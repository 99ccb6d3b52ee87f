// The γ pass at K > 64, `gamma_pass_wide_kernel`: wherever
// `launch_gamma_stats` (psd_common.cuh) picks kWide. It is the last pass
// of K1's and K2's solve (fused_solve.cuh: t interleaved as (B, K, 2)) and
// the whole of K5 (stats_gamma.cu: planar t1, t0), at f32 and bf16, with
// the replicate axis. Included by psd_common.cuh.
//
// It stands for the TPU kernels' γ bodies: terastructure_tpu/ops/
// fused_step.py `_make_kernel.one_pass(need_g=True)` (:252-308; K1, K2)
// and ops/stats_pallas.py `_gamma_kernel` (:115; K5), each with
// `_ratios_tile` (:68-93):
//   D = [t1; t0] u^T,   R = A / (D + 1e-30),   g = R1^T t1 + R0^T t0,
// g summed over the batch's rows. At bf16 the operands follow the
// reference's rule: D = bf(t) bf(u) in f32, R = bf(A / (D + eps)),
// g = R^T bf(t) in f32. On the TPU K is padded to 128 lanes
// (fused_step.py:141), so K = 65..128 costs the reference what K = 8 does.
//
// The design is the λ pass's (lambda_wide.cuh) with rows and individuals
// swapped, on wide_tile.cuh's tile. The grid is (ceil(W / 16), row
// splits, replicates), with no K chunks. A CTA of 8 warps holds a column
// tile of 16 byte columns (64 individuals: u row 16 s + c is plane s,
// byte column c) and walks its split's rows in row tiles of 64 (128
// M-rows: t1 and t0 of each row). Per row tile, over all of K:
//   D = t u^T          128 M-rows x 64 individuals: once an entry;
//   R = A / (D + eps)  one exact divide an allele and entry, into a shared
//                      tile (`lw_ratios`, the λ pass's);
//   g += t^T R         K x 64 individuals: wide_tile.cuh's g product (K7's,
//                      `W7SimtG`, `W7MmaG`).
// K is cut into pieces of at most 128 columns (`w7_pieces`), run at KP =
// 80 or 128 columns (`lw_piece_cols`, the λ pass's two widths: nvcc's
// time counts in every run). K = 65..128 is one piece: u is staged once
// a CTA, g stays in registers across the split's row tiles and leaves
// once as its partial, and t and the packed bytes of the next row tile
// arrive by cp.async in a second buffer while one runs (f32: two t tiles
// the products read; bf16: one f32 staging tile, rounded into the bf16 t
// tile after it lands). Above 128 columns a row tile sums D over the
// pieces first, each piece's t and u staged and waited for; then each
// piece's t is staged again (the last one is still there) for its g, which
// is added into the split's partial a row tile at a time, as the λ pass
// adds S. So D's FMAs are done once; t is staged twice.
// f32: SIMT, register-blocked as an SGEMM (a thread holds 8 M-rows x 4
// individuals of D and 4 individuals x KP / 16 columns of g; float4
// operand reads), no TF32. bf16: both products on mma.sync m16n8k16 with
// ldmatrix, R rounded once.
//
// Rows come through the λ pass's row sources (`WideRows<PackedLoader<
// Rows>>`): the CTA's row table is refilled for each row tile, a thread a
// row; K2's null group reads as MISSING. Past the split's rows, past W
// and where MISSING the counts are 0 and t or u are 0, so such an entry
// adds exactly 0.
//
// No atomics: each split writes its partial (nsplit, 4W, K) alone (an
// empty split writes zeros) and `gamma_reduce_kernel` adds the splits in
// order, so a re-run is bitwise equal. The row split (`gamma_grid` in
// ops/stats_packed.py, its K > 64 branch) is a multiple of 64 rows, a
// function of the shape only. Replicate z = blockIdx.z offsets its
// pointers by `rep`'s strides before any staging and runs the single
// call's grid, so each replicate is bitwise its single call. K2's rows go
// through the same staging as K1's, so K2 is bitwise K1 on the gathered
// rows.
#pragma once

#include <atomic>
#include <type_traits>

#include "lambda_wide.cuh"

namespace tt {

// What the products read for a row tile: the layout `L` of wide_tile.cuh's
// products (t, u as staged, R, bf(u)).
struct GwView {
  void* t;
  float* u;
  void* r;
  __nv_bfloat16* ub;
  __device__ float* ufb(int) const { return u; }
};

// The γ pass's dynamic shared memory. f32: two t tiles (M-rows, FS
// floats), u (64 individuals, FS floats), R (M-rows, RFS floats). bf16:
// one f32 staging tile (t as it lands; u at the start of a piece), the
// bf16 t tile (HS), bf(u) (HS), R (RHS bf16). Both: the packed bytes of
// two row tiles. Row strides as W7's.
template <int KP, bool kBf16>
struct Gw {
  static constexpr int FS = KP + 4, HS = KP + 8;
  static constexpr int RFS = kW7Ind + 4, RHS = kW7Ind + 8;
  static constexpr int kTf = kW7M * FS * 4;
  static constexpr int kTh = kBf16 ? kW7M * HS * 2 : 0;
  static constexpr int kU = kBf16 ? kW7Ind * HS * 2 : kW7Ind * FS * 4;
  static constexpr int kR = kW7M * (kBf16 ? 2 * RHS : 4 * RFS);
  static constexpr int kCodes = 2 * kW7Rows * kW7Cols;
  static constexpr int kBytes = (kBf16 ? 1 : 2) * kTf + kTh + kU + kR + kCodes;
  static_assert(kBytes <= 232448, "a CTA's shared memory on the H100");

  unsigned char* p;
  __device__ explicit Gw(unsigned char* base) : p(base) {}
  // f32 tile buf (f32), or the staging tile (bf16)
  __device__ float* tf(int buf) const {
    return reinterpret_cast<float*>(p + (kBf16 ? 0 : buf * kTf));
  }
  __device__ void* u() const { return p + (kBf16 ? 1 : 2) * kTf + kTh; }
  __device__ void* r() const { return static_cast<unsigned char*>(u()) + kU; }
  __device__ uint8_t* cb(int buf) const {
    return static_cast<unsigned char*>(r()) + kR + buf * (kCodes / 2);
  }
  // what the products read for a row tile in t tile buf (f32)
  __device__ GwView view(int buf) const {
    if constexpr (kBf16)
      return {p + kTf, tf(0), r(), static_cast<__nv_bfloat16*>(u())};
    return {tf(buf), static_cast<float*>(u()), r(), nullptr};
  }
};

// t1, t0 of rows [b0, b0 + 64), columns [k0, k0 + KP) of K, into the f32
// tile tf by cp.async (M-row w7_m(r, a)), zero past bend and K; t1[b ts +
// k tk], t0 likewise. 16-byte copies where `vec` (tk = 1 and 16-byte
// aligned rows: K5), else 4-byte ones (K1's and K2's interleaved t).
template <int KP>
__device__ __forceinline__ void gw_stage_t(float* tf,
                                           const float* __restrict__ t1g,
                                           const float* __restrict__ t0g,
                                           int ts, int tk, int bend, int K,
                                           int b0, int k0, bool vec) {
  constexpr int Q = KP / 4, FS = KP + 4;
  for (int j = threadIdx.x; j < kW7M * Q; j += kW7Threads) {
    const int m = j / Q, q = j - m * Q, k = k0 + 4 * q;
    const float* tg = (m >> 3) & 1 ? t0g : t1g;
    const long long b = b0 + 8 * (m >> 4) + (m & 7);
    float* dst = tf + m * FS + 4 * q;
    const float* src = tg + (b < bend ? b * ts + (long long)k * tk : 0);
    if (vec) {
      const bool rd = b < bend && k < K;
      cp_async16z(dst, rd ? src : tg, rd ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool rd = b < bend && k + e < K;
        cp_async4z(dst + e, rd ? src + e * tk : tg, rd ? 4 : 0);
      }
    }
  }
}

// The staged f32 t tile rounded into the bf16 t tile
template <int KP>
__device__ __forceinline__ void gw_round_t(__nv_bfloat16* th,
                                           const float* tf) {
  constexpr int Q = KP / 4, FS = KP + 4, HS = KP + 8;
  for (int j = threadIdx.x; j < kW7M * Q; j += kW7Threads) {
    const int m = j / Q, q = j - m * Q;
    const float4 v = *reinterpret_cast<const float4*>(tf + m * FS + 4 * q);
    *reinterpret_cast<uint2*>(th + m * HS + 4 * q) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// The γ pass at K > 64. grid (ceil(W / 16), nsplit, R), block kW7Threads,
// dynamic shared memory Gw<KP, kBf16>::kBytes; KP = lw_piece_cols(K).
// Arguments as gamma_pass_kernel's: split y takes rows [y bchunk, (y + 1)
// bchunk), bchunk a multiple of 64, and writes gpart[y] (4W, K). At bf16
// with KP = 80 two CTAs share an SM.
template <int KP, class Rows, bool kBf16>
__global__ void __launch_bounds__(kW7Threads, kBf16 && KP == 80 ? 2 : 1)
gamma_pass_wide_kernel(Rows rows, const float* __restrict__ up,
                       const float* __restrict__ t1g,
                       const float* __restrict__ t0g, int ts, int tk,
                       float* __restrict__ gpart, int B, int W, int K,
                       int bchunk, Rep rep) {
  using Ld = PackedLoader<Rows>;
  using Src = WideRows<Ld>;
  using L = Gw<KP, kBf16>;
  using Body = std::conditional_t<kBf16, W7Mma<KP>, W7Simt<KP>>;
  const long long z = blockIdx.z;
  const Ld ld{rows.shifted(z * rep.rows)};
  up += z * rep.u;
  t1g += z * rep.t;
  t0g += z * rep.t;
  gpart += z * rep.part;
  extern __shared__ __align__(16) unsigned char gw_smem[];
  __shared__ const uint8_t* rowp[kW7Rows];         // the row tile's rows
  const L sm(gw_smem);
  const int wc = blockIdx.x * kW7Cols;             // the CTA's byte columns
  const int bbeg = blockIdx.y * bchunk;
  const int bend = min(B, bbeg + bchunk);
  const int nrt = bend > bbeg ? (bend - bbeg + kW7Rows - 1) / kW7Rows : 0;
  const int np = w7_pieces(K);
  float* gtile = gpart + (long long)blockIdx.y * 4 * W * K;
  const bool vec = tk == 1 && (ts & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(t1g) |
                     reinterpret_cast<uintptr_t>(t0g)) & 15) == 0;
  // the columns of piece p that D sums (the staged rest is zero)
  auto span = [&](int p) {
    const int n = min(KP, K - p * KP);
    return kBf16 ? (n + 15) & ~15 : (n + 3) & ~3;
  };
  // t of row tile i, piece p, into t tile buf (f32; bf16: the staging
  // tile) and, where cbuf >= 0, the tile's row table and packed bytes into
  // byte buffer cbuf: issued, not waited for
  auto stage_rows = [&](int i, int p, int buf, int cbuf) {
    const int b0 = bbeg + i * kW7Rows;
    gw_stage_t<KP>(sm.tf(buf), t1g, t0g, ts, tk, bend, K, b0, p * KP, vec);
    if (cbuf >= 0) {
      ld.prepare(rowp, b0, bend, W);  // thread r < 64 fills and reads rowp[r]
      Src::stage(ld, sm.cb(cbuf), rowp, b0, bend, W, wc, W);
    }
  };
  // u of piece p, staged and waited for; at bf16 rounded into bf(u)
  Body body;
  auto stage_u = [&](int p) {
    __syncthreads();                   // the last piece's readers are done
    w7_stage_u<KP>(kBf16 ? sm.tf(0) : static_cast<float*>(sm.u()), up, W, K,
                   wc, W, p * KP);
    cp_async_commit();
    cp_async_wait_group<0>();
    __syncthreads();
    body.prepare(sm.view(0), 0);       // bf16: bf(u), then a barrier
  };
  // the staged t tile, waited for; at bf16 rounded into the bf16 t tile
  auto land_t = [&]() {
    cp_async_wait_group<0>();
    __syncthreads();
    if constexpr (kBf16) {
      gw_round_t<KP>(static_cast<__nv_bfloat16*>(sm.view(0).t), sm.tf(0));
      __syncthreads();
    }
  };
  typename Body::G g;
  if (np == 1) {
    stage_u(0);
    g.zero();
    if (nrt > 0) stage_rows(0, 0, 0, 0);
    cp_async_commit();
    for (int i = 0; i < nrt; ++i) {
      const int buf = i & 1;
      // row tile i has landed, and row tile i - 1 is read
      land_t();
      if (i + 1 < nrt) stage_rows(i + 1, 0, kBf16 ? 0 : buf ^ 1, buf ^ 1);
      cp_async_commit();
      const GwView v = sm.view(buf);
      body.d_product(v, 0, span(0), true);
      lw_ratios<kDivExact, Src>(body, v, sm.cb(buf));
      __syncthreads();                 // the R tile is written
      g.product(v);
    }
    g.store(gtile, W, K, wc, W, 0);
    return;
  }
  if (nrt == 0) {                      // an empty split: its partial is 0
    g.zero();
    for (int p = 0; p < np; ++p) g.store(gtile, W, K, wc, W, p * KP);
    return;
  }
  for (int i = 0; i < nrt; ++i) {
    // D over the pieces, each staged and waited for
    for (int p = 0; p < np; ++p) {
      stage_u(p);
      stage_rows(i, p, 0, p == 0 ? 0 : -1);
      cp_async_commit();
      land_t();
      body.d_product(sm.view(0), 0, span(p), p == 0);
    }
    lw_ratios<kDivExact, Src>(body, sm.view(0), sm.cb(0));
    // each piece's g (t and R: u is not read), the last piece first (its
    // t is still staged), added into the split's partial
    for (int q = 0; q < np; ++q) {
      const int p = (np - 1 + q) % np;
      __syncthreads();                 // R is written; the last t is read
      if (q > 0) {
        stage_rows(i, p, 0, -1);
        cp_async_commit();
        land_t();
      }
      g.write(sm.view(0), gtile, W, K, wc, W, p * KP, i > 0);
    }
  }
}

// Launch the γ pass at K > 64 over `nsplit` row splits (a multiple of 64
// rows each) and their reduction, as gamma_stats: gpart (nsplit, 4W, K)
// scratch, g (4, W, K), R replicates at the strides of `rep`. Each
// instantiation's dynamic shared memory is set once a device.
template <class Rows, bool kBf16>
int gamma_stats_wide(Rows src, const float* up, const float* t1g,
                     const float* t0g, int ts, int tk, float* gpart, float* g,
                     int B, int W, int K, int nsplit, cudaStream_t stream,
                     int R, Rep rep) {
  if (nsplit > 65535 || R > 65535) return (int)cudaErrorInvalidValue;
  int dev = 0;
  if (const cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  const unsigned long long bit = 1ull << (dev & 63);
  const int rows = (B + nsplit - 1) / nsplit;
  const int bchunk = (rows + kW7Rows - 1) / kW7Rows * kW7Rows;
  const dim3 grid((W + kW7Cols - 1) / kW7Cols, nsplit, R);
#define TT_GWIDE(KP)                                                         \
  {                                                                          \
    constexpr int bytes = Gw<KP, kBf16>::kBytes;                             \
    static std::atomic<unsigned long long> set{0};  /* devices set */        \
    if (!(set.load() & bit)) {                                               \
      const cudaError_t e = cudaFuncSetAttribute(                            \
          gamma_pass_wide_kernel<KP, Rows, kBf16>,                           \
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);               \
      if (e != cudaSuccess) return (int)e;                                   \
      set.fetch_or(bit);                                                     \
    }                                                                        \
    gamma_pass_wide_kernel<KP, Rows, kBf16><<<grid, kW7Threads, bytes,       \
                                              stream>>>(                     \
        src, up, t1g, t0g, ts, tk, gpart, B, W, K, bchunk, rep);             \
  }
  if (lw_piece_cols(K) == 80)
    TT_GWIDE(80)
  else
    TT_GWIDE(128)
#undef TT_GWIDE
  TT_CHECK_LAUNCH();
  const long long ng = 4LL * W * K;
  gamma_reduce_kernel<<<dim3((unsigned)((ng + 255) / 256), 1, R), 256, 0,
                        stream>>>(gpart, nsplit, ng, g, rep.part, rep.out);
  TT_CHECK_LAUNCH();
  return 0;
}

}  // namespace tt
