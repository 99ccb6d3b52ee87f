// The λ pass at K > 64, `lambda_pass_wide_kernel`: one raw λ-statistic
// pass wherever `launch_lambda_pass` (psd_common.cuh) picks kWide. It is
// the pass of K1's and K2's solve (fused_solve.cuh), of K4
// (stats_packed.cu) and of K8 (stats_acat.cu), at f32 and bf16, with the
// replicate axis. Included by psd_common.cuh.
//
// It stands for the TPU kernels' pass bodies:
// terastructure_tpu/ops/fused_step.py `_make_kernel.one_pass` (:252-308;
// K1, K2) and ops/stats_pallas.py `_lambda_kernel` (:96-112; K4) and
// `_lambda_acat_kernel` (:429-458; K8), each with `_ratios_tile` (:68-93):
//   D = [t1; t0] u^T,   R = A / (D + 1e-30),   S = R u,
// S written as part (nsplit, B, K, 2), which `update_kernel` and
// `split_reduce_kernel` add in split order. At bf16 the operands follow
// the reference's rule: D = bf(t) bf(u) in f32, R = bf(A / (D + eps)),
// S = R bf(u) in f32. On the TPU K is padded to 128 lanes
// (fused_step.py:141), so K = 65..128 costs the reference what K = 8 does.
//
// The design is the tile of wide_tile.cuh, which K7's K > 64 body walks
// too. The grid is (ceil(B / 64), column splits, replicates), with no K
// chunks. A CTA of 8 warps holds its 64 rows as 128 M-rows (t1 and t0 of
// each row) and walks its split's byte columns in sub-tiles of 16 (64
// individuals). Per sub-tile, over all of K:
//   D = t u^T          128 M-rows x 64 individuals: once an entry;
//   R = A / (D + eps)  one divide an allele and entry, into a shared tile;
//   S += R u           128 M-rows x K: in registers across the split's
//                      sub-tiles, leaving once as the CTA's rows of part.
// K is cut into pieces of at most 128 columns (`w7_pieces`), each run at
// KP = 80 or 128 columns (`lw_piece_cols`: two widths, not K7's four,
// since the pass is built for 8 entry points and nvcc's time counts in
// every run; K = 65..80, K = 72 among them, runs 80 wide, and 81..128
// pays up to 58% more FMAs). So K = 65..128 is one piece: t is staged
// once, and u and the counts of the next sub-tile arrive by 16-byte
// cp.async in a second buffer while one runs. Above 128 columns D is summed over the
// pieces first, each staged in turn; then each piece is staged again for
// its S, which is added into the CTA's rows of part a sub-tile at a time,
// as K7's K > 64 body does. So D's FMAs are done once; the operands are
// staged twice and S's partial is read back once a sub-tile and piece.
// (Cutting the output columns into z chunks of 128 instead would compute
// D ceil(K / 128) times.)
// f32: SIMT, register-blocked as an SGEMM (a thread holds 8 M-rows x 4
// individuals of D and 8 M-rows x KP / 16 columns of S; float4 operand
// reads), no TF32. bf16: both products on mma.sync m16n8k16 with ldmatrix,
// R rounded once.
//
// Row sources (`WideRows<Loader>`): packed rows, 16 bytes a row a
// sub-tile (K1 and K4: `PackedLoader<ContiguousRows>`; K2:
// `PackedLoader<GroupedRows>` through the CTA's row table, a null row
// reading as MISSING); or K8's count planes (`AcatLoader`): the
// sub-tile's a1 and a0 bf16 of 64 rows x 4 planes x 16 columns, 18 KB a
// buffer, taken as they are. Past B, past the split and where MISSING the
// counts are 0 and t or u are 0, so such an entry adds exactly 0. The
// divide is the caller's (`div`: kDivExact, kDivFast, or kDivNewton for
// K1's and K2's loop passes), chosen per launch. `active` (may be null)
// ends replicate z's CTAs at once where active[z] == 0 (K1's and K2's
// tol exit).
//
// What bounds it: at f32 the FP32 issue of 4 KP FMAs an entry (K padded
// to the piece: 80 at K = 72) and two divides; at bf16 not the products
// but the decode, the divides and the staging between the barriers
// (NVIDIA H100 80GB HBM3, 700 W, K8 at the big-N step's subsample with
// K = 72: 0.67 ms at f32, 32% of its bound, and 0.24 at bf16; PERF.md).
// At f32 a CTA (228-254 registers a thread) fills an SM, so the column
// splits (`lambda_grid` in ops/stats_packed.py, its K > 64 branch) give
// each CTA 2 to 16 sub-tiles, which pays for staging t and writing S
// once for several sub-tiles' work, with a count of CTAs that fills its
// last wave on the SMs.
//
// No atomics: the CTAs of a split write its partial sums alone and the
// reductions add the splits in order, so a re-run is bitwise equal.
// Replicate z = blockIdx.z offsets its pointers by `rep`'s strides before
// any staging and runs the single call's grid, so its result is bitwise
// its single call's. K2's rows go through the same staging as K1's, so
// K2 is bitwise K1 on the gathered rows.
#pragma once

#include <atomic>
#include <type_traits>

#include "wide_tile.cuh"

namespace tt {

// A row source's staging and decode for the wide tile: `stage` copies the
// counts of the CTA's 64 rows at byte columns [wc, wc + 16) into a buffer
// of kBytes (kW7Threads threads; cp.async where it can, waited for by the
// caller); then `counts4` gives the counts (a1, a0) of row r at byte
// column c for planes 0..3 (the SIMT body), and `counts2` those of plane p
// at columns c and c + 1, c even (the tensor-core body).
template <class Loader>
struct WideRows;

// 2-bit packed rows located through the CTA's row table (K1, K2, K4): 16
// bytes a row, MISSING counting 0 for both alleles.
template <class Rows>
struct WideRows<PackedLoader<Rows>> {
  static constexpr int kBytes = kW7Rows * kW7Cols;

  __device__ static void stage(const PackedLoader<Rows>&, uint8_t* cs,
                               const uint8_t* const* rowp, int, int, int,
                               int wc, int wend) {
    const int r = threadIdx.x;        // the thread that filled rowp[r]
    if (r < kW7Rows) w7_stage_code_row(cs + r * kW7Cols, rowp[r], wc, wend);
  }

  __device__ __forceinline__ static void decode(uint32_t code, float& a1,
                                                float& a0) {
    const bool miss = code == 3u;
    const float x = (float)code;
    a1 = miss ? 0.f : x;
    a0 = miss ? 0.f : 2.f - x;
  }

  __device__ __forceinline__ static void counts4(const uint8_t* cs, int r,
                                                 int c, float (&a1)[4],
                                                 float (&a0)[4]) {
    const uint32_t byte = cs[r * kW7Cols + c];
#pragma unroll
    for (int p = 0; p < 4; ++p) decode((byte >> (2 * p)) & 3u, a1[p], a0[p]);
  }

  __device__ __forceinline__ static void counts2(const uint8_t* cs, int r,
                                                 int c, int p, float (&a1)[2],
                                                 float (&a0)[2]) {
    const uint32_t two =
        *reinterpret_cast<const uint16_t*>(cs + r * kW7Cols + c);
#pragma unroll
    for (int e = 0; e < 2; ++e)
      decode((two >> (8 * e + 2 * p)) & 3u, a1[e], a0[e]);
  }
};

// K8's count planes a1, a0 (B, 4, W) bf16: the sub-tile's a1 tile, then
// its a0 tile, each (64 rows, 4 planes, 16 columns) with rows of kRow
// bf16, padded so that the SIMT body's reads of rows 4 apart and the
// tensor-core body's of 8 neighbouring rows fall into distinct banks. A
// plane's 8 columns come by one 16-byte cp.async where they are aligned
// (W % 8 == 0), else element by element; zero past B and wend.
template <>
struct WideRows<AcatLoader> {
  static constexpr int kRow = 4 * kW7Cols + 8;
  static constexpr int kTile = kW7Rows * kRow;  // bf16 of the a1 (a0) tile
  static constexpr int kBytes = 2 * kTile * 2;

  __device__ static void stage(const AcatLoader& ld, uint8_t* cs,
                               const uint8_t* const*, int b0, int B, int W,
                               int wc, int wend) {
    uint16_t* tiles = reinterpret_cast<uint16_t*>(cs);
    // (plane array, row, plane, half of the 16 columns)
    for (int i = threadIdx.x; i < 2 * kW7Rows * 8; i += kW7Threads) {
      const int a = i / (kW7Rows * 8), r = (i >> 3) % kW7Rows;
      const int p = (i >> 1) & 3, h = i & 1;
      uint16_t* dst = tiles + a * kTile + r * kRow + p * kW7Cols + 8 * h;
      const long long b = b0 + r;
      const int w = wc + 8 * h;
      const int n = b < B ? max(0, min(8, wend - w)) : 0;
      if (n == 0) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        continue;
      }
      const uint16_t* src = (a ? ld.a0 : ld.a1) + (b * 4 + p) * W + w;
      if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        cp_async16z(dst, src, 2 * n);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) dst[j] = j < n ? __ldg(src + j) : 0;
      }
    }
  }

  __device__ __forceinline__ static void counts4(const uint8_t* cs, int r,
                                                 int c, float (&a1)[4],
                                                 float (&a0)[4]) {
    const uint16_t* x = reinterpret_cast<const uint16_t*>(cs) + r * kRow + c;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      a1[p] = __uint_as_float((uint32_t)x[p * kW7Cols] << 16);
      a0[p] = __uint_as_float((uint32_t)x[kTile + p * kW7Cols] << 16);
    }
  }

  __device__ __forceinline__ static void counts2(const uint8_t* cs, int r,
                                                 int c, int p, float (&a1)[2],
                                                 float (&a0)[2]) {
    const uint16_t* x =
        reinterpret_cast<const uint16_t*>(cs) + r * kRow + p * kW7Cols + c;
    const uint32_t v1 = *reinterpret_cast<const uint32_t*>(x);
    const uint32_t v0 = *reinterpret_cast<const uint32_t*>(x + kTile);
    a1[0] = __uint_as_float(v1 << 16);
    a1[1] = __uint_as_float(v1 & 0xFFFF0000u);
    a0[0] = __uint_as_float(v0 << 16);
    a0[1] = __uint_as_float(v0 & 0xFFFF0000u);
  }
};

// R = A / (D + eps) of the SIMT body's 16 entries a thread (rows 4q + e,
// byte column c, planes 0..3) into the R tile
template <int kDiv, class Src, int KP, class L>
__device__ __forceinline__ void lw_ratios(const W7Simt<KP>& body,
                                          const L& sm, const uint8_t* cs) {
  constexpr int RFS = W7Simt<KP>::RFS;
  const int q = threadIdx.x >> 4, c = threadIdx.x & 15;
  float* rf = static_cast<float*>(sm.r);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = 4 * q + e;
    float a1[4], a0[4];
    Src::counts4(cs, r, c, a1, a0);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      rf[w7_m(r, 0) * RFS + 16 * p + c] = ratio<kDiv>(a1[p], body.d[e][0][p]);
      rf[w7_m(r, 1) * RFS + 16 * p + c] = ratio<kDiv>(a0[p], body.d[e][1][p]);
    }
  }
}

// ... and the tensor-core body's, on its accumulators: row 8w + g,
// individuals 8j + 2t (+1) of n8 tile j (plane j / 2, byte column
// 8 (j % 2) + 2t (+1)), rounded to bf16
template <int kDiv, class Src, int KP, class L>
__device__ __forceinline__ void lw_ratios(const W7Mma<KP>& body,
                                          const L& sm, const uint8_t* cs) {
  constexpr int RHS = W7Mma<KP>::RHS;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint32_t* r1 = reinterpret_cast<uint32_t*>(
                     static_cast<__nv_bfloat16*>(sm.r) + (16 * w + g) * RHS) +
                 t;
  uint32_t* r0 = r1 + 4 * RHS;             // 8 M-rows on (bf16 pairs)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float a1[2], a0[2];
    Src::counts2(cs, 8 * w + g, 8 * (j & 1) + 2 * t, j >> 1, a1, a0);
    r1[4 * j] = pack_bf16(ratio<kDiv>(a1[0], body.d[j][0]),
                          ratio<kDiv>(a1[1], body.d[j][1]));
    r0[4 * j] = pack_bf16(ratio<kDiv>(a0[0], body.d[j][2]),
                          ratio<kDiv>(a0[1], body.d[j][3]));
  }
}

// The λ pass at K > 64. grid (ceil(B / 64), nsplit, R), block kW7Threads,
// dynamic shared memory W7<KP, kBf16, 2 WideRows<Loader>::kBytes>::kBytes;
// KP = lw_piece_cols(K). Arguments as lambda_pass_kernel's (the note at
// the top of this file), with the divide `div` a `Div` (kDivNewton only
// where kNewton is set: K1's and K2's solve builds it). At bf16 with
// packed rows and KP = 80 two CTAs share an SM, as K7's K > 64 body.
template <int KP, class Loader, bool kBf16, bool kNewton>
__global__ void __launch_bounds__(
    kW7Threads, kBf16 && KP == 80 && WideRows<Loader>::kBytes <= 1024 ? 2 : 1)
lambda_pass_wide_kernel(Loader ld, const float* __restrict__ up,
                        const float* __restrict__ t1g,
                        const float* __restrict__ t0g, int ts, int tk,
                        float* __restrict__ part, int B, int W, int K,
                        int wchunk, int div, const int* __restrict__ active,
                        Rep rep) {
  using Src = WideRows<Loader>;
  using L = W7<KP, kBf16, 2 * Src::kBytes>;
  const long long z = blockIdx.z;
  if (active != nullptr && active[z] == 0) return;
  ld = ld.shifted(z * rep.rows);
  up += z * rep.u;
  t1g += z * rep.t;
  t0g += z * rep.t;
  part += z * rep.part;
  extern __shared__ __align__(16) unsigned char lw_smem[];
  __shared__ const uint8_t* rowp[kW7Rows];         // PackedLoader's row table
  const L sm(lw_smem);
  const int b0 = blockIdx.x * kW7Rows;
  const int wbeg = blockIdx.y * wchunk;
  const int wend = min(W, wbeg + wchunk);
  const int nsub = (wend - wbeg + kW7Cols - 1) / kW7Cols;
  const int np = w7_pieces(K);
  float* ltile = part + (long long)blockIdx.y * B * K * 2;
  // the columns of piece p that D sums (the staged rest is zero)
  auto span = [&](int p) {
    const int n = min(KP, K - p * KP);
    return kBf16 ? (n + 15) & ~15 : (n + 3) & ~3;
  };
  std::conditional_t<kBf16, W7Mma<KP>, W7Simt<KP>> body;
  auto ratios = [&](int buf) {
    if (div == kDivFast)
      lw_ratios<kDivFast, Src>(body, sm, sm.cb(buf));
    else if (div == kDivExact)
      lw_ratios<kDivExact, Src>(body, sm, sm.cb(buf));
    else if constexpr (kNewton)
      lw_ratios<kDivNewton, Src>(body, sm, sm.cb(buf));
  };
  ld.prepare(rowp, b0, B, W);  // thread r < 64 fills rowp[r], which it reads
  body.zero_s();
  // One piece: t staged once, and u and the counts of sub-tile i + 1
  // copied into the other buffer while i runs. Several: piece p of t and u
  // at byte column wc (and the counts), staged and waited for, once for
  // D and once for S. Each product is written once, for both.
  const bool one = np == 1;
  auto stage_piece = [&](int p, int wc, bool counts) {
    __syncthreads();                   // the last piece's readers are done
    w7_stage_t<KP, kBf16>(sm.t, t1g, t0g, ts, tk, B, K, b0, p * KP);
    w7_stage_u<KP>(sm.ufb(0), up, W, K, wc, wend, p * KP);
    if (counts) Src::stage(ld, sm.cb(0), rowp, b0, B, W, wc, wend);
    cp_async_commit();
    cp_async_wait_group<0>();
    __syncthreads();
  };
  if (one) {
    w7_stage_t<KP, kBf16>(sm.t, t1g, t0g, ts, tk, B, K, b0, 0);
    w7_stage_u<KP>(sm.ufb(0), up, W, K, wbeg, wend, 0);
    Src::stage(ld, sm.cb(0), rowp, b0, B, W, wbeg, wend);
    cp_async_commit();
  }
  for (int i = 0; i < nsub; ++i) {
    const int wc = wbeg + i * kW7Cols;
    const int buf = one ? i & 1 : 0;
    if (one) {
      cp_async_wait_group<0>();        // sub-tile i's copies have landed
      __syncthreads();                 // ... for all; sub-tile i - 1 is read
      if (i + 1 < nsub) {
        w7_stage_u<KP>(sm.ufb(buf ^ 1), up, W, K, wc + kW7Cols, wend, 0);
        Src::stage(ld, sm.cb(buf ^ 1), rowp, b0, B, W, wc + kW7Cols, wend);
      }
      cp_async_commit();
    }
    for (int p = 0; p < np; ++p) {
      if (!one) stage_piece(p, wc, p == 0);
      body.prepare(sm, buf);
      body.d_product(sm, buf, span(p), p == 0);
    }
    ratios(buf);
    for (int p = 0; p < np; ++p) {
      if (one) {
        __syncthreads();               // the R tile is written
      } else {
        stage_piece(p, wc, false);
        body.prepare(sm, 0);
        body.zero_s();
      }
      body.s_product(sm, buf);
      if (!one) body.flush_s(ltile, B, K, b0, p * KP, i > 0);
    }
  }
  if (one) body.flush_s(ltile, B, K, b0, 0, false);
}

// The columns a piece of K runs at (`w7_pieces(K)` pieces): 80 where
// the pieces are at most 80 wide, else 128. Zero columns past K add
// exactly 0 to D, and S's are not written.
__host__ __device__ constexpr int lw_piece_cols(int K) {
  return w7_piece_cols(K) <= 80 ? 80 : 128;
}

// Launch one λ pass at K > 64 (as launch_lambda_pass: `nsplit` column
// splits into part (nsplit, B, K, 2), R replicates at the strides of
// `rep`, `div` a `Div`). Each instantiation's dynamic shared memory is set
// once a device.
template <class Loader, bool kNewton, bool kBf16>
int launch_lambda_pass_wide(Loader ld, const float* up, const float* t1,
                            const float* t0, int ts, int tk, float* part,
                            int B, int W, int K, int nsplit, int div,
                            const int* active, cudaStream_t stream, int R,
                            Rep rep) {
  if (nsplit > 65535 || R > 65535) return (int)cudaErrorInvalidValue;
  if (!kNewton && div != kDivFast && div != kDivExact)
    return (int)cudaErrorInvalidValue;  // no Newton body instantiated
  int dev = 0;
  if (const cudaError_t e = cudaGetDevice(&dev)) return (int)e;
  const unsigned long long bit = 1ull << (dev & 63);
  const dim3 grid((B + kW7Rows - 1) / kW7Rows, nsplit, R);
  const int wchunk = split_chunk(W, nsplit);
#define TT_WIDE(KP)                                                         \
  {                                                                         \
    constexpr int bytes =                                                   \
        W7<KP, kBf16, 2 * WideRows<Loader>::kBytes>::kBytes;                \
    static std::atomic<unsigned long long> set{0};  /* devices set */       \
    if (!(set.load() & bit)) {                                              \
      const cudaError_t e = cudaFuncSetAttribute(                           \
          lambda_pass_wide_kernel<KP, Loader, kBf16, kNewton>,              \
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);              \
      if (e != cudaSuccess) return (int)e;                                  \
      set.fetch_or(bit);                                                    \
    }                                                                       \
    lambda_pass_wide_kernel<KP, Loader, kBf16, kNewton>                     \
        <<<grid, kW7Threads, bytes, stream>>>(ld, up, t1, t0, ts, tk, part, \
                                              B, W, K, wchunk, div, active, \
                                              rep);                         \
  }
  if (lw_piece_cols(K) == 80)
    TT_WIDE(80)
  else
    TT_WIDE(128)
#undef TT_WIDE
  TT_CHECK_LAUNCH();
  return 0;
}

}  // namespace tt
