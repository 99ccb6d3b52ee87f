// K7: batch_stats_fused_v2_packed and K6: batch_stats_fused_packed — the
// exact full-N statistics pass of the big-N step: the lambda statistics
// (l0, l1) (B, K) and the planar gamma statistic g (4, W, K) from one
// D = T U^T per (row, individual).
//
// Replaces terastructure_tpu/ops/stats_pallas.py
//   K7 `batch_stats_fused_v2_packed` (`_batch_stats_v2_kernel`, pallas_call
//      at :373): the default pass (stats_kernel="fused_v2");
//   K6 `batch_stats_fused_packed` (`_batch_stats_kernel`, pallas_call at
//      :285): stats_kernel="fused".
// On the TPU both walk a sequential (W tiles, B tiles) grid and sum g by
// revisiting its output block over the batch axis; v1 also sums lambda by
// a read-modify-write of a (B, K) block, v2 writes per-W-tile lambda
// partials. Hopper has no sequential grid, so the two sums are made in a
// fixed order without atomics (a seed reproduces gamma bitwise):
//
// Both kernels share the tile step: CTAs of 128 threads take a sub-tile
// of 32 byte columns x 4 planes (128 individuals) against a chunk of 32
// rows in two phases.
//   phase 1, one thread per individual (u[n,:] in registers, t of the 32
//     rows staged in shared memory and read as broadcasts): D1, D0, then
//     R = A / (D + 1e-30) into shared memory, and g[n,:] += R^T T in
//     registers;
//   phase 2, one lane per row and one warp per plane (the R reads hit 32
//     banks, u is a shared-memory broadcast): S[b,:] += R U over the
//     warp's 32 individuals.
// So the one D feeds both sums: gamma over rows in phase 1, lambda over
// individuals in phase 2.
//
//   K7: grid (W tiles of 256 columns, B tiles of 256 rows). A CTA loops
//     its 8 sub-tiles, and for each its 8 row chunks; gamma of a sub-tile
//     stays in registers across the chunks and goes out as the B tile's
//     partial, lambda of the B tile's rows accumulates in shared memory
//     (the warps add in warp order) and goes out as the W tile's partial.
//     At B=4096, W=25,088, K=10: 16 x 98 CTAs, gamma partials 64 MB,
//     lambda partials 32 MB; two reduce kernels add them in tile order.
//   K6: grid (B / 32). A CTA owns 32 rows and walks every sub-tile of W in
//     order with lambda in registers (the in-kernel lambda accumulation of
//     v1; the warps add in warp order at the end, written straight to
//     (l0, l1)); gamma goes out per sub-tile as the row tile's partial,
//     (B/32, 4W, K): 514 MB at the big-N shape, reduced in order.
//
// Bound on the H100: issue. Per row and individual, 6K FMAs and two
// divides (the pair, K4 + K5, does 8K and four); at the big-N shape that
// is ~25 G FMA against 103 MB of packed rows. K6 has only B/32 = 128 CTAs
// of 4 warps there, under one per SM, so it is latency-bound too; it is
// the non-default option, kept as the reference keeps v1.
//
// K > 64: `stats_v2_wide_kernel` and `stats_v1_wide_kernel`, the same tile
// step with the K outputs cut into chunks of tt::kKC = 32 (blockIdx.z), as
// the wide bodies of psd_wide.cuh (whose note says why). Each CTA computes
// D over all K a piece of 32 columns of K at a time (u of the 128
// individuals k-major, stride 129, each thread reading its own column; t
// of the 32 rows as float2 rows, read as broadcasts), adding each piece
// into R1/R0, which hold D until phase 1 turns them into R. The chunk's own
// piece comes last and serves its g (phase 1) and lambda (phase 2) sums.
// Shared memory does not grow with K (58 KB, K7 + its 256-row lambda
// block 64 KB), so both take any K, at K7's tile of 256 rows: the partial
// buffers keep the K <= 64 path's counts. Each chunk writes its own k
// columns of lpart and gpart; the reductions and their order are the
// K <= 64 path's.

#include "psd_common.cuh"

namespace {

constexpr int kFThreads = 128;          // 4 warps
constexpr int kFRows = 32;              // rows per chunk, one per lane
constexpr int kFCols = 32;              // byte columns per sub-tile
constexpr int kFInd = 4 * kFCols;       // individuals per sub-tile: 1/thread
constexpr int kRStride = kFInd + 1;     // odd: conflict-free lane reads

// Shared floats of the tile step: R1, R0, t of the chunk, u of the sub-tile.
template <int KM>
__host__ __device__ constexpr int tile_floats() {
  return 2 * kFRows * kRStride + kFRows * KM * 2 + kFInd * KM;
}

struct Tile {
  float* r1;   // (32 rows, kRStride)
  float* r0;
  float* ts;   // (32 rows, KM, 2): t1, t0 interleaved
  float* us;   // (128 individuals, KM)
};

template <int KM>
__device__ __forceinline__ Tile carve(float* smem) {
  Tile t;
  t.r1 = smem;
  t.r0 = t.r1 + kFRows * kRStride;
  t.ts = t.r0 + kFRows * kRStride;
  t.us = t.ts + kFRows * KM * 2;
  return t;
}

// Thread -> individual of the sub-tile at byte column wc: plane
// s = warp, column wc + lane (a warp's byte reads are one 32-byte run).
template <int KM>
__device__ __forceinline__ void load_u(const float* __restrict__ up, int W,
                                       int K, int wc, float* uk, float* us) {
  const int s = threadIdx.x >> 5, w = wc + (threadIdx.x & 31);
  const bool ok = w < W;
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    uk[k] = ok && k < K ? up[((long long)s * W + w) * K + k] : 0.f;
    us[threadIdx.x * KM + k] = uk[k];
  }
}

template <int KM>
__device__ __forceinline__ void load_t(const float* __restrict__ t1g,
                                       const float* __restrict__ t0g, int rb,
                                       int B, int K, float* ts) {
  for (int j = threadIdx.x; j < kFRows * KM * 2; j += kFThreads) {
    const int r = j / (KM * 2), rem = j % (KM * 2), k = rem / 2;
    const int b = rb + r;
    const float* tg = rem % 2 ? t0g : t1g;
    ts[j] = (k < K && b < B) ? tg[(long long)b * K + k] : 0.f;
  }
}

// Phase 1: R of rows [rb, rb+32) x the thread's individual into shared
// memory, and g += r1 t1 + r0 t0.
template <int KM>
__device__ __forceinline__ void ratios_gamma(const uint8_t* __restrict__ rows,
                                             int B, int W, int rb, int wc,
                                             const float* uk, const Tile& sm,
                                             float* g, int approx) {
  const int s = threadIdx.x >> 5, w = wc + (threadIdx.x & 31);
  const bool ok = w < W;
  for (int r = 0; r < kFRows; ++r) {
    const int b = rb + r;
    const uint32_t code =
        ok && b < B ? (rows[(long long)b * W + w] >> (2 * s)) & 3u : 3u;
    float x1 = 0.f, x0 = 0.f;
    if (code != 3u) {
      const float a1 = (float)code;
      const float a0 = 2.f - a1;
      const float* tr = sm.ts + r * KM * 2;
      float d1 = 0.f, d0 = 0.f;
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        d1 = fmaf(tr[2 * k], uk[k], d1);
        d0 = fmaf(tr[2 * k + 1], uk[k], d0);
      }
      x1 = tt::ratio(a1, d1, approx);
      x0 = tt::ratio(a0, d0, approx);
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        g[k] = fmaf(x1, tr[2 * k], g[k]);
        g[k] = fmaf(x0, tr[2 * k + 1], g[k]);
      }
    }
    sm.r1[r * kRStride + threadIdx.x] = x1;
    sm.r0[r * kRStride + threadIdx.x] = x0;
  }
}

// Phase 2: lane = row of the chunk, warp = plane; s += R U over the warp's
// 32 individuals, in column order.
template <int KM>
__device__ __forceinline__ void lambda_accum(const Tile& sm, float* s1,
                                             float* s0) {
  const int lane = threadIdx.x & 31, j0 = (threadIdx.x >> 5) * 32;
  for (int jj = 0; jj < 32; ++jj) {
    const int j = j0 + jj;
    const float x1 = sm.r1[lane * kRStride + j];
    const float x0 = sm.r0[lane * kRStride + j];
    const float* u = sm.us + j * KM;
#pragma unroll
    for (int k = 0; k < KM; ++k) {
      s1[k] = fmaf(x1, u[k], s1[k]);
      s0[k] = fmaf(x0, u[k], s0[k]);
    }
  }
}

template <int KM>
__device__ __forceinline__ void write_gamma(float* gtile, int W, int K,
                                            int wc, const float* g) {
  const int s = threadIdx.x >> 5, w = wc + (threadIdx.x & 31);
  if (w >= W) return;
  float* out = gtile + ((long long)s * W + w) * K;
#pragma unroll
  for (int k = 0; k < KM; ++k)
    if (k < K) out[k] = g[k];
}

// K7. grid (ceil(W/tile_cols), ceil(B/tile_rows)); dynamic shared memory
// tile_floats + tile_rows*K*2 floats. lpart (gridDim.x, B, K, 2), gpart
// (gridDim.y, 4W, K).
template <int KM>
__global__ void __launch_bounds__(kFThreads)
stats_v2_kernel(const uint8_t* __restrict__ rows, const float* __restrict__ up,
                const float* __restrict__ t1g, const float* __restrict__ t0g,
                float* __restrict__ lpart, float* __restrict__ gpart, int B,
                int W, int K, int tile_rows, int tile_cols, int approx) {
  extern __shared__ float smem[];
  const Tile sm = carve<KM>(smem);
  float* lam = smem + tile_floats<KM>();     // (tile_rows, K, 2)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wbeg = blockIdx.x * tile_cols;
  const int wend = min(W, wbeg + tile_cols);
  const int bbeg = blockIdx.y * tile_rows;
  const int bend = min(B, bbeg + tile_rows);
  for (int i = threadIdx.x; i < tile_rows * K * 2; i += kFThreads) lam[i] = 0.f;
  float* gtile = gpart + (long long)blockIdx.y * 4 * W * K;

  for (int wc = wbeg; wc < wend; wc += kFCols) {
    float uk[KM], g[KM];
#pragma unroll
    for (int k = 0; k < KM; ++k) g[k] = 0.f;
    __syncthreads();  // the last sub-tile's u is consumed
    load_u<KM>(up, W, K, wc, uk, sm.us);
    for (int rb = bbeg; rb < bend; rb += kFRows) {
      __syncthreads();  // the last chunk's t and R are consumed
      load_t<KM>(t1g, t0g, rb, B, K, sm.ts);
      __syncthreads();
      ratios_gamma<KM>(rows, B, W, rb, wc, uk, sm, g, approx);
      __syncthreads();
      float s1[KM], s0[KM];
#pragma unroll
      for (int k = 0; k < KM; ++k) s1[k] = s0[k] = 0.f;
      lambda_accum<KM>(sm, s1, s0);
      float* lr = lam + (rb - bbeg + lane) * K * 2;
      for (int j = 0; j < 4; ++j) {  // warps add in warp order
        __syncthreads();
        if (warp == j && rb + lane < bend) {
#pragma unroll
          for (int k = 0; k < KM; ++k) {
            if (k < K) {
              lr[2 * k] += s1[k];
              lr[2 * k + 1] += s0[k];
            }
          }
        }
      }
    }
    write_gamma<KM>(gtile, W, K, wc, g);
  }
  __syncthreads();
  float* out = lpart + ((long long)blockIdx.x * B + bbeg) * K * 2;
  for (int i = threadIdx.x; i < (bend - bbeg) * K * 2; i += kFThreads)
    out[i] = lam[i];
}

// K6. grid ceil(B/32); dynamic shared memory tile_floats floats.
// l0, l1 (B, K) final raw sums; gpart (gridDim.x, 4W, K).
template <int KM>
__global__ void __launch_bounds__(kFThreads)
stats_v1_kernel(const uint8_t* __restrict__ rows, const float* __restrict__ up,
                const float* __restrict__ t1g, const float* __restrict__ t0g,
                float* __restrict__ l0, float* __restrict__ l1,
                float* __restrict__ gpart, int B, int W, int K) {
  extern __shared__ float smem[];
  const Tile sm = carve<KM>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rb = blockIdx.x * kFRows;
  load_t<KM>(t1g, t0g, rb, B, K, sm.ts);  // the CTA's rows, kept throughout
  float* gtile = gpart + (long long)blockIdx.x * 4 * W * K;
  float s1[KM], s0[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) s1[k] = s0[k] = 0.f;

  for (int wc = 0; wc < W; wc += kFCols) {
    float uk[KM], g[KM];
#pragma unroll
    for (int k = 0; k < KM; ++k) g[k] = 0.f;
    __syncthreads();  // t is staged; the last sub-tile's R and u are consumed
    load_u<KM>(up, W, K, wc, uk, sm.us);
    ratios_gamma<KM>(rows, B, W, rb, wc, uk, sm, g, 0);
    write_gamma<KM>(gtile, W, K, wc, g);
    __syncthreads();
    lambda_accum<KM>(sm, s1, s0);
  }

  float* red = sm.r1;  // (32 rows, KM, 2) fits in R1's 32 x 129 floats
  for (int j = 0; j < 4; ++j) {  // warps add in warp order
    __syncthreads();
    if (warp == j) {
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        float* r = red + (lane * KM + k) * 2;
        r[0] = j ? r[0] + s1[k] : s1[k];
        r[1] = j ? r[1] + s0[k] : s0[k];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kFRows * K; i += kFThreads) {
    const int r = i / K, k = i % K;
    if (rb + r < B) {
      l0[(long long)(rb + r) * K + k] = red[(r * KM + k) * 2];
      l1[(long long)(rb + r) * K + k] = red[(r * KM + k) * 2 + 1];
    }
  }
}

// ---- the K-chunked bodies (K > 64) ----------------------------------------

constexpr int kUS = kFInd + 1;   // u's k stride (individuals + 1)

// Shared floats of the wide tile step: R1, R0 (D, then R), t of the chunk's
// 32 rows for one piece (float2 rows of 32), u of the sub-tile for one
// piece (32 x kUS).
constexpr int kWideTileFloats =
    2 * kFRows * kRStride + kFRows * tt::kKC * 2 + tt::kKC * kUS;

struct WideTile {
  float* r1;   // (32 rows, kRStride)
  float* r0;
  float2* ts;  // (32 rows, 32): t1, t0
  float* us;   // (32, kUS): u, k-major
};

__device__ __forceinline__ WideTile carve_wide(float* smem) {
  WideTile t;
  t.r1 = smem;
  t.r0 = t.r1 + kFRows * kRStride;
  t.ts = reinterpret_cast<float2*>(t.r0 + kFRows * kRStride);
  t.us = reinterpret_cast<float*>(t.ts + kFRows * tt::kKC);
  return t;
}

// Stage piece [k0, k0 + kw) of u of the sub-tile at byte column wc
// (individual n = plane n / 32, column wc + n % 32; coalesced reads along
// K, conflict-free k-major writes) and of t of rows [rb, rb + 32).
__device__ __forceinline__ void stage_piece_wide(
    const float* __restrict__ up, const float* __restrict__ t1g,
    const float* __restrict__ t0g, int B, int W, int K, int rb, int wc,
    int k0, int kw, const WideTile& sm) {
  for (int j = threadIdx.x; j < kFInd * kw; j += kFThreads) {
    const int n = j / kw, k = j % kw;
    const int w = wc + (n & 31);
    sm.us[k * kUS + n] =
        w < W && k0 + k < K ? up[((long long)(n >> 5) * W + w) * K + k0 + k]
                            : 0.f;
  }
  for (int j = threadIdx.x; j < kFRows * kw; j += kFThreads) {
    const int r = j / kw, k = j % kw;
    const long long o = (long long)(rb + r) * K + k0 + k;
    sm.ts[r * tt::kKC + k] = k0 + k < K && rb + r < B
                                 ? make_float2(t1g[o], t0g[o])
                                 : make_float2(0.f, 0.f);
  }
}

// D of rows [rb, rb+32) x the thread's individual over the staged piece,
// added into its own column of R1/R0 (first piece: stored).
__device__ __forceinline__ void d_piece_wide(const WideTile& sm, int kw,
                                             bool first) {
  constexpr int RB = 8;  // rows at once
  const int n = threadIdx.x;
  for (int r0 = 0; r0 < kFRows; r0 += RB) {
    float d1[RB], d0[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      d1[i] = first ? 0.f : sm.r1[(r0 + i) * kRStride + n];
      d0[i] = first ? 0.f : sm.r0[(r0 + i) * kRStride + n];
    }
    for (int k = 0; k < kw; k += 4) {
      const float u0 = sm.us[k * kUS + n], u1 = sm.us[(k + 1) * kUS + n],
                  u2 = sm.us[(k + 2) * kUS + n], u3 = sm.us[(k + 3) * kUS + n];
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        // (t1, t0) of columns k .. k + 3
        const float4* tr =
            reinterpret_cast<const float4*>(sm.ts + (r0 + i) * tt::kKC + k);
        const float4 a = tr[0], c = tr[1];
        d1[i] = fmaf(a.x, u0, d1[i]);
        d0[i] = fmaf(a.y, u0, d0[i]);
        d1[i] = fmaf(a.z, u1, d1[i]);
        d0[i] = fmaf(a.w, u1, d0[i]);
        d1[i] = fmaf(c.x, u2, d1[i]);
        d0[i] = fmaf(c.y, u2, d0[i]);
        d1[i] = fmaf(c.z, u3, d1[i]);
        d0[i] = fmaf(c.w, u3, d0[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      sm.r1[(r0 + i) * kRStride + n] = d1[i];
      sm.r0[(r0 + i) * kRStride + n] = d0[i];
    }
  }
}

// D over all K of rows [rb, rb+32) x the sub-tile at wc into R1/R0, a
// piece at a time, the chunk's own piece (kc0 / 32 of np) last.
__device__ __forceinline__ void d_all_wide(
    const float* __restrict__ up, const float* __restrict__ t1g,
    const float* __restrict__ t0g, int B, int W, int K, int rb, int wc,
    int np, const WideTile& sm) {
  for (int q = 1; q <= np; ++q) {
    const int p = (blockIdx.z + q) % np;
    const int kw = min(tt::kKC, tt::round4(K) - p * tt::kKC);
    __syncthreads();  // the last piece, R and lambda block are read
    stage_piece_wide(up, t1g, t0g, B, W, K, rb, wc, p * tt::kKC, kw, sm);
    __syncthreads();
    d_piece_wide(sm, kw, q == 1);
  }
}

// Phase 1, wide: R = A / (D + eps) of rows [rb, rb+32) x the thread's
// individual in place of D, and g += r1 t1 + r0 t0 over the chunk's kwc
// columns (the staged piece).
__device__ __forceinline__ void ratios_gamma_wide(
    const uint8_t* __restrict__ rows, int B, int W, int rb, int wc, int kwc,
    const WideTile& sm, float* g, int approx) {
  const int s = threadIdx.x >> 5, w = wc + (threadIdx.x & 31);
  const bool ok = w < W;
  for (int r = 0; r < kFRows; ++r) {
    const int b = rb + r;
    const uint32_t code =
        ok && b < B ? (rows[(long long)b * W + w] >> (2 * s)) & 3u : 3u;
    float x1 = 0.f, x0 = 0.f;
    if (code != 3u) {
      const float a1 = (float)code;
      const float a0 = 2.f - a1;
      x1 = tt::ratio(a1, sm.r1[r * kRStride + threadIdx.x], approx);
      x0 = tt::ratio(a0, sm.r0[r * kRStride + threadIdx.x], approx);
      const float2* tr = sm.ts + r * tt::kKC;
#pragma unroll
      for (int j = 0; j < tt::kKC; ++j) {
        if (j < kwc) {
          const float2 t = tr[j];
          g[j] = fmaf(x1, t.x, g[j]);
          g[j] = fmaf(x0, t.y, g[j]);
        }
      }
    }
    sm.r1[r * kRStride + threadIdx.x] = x1;
    sm.r0[r * kRStride + threadIdx.x] = x0;
  }
}

// Phase 2, wide: lane = row, warp = plane; s += R U over the warp's 32
// individuals for the chunk's kwc columns (the staged piece), in column
// order.
__device__ __forceinline__ void lambda_accum_wide(const WideTile& sm,
                                                  int kwc, float* s1,
                                                  float* s0) {
  const int lane = threadIdx.x & 31, j0 = (threadIdx.x >> 5) * 32;
  for (int jj = 0; jj < 32; ++jj) {
    const int j = j0 + jj;
    const float x1 = sm.r1[lane * kRStride + j];
    const float x0 = sm.r0[lane * kRStride + j];
#pragma unroll
    for (int kk = 0; kk < tt::kKC; ++kk) {
      if (kk < kwc) {
        const float u = sm.us[kk * kUS + j];
        s1[kk] = fmaf(x1, u, s1[kk]);
        s0[kk] = fmaf(x0, u, s0[kk]);
      }
    }
  }
}

__device__ __forceinline__ void write_gamma_wide(float* gtile, int W, int K,
                                                 int wc, int kc0,
                                                 const float* g) {
  const int s = threadIdx.x >> 5, w = wc + (threadIdx.x & 31);
  if (w >= W) return;
  float* out = gtile + ((long long)s * W + w) * K;
#pragma unroll
  for (int j = 0; j < tt::kKC; ++j)
    if (kc0 + j < K) out[kc0 + j] = g[j];
}

// K7, wide. grid (ceil(W/tile_cols), ceil(B/tile_rows), ceil(K/32));
// dynamic shared memory kWideTileFloats + tile_rows*32*2 floats.
// lpart (gridDim.x, B, K, 2), gpart (gridDim.y, 4W, K): CTA z writes
// k in [32 z, 32 z + 32).
__global__ void __launch_bounds__(kFThreads)
stats_v2_wide_kernel(const uint8_t* __restrict__ rows,
                     const float* __restrict__ up,
                     const float* __restrict__ t1g,
                     const float* __restrict__ t0g, float* __restrict__ lpart,
                     float* __restrict__ gpart, int B, int W, int K,
                     int tile_rows, int tile_cols, int approx) {
  extern __shared__ __align__(16) float wide_smem[];
  const WideTile sm = carve_wide(wide_smem);
  float* lam = wide_smem + kWideTileFloats;    // (tile_rows, kKC, 2)
  constexpr int kLam = tt::kKC * 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wbeg = blockIdx.x * tile_cols;
  const int wend = min(W, wbeg + tile_cols);
  const int bbeg = blockIdx.y * tile_rows;
  const int bend = min(B, bbeg + tile_rows);
  const int np = gridDim.z;                    // pieces = chunks
  const int kc0 = blockIdx.z * tt::kKC;
  const int kwc = min(tt::kKC, tt::round4(K) - kc0);
  for (int i = threadIdx.x; i < tile_rows * kLam; i += kFThreads) lam[i] = 0.f;
  float* gtile = gpart + (long long)blockIdx.y * 4 * W * K;

  for (int wc = wbeg; wc < wend; wc += kFCols) {
    float g[tt::kKC];
#pragma unroll
    for (int j = 0; j < tt::kKC; ++j) g[j] = 0.f;
    for (int rb = bbeg; rb < bend; rb += kFRows) {
      d_all_wide(up, t1g, t0g, B, W, K, rb, wc, np, sm);
      ratios_gamma_wide(rows, B, W, rb, wc, kwc, sm, g, approx);
      __syncthreads();
      float s1[tt::kKC], s0[tt::kKC];
#pragma unroll
      for (int j = 0; j < tt::kKC; ++j) s1[j] = s0[j] = 0.f;
      lambda_accum_wide(sm, kwc, s1, s0);
      float* lr = lam + (rb - bbeg + lane) * kLam;
      for (int j = 0; j < 4; ++j) {  // warps add in warp order
        __syncthreads();
        if (warp == j && rb + lane < bend) {
#pragma unroll
          for (int kk = 0; kk < tt::kKC; ++kk) {
            lr[2 * kk] += s1[kk];
            lr[2 * kk + 1] += s0[kk];
          }
        }
      }
    }
    write_gamma_wide(gtile, W, K, wc, kc0, g);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (bend - bbeg) * kLam; i += kFThreads) {
    const int r = i / kLam, kk = (i % kLam) / 2;
    if (kc0 + kk < K)
      lpart[(((long long)blockIdx.x * B + bbeg + r) * K + kc0 + kk) * 2 +
            i % 2] = lam[i];
  }
}

// K6, wide. grid (ceil(B/32), 1, ceil(K/32)); dynamic shared memory
// kWideTileFloats floats. l0, l1 (B, K); gpart (gridDim.x, 4W, K): CTA z
// writes k in [32 z, 32 z + 32).
__global__ void __launch_bounds__(kFThreads)
stats_v1_wide_kernel(const uint8_t* __restrict__ rows,
                     const float* __restrict__ up,
                     const float* __restrict__ t1g,
                     const float* __restrict__ t0g, float* __restrict__ l0,
                     float* __restrict__ l1, float* __restrict__ gpart, int B,
                     int W, int K) {
  extern __shared__ __align__(16) float wide_smem[];
  const WideTile sm = carve_wide(wide_smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rb = blockIdx.x * kFRows;
  const int np = gridDim.z;                    // pieces = chunks
  const int kc0 = blockIdx.z * tt::kKC;
  const int kwc = min(tt::kKC, tt::round4(K) - kc0);
  float* gtile = gpart + (long long)blockIdx.x * 4 * W * K;
  float s1[tt::kKC], s0[tt::kKC];
#pragma unroll
  for (int j = 0; j < tt::kKC; ++j) s1[j] = s0[j] = 0.f;

  for (int wc = 0; wc < W; wc += kFCols) {
    float g[tt::kKC];
#pragma unroll
    for (int j = 0; j < tt::kKC; ++j) g[j] = 0.f;
    d_all_wide(up, t1g, t0g, B, W, K, rb, wc, np, sm);
    ratios_gamma_wide(rows, B, W, rb, wc, kwc, sm, g, 0);
    write_gamma_wide(gtile, W, K, wc, kc0, g);
    __syncthreads();
    lambda_accum_wide(sm, kwc, s1, s0);
  }

  float* red = sm.r1;  // (32 rows, kKC, 2) fits in R1's 32 x 129 floats
  for (int j = 0; j < 4; ++j) {  // warps add in warp order
    __syncthreads();
    if (warp == j) {
#pragma unroll
      for (int kk = 0; kk < tt::kKC; ++kk) {
        float* r = red + (lane * tt::kKC + kk) * 2;
        r[0] = j ? r[0] + s1[kk] : s1[kk];
        r[1] = j ? r[1] + s0[kk] : s0[kk];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kFRows * tt::kKC; i += kFThreads) {
    const int r = i / tt::kKC, kk = i % tt::kKC;
    if (rb + r < B && kc0 + kk < K) {
      l0[(long long)(rb + r) * K + kc0 + kk] = red[i * 2];
      l1[(long long)(rb + r) * K + kc0 + kk] = red[i * 2 + 1];
    }
  }
}

}  // namespace

extern "C" int tt_batch_stats_fused_v2(
    const uint8_t* rows, const float* up, const float* t1, const float* t0,
    float* l0, float* l1, float* g, float* lpart, float* gpart, int B, int W,
    int K, int tile_rows, int tile_cols, int approx, cudaStream_t stream) {
  const int km = tt::pick_km(K);
  if (B <= 0 || W <= 0 || km < 0 || tile_rows <= 0 || tile_cols <= 0 ||
      tile_rows % kFRows || tile_cols % kFCols)
    return (int)cudaErrorInvalidValue;
  const int nwt = (W + tile_cols - 1) / tile_cols;
  const int nbt = (B + tile_rows - 1) / tile_rows;
  const dim3 grid(nwt, nbt);
  if (km == tt::kWide) {
    const int bytes =
        (kWideTileFloats + tile_rows * tt::kKC * 2) * (int)sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(
        stats_v2_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    stats_v2_wide_kernel<<<dim3(nwt, nbt, tt::wide_chunks(K)), kFThreads,
                           bytes, stream>>>(rows, up, t1, t0, lpart, gpart, B,
                                            W, K, tile_rows, tile_cols,
                                            approx);
  } else {
#define TT_LAUNCH(KM)                                                        \
  {                                                                          \
    const int bytes =                                                        \
        (tile_floats<KM>() + tile_rows * K * 2) * (int)sizeof(float);        \
    const cudaError_t e = cudaFuncSetAttribute(                              \
        stats_v2_kernel<KM>, cudaFuncAttributeMaxDynamicSharedMemorySize,    \
        bytes);                                                              \
    if (e != cudaSuccess) return (int)e;                                     \
    stats_v2_kernel<KM><<<grid, kFThreads, bytes, stream>>>(                 \
        rows, up, t1, t0, lpart, gpart, B, W, K, tile_rows, tile_cols,       \
        approx);                                                             \
  }
  TT_DISPATCH_KM(km, TT_LAUNCH)
#undef TT_LAUNCH
  }
  TT_CHECK_LAUNCH();
  const int bk = B * K;
  tt::split_reduce_kernel<<<(bk + 255) / 256, 256, 0, stream>>>(lpart, nwt,
                                                                bk, l0, l1);
  TT_CHECK_LAUNCH();
  const long long ng = 4LL * W * K;
  tt::gamma_reduce_kernel<<<(unsigned)((ng + 255) / 256), 256, 0, stream>>>(
      gpart, nbt, ng, g);
  TT_CHECK_LAUNCH();
  return 0;
}

extern "C" int tt_batch_stats_fused(const uint8_t* rows, const float* up,
                                    const float* t1, const float* t0,
                                    float* l0, float* l1, float* g,
                                    float* gpart, int B, int W, int K,
                                    cudaStream_t stream) {
  const int km = tt::pick_km(K);
  if (B <= 0 || W <= 0 || km < 0) return (int)cudaErrorInvalidValue;
  const int nbt = (B + kFRows - 1) / kFRows;
  if (km == tt::kWide) {
    const int bytes = kWideTileFloats * (int)sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(
        stats_v1_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    stats_v1_wide_kernel<<<dim3(nbt, 1, tt::wide_chunks(K)), kFThreads,
                           bytes, stream>>>(rows, up, t1, t0, l0, l1, gpart,
                                            B, W, K);
  } else {
#define TT_LAUNCH(KM)                                                        \
  {                                                                          \
    const int bytes = tile_floats<KM>() * (int)sizeof(float);                \
    const cudaError_t e = cudaFuncSetAttribute(                              \
        stats_v1_kernel<KM>, cudaFuncAttributeMaxDynamicSharedMemorySize,    \
        bytes);                                                              \
    if (e != cudaSuccess) return (int)e;                                     \
    stats_v1_kernel<KM><<<nbt, kFThreads, bytes, stream>>>(                  \
        rows, up, t1, t0, l0, l1, gpart, B, W, K);                           \
  }
  TT_DISPATCH_KM(km, TT_LAUNCH)
#undef TT_LAUNCH
  }
  TT_CHECK_LAUNCH();
  const long long ng = 4LL * W * K;
  tt::gamma_reduce_kernel<<<(unsigned)((ng + 255) / 256), 256, 0, stream>>>(
      gpart, nbt, ng, g);
  TT_CHECK_LAUNCH();
  return 0;
}
