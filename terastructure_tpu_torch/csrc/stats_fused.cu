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

}  // namespace

extern "C" int tt_batch_stats_fused_v2(
    const uint8_t* rows, const float* up, const float* t1, const float* t0,
    float* l0, float* l1, float* g, float* lpart, float* gpart, int B, int W,
    int K, int tile_rows, int tile_cols, int approx, cudaStream_t stream) {
  const int km = tt::pick_km(K);
  if (B <= 0 || W <= 0 || km == 0 || tile_rows <= 0 || tile_cols <= 0 ||
      tile_rows % kFRows || tile_cols % kFCols)
    return (int)cudaErrorInvalidValue;
  const int nwt = (W + tile_cols - 1) / tile_cols;
  const int nbt = (B + tile_rows - 1) / tile_rows;
  const dim3 grid(nwt, nbt);
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
  if (B <= 0 || W <= 0 || km == 0) return (int)cudaErrorInvalidValue;
  const int nbt = (B + kFRows - 1) / kFRows;
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
  TT_CHECK_LAUNCH();
  const long long ng = 4LL * W * K;
  tt::gamma_reduce_kernel<<<(unsigned)((ng + 255) / 256), 256, 0, stream>>>(
      gpart, nbt, ng, g);
  TT_CHECK_LAUNCH();
  return 0;
}
