// Device code shared by K1 (fused_step.cu) and K4 (stats_packed.cu).
//
// `lambda_pass_kernel` is one raw lambda-statistic pass from 2-bit packed
// rows, the body both kernels run:
//
//   for every row b and individual n (byte w = n / 4, plane s = n % 4):
//     a1 = code, a0 = 2 - code      (code 3 = MISSING counts 0 for both)
//     D1 = sum_k t1[b,k] u[n,k],  D0 = sum_k t0[b,k] u[n,k]
//     S1[b,k] += a1 / (D1 + 1e-30) * u[n,k],  S0[b,k] += a0 / (D0 + 1e-30) * u[n,k]
//
// Layout: one lane per row (32 rows per CTA), so t and the two K-vectors
// of sums sit in the lane's registers for the whole pass and every u[n,:]
// read is a broadcast (all lanes read the same address). The CTA stages
// its 32 rows in shared memory, 512 bytes at a time, with an odd word
// stride so the 32 lanes' word reads hit 32 different banks; its 8 warps
// take interleaved words of the tile. The byte range of a row is split
// over gridDim.y CTAs to fill the card at small B; each CTA writes its
// partial sums and a later kernel adds them in split order. The 8 warps'
// sums are added in warp order. No atomics: the result is bitwise
// reproducible.
//
// Bound on the H100: per individual and row, 4K FMAs, two divides and
// K shared/L1 broadcast loads; at the TGP shape (B=4096, W=640, K=8) a
// pass is ~0.34 G FMA and ~21 M divides against ~2.6 MB of packed rows,
// so it is bound by issue (FMA + divide), not by bytes. Tensor cores
// (wgmma) are the later step.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define TT_CHECK_LAUNCH()                                   \
  do {                                                      \
    cudaError_t e_ = cudaGetLastError();                    \
    if (e_ != cudaSuccess) return (int)e_;                  \
  } while (0)

namespace tt {

constexpr float kEps = 1e-30f;
constexpr int kRowsPerCta = 32;                 // one row per lane
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileBytes = 512;                 // byte columns per smem tile
constexpr int kTileWords = kTileBytes / 4;
constexpr int kStrideWords = kTileWords + 1;    // odd: conflict-free lanes

// Digamma for x > 0: the reference kernel's (fused_step.py:43-66) six
// conditional recurrence shifts to x >= 6, then the asymptotic series.
__device__ __forceinline__ float digamma(float x) {
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const bool small = x < 6.f;
    acc -= small ? 1.f / x : 0.f;
    x = small ? x + 1.f : x;
  }
  const float inv = 1.f / x;
  const float inv2 = inv * inv;
  const float series =
      logf(x) - 0.5f * inv -
      inv2 * (1.f / 12.f - inv2 * (1.f / 120.f - inv2 / 252.f));
  return acc + series;
}

// (t1, t0) = exp E[log beta], exp E[log(1 - beta)] for Beta(l0, l1).
__device__ __forceinline__ void exp_elog_beta(float l0, float l1, float& t1,
                                              float& t0) {
  const float tot = digamma(l0 + l1);
  t1 = expf(digamma(l0) - tot);
  t0 = expf(digamma(l1) - tot);
}

// One raw lambda pass. grid (ceil(B/32), nsplit), block kThreads.
// t1[b*ts + k*tk], t0 likewise; part (nsplit, B, K, 2): [...,0] = S1 (the
// lambda0 statistic), [...,1] = S0. `active` (may be null): skip the pass
// when *active == 0. approx: fast divide (__fdividef).
template <int KM>
__global__ void __launch_bounds__(kThreads)
lambda_pass_kernel(const uint8_t* __restrict__ rows,
                   const float* __restrict__ up,
                   const float* __restrict__ t1g,
                   const float* __restrict__ t0g, int ts, int tk,
                   float* __restrict__ part, int B, int W, int K, int wchunk,
                   int approx, const int* __restrict__ active) {
  if (active != nullptr && *active == 0) return;
  __shared__ uint32_t tile[kRowsPerCta * kStrideWords];
  __shared__ float red[kRowsPerCta * KM * 2];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * kRowsPerCta;
  const int b = b0 + lane;
  const bool row_ok = b < B;
  const int wbeg = blockIdx.y * wchunk;
  const int wend = min(W, wbeg + wchunk);

  float t1[KM], t0[KM], s1[KM], s0[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const bool ok = row_ok && k < K;
    t1[k] = ok ? t1g[(long long)b * ts + k * tk] : 0.f;
    t0[k] = ok ? t0g[(long long)b * ts + k * tk] : 0.f;
    s1[k] = 0.f;
    s0[k] = 0.f;
  }

  uint8_t* tile_b = reinterpret_cast<uint8_t*>(tile);
  for (int w0 = wbeg; w0 < wend; w0 += kTileBytes) {
    const int nb = min(kTileBytes, wend - w0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < kRowsPerCta * kTileBytes; i += kThreads) {
      const int r = i / kTileBytes, c = i % kTileBytes;
      uint8_t v = 0xFF;  // outside the matrix: MISSING
      if (b0 + r < B && c < nb) v = rows[(long long)(b0 + r) * W + w0 + c];
      tile_b[r * kStrideWords * 4 + c] = v;
    }
    __syncthreads();
    const int nwords = (nb + 3) / 4;
    for (int wd = warp; wd < nwords; wd += kWarps) {
      const uint32_t word = tile[lane * kStrideWords + wd];
      if (word == 0xFFFFFFFFu) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int w = w0 + wd * 4 + c;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t code = (word >> (8 * c + 2 * s)) & 3u;
          if (code == 3u) continue;
          const float a1 = (float)code;
          const float a0 = 2.f - a1;
          const float* u = up + ((long long)s * W + w) * K;
          float uk[KM];
          float d1 = 0.f, d0 = 0.f;
#pragma unroll
          for (int k = 0; k < KM; ++k) {
            uk[k] = k < K ? __ldg(u + k) : 0.f;
            d1 = fmaf(t1[k], uk[k], d1);
            d0 = fmaf(t0[k], uk[k], d0);
          }
          float r1, r0;
          if (approx) {
            r1 = __fdividef(a1, d1 + kEps);
            r0 = __fdividef(a0, d0 + kEps);
          } else {
            r1 = a1 / (d1 + kEps);
            r0 = a0 / (d0 + kEps);
          }
#pragma unroll
          for (int k = 0; k < KM; ++k) {
            s1[k] = fmaf(r1, uk[k], s1[k]);
            s0[k] = fmaf(r0, uk[k], s0[k]);
          }
        }
      }
    }
  }

  // Add the warps' sums in warp order (deterministic).
  for (int j = 0; j < kWarps; ++j) {
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
  float* out = part + (long long)blockIdx.y * B * K * 2;
  for (int i = threadIdx.x; i < kRowsPerCta * K * 2; i += kThreads) {
    const int r = i / (2 * K), rem = i % (2 * K);
    if (b0 + r < B) {
      out[(long long)(b0 + r) * K * 2 + rem] =
          red[(r * KM + rem / 2) * 2 + rem % 2];
    }
  }
}

// Byte columns per split so that `nsplit` CTAs cover W (multiple of 16).
inline int split_chunk(int W, int nsplit) {
  const int c = (W + nsplit - 1) / nsplit;
  return (c + 15) / 16 * 16;
}

// Smallest instantiated K-width holding K; 0 when K is too large.
inline int pick_km(int K) {
  static const int kms[] = {4, 8, 16, 32, 64};
  for (int km : kms)
    if (K >= 1 && K <= km) return km;
  return 0;
}

}  // namespace tt

// Expand F(KM) for the instantiated K-widths (switch on km).
#define TT_DISPATCH_KM(km, F)        \
  switch (km) {                      \
    case 4: F(4); break;             \
    case 8: F(8); break;             \
    case 16: F(16); break;           \
    case 32: F(32); break;           \
    case 64: F(64); break;           \
    default: return (int)cudaErrorInvalidValue; \
  }
