// Device code shared by the port's kernels: K1 and K2 (fused_solve.cuh), K4
// (stats_packed.cu), K5 (stats_gamma.cu), K7/K6 (stats_fused.cu) and K8
// (stats_acat.cu).
//
// `lambda_pass_kernel<KM, Loader>` is one raw lambda-statistic pass:
//
//   for every row b and individual n (byte w = n / 4, plane s = n % 4):
//     a1, a0 = the allele counts of (b, n)  (MISSING counts 0 for both)
//     D1 = sum_k t1[b,k] u[n,k],  D0 = sum_k t0[b,k] u[n,k]
//     S1[b,k] += a1 / (D1 + 1e-30) * u[n,k],  S0[b,k] += a0 / (D0 + 1e-30) * u[n,k]
//
// The Loader says where the counts come from: `PackedLoader<Rows>`
// decodes 2-bit packed rows (K1, K2, K4), `AcatLoader` reads pre-decoded
// bf16 count planes (K8). Everything else is one body.
//
// `Rows` says where each packed row of the batch lies: `ContiguousRows`
// is a gathered (B, W) matrix (K1, K4, K5); `GroupedRows` is K2's batch,
// B/g groups of g consecutive rows read straight out of the packed
// (L, W) matrix at the group starts idx0. A CTA looks its rows' starts up
// once, into a table in shared memory, so the pass code is one.
//
// Layout: one lane per row (32 rows per CTA), so t and the two K-vectors
// of sums sit in the lane's registers for the whole pass and every u[n,:]
// read is a broadcast (all lanes read the same address). The CTA stages
// its 32 rows in shared memory a tile of columns at a time, with an odd
// word stride so the 32 lanes' word reads hit 32 different banks; its 8
// warps take interleaved units of the tile. The column range of a row is
// split over gridDim.y CTAs to fill the card at small B; each CTA writes
// its partial sums and `split_reduce_kernel` adds them in split order.
// The 8 warps' sums are added in warp order. No atomics: the result is
// bitwise reproducible.
//
// `gamma_pass_kernel<KM, Rows>` is the planar gamma statistic
// g[s*W+w, k] = sum_b r1[b,n] t1[b,k] + r0[b,n] t0[b,k] over a slice of
// rows (K1's last pass and K5); `gamma_reduce_kernel` adds the slices in
// order.
//
// Bound on the H100: per individual and row, 4K FMAs, two divides and K
// shared/L1 broadcast loads; a pass is bound by issue (FMA + divide), not
// by bytes (PERF.md). Tensor cores (wgmma) are the later step.
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

__device__ __forceinline__ float ratio(float a, float d, int approx) {
  return approx ? __fdividef(a, d + kEps) : a / (d + kEps);
}

// Batch row b of a gathered (B, W) matrix starts at rows + b*W.
struct ContiguousRows {
  const uint8_t* rows;
  __device__ __forceinline__ const uint8_t* row(int b, int W) const {
    return rows + (long long)b * W;
  }
};

// K2's batch: B/group groups of `group` consecutive rows of the packed
// (L, W) matrix; group j starts at row idx0[j]. A start that is not a
// multiple of `group` in [0, L - group] gives an all-MISSING group
// (nullptr), so the kernel never reads outside the matrix.
struct GroupedRows {
  const uint8_t* packed;
  const int* idx0;
  int group;
  long long L;
  __device__ __forceinline__ const uint8_t* row(int b, int W) const {
    const long long s = idx0[b / group];
    if (s < 0 || s > L - group || s % group) return nullptr;
    return packed + (s + b % group) * W;
  }
};

// 2-bit packed rows, located by `Rows`. A tile is 512 byte columns; a
// unit is one 32-bit word (4 columns x 4 planes), skipped whole when all
// MISSING. `prepare` fills the CTA's row table (rowp, in shared memory)
// once; `stage` reads the rows through it (a null row reads as MISSING).
template <class Rows>
struct PackedLoader {
  static constexpr int kCols = 512;
  static constexpr int kColsPerUnit = 4;
  static constexpr int kStride = kCols / 4 + 1;          // words, odd
  static constexpr int kSmemWords = kRowsPerCta * kStride;
  Rows src;

  __device__ void prepare(const uint8_t** rowp, int b0, int B, int W) const {
    const int r = threadIdx.x;
    if (r < kRowsPerCta) rowp[r] = b0 + r < B ? src.row(b0 + r, W) : nullptr;
  }

  __device__ void stage(uint32_t* tile, const uint8_t* const* rowp, int b0,
                        int B, int W, int w0, int nb) const {
    uint8_t* tb = reinterpret_cast<uint8_t*>(tile);
    for (int i = threadIdx.x; i < kRowsPerCta * kCols; i += kThreads) {
      const int r = i / kCols, c = i % kCols;
      const uint8_t* p = rowp[r];
      uint8_t v = 0xFF;  // outside the matrix: MISSING
      if (p != nullptr && c < nb) v = p[w0 + c];
      tb[r * kStride * 4 + c] = v;
    }
  }

  // f(col, s, a1, a0) for each present entry of `unit` in lane's row.
  template <class F>
  __device__ __forceinline__ void visit(const uint32_t* tile, int lane,
                                        int unit, F&& f) const {
    const uint32_t word = tile[lane * kStride + unit];
    if (word == 0xFFFFFFFFu) return;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint32_t code = (word >> (8 * c + 2 * s)) & 3u;
        if (code == 3u) continue;
        const float a1 = (float)code;
        f(unit * 4 + c, s, a1, 2.f - a1);
      }
    }
  }
};

// Pre-decoded count planes a1, a0 (B, 4, W) bf16 (raw bits as uint16).
// A tile is 32 columns x 4 planes; each staged word holds the pair
// (a1 bits, a0 bits), 0 where both counts are 0 (nothing to add). A unit
// is one column.
struct AcatLoader {
  static constexpr int kCols = 32;
  static constexpr int kColsPerUnit = 1;
  static constexpr int kStride = 4 * kCols + 1;          // words, odd
  static constexpr int kSmemWords = kRowsPerCta * kStride;
  const uint16_t* a1;
  const uint16_t* a0;

  __device__ void prepare(const uint8_t**, int, int, int) const {}

  __device__ void stage(uint32_t* tile, const uint8_t* const*, int b0, int B,
                        int W, int w0, int nb) const {
    for (int i = threadIdx.x; i < kRowsPerCta * 4 * kCols; i += kThreads) {
      const int r = i / (4 * kCols), rem = i % (4 * kCols);
      const int s = rem / kCols, c = rem % kCols;
      uint32_t v = 0;
      if (b0 + r < B && c < nb) {
        const long long off = ((long long)(b0 + r) * 4 + s) * W + w0 + c;
        v = (uint32_t)a1[off] | ((uint32_t)a0[off] << 16);
      }
      tile[r * kStride + s * kCols + c] = v;
    }
  }

  template <class F>
  __device__ __forceinline__ void visit(const uint32_t* tile, int lane,
                                        int unit, F&& f) const {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t v = tile[lane * kStride + s * kCols + unit];
      if (v == 0u) continue;
      f(unit, s, __uint_as_float(v << 16), __uint_as_float(v & 0xFFFF0000u));
    }
  }
};

// One raw lambda pass. grid (ceil(B/32), nsplit), block kThreads.
// t1[b*ts + k*tk], t0 likewise; part (nsplit, B, K, 2): [...,0] = S1 (the
// lambda0 statistic), [...,1] = S0. `active` (may be null): skip the pass
// when *active == 0. approx: fast divide (__fdividef).
template <int KM, class Loader>
__global__ void __launch_bounds__(kThreads)
lambda_pass_kernel(Loader ld, const float* __restrict__ up,
                   const float* __restrict__ t1g,
                   const float* __restrict__ t0g, int ts, int tk,
                   float* __restrict__ part, int B, int W, int K, int wchunk,
                   int approx, const int* __restrict__ active) {
  if (active != nullptr && *active == 0) return;
  __shared__ uint32_t tile[Loader::kSmemWords];
  __shared__ float red[kRowsPerCta * KM * 2];
  __shared__ const uint8_t* rowp[kRowsPerCta];  // PackedLoader's row table

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * kRowsPerCta;
  const int b = b0 + lane;
  const bool row_ok = b < B;
  const int wbeg = blockIdx.y * wchunk;
  const int wend = min(W, wbeg + wchunk);

  ld.prepare(rowp, b0, B, W);  // visible after the first tile's barrier
  float t1[KM], t0[KM], s1[KM], s0[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const bool ok = row_ok && k < K;
    t1[k] = ok ? t1g[(long long)b * ts + k * tk] : 0.f;
    t0[k] = ok ? t0g[(long long)b * ts + k * tk] : 0.f;
    s1[k] = 0.f;
    s0[k] = 0.f;
  }

  for (int w0 = wbeg; w0 < wend; w0 += Loader::kCols) {
    const int nb = min(Loader::kCols, wend - w0);
    __syncthreads();  // the previous tile is consumed
    ld.stage(tile, rowp, b0, B, W, w0, nb);
    __syncthreads();
    const int nunits = (nb + Loader::kColsPerUnit - 1) / Loader::kColsPerUnit;
    for (int unit = warp; unit < nunits; unit += kWarps) {
      ld.visit(tile, lane, unit, [&](int col, int s, float a1, float a0) {
        const float* u = up + ((long long)s * W + w0 + col) * K;
        float uk[KM];
        float d1 = 0.f, d0 = 0.f;
#pragma unroll
        for (int k = 0; k < KM; ++k) {
          uk[k] = k < K ? __ldg(u + k) : 0.f;
          d1 = fmaf(t1[k], uk[k], d1);
          d0 = fmaf(t0[k], uk[k], d0);
        }
        const float r1 = ratio(a1, d1, approx);
        const float r0 = ratio(a0, d0, approx);
#pragma unroll
        for (int k = 0; k < KM; ++k) {
          s1[k] = fmaf(r1, uk[k], s1[k]);
          s0[k] = fmaf(r0, uk[k], s0[k]);
        }
      });
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

constexpr int kGThreads = 128;  // individuals per gamma CTA
constexpr int kGRows = 64;      // rows of t staged in shared memory at once

// Partial planar gamma statistic over rows [y*bchunk, (y+1)*bchunk):
// gpart[y, i, k] = sum_b r1[b,i] t1[b,k] + r0[b,i] t0[b,k] for the planar
// individual i = s*W + w, t1[b*ts + k*tk] and t0 likewise (exact divide).
// One thread per individual: u[i,:] and the K sums stay in registers,
// rows of t and the rows' starts (located by `Rows`) are staged in shared
// memory and read as broadcasts, and a warp's packed-byte reads are
// coalesced.
template <int KM, class Rows>
__global__ void __launch_bounds__(kGThreads)
gamma_pass_kernel(Rows src, const float* __restrict__ up,
                  const float* __restrict__ t1g,
                  const float* __restrict__ t0g, int ts, int tk,
                  float* __restrict__ gpart, int B, int W, int K, int bchunk) {
  __shared__ float tsm[kGRows * KM * 2];
  __shared__ const uint8_t* rowp[kGRows];
  const int i = blockIdx.x * kGThreads + threadIdx.x;
  const bool ok = i < 4 * W;
  const int s = ok ? i / W : 0;
  const int w = ok ? i % W : 0;
  float uk[KM], g[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    uk[k] = ok && k < K ? up[(long long)i * K + k] : 0.f;
    g[k] = 0.f;
  }
  const int bbeg = blockIdx.y * bchunk;
  const int bend = min(B, bbeg + bchunk);
  for (int c0 = bbeg; c0 < bend; c0 += kGRows) {
    const int nr = min(kGRows, bend - c0);
    __syncthreads();
    for (int j = threadIdx.x; j < nr * KM * 2; j += kGThreads) {
      const int r = j / (KM * 2), rem = j % (KM * 2);
      const int k = rem / 2;
      const float* tg = rem % 2 ? t0g : t1g;
      tsm[j] = k < K ? tg[(long long)(c0 + r) * ts + k * tk] : 0.f;
    }
    for (int r = threadIdx.x; r < nr; r += kGThreads)
      rowp[r] = src.row(c0 + r, W);
    __syncthreads();
    for (int r = 0; r < nr; ++r) {
      const uint8_t* p = rowp[r];
      const uint32_t code = ok && p != nullptr ? (p[w] >> (2 * s)) & 3u : 3u;
      if (code == 3u) continue;
      const float a1 = (float)code;
      const float a0 = 2.f - a1;
      const float* tr = tsm + r * KM * 2;
      float d1 = 0.f, d0 = 0.f;
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        d1 = fmaf(tr[2 * k], uk[k], d1);
        d0 = fmaf(tr[2 * k + 1], uk[k], d0);
      }
      const float r1 = a1 / (d1 + kEps);
      const float r0 = a0 / (d0 + kEps);
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        g[k] = fmaf(r1, tr[2 * k], g[k]);
        g[k] = fmaf(r0, tr[2 * k + 1], g[k]);
      }
    }
  }
  if (!ok) return;
  float* out = gpart + ((long long)blockIdx.y * 4 * W + i) * K;
#pragma unroll
  for (int k = 0; k < KM; ++k)
    if (k < K) out[k] = g[k];
}

namespace {  // one copy per translation unit (no template to share)

// g[j] = sum_y gpart[y, j], y in order.
__global__ void gamma_reduce_kernel(const float* __restrict__ gpart,
                                    int nsplit, long long n,
                                    float* __restrict__ g) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float a = 0.f;
  for (int y = 0; y < nsplit; ++y) a += gpart[(long long)y * n + j];
  g[j] = a;
}

// l0[i] = sum_s part[s, i, 0], l1[i] = sum_s part[s, i, 1], s in order.
__global__ void split_reduce_kernel(const float* __restrict__ part,
                                    int nsplit, int bk, float* __restrict__ l0,
                                    float* __restrict__ l1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bk) return;
  float a = 0.f, c = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    a += part[((long long)s * bk + i) * 2];
    c += part[((long long)s * bk + i) * 2 + 1];
  }
  l0[i] = a;
  l1[i] = c;
}

}  // namespace

// Launch the gamma pass over `nsplit` row slices and their reduction.
// gpart (nsplit, 4W, K) scratch, g (4, W, K).
template <int KM, class Rows>
int gamma_stats(Rows src, const float* up, const float* t1g,
                const float* t0g, int ts, int tk, float* gpart, float* g,
                int B, int W, int K, int nsplit, cudaStream_t stream) {
  const int bchunk = (B + nsplit - 1) / nsplit;
  const dim3 grid((4 * W + kGThreads - 1) / kGThreads, nsplit);
  gamma_pass_kernel<KM, Rows><<<grid, kGThreads, 0, stream>>>(
      src, up, t1g, t0g, ts, tk, gpart, B, W, K, bchunk);
  TT_CHECK_LAUNCH();
  const long long ng = 4LL * W * K;
  gamma_reduce_kernel<<<(unsigned)((ng + 255) / 256), 256, 0, stream>>>(
      gpart, nsplit, ng, g);
  TT_CHECK_LAUNCH();
  return 0;
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
