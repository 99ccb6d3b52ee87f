// Device code shared by the port's kernels: K1 and K2 (fused_solve.cuh), K4
// (stats_packed.cu), K5 (stats_gamma.cu), K7/K6 (stats_fused.cuh) and K8
// (stats_acat.cu).
//
// `lambda_pass_kernel<KM, Loader, kDiv>` is one raw lambda-statistic pass:
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
// It replaces the one-pass bodies of the TPU kernels
// terastructure_tpu/ops/fused_step.py `_make_kernel.one_pass` (:252-308)
// and ops/stats_pallas.py `_lambda_kernel` (:96-112), which run the two
// products on the MXU over VMEM tiles. The f32 path here stays outside the
// tensor cores (TF32 would change its numbers), and wgmma and TMA do not
// apply to an f32 FMA pass whose products are K = 3..10 deep.
//
// What bounds it on the H100: 4K FMAs and two divides an entry against
// two bits of input, so the FP32 rate, never bytes. What keeps a plain
// version far below that is latency: a u row read from global memory is
// an L2 round trip an entry (nothing is reused inside a CTA), an entry is
// two dependent FMA chains and a divide, a branch around each entry keeps
// the compiler from overlapping them, an IEEE divide takes its slow path
// for a zero count, and at B = 1024 a coarse grid leaves most SMs one CTA.
//
// Layout: one lane per row and one warp per 32 rows, for a whole
// chunk of byte columns, so t and the two K-vectors of sums sit in the
// lane's registers for the pass and no sum crosses a warp. A CTA is
// kRowWarps such warps on neighbouring rows. Per tile of columns it
// stages, once for all its rows, the rows' packed words (word-wide loads,
// odd word stride: the lanes' reads hit 32 banks) and the tile's u rows
// padded to KM floats (so a lane reads u[n,:] as float4 broadcasts from
// shared memory and the inner loops carry no `k < K` test). Entries are
// decoded without a branch (MISSING counts 0 for both alleles, which adds
// exactly 0) and taken `G` at a time, so the D chains and the divides of
// neighbouring entries overlap. The column range of a row is split over
// gridDim.y CTAs (`lambda_grid` in ops/stats_packed.py: chunks of 16 to
// 128 byte columns, about 16 warps an SM where the batch allows); each
// CTA writes its partial sums and `split_reduce_kernel` or the solve's
// `update_kernel` adds them in split order. No atomics: a lane adds its
// entries in column order, so the result is bitwise reproducible.
//
// `gamma_pass_kernel<KM, Rows>` is the planar gamma statistic
// g[s*W+w, k] = sum_b r1[b,n] t1[b,k] + r0[b,n] t0[b,k] over a slice of
// rows (K1's and K2's last pass, and K5); `gamma_reduce_kernel` adds the
// slices in order. Its per-thread step, `gamma_rows`, is also K7's phase
// 1 (stats_fused.cuh). It applies the lambda pass's layout to the other
// sum: the rows' packed bytes staged in shared memory with word-wide
// loads, t read as float4 broadcasts, entries decoded without a branch,
// two rows in flight, and KM = 12 for K = 9..12. Its grid
// (`gamma_grid` in ops/stats_packed.py) keeps about four CTAs an SM.
//
// The divides (`ratio`, `Div`): an exact pass gives the bits of the IEEE
// divide as count x IEEE reciprocal; the others use the hardware
// reciprocal, bare (approx_div) or with one Newton step (the fused
// solve's loop passes).
//
// These bodies are instantiated for K-widths KM = 4..64 (`pick_km`; the
// gamma pass also KM = 12). K > 64 goes, by K, through the launchers below
// (`launch_lambda_pass`, `launch_gamma_stats`) to the λ pass of
// lambda_wide.cuh and the γ pass of gamma_wide.cuh (K in pieces of up to
// 128 columns, D once an entry, on the tile of wide_tile.cuh); every kind
// takes the replicate axis (`Rep`). At compute dtype bf16
// (kBf16) the passes at K <= 64 (K1, K2, K4, K5, and K8 over count
// planes), the λ and γ passes at K > 64 and the statistics of K7 and K6
// run tensor-core bodies (psd_mma.cuh, lambda_wide.cuh, gamma_wide.cuh,
// stats_fused.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TT_CHECK_LAUNCH()                                   \
  do {                                                      \
    cudaError_t e_ = cudaGetLastError();                    \
    if (e_ != cudaSuccess) return (int)e_;                  \
  } while (0)

namespace tt {

constexpr float kEps = 1e-30f;
constexpr int kRowWarps = 2;                    // warps of a lambda-pass CTA
constexpr int kThreads = 32 * kRowWarps;
constexpr int kRowsPerCta = kThreads;           // one row per lane

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

// a / (d + 1e-30) for an allele count a, three ways:
//   kDivExact   a * RN(1 / x). The counts are 0, 1 or 2, so this is the
//               correctly rounded quotient itself (scaling by a power of
//               two is exact): the bits of the true divide without the
//               divide's slow path, which a zero numerator takes.
//   kDivFast    the hardware reciprocal (__fdividef, ~2 ulp): approx_div.
//   kDivNewton  the hardware reciprocal and one Newton step, within 1 ulp
//               of RN(1 / x): the IEEE reciprocal's own instructions
//               without its range test and branch, which x = d + 1e-30 in
//               [1e-30, ~K] never needs. The loop and tail passes of the
//               fused solve use it when approx_div is off.
// The final pass of a solve, the gamma pass and every exact call of K4,
// K7 and K8 use kDivExact.
enum Div { kDivExact = 0, kDivFast = 1, kDivNewton = 2 };

template <int kDiv>
__device__ __forceinline__ float ratio(float a, float d) {
  const float x = d + kEps;
  if (kDiv == kDivFast) return __fdividef(a, x);
  if (kDiv == kDivExact) return a * __frcp_rn(x);
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return a * fmaf(r, fmaf(-x, r, 1.f), r);
}

__device__ __forceinline__ float ratio(float a, float d, int approx) {
  return approx ? ratio<kDivFast>(a, d) : ratio<kDivExact>(a, d);
}

// The replicate axis (batched replicates, svi/replicates.py): one launch
// runs R independent problems, replicate z in blockIdx.z. Replicate z's
// arrays start z x stride elements after replicate 0's, one stride per
// kind of array; a stride of 0 shares the array across replicates (K4's
// eval rows). Each body offsets its pointers in its prologue, so R = 1
// (z = 0) is the single call, and each replicate runs on the grid a call
// of its own would, so its sums add in the same order: a replicate's
// result is bitwise the single call's on its inputs.
struct Rep {
  long long rows = 0;  // bytes of the packed rows (K8: count-plane elements)
  long long u = 0;     // floats of the u planes
  long long t = 0;     // floats of t1 and t0 (K1's interleaved t)
  long long part = 0;  // floats of the partial sums
  long long out = 0;   // floats of the reduced outputs
};

// cp.async of 16 (or 4) bytes, filled with zeros past `bytes` (0: none
// read): a tile's copies stay in flight while the CTA computes, until
// `cp_async_wait_group` (the bodies of psd_mma.cuh and wide_tile.cuh).
__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            int bytes) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(a),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4z(void* dst, const void* src,
                                           int bytes) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(a),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// K padded to the k16 steps of D at the K-width a K <= 64 body runs
// (`pick_km`: 16 to K = 16, then 32, then 64): the row width, in bf16, of
// the rounded u and t that the tensor-core passes stage (psd_mma.cuh;
// ops/stats_packed.py `mma_kp`).
__host__ __device__ constexpr int mma_kp(int K) {
  return K <= 16 ? 16 : K <= 32 ? 32 : 64;
}

// Four packed words of a row from byte column c, stopping at byte column
// `end`: cp.async where a word is whole and aligned, else assembled byte
// by byte; a null row and bytes at or past `end` read as MISSING.
__device__ __forceinline__ void stage_words4(uint32_t* dst, const uint8_t* p,
                                             int c, int end) {
#pragma unroll
  for (int e = 0; e < 4; ++e, c += 4) {
    const uint8_t* q = p + c;
    if (p != nullptr && c + 4 <= end &&
        (reinterpret_cast<uintptr_t>(q) & 3) == 0) {
      cp_async4z(dst + e, q, 4);
    } else {
      uint32_t v = 0xFFFFFFFFu;
      for (int j = 0; p != nullptr && j < 4 && c + j < end; ++j) {
        v &= ~(0xFFu << (8 * j));
        v |= (uint32_t)__ldg(q + j) << (8 * j);
      }
      dst[e] = v;
    }
  }
}

// 16 bytes of packed words of a row from byte column c (stopping at
// `end`): one cp.async where they are whole and 16-byte aligned.
__device__ __forceinline__ void stage_words16(uint32_t* dst, const uint8_t* p,
                                              int c, int end) {
  const uint8_t* q = p + c;
  if (p != nullptr && c + 16 <= end &&
      (reinterpret_cast<uintptr_t>(q) & 15) == 0)
    cp_async16z(dst, q, 16);
  else
    stage_words4(dst, p, c, end);
}

// Batch row b of a gathered (B, W) matrix starts at rows + b*W.
struct ContiguousRows {
  const uint8_t* rows;
  __device__ __forceinline__ const uint8_t* row(int b, int W) const {
    return rows + (long long)b * W;
  }
  // replicate z's rows, `off` bytes on (Rep::rows)
  __device__ __forceinline__ ContiguousRows shifted(long long off) const {
    return {rows + off};
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
  // K2 has no replicate axis (its launches are R = 1; the reference's
  // batched fit cannot lift its group DMA under vmap,
  // terastructure_tpu/svi/replicates.py:26-30): one matrix
  __device__ __forceinline__ GroupedRows shifted(long long) const {
    return *this;
  }
};

// A Loader stages a tile of the CTA's rows in shared memory and hands a
// lane its row's entries a unit at a time:
//   cols(km)          byte columns of a tile (sized so that the tile and
//                     the tile's u rows fit the 48 KB of static shared memory)
//   words(tc)         shared-memory words of a tile of tc columns
//   kEntries          entries of a unit, kWords its staged words
//   units(nb)         units of a tile of nb columns
//   load<TC>(...)     the unit's words; false when nothing in it is present
//   entry<TC>(...)    entry e of the unit: its u row in the tile
//                     (plane * TC + column) and its two counts
//
// 2-bit packed rows, located by `Rows`. A unit is one 32-bit word (4
// columns x 4 planes), skipped whole when all MISSING. `prepare` fills the
// CTA's row table (rowp, in shared memory) once; `stage` reads the rows
// through it, a word at a time where the row is word-aligned (a null row
// reads as MISSING).
template <class Rows>
struct PackedLoader {
  static constexpr int kEntries = 16;
  static constexpr int kWords = 1;
  __host__ __device__ static constexpr int cols(int km) {
    return km <= 32 ? 64 : 32;
  }
  __host__ __device__ static constexpr int words(int tc) {
    return kRowsPerCta * (tc / 4 + 1);
  }
  Rows src;

  __device__ __forceinline__ PackedLoader shifted(long long off) const {
    return {src.shifted(off)};
  }

  __device__ void prepare(const uint8_t** rowp, int b0, int B, int W) const {
    const int r = threadIdx.x;
    if (r < kRowsPerCta) rowp[r] = b0 + r < B ? src.row(b0 + r, W) : nullptr;
  }

  template <int TC, int kT = kThreads>
  __device__ void stage(uint32_t* tile, const uint8_t* const* rowp, int b0,
                        int B, int W, int w0, int nb) const {
    constexpr int kStride = TC / 4 + 1;                  // words, odd
    const int nw = (nb + 3) >> 2;
    for (int i = threadIdx.x; i < kRowsPerCta * nw; i += kT) {
      const int r = i / nw, wd = i - r * nw;
      const uint8_t* p = rowp[r];
      uint32_t v = 0xFFFFFFFFu;  // outside the matrix: MISSING
      if (p != nullptr) {
        const uint8_t* q = p + w0 + 4 * wd;
        if (4 * wd + 4 <= nb && (reinterpret_cast<uintptr_t>(q) & 3) == 0) {
          v = __ldg(reinterpret_cast<const uint32_t*>(q));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (4 * wd + j < nb) {
              v &= ~(0xFFu << (8 * j));
              v |= (uint32_t)__ldg(q + j) << (8 * j);
            }
          }
        }
      }
      tile[r * kStride + wd] = v;
    }
  }

  __device__ static int units(int nb) { return (nb + 3) >> 2; }

  template <int TC>
  __device__ __forceinline__ static bool load(const uint32_t* tile, int r,
                                              int unit,
                                              uint32_t (&w)[kWords]) {
    w[0] = tile[r * (TC / 4 + 1) + unit];
    return w[0] != 0xFFFFFFFFu;
  }

  template <int TC>
  __device__ __forceinline__ static void entry(const uint32_t (&w)[kWords],
                                               int unit, int e, int& urow,
                                               float& a1, float& a0) {
    const int c = e >> 2, s = e & 3;
    const uint32_t code = (w[0] >> (8 * c + 2 * s)) & 3u;
    const bool missing = code == 3u;
    const float x = (float)code;
    urow = s * TC + 4 * unit + c;
    a1 = missing ? 0.f : x;
    a0 = missing ? 0.f : 2.f - x;
  }

  // The tensor-core pass (psd_mma.cuh): tiles of 64 byte columns where D
  // and S are one k16 step (K <= 16), else 32, two of them in flight
  // (kMmaStages), so that both tiles and their u fit the 48 KB of static
  // shared memory. A tile's rows are staged by 16-byte cp.async in rows of
  // TC / 4 + 4 words: 16-byte aligned, and the 8 rows g of a warp's read
  // fall into distinct banks. Lane (g, t) of a 16-individual step (a
  // word) takes its row's word, and from it the counts of individuals
  // 8j + 2t + e.
  __host__ __device__ static constexpr int mma_cols(int kn) {
    return kn <= 2 ? 64 : 32;
  }
  __host__ __device__ static constexpr int mma_words(int tc) {
    return kRowsPerCta * (tc / 4 + 4);
  }
  static constexpr int kMmaWords = 1;
  static constexpr int kMmaStages = 2;
  template <int TC, int kT>
  __device__ void stage_mma(uint32_t* tile, const uint8_t* const* rowp, int,
                            int, int, int w0, int nb) const {
    const int nq = (nb + 15) >> 4;                 // 16-byte pieces a row
    for (int i = threadIdx.x; i < kRowsPerCta * nq; i += kT) {
      const int r = i / nq, q = i - r * nq;
      stage_words16(tile + r * (TC / 4 + 4) + 4 * q, rowp[r], w0 + 16 * q,
                    w0 + nb);
    }
  }
  template <int TC>
  __device__ __forceinline__ static bool mma_load(const uint32_t* tile, int r,
                                                  int unit, int,
                                                  uint32_t (&w)[kMmaWords]) {
    w[0] = tile[r * (TC / 4 + 4) + unit];
    return w[0] != 0xFFFFFFFFu;
  }
  __device__ __forceinline__ static void mma_counts(
      const uint32_t (&w)[kMmaWords], int t, int j, int e, float& a1,
      float& a0) {
    const uint32_t code = (w[0] >> (16 * j + 4 * t + 2 * e)) & 3u;
    const bool missing = code == 3u;
    const float x = (float)code;
    a1 = missing ? 0.f : x;
    a0 = missing ? 0.f : 2.f - x;
  }
};

// Pre-decoded count planes a1, a0 (B, 4, W) bf16 (raw bits as uint16).
// Each staged word holds the pair (a1 bits, a0 bits), 0 where both counts
// are 0 (nothing to add). A unit is one column (4 planes). `stage` reads
// 8 columns of a plane at a time where the planes are 16-byte aligned.
// The counts are taken as they are (any bf16 value), never re-coded.
struct AcatLoader {
  static constexpr int kEntries = 4;
  static constexpr int kWords = 4;
  __host__ __device__ static constexpr int cols(int) { return 16; }
  __host__ __device__ static constexpr int words(int tc) {
    return kRowsPerCta * (4 * tc + 1);
  }
  const uint16_t* a1;
  const uint16_t* a0;

  // replicate z's planes, `off` elements on (Rep::rows)
  __device__ __forceinline__ AcatLoader shifted(long long off) const {
    return {a1 + off, a0 + off};
  }

  __device__ void prepare(const uint8_t**, int, int, int) const {}

  // The pairs of rows [b0, b0 + 64) x 4 planes x nb columns from w0 into
  // tile[r * kRow + s * kPlane + c] (zero past B and past nb), kT threads.
  template <int TC, int kT, int kRow, int kPlane>
  __device__ void stage_pairs(uint32_t* tile, int b0, int B, int W, int w0,
                              int nb) const {
    constexpr int kOct = TC / 8;
    for (int i = threadIdx.x; i < kRowsPerCta * 4 * kOct; i += kT) {
      const int r = i / (4 * kOct), s = (i / kOct) % 4, c = (i % kOct) * 8;
      if (c >= nb) continue;                             // never visited
      uint32_t* dst = tile + r * kRow + s * kPlane + c;
      const long long off = ((long long)(b0 + r) * 4 + s) * W + w0 + c;
      uint32_t v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (b0 + r < B) {
        if (c + 8 <= nb &&
            ((reinterpret_cast<uintptr_t>(a1 + off) |
              reinterpret_cast<uintptr_t>(a0 + off)) & 15) == 0) {
          const uint4 x = __ldg(reinterpret_cast<const uint4*>(a1 + off));
          const uint4 y = __ldg(reinterpret_cast<const uint4*>(a0 + off));
          const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
          const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[2 * j] = (xs[j] & 0xFFFFu) | (ys[j] << 16);
            v[2 * j + 1] = (xs[j] >> 16) | (ys[j] & 0xFFFF0000u);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (c + j < nb)
              v[j] = (uint32_t)a1[off + j] | ((uint32_t)a0[off + j] << 16);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j] = v[j];
    }
  }

  // A lane per row: row stride 4 TC + 1 (odd), planes TC apart.
  template <int TC>
  __device__ void stage(uint32_t* tile, const uint8_t* const*, int b0, int B,
                        int W, int w0, int nb) const {
    stage_pairs<TC, kThreads, 4 * TC + 1, TC>(tile, b0, B, W, w0, nb);
  }

  __device__ static int units(int nb) { return nb; }

  template <int TC>
  __device__ __forceinline__ static bool load(const uint32_t* tile, int r,
                                              int unit,
                                              uint32_t (&w)[kWords]) {
#pragma unroll
    for (int s = 0; s < 4; ++s) w[s] = tile[r * (4 * TC + 1) + s * TC + unit];
    return (w[0] | w[1] | w[2] | w[3]) != 0u;
  }

  template <int TC>
  __device__ __forceinline__ static void entry(const uint32_t (&w)[kWords],
                                               int unit, int e, int& urow,
                                               float& a1, float& a0) {
    urow = e * TC + unit;
    a1 = __uint_as_float(w[e] << 16);
    a0 = __uint_as_float(w[e] & 0xFFFF0000u);
  }

  // The tensor-core pass (psd_mma.cuh, K8 at bf16): a step is 4 columns x
  // 4 planes (16 individuals in natural order, 4c + s), and lane (g, t)
  // needs the pairs of its row for individuals 8j + 2t + e: column 2j +
  // t / 2, plane 2 (t % 2) + e. Planes TC + 1 words apart and rows 4 (TC +
  // 1), so that a warp's 32 reads of one (j, e) hit 32 banks. Tiles of 32
  // columns where D and S are one or two k-tiles (K <= 16), else 16, so
  // that the tile and the staged u fit the 48 KB of static shared memory
  // (NVIDIA H100 80GB HBM3, 700 W, B = 4096, 4 x 2,048 individuals, K =
  // 10: 0.140 ms with 32 columns, 0.172 with 16; the f32 body 0.265).
  // One stage: the pairs are built in registers (no cp.async), and a
  // second tile would not fit the static shared memory. Staging the two
  // planes as they are by 8-byte cp.async, two tiles of 16 columns in
  // flight, was tried and was slower at K = 10.
  __host__ __device__ static constexpr int mma_cols(int kn) {
    return kn <= 2 ? 32 : 16;
  }
  __host__ __device__ static constexpr int mma_words(int tc) {
    return kRowsPerCta * 4 * (tc + 1);
  }
  static constexpr int kMmaWords = 4;
  static constexpr int kMmaStages = 1;
  template <int TC, int kT>
  __device__ void stage_mma(uint32_t* tile, const uint8_t* const*, int b0,
                            int B, int W, int w0, int nb) const {
    stage_pairs<TC, kT, 4 * (TC + 1), TC + 1>(tile, b0, B, W, w0, nb);
  }
  template <int TC>
  __device__ __forceinline__ static bool mma_load(const uint32_t* tile, int r,
                                                  int unit, int t,
                                                  uint32_t (&w)[kMmaWords]) {
    const uint32_t* p = tile + r * 4 * (TC + 1) + 2 * (t & 1) * (TC + 1) +
                        4 * unit + (t >> 1);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) w[2 * j + e] = p[e * (TC + 1) + 2 * j];
    return (w[0] | w[1] | w[2] | w[3]) != 0u;
  }
  __device__ __forceinline__ static void mma_counts(
      const uint32_t (&w)[kMmaWords], int, int j, int e, float& a1,
      float& a0) {
    a1 = __uint_as_float(w[2 * j + e] << 16);
    a0 = __uint_as_float(w[2 * j + e] & 0xFFFF0000u);
  }
};

// One raw lambda pass. grid (ceil(B/kRowsPerCta), nsplit, R), block
// kThreads. t1[b*ts + k*tk], t0 likewise; part (nsplit, B, K, 2): [...,0]
// = S1 (the lambda0 statistic), [...,1] = S0. `active` (may be null): skip
// the pass when active[z] == 0. kDiv: how `ratio` divides. Replicate z =
// blockIdx.z reads and writes at the strides of `rep`. (At bf16 the pass
// for K <= 64 is lambda_pass_mma_kernel, psd_mma.cuh, for both loaders.)
template <int KM, class Loader, int kDiv>
__global__ void __launch_bounds__(kThreads)
lambda_pass_kernel(Loader ld, const float* __restrict__ up,
                   const float* __restrict__ t1g,
                   const float* __restrict__ t0g, int ts, int tk,
                   float* __restrict__ part, int B, int W, int K, int wchunk,
                   const int* __restrict__ active, Rep rep) {
  const long long z = blockIdx.z;
  if (active != nullptr && active[z] == 0) return;
  ld = ld.shifted(z * rep.rows);
  up += z * rep.u;
  t1g += z * rep.t;
  t0g += z * rep.t;
  part += z * rep.part;
  constexpr int TC = Loader::cols(KM);
  // entries a lane works on at once: their u rows sit in registers
  constexpr int G = KM <= 8 ? 4 : KM <= 16 ? 2 : 1;
  __shared__ uint32_t tile[Loader::words(TC)];
  __shared__ __align__(16) float us[4 * TC * KM];  // u rows, padded to KM
  __shared__ const uint8_t* rowp[kRowsPerCta];     // PackedLoader's row table

  const int r = threadIdx.x;                       // the lane's row in the CTA
  const int b0 = blockIdx.x * kRowsPerCta;
  const int b = b0 + r;
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

  for (int w0 = wbeg; w0 < wend; w0 += TC) {
    const int nb = min(TC, wend - w0);
    __syncthreads();  // the previous tile is consumed
    ld.template stage<TC>(tile, rowp, b0, B, W, w0, nb);
    // u rows of the tile's columns, zero beyond K and beyond nb (a packed
    // word reaches up to 3 columns past nb; they read as MISSING)
    const int nc = min(TC, (nb + 3) & ~3);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float* ug = up + ((long long)s * W + w0) * K;
      for (int i = threadIdx.x; i < nc * KM; i += kThreads) {
        const int c = i / KM, k = i % KM;
        us[(s * TC + c) * KM + k] =
            c < nb && k < K ? __ldg(ug + c * K + k) : 0.f;
      }
    }
    __syncthreads();
    const int nunits = Loader::units(nb);
    for (int unit = 0; unit < nunits; ++unit) {
      uint32_t w[Loader::kWords];
      if (!Loader::template load<TC>(tile, r, unit, w)) continue;
#pragma unroll
      for (int e0 = 0; e0 < Loader::kEntries; e0 += G) {
        float a1[G], a0[G], d1[G], d0[G], uk[G][KM];
#pragma unroll
        for (int i = 0; i < G; ++i) {
          int urow;
          Loader::template entry<TC>(w, unit, e0 + i, urow, a1[i], a0[i]);
          const float4* q = reinterpret_cast<const float4*>(us + urow * KM);
#pragma unroll
          for (int k4 = 0; k4 < KM / 4; ++k4) {
            const float4 v = q[k4];
            uk[i][4 * k4] = v.x;
            uk[i][4 * k4 + 1] = v.y;
            uk[i][4 * k4 + 2] = v.z;
            uk[i][4 * k4 + 3] = v.w;
          }
          d1[i] = 0.f;
          d0[i] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < KM; ++k) {
#pragma unroll
          for (int i = 0; i < G; ++i) {
            d1[i] = fmaf(t1[k], uk[i][k], d1[i]);
            d0[i] = fmaf(t0[k], uk[i][k], d0[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const float r1 = ratio<kDiv>(a1[i], d1[i]);
          const float r0 = ratio<kDiv>(a0[i], d0[i]);
#pragma unroll
          for (int k = 0; k < KM; ++k) {
            s1[k] = fmaf(r1, uk[i][k], s1[k]);
            s0[k] = fmaf(r0, uk[i][k], s0[k]);
          }
        }
      }
    }
  }

  if (!row_ok) return;
  float2* out = reinterpret_cast<float2*>(
      part + ((long long)blockIdx.y * B + b) * K * 2);
#pragma unroll
  for (int k = 0; k < KM; ++k)
    if (k < K) out[k] = make_float2(s1[k], s0[k]);
}

// The gamma side of the entry step, shared by the gamma pass (K1, K2, K5)
// and K7's phase 1 (stats_fused.cuh). A thread holds one individual's u
// (KM floats, zero beyond K) and its K sums g in registers and walks `nr`
// rows staged in shared memory:
//   D1 = sum_k t1[b,k] u[k], D0 likewise (k ascending, one FMA chain each)
//   r1 = a1 / (D1 + eps), r0 = a0 / (D0 + eps)          (`ratio<kDiv>`)
//   g[k] += r1 t1[b,k], then g[k] += r0 t0[b,k]           (rows in order)
// and, where kStoreR, writes r1, r0 to rs1[r * rstride], rs0 likewise.
//   tr    the rows' t as KM/2 float4 a row, (t1[k], t0[k], t1[k+1],
//         t0[k+1]): read as broadcasts into registers that serve D and g
//   code  the thread's packed byte of row r at code[r * cstride]; its
//         2-bit code at `shift`. MISSING counts 0 for both alleles, so its
//         R is 0 x a finite reciprocal = 0 and it adds exactly 0: no branch
// RB rows at a time, so their D chains and divides overlap; nr is a
// multiple of RB (the callers stage MISSING rows with t = 0 up to it,
// which add exactly 0). Zero columns of K (k >= K) add exactly 0 to D, so
// a wider KM gives the same bits.
template <int KM, int RB, int kDiv, bool kStoreR>
__device__ __forceinline__ void gamma_rows(
    const float (&uk)[KM], float (&g)[KM], const float4* __restrict__ tr,
    const uint8_t* __restrict__ code, int cstride, int shift, int nr,
    float* __restrict__ rs1, float* __restrict__ rs0, int rstride) {
  static_assert(KM % 4 == 0, "t rows are read as float4");
  for (int rb = 0; rb < nr; rb += RB) {
    float a1[RB], a0[RB], d1[RB], d0[RB], t[RB][2 * KM];
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const uint32_t c = (code[(rb + i) * cstride] >> shift) & 3u;
      const bool missing = c == 3u;
      a1[i] = missing ? 0.f : (float)c;
      a0[i] = missing ? 0.f : 2.f - (float)c;
      const float4* q = tr + (rb + i) * (KM / 2);
#pragma unroll
      for (int k2 = 0; k2 < KM / 2; ++k2) {
        const float4 v = q[k2];
        t[i][4 * k2] = v.x;
        t[i][4 * k2 + 1] = v.y;
        t[i][4 * k2 + 2] = v.z;
        t[i][4 * k2 + 3] = v.w;
      }
      d1[i] = 0.f;
      d0[i] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < KM; ++k) {
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        d1[i] = fmaf(t[i][2 * k], uk[k], d1[i]);
        d0[i] = fmaf(t[i][2 * k + 1], uk[k], d0[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const float x1 = ratio<kDiv>(a1[i], d1[i]);
      const float x0 = ratio<kDiv>(a0[i], d0[i]);
      if (kStoreR) {
        rs1[(rb + i) * rstride] = x1;
        rs0[(rb + i) * rstride] = x0;
      }
#pragma unroll
      for (int k = 0; k < KM; ++k) {
        g[k] = fmaf(x1, t[i][2 * k], g[k]);
        g[k] = fmaf(x0, t[i][2 * k + 1], g[k]);
      }
    }
  }
}

constexpr int kGThreads = 128;  // individuals of a gamma CTA ...
constexpr int kGCols = 32;      // ... 32 byte columns x 4 planes
constexpr int kGRows = 64;      // rows staged in shared memory at once

// Partial planar gamma statistic over rows [y*bchunk, (y+1)*bchunk):
// gpart[y, i, k] = sum_b r1[b,i] t1[b,k] + r0[b,i] t0[b,k] for the planar
// individual i = s*W + w, t1[b*ts + k*tk] and t0 likewise (exact divide).
// grid (ceil(W/32), nsplit). A CTA takes byte columns [32x, 32x + 32), a
// warp one plane s of them, a lane one column: u[i,:] and the K sums stay
// in registers. Per block of 64 rows the CTA stages the rows' t and their
// 32 packed bytes (word-wide loads; rows located by `Rows`, a null row
// reads as MISSING) in shared memory, then each thread runs `gamma_rows`
// over them. A slice's rows are added in order, so its bits do not
// depend on the CTA's layout. Replicate z = blockIdx.z at the strides of
// `rep`. (At bf16 the pass for K <= 64 is gamma_pass_mma_kernel,
// psd_mma.cuh.)
template <int KM, class Rows>
__global__ void __launch_bounds__(kGThreads)
gamma_pass_kernel(Rows src, const float* __restrict__ up,
                  const float* __restrict__ t1g,
                  const float* __restrict__ t0g, int ts, int tk,
                  float* __restrict__ gpart, int B, int W, int K, int bchunk,
                  Rep rep) {
  constexpr int RB = KM <= 16 ? 2 : 1;
  const long long z = blockIdx.z;
  src = src.shifted(z * rep.rows);
  up += z * rep.u;
  t1g += z * rep.t;
  t0g += z * rep.t;
  gpart += z * rep.part;
  __shared__ float4 tsm[kGRows * KM / 2];
  __shared__ uint32_t bsm[kGRows * kGCols / 4];
  const int s = threadIdx.x >> 5;
  const int w0 = blockIdx.x * kGCols;
  const int w = w0 + (threadIdx.x & 31);
  const bool ok = w < W;
  const long long i = (long long)s * W + w;
  float uk[KM], g[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    uk[k] = ok && k < K ? up[i * K + k] : 0.f;
    g[k] = 0.f;
  }
  const int bbeg = blockIdx.y * bchunk;
  const int bend = min(B, bbeg + bchunk);
  float* tf = reinterpret_cast<float*>(tsm);
  for (int c0 = bbeg; c0 < bend; c0 += kGRows) {
    const int nr = min(kGRows, bend - c0);
    const int nrp = (nr + RB - 1) / RB * RB;
    __syncthreads();  // the previous block is consumed
    for (int j = threadIdx.x; j < nrp * KM * 2; j += kGThreads) {
      const int r = j / (KM * 2), rem = j % (KM * 2);
      const int k = rem / 2;
      const float* tg = rem % 2 ? t0g : t1g;
      tf[j] = r < nr && k < K ? tg[(long long)(c0 + r) * ts + k * tk] : 0.f;
    }
    for (int j = threadIdx.x; j < nrp * (kGCols / 4); j += kGThreads) {
      const int r = j / (kGCols / 4), c = 4 * (j % (kGCols / 4));
      const uint8_t* p = r < nr ? src.row(c0 + r, W) : nullptr;
      uint32_t v = 0xFFFFFFFFu;  // outside the matrix: MISSING
      if (p != nullptr) {
        const uint8_t* q = p + w0 + c;
        if (w0 + c + 4 <= W && (reinterpret_cast<uintptr_t>(q) & 3) == 0) {
          v = __ldg(reinterpret_cast<const uint32_t*>(q));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (w0 + c + e < W) {
              v &= ~(0xFFu << (8 * e));
              v |= (uint32_t)__ldg(q + e) << (8 * e);
            }
          }
        }
      }
      bsm[j] = v;
    }
    __syncthreads();
    gamma_rows<KM, RB, kDivExact, false>(
        uk, g, tsm, reinterpret_cast<const uint8_t*>(bsm) + (threadIdx.x & 31),
        kGCols, 2 * s, nrp, nullptr, nullptr, 0);
  }
  if (!ok) return;
  float* out = gpart + ((long long)blockIdx.y * 4 * W + i) * K;
#pragma unroll
  for (int k = 0; k < KM; ++k)
    if (k < K) out[k] = g[k];
}

}  // namespace tt

#include "psd_mma.cuh"

namespace tt {

namespace {  // one copy per translation unit (no template to share)

// g[j] = sum_y gpart[y, j], y in order; replicate blockIdx.z at strides
// ps (gpart) and os (g).
__global__ void gamma_reduce_kernel(const float* __restrict__ gpart,
                                    int nsplit, long long n,
                                    float* __restrict__ g, long long ps,
                                    long long os) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  gpart += blockIdx.z * ps;
  g += blockIdx.z * os;
  float a = 0.f;
  for (int y = 0; y < nsplit; ++y) a += gpart[(long long)y * n + j];
  g[j] = a;
}

// l0[i] = sum_s part[s, i, 0], l1[i] = sum_s part[s, i, 1], s in order;
// replicate blockIdx.z at strides ps (part) and os (l0, l1).
__global__ void split_reduce_kernel(const float* __restrict__ part,
                                    int nsplit, int bk, float* __restrict__ l0,
                                    float* __restrict__ l1, long long ps,
                                    long long os) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bk) return;
  part += blockIdx.z * ps;
  l0 += blockIdx.z * os;
  l1 += blockIdx.z * os;
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
// gpart (nsplit, 4W, K) scratch, g (4, W, K). kBf16: the tensor-core body
// (psd_mma.cuh) with ceil(KM / 8) n8 tiles of K, on the same grid
// (`gamma_grid` chooses nsplit by dtype), reading the rounded t `tb`
// (R, 2, B, mma_kp(K)) bf16 instead of t1g, t0g. R replicates in the
// grid's z at the strides of `rep` (gpart: rep.part, g: rep.out).
template <int KM, class Rows, bool kBf16>
int gamma_stats(Rows src, const float* up, const float* t1g,
                const float* t0g, int ts, int tk, const __nv_bfloat16* tb,
                float* gpart, float* g, int B, int W, int K, int nsplit,
                cudaStream_t stream, int R, Rep rep) {
  const int bchunk = (B + nsplit - 1) / nsplit;
  const dim3 grid((W + kGCols - 1) / kGCols, nsplit, R);
  if constexpr (kBf16)
    gamma_pass_mma_kernel<(KM + 7) / 8, Rows><<<grid, kMmaThreads, 0, stream>>>(
        src, up, tb, gpart, B, W, K, bchunk, rep);
  else
    gamma_pass_kernel<KM, Rows><<<grid, kGThreads, 0, stream>>>(
        src, up, t1g, t0g, ts, tk, gpart, B, W, K, bchunk, rep);
  TT_CHECK_LAUNCH();
  const long long ng = 4LL * W * K;
  gamma_reduce_kernel<<<dim3((unsigned)((ng + 255) / 256), 1, R), 256, 0,
                        stream>>>(gpart, nsplit, ng, g, rep.part, rep.out);
  TT_CHECK_LAUNCH();
  return 0;
}

// Byte columns per split so that `nsplit` CTAs cover W (multiple of 16).
inline int split_chunk(int W, int nsplit) {
  const int c = (W + nsplit - 1) / nsplit;
  return (c + 15) / 16 * 16;
}

// The K-width a pass runs at: the smallest instantiated KM holding K,
// kWide for K > 64 (lambda_wide.cuh, gamma_wide.cuh), -1 for K < 1. The
// gamma pass and K7
// also instantiate KM = 12 (`km12`), so that K = 9..12 (K = 10 in the
// big-N configs) runs 12 wide instead of 16; the lambda pass keeps
// {4, 8, 16, 32, 64}.
constexpr int kWide = 0;
inline int pick_km(int K, bool km12 = false) {
  static const int kms[] = {4, 8, 16, 32, 64};
  if (K < 1) return -1;
  if (km12 && K > 8 && K <= 12) return 12;
  for (int km : kms)
    if (K <= km) return km;
  return kWide;
}

}  // namespace tt

#include "lambda_wide.cuh"
#include "gamma_wide.cuh"

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

// The same with KM = 12 (the gamma pass and K7: pick_km(K, true)).
#define TT_DISPATCH_KM12(km, F)      \
  switch (km) {                      \
    case 4: F(4); break;             \
    case 8: F(8); break;             \
    case 12: F(12); break;           \
    case 16: F(16); break;           \
    case 32: F(32); break;           \
    case 64: F(64); break;           \
    default: return (int)cudaErrorInvalidValue; \
  }

namespace tt {

// Launch one lambda pass over `nsplit` column splits; part (nsplit, B, K,
// 2) takes the partial sums. `div` is a `Div` (kDivNewton only where
// kNewton is set: only the fused solve builds it); `active` as in
// `lambda_pass_kernel`; kBf16 picks the bf16 bodies: at K <= 64 the
// tensor-core body (psd_mma.cuh) for either loader, packed rows (K1, K2,
// K4) or count planes (K8), which stages the rounded u `ub` (`round_u`:
// R x (4W, mma_kp(K)) bf16) instead of reading up. K > 64 runs
// `lambda_pass_wide_kernel` (lambda_wide.cuh) at either dtype. R
// replicates in the grid's z at the strides of `rep`.
template <class Loader, bool kNewton = false, bool kBf16 = false>
int launch_lambda_pass(Loader ld, const float* up, const __nv_bfloat16* ub,
                       const float* t1, const float* t0, int ts, int tk,
                       float* part, int B, int W, int K, int nsplit, int div,
                       const int* active, cudaStream_t stream, int R = 1,
                       Rep rep = {}) {
  const int km = pick_km(K);
  if (B <= 0 || W <= 0 || nsplit <= 0 || km < 0 || R < 1 ||
      (div == kDivNewton && !kNewton) ||
      (kBf16 && km != kWide && ub == nullptr))
    return (int)cudaErrorInvalidValue;
  if (km == kWide)
    return launch_lambda_pass_wide<Loader, kNewton, kBf16>(
        ld, up, t1, t0, ts, tk, part, B, W, K, nsplit, div, active, stream,
        R, rep);
  const dim3 grid((B + kRowsPerCta - 1) / kRowsPerCta, nsplit, R);
  const int wchunk = split_chunk(W, nsplit);
#define TT_PASS(KM, DIV)                                                  \
  if constexpr (kBf16) /* the tensor-core body: ceil(KM / 8) n8 tiles */  \
    lambda_pass_mma_kernel<(KM + 7) / 8, Loader, DIV>                     \
        <<<grid, kMmaThreads, 0, stream>>>(ld, ub, t1, t0, ts, tk, part,  \
                                           B, W, K, wchunk, active, rep); \
  else                                                                    \
    lambda_pass_kernel<KM, Loader, DIV>                                   \
        <<<grid, kThreads, 0, stream>>>(ld, up, t1, t0, ts, tk, part, B,  \
                                        W, K, wchunk, active, rep)
#define TT_LAUNCH(KM)                                 \
  if (div == kDivFast) {                              \
    TT_PASS(KM, kDivFast);                            \
  } else if (div == kDivExact) {                      \
    TT_PASS(KM, kDivExact);                           \
  } else if constexpr (kNewton) {                     \
    TT_PASS(KM, kDivNewton);                          \
  }
  TT_DISPATCH_KM(km, TT_LAUNCH)
#undef TT_LAUNCH
#undef TT_PASS
  TT_CHECK_LAUNCH();
  return 0;
}

// Launch the gamma pass (gamma_stats, or gamma_stats_wide for K > 64);
// kBf16 picks the bf16 bodies, at K <= 64 on the rounded t `tb`
// (`round_t`, or the fused solve's final update). R replicates as in
// launch_lambda_pass.
template <class Rows, bool kBf16 = false>
int launch_gamma_stats(Rows src, const float* up, const float* t1g,
                       const float* t0g, int ts, int tk,
                       const __nv_bfloat16* tb, float* gpart, float* g, int B,
                       int W, int K, int nsplit, cudaStream_t stream,
                       int R = 1, Rep rep = {}) {
  const int km = pick_km(K, true);
  if (B <= 0 || W <= 0 || nsplit <= 0 || km < 0 || R < 1 ||
      (kBf16 && km != kWide && tb == nullptr))
    return (int)cudaErrorInvalidValue;
  if (km == kWide)
    return gamma_stats_wide<Rows, kBf16>(src, up, t1g, t0g, ts, tk, gpart, g,
                                         B, W, K, nsplit, stream, R, rep);
  int err = 0;
#define TT_LAUNCH(KM)                                                    \
  err = gamma_stats<KM, Rows, kBf16>(src, up, t1g, t0g, ts, tk, tb, gpart, \
                                     g, B, W, K, nsplit, stream, R, rep)
  TT_DISPATCH_KM12(km, TT_LAUNCH)
#undef TT_LAUNCH
  return err;
}

}  // namespace tt
