// The K-chunked ("wide") body of the gamma pass, for K > 64: K1's and
// K2's last pass and K5 (`gamma_stats_wide`, which `launch_gamma_stats` in
// psd_common.cuh picks by K). Included by psd_common.cuh after the K <= 64
// bodies, whose row sources and divides it reuses. The K-chunking helpers
// here (`kKC`, `wide_z`, `wide_grid_z`) also serve K6's K > 64 body in
// stats_fused.cuh. The λ pass at K > 64 is no longer K-chunked: it is
// lambda_wide.cuh's `lambda_pass_wide_kernel`, on the tile that K7's K > 64
// body walks too (wide_tile.cuh).
//
// It stands for the same TPU kernel as the K <= 64 gamma bodies: K1's last
// pass (terastructure_tpu/ops/fused_step.py `_make_kernel.one_pass`,
// :252-308) and ops/stats_pallas.py `_gamma_kernel` (K5). On the TPU K is
// padded to 128 lanes (fused_step.py:141), so K = 65..128 costs the
// reference nothing more than K = 8 does.
//
// Why K-chunked: the K <= 64 bodies keep KM floats per K-vector in
// registers (u and g). KM = 64 already spills, and KM = 128 would not fit
// the 48 KB of static shared memory either. So a wide CTA splits the K
// output columns into chunks of kKC = 32 (blockIdx.z), which hold in
// registers what KM = 32 holds. Each CTA computes the whole D1 = sum_k
// t1[b,k] u[n,k] (and D0) over all K, then adds only its chunk's sums.
//
// Any K: D's operands are staged a piece at a time, piece p being the
// columns [32p, 32p + 32) of K (the chunks' own split), and D is summed
// over the pieces, so a CTA's shared memory (25 KB, static) does not grow
// with K. A CTA takes its own chunk's piece last, so that the staged piece
// serves the chunk's sums too; D's sum thus starts at a different piece in
// each chunk (the chunks' R of one entry differ in rounding only). Per
// block of kWideGRows = 32 rows, a piece's u of the CTA's 128 individuals
// (k-major, stride 129: a thread, one individual, reads its own column;
// the staging writes hit 32 banks) and t of the rows (float2 rows, read as
// float4 broadcasts); a thread keeps D of its individual and the 32 rows
// in registers.
//
// What bounds it at K > 64: the shared-memory load rate and the
// recompute. D is computed ceil(K / 32) times: at K = 72, 3 x 2K + 2K =
// 8K FMAs an entry against the 4K an unchunked pass would do, and at
// K = 256 8 x 2K + 2K = 18K against 4K. This body is a repair, not a
// redesign; K7's and the λ pass's K-chunked bodies have been redesigned
// (stats_fused.cuh `stats_v2_wide_kernel`, lambda_wide.cuh; their notes
// and PERF.md give their times), and this one is next.
//
// No atomics: each chunk writes its own k columns of the same partial-sum
// buffer as the K <= 64 body (gpart (nsplit, 4W, K)), and the split
// reduction adds them in split order, so a re-run is bitwise equal.
//
// The replicate axis (batched replicates, the reference's kernels under
// jax.vmap): R problems share the grid's z with the chunks, z = r x
// chunks + c (`wide_z`), so gridDim.z is R x ceil(K / 32) (the launcher
// keeps it within 65,535). CTA (x, y, z) offsets its pointers by
// replicate r's `Rep` strides in its prologue, before any staging, and
// then runs chunk c exactly as the single call's CTA (x, y, c) does: a
// replicate's result is bitwise its single call's. R = 1 is that call.
#pragma once

namespace tt {

constexpr int kKC = 32;          // columns of K in a chunk and in a piece
constexpr int kWideGRows = 32;   // rows of a wide gamma CTA's block
constexpr int kUStride = kGThreads + 1;  // wide gamma pass: u's k stride

__host__ __device__ constexpr int round4(int K) { return (K + 3) & ~3; }
__host__ __device__ constexpr int wide_chunks(int K) {
  return (K + kKC - 1) / kKC;
}

// A wide CTA's replicate and chunk: z = r x wide_chunks(K) + c.
struct WideZ {
  long long r;  // the replicate
  int c;        // the chunk of K: columns [32 c, 32 c + 32)
  int np;       // chunks (= pieces) of K
};
__device__ __forceinline__ WideZ wide_z(int K) {
  const int np = wide_chunks(K);
  return {(long long)(blockIdx.z / np), (int)(blockIdx.z % np), np};
}

// The grid's z of a wide launch of R replicates; 0 where it would pass
// the hardware's 65,535 (the launchers then refuse the call).
inline unsigned wide_grid_z(int K, int R) {
  const long long z = (long long)wide_chunks(K) * R;
  return z <= 65535 ? (unsigned)z : 0u;
}

// Columns of piece p: 32, or what is left of K rounded up to 4.
__device__ __forceinline__ int piece_width(int K, int p) {
  return min(kKC, round4(K) - p * kKC);
}

// The wide gamma pass. grid (ceil(4W/kGThreads), nsplit, R x
// wide_chunks(K)), block kGThreads. Arguments as gamma_pass_kernel's; the
// CTA of chunk c writes gpart[..., k] for k in [32 c, 32 c + 32) of its
// replicate (`wide_z`). kBf16: the bf16 body.
template <class Rows, bool kBf16 = false>
__global__ void __launch_bounds__(kGThreads)
gamma_pass_wide_kernel(Rows src, const float* __restrict__ up,
                       const float* __restrict__ t1g,
                       const float* __restrict__ t0g, int ts, int tk,
                       float* __restrict__ gpart, int B, int W, int K,
                       int bchunk, Rep rep) {
  const WideZ z = wide_z(K);
  src = src.shifted(z.r * rep.rows);
  up += z.r * rep.u;
  t1g += z.r * rep.t;
  t0g += z.r * rep.t;
  gpart += z.r * rep.part;
  constexpr int R = kWideGRows;
  __shared__ float usm[kKC * kUStride];                // (k, individual)
  __shared__ __align__(16) float2 tsm[R * kKC];        // (row, k)
  __shared__ const uint8_t* rowp[R];
  const int i0 = blockIdx.x * kGThreads;
  const int i = i0 + threadIdx.x;
  const bool ok = i < 4 * W;
  const int s = ok ? i / W : 0;
  const int w = ok ? i % W : 0;
  const int np = z.np;                                 // pieces = chunks
  const int kc0 = z.c * kKC;
  const int kwc = piece_width(K, z.c);                 // the chunk's columns
  float g[kKC];
#pragma unroll
  for (int j = 0; j < kKC; ++j) g[j] = 0.f;
  const int bbeg = blockIdx.y * bchunk;
  const int bend = min(B, bbeg + bchunk);
  for (int c0 = bbeg; c0 < bend; c0 += R) {
    const int nr = min(R, bend - c0);
    float d1[R], d0[R];
#pragma unroll
    for (int r = 0; r < R; ++r) d1[r] = d0[r] = 0.f;
    for (int q = 1; q <= np; ++q) {
      const int p = (z.c + q) % np;                    // the chunk's own last
      const int k0 = p * kKC, kw = piece_width(K, p);
      __syncthreads();                     // the last piece or block is read
      for (int j = threadIdx.x; j < kGThreads * kw; j += kGThreads) {
        const int n = j / kw, k = j % kw;
        usm[k * kUStride + n] =
            i0 + n < 4 * W && k0 + k < K
                ? operand<kBf16>(up[(long long)(i0 + n) * K + k0 + k])
                : 0.f;
      }
      for (int j = threadIdx.x; j < R * kw; j += kGThreads) {
        const int r = j / kw, k = j % kw;
        const long long o =
            (long long)(c0 + r) * ts + (long long)(k0 + k) * tk;
        tsm[r * kKC + k] = r < nr && k0 + k < K
                               ? make_float2(operand<kBf16>(t1g[o]),
                                             operand<kBf16>(t0g[o]))
                               : make_float2(0.f, 0.f);
      }
      if (q == 1)
        for (int r = threadIdx.x; r < nr; r += kGThreads)
          rowp[r] = src.row(c0 + r, W);
      __syncthreads();
      for (int k = 0; k < kw; k += 2) {
        const float ua = usm[k * kUStride + threadIdx.x];
        const float ub = usm[(k + 1) * kUStride + threadIdx.x];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          // (t1, t0) of columns k and k + 1
          const float4 t = *reinterpret_cast<const float4*>(tsm + r * kKC + k);
          d1[r] = fmaf(t.x, ua, d1[r]);
          d0[r] = fmaf(t.y, ua, d0[r]);
          d1[r] = fmaf(t.z, ub, d1[r]);
          d0[r] = fmaf(t.w, ub, d0[r]);
        }
      }
    }
    // the chunk's sums (tsm holds the chunk's own piece), four rows a step:
    // d moves down four rows after each, so that it stays in registers with
    // a body of four rows (unrolled over all R rows, nvcc takes ~13 s more
    // a source)
    for (int rb = 0; rb < nr; rb += 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rb + i;
        const uint8_t* p = r < nr ? rowp[r] : nullptr;
        const uint32_t code = ok && p != nullptr ? (p[w] >> (2 * s)) & 3u : 3u;
        if (code != 3u) {
          const float a1 = (float)code;
          const float a0 = 2.f - a1;
          const float r1 = operand<kBf16>(ratio<kDivExact>(a1, d1[i]));
          const float r0 = operand<kBf16>(ratio<kDivExact>(a0, d0[i]));
          const float2* tr = tsm + r * kKC;
#pragma unroll
          for (int j = 0; j < kKC; ++j) {
            if (j < kwc) {                       // the same for all threads
              const float2 t = tr[j];
              g[j] = fmaf(r1, t.x, g[j]);
              g[j] = fmaf(r0, t.y, g[j]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < R - 4; ++i) {
        d1[i] = d1[i + 4];
        d0[i] = d0[i + 4];
      }
    }
  }
  if (!ok) return;
  float* out = gpart + ((long long)blockIdx.y * 4 * W + i) * K;
#pragma unroll
  for (int j = 0; j < kKC; ++j)
    if (kc0 + j < K) out[kc0 + j] = g[j];
}

// Launch the wide gamma pass over `nsplit` row slices and their reduction
// (as gamma_stats, R replicates at the strides of `rep`).
template <class Rows, bool kBf16 = false>
int gamma_stats_wide(Rows src, const float* up, const float* t1g,
                     const float* t0g, int ts, int tk, float* gpart, float* g,
                     int B, int W, int K, int nsplit, cudaStream_t stream,
                     int R, Rep rep) {
  const unsigned gz = wide_grid_z(K, R);
  if (gz == 0) return (int)cudaErrorInvalidValue;
  const int bchunk = (B + nsplit - 1) / nsplit;
  const dim3 grid((4 * W + kGThreads - 1) / kGThreads, nsplit, gz);
  gamma_pass_wide_kernel<Rows, kBf16><<<grid, kGThreads, 0, stream>>>(
      src, up, t1g, t0g, ts, tk, gpart, B, W, K, bchunk, rep);
  TT_CHECK_LAUNCH();
  const long long ng = 4LL * W * K;
  gamma_reduce_kernel<<<dim3((unsigned)((ng + 255) / 256), 1, R), 256, 0,
                        stream>>>(gpart, nsplit, ng, g, rep.part, rep.out);
  TT_CHECK_LAUNCH();
  return 0;
}

}  // namespace tt
