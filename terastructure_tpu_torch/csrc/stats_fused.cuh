// K7: batch_stats_fused_v2_packed and K6: batch_stats_fused_packed — the
// exact full-N statistics pass of the big-N step: the lambda statistics
// (l0, l1) (B, K) and the planar gamma statistic g (4, W, K) from one
// D = T U^T per (row, individual). The bodies and their launchers, for
// both compute dtypes; stats_fused.cu holds the f32 entries and
// stats_fused_bf16.cu the bf16 ones, so that nvcc builds the two in
// parallel.
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
// fixed order without float atomics (a seed reproduces gamma bitwise).
// K6 is K7's launch at the exact divide (the K6 note below).
//
// K7 (K <= 64), `stats_v2_kernel`: grid (W tiles of 256 byte columns, B
// tiles of 128 rows), CTAs of 4 warps. Warp q owns rows [32q, 32q + 32)
// of the tile for the whole W tile; the CTA walks it in sub-tiles of 8
// byte columns x 4 planes (32 individuals):
//   phase 1, lane = individual (u[n,:] in registers): `tt::gamma_rows`
//     (psd_common.cuh, the gamma pass's own step) over the warp's 32 rows:
//     D1, D0, R = A / (D + 1e-30) into the warp's slice of shared memory,
//     g[n,:] += R^T T in registers;
//   phase 2, lane = row: S[b,:] += R U over the 32 individuals, the sums
//     in registers across the whole W tile;
//   the four warps' g partials go through their R slices and are added in
//     warp order into the B tile's gamma partial.
// No warp reads another's R, so phase 2 follows phase 1 without a CTA
// barrier; a sub-tile costs two (its staged bytes and u, double-buffered
// and fetched into registers one sub-tile ahead; the g partials). The
// lambda sums leave once, as the W tile's partial. t of the CTA's 128
// rows is staged once, as (t1, t0) pairs read as float4 broadcasts; u
// rows are padded to KM and read as float4 broadcasts; entries are
// decoded without a branch (MISSING adds exactly 0); at KM <= 8 phase 1
// takes two rows at a time so that their D chains and divides overlap (at
// KM = 12 one: with two the body spilled at its 128 registers and took
// 2.49 ms, with one 2.36). KM = 12 is
// instantiated beside 4..64, so K = 9..12 runs 12 wide. Shared memory is
// 50 KB at KM = 12 (55 KB at 16) and registers are capped at 128, so an
// SM holds 4 CTAs, 16 warps. At B=4096, W=25,088, K=10: 98 x 32 CTAs,
// gamma partials 128 MB, lambda partials 32 MB; two reduce kernels add
// them in tile order.
//
// What the previous body lost (NVIDIA H100 80GB HBM3, 700 W; PERF.md):
// it took 5.49 ms at the big-N shape against a 0.561 ms bound. Its CTA
// held a 32-row chunk against 128 individuals and a 256-row lambda block,
// 65 KB at KM = 16, so 3 CTAs (12 warps) an SM; at K = 16 the block grew
// to 32 KB, 2 CTAs fitted, and the same FMAs took 9.47 ms: occupancy, not
// FMAs, set its time. Each row's byte came from global memory behind a
// branch, t was read as scalars, and a chunk cost 7 barriers (4 for the
// warps' ordered lambda add). The redesign takes 2.36 ms at K = 10 (1.92
// at K = 8, 3.49 at K = 16), 2.3x faster. K = 16 runs the KM = 16 body
// that K = 10 ran before; so KM = 12 saves about 1.1 ms of the 3.1 ms
// gained (an estimate: K = 10 at KM = 16 was not run).
//
// K6 (stats_kernel="fused") is K7's launch, `batch_stats_fused_v2`, at
// the exact divide: its g, l0 and l1 are K7's bit for bit, at every K,
// both dtypes and under the replicate axis. The reference's v1 differs
// from v2 only where it adds lambda, into a (B, K) block revisited over W
// tiles in W-tile order; K7's `split_reduce_kernel` adds the W tiles'
// partials in that order too. K6's first body, a CTA of 32 rows walking
// all of W, launched 128 CTAs at the big-N shape with K = 10 (K7: 98 x
// 32), kept 514 MB of gamma partials (K7: 128 MB), computed D three times
// an entry at K = 72 and ran bf16 on SIMT with rounded operands: 15.2 ms
// at K = 10 against K7's 2.36 (PERF.md). A lambda finished inside K7's
// bodies (the B tile's last CTA, found by an integer arrival count, adding
// the W tiles' partials in order) gave the same bits and was 3-7% slower
// than K7's two launches (PERF.md), so K6 has no body of its own.
//
// Bound on the H100: FP32 issue. Per row and individual, 6K FMAs and two
// divides (the pair, K4 + K5, does 8K and four); at the big-N shape that
// is ~25 G FMA against 103 MB of packed rows. K7 issues ~100 instructions
// an entry at KM = 12 (72 FMAs, 9 float4 and 5 scalar shared-memory
// accesses, the decode and two reciprocals): 25 SM cycles a warp's 32
// entries at full issue, against 43 measured. A lane taking two
// individuals (t read once for both: a third fewer broadcasts) was no
// faster at KM = 8 and spilled above it (PERF.md), so the rest is
// latency at 16 warps an SM, or issue.
//
// K > 64, K7: `stats_v2_wide_kernel<KP, kBf16>`, a body of its own, with
// no K chunks: the grid is (W tiles of 256 byte columns, B tiles,
// replicates). K is cut into pieces of at most 128 columns (KP = 80, 96,
// 112 or 128, `w7_piece_cols`): K = 65..128, which the reference's
// 128-lane padding runs at the cost of K = 8, is one piece. A CTA of 8
// warps takes its B tile a row tile of 64 rows at a time, held as 128
// M-rows (t1 and t0 of each row), and walks its W tile in sub-tiles of 16
// byte columns (64 individuals), three products a sub-tile over the
// whole tile:
//   D = t u^T (128 M-rows x 64 individuals, k = K): once an entry;
//   R = A / (D + eps), into a shared R tile;
//   S += R u (128 M-rows x K, k = the 64 individuals): in registers for
//     the W tile, leaving once as the row tile's lambda partial;
//   g = t^T R (K x 64 individuals, k = the 128 M-rows): added, row tile
//     after row tile, into the B tile's gamma partial.
// A B tile holds 4 row tiles (256 rows: 0.46 GB of gamma partials at the
// big-N shape with K = 72, 18.4 GB at N = 1M with R = 4), or 2 or 1
// where 4 would leave fewer than 256 CTAs a
// replicate (ops/stats_packed.py `v2_b_tile`); each partial is written
// and read back by one CTA, in row-tile order, so no atomics. t of a row
// tile is staged once; u and the packed bytes of the next sub-tile arrive
// by 16-byte cp.async in a second buffer while one runs. Above 128
// columns D is summed over the pieces first (each staged), then each
// piece is staged again for its S and g, S added into the row tile's rows
// of lpart: the operands are staged twice, D's FMAs
// done once. f32: SIMT, register-blocked as an SGEMM (a thread owns 8
// M-rows x 4 individuals of D, 8 M-rows x KP / 16 columns of S, 4
// individuals x KP / 16 columns of g; float4 operand reads), no TF32.
// bf16: the three products on mma.sync m16n8k16, R rounded once and read
// by ldmatrix as S's A operand and, transposed, as g's B operand. The
// staging, the shared-memory layout and the D, S and g products are
// wide_tile.cuh's (the K > 64 λ and γ passes, lambda_wide.cuh and
// gamma_wide.cuh, walk the same tile); K7's decode and divide are below
// (`w7_ratios`).
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W; PERF.md): at f32 the FP32
// issue of its FMAs (6 KP an entry, K padded to the piece) and the exact
// divides; at bf16 not the products but what runs between the barriers
// of 8-warp CTAs (the decode, the divides, the staging) and the gamma
// partials, written and added again. Builds that left out one product,
// or the divide, at a time (trial builds, not kept) showed the f32
// time spread over the three products, g's the largest, with the divides
// a smaller share; at bf16 the products a small share, the divides a
// larger one and the rest between the barriers. A call
// (`chip_smoke.py --digest`, the two reductions included) at the big-N
// shape with K = 72 takes 13.1-13.4 ms at f32 against a 3.785 ms bound,
// and 4.9 ms at bf16 against 0.256, as with B tiles of one row tile
// (which hold 4x the gamma partials): the adds into the partial cost what
// the reduction no longer reads.
//
// At compute dtype bf16 (kBf16, the reference's dtype=jnp.bfloat16:
// `_ratios_tile` and the dots of `_batch_stats_v2_kernel` and
// `_batch_stats_kernel`, stats_pallas.py:68-93, :225-259, :317-350) D =
// bf(t) bf(u), the gamma sums bf(R) bf(t) and the lambda sums bf(R) bf(u),
// each product exact in f32 and the sums f32. K7 and K6 run tensor-core
// bodies, `stats_v2_mma_kernel` at K <= 64 (below, with its note) and
// `stats_v2_wide_kernel` above.
//
// The replicate axis (batched replicates, the reference's passes under
// jax.vmap): one launch runs R independent calls, replicate z in the
// grid's z, over arrays that are R x the single call's, back to back.
// Each body offsets its pointers in its prologue (rows by B W bytes, u by
// 4 W K, t1 and t0 by B K, the lambda partials by a call's W tiles x B K
// 2, the gamma partials by its row tiles x 4 W K),
// before it stages anything, and each replicate runs on the grid its own
// call would, so its sums add in the same order: its result is bitwise
// the single call's. The reductions take R in z at the same strides. R =
// 1 is the single call.
#pragma once

#include <type_traits>

#include "psd_common.cuh"

namespace {

// ---- K7, K <= 64 -----------------------------------------------------------

constexpr int kV2Warps = 4;
constexpr int kV2Threads = 32 * kV2Warps;
constexpr int kV2Rows = kV2Threads;     // rows of a CTA: a warp owns 32
constexpr int kV2Cols = 8;              // byte columns of a sub-tile ...
constexpr int kV2Ind = 4 * kV2Cols;     // ... its 32 individuals
constexpr int kV2RS = kV2Ind + 1;       // R's row stride, odd
constexpr int kV2Slice = 2 * 32 * kV2RS;  // a warp's R1 and R0 (floats)

// Dynamic shared memory of the K7 body: t of the CTA's rows, the warps' R
// slices, and two buffers each of the sub-tile's u and packed bytes.
template <int KM>
__host__ __device__ constexpr int v2_smem_bytes() {
  return (kV2Rows * 2 * KM + kV2Warps * kV2Slice + 2 * kV2Ind * KM) *
             (int)sizeof(float) +
         2 * kV2Rows * kV2Cols;
}

// The sub-tile at byte column wc, read into registers ahead of its use:
// thread r's row b0 + r (8 bytes, word-wide where aligned; MISSING beyond
// B and W) and KM/4 floats of the 32 individuals' u (zero beyond K and W).
template <int KM>
struct V2Fetch {
  uint32_t lo, hi;
  float u[KM / 4];

  __device__ __forceinline__ void load(const uint8_t* __restrict__ rows,
                                       const float* __restrict__ up, int B,
                                       int W, int K, int b0, int wc) {
    const int r = threadIdx.x;
    lo = hi = 0xFFFFFFFFu;
    if (b0 + r < B) {
      const uint8_t* q = rows + (long long)(b0 + r) * W + wc;
      if (wc + kV2Cols <= W && (reinterpret_cast<uintptr_t>(q) & 7) == 0) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(q));
        lo = v.x;
        hi = v.y;
      } else {
#pragma unroll
        for (int c = 0; c < kV2Cols; ++c) {
          if (wc + c < W) {
            uint32_t& d = c < 4 ? lo : hi;
            d &= ~(0xFFu << (8 * (c & 3)));
            d |= (uint32_t)__ldg(q + c) << (8 * (c & 3));
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < KM / 4; ++m) {
      const int j = r + m * kV2Threads;     // over (individual, k)
      const int n = j / KM, k = j % KM;
      const int w = wc + (n & 7);
      u[m] = w < W && k < K
                 ? __ldg(up + ((long long)(n >> 3) * W + w) * K + k)
                 : 0.f;
    }
  }

  __device__ __forceinline__ void store(uint32_t* bytes, float* us) const {
    reinterpret_cast<uint2*>(bytes)[threadIdx.x] = make_uint2(lo, hi);
#pragma unroll
    for (int m = 0; m < KM / 4; ++m) us[threadIdx.x + m * kV2Threads] = u[m];
  }
};

// Phase 2 of K7: s += R U over the sub-tile's 32 individuals for the
// lane's row (its R row r1, r0 of the warp's slice; u rows as float4
// broadcasts), in individual order.
template <int KM>
__device__ __forceinline__ void lambda_row(const float* __restrict__ r1,
                                           const float* __restrict__ r0,
                                           const float* __restrict__ us,
                                           float (&s1)[KM], float (&s0)[KM]) {
#pragma unroll 4
  for (int j = 0; j < kV2Ind; ++j) {
    const float x1 = r1[j], x0 = r0[j];
    const float4* q = reinterpret_cast<const float4*>(us + j * KM);
#pragma unroll
    for (int k4 = 0; k4 < KM / 4; ++k4) {
      const float4 v = q[k4];
      const float u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s1[4 * k4 + e] = fmaf(x1, u[e], s1[4 * k4 + e]);
        s0[4 * k4 + e] = fmaf(x0, u[e], s0[4 * k4 + e]);
      }
    }
  }
}

// K7, K <= 64. grid (ceil(W/tile_cols), ceil(B/kV2Rows), R); dynamic
// shared memory v2_smem_bytes<KM>(). lpart (gridDim.x, B, K, 2), gpart
// (gridDim.y, 4W, K). Warp q owns rows b0 + [32q, 32q + 32) for the whole
// W tile; per sub-tile of 8 byte columns:
//   phase 1, lane = individual (plane lane / 8, column lane % 8):
//     `gamma_rows` over the warp's 32 rows, R into the warp's own slice;
//   phase 2, lane = row: s += R U over the 32 individuals (registers,
//     across the whole W tile);
//   the warps' g partials (in their R slices) are added in warp order
//     into the row tile's gpart.
// No warp reads another's R, so phases 1 and 2 need no barrier between
// them; the sub-tile costs two (its staged data; the g partials).
template <int KM, int kDiv>
__global__ void __launch_bounds__(kV2Threads, KM <= 16 ? 4 : 1)
stats_v2_kernel(const uint8_t* __restrict__ rows, const float* __restrict__ up,
                const float* __restrict__ t1g, const float* __restrict__ t0g,
                float* __restrict__ lpart, float* __restrict__ gpart, int B,
                int W, int K, int tile_cols) {
  constexpr int RB = KM <= 8 ? 2 : 1;    // rows in flight in phase 1
  const long long z = blockIdx.z;        // the replicate
  rows += z * B * W;
  up += 4 * z * W * K;
  t1g += z * B * K;
  t0g += z * B * K;
  lpart += z * gridDim.x * B * K * 2;
  gpart += 4 * z * gridDim.y * W * K;
  extern __shared__ __align__(16) float v2_smem[];
  float4* tsm = reinterpret_cast<float4*>(v2_smem);  // (kV2Rows, KM/2)
  float* R = v2_smem + kV2Rows * 2 * KM;             // kV2Warps slices
  float* usm = R + kV2Warps * kV2Slice;              // 2 x (32, KM)
  uint32_t* bsm = reinterpret_cast<uint32_t*>(usm + 2 * kV2Ind * KM);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wbeg = blockIdx.x * tile_cols;
  const int wend = min(W, wbeg + tile_cols);
  const int b0 = blockIdx.y * kV2Rows;
  float* r1w = R + warp * kV2Slice;
  float* r0w = r1w + 32 * kV2RS;

  float* tf = v2_smem;  // t of the CTA's rows, (t1, t0) interleaved, once
  for (int j = threadIdx.x; j < kV2Rows * 2 * KM; j += kV2Threads) {
    const int r = j / (2 * KM), rem = j % (2 * KM), k = rem >> 1;
    const long long b = b0 + r;
    tf[j] = b < B && k < K ? (rem & 1 ? t0g : t1g)[b * K + k] : 0.f;
  }
  V2Fetch<KM> next;
  next.load(rows, up, B, W, K, b0, wbeg);
  next.store(bsm, usm);

  float s1[KM], s0[KM];
#pragma unroll
  for (int k = 0; k < KM; ++k) s1[k] = s0[k] = 0.f;
  const int nsub = (wend - wbeg + kV2Cols - 1) / kV2Cols;
  for (int i = 0; i < nsub; ++i) {
    const int wc = wbeg + i * kV2Cols;
    const float* us = usm + (i & 1) * kV2Ind * KM;
    const uint8_t* by =
        reinterpret_cast<const uint8_t*>(bsm + (i & 1) * 2 * kV2Rows);
    __syncthreads();  // sub-tile i is staged; the last g partials are read
    const bool more = i + 1 < nsub;
    if (more) next.load(rows, up, B, W, K, b0, wc + kV2Cols);

    float uk[KM], g[KM];
    const float4* uq = reinterpret_cast<const float4*>(us + lane * KM);
#pragma unroll
    for (int k4 = 0; k4 < KM / 4; ++k4) {
      const float4 v = uq[k4];
      uk[4 * k4] = v.x;
      uk[4 * k4 + 1] = v.y;
      uk[4 * k4 + 2] = v.z;
      uk[4 * k4 + 3] = v.w;
    }
#pragma unroll
    for (int k = 0; k < KM; ++k) g[k] = 0.f;
    tt::gamma_rows<KM, RB, kDiv, true>(
        uk, g, tsm + warp * 32 * (KM / 2), by + warp * 32 * kV2Cols + (lane & 7),
        kV2Cols, 2 * (lane >> 3), 32, r1w + lane, r0w + lane, kV2RS);
    __syncwarp();
    lambda_row<KM>(r1w + lane * kV2RS, r0w + lane * kV2RS, us, s1, s0);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < KM; ++k) r1w[lane * (KM + 1) + k] = g[k];
    if (more)
      next.store(bsm + ((i + 1) & 1) * 2 * kV2Rows,
                 usm + ((i + 1) & 1) * kV2Ind * KM);
    __syncthreads();  // every warp's g partial is in its slice
    for (int j = threadIdx.x; j < kV2Ind * K; j += kV2Threads) {
      const int n = j / K, k = j % K;
      const int w = wc + (n & 7);
      if (w >= W) continue;
      float v = R[n * (KM + 1) + k];
#pragma unroll
      for (int q = 1; q < kV2Warps; ++q) v += R[q * kV2Slice + n * (KM + 1) + k];
      gpart[((long long)blockIdx.y * 4 * W + (long long)(n >> 3) * W + w) * K +
            k] = v;
    }
  }
  const int b = b0 + threadIdx.x;
  if (b >= B) return;
  float2* out = reinterpret_cast<float2*>(
      lpart + ((long long)blockIdx.x * B + b) * K * 2);
#pragma unroll
  for (int k = 0; k < KM; ++k)
    if (k < K) out[k] = make_float2(s1[k], s0[k]);
}

// ---- K7 at compute dtype bf16, K <= 64: on the tensor cores ---------------
//
// The chain of `tt::lambda_pass_mma_kernel` (psd_mma.cuh) with a third
// product, on `mma.sync.aligned.m16n8k16` (bf16 operands, f32 sums):
//   D = [bf(t1); bf(t0)] bf(U)^T   (m16: 8 rows x 2 alleles, n8: individuals)
//   R = bf(A / (D + 1e-30))        on the accumulators (`ratio<kDiv>`)
//   S += R bf(U)                   the accumulators, register for register,
//                                  are the A fragment (the λ pass's step)
//   g^T += [bf(t1)^T bf(t0)^T] R   (m16: 16 columns of K, k16: the 8 rows x
//                                  2 alleles, n8: individuals)
// The third product needs R as a B fragment: k = allele-rows 2t, 2t + 1,
// n = individual g, the transpose of the accumulator's (row g,
// individuals 2t, 2t + 1). `movmatrix.m8n8.trans` turns each 8 x 8 block
// of bf16 R in registers, four a step, with no trip through shared
// memory. Its A operand, bf(t)^T of the warp's rows, is constant for the
// CTA's life and sits in registers beside D's A operand.
//
// Layout, kept from the f32 body: a CTA is 4 warps and V2Mma<KN>::kRows
// rows, a warp owns MT m-tiles of 8 rows for the whole W tile, so S stays
// in registers and leaves once as the W tile's λ partial. A sub-tile is
// NSTEP steps of 16 individuals (4 byte columns x 4 planes, natural
// order 4c + s); a step's g partial (16 individuals x KP) goes into the
// warp's own slice of shared memory, and once per sub-tile the four
// warps' slices are added in warp order into the B tile's γ partial. The
// rows' packed words and bf(U) of the next sub-tile are fetched into
// registers while the current one runs, into double buffers: two
// barriers a sub-tile. MT is 4 / KD (KD = k16 steps of D), so that t's
// two A operands and S take the same 64 registers at every K: 128 rows a
// CTA at K <= 16, 64 at K <= 32, 32 at K <= 64 (ops/stats_packed.py
// `v2_tile_rows`). No atomics, and an MMA's sum order is fixed: a re-run
// is bitwise equal.
//
// Edges: rows past B have t = 0 and MISSING words, individuals past the W
// tile u = 0 and MISSING words; their R is 0 x a finite reciprocal = 0 and
// adds exactly 0 to S and g. K pads to 16 in D and g and to 8 in S.
//
// What bounds it: not the products (12K an entry at 989 TFLOP/s) but,
// as in the passes, the per-entry work the tensor cores leave to the
// FP32 and integer pipes: the decode, two divides and the conversions,
// and the latency between them. Measured (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md): 1.37-1.40 ms at B = 4096, W = 25,088, K = 10, against 2.47
// for the SIMT body with rounded operands that it replaced and 2.34 for
// the f32 body. At K <= 16 it takes 128 registers and spills 144-160 B;
// three CTAs an SM at 168 registers without spills took 1.52 ms, and
// bf(t)^T made from D's A operand by `movmatrix` at each step (16
// registers fewer) took the same time, so four CTAs of 4 warps stay.
template <int KN>
struct V2Mma {
  static constexpr int KD = (KN + 1) / 2;       // k16 steps of D, m16 of g
  static constexpr int KP = 16 * KD;            // K padded for D and g
  static constexpr int MT = 4 / KD;             // m-tiles of 8 rows a warp
  static constexpr int kRows = 4 * 8 * MT;      // rows of a CTA
  static constexpr int NSTEP = KP == 64 ? 2 : 4;  // steps of a sub-tile
  static constexpr int SC = 4 * NSTEP;          // its byte columns
  static constexpr int NI = 4 * SC;             // its individuals
  static constexpr int US = KP + 8;             // bf16 a staged u row
  static constexpr int WS = NSTEP + 1;          // words a staged row (odd)
  static constexpr int GS = KP + 4;             // floats a slice row
  static constexpr int UW = NI * KP / 2 / kV2Threads;  // u words a thread
  static constexpr int BW = (kRows * NSTEP + kV2Threads - 1) / kV2Threads;
  static constexpr int kSmemBytes =
      2 * NI * US * 2 + 2 * kRows * WS * 4 + kV2Warps * NI * GS * 4;
};

// bf16 8 x 8 block transposed in registers: lane l gives (row l / 4,
// columns 2 (l % 4), + 1) and gets the same of the transpose.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(d) : "r"(a));
  return d;
}

// The sub-tile at byte column wc, into registers ahead of its use: BW of
// its kRows x NSTEP packed words (MISSING past B and past wend) and UW
// words of bf(U) pairs of its NI individuals (zero past K and wend).
template <class C>
struct V2MmaFetch {
  uint32_t w[C::BW];
  uint32_t u[C::UW];

  __device__ __forceinline__ void load(const uint8_t* __restrict__ rows,
                                       const float* __restrict__ up, int B,
                                       int W, int K, int b0, int wc,
                                       int wend) {
#pragma unroll
    for (int j = 0; j < C::BW; ++j) {
      const int f = threadIdx.x * C::BW + j;
      const int r = f / C::NSTEP, c = wc + 4 * (f % C::NSTEP);
      uint32_t v = 0xFFFFFFFFu;
      if (f < C::kRows * C::NSTEP && b0 + r < B) {
        const uint8_t* q = rows + (long long)(b0 + r) * W + c;
        if (c + 4 <= wend && (reinterpret_cast<uintptr_t>(q) & 3) == 0) {
          v = __ldg(reinterpret_cast<const uint32_t*>(q));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (c + e < wend) {
              v &= ~(0xFFu << (8 * e));
              v |= (uint32_t)__ldg(q + e) << (8 * e);
            }
          }
        }
      }
      w[j] = v;
    }
#pragma unroll
    for (int j = 0; j < C::UW; ++j) {
      const int f = threadIdx.x * C::UW + j;
      const int n = f / (C::KP / 2), k = 2 * (f % (C::KP / 2));
      const int c = wc + (n >> 2);
      const float* ug = up + ((long long)(n & 3) * W + c) * K;
      const bool ok = c < wend;
      const float x0 = ok && k < K ? __ldg(ug + k) : 0.f;
      const float x1 = ok && k + 1 < K ? __ldg(ug + k + 1) : 0.f;
      u[j] = tt::pack_bf16(x0, x1);
    }
  }

  __device__ __forceinline__ void store(uint32_t* bw, uint32_t* uw) const {
#pragma unroll
    for (int j = 0; j < C::BW; ++j) {
      const int f = threadIdx.x * C::BW + j;
      if (f < C::kRows * C::NSTEP)
        bw[(f / C::NSTEP) * C::WS + f % C::NSTEP] = w[j];
    }
#pragma unroll
    for (int j = 0; j < C::UW; ++j) {
      const int f = threadIdx.x * C::UW + j;
      uw[(f / (C::KP / 2)) * (C::US / 2) + f % (C::KP / 2)] = u[j];
    }
  }
};

// K7 at bf16, K <= 8 KN. grid (ceil(W/tile_cols), ceil(B/kRows), R); dynamic
// shared memory V2Mma<KN>::kSmemBytes. lpart (gridDim.x, B, K, 2), gpart
// (gridDim.y, 4W, K), as stats_v2_kernel's.
template <int KN, int kDiv>
__global__ void __launch_bounds__(kV2Threads, KN <= 2 ? 4 : 2)
stats_v2_mma_kernel(const uint8_t* __restrict__ rows,
                    const float* __restrict__ up,
                    const float* __restrict__ t1g,
                    const float* __restrict__ t0g, float* __restrict__ lpart,
                    float* __restrict__ gpart, int B, int W, int K,
                    int tile_cols) {
  using C = V2Mma<KN>;
  constexpr int KD = C::KD, MT = C::MT, KP = C::KP, US = C::US;
  const long long z = blockIdx.z;        // the replicate (stats_v2_kernel)
  rows += z * B * W;
  up += 4 * z * W * K;
  t1g += z * B * K;
  t0g += z * B * K;
  lpart += z * gridDim.x * B * K * 2;
  gpart += 4 * z * gridDim.y * W * K;
  extern __shared__ __align__(16) unsigned char v2m_smem[];
  __nv_bfloat16* usm = reinterpret_cast<__nv_bfloat16*>(v2m_smem);
  uint32_t* bsm = reinterpret_cast<uint32_t*>(usm + 2 * C::NI * US);
  float* gsm = reinterpret_cast<float*>(bsm + 2 * C::kRows * C::WS);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wbeg = blockIdx.x * tile_cols;
  const int wend = min(W, wbeg + tile_cols);
  const int b0 = blockIdx.y * C::kRows;
  const int rw = warp * 8 * MT;              // the warp's first row
  float* gw = gsm + warp * C::NI * C::GS;    // the warp's γ slice

  // A of D for m-tile m (rows 0-7 bf(t1), 8-15 bf(t0) of its 8 rows: row
  // g, k 2t, 2t+1 (+ 8)) and A of g^T (k g (+ 8), rows 2t, 2t+1 of t1,
  // then of t0), zero past B and past K
  uint32_t at[MT][KD][4], ag[MT][KD][4];
  auto tval = [&](const float* tg, int b, int k) {
    return b < B && k < K ? tg[(long long)b * K + k] : 0.f;
  };
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int bd = b0 + rw + 8 * m + g, bg = b0 + rw + 8 * m + 2 * t;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      const int k = 16 * kd + 2 * t, kg = 16 * kd + g;
      at[m][kd][0] = tt::pack_bf16(tval(t1g, bd, k), tval(t1g, bd, k + 1));
      at[m][kd][1] = tt::pack_bf16(tval(t0g, bd, k), tval(t0g, bd, k + 1));
      at[m][kd][2] =
          tt::pack_bf16(tval(t1g, bd, k + 8), tval(t1g, bd, k + 9));
      at[m][kd][3] =
          tt::pack_bf16(tval(t0g, bd, k + 8), tval(t0g, bd, k + 9));
      ag[m][kd][0] = tt::pack_bf16(tval(t1g, bg, kg), tval(t1g, bg + 1, kg));
      ag[m][kd][1] =
          tt::pack_bf16(tval(t1g, bg, kg + 8), tval(t1g, bg + 1, kg + 8));
      ag[m][kd][2] = tt::pack_bf16(tval(t0g, bg, kg), tval(t0g, bg + 1, kg));
      ag[m][kd][3] =
          tt::pack_bf16(tval(t0g, bg, kg + 8), tval(t0g, bg + 1, kg + 8));
    }
  }
  float acc[MT][KN][4];                      // S: rows g (S1), g + 8 (S0)
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  V2MmaFetch<C> next;
  next.load(rows, up, B, W, K, b0, wbeg, wend);
  next.store(bsm, reinterpret_cast<uint32_t*>(usm));
  const int nsub = (wend - wbeg + C::SC - 1) / C::SC;
  for (int i = 0; i < nsub; ++i) {
    const int wc = wbeg + i * C::SC;
    const int nb = min(C::SC, wend - wc);
    const __nv_bfloat16* us = usm + (i & 1) * C::NI * US;
    const uint32_t* bw = bsm + (i & 1) * C::kRows * C::WS;
    __syncthreads();  // sub-tile i is staged; the last γ partials are read
    const bool more = i + 1 < nsub;
    if (more) next.load(rows, up, B, W, K, b0, wc + C::SC, wend);

    const int nsteps = (nb + 3) >> 2;
    for (int st = 0; st < nsteps; ++st) {
      const __nv_bfloat16* ub = us + 16 * st * US;
      uint32_t bd[KD][4];   // B of D: (ind 0-7, k lo), (0-7, hi), (8-15, ..)
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        tt::ldsm_x4(bd[kd], ub + ((lane & 7) + 8 * (lane >> 4)) * US +
                                16 * kd + 8 * ((lane >> 3) & 1));
      uint32_t bs[KN][2];   // B of S, n8 tile j of K: individuals 0-15
#pragma unroll
      for (int jp = 0; jp < KN / 2; ++jp) {
        uint32_t r[4];
        tt::ldsm_x4_trans(r, ub + ((lane & 7) + 8 * ((lane >> 3) & 1)) * US +
                                 16 * jp + 8 * (lane >> 4));
        bs[2 * jp][0] = r[0];
        bs[2 * jp][1] = r[1];
        bs[2 * jp + 1][0] = r[2];
        bs[2 * jp + 1][1] = r[3];
      }
      if constexpr (KN % 2) {
        uint32_t r[2];
        tt::ldsm_x2_trans(r, ub + ((lane & 7) + 8 * ((lane >> 3) & 1)) * US +
                                 8 * (KN - 1));
        bs[KN - 1][0] = r[0];
        bs[KN - 1][1] = r[1];
      }
      float gacc[KD][2][4];  // g^T: k g (0, 1), g + 8 (2, 3); ind 2t, 2t+1
#pragma unroll
      for (int mk = 0; mk < KD; ++mk)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) gacc[mk][j][e] = 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const uint32_t wd = bw[(rw + 8 * m + g) * C::WS + st];
        if (__all_sync(0xffffffffu, wd == 0xFFFFFFFFu))
          continue;                          // the m-tile's entries all MISSING
        float d[2][4];                       // n8 tiles: individuals 0-7, 8-15
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          tt::mma_bf16(d[0], at[m][kd], bd[kd][0], bd[kd][1]);
          tt::mma_bf16(d[1], at[m][kd], bd[kd][2], bd[kd][3]);
        }
        // R on the accumulators, rounded: ar = (R1 0-7, R0 0-7, R1 8-15,
        // R0 8-15), the A fragment of S's MMA
        uint32_t ar[4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float r[4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t code = (wd >> (16 * j + 4 * t + 2 * e)) & 3u;
            const bool missing = code == 3u;
            const float x = (float)code;
            r[e] = tt::ratio<kDiv>(missing ? 0.f : x, d[j][e]);
            r[2 + e] = tt::ratio<kDiv>(missing ? 0.f : 2.f - x, d[j][2 + e]);
          }
          ar[2 * j] = tt::pack_bf16(r[0], r[1]);
          ar[2 * j + 1] = tt::pack_bf16(r[2], r[3]);
        }
#pragma unroll
        for (int j = 0; j < KN; ++j)
          tt::mma_bf16(acc[m][j], ar, bs[j][0], bs[j][1]);
        // g^T += bf(t)^T R: B of n8 tile j is (R1, R0) of its individuals,
        // transposed
        uint32_t rt[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) rt[q] = movmatrix_trans(ar[q]);
#pragma unroll
        for (int mk = 0; mk < KD; ++mk) {
          tt::mma_bf16(gacc[mk][0], ag[m][mk], rt[0], rt[1]);
          tt::mma_bf16(gacc[mk][1], ag[m][mk], rt[2], rt[3]);
        }
      }
      // the step's g partial into the warp's slice, (individual, k)
#pragma unroll
      for (int mk = 0; mk < KD; ++mk)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            gw[(16 * st + 8 * j + 2 * t + (e & 1)) * C::GS + 16 * mk + g +
               8 * (e >> 1)] = gacc[mk][j][e];
    }
    if (more)
      next.store(bsm + ((i + 1) & 1) * C::kRows * C::WS,
                 reinterpret_cast<uint32_t*>(usm + ((i + 1) & 1) * C::NI * US));
    __syncthreads();  // every warp's g partials are in its slice
    // the four slices added in warp order: plane-major, then column, then
    // k, so that a plane's columns are one run of gpart
    for (int j = threadIdx.x; j < 4 * nb * K; j += kV2Threads) {
      const int s = j / (nb * K), rem = j % (nb * K);
      const int c = rem / K, k = rem % K;
      const float* q = gsm + (4 * c + s) * C::GS + k;
      float v = q[0];
#pragma unroll
      for (int w = 1; w < kV2Warps; ++w) v += q[w * C::NI * C::GS];
      gpart[((long long)blockIdx.y * 4 * W + (long long)s * W + wc + c) * K +
            k] = v;
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int b = b0 + rw + 8 * m + g;
    if (b >= B) continue;
    float2* out = reinterpret_cast<float2*>(
        lpart + ((long long)blockIdx.x * B + b) * K * 2);
#pragma unroll
    for (int j = 0; j < KN; ++j) {
      const int k = 8 * j + 2 * t;
      if (k < K) out[k] = make_float2(acc[m][j][0], acc[m][j][2]);
      if (k + 1 < K) out[k + 1] = make_float2(acc[m][j][1], acc[m][j][3]);
    }
  }
}

// ---- K7, K > 64 -------------------------------------------------------------
//
// `stats_v2_wide_kernel<KP, kBf16>` (the note at the top of this file says
// what bounds it and what its design does): a CTA of 8 warps takes a row
// tile of 64 rows (128 M-rows: t1 and t0 of each row) at a time against
// a W tile walked in sub-tiles of 16 byte columns (64 individuals), with
// K in pieces of KP columns: D = t u^T, R = A / (D + eps), S += R u and
// g = t^T R, three products over the tile.

using tt::cp_async_commit;
using tt::cp_async_wait_group;
using tt::kW7Cols;
using tt::kW7Ind;
using tt::kW7M;
using tt::kW7Rows;
using tt::kW7Threads;
using tt::W7;
using tt::w7_m;
using tt::w7_piece_cols;
using tt::w7_pieces;
using tt::w7_stage_t;
using tt::w7_stage_u;
using tt::W7Mma;
using tt::W7Simt;

constexpr int kW7Group = 4;              // the most row tiles of a B tile

// The packed bytes of rows [b0, b0 + 64) at byte columns [wc, wc + 16),
// MISSING past B and wend (`tt::w7_stage_code_row`, a thread a row).
__device__ __forceinline__ void w7_stage_codes(uint8_t* cs,
                                               const uint8_t* __restrict__ rows,
                                               int B, int W, int b0, int wc,
                                               int wend) {
  const int r = threadIdx.x;
  if (r >= kW7Rows) return;
  const long long b = b0 + r;
  tt::w7_stage_code_row(cs + r * kW7Cols, b < B ? rows + b * W : nullptr,
                        wc, wend);
}

// K7's decode and divide over the shared tile's products (wide_tile.cuh):
// the f32 SIMT form, then the bf16 tensor-core one.

// R = A / (D + eps) of the thread's 16 entries into the R tile
template <int KP, class L>
__device__ __forceinline__ void w7_ratios(W7Simt<KP>& body, const L& sm,
                                          const uint8_t* codes, int approx) {
  constexpr int RFS = W7Simt<KP>::RFS;
  auto& d = body.d;
  const int q = threadIdx.x >> 4, c = threadIdx.x & 15;
  float* rf = static_cast<float*>(sm.r);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = 4 * q + e;
    const uint32_t byte = codes[r * kW7Cols + c];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t code = (byte >> (2 * p)) & 3u;
      const bool miss = code == 3u;
      const float x = (float)code;
      rf[w7_m(r, 0) * RFS + 16 * p + c] =
          tt::ratio(miss ? 0.f : x, d[e][0][p], approx);
      rf[w7_m(r, 1) * RFS + 16 * p + c] =
          tt::ratio(miss ? 0.f : 2.f - x, d[e][1][p], approx);
    }
  }
}

// R = A / (D + eps) on the accumulators, rounded, into the R tile: the
// thread's row 8w + g, individuals 8j + 2t (+1) of n8 tile j (plane
// j / 2, byte column 8 (j % 2) + 2t (+1))
template <int KP, class L>
__device__ __forceinline__ void w7_ratios(W7Mma<KP>& body, const L& sm,
                                          const uint8_t* codes, int approx) {
  constexpr int RHS = W7Mma<KP>::RHS;
  auto& d = body.d;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint4 cw =
      *reinterpret_cast<const uint4*>(codes + (8 * w + g) * kW7Cols);
  const uint32_t lo = t >> 1 ? cw.y : cw.x, hi = t >> 1 ? cw.w : cw.z;
  uint32_t* r1 = reinterpret_cast<uint32_t*>(
                     static_cast<__nv_bfloat16*>(sm.r) + (16 * w + g) * RHS) +
                 t;
  uint32_t* r0 = r1 + 4 * RHS;           // 8 M-rows on (bf16 pairs)
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t word = j & 1 ? hi : lo;
    float x[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t code =
          (word >> (8 * (2 * (t & 1) + e) + 2 * (j >> 1))) & 3u;
      const bool miss = code == 3u;
      const float a1 = (float)code;
      x[e] = tt::ratio(miss ? 0.f : a1, d[j][e], approx);
      x[2 + e] = tt::ratio(miss ? 0.f : 2.f - a1, d[j][2 + e], approx);
    }
    r1[4 * j] = tt::pack_bf16(x[0], x[1]);
    r0[4 * j] = tt::pack_bf16(x[2], x[3]);
  }
}

// K7, K > 64. grid (ceil(W/tile_cols), ceil(B/tile_rows), R); block
// kW7Threads; dynamic shared memory W7<KP, kBf16>::kBytes; KP =
// w7_piece_cols(K). A CTA's B tile of tile_rows (64, 128 or 256) is walked
// as row tiles of 64, whose g go into the B tile's one gamma partial,
// added in row-tile order. lpart (gridDim.x, B, K, 2), gpart (gridDim.y,
// 4W, K), as stats_v2_kernel's. One piece (K <= 128): t staged once a row
// tile, u and the bytes of the next sub-tile (of this row tile or the
// next) copied (cp.async) while one runs; the lambda sums stay in
// registers for the W tile. Several pieces: per sub-tile, D summed over
// the pieces (each staged), then each piece staged again for its S and g;
// its S added into the row tile's rows of lpart. At bf16 and KP <= 96 two
// CTAs share an SM (128 registers, a few spilled; 95 and 109 KiB of
// shared memory): a trial build at one CTA (194 registers, no spills) was
// slower at the big-N shape with K = 72, its barriers idling the SM.
template <int KP, bool kBf16>
__global__ void __launch_bounds__(kW7Threads, kBf16 && KP <= 96 ? 2 : 1)
stats_v2_wide_kernel(const uint8_t* __restrict__ rows,
                     const float* __restrict__ up,
                     const float* __restrict__ t1g,
                     const float* __restrict__ t0g, float* __restrict__ lpart,
                     float* __restrict__ gpart, int B, int W, int K,
                     int tile_rows, int tile_cols, int approx) {
  using L = W7<KP, kBf16>;
  const long long z = blockIdx.z;        // the replicate (stats_v2_kernel)
  rows += z * B * W;
  up += 4 * z * W * K;
  t1g += z * B * K;
  t0g += z * B * K;
  lpart += z * gridDim.x * B * K * 2;
  gpart += 4 * z * gridDim.y * W * K;
  extern __shared__ __align__(16) unsigned char w7_smem[];
  const L sm(w7_smem);
  const int wbeg = blockIdx.x * tile_cols;
  const int wend = min(W, wbeg + tile_cols);
  const int bt0 = blockIdx.y * tile_rows;
  // the row tiles of the B tile that hold rows
  const int nrt = (min(tile_rows, B - bt0) + kW7Rows - 1) / kW7Rows;
  const int np = w7_pieces(K);
  const int nsub = (wend - wbeg + kW7Cols - 1) / kW7Cols;
  float* ltile = lpart + (long long)blockIdx.x * B * K * 2;
  float* gtile = gpart + (long long)blockIdx.y * 4 * W * K;
  // the columns of piece p that D sums (the staged rest is zero)
  auto span = [&](int p) {
    const int n = min(KP, K - p * KP);
    return kBf16 ? (n + 15) & ~15 : (n + 3) & ~3;
  };
  // piece p of t (rows from b0) and of u at byte column wc (and the
  // bytes), staged and waited for: several pieces only
  auto stage_piece = [&](int p, int b0, int wc, bool bytes) {
    __syncthreads();                     // the last piece's readers are done
    w7_stage_t<KP, kBf16>(sm.t, t1g, t0g, K, 1, B, K, b0, p * KP);
    w7_stage_u<KP>(sm.ufb(0), up, W, K, wc, wend, p * KP);
    if (bytes) w7_stage_codes(sm.cb(0), rows, B, W, b0, wc, wend);
    cp_async_commit();
    cp_async_wait_group<0>();
    __syncthreads();
  };
  std::conditional_t<kBf16, W7Mma<KP>, W7Simt<KP>> body;
  body.zero_s();
  if (np == 1) {                         // the first sub-tile's u and bytes
    w7_stage_u<KP>(sm.ufb(0), up, W, K, wbeg, wend, 0);
    w7_stage_codes(sm.cb(0), rows, B, W, bt0, wbeg, wend);
    cp_async_commit();
  }
  // sub-tile i of row tile rt, the it-th of the CTA
  for (int it = 0, rt = 0, i = 0; it < nrt * nsub; ++it) {
    const int b0 = bt0 + rt * kW7Rows, wc = wbeg + i * kW7Cols;
    const bool last = i + 1 == nsub;     // the row tile's last sub-tile
    const int buf = np == 1 ? it & 1 : 0;
    if (np == 1) {
      // t of the row tile: its last readers passed the barrier that ends
      // the sub-tile before
      if (i == 0)
        w7_stage_t<KP, kBf16>(sm.t, t1g, t0g, K, 1, B, K, b0, 0);
      if (it + 1 < nrt * nsub) {         // the next sub-tile's, of this row
        const int wn = last ? wbeg : wc + kW7Cols;  // tile or the next
        w7_stage_u<KP>(sm.ufb(buf ^ 1), up, W, K, wn, wend, 0);
        w7_stage_codes(sm.cb(buf ^ 1), rows, B, W, last ? b0 + kW7Rows : b0,
                       wn, wend);
      }
      cp_async_commit();
      cp_async_wait_group<1>();          // sub-tile it has landed
      __syncthreads();
      body.prepare(sm, buf);
      body.d_product(sm, buf, span(0), true);
    } else {
      for (int p = 0; p < np; ++p) {
        stage_piece(p, b0, wc, p == 0);
        body.prepare(sm, 0);
        body.d_product(sm, 0, span(p), p == 0);
      }
    }
    w7_ratios(body, sm, sm.cb(buf), approx);
    for (int p = 0; p < np; ++p) {
      if (np == 1) {
        __syncthreads();                 // the R tile is written
      } else {
        stage_piece(p, b0, wc, false);
        body.prepare(sm, 0);
        body.zero_s();
      }
      body.s_product(sm, buf);
      decltype(body)::G::write(sm, gtile, W, K, wc, wend, p * KP,
                               rt > 0);
      if (np > 1) body.flush_s(ltile, B, K, b0, p * KP, i > 0);
    }
    if (np == 1) {
      __syncthreads();                   // R, t, u and the bytes are read
      if (last) {                        // the row tile's S leaves
        body.flush_s(ltile, B, K, b0, 0, false);
        body.zero_s();
      }
    }
    if (last) {
      ++rt;
      i = 0;
    } else {
      ++i;
    }
  }
}

// K7's and K6's launch (K6: approx = 0): the body K picks (at bf16 and
// K <= 64 the tensor-core body; K > 64 `stats_v2_wide_kernel` at the
// piece width K takes), then the lambda partials' and the gamma partials'
// reductions in tile order. Arguments as tt_batch_stats_fused_v2; tile_rows must be the body's
// (ops/stats_packed.py `v2_tile_rows`), at K > 64 1, 2 or 4 times it
// (`v2_b_tile`). R replicates, replicate z in the grid's z.
template <bool kBf16>
int batch_stats_fused_v2(int R, const uint8_t* rows, const float* up,
                         const float* t1, const float* t0, float* l0,
                         float* l1, float* g, float* lpart, float* gpart,
                         int B, int W, int K, int tile_rows, int tile_cols,
                         int approx, cudaStream_t stream) {
  const int km = tt::pick_km(K, true);
  int body_rows = kV2Rows, body_cols = kV2Cols;
  if (km == tt::kWide) {
    body_rows = kW7Rows;
    body_cols = kW7Cols;
  } else if (kBf16) {
    const int kd = (km + 15) / 16;  // V2Mma<KN>: 4 / KD m-tiles a warp
    body_rows = 32 * (4 / kd);
    body_cols = kd == 4 ? 8 : 16;
  }
  // K > 64: a B tile of 1, 2 or 4 row tiles (ops/stats_packed.py
  // `v2_b_tile`)
  const bool rows_ok = km == tt::kWide
                           ? tile_rows % body_rows == 0 &&
                                 tile_rows <= kW7Group * body_rows
                           : tile_rows == body_rows;
  if (B <= 0 || W <= 0 || km < 0 || tile_rows <= 0 || !rows_ok ||
      tile_cols <= 0 || tile_cols % body_cols || R < 1 || R > 65535)
    return (int)cudaErrorInvalidValue;
  const int nwt = (W + tile_cols - 1) / tile_cols;
  const int nbt = (B + tile_rows - 1) / tile_rows;
  const dim3 grid(nwt, nbt, R);
  if (km == tt::kWide) {
#define TT_WIDE(KP)                                                          \
  {                                                                          \
    constexpr int bytes = W7<KP, kBf16>::kBytes;                             \
    const cudaError_t e = cudaFuncSetAttribute(                              \
        stats_v2_wide_kernel<KP, kBf16>,                                     \
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);                 \
    if (e != cudaSuccess) return (int)e;                                     \
    stats_v2_wide_kernel<KP, kBf16><<<grid, kW7Threads, bytes, stream>>>(    \
        rows, up, t1, t0, lpart, gpart, B, W, K, tile_rows, tile_cols,       \
        approx);                                                             \
  }
    switch (w7_piece_cols(K)) {
      case 80: TT_WIDE(80) break;
      case 96: TT_WIDE(96) break;
      case 112: TT_WIDE(112) break;
      case 128: TT_WIDE(128) break;
      default: return (int)cudaErrorInvalidValue;
    }
#undef TT_WIDE
  } else if constexpr (kBf16) {
#define TT_BODY(KN, DIV)                                                     \
  {                                                                          \
    static_assert(V2Mma<KN>::kRows == 32 * (4 / ((KN + 1) / 2)));            \
    constexpr int bytes = V2Mma<KN>::kSmemBytes;                             \
    const cudaError_t e = cudaFuncSetAttribute(                              \
        stats_v2_mma_kernel<KN, DIV>,                                        \
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);                 \
    if (e != cudaSuccess) return (int)e;                                     \
    stats_v2_mma_kernel<KN, DIV><<<grid, kV2Threads, bytes, stream>>>(       \
        rows, up, t1, t0, lpart, gpart, B, W, K, tile_cols);                 \
  }
#define TT_LAUNCH(KM)                      \
  if (approx) {                            \
    TT_BODY((KM + 7) / 8, tt::kDivFast)    \
  } else {                                 \
    TT_BODY((KM + 7) / 8, tt::kDivExact)   \
  }
    TT_DISPATCH_KM12(km, TT_LAUNCH)
#undef TT_LAUNCH
#undef TT_BODY
  } else {
#define TT_BODY(KM, DIV)                                                     \
  {                                                                          \
    constexpr int bytes = v2_smem_bytes<KM>();                               \
    const cudaError_t e = cudaFuncSetAttribute(                              \
        stats_v2_kernel<KM, DIV>,                                            \
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);                 \
    if (e != cudaSuccess) return (int)e;                                     \
    stats_v2_kernel<KM, DIV><<<grid, kV2Threads, bytes, stream>>>(           \
        rows, up, t1, t0, lpart, gpart, B, W, K, tile_cols);                 \
  }
#define TT_LAUNCH(KM)            \
  if (approx) {                  \
    TT_BODY(KM, tt::kDivFast)    \
  } else {                       \
    TT_BODY(KM, tt::kDivExact)   \
  }
    TT_DISPATCH_KM12(km, TT_LAUNCH)
#undef TT_LAUNCH
#undef TT_BODY
  }
  TT_CHECK_LAUNCH();
  const int bk = B * K;
  tt::split_reduce_kernel<<<dim3((bk + 255) / 256, 1, R), 256, 0, stream>>>(
      lpart, nwt, bk, l0, l1, 2LL * nwt * bk, bk);
  TT_CHECK_LAUNCH();
  const long long ng = 4LL * W * K;
  tt::gamma_reduce_kernel<<<dim3((unsigned)((ng + 255) / 256), 1, R), 256, 0,
                            stream>>>(gpart, nbt, ng, g, nbt * ng, ng);
  TT_CHECK_LAUNCH();
  return 0;
}

}  // namespace
