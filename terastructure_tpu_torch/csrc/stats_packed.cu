// K4: lambda_stats_packed — one raw lambda-statistic pass from packed rows.
//
// Replaces terastructure_tpu/ops/stats_pallas.py `lambda_stats_packed`
// (`_lambda_kernel`, pallas_call at :165). The TPU kernel walks a
// (B/TB, W/TW) grid in order and accumulates (l0, l1) in its output block
// across the W axis. Here the pass body is `tt::lambda_pass_kernel`
// (psd_common.cuh, shared with K1 and K2; its design note is there): a
// warp owns 32 rows and a chunk of W and writes partial sums, and
// `tt::split_reduce_kernel` adds the chunks in a fixed order into (l0, l1).
// K8 (stats_acat.cu) runs the same body over pre-decoded count planes.
//
// Bound on the H100: the FP32 rate, as K1's pass (at the eval shape B=1024,
// W=640, K=8: ~84 M FMA, ~5 M divides, 0.66 MB of rows). The split over W
// (`lambda_grid`: 40 chunks of 16 columns there) fills the card at
// B=1024. approx = 0 gives the bits of the IEEE divide, 1 uses __fdividef.
//
// tt_lambda_stats_packed_bf16 is the same pass at compute dtype bf16 (the
// reference's dtype=jnp.bfloat16: T, U and R rounded to bf16 as the
// products' operands, sums in f32), the pass of the eval re-solve and the
// export at bf16. At K <= 64 it rounds u once (`tt::round_u`, one launch)
// into the layout the tensor-core body `tt::lambda_pass_mma_kernel`
// (psd_mma.cuh) stages by cp.async, on `lambda_grid`'s bf16 split.
//
// R > 1 runs R replicates of the pass in one launch (blockIdx.z,
// psd_common.cuh `Rep`): the batched replicates' eval re-solve, where
// every replicate's gamma meets the same eval rows. The rows are shared
// (rows_stride 0) or R x (B, W) (rows_stride B W); u planes, t1, t0, l0,
// l1 and the partial sums are R x the single call's, back to back. R = 1
// is one pass.

#include "psd_common.cuh"

namespace {

template <bool kBf16>
int lambda_stats(const uint8_t* rows, const float* up, const float* t1,
                 const float* t0, float* l0, float* l1, float* part,
                 __nv_bfloat16* ub, int B, int W, int K, int nsplit,
                 int approx, cudaStream_t stream, int R,
                 long long rows_stride) {
  using Loader = tt::PackedLoader<tt::ContiguousRows>;
  const int bk = B * K;
  tt::Rep rep;
  rep.rows = rows_stride;
  rep.u = 4LL * W * K;
  rep.t = rep.out = bk;
  rep.part = 2LL * nsplit * bk;
  if (kBf16 && K <= 64 && ub != nullptr)
    if (const int err = tt::round_u(up, ub, W, K, R, stream)) return err;
  if (const int err = tt::launch_lambda_pass<Loader, false, kBf16>(
          Loader{{rows}}, up, ub, t1, t0, K, 1, part, B, W, K, nsplit,
          approx ? tt::kDivFast : tt::kDivExact, nullptr, stream, R, rep))
    return err;
  tt::split_reduce_kernel<<<dim3((bk + 255) / 256, 1, R), 256, 0, stream>>>(
      part, nsplit, bk, l0, l1, rep.part, rep.out);
  TT_CHECK_LAUNCH();
  return 0;
}

}  // namespace

extern "C" int tt_lambda_stats_packed(
    int R, const uint8_t* rows, const float* up, const float* t1,
    const float* t0, float* l0, float* l1, float* part, int B, int W, int K,
    int nsplit, int approx, long long rows_stride, cudaStream_t stream) {
  return lambda_stats<false>(rows, up, t1, t0, l0, l1, part, nullptr, B, W,
                             K, nsplit, approx, stream, R, rows_stride);
}

// ub: scratch for bf(u), R x (4W, mma_kp(K)) bf16 (K <= 64; unused above)
extern "C" int tt_lambda_stats_packed_bf16(
    int R, const uint8_t* rows, const float* up, const float* t1,
    const float* t0, float* l0, float* l1, float* part, __nv_bfloat16* ub,
    int B, int W, int K, int nsplit, int approx, long long rows_stride,
    cudaStream_t stream) {
  return lambda_stats<true>(rows, up, t1, t0, l0, l1, part, ub, B, W, K,
                            nsplit, approx, stream, R, rows_stride);
}

// How many floats x with bit patterns in [lo, hi) give a different
// reciprocal from the tensor-core passes' exact divide (psd_mma.cuh
// `rcp_rn`) than from __frcp_rn: into *bad (zeroed by the caller).
extern "C" int tt_rcp_rn_check(unsigned int lo, unsigned int hi,
                               unsigned long long* bad, cudaStream_t stream) {
  return tt::rcp_rn_check(lo, hi, bad, stream);
}
