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
// export at bf16.

#include "psd_common.cuh"

namespace {

template <bool kBf16>
int lambda_stats(const uint8_t* rows, const float* up, const float* t1,
                 const float* t0, float* l0, float* l1, float* part, int B,
                 int W, int K, int nsplit, int approx, cudaStream_t stream) {
  using Loader = tt::PackedLoader<tt::ContiguousRows>;
  if (const int err = tt::launch_lambda_pass<Loader, false, kBf16>(
          Loader{{rows}}, up, t1, t0, K, 1, part, B, W, K, nsplit,
          approx ? tt::kDivFast : tt::kDivExact, nullptr, stream))
    return err;
  const int bk = B * K;
  tt::split_reduce_kernel<<<(bk + 255) / 256, 256, 0, stream>>>(part, nsplit, bk,
                                                            l0, l1);
  TT_CHECK_LAUNCH();
  return 0;
}

}  // namespace

extern "C" int tt_lambda_stats_packed(const uint8_t* rows, const float* up,
                                      const float* t1, const float* t0,
                                      float* l0, float* l1, float* part,
                                      int B, int W, int K, int nsplit,
                                      int approx, cudaStream_t stream) {
  return lambda_stats<false>(rows, up, t1, t0, l0, l1, part, B, W, K, nsplit,
                             approx, stream);
}

extern "C" int tt_lambda_stats_packed_bf16(const uint8_t* rows,
                                           const float* up, const float* t1,
                                           const float* t0, float* l0,
                                           float* l1, float* part, int B,
                                           int W, int K, int nsplit,
                                           int approx, cudaStream_t stream) {
  return lambda_stats<true>(rows, up, t1, t0, l0, l1, part, B, W, K, nsplit,
                            approx, stream);
}
