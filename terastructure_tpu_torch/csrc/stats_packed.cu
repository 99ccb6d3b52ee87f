// K4: lambda_stats_packed — one raw lambda-statistic pass from packed rows.
//
// Replaces terastructure_tpu/ops/stats_pallas.py `lambda_stats_packed`
// (`_lambda_kernel`, pallas_call at :165). The TPU kernel walks a
// (B/TB, W/TW) grid in order and accumulates (l0, l1) in its output block
// across the W axis. Here the pass body is `tt::lambda_pass_kernel`
// (psd_common.cuh, shared with K1): CTAs own 32 rows each and a slice of
// W, write partial sums, and `tt::split_reduce_kernel` adds the slices in a
// fixed order into (l0, l1).
// K8 (stats_acat.cu) runs the same body over pre-decoded count planes.
//
// Bound on the H100: the same as K1's pass, issue-bound on FMAs and
// divides (at the eval shape B=1024, W=640, K=8: ~84 M FMA, ~5 M divides,
// 0.66 MB of rows). The split over W keeps ~2 CTAs per SM at B=1024.

#include "psd_common.cuh"

extern "C" int tt_lambda_stats_packed(const uint8_t* rows, const float* up,
                                      const float* t1, const float* t0,
                                      float* l0, float* l1, float* part,
                                      int B, int W, int K, int nsplit,
                                      int approx, cudaStream_t stream) {
  const int km = tt::pick_km(K);
  if (B <= 0 || W <= 0 || nsplit <= 0 || km == 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + tt::kRowsPerCta - 1) / tt::kRowsPerCta, nsplit);
  const int wchunk = tt::split_chunk(W, nsplit);
  using Loader = tt::PackedLoader<tt::ContiguousRows>;
#define TT_LAUNCH(KM)                                                     \
  tt::lambda_pass_kernel<KM, Loader><<<grid, tt::kThreads, 0, stream>>>(  \
      Loader{{rows}}, up, t1, t0, K, 1, part, B, W, K, wchunk, approx,     \
      nullptr)
  TT_DISPATCH_KM(km, TT_LAUNCH)
#undef TT_LAUNCH
  TT_CHECK_LAUNCH();
  const int bk = B * K;
  tt::split_reduce_kernel<<<(bk + 255) / 256, 256, 0, stream>>>(part, nsplit, bk,
                                                            l0, l1);
  TT_CHECK_LAUNCH();
  return 0;
}
