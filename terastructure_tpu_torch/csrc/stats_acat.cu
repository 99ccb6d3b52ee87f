// K8: lambda_stats_acat — one raw lambda-statistic pass over pre-decoded
// allele-count planes.
//
// Replaces terastructure_tpu/ops/stats_pallas.py `lambda_stats_acat`
// (`_lambda_acat_kernel`, pallas_call at :473). The big-N step decodes
// the column subsample of its rows once into a1, a0 (B, 4, W) bf16
// (`decode_count_planes`) and runs this pass local_iters times over them.
// The body is K4's, `tt::lambda_pass_kernel` (psd_common.cuh), with
// `tt::AcatLoader`: a CTA stages 64 rows x 16 columns x 4 planes of both
// planes as (a1, a0) bf16 pairs in shared memory (16-byte loads; odd word
// stride, so the lanes' reads are conflict-free) instead of unpacking
// bytes. Partial sums over column splits are added in split order (no
// atomics).
//
// Bound on the H100: at the big-N shape (B=4096, 4 x 2048 individuals of
// the subsample, K=10) a pass is ~1.3 G FMA and ~67 M divides against
// 134 MB of count planes, ~10 FMA a byte: issue-bound like K4, with the
// planes read once per pass (they do not fit the 50 MB L2).
// approx: fast divide (__fdividef), the reference's local_sub_approx_div.
//
// tt_lambda_stats_acat_bf16 is the same pass at compute dtype bf16 (the
// reference's lambda_stats_acat(dtype=jnp.bfloat16), :429-458: T and U
// rounded to bf16 as the products' operands, R rounded after the f32
// divide, sums in f32; the count planes are bf16 at both dtypes and exact).
// At K <= 64 it is the tensor-core pass `tt::lambda_pass_mma_kernel`
// (psd_mma.cuh) with `tt::AcatLoader`'s count-plane staging: a lane reads
// the (a1, a0) pairs of its row for the four individuals its D
// accumulators hold, as they are (any bf16 count, never re-coded); u is
// rounded once a call (`tt::round_u`, one launch) and staged by cp.async.
// K > 64 runs `tt::lambda_pass_wide_kernel` (lambda_wide.cuh) at either
// dtype.
//
// Every pass runs (`active` is null): at the big-N shape the reference's
// tol test lets all of the solve's loop passes run (PERF.md §6),
// so a device-side gate, as K1 has, would skip nothing.
//
// R > 1 runs R replicates of the pass in one launch (blockIdx.z,
// psd_common.cuh `Rep`): the batched replicates' big-N solve, the
// reference's lambda_stats_acat under jax.vmap. The planes, u planes, t1,
// t0, l0, l1 and the partial sums are R x the single call's, back to back;
// each body offsets its pointers before it stages a tile, and each
// replicate runs the single call's grid, so its bits are the single
// call's. R = 1 is one pass.

#include "psd_common.cuh"

namespace {

template <bool kBf16>
int lambda_stats_acat(int R, const uint16_t* a1, const uint16_t* a0,
                      const float* up, const float* t1, const float* t0,
                      float* l0, float* l1, float* part, __nv_bfloat16* ub,
                      int B, int W, int K, int nsplit, int approx,
                      cudaStream_t stream) {
  const int bk = B * K;
  tt::Rep rep;
  rep.rows = 4LL * B * W;
  rep.u = 4LL * W * K;
  rep.t = rep.out = bk;
  rep.part = 2LL * nsplit * bk;
  if (kBf16 && K <= 64 && ub != nullptr)
    if (const int err = tt::round_u(up, ub, W, K, R, stream)) return err;
  if (const int err = tt::launch_lambda_pass<tt::AcatLoader, false, kBf16>(
          tt::AcatLoader{a1, a0}, up, ub, t1, t0, K, 1, part, B, W, K,
          nsplit, approx ? tt::kDivFast : tt::kDivExact, nullptr, stream, R,
          rep))
    return err;
  tt::split_reduce_kernel<<<dim3((bk + 255) / 256, 1, R), 256, 0, stream>>>(
      part, nsplit, bk, l0, l1, rep.part, rep.out);
  TT_CHECK_LAUNCH();
  return 0;
}

}  // namespace

extern "C" int tt_lambda_stats_acat(int R, const uint16_t* a1,
                                    const uint16_t* a0, const float* up,
                                    const float* t1, const float* t0,
                                    float* l0, float* l1, float* part, int B,
                                    int W, int K, int nsplit, int approx,
                                    cudaStream_t stream) {
  return lambda_stats_acat<false>(R, a1, a0, up, t1, t0, l0, l1, part,
                                  nullptr, B, W, K, nsplit, approx, stream);
}

// ub: scratch for bf(u), R x (4W, mma_kp(K)) bf16 (K <= 64; unused above)
extern "C" int tt_lambda_stats_acat_bf16(int R, const uint16_t* a1,
                                         const uint16_t* a0, const float* up,
                                         const float* t1, const float* t0,
                                         float* l0, float* l1, float* part,
                                         __nv_bfloat16* ub, int B, int W,
                                         int K, int nsplit, int approx,
                                         cudaStream_t stream) {
  return lambda_stats_acat<true>(R, a1, a0, up, t1, t0, l0, l1, part, ub, B,
                                 W, K, nsplit, approx, stream);
}
