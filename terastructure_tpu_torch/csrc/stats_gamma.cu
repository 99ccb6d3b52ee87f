// K5: gamma_stats_packed — the planar gamma statistic from packed rows.
//
// Replaces terastructure_tpu/ops/stats_pallas.py `gamma_stats_packed`
// (`_gamma_kernel`, pallas_call at :204). The TPU kernel walks a
// (W/TW, B/TB) grid and accumulates g (4, W, K) in its output block over
// the batch axis, in order. Here it is K1's and K2's last pass,
// `tt::gamma_pass_kernel` (psd_common.cuh): a CTA takes 32 byte columns x
// 4 planes and a slice of the rows (`gamma_grid` in ops/stats_packed.py),
// stages the rows' packed bytes and t in shared memory 64 rows at a time,
// and each thread runs `tt::gamma_rows` (the step K7's phase 1 runs too)
// for its individual; `gamma_reduce_kernel` adds the row slices in order
// (no atomics). With K4 it forms the `stats_kernel="pair"` statistics pass
// of the big-N step.
//
// Bound on the H100: FP32 issue (4K FMAs and two divides per row and
// individual). At the big-N shape (B=4096, W=25,088, K=10) that is
// ~16 G FMA and ~0.8 G divides against 103 MB of packed rows. K > 64
// runs `tt::gamma_pass_wide_kernel` (gamma_wide.cuh: D once an entry, K in
// pieces of up to 128 columns, a column tile walking 64-row tiles).
//
// tt_gamma_stats_packed_bf16 is the same pass at compute dtype bf16 (u, t
// and R rounded to bf16 as the products' operands, sums in f32): the γ
// pass K1 and K2 end with at bf16, through an entry of its own (the
// reference's gamma_stats_packed(dtype=jnp.bfloat16)). At K <= 64 it
// rounds t once (`tt::round_t`, one launch) into the layout the
// tensor-core body `tt::gamma_pass_mma_kernel` (psd_mma.cuh) stages by
// cp.async, on `gamma_grid`'s bf16 split.
//
// R > 1 runs R replicates of the pass in one launch (blockIdx.z,
// psd_common.cuh `Rep`): the batched replicates' big-N step with
// stats_kernel="pair", the reference's gamma_stats_packed under jax.vmap.
// rows, u planes, t1, t0, g and the partial sums are R x the single
// call's, back to back, and each replicate runs the single call's grid:
// its bits are the single call's. R = 1 is one pass.

#include "psd_common.cuh"

namespace {

tt::Rep gamma_rep(int B, int W, int K, int nsplit) {
  tt::Rep rep;
  rep.rows = (long long)B * W;
  rep.u = rep.out = 4LL * W * K;
  rep.t = (long long)B * K;
  rep.part = nsplit * rep.u;
  return rep;
}

}  // namespace

extern "C" int tt_gamma_stats_packed(int R, const uint8_t* rows,
                                     const float* up, const float* t1,
                                     const float* t0, float* g, float* gpart,
                                     int B, int W, int K, int nsplit,
                                     cudaStream_t stream) {
  return tt::launch_gamma_stats(tt::ContiguousRows{rows}, up, t1, t0, K, 1,
                                nullptr, gpart, g, B, W, K, nsplit, stream, R,
                                gamma_rep(B, W, K, nsplit));
}

// tb: scratch for bf(t1), bf(t0), R x (2, B, mma_kp(K)) bf16 (K <= 64;
// unused above), rounded here before the pass
extern "C" int tt_gamma_stats_packed_bf16(int R, const uint8_t* rows,
                                          const float* up, const float* t1,
                                          const float* t0, float* g,
                                          float* gpart, __nv_bfloat16* tb,
                                          int B, int W, int K, int nsplit,
                                          cudaStream_t stream) {
  if (K <= 64 && tb != nullptr)
    if (const int err = tt::round_t(t1, t0, K, 1, (long long)B * K, tb, B, K,
                                    R, stream))
      return err;
  return tt::launch_gamma_stats<tt::ContiguousRows, true>(
      tt::ContiguousRows{rows}, up, t1, t0, K, 1, tb, gpart, g, B, W, K,
      nsplit, stream, R, gamma_rep(B, W, K, nsplit));
}
