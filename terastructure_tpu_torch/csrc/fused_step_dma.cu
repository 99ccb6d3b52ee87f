// K2: fused_local_solve_dma — the fused local solve reading its rows
// straight out of the packed matrix.
//
// Replaces terastructure_tpu/ops/fused_step.py `fused_local_solve_dma`
// (:493, pallas_call at :537; body `kernel_dma` :384-407). On the TPU the
// kernel DMAs B/g aligned groups of g consecutive rows (starts idx0 by
// scalar prefetch) from HBM into VMEM, because Mosaic's body reads only
// VMEM, then runs K1's body on the copy. Here there is no copy: the batch
// (B x W bytes, 0.66 MB at B=1024 W=640) stays in the 50 MB L2 across the
// ~9 passes after the first reads it, so K2 is K1's launch sequence with
// the row addressing swapped (`tt::GroupedRows`: each CTA looks up its
// rows' starts once, batch row b = packed row idx0[b/g] + b%g). No
// (B, W) gathered buffer exists. Bound: floating-point issue, as K1's.
// The reduction order is K1's (fixed-order partials, no atomics), so on
// the same rows K2 is bitwise equal to K1 and a seed reproduces a fit.
//
// The launch sequence is fused_solve.cuh's, instantiated here for
// `tt::GroupedRows` (its own source, so it builds beside K1 in parallel);
// its bf16 sequence is fused_step_dma_bf16.cu's.

#include "fused_solve.cuh"

// K2: batch row b is row idx0[b / group] + b % group of packed (L, W).
extern "C" int tt_fused_local_solve_dma(
    const int* idx0, const uint8_t* packed, long long L, int group,
    const float* up, const float* lamb_init, float* lamb_out, float* g,
    float* lam, float* mid, float* t, float* part, float* dpart, int* active,
    float* gpart, int B, int W, int K, int nsplit_w, int nsplit_b,
    int local_iters, float local_tol, float beta_a, float beta_b,
    int warm_start, int approx_div, int accel, cudaStream_t stream) {
  if (group <= 0 || B % group || L < group) return (int)cudaErrorInvalidValue;
  return fused_solve<tt::GroupedRows, false>(
      tt::GroupedRows{packed, idx0, group, L}, up, lamb_init, lamb_out, g,
      lam, mid, t, part, dpart, active, gpart, nullptr, nullptr, B, W, K,
      nsplit_w, nsplit_b, local_iters, local_tol, beta_a, beta_b, warm_start,
      approx_div, accel, stream);
}
