// K2 at compute dtype bf16: fused_local_solve_dma's bf16 bodies (T, U and
// R rounded to bf16 as the products' operands, sums in f32), for the
// reference's fused_local_solve_dma(dtype=jnp.bfloat16)
// (terastructure_tpu/ops/fused_step.py:493). The launch sequence is
// fused_solve.cuh's for `tt::GroupedRows`; arguments as
// tt_fused_local_solve_dma (fused_step_dma.cu), with after gpart the
// scratch of bf(u) and bf(t) (ub, tb: as tt_fused_local_solve_bf16's). On
// the same rows it is bitwise K1's bf16 sequence.

#include "fused_solve.cuh"

extern "C" int tt_fused_local_solve_dma_bf16(
    const int* idx0, const uint8_t* packed, long long L, int group,
    const float* up, const float* lamb_init, float* lamb_out, float* g,
    float* lam, float* mid, float* t, float* part, float* dpart, int* active,
    float* gpart, __nv_bfloat16* ub, __nv_bfloat16* tb, int B, int W, int K,
    int nsplit_w, int nsplit_b, int local_iters, float local_tol,
    float beta_a, float beta_b, int warm_start, int approx_div, int accel,
    cudaStream_t stream) {
  if (group <= 0 || B % group || L < group) return (int)cudaErrorInvalidValue;
  return fused_solve<tt::GroupedRows, true>(
      tt::GroupedRows{packed, idx0, group, L}, up, lamb_init, lamb_out, g,
      lam, mid, t, part, dpart, active, gpart, ub, tb, B, W, K, nsplit_w,
      nsplit_b, local_iters, local_tol, beta_a, beta_b, warm_start,
      approx_div, accel, stream);
}
