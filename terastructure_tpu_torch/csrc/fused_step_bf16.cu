// K1 at compute dtype bf16: fused_local_solve's bf16 bodies (T, U and R
// rounded to bf16 as the products' operands, sums in f32), for the
// reference's fused_local_solve(dtype=jnp.bfloat16)
// (terastructure_tpu/ops/fused_step.py:423; casts :270-277, :291-296).
// The launch sequence is fused_solve.cuh's; arguments as
// tt_fused_local_solve (fused_step.cu), with after gpart the scratch of
// bf(u) and bf(t), ub R x (4W, mma_kp(K)) and tb R x (2, B, mma_kp(K))
// bf16 (K <= 64; null above). Its own source, so that nvcc builds it
// beside the f32 one in parallel.

#include "fused_solve.cuh"

extern "C" int tt_fused_local_solve_bf16(
    int R, const uint8_t* rows, const float* up, const float* lamb_init,
    float* lamb_out, float* g, float* lam, float* mid, float* t, float* part,
    float* dpart, int* active, float* gpart, __nv_bfloat16* ub,
    __nv_bfloat16* tb, int B, int W, int K, int nsplit_w, int nsplit_b,
    int local_iters, float local_tol, float beta_a, float beta_b,
    int warm_start, int approx_div, int accel, cudaStream_t stream) {
  return fused_solve<tt::ContiguousRows, true>(
      tt::ContiguousRows{rows}, up, lamb_init, lamb_out, g, lam, mid, t,
      part, dpart, active, gpart, ub, tb, B, W, K, nsplit_w, nsplit_b,
      local_iters, local_tol, beta_a, beta_b, warm_start, approx_div, accel,
      stream, R);
}
