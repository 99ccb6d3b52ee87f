// K1: fused_local_solve — the fused local solve on a gathered (B, W)
// matrix of rows. The launch sequence and its design note are in
// fused_solve.cuh. This source holds the f32 sequence; fused_step_bf16.cu
// the bf16 one (tt_fused_local_solve_bf16, same arguments).

#include "fused_solve.cuh"

// R: the replicates of a batched call (svi/replicates.py), each array R
// of the single solve's back to back (fused_solve.cuh); R = 1 is one solve.
extern "C" int tt_fused_local_solve(
    int R, const uint8_t* rows, const float* up, const float* lamb_init,
    float* lamb_out, float* g, float* lam, float* mid, float* t, float* part,
    float* dpart, int* active, float* gpart, int B, int W, int K,
    int nsplit_w, int nsplit_b, int local_iters, float local_tol,
    float beta_a, float beta_b, int warm_start, int approx_div, int accel,
    cudaStream_t stream) {
  return fused_solve<tt::ContiguousRows, false>(
      tt::ContiguousRows{rows}, up, lamb_init, lamb_out, g, lam, mid, t,
      part, dpart, active, gpart, nullptr, nullptr, B, W, K, nsplit_w,
      nsplit_b, local_iters, local_tol, beta_a, beta_b, warm_start,
      approx_div, accel, stream, R);
}
