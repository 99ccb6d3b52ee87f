// The launch sequence of the fused local solve — the whole phi <-> lambda
// local solve of one SVI step, and the gamma statistic — shared by K1
// (fused_step.cu) and K2 (fused_step_dma.cu), which differ only in where
// the passes read the batch's rows (`Rows`, psd_common.cuh). Each entry
// lives in its own source so that nvcc builds the two in parallel.
//
// K1 replaces terastructure_tpu/ops/fused_step.py `fused_local_solve`
// (pallas_call at :459; body `_make_kernel.body_common` :223-365). On the
// TPU one program holds the minibatch in VMEM and loops in place. Here
// the rows are independent inside the solve, so each pass is one launch
// of `tt::lambda_pass_kernel` (psd_common.cuh; a lane per row, a warp per
// 32 rows and a chunk of columns), and only two things couple CTAs, both
// reduced in a fixed order:
//   - the batch-wide relative change that ends the tol-gated loop:
//     `update_kernel` writes per-CTA sums of |new - lam| and |lam|,
//     `delta_kernel` adds them in order and clears a device-side `active`
//     flag that later passes read (no host sync, no early return to the
//     host: the launch sequence is fixed by local_iters);
//   - the gamma statistic g = R^T T, a sum over all B rows:
//     `tt::gamma_pass_kernel` (psd_common.cuh, shared with K5) gives each
//     thread one individual and loops over a slice of rows in order;
//     `gamma_reduce_kernel` adds the slices in order. No atomics anywhere,
//     so a seed reproduces a fit bitwise.
//
// Launch sequence (same schedule as stats_dense.solve_schedule):
//   init                       lam = prior or lamb_init, t = T(lam)
//   loop_iters x [pass, update(LOOP), delta]
//   accel: pass, update(MID), pass, update(AITKEN)
//   pass (exact divide), update(FINAL) -> lamb_out
//   gamma_pass, gamma_reduce -> g
//
// Bound on the H100: at the TGP shape (B=4096, W=640, K=8) each pass is
// ~0.34 G FMA and ~21 M divides over 2.6 MB of rows that stay in L2, so
// the solve is bound by the FP32 rate, not by bytes; what it loses beyond
// that is latency and launches. The lambda pass (its design note is in
// psd_common.cuh) keeps t and the sums in registers, reads u from shared
// memory and overlaps neighbouring entries; `lambda_grid`
// (ops/stats_packed.py) splits the columns so that the card is full at
// B=1024 too. The partial sums of the column splits (nsplit_w of them, 40
// at B=1024) are added in split order by `update_kernel`. The loop and
// tail passes use the hardware reciprocal, bare with approx_div
// (tt::kDivFast) and with one Newton step without it (tt::kDivNewton,
// within 1 ulp); the final pass and the gamma pass always give the bits
// of the IEEE divide (tt::kDivExact). The f32 path stays outside the
// tensor cores (TF32 would change its numbers). K > 64 runs the λ pass of
// lambda_wide.cuh and the γ pass of gamma_wide.cuh through the same
// launchers.
//
// At compute dtype bf16 (kBf16, the reference's dtype=jnp.bfloat16) the
// passes take their bf16 bodies: T, U and R enter the products rounded to
// bf16 and the sums stay f32; the update beta + t * S, the tol test and
// Aitken use the unrounded f32 t and lambda (the update kernels below are
// the f32 path's). At K <= 64 the sequence rounds bf(u) once after init
// (`tt::round_u`: the tensor-core λ passes stage it) and the final update
// rounds the γ pass's bf(t) (`update_kernel<true>`), so the bodies of
// psd_mma.cuh copy and never convert. The bf16 sequences are instantiated
// in their own sources (fused_step_bf16.cu, fused_step_dma_bf16.cu), so
// that nvcc builds them beside the f32 ones in parallel.
//
// Batched replicates (svi/replicates.py; the reference vmaps this kernel,
// and Pallas lifts it by a grid dimension): `fused_solve` takes R
// independent solves, each with its own rows, u planes, lambda and
// scratch, R x the single solve's arrays back to back. Every kernel of the
// sequence runs replicate z in blockIdx.z (delta_kernel: a CTA a
// replicate) on the grid a single solve would use, and each replicate has
// its own `active[z]`: a replicate's tol loop ends on its own, as the
// reference's vmapped while_loop does, while the others run on. The
// launch sequence (and the host's enqueue) is paid once for all R. R = 1
// is the single solve.

#pragma once

#include "psd_common.cuh"

namespace {

enum UpdateMode { kLoop = 0, kMid = 1, kAitken = 2, kFinal = 3 };

constexpr int kUpd = 256;  // threads per update CTA (one per (b, k))

__device__ __forceinline__ float aitken(float prev, float cur, float nw) {
  // stats_dense.aitken_final with floor 1e-3, rmax 0.9
  const float d1 = nw - cur;
  const float d0 = cur - prev;
  const float den = d0 - d1;
  const bool ok = fabsf(den) > 1e-12f;
  float step = ok ? d1 * d1 / den : 0.f;
  const float cap = (float)(0.9 / (1.0 - 0.9)) * fabsf(d1);
  step = fminf(fmaxf(step, -cap), cap);
  return fmaxf(nw + step, 1e-3f);
}

// lam = warm ? lamb_init : (beta_a, beta_b); t = T(lam); active = 1.
// Replicate z = blockIdx.z: its (B, K, 2) arrays 2 bk floats apart.
__global__ void init_kernel(const float* __restrict__ lamb_init, int warm,
                            float beta_a, float beta_b, float* __restrict__ lam,
                            float* __restrict__ t, int* __restrict__ active,
                            int bk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const long long z = blockIdx.z, o = z * 2 * bk;
  if (i == 0) active[z] = 1;
  if (i >= bk) return;
  lamb_init += o;
  lam += o;
  t += o;
  const float l0 = warm ? lamb_init[2 * i] : beta_a;
  const float l1 = warm ? lamb_init[2 * i + 1] : beta_b;
  lam[2 * i] = l0;
  lam[2 * i + 1] = l1;
  tt::exp_elog_beta(l0, l1, t[2 * i], t[2 * i + 1]);
}

// new = prior + t * (sum over splits of part), then by mode:
//   LOOP   (if *active): per-CTA |new - lam| and |lam| sums; lam = new
//   MID:    mid = new
//   AITKEN: lam = aitken(lam, mid, new)
//   FINAL:  out = new
// and t = T(the lambda the next pass reads) for every mode but FINAL.
// kRoundT (the bf16 sequence at K <= 64): FINAL also rounds the t that
// the final pass read, the γ pass's, into tb (2, B, mma_kp(K)) bf16, the
// layout the γ pass stages (zero past K).
// Replicate z = blockIdx.z: its part nsplit x 2 bk floats on, its (B, K,
// 2) arrays 2 bk, its dpart 2 gridDim.x, its tb 2 B mma_kp(K), its flag
// active[z].
template <bool kRoundT>
__global__ void __launch_bounds__(kUpd)
update_kernel(int mode, const float* __restrict__ part, int nsplit, int bk,
              float beta_a, float beta_b, float* __restrict__ lam,
              float* __restrict__ mid, float* __restrict__ t,
              float* __restrict__ out, float* __restrict__ dpart,
              const int* __restrict__ active, int K,
              __nv_bfloat16* __restrict__ tb) {
  const long long z = blockIdx.z, o = z * 2 * bk;
  if (mode == kLoop && active[z] == 0) return;
  part += o * nsplit;
  lam += o;
  mid += o;
  t += o;
  out += o;
  dpart += z * 2 * gridDim.x;
  __shared__ float sdiff[kUpd], smag[kUpd];
  const int i = blockIdx.x * kUpd + threadIdx.x;
  float diff = 0.f, mag = 0.f;
  if (i < bk) {
    float s0 = 0.f, s1 = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      s0 += part[((long long)s * bk + i) * 2];
      s1 += part[((long long)s * bk + i) * 2 + 1];
    }
    const float n0 = beta_a + t[2 * i] * s0;
    const float n1 = beta_b + t[2 * i + 1] * s1;
    float l0 = n0, l1 = n1;  // the lambda the next pass reads
    if (mode == kLoop) {
      const float p0 = lam[2 * i], p1 = lam[2 * i + 1];
      diff = fabsf(n0 - p0) + fabsf(n1 - p1);
      mag = fabsf(p0) + fabsf(p1);
      lam[2 * i] = n0;
      lam[2 * i + 1] = n1;
    } else if (mode == kMid) {
      mid[2 * i] = n0;
      mid[2 * i + 1] = n1;
    } else if (mode == kAitken) {
      l0 = aitken(lam[2 * i], mid[2 * i], n0);
      l1 = aitken(lam[2 * i + 1], mid[2 * i + 1], n1);
      lam[2 * i] = l0;
      lam[2 * i + 1] = l1;
    } else {
      out[2 * i] = n0;
      out[2 * i + 1] = n1;
      if constexpr (kRoundT) {
        if (tb != nullptr) {
          const int kp = tt::mma_kp(K), b = i / K, k = i - b * K;
          const long long nb = (long long)(bk / K) * kp;
          __nv_bfloat16* t1b = tb + z * 2 * nb + (long long)b * kp;
          __nv_bfloat16* t0b = t1b + nb;
          t1b[k] = __float2bfloat16_rn(t[2 * i]);
          t0b[k] = __float2bfloat16_rn(t[2 * i + 1]);
          for (int j = K; k == K - 1 && j < kp; ++j)
            t1b[j] = t0b[j] = __float2bfloat16_rn(0.f);
        }
      }
    }
    if (mode != kFinal) tt::exp_elog_beta(l0, l1, t[2 * i], t[2 * i + 1]);
  }
  if (mode != kLoop) return;
  sdiff[threadIdx.x] = diff;
  smag[threadIdx.x] = mag;
  for (int h = kUpd / 2; h > 0; h >>= 1) {  // fixed-shape tree
    __syncthreads();
    if (threadIdx.x < h) {
      sdiff[threadIdx.x] += sdiff[threadIdx.x + h];
      smag[threadIdx.x] += smag[threadIdx.x + h];
    }
  }
  if (threadIdx.x == 0) {
    dpart[2 * blockIdx.x] = sdiff[0];
    dpart[2 * blockIdx.x + 1] = smag[0];
  }
}

// delta = mean|new - lam| / (mean|lam| + 1); active &= delta > tol.
// A CTA a replicate: replicate blockIdx.x's nblk partials and its flag.
__global__ void __launch_bounds__(kUpd)
delta_kernel(const float* __restrict__ dpart, int nblk, int bk, float tol,
             int* __restrict__ active) {
  active += blockIdx.x;
  if (*active == 0) return;
  dpart += 2LL * nblk * blockIdx.x;
  __shared__ float sdiff[kUpd], smag[kUpd];
  float diff = 0.f, mag = 0.f;
  for (int j = threadIdx.x; j < nblk; j += kUpd) {
    diff += dpart[2 * j];
    mag += dpart[2 * j + 1];
  }
  sdiff[threadIdx.x] = diff;
  smag[threadIdx.x] = mag;
  for (int h = kUpd / 2; h > 0; h >>= 1) {
    __syncthreads();
    if (threadIdx.x < h) {
      sdiff[threadIdx.x] += sdiff[threadIdx.x + h];
      smag[threadIdx.x] += smag[threadIdx.x + h];
    }
  }
  if (threadIdx.x == 0) {
    const float n = 2.f * (float)bk;
    const float delta = (sdiff[0] / n) / (smag[0] / n + 1.f);
    if (!(delta > tol)) *active = 0;  // NaN ends the loop, as in the reference
  }
}

// The launch sequence of K1 and K2: they differ only in where the passes
// read the batch's rows (`Rows`, psd_common.cuh). kBf16: the bf16 bodies;
// at K <= 64 ub R x (4W, mma_kp(K)) and tb R x (2, B, mma_kp(K)) bf16
// take bf(u), rounded once before the loop (`round_u`, one launch) and
// read by every λ pass, and bf(t) of the γ pass, rounded by the final
// update (null at f32 and at K > 64).
// R replicates (K1 only; K2 has R = 1): rows R x (B, W), up R x (4, W,
// K), lamb_init, lamb_out, lam, mid, t R x (B, K, 2), g R x (4, W, K),
// part R x (nsplit_w, B, K, 2), dpart R x (nupd, 2), active (R,), gpart
// R x (nsplit_b, 4W, K), each replicate's block after the last.
template <class Rows, bool kBf16>
int fused_solve(Rows src, const float* up, const float* lamb_init,
                float* lamb_out, float* g, float* lam, float* mid, float* t,
                float* part, float* dpart, int* active, float* gpart,
                __nv_bfloat16* ub, __nv_bfloat16* tb, int B, int W, int K,
                int nsplit_w, int nsplit_b, int local_iters, float local_tol,
                float beta_a, float beta_b, int warm_start, int approx_div,
                int accel, cudaStream_t stream, int R = 1) {
  const bool narrow = kBf16 && K <= 64;
  if (B <= 0 || W <= 0 || nsplit_w <= 0 || nsplit_b <= 0 || R < 1 ||
      tt::pick_km(K) < 0 || local_iters < 0 ||
      (narrow && (ub == nullptr || tb == nullptr)))
    return (int)cudaErrorInvalidValue;
  const bool acc = accel && local_iters >= 3;
  const int loop_iters = acc ? local_iters - 2 : local_iters;
  const int bk = B * K;
  const int nupd = (bk + kUpd - 1) / kUpd;
  const tt::PackedLoader<Rows> loader{src};
  const long long wk = 4LL * W * K;
  tt::Rep lrep, grep;                   // replicate strides of the passes
  lrep.rows = grep.rows = (long long)B * W;
  lrep.u = grep.u = wk;
  lrep.t = grep.t = 2LL * bk;
  lrep.part = 2LL * nsplit_w * bk;
  grep.part = nsplit_b * wk;
  grep.out = wk;

  // the loop and tail passes' divide; the final pass divides exactly
  const int loop_div = approx_div ? tt::kDivFast : tt::kDivNewton;

  auto pass = [&](int div, const int* gate) -> int {
    return tt::launch_lambda_pass<tt::PackedLoader<Rows>, true, kBf16>(
        loader, up, ub, t, t + 1, 2 * K, 2, part, B, W, K, nsplit_w, div,
        gate, stream, R, lrep);
  };
  const dim3 ugrid(nupd, 1, R);
  auto update = [&](int mode) -> int {
    update_kernel<kBf16><<<ugrid, kUpd, 0, stream>>>(
        mode, part, nsplit_w, bk, beta_a, beta_b, lam, mid, t, lamb_out,
        dpart, active, K, narrow ? tb : nullptr);
    TT_CHECK_LAUNCH();
    return 0;
  };
  int err;

  init_kernel<<<ugrid, kUpd, 0, stream>>>(lamb_init, warm_start, beta_a,
                                          beta_b, lam, t, active, bk);
  TT_CHECK_LAUNCH();
  if (narrow)
    if ((err = tt::round_u(up, ub, W, K, R, stream))) return err;
  for (int it = 0; it < loop_iters; ++it) {
    if ((err = pass(loop_div, active))) return err;
    if ((err = update(kLoop))) return err;
    delta_kernel<<<R, kUpd, 0, stream>>>(dpart, nupd, bk, local_tol, active);
    TT_CHECK_LAUNCH();
  }
  if (acc) {
    if ((err = pass(loop_div, nullptr))) return err;
    if ((err = update(kMid))) return err;
    if ((err = pass(loop_div, nullptr))) return err;
    if ((err = update(kAitken))) return err;
  }
  if ((err = pass(tt::kDivExact, nullptr))) return err;
  if ((err = update(kFinal))) return err;

  return tt::launch_gamma_stats<Rows, kBf16>(src, up, t, t + 1, 2 * K, 2,
                                             tb, gpart, g, B, W, K, nsplit_b,
                                             stream, R, grep);
}

}  // namespace
