"""Dense sufficient statistics for PSD SVI in torch (port of
terastructure_tpu/ops/stats_dense.py).

phi for (i, j) depends only on the genotype and exp-expected-log factors:

  u_ik  = exp E[log theta_ik]            (N, K)
  t1_jk = exp E[log beta_kj]             (B, K)   t0 likewise for 1-beta
  D1 = T1 U^T, D0 = T0 U^T               (B, N)
  R1 = A1 / D1, R0 = A0 / D0             allele counts over denominators
  lambda stats: L0 = t1 * (R1 U),  L1 = t0 * (R0 U)
  gamma stats:  S  = u * (R1^T T1 + R0^T T0)

This is the plain math; the kernels in ops/fused_step.py and
ops/stats_packed.py compute the same from 2-bit packed rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from terastructure_tpu_torch.models.psd import MISSING, elog_beta, elog_dirichlet

_EPS = 1e-30


class BatchStats(NamedTuple):
    gamma_stat: torch.Tensor   # (N, K)
    lam0_stat: torch.Tensor    # (B, K) allele-1 counts
    lam1_stat: torch.Tensor    # (B, K) allele-0 counts


def exp_elog_theta(gamma):
    """u = exp E[log theta] (N, K)."""
    return torch.exp(elog_dirichlet(gamma))


def exp_elog_beta(lamb_b):
    """(t1, t0) = exp E[log beta], exp E[log(1-beta)], each (B, K)."""
    e1, e0 = elog_beta(lamb_b)
    return torch.exp(e1), torch.exp(e0)


def allele_counts(xb, dtype=torch.float32):
    """Genotypes (B, N) int8 -> masked allele-count matrices (A1, A0)."""
    mask = xb != MISSING
    xf = xb.to(dtype)
    zero = torch.zeros((), dtype=dtype, device=xb.device)
    return torch.where(mask, xf, zero), torch.where(mask, 2.0 - xf, zero)


def as_operand(x, dtype):
    """x as a product operand of the compute dtype, held in f32: rounded
    to bf16 (to nearest even) and back where dtype is bf16, x itself at
    float32. The product of two bf16 values is exact in f32, so an f32
    product of such operands is the reference's bf16 x bf16 product with
    f32 sums (preferred_element_type=float32), up to the sums' order."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _ratios(a1, a0, u, t1, t0, dtype):
    """R1, R0 (B, N): allele counts over mixture denominators, rounded to
    the compute dtype (held in f32); the divide is f32."""
    ud = as_operand(u, dtype)
    d1 = as_operand(t1, dtype) @ ud.T
    d0 = as_operand(t0, dtype) @ ud.T
    r1 = as_operand(a1.float() / (d1 + _EPS), dtype)
    r0 = as_operand(a0.float() / (d0 + _EPS), dtype)
    return r1, r0


def _reduced(l0, l1, ind_reduce):
    return (l0, l1) if ind_reduce is None else ind_reduce(l0, l1)


def lambda_stats(a1, a0, u, t1, t0, dtype=torch.float32, ind_reduce=None):
    """One coordinate-ascent lambda statistic: (L0, L1), each (B, K).

    ind_reduce: None, or (l0, l1) -> (l0, l1) applied to the individual
    sums before they are scaled by t (the sharded step's all-reduce over
    the ranks that hold the other individuals)."""
    r1, r0 = _ratios(a1, a0, u, t1, t0, dtype)
    ud = as_operand(u, dtype)
    l0, l1 = _reduced(r1 @ ud, r0 @ ud, ind_reduce)
    return t1 * l0, t0 * l1


def batch_stats(a1, a0, u, t1, t0, dtype=torch.float32,
                ind_reduce=None) -> BatchStats:
    """All sufficient statistics for a converged local solution. The
    gamma statistic is this shard's partial (sharded: its SNPs only);
    ind_reduce as `lambda_stats`'."""
    r1, r0 = _ratios(a1, a0, u, t1, t0, dtype)
    ud = as_operand(u, dtype)
    l0, l1 = _reduced(r1 @ ud, r0 @ ud, ind_reduce)
    l0 = t1 * l0
    l1 = t0 * l1
    s = u * (r1.T @ as_operand(t1, dtype) + r0.T @ as_operand(t0, dtype))
    return BatchStats(gamma_stat=s, lam0_stat=l0, lam1_stat=l1)


def aitken_final(prev, cur, new, floor=1e-3, rmax=0.9):
    """One per-coordinate Aitken delta^2 extrapolation of the lambda fixed
    point from three consecutive iterates, with the implied contraction
    ratio clamped at rmax and the result floored (see the reference for
    the measurements behind both guards)."""
    d1 = new - cur
    d0 = cur - prev
    den = d0 - d1
    ok = den.abs() > 1e-12
    step = torch.where(ok, d1 * d1 / torch.where(ok, den, 1.0), 0.0)
    cap = (rmax / (1.0 - rmax)) * d1.abs()
    step = torch.minimum(torch.maximum(step, -cap), cap)
    return torch.clamp_min(new + step, floor)


def pad_share(pad_rows, k, prior, first):
    """What `pad_rows` all-MISSING rows add to the two sums of the tol
    test, (sum |new - lam|, sum |lam|), over their K x 2 entries. Their
    lambda starts at 1.0 (the reference pads lambda with 1.0) and every
    pass moves it to the prior (beta_a, beta_b): their statistics are 0."""
    beta_a, beta_b = prior
    if first:
        return (pad_rows * k * (abs(beta_a - 1.0) + abs(beta_b - 1.0)),
                pad_rows * k * 2.0)
    return 0.0, pad_rows * k * (abs(beta_a) + abs(beta_b))


def _tol_delta(new, lam, pad_rows, prior, first):
    """The tol test's mean relative lambda change of one solve (B, K, 2),
    with the reference's pad rows' share where it pads the batch."""
    if pad_rows:
        n = lam.numel() + pad_rows * lam.shape[1] * 2
        pd, pm = pad_share(pad_rows, lam.shape[1], prior, first=first)
        return (((new - lam).abs().sum() + pd) / n
                / (((lam.abs().sum() + pm) / n) + 1.0))
    return (new - lam).abs().mean() / (lam.abs().mean() + 1.0)


def solve_schedule(iterate, lamb0, *, local_iters, local_tol, accel,
                   pad_rows=0, prior=(1.0, 1.0), passes=None):
    """The local-solve schedule shared by every coordinate-ascent path.

    plain: up to `local_iters` passes, stopping after the first pass whose
    mean relative lambda change is not above local_tol.
    accel (needs local_iters >= 3): that loop capped at local_iters-2
    passes, then two passes that always run and one clamped Aitken
    extrapolation.

    The tol-gated while loop of the reference becomes device-side
    masking: every pass runs and `lam = where(active, new, lam)` keeps the
    result of the last pass the loop would have taken. The result is
    identical and the host never reads a device value.

    pad_rows: all-MISSING rows the reference would have padded the batch
    with (the big-N step at B % 8 != 0). They are not made: their known
    share (`pad_share`, with prior = (beta_a, beta_b)) enters both means
    of the tol test, which then run over B + pad_rows rows as the
    reference's do.

    passes: None, or a list to which the solve appends the number of
    loop passes the reference's while_loop would run: 1 + the passes
    after the first that `active` lets through, a scalar on the solve's
    device (the host reads no device value here); R solves append R
    counts, one a replicate.

    lamb0 (R, B, K, 2) is R independent solves (batched replicates: the
    reference's while_loop under vmap). Each replicate has its own tol
    test and `active`, and its means are taken on its own slice as a
    single solve takes them, so each replicate's result is bitwise the
    single solve's.
    """
    accel = accel and local_iters >= 3
    loop_iters = local_iters - 2 if accel else local_iters
    lam = lamb0
    replicates = lam.dim() == 4
    shape = (lam.shape[0], 1, 1, 1) if replicates else ()
    active = torch.ones(shape, dtype=torch.bool, device=lamb0.device)
    ran = []
    for i in range(loop_iters):
        if i and passes is not None:
            ran.append(active)
        new = iterate(lam)
        if replicates:
            delta = torch.stack([
                _tol_delta(nr, lr, pad_rows, prior, i == 0)
                for nr, lr in zip(new, lam)]).view(shape)
        else:
            delta = _tol_delta(new, lam, pad_rows, prior, i == 0)
        lam = torch.where(active, new, lam)
        active = active & (delta > local_tol)
    if passes is not None:
        count = 1 + sum(ran)
        if not replicates:
            passes.append(count)
        elif ran:
            passes.extend(count.view(-1))
        else:
            passes.extend([count] * lam.shape[0])
    if accel:
        mid = iterate(lam)
        new = iterate(mid)
        lam = aitken_final(lam, mid, new)
    return lam


def local_solve(a1, a0, u, lamb_b, *, beta_a, beta_b, local_iters,
                local_tol, dtype=torch.float32, accel=False, ind_reduce=None):
    """Local coordinate ascent phi <-> lambda for the minibatch SNPs on
    `solve_schedule`. Returns the converged lamb_b (B, K, 2). ind_reduce
    as `lambda_stats`'."""

    def iterate(lam):
        t1, t0 = exp_elog_beta(lam)
        l0, l1 = lambda_stats(a1, a0, u, t1, t0, dtype, ind_reduce)
        return torch.stack([beta_a + l0, beta_b + l1], -1)

    return solve_schedule(iterate, lamb_b, local_iters=local_iters,
                          local_tol=local_tol, accel=accel)
