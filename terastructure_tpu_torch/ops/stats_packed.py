"""λ statistics straight from 2-bit packed rows (port of the parts of
terastructure_tpu/ops/stats_pallas.py on the main path).

Planar layout: byte w of a row holds individuals 4w..4w+3, and bit plane
s, `(byte >> 2s) & 3`, holds individuals {4w+s}. u is kept as
`u_planes (4, W, K)` with u_planes[s, w] = u[4w+s], so a kernel decodes a
byte with shifts and masks and reads u for the same (s, w).

`lambda_stats_packed` (kernel K4, csrc/stats_packed.cu) is one raw
λ-statistic pass; `local_solve_packed` drives it through the shared
solve schedule. On CPU tensors K4 runs its plain twin.
"""

from __future__ import annotations

import torch

from terastructure_tpu_torch import _build
from terastructure_tpu_torch.models.psd import elog_beta
from terastructure_tpu_torch.ops.stats_dense import solve_schedule

_EPS = 1e-30
KMAX = 64       # largest K the CUDA kernels are instantiated for


def u_to_planes(u: torch.Tensor) -> torch.Tensor:
    """(N, K) -> (4, W, K) planar layout; requires N % 4 == 0."""
    n, k = u.shape
    return u.reshape(n // 4, 4, k).permute(1, 0, 2).contiguous()


def planes_to_flat(g: torch.Tensor) -> torch.Tensor:
    """(4, W, K) -> (N, K), the inverse of u_to_planes."""
    _, w, k = g.shape
    return g.permute(1, 0, 2).reshape(4 * w, k)


def plane_counts(rows: torch.Tensor):
    """Packed rows (B, W) -> allele counts (A1, A0), each (B, 4W) f32 in
    planar column order s*W + w; MISSING (code 3) counts 0 for both."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=rows.device)
    x = (rows[:, None, :] >> shifts[:, None]) & 0x3           # (B, 4, W)
    x = x.reshape(rows.shape[0], -1)
    miss = x == 3
    xf = x.float()
    zero = torch.zeros((), device=rows.device)
    return torch.where(miss, zero, xf), torch.where(miss, zero, 2.0 - xf)


def ratios_planar(a1, a0, u_cat, t1, t0, approx_div=False):
    """R = A / (T U^T + eps) for both alleles, (B, 4W) each. approx_div
    multiplies by the reciprocal instead of dividing (the kernel's fast
    path differs from both by a few ulp)."""
    d1 = t1 @ u_cat.T + _EPS
    d0 = t0 @ u_cat.T + _EPS
    if approx_div:
        return a1 * torch.reciprocal(d1), a0 * torch.reciprocal(d0)
    return a1 / d1, a0 / d0


def lambda_stats_packed_twin(rows, u_planes, t1, t0, *, approx_div=False):
    """Plain PyTorch version of K4: raw (l0, l1) = (R1 U, R0 U)."""
    u_cat = u_planes.reshape(-1, u_planes.shape[-1])
    a1, a0 = plane_counts(rows)
    r1, r0 = ratios_planar(a1, a0, u_cat, t1, t0, approx_div)
    return r1 @ u_cat, r0 @ u_cat


def pad_individuals(u: torch.Tensor, w: int) -> torch.Tensor:
    """u (N, K) -> (4W, K), padding individuals with 1.0: their genotypes
    decode as MISSING, so they add nothing."""
    if u.shape[0] != 4 * w:
        u = torch.cat([u, u.new_ones((4 * w - u.shape[0], u.shape[1]))])
    return u


def check_shapes(name, rows, u_planes):
    """Validate the (B, W) rows and (4, W, K) u_planes of a kernel call."""
    if rows.dim() != 2 or u_planes.dim() != 3 or u_planes.shape[0] != 4:
        raise ValueError(f"{name}: rows (B, W), u_planes (4, W, K)")
    if u_planes.shape[1] != rows.shape[1]:
        raise ValueError(f"{name}: W mismatch {rows.shape} vs "
                         f"{tuple(u_planes.shape)}")
    if not 1 <= u_planes.shape[2] <= KMAX:
        raise ValueError(f"{name}: K must be in [1, {KMAX}]")


def grid_split(n_primary: int, max_split: int, target: int = 264) -> int:
    """How many ways to split a kernel's reduction axis so that about
    `target` CTAs (two per H100 SM) are in flight. A function of the
    shape only, so the summation order, and the result, never depend
    on anything else."""
    return max(1, min(max_split, -(-target // max(n_primary, 1))))


def lambda_stats_packed(rows: torch.Tensor, u_planes: torch.Tensor,
                        t1: torch.Tensor, t0: torch.Tensor, *,
                        approx_div: bool = False):
    """Raw λ statistics from packed rows.

    rows (B, W) uint8; u_planes (4, W, K) f32; t1, t0 (B, K) f32.
    Returns (l0_raw, l1_raw), each (B, K) f32; the caller multiplies by
    t1 / t0.
    """
    check_shapes("lambda_stats_packed", rows, u_planes)
    if rows.device.type == "cpu":
        lambda_stats_packed.twin_calls += 1
        return lambda_stats_packed_twin(rows, u_planes, t1, t0,
                                        approx_div=approx_div)
    if rows.device.type != "cuda":
        raise ValueError(f"lambda_stats_packed: unsupported device {rows.device}")
    _build.require_cuda("lambda_stats_packed", rows, u_planes, t1, t0,
                        dtypes=(torch.uint8,) + (torch.float32,) * 3)
    b, w = rows.shape
    k = u_planes.shape[2]
    if t1.shape != (b, k) or t0.shape != (b, k):
        raise ValueError("lambda_stats_packed: t1, t0 must be (B, K)")
    nsplit = grid_split(-(-b // 32), -(-w // 128))
    dev = rows.device
    l0 = torch.empty((b, k), dtype=torch.float32, device=dev)
    l1 = torch.empty_like(l0)
    part = torch.empty((nsplit, b, k, 2), dtype=torch.float32, device=dev)
    err = _build.lib().tt_lambda_stats_packed(
        rows.data_ptr(), u_planes.data_ptr(), t1.data_ptr(), t0.data_ptr(),
        l0.data_ptr(), l1.data_ptr(), part.data_ptr(), b, w, k, nsplit,
        int(approx_div), _build.stream_ptr(dev))
    _build.check(err, "lambda_stats_packed")
    lambda_stats_packed.launches += 1
    return l0, l1


lambda_stats_packed.launches = 0
lambda_stats_packed.twin_calls = 0


def local_solve_packed(rows, u, lamb_b, *, beta_a, beta_b, local_iters,
                       local_tol, stat_scale=1.0, approx_div=False,
                       accel=False):
    """Local coordinate ascent from packed rows on the shared schedule.

    u: (N, K) with N = 4 * W (caller pads); returns lamb_b (B, K, 2).
    stat_scale rescales the individual-summed statistics (N/Ns for a
    column subsample).
    """
    u_planes = u_to_planes(u)

    def iterate(lam):
        e1, e0 = elog_beta(lam)
        t1, t0 = torch.exp(e1), torch.exp(e0)
        l0, l1 = lambda_stats_packed(rows, u_planes, t1, t0,
                                     approx_div=approx_div)
        return torch.stack([beta_a + stat_scale * t1 * l0,
                            beta_b + stat_scale * t0 * l1], -1)

    return solve_schedule(iterate, lamb_b, local_iters=local_iters,
                          local_tol=local_tol, accel=accel)
