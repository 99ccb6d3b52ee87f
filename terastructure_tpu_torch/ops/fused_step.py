"""The fused SVI local solve — kernels K1 and K2 (port of
terastructure_tpu/ops/fused_step.py, `fused_local_solve` and
`fused_local_solve_dma`).

One call runs the whole phi <-> lambda coordinate ascent for a minibatch
of packed rows and emits the converged lambda_B plus the planar gamma
statistic. K1 takes the gathered rows (B, W); K2 takes the packed matrix
(L, W) and the starts of B/g groups of g consecutive rows, and its passes
read the rows there (no gathered copy). CUDA: csrc/fused_step.cu (K1)
and csrc/fused_step_dma.cu (K2), one launch sequence in
csrc/fused_solve.cuh (fixed, on the current stream, no host sync). CPU:
`fused_local_solve_twin` and `fused_local_solve_dma_twin`, the same
schedule in plain PyTorch.

Schedule (identical to stats_dense.solve_schedule): cold start at the
Beta prior (or warm start from lamb_init); a tol-gated loop of passes
t = exp(psi(lam) - psi(lam0 + lam1)), D = [T1; T0] U^T,
R = A / (D + 1e-30), lam <- prior + t * (R U); with accel the loop stops
at local_iters - 2 passes and two tail passes plus one clamped Aitken
step follow; then one exact pass emits lambda and g = R^T T.

dtype=torch.bfloat16 (compute_dtype "bfloat16") runs the bf16 sequences
(csrc/fused_step_bf16.cu, csrc/fused_step_dma_bf16.cu): T, U and R enter
the three products rounded to bf16 and the sums stay f32, as in the
reference's bf16 kernel; everything outside the products (the update
with the unrounded t, the tol test, Aitken) is the f32 path's.

Batched replicates (svi/replicates.py): K1 takes a leading replicate
axis, R solves in one launch sequence (`tt_fused_local_solve` with R),
each with its own tol exit, as the reference's vmapped kernel has; the
twin of a batched call is the twin of each replicate, stacked.
"""

from __future__ import annotations

import torch

from terastructure_tpu_torch import _build
from terastructure_tpu_torch.ops.stats_dense import as_operand, solve_schedule
from terastructure_tpu_torch.ops.stats_packed import (
    c_ptr, check_dtype, check_shapes, count_launch, gamma_grid, lambda_grid,
    plane_counts, ratios_planar, rounded_scratch)


def digamma(x: torch.Tensor) -> torch.Tensor:
    """The kernel's digamma for x > 0 (fused_step.py:43-66 of the
    reference, and `tt::digamma` in csrc/psd_common.cuh): six conditional
    recurrence shifts to x >= 6, then the asymptotic series. Holds to
    ~1e-6 down to the 1e-3 lambda floor that aitken_final enforces."""
    acc = torch.zeros_like(x)
    for _ in range(6):
        small = x < 6.0
        acc = acc - torch.where(small, 1.0 / x, 0.0)
        x = torch.where(small, x + 1.0, x)
    inv = 1.0 / x
    inv2 = inv * inv
    series = (torch.log(x) - 0.5 * inv
              - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0)))
    return acc + series


def exp_elog_beta_kernel(lam: torch.Tensor):
    """(t1, t0) from (B, K, 2) Beta params with the kernel's digamma."""
    lam0, lam1 = lam[..., 0], lam[..., 1]
    tot = digamma(lam0 + lam1)
    return torch.exp(digamma(lam0) - tot), torch.exp(digamma(lam1) - tot)


# --- the reference's shape gate ------------------------------------------
# Whether a step takes the fused solve or the big-N per-iteration path
# changes the algorithm (the big-N path subsamples individuals), so the
# port reproduces the reference's decision exactly: the arithmetic of
# fused_step.supports / pick_config / kernel_vmem_bytes, constants
# included. The H100 kernel has no such budget; nothing else reads these.
_ROWS_BUDGET = 4 * 1024 * 1024
_SAFE_BYTES = 112 * 1024 * 1024
_KPAD_UNITS = 11


def _reference_footprint(b, w, k, *, tw, pre, itemsize, accel):
    kp = 128 * ((k + 127) // 128)
    e = (2 * b) * (4 * tw)
    total = b * w
    if pre:
        sb = 2 if pre == "bf16" else 1
        total += (2 * b) * (4 * w) * sb
        total += e * (4 + itemsize)
        total += e * (4 + sb)
    else:
        total += e * (4 + 2 * itemsize)
    total += (_KPAD_UNITS + (2 if accel else 0)) * b * kp * 4
    total += 2 * 4 * w * kp * 4
    return total


def _reference_config_fits(b, w, k, itemsize, accel):
    for pre in ("bf16", "i8", False):
        for tw in (512, 256, 128):
            if w % tw or (accel and b >= 4096 and w == tw):
                continue
            if _reference_footprint(b, w, k, tw=tw, pre=pre,
                                    itemsize=itemsize,
                                    accel=accel) <= _SAFE_BYTES:
                return True
    return False


def supports(b: int, w: int, k: int = 8, dtype=torch.float32,
             accel: bool = False) -> bool:
    """The reference's fused-path gate (fused_step.supports): True exactly
    where the reference engine runs the fused solve at this shape."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (b * w <= _ROWS_BUDGET and w % 128 == 0 and b % 8 == 0
            and _reference_config_fits(b, w, k, itemsize, accel))


# --- the plain twin --------------------------------------------------------
def fused_local_solve_twin(rows, u_planes, lamb_init, *, local_iters,
                           local_tol, beta_a, beta_b, dtype=torch.float32,
                           warm_start=False, approx_div=False, accel=False):
    """Plain PyTorch version of K1, same signature and layouts. At bf16
    the products take T, U and R rounded to bf16 and sum in f32; the
    update beta + t * S uses the unrounded t (the reference's
    fused_step.py:270-277, :335-336)."""
    b = rows.shape[0]
    k = u_planes.shape[-1]
    u_cat = u_planes.reshape(-1, k)                          # (4W, K)
    a1, a0 = plane_counts(rows)
    if warm_start:
        lam = lamb_init.float()
    else:
        lam = torch.stack(
            [torch.full((b, k), beta_a, device=rows.device),
             torch.full((b, k), beta_b, device=rows.device)], -1)

    u_op = as_operand(u_cat, dtype)

    def one_pass(lam, approx):
        t1, t0 = exp_elog_beta_kernel(lam)
        r1, r0 = ratios_planar(a1, a0, u_cat, t1, t0, approx, dtype)
        new = torch.stack([beta_a + t1 * (r1 @ u_op),
                           beta_b + t0 * (r0 @ u_op)], -1)
        return new, t1, t0, r1, r0

    lam = solve_schedule(lambda x: one_pass(x, approx_div)[0], lam,
                         local_iters=local_iters, local_tol=local_tol,
                         accel=accel)
    new, t1, t0, r1, r0 = one_pass(lam, False)
    g = r1.T @ as_operand(t1, dtype) + r0.T @ as_operand(t0, dtype)
    return new, g.reshape(u_planes.shape)                    # g (4W, K)


def fused_local_solve_dma_twin(idx0, packed, u_planes, lamb_init, *, group,
                               **kw):
    """Plain PyTorch version of K2: gather the groups, then K1's twin."""
    l, w = packed.shape
    b = idx0.shape[0] * group
    rows = packed.view(l // group, group * w)[idx0.long() // group]
    return fused_local_solve_twin(rows.view(b, w), u_planes, lamb_init, **kw)


# --- the wrappers ------------------------------------------------------------
def _check_solve_args(name, rows, u_planes, lamb_init, b, dtype):
    """Validate a fused solve's rows ((B, W), or K2's packed (L, W)),
    u_planes, lamb_init for a batch of b rows, and its compute dtype."""
    check_shapes(name, rows, u_planes)
    check_dtype(name, dtype)
    k = u_planes.shape[2]
    if lamb_init.shape != (b, k, 2):
        raise ValueError(f"{name}: lamb_init must be (B, K, 2)")


def _launch_solve(entry, lead_args, u_planes, lamb_init, b, w, *, local_iters,
                  local_tol, beta_a, beta_b, dtype, warm_start, approx_div,
                  accel, r=None):
    """Allocate the solve's outputs and scratch and call the C entry
    `entry` (tt_fused_local_solve or tt_fused_local_solve_dma; with the
    suffix _bf16 where dtype is bf16, the same arguments) with `lead_args`
    (K1's R and rows, K2's row arguments) first. r:
    the replicates of a batched call (every array gets the leading axis;
    each replicate's grid is the single solve's), None for one solve.
    Returns (lamb_out, g)."""
    dev = u_planes.device
    k = u_planes.shape[-1]
    nsplit_w, _ = lambda_grid(b, w, k, dtype)
    nsplit_b = gamma_grid(b, w, k, dtype)
    nupd = -(-b * k // 256)
    lead = () if r is None else (r,)

    def f32(*shape):
        return torch.empty((*lead, *shape), dtype=torch.float32, device=dev)

    lamb_out, g = f32(b, k, 2), f32(4, w, k)
    lam, mid, t = f32(b, k, 2), f32(b, k, 2), f32(b, k, 2)
    part, dpart = f32(nsplit_w, b, k, 2), f32(nupd, 2)
    gpart = f32(nsplit_b, 4 * w, k)
    active = torch.empty(lead or 1, dtype=torch.int32, device=dev)
    scratch = ()
    if dtype == torch.bfloat16:        # bf(u) and bf(t) at K <= 64
        entry += "_bf16"
        scratch = (c_ptr(rounded_scratch(lead, 4 * w, k, dev, dtype)),
                   c_ptr(rounded_scratch(lead, 2 * b, k, dev, dtype)))
    err = getattr(_build.lib(), entry)(
        *lead_args, u_planes.data_ptr(), lamb_init.data_ptr(),
        lamb_out.data_ptr(), g.data_ptr(), lam.data_ptr(), mid.data_ptr(),
        t.data_ptr(), part.data_ptr(), dpart.data_ptr(), active.data_ptr(),
        gpart.data_ptr(), *scratch, b, w, k, nsplit_w, nsplit_b, local_iters,
        float(local_tol), float(beta_a), float(beta_b), int(warm_start),
        int(approx_div), int(accel), _build.stream_ptr(dev))
    _build.check(err, entry)
    return lamb_out, g


def fused_local_solve(rows: torch.Tensor, u_planes: torch.Tensor,
                      lamb_init: torch.Tensor, *, local_iters: int,
                      local_tol: float, beta_a: float, beta_b: float,
                      dtype=torch.float32, warm_start: bool = False,
                      approx_div: bool = False, accel: bool = False):
    """Run the fused local solve (K1).

    rows: (B, W) uint8 gathered minibatch rows (any W; bytes 0xFF decode as
    MISSING). u_planes: (4, W, K) f32. lamb_init: (B, K, 2) f32, read iff
    warm_start. approx_div speeds up the divides of the loop and tail
    passes; the final pass always divides exactly. dtype: the products'
    operand type, float32 or bfloat16 (T, U and R rounded to bf16, sums
    and everything outside the products in f32; counted in
    `bf16_launches`). Returns (new_lamb_b (B, K, 2) f32, g_planes
    (4, W, K) f32).

    Batched replicates: rows (R, B, W), u_planes (R, 4, W, K), lamb_init
    (R, B, K, 2) run R solves in one launch sequence (counted in
    `rep_launches` as well), each with its own tol exit; returns
    (R, B, K, 2) and (R, 4, W, K), replicate r bitwise the single solve's
    on its inputs, at any K (K > 64: the wide passes with the axis).
    """
    name = "fused_local_solve"
    r = _check_replicates(name, rows, u_planes, lamb_init)
    _check_solve_args(name, rows if r is None else rows[0],
                      u_planes if r is None else u_planes[0],
                      lamb_init if r is None else lamb_init[0],
                      rows.shape[-2], dtype)
    kw = dict(local_iters=local_iters, local_tol=local_tol, beta_a=beta_a,
              beta_b=beta_b, dtype=dtype, warm_start=warm_start,
              approx_div=approx_div, accel=accel)
    if rows.device.type == "cpu":
        fused_local_solve.twin_calls += 1
        if r is None:
            return fused_local_solve_twin(rows, u_planes, lamb_init, **kw)
        outs = [fused_local_solve_twin(rows[i], u_planes[i], lamb_init[i],
                                       **kw) for i in range(r)]
        return tuple(torch.stack(x) for x in zip(*outs))
    if rows.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {rows.device}")
    _build.require_cuda(name, rows, u_planes, lamb_init,
                        dtypes=(torch.uint8, torch.float32, torch.float32))
    out = _launch_solve("tt_fused_local_solve", (r or 1, rows.data_ptr()),
                        u_planes, lamb_init, *rows.shape[-2:], r=r, **kw)
    count_launch(fused_local_solve, dtype)
    if r is not None:
        fused_local_solve.rep_launches += 1
    return out


def _check_replicates(name, rows, u_planes, lamb_init):
    """A batched call's replicate count R (rows (R, B, W), u_planes (R, 4,
    W, K), lamb_init (R, B, K, 2)), None for a single call (rows (B,
    W))."""
    if rows.dim() != 3:
        return None
    r = rows.shape[0]
    if u_planes.dim() != 4 or lamb_init.dim() != 4:
        raise ValueError(f"{name}: rows (R, B, W), u_planes (R, 4, W, K), "
                         "lamb_init (R, B, K, 2)")
    if u_planes.shape[0] != r or lamb_init.shape[0] != r:
        raise ValueError(f"{name}: {r} replicates of rows, "
                         f"{u_planes.shape[0]} of u_planes, "
                         f"{lamb_init.shape[0]} of lamb_init")
    return r


fused_local_solve.launches = 0
fused_local_solve.bf16_launches = 0
fused_local_solve.rep_launches = 0
fused_local_solve.twin_calls = 0


def fused_local_solve_dma(idx0: torch.Tensor, packed: torch.Tensor,
                          u_planes: torch.Tensor, lamb_init: torch.Tensor, *,
                          group: int, local_iters: int, local_tol: float,
                          beta_a: float, beta_b: float, dtype=torch.float32,
                          warm_start: bool = False, approx_div: bool = False,
                          accel: bool = False):
    """Run the fused local solve on B = len(idx0) * group rows read
    straight out of the packed matrix (K2).

    idx0: (B/group,) int32 group starts, multiples of `group` in
    [0, L - group]; batch row b is packed row idx0[b // group] + b % group.
    packed: (L, W) uint8. group: a multiple of 8. Other arguments and the
    returns as `fused_local_solve`. Raises ValueError where the reference
    does (group % 8, or a shape outside the fused gate `supports`). The
    starts are checked on CPU tensors; on the card they are not read back
    (that would wait for the device), and a start out of range reads as an
    all-MISSING group, never outside the matrix.
    """
    name = "fused_local_solve_dma"
    if idx0.dim() != 1 or packed.dim() != 2:
        raise ValueError(f"{name}: idx0 (B/group,), packed (L, W)")
    l, w = packed.shape
    b = idx0.shape[0] * group
    k = u_planes.shape[-1]
    if group % 8 or not supports(b, w, k, dtype, accel=accel):
        raise ValueError(f"{name}: unsupported B={b}, W={w}, group={group}")
    if l % group:
        raise ValueError(f"{name}: L={l} is not a multiple of group={group}")
    if idx0.dtype != torch.int32 or not idx0.is_contiguous():
        raise TypeError(f"{name}: idx0 must be contiguous int32")
    if idx0.device != packed.device:
        raise ValueError(f"{name}: idx0 on {idx0.device}, packed on "
                         f"{packed.device}")
    _check_solve_args(name, packed, u_planes, lamb_init, b, dtype)
    kw = dict(local_iters=local_iters, local_tol=local_tol, beta_a=beta_a,
              beta_b=beta_b, dtype=dtype, warm_start=warm_start,
              approx_div=approx_div, accel=accel)
    if packed.device.type == "cpu":
        if b and (idx0.min() < 0 or idx0.max() > l - group
                  or bool((idx0 % group).any())):
            raise ValueError(f"{name}: group starts must be multiples of "
                             f"{group} in [0, {l - group}]")
        fused_local_solve_dma.twin_calls += 1
        return fused_local_solve_dma_twin(idx0, packed, u_planes, lamb_init,
                                          group=group, **kw)
    if packed.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {packed.device}")
    _build.require_cuda(name, packed, u_planes, lamb_init,
                        dtypes=(torch.uint8, torch.float32, torch.float32))
    out = _launch_solve("tt_fused_local_solve_dma",
                        (idx0.data_ptr(), packed.data_ptr(), l, group),
                        u_planes, lamb_init, b, w, **kw)
    count_launch(fused_local_solve_dma, dtype)
    return out


fused_local_solve_dma.launches = 0
fused_local_solve_dma.bf16_launches = 0
fused_local_solve_dma.twin_calls = 0
