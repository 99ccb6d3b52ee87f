"""compute-beta post-pass: lambda for every SNP with theta frozen (port of
terastructure_tpu/svi/postprocess.py).

`solve_lambda_blocks` is the shared core of the 'local' lambda mode's eval
scorer and of the final lambda export. Each fixed-size block of packed
rows runs `local_solve_packed` (kernel K4 per pass on CUDA, its twin on
the CPU) and one exact K4 pass for the final statistic, at the config's
compute dtype (K4's bf16 body at "bfloat16").
"""

from __future__ import annotations

import torch

from terastructure_tpu_torch.config import SVIConfig
from terastructure_tpu_torch.models import psd
from terastructure_tpu_torch.ops import stats_dense as ops
from terastructure_tpu_torch.ops.stats_packed import (lambda_stats_packed,
                                                      local_solve_packed,
                                                      pad_individuals,
                                                      u_to_planes)


def solve_lambda_blocks(cfg: SVIConfig, u, packed_rows, *,
                        block: int = 1024, sub_seed=None):
    """Converged lambda for each packed row given fixed u = exp E[log theta].

    u: (4W, K) (caller pads); packed_rows: (S, W) uint8, a device tensor or
    a host array (each block moves to u's device on demand, so only one
    (block, W) slice is live). Returns lamb (S, K, 2) f32 on u's device.
    The last block is padded with 0xFF (MISSING) rows.

    sub_seed enables the big-N column subsample (cfg.local_sub_n): the
    coordinate-ascent passes run on a fixed byte-aligned subsample of
    individuals with N/Ns-scaled statistics, and the final statistic is
    one exact full-N pass. Pass a fixed seed so eval scores stay
    deterministic across checks.

    Batched replicates: u (R, 4W, K) solves every row for R replicates at
    once (K4 with its replicate axis, the rows shared) and returns
    (R, S, K, 2); one column subsample serves every replicate, as in the
    reference's batched scorer.
    """
    dtype = getattr(torch, cfg.compute_dtype)
    dev = u.device
    s, w = packed_rows.shape
    lead = tuple(u.shape[:-2])                    # () or (R,)
    wp = u.shape[-2] // 4
    lamb0 = torch.empty((*lead, block, cfg.k, 2), dtype=torch.float32,
                        device=dev)
    lamb0[..., 0] = cfg.beta_a
    lamb0[..., 1] = cfg.beta_b
    u_planes = u_to_planes(u)

    sub_w = (cfg.local_sub_n // 4 // 128) * 128
    idx_w = u_sub = None
    if sub_seed is not None and sub_w >= 128 and wp >= 4 * sub_w:
        gen = torch.Generator().manual_seed(sub_seed)
        idx_w = torch.randperm(wp, generator=gen)[:sub_w].to(dev)
        u_sub = u.reshape(*lead, wp, 4, -1)[..., idx_w, :, :].reshape(
            *lead, 4 * sub_w, -1)

    kw = dict(beta_a=cfg.beta_a, beta_b=cfg.beta_b,
              local_iters=cfg.local_iters, local_tol=cfg.local_tol,
              accel=cfg.local_accel, dtype=dtype)
    outs = []
    for lo in range(0, s, block):
        hi = min(lo + block, s)
        rows = torch.as_tensor(packed_rows[lo:hi]).to(dev)
        if hi - lo < block:
            rows = torch.cat([rows, rows.new_full((block - (hi - lo), w),
                                                  0xFF)])
        if idx_w is not None:
            lam = local_solve_packed(rows[:, idx_w].contiguous(), u_sub,
                                     lamb0, stat_scale=wp / sub_w, **kw)
        else:
            lam = local_solve_packed(rows, u, lamb0, **kw)
        e1, e0 = ops.exp_elog_beta(lam)
        l0, l1 = lambda_stats_packed(rows, u_planes, e1, e0, dtype=dtype)
        outs.append(torch.stack([cfg.beta_a + e1 * l0,
                                 cfg.beta_b + e0 * l1], -1))
    return torch.cat(outs, -3)[..., :s, :, :]


def compute_lambda(cfg: SVIConfig, gamma, packed, *, block: int = 1024):
    """Converged lambda (L, K, 2) for the whole matrix given gamma."""
    u = pad_individuals(ops.exp_elog_theta(gamma), packed.shape[1])
    return solve_lambda_blocks(cfg, u, packed, block=block)[: cfg.l]


def compute_beta(cfg: SVIConfig, gamma, packed, *, block: int = 1024):
    """Final beta estimates (L, K) as numpy, given converged gamma (N, K)."""
    lamb = compute_lambda(cfg, gamma, packed, block=block)
    return psd.beta_mean(lamb).cpu().numpy()

