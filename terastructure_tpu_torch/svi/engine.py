"""The SVI engine: single-device step and step-chunk runner (port of
terastructure_tpu/svi/engine.py).

    repeat:
      sample the SNP minibatch and gather its packed rows   (_sample_rows)
      local step: phi <-> lambda_B                         (fused_local_solve)
      global step: gamma <- (1 - rho) gamma + rho (alpha + L/B * stat)

Plain functions on tensors with an explicit device. The state is a
NamedTuple; `t` is a host int and the per-step draws come from a torch
generator seeded from (seed, t), so a run is reproducible and resumable
and the chunk itself never reads the device.

Ported: the resident, single-process, local-lambda path with kernel
"auto"/"fused" (K1, and K3 at biobank L) or "dense". Not yet ported, and
raising NotImplementedError: lambda_mode="stored", kernel="pallas" and
the big-N per-iteration path the fused gate falls back to (slice S4), the
bf16 kernel path, snp_group >= 8 group DMA (K2).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from terastructure_tpu_torch.config import SVIConfig
from terastructure_tpu_torch.data.pack import unpack2bit_torch
from terastructure_tpu_torch.models import psd
from terastructure_tpu_torch.ops import fused_step
from terastructure_tpu_torch.ops import stats_dense as ops
from terastructure_tpu_torch.ops.gather import gather_row_blocks
from terastructure_tpu_torch.ops.stats_packed import (pad_individuals,
                                                      planes_to_flat,
                                                      u_to_planes)


class SVIState(NamedTuple):
    gamma: torch.Tensor   # (N, K) f32 Dirichlet params
    lamb: torch.Tensor    # (L, K, 2) f32 Beta params
    t: int                # iteration counter (host)
    seed: int             # base seed; step t draws from (seed, t)


def pad_width(packed: np.ndarray) -> np.ndarray:
    """Pad the byte width to a multiple of 128 with 0xFF (MISSING), as the
    reference driver does: the fused gate requires it."""
    wpad = (-packed.shape[1]) % 128
    if wpad:
        packed = np.pad(packed, ((0, 0), (0, wpad)), constant_values=0xFF)
    return packed


def init_state(cfg: SVIConfig, *, l_padded=None, device="cpu") -> SVIState:
    """Random gamma, prior lambda. gamma is drawn on the CPU from cfg.seed
    and then moved, so every device starts from the same values."""
    l = cfg.l if l_padded is None else l_padded
    gen = torch.Generator().manual_seed(cfg.seed)
    gamma = (cfg.alpha_value + cfg.gamma_init_scale
             * torch.rand((cfg.n, cfg.k), generator=gen)).to(device)
    lamb = torch.empty((l, cfg.k, 2), dtype=torch.float32, device=device)
    lamb[..., 0] = cfg.beta_a
    lamb[..., 1] = cfg.beta_b
    return SVIState(gamma=gamma, lamb=lamb, t=0, seed=cfg.seed)


def state_from_reference(gamma, lamb, t, seed, device="cpu") -> SVIState:
    """The port's state from the reference SVIState's arrays (numpy), so
    both packages can run from one state."""
    return SVIState(
        gamma=torch.tensor(np.asarray(gamma, np.float32), device=device),
        lamb=torch.tensor(np.asarray(lamb, np.float32), device=device),
        t=int(t), seed=int(seed))


def step_generator(seed: int, t: int, device) -> torch.Generator:
    """The generator of step t: seeded from (seed, t), like the
    reference's fold_in(key, t). Its draws differ from JAX's."""
    s = np.random.SeedSequence([seed & 0xFFFFFFFF, t]).generate_state(
        2, dtype=np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(s[0]) << 31 ^ int(s[1]))


def _sample_batch(gen, l_real, batch_size, device):
    """Uniform SNP minibatch: without replacement while L <= 65536, with
    replacement (still unbiased) at biobank L."""
    if l_real <= 65536:
        return torch.randperm(l_real, generator=gen, device=device)[
            :batch_size].to(torch.int32)
    return torch.randint(0, l_real, (batch_size,), generator=gen,
                         device=device, dtype=torch.int32)


def _sample_rows(cfg: SVIConfig, packed, gen, l_sample):
    """Sample the SNP minibatch and gather its packed rows.

    At biobank L: B/8 uniform 8-row blocks fetched by K3
    `gather_row_blocks`; block draws keep the gamma estimate unbiased
    (every SNP equally likely, scale L/B unchanged). Otherwise independent
    per-row draws and a plain index gather. The choice depends on the
    config and the shape only, never on the device (the reference turns
    blocks off under its CPU interpreter). Returns (idx (B,), rows (B, W)).
    """
    b = cfg.batch_size
    if (cfg.dma_gather and l_sample >= cfg.dma_gather_min_l
            and l_sample % 8 == 0 and b % 128 == 0):
        blocks = torch.randint(0, l_sample // 8, (b // 8,), generator=gen,
                               device=packed.device, dtype=torch.int32)
        idx = (blocks[:, None] * 8
               + torch.arange(8, dtype=torch.int32, device=packed.device)
               ).reshape(b)
        return idx, gather_row_blocks(packed, blocks, block=8)
    idx = _sample_batch(gen, l_sample, b, packed.device)
    return idx, packed[idx.long()]


def _resolve_kernel(cfg: SVIConfig) -> str:
    """"auto" is the fused solve on every device: K1 on CUDA, its twin on
    the CPU (the reference picks fused only on the TPU)."""
    if cfg.kernel == "auto":
        return "fused"
    if cfg.kernel in ("fused", "dense"):
        return cfg.kernel
    if cfg.kernel == "pallas":
        raise NotImplementedError(
            "kernel='pallas' (per-iteration big-N path) is slice S4")
    raise ValueError(f"unknown kernel {cfg.kernel!r}")


def step_core_fused(cfg: SVIConfig, gamma, rows):
    """Fused local solve (K1) from packed rows (B, W), cold start.
    Returns (new_lamb_b (B, K, 2), gamma_stat (N, K))."""
    b, w = rows.shape
    u = pad_individuals(ops.exp_elog_theta(gamma), w)
    lamb_init = torch.zeros((b, cfg.k, 2), dtype=torch.float32,
                            device=rows.device)
    new_lamb_b, g = fused_step.fused_local_solve(
        rows, u_to_planes(u), lamb_init,
        local_iters=cfg.local_iters, local_tol=cfg.local_tol,
        beta_a=cfg.beta_a, beta_b=cfg.beta_b,
        dtype=getattr(torch, cfg.compute_dtype), warm_start=False,
        approx_div=cfg.stats_approx_div, accel=cfg.local_accel)
    return new_lamb_b, (u * planes_to_flat(g))[: gamma.shape[0]]


def step_core_dense(cfg: SVIConfig, gamma, xb, lamb_b):
    """Local solve + statistics from an unpacked minibatch xb (B, N).
    Returns (new_lamb_b (B, K, 2), gamma_stat (N, K))."""
    dtype = getattr(torch, cfg.compute_dtype)
    a1, a0 = ops.allele_counts(xb, torch.float32)
    u = ops.exp_elog_theta(gamma)
    lamb_b = ops.local_solve(
        a1, a0, u, lamb_b, beta_a=cfg.beta_a, beta_b=cfg.beta_b,
        local_iters=cfg.local_iters, local_tol=cfg.local_tol, dtype=dtype,
        accel=cfg.local_accel)
    t1, t0 = ops.exp_elog_beta(lamb_b)
    stats = ops.batch_stats(a1, a0, u, t1, t0, dtype)
    new_lamb_b = torch.stack([cfg.beta_a + stats.lam0_stat,
                              cfg.beta_b + stats.lam1_stat], -1)
    return new_lamb_b, stats.gamma_stat


def _global_update(cfg: SVIConfig, gamma, gamma_stat, t: int, l_sample: int):
    """Robbins-Monro natural-gradient gamma update.

    rho and L/B are computed in float32, as the reference does, so the
    step matches it to the last bits. gamma_psum_dtype="bf16" rounds the
    statistic to bf16 (round to nearest even) and back, the single-device
    mirror of the sharded bf16 reduction.
    """
    rho = float(np.power(np.float32(cfg.tau0) + np.float32(t),
                         np.float32(-cfg.kappa), dtype=np.float32))
    scale = float(np.float32(l_sample) / np.float32(cfg.batch_size))
    if cfg.gamma_psum_dtype == "bf16":
        gamma_stat = gamma_stat.to(torch.bfloat16).to(torch.float32)
    gamma_target = cfg.alpha_value + scale * gamma_stat
    return float(np.float32(1.0) - np.float32(rho)) * gamma + rho * gamma_target


def make_step(cfg: SVIConfig, l_sample: int | None = None):
    """The single-device SVI step: (state, packed) -> state.

    l_sample: the SNP range to sample over (the padded row count when the
    packed matrix has padding rows; defaults to cfg.l).
    """
    impl_req = _resolve_kernel(cfg)
    l_s = l_sample or cfg.l
    if cfg.lambda_mode != "local":
        raise NotImplementedError(
            "lambda_mode='stored' is a later slice; the port runs 'local'")

    def step(state: SVIState, packed) -> SVIState:
        gamma = state.gamma
        b, w = cfg.batch_size, packed.shape[1]
        if impl_req == "fused":
            dtype = getattr(torch, cfg.compute_dtype)
            if not fused_step.supports(b, w, cfg.k, dtype,
                                       accel=cfg.local_accel):
                raise NotImplementedError(
                    f"B={b}, W={w}, K={cfg.k} is outside the fused gate: the "
                    "big-N per-iteration path is slice S4")
            g = cfg.snp_group
            if (g >= 8 and g % 8 == 0 and l_s % g == 0 and b % g == 0
                    and l_s > 65536):
                raise NotImplementedError(
                    "snp_group >= 8 (group DMA, kernel K2) is not ported")
        gen = step_generator(state.seed, state.t, packed.device)
        _, rows = _sample_rows(cfg, packed, gen, l_s)
        if impl_req == "fused":
            _, gamma_stat = step_core_fused(cfg, gamma, rows)
        else:
            lamb_b = torch.empty((b, cfg.k, 2), device=packed.device)
            lamb_b[..., 0] = cfg.beta_a
            lamb_b[..., 1] = cfg.beta_b
            xb = unpack2bit_torch(rows, cfg.n)
            _, gamma_stat = step_core_dense(cfg, gamma, xb, lamb_b)
        gamma = _global_update(cfg, gamma, gamma_stat, state.t, l_s)
        return state._replace(gamma=gamma, t=state.t + 1)

    return step


def make_run_chunk(cfg: SVIConfig, nsteps: int, l_sample: int | None = None):
    """Runner of `nsteps` SVI steps. It enqueues device work only: the
    host never waits on the device inside a chunk."""
    step = make_step(cfg, l_sample)

    def run_chunk(state: SVIState, packed) -> SVIState:
        for _ in range(nsteps):
            state = step(state, packed)
        return state

    return run_chunk


def make_entry_loglik_recompute(cfg: SVIConfig, eval_rows, row_of_entry,
                                ind_idx, x, *, device):
    """Eval scorer for the 'local' lambda mode.

    eval_rows (S, W) packed rows of the distinct eval SNPs (the training
    matrix: eval entries are MISSING there); row_of_entry (M,) maps each
    entry to its row. Returns gamma -> mean log-lik (a 0-d tensor), which
    re-solves those SNPs' lambdas from the current gamma. Inputs move to
    the device once.
    """
    from terastructure_tpu_torch.svi.postprocess import solve_lambda_blocks

    eval_rows = torch.as_tensor(np.asarray(eval_rows)).to(device)
    row_of_entry = torch.as_tensor(np.asarray(row_of_entry)).long().to(device)
    ind_idx = torch.as_tensor(np.asarray(ind_idx)).long().to(device)
    x = torch.as_tensor(np.asarray(x)).to(device)
    w = eval_rows.shape[1]
    # Fixed subsample seed: eval scores stay deterministic across checks
    # (the column subsample engages only when N is large).
    sub_seed = cfg.seed ^ 0xE7A1

    def f(gamma):
        u = pad_individuals(ops.exp_elog_theta(gamma), w)
        lamb_eval = solve_lambda_blocks(cfg, u, eval_rows, block=1024,
                                        sub_seed=sub_seed)
        if cfg.predictive == "variational":
            return psd.variational_predictive_loglik(
                gamma[ind_idx], lamb_eval[row_of_entry], x).mean()
        beta = psd.beta_mean(lamb_eval)
        th = psd.theta_mean(gamma[ind_idx])
        p = (th * beta[row_of_entry]).sum(-1)
        return psd.binomial2_loglik(x, p).mean()

    return f
