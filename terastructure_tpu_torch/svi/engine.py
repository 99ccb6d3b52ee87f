"""The SVI engine: single-device step and step-chunk runner (port of
terastructure_tpu/svi/engine.py).

    repeat:
      sample the SNP minibatch                       (_sample_rows, K2's
                                                      group draw, or
                                                      _gather_batch)
      local step: phi <-> lambda_B and the gamma statistic
          (fused_local_solve K1, fused_local_solve_dma K2 on groups of
           the packed matrix, or step_core_packed where the fused gate
           refuses the shape: the big-N per-iteration path)
      global step: gamma <- (1 - rho) gamma + rho (alpha + L/B * stat)
      stored lambda mode: scatter lambda_B back into the (L, K, 2) array

Plain functions on tensors with an explicit device. The state is a
NamedTuple; `t` is a host int and the per-step draws come from a torch
generator seeded from (seed, t), so a run is reproducible and resumable
and the chunk itself never reads the device.

Ported: the resident, single-process path with kernel "auto"/"fused"
(K1, K3 at biobank L, K2 with snp_group >= 8), "dense", and "pallas"
(the big-N per-iteration path: K8, K4, and K7, K5 or K6 for the
statistics), at compute_dtype "float32" and "bfloat16", in both lambda
modes.

Batched replicates (`make_replicate_step`, `make_replicate_run_chunk`;
the entry point is svi/replicates.py): R seeds step in lockstep on one
stacked state, the reference's vmapped step. Each replicate draws its own
minibatch (and on the big-N path its own column subsample) from its own
generators; the fused branch on gathered rows (K1, the reference's
dma_gather=False: no K3) and the big-N path (K8, K7, K4, K5, K6) each
launch their kernels once for all R with a replicate axis, at any K;
kernel="dense" runs each replicate's dense step; the glue runs on the
stacked tensors. K2's group DMA raises NotImplementedError, as the
reference's batched fit has no such path.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from terastructure_tpu_torch.config import SVIConfig
from terastructure_tpu_torch.data.pack import unpack2bit_torch
from terastructure_tpu_torch.models import psd
from terastructure_tpu_torch.ops import fused_step
from terastructure_tpu_torch.ops import stats_dense as ops
from terastructure_tpu_torch.ops import stats_packed as pk
from terastructure_tpu_torch.ops.gather import gather_row_blocks
from terastructure_tpu_torch.ops.stats_packed import (pad_individuals,
                                                      planes_to_flat,
                                                      u_to_planes)


class SVIState(NamedTuple):
    gamma: torch.Tensor   # (N, K) f32 Dirichlet params
    lamb: torch.Tensor    # (L, K, 2) f32 Beta params
    t: int                # iteration counter (host)
    seed: int             # base seed; step t draws from (seed, t)


def pad_width(packed):
    """Pad the byte width to a multiple of 128 with 0xFF (MISSING), as the
    reference driver does: the fused gate requires it. A numpy array or a
    tensor (padded where it lies)."""
    wpad = (-packed.shape[1]) % 128
    if wpad and isinstance(packed, torch.Tensor):
        packed = torch.nn.functional.pad(packed, (0, wpad), value=0xFF)
    elif wpad:
        packed = np.pad(packed, ((0, 0), (0, wpad)), constant_values=0xFF)
    return packed


def resident_packed(packed, device) -> torch.Tensor:
    """The width-padded packed matrix (pad_width) as a uint8 tensor on
    `device`: what `fit(packed=)`, `fit_replicates_batched(packed=)`,
    `compute_lambda` and `compute_beta` take. A matrix already on the
    device (data/simulate.simulate_packed_device_resident) is used where
    it is, copied only where its width needs padding."""
    if isinstance(packed, torch.Tensor):
        return pad_width(packed.to(device))
    return torch.from_numpy(pad_width(np.asarray(packed))).to(device)


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


def step_generator(seed: int, t: int, device, *tags: int) -> torch.Generator:
    """The generator of step t: seeded from (seed, t), like the
    reference's fold_in(key, t); extra tags give a separate stream of the
    same step, like fold_in(fold_in(key, t), tag). Its draws differ from
    JAX's."""
    s = np.random.SeedSequence([seed & 0xFFFFFFFF, t, *tags]).generate_state(
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


def _group_size(cfg: SVIConfig, l_sample: int) -> int:
    """Effective SNP-group granularity of the stored mode's gather (1 =
    independent per-SNP draws), as the reference's _group_size."""
    g = cfg.snp_group
    if (g <= 1 or l_sample <= 65536 or l_sample % g
            or cfg.batch_size % g):
        return 1
    return g


def _gather_batch(cfg: SVIConfig, packed, lamb, gen, l_sample, *, draw=None):
    """Sample the minibatch and gather its packed rows and lambda rows
    (the stored mode's big-N and dense branches).

    Group-sampled at biobank L (see SVIConfig.snp_group): B/G groups of G
    consecutive SNPs, gathered as B/G rows of a (L/G, G*W) view. `draw`
    injects the draw instead of gen's (tests): the group indices (B/G,)
    when grouped, the row indices (B,) otherwise.

    Returns (idx (B,), rows (B, W), lamb_b (B, K, 2), scatter) where
    scatter(new_lamb_b) writes the new lambda rows into `lamb` in place.
    """
    b = cfg.batch_size
    g = _group_size(cfg, l_sample)
    dev = packed.device
    draw = (_draw_batch(cfg, gen, l_sample, g, dev) if draw is None
            else draw.to(dev).long())
    if g == 1:
        idx = draw

        def scatter(new):
            lamb[idx] = new

        return idx, packed[idx], lamb[idx], scatter

    lg, ng = l_sample // g, b // g
    w, k = packed.shape[1], lamb.shape[1]
    gidx = draw
    idx = (gidx[:, None] * g + torch.arange(g, device=dev)).reshape(b)
    rows = packed[:l_sample].view(lg, g * w)[gidx].view(b, w)
    lamb_g = lamb[:l_sample].view(lg, g, k, 2)

    def scatter(new):
        lamb_g[gidx] = new.view(ng, g, k, 2)

    return idx, rows, lamb_g[gidx].view(b, k, 2), scatter


def _draw_batch(cfg: SVIConfig, gen, l_sample, g, dev) -> torch.Tensor:
    """A step's draw from gen, int64: B row indices (`_sample_batch`)
    where g is 1, else B/g indices of groups of g rows (the stored mode's
    groups, `_gather_batch`)."""
    if g == 1:
        return _sample_batch(gen, l_sample, cfg.batch_size, dev).long()
    return torch.randint(0, l_sample // g, (cfg.batch_size // g,),
                         generator=gen, device=dev, dtype=torch.int32).long()


def uses_group_dma(cfg: SVIConfig, l_sample: int) -> bool:
    """Whether the fused branch reads its minibatch as groups straight
    out of the packed matrix (K2): the reference's gate
    (svi/engine.py:343-346) without its `not interpret` term, so the
    choice depends on the config and the shape only."""
    g = cfg.snp_group
    return (g >= 8 and g % 8 == 0 and l_sample % g == 0
            and cfg.batch_size % g == 0 and l_sample > 65536)


def _draw_groups(cfg: SVIConfig, gen, l_sample, device):
    """K2's minibatch: B/g uniform group starts idx0 (multiples of g) and
    the rows they cover, idx (B,)."""
    g = cfg.snp_group
    gidx = torch.randint(0, l_sample // g, (cfg.batch_size // g,),
                         generator=gen, device=device, dtype=torch.int32)
    idx0 = gidx * g
    idx = (idx0[:, None] + torch.arange(g, dtype=torch.int32, device=device)
           ).reshape(-1)
    return idx0, idx


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


SUB_TAG = 0x5B      # the column subsample's stream: fold_in(kb, 0x5B)


def _resolve_kernel(cfg: SVIConfig) -> str:
    """"auto" is the fused solve on every device: K1 on CUDA, its twin on
    the CPU (the reference picks fused only on the TPU)."""
    if cfg.kernel == "auto":
        return "fused"
    if cfg.kernel in ("fused", "dense", "pallas"):
        return cfg.kernel
    raise ValueError(f"unknown kernel {cfg.kernel!r}")


def _fused_solve(cfg: SVIConfig, gamma, w, b, device, lamb_init, solve):
    """The glue K1 and K2 share: u = exp E[log theta] padded to 4W
    individuals in planes, the gamma statistic out. solve(u_planes,
    lamb_init, **kw) is the kernel call. lamb_init None is a cold start:
    the solve is handed zeros it never reads, as the reference does.
    Returns (new_lamb_b (B, K, 2), gamma_stat (N, K)); a leading R on
    gamma (batched replicates) carries through."""
    *lead, n, _ = gamma.shape
    u = pad_individuals(ops.exp_elog_theta(gamma), w)
    warm = lamb_init is not None
    if not warm:
        lamb_init = torch.zeros((*lead, b, cfg.k, 2), dtype=torch.float32,
                                device=device)
    new_lamb_b, g = solve(
        u_to_planes(u), lamb_init, local_iters=cfg.local_iters,
        local_tol=cfg.local_tol, beta_a=cfg.beta_a, beta_b=cfg.beta_b,
        dtype=getattr(torch, cfg.compute_dtype), warm_start=warm,
        approx_div=cfg.stats_approx_div, accel=cfg.local_accel)
    return new_lamb_b, (u * planes_to_flat(g))[..., :n, :]


def step_core_fused(cfg: SVIConfig, gamma, rows, lamb_init=None):
    """Fused local solve (K1) from packed rows (B, W); warm start from
    lamb_init (B, K, 2) where given, else cold at the prior.
    Returns (new_lamb_b (B, K, 2), gamma_stat (N, K)).

    Batched replicates: gamma (R, N, K), rows (R, B, W), lamb_init (R,
    B, K, 2) or None: one K1 launch sequence with the replicate axis,
    each replicate with its own tol exit; returns (R, B, K, 2) and (R,
    N, K), replicate r bitwise the single step's on its inputs."""
    b, w = rows.shape[-2:]
    return _fused_solve(cfg, gamma, w, b, rows.device, lamb_init,
                        functools.partial(fused_step.fused_local_solve, rows))


def step_core_fused_dma(cfg: SVIConfig, gamma, packed, idx0, lamb_init=None):
    """Fused local solve (K2) on the B/g groups of g = cfg.snp_group rows
    of packed (L, W) that start at idx0; no gathered copy. Warm start as
    step_core_fused. Returns (new_lamb_b (B, K, 2), gamma_stat (N, K))."""
    g = cfg.snp_group
    return _fused_solve(
        cfg, gamma, packed.shape[1], idx0.shape[0] * g, packed.device,
        lamb_init, functools.partial(fused_step.fused_local_solve_dma, idx0,
                                     packed, group=g))


def _prior_lamb(cfg: SVIConfig, b: int, device, lead=()) -> torch.Tensor:
    """The cold start of a local solve: (*lead, B, K, 2) at the Beta
    prior."""
    lamb = torch.empty((*lead, b, cfg.k, 2), dtype=torch.float32,
                       device=device)
    lamb[..., 0] = cfg.beta_a
    lamb[..., 1] = cfg.beta_b
    return lamb


def subsample_columns(cfg: SVIConfig, wp: int, gen) -> torch.Tensor | None:
    """The big-N column subsample: sub_w distinct byte columns of the
    padded width wp (4 individuals each), or None where it does not
    engage (local_sub_n below 512 or wp < 4 sub_w), as the reference's
    step_core_packed decides."""
    sub_w = (cfg.local_sub_n // 4 // 128) * 128
    if sub_w < 128 or wp < 4 * sub_w:
        return None
    return torch.randperm(wp, generator=gen, device=gen.device)[:sub_w]


def batch_pad_rows(b: int) -> int:
    """All-MISSING rows the reference's big-N step pads a batch of b rows
    with: it pads to a multiple of 8 where none of its row tiles (256,
    128, ..., 8) divides b (terastructure_tpu/svi/engine.py:178-179)."""
    return (-b) % 8


def step_core_packed(cfg: SVIConfig, gamma, rows, *, gen=None, idx_w=None,
                     lamb_b=None):
    """Local solve + statistics from packed rows (B, W): the big-N
    per-iteration path (the reference's engine.step_core_packed).

    The coordinate-ascent passes run on a byte-aligned column subsample
    of ~local_sub_n individuals with N/Ns-scaled statistics (K8 over
    count planes decoded once, or K4 with sub_decode_once=False; fast
    divide with local_sub_approx_div), optionally one exact full-N K4
    sweep (local_refine_full), then one exact full-N statistics pass
    chosen by stats_kernel: "fused_v2" (K7), "pair" (K4 + K5) or "fused"
    (K6). Without a subsample (gen and idx_w both None, or N too small)
    the whole solve runs K4 at full N. Every kernel call runs at
    cfg.compute_dtype (at "bfloat16" the kernels' bf16 bodies: T, U and R
    rounded as the products' operands; the schedule, the tol test and
    the update stay f32).

    gen draws the subsample; idx_w (sub_w,) injects it instead (tests).
    lamb_b (B, K, 2) warm-starts the solve (the stored lambda mode); None
    starts it at the prior.
    Any B: the kernels need no batch padding. Where the reference pads B
    (`batch_pad_rows`), the solve's tol test counts the pad rows' known
    share, so the loop exits at the reference's pass.
    Returns (new_lamb_b (B, K, 2), gamma_stat (N, K)).

    Batched replicates (the reference's step under jax.vmap): gamma
    (R, N, K), rows (R, B, W), lamb_b (R, B, K, 2) or None, and gen a
    sequence of R generators or idx_w (R, sub_w), replicate r's own
    subsample. Every kernel runs once for all R with its replicate axis,
    each replicate with its own tol test; returns (R, B, K, 2) and
    (R, N, K), replicate r bitwise the single step's on its inputs.
    """
    dtype = getattr(torch, cfg.compute_dtype)
    *lead, b, w = rows.shape
    n = gamma.shape[-2]
    if w % 128:        # the reference's padded width: same subsample range
        rows = torch.cat([rows, rows.new_full((*lead, b, (-w) % 128), 0xFF)],
                         -1)
    wp = rows.shape[-1]
    u = pad_individuals(ops.exp_elog_theta(gamma), wp)
    if lamb_b is None:
        lamb_b = _prior_lamb(cfg, b, rows.device, lead)
    kw = dict(beta_a=cfg.beta_a, beta_b=cfg.beta_b,
              pad_rows=batch_pad_rows(b), dtype=dtype)
    if idx_w is None and gen is not None and not lead:
        idx_w = subsample_columns(cfg, wp, gen)
    elif idx_w is None and gen is not None:   # the shape decides for all R
        subs = [subsample_columns(cfg, wp, g) for g in gen]
        idx_w = None if subs[0] is None else torch.stack(subs)
    if idx_w is not None:
        sub_w = idx_w.shape[-1]
        idx_w = idx_w.to(rows.device, torch.long)
        if lead:       # replicate r's columns of its rows and of its u
            rows_sub = torch.take_along_dim(
                rows, idx_w[:, None, :].expand(*lead, b, sub_w), -1)
            reps = torch.arange(lead[0], device=rows.device)[:, None]
            u_sub = u.reshape(*lead, wp, 4, -1)[reps, idx_w].reshape(
                *lead, 4 * sub_w, -1)
        else:
            rows_sub = rows[:, idx_w].contiguous()
            u_sub = u.reshape(wp, 4, -1)[idx_w].reshape(4 * sub_w, -1)
        solve = (pk.local_solve_acat if cfg.sub_decode_once
                 else pk.local_solve_packed)
        lamb_b = solve(rows_sub, u_sub, lamb_b, local_iters=cfg.local_iters,
                       local_tol=cfg.local_tol, stat_scale=wp / sub_w,
                       approx_div=cfg.local_sub_approx_div,
                       accel=cfg.local_accel, **kw)
        if cfg.local_refine_full:
            lamb_b = pk.local_solve_packed(rows, u, lamb_b, local_iters=1,
                                           local_tol=0.0, **kw)
    else:
        lamb_b = pk.local_solve_packed(rows, u, lamb_b,
                                       local_iters=cfg.local_iters,
                                       local_tol=cfg.local_tol,
                                       accel=cfg.local_accel, **kw)
    t1, t0 = ops.exp_elog_beta(lamb_b)
    if cfg.stats_kernel == "fused_v2":
        gamma_stat, l0, l1 = pk.batch_stats_fused_v2_packed(
            rows, u, t1, t0, approx_div=cfg.stats_approx_div, dtype=dtype)
    elif cfg.stats_kernel in ("pair", "fused"):
        stats_fn = {"pair": pk.batch_stats_packed,
                    "fused": pk.batch_stats_fused_packed}[cfg.stats_kernel]
        gamma_stat, l0, l1 = stats_fn(rows, u, t1, t0, dtype=dtype)
    else:
        raise ValueError(f"unknown stats_kernel {cfg.stats_kernel!r}")
    new_lamb_b = torch.stack([cfg.beta_a + l0, cfg.beta_b + l1], -1)
    return new_lamb_b, gamma_stat[..., :n, :]


def step_core_dense(cfg: SVIConfig, gamma, xb, lamb_b):
    """Local solve + statistics from an unpacked minibatch xb (B, N).
    Returns (new_lamb_b (B, K, 2), gamma_stat (N, K)).

    Batched replicates: gamma (R, N, K), xb (R, B, N), lamb_b (R, B, K,
    2): each replicate's step, stacked. Plain torch with no kernel of its
    own, so a replicate runs its single step's products and its result
    is that step's bitwise (a batched product may sum in another
    order)."""
    if gamma.dim() == 3:
        outs = [step_core_dense(cfg, g, x, lm)
                for g, x, lm in zip(gamma, xb, lamb_b)]
        return tuple(torch.stack(x) for x in zip(*outs))
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


def step_impl(cfg: SVIConfig, w: int) -> str:
    """The local step a step of width w runs: "fused", "pallas" (big-N)
    or "dense". The reference's order (engine.py:336-346): a shape the
    fused kernel's gate refuses takes the big-N path; group DMA (K2) is a
    variant of the fused branch only (uses_group_dma)."""
    impl = _resolve_kernel(cfg)
    if impl == "fused" and not fused_step.supports(
            cfg.batch_size, w, cfg.k, getattr(torch, cfg.compute_dtype),
            accel=cfg.local_accel):
        return "pallas"
    return impl


def make_step(cfg: SVIConfig, l_sample: int | None = None):
    """The single-device SVI step: (state, packed) -> state.

    l_sample: the SNP range to sample over (the padded row count when the
    packed matrix has padding rows; defaults to cfg.l).

    In the stored lambda mode the step scatters the minibatch's new
    lambda rows into state.lamb in place: it consumes its input state,
    as the reference's chunk runner donates it (donate_argnums). Clone
    the state first to run a step twice from it. Duplicate rows in a
    batch (draws with replacement, a group drawn twice) carry bitwise
    equal values, so the scatter's write order does not matter.
    """
    _resolve_kernel(cfg)            # an unknown kernel name fails here
    l_s = l_sample or cfg.l
    local_mode = cfg.lambda_mode == "local"
    if not local_mode and cfg.lambda_mode != "stored":
        raise ValueError(f"unknown lambda_mode {cfg.lambda_mode!r}")

    def step(state: SVIState, packed) -> SVIState:
        gamma, lamb = state.gamma, state.lamb
        b = cfg.batch_size
        dev = packed.device
        impl = step_impl(cfg, packed.shape[1])
        gen = step_generator(state.seed, state.t, dev)
        if impl == "fused":
            if uses_group_dma(cfg, l_s):
                idx0, idx = _draw_groups(cfg, gen, l_s, dev)
                new_lamb_b, gamma_stat = step_core_fused_dma(
                    cfg, gamma, packed, idx0,
                    None if local_mode else lamb[idx.long()])
            else:
                idx, rows = _sample_rows(cfg, packed, gen, l_s)
                new_lamb_b, gamma_stat = step_core_fused(
                    cfg, gamma, rows, None if local_mode else lamb[idx.long()])
            if not local_mode:
                lamb[idx.long()] = new_lamb_b
        else:
            if local_mode:
                _, rows = _sample_rows(cfg, packed, gen, l_s)
                lamb_b, scatter = None, None
            else:
                _, rows, lamb_b, scatter = _gather_batch(cfg, packed, lamb,
                                                         gen, l_s)
            if impl == "pallas":
                sub_gen = step_generator(state.seed, state.t, dev, SUB_TAG)
                new_lamb_b, gamma_stat = step_core_packed(
                    cfg, gamma, rows, gen=sub_gen, lamb_b=lamb_b)
            else:
                xb = unpack2bit_torch(rows, cfg.n)
                new_lamb_b, gamma_stat = step_core_dense(
                    cfg, gamma, xb,
                    _prior_lamb(cfg, b, dev) if lamb_b is None else lamb_b)
            if scatter is not None:
                scatter(new_lamb_b)
        gamma = _global_update(cfg, gamma, gamma_stat, state.t, l_s)
        return state._replace(gamma=gamma, t=state.t + 1)

    return step


class ReplicateState(NamedTuple):
    """R replicates' states stacked (the reference's vmapped SVIState)."""
    gamma: torch.Tensor   # (R, N, K)
    lamb: torch.Tensor    # (R, L, K, 2)
    t: int                # the iteration counter (host), shared: the
    #                       replicates step in lockstep
    seeds: tuple          # each replicate's seed


def init_replicate_state(cfg: SVIConfig, seeds, *, l_padded=None,
                         device="cpu") -> ReplicateState:
    """`init_state` of each seed, stacked: replicate r starts where a
    single fit with seed r starts."""
    states = [init_state(cfg.replace(seed=s), l_padded=l_padded,
                         device=device) for s in seeds]
    return ReplicateState(gamma=torch.stack([s.gamma for s in states]),
                          lamb=torch.stack([s.lamb for s in states]),
                          t=0,
                          seeds=tuple(int(s) for s in seeds))


def unstack_state(states: ReplicateState, i: int) -> SVIState:
    """Replicate i's SVIState out of a stacked state (views of its rows)."""
    return SVIState(gamma=states.gamma[i], lamb=states.lamb[i],
                    t=states.t, seed=states.seeds[i])


def check_replicate_path(cfg: SVIConfig, w: int, l_sample: int) -> None:
    """Raise NotImplementedError where a batched step would read its
    minibatch through K2's group DMA, which the reference's batched fit
    has no path for either: its scalar-prefetch DMA kernels do not lift
    under vmap, so it forces dma_gather=False
    (terastructure_tpu/svi/replicates.py:26-30). Every other branch runs
    batched at any K: the fused solve (K1) on gathered rows, the big-N
    path (K8, K7, K4, K5, K6) and kernel="dense"."""
    if step_impl(cfg, w) == "fused" and uses_group_dma(cfg, l_sample):
        raise NotImplementedError(
            f"batched replicates through K2's group DMA (snp_group="
            f"{cfg.snp_group} at L = {l_sample}): the reference's batched "
            "fit has no such path, its group DMA kernel does not lift "
            "under vmap (terastructure_tpu/svi/replicates.py:26-30); run "
            "the replicates with snp_group=1, or one by one")


def make_replicate_step(cfg: SVIConfig, l_sample: int | None = None):
    """The batched replicates' step: (ReplicateState, packed) ->
    ReplicateState, R single-device steps in lockstep.

    Replicate r draws step t's minibatch from step_generator(seed_r, t)
    as a single fit with seed r does with dma_gather=False (independent
    per-row draws; the reference's batched step turns block draws off), so
    K3 never runs. The R row sets are gathered into one (R, B, W) tensor.
    The fused branch solves all R in one K1 launch sequence. The big-N
    branch (where the fused gate refuses the shape) runs the batched
    `step_core_packed`, replicate r's column subsample drawn from
    step_generator(seed_r, t, SUB_TAG) as the single step draws it.
    kernel="dense" runs `step_core_dense` on each replicate's unpacked
    rows (plain torch, no kernel of its own: a replicate's products are
    its single step's). In the stored mode the big-N and dense branches
    draw by `_gather_batch`'s rule (groups where `_group_size` > 1), as
    their single steps do. u, the gamma statistic and the Robbins-Monro
    update run on the stacked tensors (rho is the same for every
    replicate). In the stored lambda mode each replicate gathers and
    scatters its own lambda rows, in place. Each replicate's gamma (and
    lambda) is bitwise the single fit's, at any K.

    Raises NotImplementedError where the step would take K2's group DMA
    (`check_replicate_path`).
    """
    _resolve_kernel(cfg)
    cfg = cfg.replace(dma_gather=False)
    l_s = l_sample or cfg.l
    w = 128 * -(-cfg.n // 512)            # pad_width's byte width
    check_replicate_path(cfg, w, l_s)
    impl = step_impl(cfg, w)
    local_mode = cfg.lambda_mode == "local"
    if not local_mode and cfg.lambda_mode != "stored":
        raise ValueError(f"unknown lambda_mode {cfg.lambda_mode!r}")
    g = _group_size(cfg, l_s) if impl != "fused" and not local_mode else 1

    def step(state: ReplicateState, packed) -> ReplicateState:
        t = state.t
        if packed.shape[1] != w:
            raise ValueError(f"replicate step: packed width {packed.shape[1]}"
                             f", expected {w}")
        gamma, lamb = state.gamma, state.lamb
        r, n = gamma.shape[:2]
        b, k = cfg.batch_size, cfg.k
        dev = packed.device
        reps = torch.arange(r, device=dev)[:, None]
        warm = not local_mode
        # rows (R, B), or groups of g rows (R, B/g); as a view of g-row
        # groups the matrix and lambda take one index for both
        draw = torch.stack([_draw_batch(cfg, step_generator(seed, t, dev),
                                        l_s, g, dev) for seed in state.seeds])
        lg = l_s // g
        rows = packed[:l_s].view(lg, g * w)[draw].view(r, b, w)
        lamb_rows = lamb[:, :l_s].view(r, lg, g * k, 2)
        lamb_init = lamb_rows[reps, draw].view(r, b, k, 2) if warm else None
        if impl == "pallas":
            new_lamb_b, gamma_stat = step_core_packed(
                cfg, gamma, rows, lamb_b=lamb_init,
                gen=[step_generator(seed, t, dev, SUB_TAG)
                     for seed in state.seeds])
        elif impl == "dense":
            new_lamb_b, gamma_stat = step_core_dense(
                cfg, gamma, unpack2bit_torch(rows, n),
                lamb_init if warm else _prior_lamb(cfg, b, dev, (r,)))
        else:
            new_lamb_b, gamma_stat = step_core_fused(cfg, gamma, rows,
                                                     lamb_init)
        if warm:
            lamb_rows[reps, draw] = new_lamb_b.view(r, b // g, g * k, 2)
        gamma = _global_update(cfg, gamma, gamma_stat, t, l_s)
        return state._replace(gamma=gamma, t=t + 1)

    return step


def make_replicate_run_chunk(cfg: SVIConfig, nsteps: int,
                             l_sample: int | None = None):
    """Runner of `nsteps` batched replicate steps (`make_replicate_step`);
    like make_run_chunk it only enqueues device work, and in the stored
    mode it consumes its input state."""
    step = make_replicate_step(cfg, l_sample)

    def run_chunk(state: ReplicateState, packed) -> ReplicateState:
        for _ in range(nsteps):
            state = step(state, packed)
        return state

    return run_chunk


def make_run_chunk(cfg: SVIConfig, nsteps: int, l_sample: int | None = None):
    """Runner of `nsteps` SVI steps. It enqueues device work only: the
    host never waits on the device inside a chunk. In the stored lambda
    mode it consumes its input state (make_step)."""
    step = make_step(cfg, l_sample)

    def run_chunk(state: SVIState, packed) -> SVIState:
        for _ in range(nsteps):
            state = step(state, packed)
        return state

    return run_chunk


def entry_loglik(gamma, lamb, ind_idx, snp_idx, x, form="plugin"):
    """Mean per-entry predictive log-likelihood of an entry set from the
    stored lambda (the stored mode's scorer). form: "plugin" or
    "variational" (models/psd.predictive_loglik). Returns a 0-d tensor."""
    return psd.predictive_loglik(gamma, lamb, ind_idx, snp_idx, x,
                                 form=form).mean()


def make_entry_loglik_recompute(cfg: SVIConfig, eval_rows, row_of_entry,
                                ind_idx, x, *, device):
    """Eval scorer for the 'local' lambda mode.

    eval_rows (S, W) packed rows of the distinct eval SNPs (the training
    matrix: eval entries are MISSING there); row_of_entry (M,) maps each
    entry to its row. Returns gamma -> mean log-lik (a 0-d tensor), which
    re-solves those SNPs' lambdas from the current gamma. Inputs move to
    the device once.

    gamma may be stacked (R, N, K) (batched replicates): the returned
    function then gives (R,) log-liks, the lambdas of all R re-solved at
    once (K4 with its replicate axis), each replicate's score taken on
    its own slice as a single fit's is (so bitwise the single scorer's
    where the column subsample does not engage: its seed, cfg.seed's, is
    shared by the replicates, as in the reference's batched scorer).
    """
    from terastructure_tpu_torch.svi.postprocess import solve_lambda_blocks

    if not isinstance(eval_rows, torch.Tensor):
        eval_rows = torch.as_tensor(np.asarray(eval_rows))
    eval_rows = eval_rows.to(device)
    row_of_entry = torch.as_tensor(np.asarray(row_of_entry)).long().to(device)
    ind_idx = torch.as_tensor(np.asarray(ind_idx)).long().to(device)
    x = torch.as_tensor(np.asarray(x)).to(device)
    w = eval_rows.shape[1]
    # Fixed subsample seed: eval scores stay deterministic across checks
    # (the column subsample engages only when N is large).
    sub_seed = cfg.seed ^ 0xE7A1

    def score(gamma, lamb_eval):
        if cfg.predictive == "variational":
            return psd.variational_predictive_loglik(
                gamma[ind_idx], lamb_eval[row_of_entry], x).mean()
        beta = psd.beta_mean(lamb_eval)
        th = psd.theta_mean(gamma[ind_idx])
        p = (th * beta[row_of_entry]).sum(-1)
        return psd.binomial2_loglik(x, p).mean()

    def f(gamma):
        u = pad_individuals(ops.exp_elog_theta(gamma), w)
        lamb_eval = solve_lambda_blocks(cfg, u, eval_rows, block=1024,
                                        sub_seed=sub_seed)
        if gamma.dim() == 3:
            return torch.stack([score(g, lm)
                                for g, lm in zip(gamma, lamb_eval)])
        return score(gamma, lamb_eval)

    return f
