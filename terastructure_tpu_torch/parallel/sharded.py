"""The sharded SVI step over the (ind x snp) grid of ranks (port of
terastructure_tpu/parallel/sharded.py).

Dataflow, on rank (i, s) with gamma shard i and SNP/lambda shard s:

  - draw B_local SNPs from the local padded SNP range: the draw depends on
    (seed, t, s) only, so every rank of an ind group draws the same rows;
  - gather the local (B_local, W_local) block of packed rows;
  - the local phi <-> lambda coordinate ascent, each pass's lambda
    statistics all-reduced over the ind group between kernel launches
    (the ind_reduce hook of the solves): every rank of the group sees the
    same sums, so the same tol test and Aitken tail, with no host read;
  - the gamma statistic all-reduced over the snp group (each shard's
    minibatch covers only its SNPs);
  - scatter lambda into the local lambda shard (stored mode) and update
    the local gamma shard. No other communication.

No kernel holds a collective: each runs on the shard's shapes and the
all-reduces sit between launches.

Sampling from the padded range keeps the estimator unbiased: padding SNPs
are all MISSING, and the L/B scale uses the padded L.

The draws: the row draw comes from engine.step_generator(seed, t, "cpu",
s), the CPU generator, so that the host replays it bit for bit for the
sharded stream (parallel/stream.py); the column subsample of the big-N
passes from step_generator(seed, t, device, s, i, SUB_TAG), the
reference's fold_in(fold_in(kb, i), 0x5B). Torch's generators are not
threefry: tests inject rows and columns into both packages.

Requirements: N padded to 4 * ind (512 * ind where a kernel is reachable:
each shard's byte width a multiple of 128), L padded to a multiple of
snp; `make_plan` and `prepare` do both.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from terastructure_tpu_torch.config import SVIConfig
from terastructure_tpu_torch.data.dataset import GenotypeData
from terastructure_tpu_torch.data.pack import packed_width, unpack2bit_torch
from terastructure_tpu_torch.ops import fused_step
from terastructure_tpu_torch.ops import stats_dense as ops
from terastructure_tpu_torch.ops import stats_packed as pk
from terastructure_tpu_torch.ops.gather import gather_row_blocks
from terastructure_tpu_torch.parallel.mesh import IND_AXIS, SNP_AXIS
from terastructure_tpu_torch.svi import engine
from terastructure_tpu_torch.svi.engine import SVIState


class ShardPlan(NamedTuple):
    """Static padded shapes for an even 2-D sharding."""
    n: int            # real individuals
    l: int            # real SNPs
    n_padded: int     # multiple of 4 * ind (512 * ind where kernels run)
    l_padded: int     # multiple of snp
    ind: int
    snp: int
    batch_per_shard: int

    @property
    def l_local(self) -> int:
        return self.l_padded // self.snp

    @property
    def w_local(self) -> int:
        return packed_width(self.n_padded) // self.ind


def _kernel_reachable(cfg: SVIConfig) -> bool:
    """Whether a kernel (or its twin) can run: every kernel name but
    "dense", on the card and on the CPU alike, as engine._resolve_kernel
    resolves "auto" to the fused solve everywhere."""
    return cfg.kernel in ("fused", "pallas", "auto")


def make_plan(cfg: SVIConfig, mesh) -> ShardPlan:
    """The padded shapes of a fit over `mesh` (a Mesh or a MeshSpec)."""
    ind, snp = mesh.shape[IND_AXIS], mesh.shape[SNP_AXIS]
    if cfg.batch_size % snp:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by snp "
                         f"axis {snp}")
    # Where a kernel is reachable, pad N so each shard's byte width is a
    # multiple of 128 (the fused gate and the pass tiles need it; padding
    # individuals decode as MISSING). The dense path keeps the 4 * ind
    # byte-alignment quantum.
    quantum = 512 * ind if _kernel_reachable(cfg) else 4 * ind
    n_padded = -(-cfg.n // quantum) * quantum
    l_padded = -(-cfg.l // snp) * snp
    return ShardPlan(n=cfg.n, l=cfg.l, n_padded=n_padded, l_padded=l_padded,
                     ind=ind, snp=snp, batch_per_shard=cfg.batch_size // snp)


def block_bounds(plan: ShardPlan, mesh):
    """(rows, cols) of rank (i, s)'s block of the padded packed matrix:
    rows [s L_local, (s + 1) L_local), byte columns [i W_local,
    (i + 1) W_local)."""
    return ((mesh.s * plan.l_local, (mesh.s + 1) * plan.l_local),
            (mesh.i * plan.w_local, (mesh.i + 1) * plan.w_local))


def local_block(plan: ShardPlan, mesh, data: GenotypeData) -> np.ndarray:
    """This rank's (L_local, W_local) block as a host array: cut out of
    data.packed, the whole matrix or a block of it at (snp_row_offset,
    byte_col_offset) (multihost.load_bed_shard). Padding rows and columns
    are 0xFF (MISSING). Raises where data.packed does not cover the
    block's real rows and columns."""
    (r0, r1), (c0, c1) = block_bounds(plan, mesh)
    src = data.packed
    sr0, sc0 = data.snp_row_offset, data.byte_col_offset
    need_r = (r0, min(r1, data.l))
    need_c = (c0, min(c1, packed_width(data.n)))
    have_r = (sr0, sr0 + src.shape[0])
    have_c = (sc0, sc0 + src.shape[1])
    out = np.full((plan.l_local, plan.w_local), 0xFF, dtype=np.uint8)
    if need_r[1] <= need_r[0] or need_c[1] <= need_c[0]:
        return out                            # a block of padding only
    if (have_r[0] > need_r[0] or have_r[1] < need_r[1]
            or have_c[0] > need_c[0] or have_c[1] < need_c[1]):
        raise ValueError(
            f"the host matrix covers rows {have_r} and byte columns "
            f"{have_c}, rank {mesh.rank} needs rows {need_r} and columns "
            f"{need_c}: load the block multihost.load_bed_shard reads")
    out[: need_r[1] - r0, : need_c[1] - c0] = src[
        need_r[0] - sr0: need_r[1] - sr0, need_c[0] - sc0: need_c[1] - sc0]
    return out


def prepare(cfg: SVIConfig, data: GenotypeData, mesh):
    """(plan, this rank's packed block (L_local, W_local) uint8 on
    mesh.device). Padding individuals and SNPs are 0xFF (MISSING)."""
    plan = make_plan(cfg, mesh)
    return plan, torch.from_numpy(local_block(plan, mesh, data)).to(
        mesh.device)


def _local_rows(plan: ShardPlan, mesh) -> slice:
    n_local = plan.n_padded // plan.ind
    return slice(mesh.i * n_local, (mesh.i + 1) * n_local)


def init_sharded_state(cfg: SVIConfig, plan: ShardPlan, mesh) -> SVIState:
    """engine.init_state at the padded shapes, this rank's shards: the
    whole (n_padded, K) gamma is drawn on the CPU from cfg.seed (as
    engine.init_state draws its (N, K)) and the rank keeps its rows, so
    rows < n are the single-device init's whatever the grid. lambda: this
    rank's (L_local, K, 2) rows at the prior."""
    gen = torch.Generator().manual_seed(cfg.seed)
    gamma = (cfg.alpha_value + cfg.gamma_init_scale
             * torch.rand((plan.n_padded, cfg.k), generator=gen))
    lamb = engine._prior_lamb(cfg, plan.l_local, mesh.device)
    return SVIState(gamma=gamma[_local_rows(plan, mesh)].to(mesh.device),
                    lamb=lamb, t=0, seed=cfg.seed)


def shard_state(state: SVIState, plan: ShardPlan, mesh) -> SVIState:
    """This rank's shards of a whole state (a restored checkpoint, a text
    model): gamma and lambda padded with ones to the padded shapes, as
    the reference pads them, and cut to the rank's rows."""
    gamma, lamb = state.gamma.cpu(), state.lamb.cpu()
    if gamma.shape[0] != plan.n_padded:
        gamma = torch.cat([gamma, gamma.new_ones(
            (plan.n_padded - gamma.shape[0], gamma.shape[1]))])
    if lamb.shape[0] != plan.l_padded:
        lamb = torch.cat([lamb, lamb.new_ones(
            (plan.l_padded - lamb.shape[0],) + tuple(lamb.shape[1:]))])
    rows = slice(mesh.s * plan.l_local, (mesh.s + 1) * plan.l_local)
    return SVIState(gamma=gamma[_local_rows(plan, mesh)].to(mesh.device),
                    lamb=lamb[rows].contiguous().to(mesh.device),
                    t=state.t, seed=state.seed)


def gather_state(state: SVIState, mesh, *, lamb: bool = True):
    """The whole padded state on the lead rank (None elsewhere): gamma
    gathered over the lead's ind group (the ranks with s = 0 take part),
    lambda over its snp group (i = 0) where `lamb`. Collective: every
    rank calls it."""
    gamma = (mesh.gather(state.gamma, mesh.ind_ranks(0), mesh.ind_group,
                         state.gamma.shape[0] * mesh.spec.ind)
             if mesh.s == 0 else None)
    lam = (mesh.gather(state.lamb, mesh.snp_ranks(0), mesh.snp_group,
                       state.lamb.shape[0] * mesh.spec.snp)
           if lamb and mesh.i == 0 else None)
    if not mesh.lead:
        return None
    return SVIState(gamma=gamma, lamb=lam, t=state.t, seed=state.seed)


class KernelPlan(NamedTuple):
    """The static kernel and sampling choice of a sharded step, shared by
    the resident step and the host sampler of the stream, which must draw
    what the resident step draws."""
    want_fused: bool
    use_pk: bool            # the per-iteration kernels (K8/K4, K7/K4+K5)
    dma_blocks: bool        # the minibatch as B_local/8 8-row blocks (K3)
    wl: int                 # the shard's byte width


def _tiles_fit(b: int, w: int) -> bool:
    """The reference's pick_tiles succeeds: a row tile of 8..256 divides b
    and a column tile of 128..512 divides w. The port's kernels need no
    tiles; the rule only decides the path, as in the reference."""
    return b % 8 == 0 and w % 128 == 0


def plan_kernels(cfg: SVIConfig, plan: ShardPlan) -> KernelPlan:
    """The reference's plan_kernels with "auto" resolved as the port
    resolves it everywhere: the fused solve where its gate passes."""
    if cfg.kernel == "fused" and plan.ind > 1:
        raise ValueError(
            "kernel='fused' runs the whole local coordinate ascent inside "
            "one kernel sequence and cannot all-reduce over a sharded 'ind' "
            f"axis; this mesh has ind={plan.ind}. Keep 'ind' for hosts and "
            "shard cards over 'snp', or use kernel='auto'/'pallas'/'dense', "
            "which all-reduce each pass")
    wl = plan.w_local
    b_local = plan.batch_per_shard
    l_local = plan.l_local
    want_fused = plan.ind == 1 and cfg.kernel in ("fused", "auto")
    if want_fused and cfg.kernel == "auto":
        want_fused = fused_step.supports(
            b_local, wl, cfg.k, getattr(torch, cfg.compute_dtype),
            accel=cfg.local_accel)
    use_pk = _tiles_fit(b_local, wl) and _kernel_reachable(cfg)
    dma_blocks = bool(cfg.dma_gather and use_pk and not want_fused
                      and l_local >= cfg.dma_gather_min_l
                      and l_local % 8 == 0 and b_local % 128 == 0)
    return KernelPlan(want_fused=want_fused, use_pk=use_pk,
                      dma_blocks=dma_blocks, wl=wl)


def draw_rows(plan: ShardPlan, kp: KernelPlan, seed: int, t: int, s: int):
    """Step t's minibatch of SNP shard s, from the CPU generator
    step_generator(seed, t, "cpu", s): (blocks (B_local/8,) int32 or None,
    idx (B_local,) int32 local row indices). With replacement, as the
    reference's randint; B_local/8 uniform 8-row blocks under dma_blocks."""
    gen = engine.step_generator(seed, t, "cpu", s)
    b_local = plan.batch_per_shard
    if kp.dma_blocks:
        blocks = torch.randint(0, plan.l_local // 8, (b_local // 8,),
                               generator=gen, dtype=torch.int32)
        idx = (blocks[:, None] * 8
               + torch.arange(8, dtype=torch.int32)).reshape(b_local)
        return blocks, idx
    return None, torch.randint(0, plan.l_local, (b_local,), generator=gen,
                               dtype=torch.int32)


def _build_step_parts(cfg: SVIConfig, plan: ShardPlan, mesh):
    """The per-rank closures every sharded runner composes:
    (sample_gather, stats_from_rows, apply_gamma, psum_gamma).

    Kernel choice per shard: with 'ind' unsharded the lambda statistics
    need no reduction, so the fused solve (K1) applies whole where its
    gate passes; otherwise the per-iteration kernels with the
    all-reduce over 'ind' between launches (K8 on the column subsample
    or K4, then K7 or K4 + K5), or the dense path where the tile rule
    fails or kernel="dense". lambda_mode "local" skips the stored lambda
    gather and scatter.

    The gamma all-reduce over 'snp' is not inside stats_from_rows:
    callers put psum_gamma between stats_from_rows and apply_gamma, so the
    chunk runner can overlap it with the next step's gather.
    """
    kp = plan_kernels(cfg, plan)
    b_local = plan.batch_per_shard
    wl = kp.wl
    dtype = getattr(torch, cfg.compute_dtype)
    local_mode = cfg.lambda_mode == "local"
    dev = mesh.device
    reduce_ind = mesh.reduce_ind if plan.ind > 1 else None
    # the per-shard column subsample (each ind shard takes its share; the
    # N/Ns scale is shard-independent)
    sub_w = ((cfg.local_sub_n // 4 // plan.ind) // 128) * 128
    use_sub = sub_w >= 128 and wl >= 4 * sub_w

    def prior():
        return engine._prior_lamb(cfg, b_local, dev)

    def _local_step_pk(gamma_l, lamb_l, rows, idx, t, seed, idx_w):
        u = ops.exp_elog_theta(gamma_l)                 # (4 W_l, K)
        kw = dict(beta_a=cfg.beta_a, beta_b=cfg.beta_b, dtype=dtype,
                  ind_reduce=reduce_ind)
        lamb_b = prior() if local_mode else lamb_l[idx]
        if use_sub:
            if idx_w is None:
                gen = engine.step_generator(seed, t, dev, mesh.s, mesh.i,
                                            engine.SUB_TAG)
                idx_w = torch.randperm(wl, generator=gen, device=dev)[:sub_w]
            idx_w = idx_w.to(dev, torch.long)
            rows_it = rows[:, idx_w].contiguous()
            u_it = u.reshape(wl, 4, -1)[idx_w].reshape(4 * sub_w, -1)
            if cfg.sub_decode_once:
                lamb_b = pk.local_solve_acat(
                    rows_it, u_it, lamb_b, local_iters=cfg.local_iters,
                    local_tol=cfg.local_tol, stat_scale=wl / sub_w,
                    approx_div=cfg.local_sub_approx_div,
                    accel=cfg.local_accel, **kw)
            else:
                lamb_b = pk.local_solve_packed(
                    rows_it, u_it, lamb_b, local_iters=cfg.local_iters,
                    local_tol=cfg.local_tol, stat_scale=wl / sub_w,
                    accel=cfg.local_accel, **kw)
            if cfg.local_refine_full:
                # one exact full-N pass before the final statistics
                lamb_b = pk.local_solve_packed(rows, u, lamb_b, local_iters=1,
                                               local_tol=0.0, **kw)
        else:
            lamb_b = pk.local_solve_packed(
                rows, u, lamb_b, local_iters=cfg.local_iters,
                local_tol=cfg.local_tol, accel=cfg.local_accel, **kw)
        # the final exact statistics from the converged t's (the same on
        # every rank of the ind group: the solve is in lockstep)
        t1, t0 = ops.exp_elog_beta(lamb_b)
        if cfg.stats_kernel == "fused_v2":
            # K7's lambda sums come out scaled by t; reduced as they are
            gamma_stat, l0s, l1s = pk.batch_stats_fused_v2_packed(
                rows, u, t1, t0, approx_div=cfg.stats_approx_div,
                dtype=dtype)
            if reduce_ind is not None:
                l0s, l1s = reduce_ind(l0s, l1s)
        else:
            # the pair (K4 + K5) for "pair" and "fused" alike, as the
            # reference's sharded step takes it
            u_planes = pk.u_to_planes(u)
            l0r, l1r = pk.lambda_stats_packed(rows, u_planes, t1, t0,
                                              dtype=dtype)
            if reduce_ind is not None:
                l0r, l1r = reduce_ind(l0r, l1r)
            l0s, l1s = t1 * l0r, t0 * l1r
            g = pk.gamma_stats_packed(rows, u_planes, t1, t0, dtype)
            gamma_stat = u * pk.planes_to_flat(g)
        if not local_mode:
            lamb_l[idx] = torch.stack([cfg.beta_a + l0s, cfg.beta_b + l1s],
                                      -1)
        return lamb_l, gamma_stat

    def stats_from_rows(gamma_l, lamb_l, rows, idx, t, seed, idx_w=None):
        """Everything after the minibatch gather: the local solve and the
        lambda scatter (stored mode: idx (B_local,) local rows; may be None
        in the local mode). Returns (lamb_l, gamma_stat_local), the gamma
        statistic not yet reduced over 'snp'. seed: the state's (the
        column subsample's stream); idx_w (sub_w,) injects the subsample
        instead (tests)."""
        if idx is not None:
            idx = idx.to(dev, torch.long)
        if kp.want_fused and fused_step.supports(
                b_local, rows.shape[1], cfg.k, dtype, accel=cfg.local_accel):
            new_lamb_b, gamma_stat = engine.step_core_fused(
                cfg, gamma_l, rows, None if local_mode else lamb_l[idx])
            if not local_mode:
                lamb_l[idx] = new_lamb_b
            return lamb_l, gamma_stat
        if kp.use_pk:
            return _local_step_pk(gamma_l, lamb_l, rows, idx, t, seed, idx_w)
        xb = unpack2bit_torch(rows, 4 * rows.shape[1])
        a1, a0 = ops.allele_counts(xb, torch.float32)
        u = ops.exp_elog_theta(gamma_l)
        lamb_b = ops.local_solve(
            a1, a0, u, prior() if local_mode else lamb_l[idx],
            beta_a=cfg.beta_a, beta_b=cfg.beta_b,
            local_iters=cfg.local_iters, local_tol=cfg.local_tol,
            dtype=dtype, accel=cfg.local_accel, ind_reduce=reduce_ind)
        t1, t0 = ops.exp_elog_beta(lamb_b)
        stats = ops.batch_stats(a1, a0, u, t1, t0, dtype,
                                ind_reduce=reduce_ind)
        if not local_mode:
            lamb_l[idx] = torch.stack([cfg.beta_a + stats.lam0_stat,
                                       cfg.beta_b + stats.lam1_stat], -1)
        return lamb_l, stats.gamma_stat

    def apply_gamma(gamma_l, gamma_stat, t):
        """The Robbins-Monro update from the statistic already reduced
        over 'snp' (the L/B scale at the padded L)."""
        return engine._global_update(cfg, gamma_l, gamma_stat, t,
                                     plan.l_padded)

    def sample_gather(packed_l, t, seed):
        """This shard's minibatch rows of step t: (rows (B_local, W_l),
        idx (B_local,) on the device). Depends on (seed, t, s) only, not
        on gamma or lambda, which is what lets the chunk runner gather
        step t + 1 while step t's gamma all-reduce runs."""
        blocks, idx = draw_rows(plan, kp, seed, t, mesh.s)
        idx = idx.to(dev)
        if blocks is not None:
            return gather_row_blocks(packed_l, blocks.to(dev), block=8), idx
        return packed_l[idx.long()], idx

    def psum_gamma(gamma_stat, async_op=False):
        """Start the all-reduce of the gamma statistic over 'snp' in
        cfg.gamma_psum_dtype ("bf16": each partial rounded to bf16, to
        nearest even, summed in bf16, back to f32). Returns done() ->
        the reduced f32 statistic, which waits for the collective."""
        x = (gamma_stat.to(torch.bfloat16) if cfg.gamma_psum_dtype == "bf16"
             else gamma_stat)
        work = mesh.reduce_snp(x, async_op=async_op)

        def done():
            if work is not None:
                work.wait()
            return x.float()

        return done

    return sample_gather, stats_from_rows, apply_gamma, psum_gamma


def make_sharded_step(cfg: SVIConfig, plan: ShardPlan, mesh,
                      streaming: bool = False):
    """The single sharded step: (state, packed_l) -> state, this rank's
    shards of both. For chunks prefer make_sharded_run_chunk, which
    overlaps the gamma all-reduce with the next step's gather.

    streaming=True returns (state, rows_l) -> state: the rank's minibatch
    block arrives gathered by the host (parallel/stream.py), drawn as the
    resident step draws it, so a streamed fit is bitwise the resident
    one. It requires lambda_mode="local"."""
    sample_gather, stats_from_rows, apply_gamma, psum_gamma = (
        _build_step_parts(cfg, plan, mesh))
    if streaming and cfg.lambda_mode != "local":
        raise ValueError("sharded streaming requires lambda_mode='local' "
                         "(nothing SNP-indexed to scatter back against a "
                         "host matrix)")

    def step(state: SVIState, packed_l) -> SVIState:
        t = state.t
        if streaming:
            rows, idx = packed_l, None
        else:
            rows, idx = sample_gather(packed_l, t, state.seed)
        lamb, gstat = stats_from_rows(state.gamma, state.lamb, rows, idx, t,
                                      state.seed)
        gamma = apply_gamma(state.gamma, psum_gamma(gstat)(), t)
        return state._replace(gamma=gamma, lamb=lamb, t=t + 1)

    return step


def make_sharded_run_chunk(cfg: SVIConfig, plan: ShardPlan, mesh,
                           nsteps: int, *, overlap: bool | None = None):
    """Runner of `nsteps` sharded steps: (state, packed_l) -> state.

    Pipelined (overlap, the default cfg.comm_overlap): step t + 1's
    minibatch is drawn and gathered between the start of step t's gamma
    all-reduce (async_op) and its wait before the gamma update, which
    consumes the fully reduced statistic as before: only the order of the
    launches changes, so the result is bitwise the per-step runner's.
    Under NCCL the all-reduce runs on NCCL's stream; the gather runs on
    the compute stream and reads only the packed block. overlap=False
    runs make_sharded_step nsteps times."""
    if overlap is None:
        overlap = cfg.comm_overlap
    if not overlap:
        step = make_sharded_step(cfg, plan, mesh)

        def run_chunk_plain(state: SVIState, packed_l) -> SVIState:
            for _ in range(nsteps):
                state = step(state, packed_l)
            return state

        return run_chunk_plain

    sample_gather, stats_from_rows, apply_gamma, psum_gamma = (
        _build_step_parts(cfg, plan, mesh))

    def run_chunk(state: SVIState, packed_l) -> SVIState:
        gamma, lamb, t0, seed = state.gamma, state.lamb, state.t, state.seed
        rows, idx = sample_gather(packed_l, t0, seed)
        for i in range(nsteps):
            t = t0 + i
            lamb, gstat = stats_from_rows(gamma, lamb, rows, idx, t, seed)
            done = psum_gamma(gstat, async_op=True)
            if i + 1 < nsteps:
                # the next minibatch, inside the all-reduce's latency
                rows, idx = sample_gather(packed_l, t + 1, seed)
            gamma = apply_gamma(gamma, done(), t)
        return state._replace(gamma=gamma, lamb=lamb, t=t0 + nsteps)

    return run_chunk


def make_sharded_compute_lambda(cfg: SVIConfig, plan: ShardPlan, mesh, *,
                                block: int = 512):
    """The sharded compute-beta core: the converged lambda of every SNP
    row of this rank's shard.

    The post-pass (svi/postprocess.compute_lambda, the reference's
    `-compute-beta`) re-solves each SNP's lambda with theta frozen. Each
    rank solves its local rows in blocks; the individual sums are
    all-reduced over 'ind' every pass (t-scaled: t is the same on every
    rank of the group), so the solve stays in lockstep. K4 where the tile
    rule passes and a kernel is reachable, else the dense statistics.

    Returns fn(gamma_l, packed_l) -> lamb_l (L_local, K, 2)."""
    wl = plan.w_local
    l_local = plan.l_local
    blk = min(block, l_local)
    dtype = getattr(torch, cfg.compute_dtype)
    use_pk = _tiles_fit(blk, wl) and _kernel_reachable(cfg)
    reduce_ind = mesh.reduce_ind

    def fn(gamma_l, packed_l):
        dev = packed_l.device
        u = ops.exp_elog_theta(gamma_l)                 # (4 W_l, K)
        u_planes = pk.u_to_planes(u)
        lamb0 = engine._prior_lamb(cfg, blk, dev)

        def stats(rows, t1, t0):
            if use_pk:
                l0, l1 = pk.lambda_stats_packed(rows, u_planes, t1, t0,
                                                dtype=dtype)
                l0, l1 = t1 * l0, t0 * l1
            else:
                a1, a0 = ops.allele_counts(unpack2bit_torch(rows, 4 * wl))
                l0, l1 = ops.lambda_stats(a1, a0, u, t1, t0, dtype)
            return reduce_ind(l0, l1)

        def iterate_on(rows):
            def iterate(lam):
                t1, t0 = ops.exp_elog_beta(lam)
                l0, l1 = stats(rows, t1, t0)
                return torch.stack([cfg.beta_a + l0, cfg.beta_b + l1], -1)
            return iterate

        outs = []
        for lo in range(0, l_local, blk):
            rows = packed_l[lo: lo + blk]
            if rows.shape[0] < blk:
                rows = torch.cat([rows, rows.new_full(
                    (blk - rows.shape[0], wl), 0xFF)])
            iterate = iterate_on(rows)
            lam = ops.solve_schedule(iterate, lamb0,
                                     local_iters=cfg.local_iters,
                                     local_tol=cfg.local_tol,
                                     accel=cfg.local_accel)
            # the final exact update from the converged t's
            outs.append(iterate(lam))
        return torch.cat(outs)[:l_local]

    return fn
