"""No-U-Turn Sampler: iterative multinomial NUTS over a batch of chains
(port of terastructure_tpu/mcmc/nuts.py).

The dynamic-trajectory HMC of Hoffman & Gelman (2014) with the
multinomial state sampling and generalized U-turn criterion of Betancourt
(2017), in the iterative formulation (O(max_depth) memory, no
recursion). The reference runs it as nested `lax.while_loop`s under
`vmap`, where a chain whose loop has ended stops changing while the
others run on. Here every chain's state is a row of (C, ...) tensors,
each loop is a host loop that runs while any chain is active, and a
chain's per-chain `active` mask freezes it once its own loop would have
ended: one `.any()` sync a leaf and one a doubling. Every chain of a
transition doubles in step (depth d for all chains still going), so the
leaf index is a host integer; the leaf step reads its checkpoint slots
from a device table and tests every slot under a mask, so that it has
one shape at every leaf and runs as one CUDA graph on a card.

Dtypes are the reference's: momenta, positions and gradients in the
parameter dtype (float32); energies, log-weights and the acceptance sum
in the log-density's dtype (float64 when the potential sums in float64).
A non-finite energy is a divergence. Warmup (dual averaging + Welford
mass) reuses mcmc/hmc.py.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import torch

from terastructure_tpu_torch.mcmc import chains
from terastructure_tpu_torch.mcmc.hmc import (
    SampleSink, StepGraph, Target, TorchDraws, _sync, as_generator,
    chain_start, da_init, da_update, gather_samples, kinetic, samples_dict,
    stack_chains, warmup_windows, welford_init, welford_update,
    welford_variance)


class _Point(NamedTuple):
    """One end (or the proposal) of each chain's trajectory: qpg stacks
    position, momentum and gradient, (C, 3, dim); lp is log p, (C,)."""
    qpg: torch.Tensor
    lp: torch.Tensor


def _select(mask, a: _Point, b: _Point) -> _Point:
    """a where the per-chain mask holds, else b."""
    return _Point(torch.where(mask[:, None, None], a.qpg, b.qpg),
                  torch.where(mask, a.lp, b.lp))


def _dot(a, b):
    """Row-wise dot in the inputs' dtype (elementwise products and a sum:
    no tensor-core matmul)."""
    return torch.sum(a * b, dim=-1)


def _is_turning(inv_mass, p_left, p_right, p_sum):
    """Generalized U-turn criterion on a subtree (Betancourt App. A.4.2)."""
    v_left = inv_mass * p_left
    v_right = inv_mass * p_right
    s = p_sum - 0.5 * (p_left + p_right)
    return (_dot(v_left, s) <= 0) | (_dot(v_right, s) <= 0)


def _leaf_to_ckpt(n: int):
    """Leaf index -> (idx_min, idx_max), the checkpoint range to test.

    idx_max = popcount(n >> 1); the number of complete subtrees ending at
    leaf n equals the count of trailing one-bits of n."""
    idx_max = bin(n >> 1).count("1")
    trailing = 0
    while (n >> trailing) & 1:
        trailing += 1
    return idx_max - trailing + 1, idx_max


def _iterative_turning(inv_mass, p, p_sum, p_ckpts, psum_ckpts, in_range):
    """U-turns of the current leaf against every checkpointed subtree start
    in `in_range` (a mask over the checkpoint slots, (max_depth + 1,)):
    the reference tests idx_max down to idx_min and stops at the first;
    the OR over the range is the same. p_ckpts, psum_ckpts: (C,
    max_depth + 1, dim); every slot is evaluated, so the step has one
    shape at every leaf."""
    sub_psum = p_sum[:, None] - psum_ckpts + p_ckpts
    turning = _is_turning(inv_mass[:, None], p_ckpts, p[:, None], sub_psum)
    return torch.any(turning & in_range, dim=-1)


def _leaf_table(max_depth: int, device) -> torch.Tensor:
    """For each leaf of a subtree of at most 2^(max_depth-1) leaves: [even,
    checkpoint slot, lo, hi]: an even leaf writes its slot (popcount(n >>
    1)), an odd one tests the slots lo..hi (_leaf_to_ckpt); lo > hi tests
    none."""
    rows = []
    for n in range(2 ** max(max_depth - 1, 0)):
        if n % 2 == 0:
            rows.append([1, bin(n >> 1).count("1"), 1, 0])
        else:
            rows.append([0, 0, *_leaf_to_ckpt(n)])
    return torch.tensor(rows, dtype=torch.int64, device=device)


def nuts_kernel(target: Target, max_depth: int = 8,
                max_delta_energy: float = 1000.0,
                split: chains.ChainSplit | None = None):
    """One NUTS transition for every chain.

    kernel(draws, q, eps, inv_mass) -> (q, info): q (C, dim), eps one per
    chain, inv_mass (C, dim) or (dim,); info holds per-chain tensors
    accept_prob, num_steps, diverging, depth and log_prob. The subtrees
    reuse one `_Subtree` (its leaf step captured once on a card). split:
    this rank's share of the chains over ranks; its global OR ends each
    loop when no chain on any rank is active (None: one rank)."""

    split = split or chains.ChainSplit(0)
    trees = {}

    def kernel(draws, q0, eps, inv_mass):
        dev = q0.device
        c, dim = q0.shape
        eps = torch.as_tensor(eps, device=dev).to(q0.dtype).expand(c)
        lp0, g0 = target.value_and_grad(q0)
        edt = lp0.dtype
        if "tree" not in trees:
            trees["tree"] = _Subtree(target, q0, edt, max_depth,
                                     max_delta_energy, split)
        tree = trees["tree"]
        p0 = draws.momentum((c, dim), q0.dtype, dev) / torch.sqrt(inv_mass)
        init = _Point(torch.stack([q0, p0, g0], 1), lp0)
        h0 = -lp0 + kinetic(p0, inv_mass)

        left = right = proposal = init
        log_w = torch.zeros(c, dtype=edt, device=dev)
        p_sum = p0
        depth = torch.zeros(c, dtype=torch.int64, device=dev)
        turning = torch.zeros(c, dtype=torch.bool, device=dev)
        diverging = torch.zeros(c, dtype=torch.bool, device=dev)
        sum_acc = torch.zeros(c, dtype=edt, device=dev)
        num_steps = torch.zeros(c, dtype=torch.int64, device=dev)

        for d in range(max_depth):
            active = ~turning & ~diverging
            if not split.any(active):
                break
            forward = draws.direction((c,), dev)
            eps_d = torch.where(forward, eps, -eps)[:, None]
            start = _select(forward, right, left)
            sub = tree.build(draws, start, eps_d, 2**d, active, h0, inv_mass)
            u = draws.merge_uniform((c,), edt, dev)
            new_left = _select(forward, left, sub["state"])
            new_right = _select(forward, sub["state"], right)
            sub_ok = ~(sub["turning"] | sub["diverging"])
            # biased progressive sampling between the old tree and the new
            # subtree
            take_new = (torch.log(u) < sub["log_w"] - log_w) & sub_ok
            p_sum_new = p_sum + sub["p_sum"]
            turning_full = _is_turning(inv_mass, new_left.qpg[:, 1],
                                       new_right.qpg[:, 1], p_sum_new)
            proposal = _select(active & take_new, sub["proposal"], proposal)
            log_w = torch.where(active & sub_ok,
                                torch.logaddexp(log_w, sub["log_w"]), log_w)
            left = _select(active, new_left, left)
            right = _select(active, new_right, right)
            p_sum = torch.where(active[:, None], p_sum_new, p_sum)
            depth = depth + active.long()
            turning = torch.where(
                active, sub["turning"] | (sub_ok & turning_full), turning)
            diverging = torch.where(active, sub["diverging"], diverging)
            sum_acc = torch.where(active, sum_acc + sub["sum_acc"], sum_acc)
            num_steps = num_steps + torch.where(active, sub["leaves"], 0)

        accept_prob = sum_acc / torch.clamp(num_steps.to(torch.float32),
                                            min=1.0)
        return proposal.qpg[:, 0], {
            "accept_prob": accept_prob,
            "num_steps": num_steps,
            "diverging": diverging,
            "depth": depth,
            "log_prob": proposal.lp,
        }

    return kernel


class _Subtree:
    """A subtree's state for every chain on static buffers, and its leaf
    step (`hmc.StepGraph`: a CUDA graph on a card). The host loop draws
    the leaf's uniform, points the step at the leaf's checkpoint slots and
    runs it while any chain is active (on any rank: `split.any`): one
    sync a leaf."""

    def __init__(self, target, q, edt, max_depth, max_delta_energy, split):
        c, dim = q.shape
        dev, dt = q.device, q.dtype

        def z(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.target, self.max_delta_energy = target, max_delta_energy
        self.split = split
        self.qpg, self.pr_qpg = z(c, 3, dim), z(c, 3, dim)
        self.lp, self.pr_lp = z(c, dtype=edt), z(c, dtype=edt)
        self.log_w, self.sum_acc = z(c, dtype=edt), z(c, dtype=edt)
        self.h0, self.u = z(c, dtype=edt), z(c, dtype=edt)
        self.p_sum, self.step_, self.inv_mass = z(c, dim), z(c, dim), z(c, dim)
        self.half = z(c, 1)
        self.p_ckpts = z(c, max_depth + 1, dim)
        self.psum_ckpts = z(c, max_depth + 1, dim)
        self.leaves = z(c, dtype=torch.int64)
        self.turning, self.diverging = z(c, dtype=torch.bool), z(
            c, dtype=torch.bool)
        self.active0, self.act = z(c, dtype=torch.bool), z(c, dtype=torch.bool)
        self.table = _leaf_table(max_depth, dev)
        self.ctrl = self.table[0].clone()
        self.slots = torch.arange(max_depth + 1, device=dev)
        self.leaf = StepGraph(self._leaf, dev)

    def _leaf(self):
        act = self.act
        m = act[:, None]
        p = self.qpg[:, 1] + self.half * self.qpg[:, 2]
        q = self.qpg[:, 0] + self.step_ * p
        lp, g = self.target.value_and_grad(q)
        p = p + self.half * g
        new = torch.stack([q, p, g], 1)
        dh = -lp + kinetic(p, self.inv_mass) - self.h0    # > 0: worse
        finite = torch.isfinite(dh)
        # non-finite energies are divergences
        div = ~finite | (dh > self.max_delta_energy)
        log_w_leaf = torch.where(finite, -dh, -torch.inf)
        log_w_new = torch.logaddexp(self.log_w, log_w_leaf)
        # progressive multinomial: take the leaf w.p. w_leaf / w_total
        take = torch.log(self.u) < log_w_leaf - log_w_new
        acc = torch.where(finite, torch.exp(torch.clamp(-dh, max=0.0)), 0.0)
        p_sum_new = self.p_sum + p
        # an odd leaf tests the checkpoints lo..hi, an even one writes its
        # slot
        lo, hi = self.ctrl[2], self.ctrl[3]
        turn = _iterative_turning(self.inv_mass, p, p_sum_new, self.p_ckpts,
                                  self.psum_ckpts,
                                  (self.slots >= lo) & (self.slots <= hi))
        idx = self.ctrl[1:2]
        write = m & (self.ctrl[0] == 1)
        for ck, val in ((self.p_ckpts, p), (self.psum_ckpts, p_sum_new)):
            old = ck.index_select(1, idx)[:, 0]
            ck.index_copy_(1, idx, torch.where(write, val, old)[:, None])
        self.qpg.copy_(torch.where(act[:, None, None], new, self.qpg))
        self.lp.copy_(torch.where(act, lp, self.lp))
        tk = act & take
        self.pr_qpg.copy_(torch.where(tk[:, None, None], new, self.pr_qpg))
        self.pr_lp.copy_(torch.where(tk, lp, self.pr_lp))
        self.log_w.copy_(torch.where(act, log_w_new, self.log_w))
        self.sum_acc.copy_(torch.where(act, self.sum_acc + acc, self.sum_acc))
        self.p_sum.copy_(torch.where(m, p_sum_new, self.p_sum))
        self.leaves.add_(act.long())
        self.turning.copy_(torch.where(act, turn, self.turning))
        self.diverging.copy_(torch.where(act, div, self.diverging))
        self.act.copy_(self.active0 & ~self.turning & ~self.diverging)

    def build(self, draws, start: _Point, eps_d, n_leaves: int, active0, h0,
              inv_mass):
        """Up to n_leaves leapfrog steps from `start` in each chain's
        direction, with progressive multinomial sampling and iterative
        U-turn checks. A chain steps while it is in active0 and has neither
        turned nor diverged. Returns views of the buffers, valid until the
        next build."""
        c = start.qpg.shape[0]
        edt = h0.dtype
        for buf, val in ((self.qpg, start.qpg), (self.pr_qpg, start.qpg),
                         (self.lp, start.lp), (self.pr_lp, start.lp),
                         (self.h0, h0), (self.active0, active0),
                         (self.act, active0), (self.half, 0.5 * eps_d),
                         (self.step_, eps_d * inv_mass),
                         (self.inv_mass, inv_mass.expand(self.p_sum.shape))):
            buf.copy_(val)
        self.log_w.fill_(-torch.inf)
        for buf in (self.sum_acc, self.p_sum, self.p_ckpts, self.psum_ckpts,
                    self.leaves, self.turning, self.diverging):
            buf.zero_()
        for leaf in range(n_leaves):
            if not self.split.any(self.act):
                break
            self.u.copy_(draws.leaf_uniform((c,), edt, self.u.device))
            self.ctrl.copy_(self.table[leaf])
            self.leaf()
        return dict(state=_Point(self.qpg, self.lp),
                    proposal=_Point(self.pr_qpg, self.pr_lp),
                    log_w=self.log_w, p_sum=self.p_sum, turning=self.turning,
                    diverging=self.diverging, sum_acc=self.sum_acc,
                    leaves=self.leaves)


def run_nuts(
    key,
    log_prob: Callable,
    init_params,
    *,
    n_samples: int,
    n_warmup: int = 500,
    max_depth: int = 8,
    init_eps: float = 0.1,
    target_accept: float = 0.8,
    n_chains: int = 1,
    shard_chains: bool = True,
    inv_mass0=None,
    dispatch_chunk: int = 100,
):
    """Run NUTS chains (a leading chain axis when n_chains > 1).

    key: an int seed or a torch.Generator on the parameters' device.
    Returns (samples dict of host numpy arrays with leading (chains,
    samples), or (samples,) for one chain, diagnostics). inv_mass0:
    optional diagonal preconditioner dict (no chain axis, e.g.
    potential.svi_informed_inits' q-variances) used through warmup phases
    1-2 and as the Welford shrinkage target in phase 3. Samples are copied
    to the host every `dispatch_chunk` transitions. The diagnostics add,
    beyond the reference's, the seconds of warmup and of sampling and the
    leapfrog steps of each (all chains).

    In a process group (shard_chains), the chains are split over the
    ranks (mcmc/chains.py): each rank integrates its own, the loops end
    on a global OR, and every rank returns every chain's samples and
    step size and the diagnostics over all chains ("draws": this rank's
    generator calls, equal on every rank holding chains).
    """
    vmapped = n_chains > 1
    split = chains.split(n_chains, shard_chains)
    if not split.holds:
        return split.idle()
    target, q, im0 = chain_start(log_prob, split.local(init_params),
                                 n_chains, inv_mass0)
    dev = q.device
    draws = split.draws(TorchDraws(as_generator(key, dev)))
    kernel = nuts_kernel(target, max_depth=max_depth, split=split)
    c = q.shape[0]
    steps = {"warmup": 0, "sample": 0}
    t0 = time.time()

    def warm(q, da, wf, inv_mass, n):
        for _ in range(n):
            q, info = kernel(draws, q, torch.exp(da.log_eps), inv_mass)
            da = da_update(da, info["accept_prob"], target=target_accept)
            wf = welford_update(wf, q)
            steps["warmup"] += int(info["num_steps"].sum())
        return q, da, wf

    n1, n2, n3 = warmup_windows(n_warmup)
    inv_mass = im0.expand(c, -1)
    da = da_init(torch.full((c,), float(init_eps), dtype=torch.float64,
                            device=dev))
    q, da, _ = warm(q, da, welford_init(q), inv_mass, n1)
    q, da, wf = warm(q, da, welford_init(q), inv_mass, n2)
    inv_mass = welford_variance(wf, prior=None if inv_mass0 is None else im0)
    q, da, _ = warm(q, da_init(torch.exp(da.log_eps)), welford_init(q),
                    inv_mass, n3)
    eps = torch.exp(da.log_eps_avg)
    _sync(dev)
    t1 = time.time()

    sink = SampleSink(dispatch_chunk)
    accs, divs = [], []
    for _ in range(n_samples):
        q, info = kernel(draws, q, eps, inv_mass)
        sink.add(q)
        accs.append(info["accept_prob"])
        divs.append(info["diverging"])
        steps["sample"] += int(info["num_steps"].sum())
    samples = samples_dict(target, gather_samples(split, sink), vmapped)
    sample_s = time.time() - t1
    eps_out = split.gather(eps).cpu().numpy()
    return split.share((samples, {
        "accept_rate": float(stack_chains(split, accs).mean()),
        "divergence_rate": float(stack_chains(split, divs).float().mean()),
        "eps": eps_out if vmapped else eps_out[0],
        "warmup_s": t1 - t0,
        "sample_s": sample_s,
        "leapfrog_warmup": split.sum_int(steps["warmup"]),
        "leapfrog_sample": split.sum_int(steps["sample"]),
        "draws": draws.calls,
    }))
