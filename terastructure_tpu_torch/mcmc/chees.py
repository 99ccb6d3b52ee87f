"""ChEES-HMC: adaptive HMC over many chains (port of
terastructure_tpu/mcmc/chees.py).

Hoffman, Radul & Sountsov (AISTATS 2021), "An Adaptive MCMC Scheme for
Setting Trajectory Lengths in Hamiltonian Monte Carlo": run many chains
in step, integrate jittered-length leapfrog trajectories, and adapt the
trajectory length T by Adam ascent on the ChEES criterion

    ChEES(T) = (1/4) E[ (||q' - m||^2 - ||q - m||^2)^2 ],

whose per-chain stochastic gradient uses the end-of-trajectory velocity:

    g_i = (||q'_i - m||^2 - ||q_i - m||^2) * <q'_i - m, v'_i> * u

with m the cross-chain mean of the proposed states and u the shared
jitter fraction (a Halton(2) sequence). The step size adapts by dual
averaging on the cross-chain mean acceptance (target 0.651); the diagonal
mass from cross-chain and time second moments in the 3-phase window of
hmc.run_hmc.

A chunk of `dispatch_chunk` iterations fixes the leapfrog bound L_max (a
power of two of ceil(T/eps), recomputed on the host between chunks, at
most max_leapfrog); a chain masks the steps beyond its own length. The
reference compiles one program per L_max; here the trajectory is
hmc.Leapfrog's step (one CUDA graph on a card) with a per-chain step
count, looped until every chain has taken its steps (the masked steps
change nothing). Samples reach the host through hmc.SampleSink, every
`dispatch_chunk` transitions.

Over ranks (mcmc/chains.py) each rank integrates its own chains; the
cross-chain statistics (the mean acceptance, the ChEES criterion's mean
state and sums, the mass moments) are taken over every chain's values,
gathered in chain order, so every rank adapts eps, T and the mass to
the same values, those of one rank holding every chain; the trajectory
loop runs to the largest step count of any rank.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from terastructure_tpu_torch.mcmc import chains
from terastructure_tpu_torch.mcmc.hmc import (
    Leapfrog, SampleSink, TorchDraws, as_generator, chain_start, da_init,
    da_update, gather_samples, kinetic, samples_dict, stack_chains,
    warmup_windows)


def _halton2(i: np.ndarray) -> np.ndarray:
    """Base-2 Halton (van der Corput) sequence, host-side."""
    out = np.zeros(i.shape, np.float64)
    f = 0.5
    v = np.asarray(i, np.int64) + 1
    while v.max() > 0:
        out += f * (v & 1)
        v >>= 1
        f *= 0.5
    return out


def _bucket(t_now: float, eps_now: float, max_leapfrog: int) -> int:
    need = int(np.ceil(t_now / max(eps_now, 1e-12))) + 1
    b = 1
    while b < need:
        b *= 2
    return int(min(max(b, 4), max_leapfrog))


def run_chees(
    key,
    log_prob: Callable,
    init_params,
    *,
    n_samples: int,
    n_warmup: int = 500,
    n_chains: int = 16,
    init_eps: float = 0.1,
    init_traj: float = 1.0,
    target_accept: float = 0.651,
    adam_lr: float = 0.025,
    max_leapfrog: int = 1024,
    shard_chains: bool = True,
    inv_mass0=None,
    dispatch_chunk: int = 100,
    mass_floor_frac: float = 0.25,
    sample_traj_mult: float = 1.0,
):
    """Run n_chains ChEES-HMC chains.

    init_params must carry a leading chain axis of size n_chains. key: an
    int seed or a torch.Generator on the parameters' device. Returns
    (samples dict of host numpy arrays with leading (chains, samples),
    diagnostics). inv_mass0: optional diagonal preconditioner (no chain
    axis), e.g. potential.svi_informed_inits' q-variances.

    mass_floor_frac floors the warmup-estimated variance at that fraction
    of inv_mass0 (only where inv_mass0 is given); sample_traj_mult
    lengthens the frozen trajectory for the sampling phase only, clamped
    to eps * max_leapfrog (reported as traj_truncated).
    In a process group (shard_chains), the chains are split over the
    ranks and every rank returns every chain's samples
    (diagnostics["draws"]: this rank's generator calls).
    """
    if n_chains < 2:
        raise ValueError("ChEES adaptation needs >= 2 chains")
    split = chains.split(n_chains, shard_chains)
    if not split.holds:
        return split.idle()
    target, q, inv_mass = chain_start(log_prob, split.local(init_params),
                                      n_chains, inv_mass0)
    dev = q.device
    c, dim = q.shape
    draws = split.draws(TorchDraws(as_generator(key, dev)))
    lp, g = target.value_and_grad(q)
    lf = Leapfrog(target, q, lp)
    f64 = dict(dtype=torch.float64, device=dev)
    st = dict(
        da=da_init(torch.tensor(float(init_eps), **f64)),
        log_t=torch.log(torch.tensor(float(init_traj), **f64)),
        adam_m=torch.zeros((), **f64), adam_v=torch.zeros((), **f64),
        adam_i=torch.zeros((), **f64),
        msum=torch.zeros(dim, dtype=torch.float32, device=dev),
        msq=torch.zeros(dim, dtype=torch.float32, device=dev),
        mcnt=torch.zeros((), dtype=torch.float32, device=dev),
        inv_m=inv_mass)

    def one_iter(q, lp, g, u, l_max, adapt_eps, adapt_t, adapt_mass):
        """One jittered-HMC transition for all chains + adaptation."""
        da = st["da"]
        eps = torch.exp(da.log_eps).to(q.dtype)
        inv_mc = st["inv_m"].to(q.dtype)
        traj = torch.exp(st["log_t"])
        # jitter shared across chains while T adapts, per chain after
        jit = draws.uniform((c,), q.dtype, dev)
        u_chain = torch.full((c,), u, dtype=q.dtype, device=dev) \
            if adapt_t else jit
        n_steps = torch.clamp((u_chain.double() * traj / eps.double()).to(
            torch.int32), min=1)
        n_steps = torch.clamp(n_steps, max=l_max)
        p = draws.normal((c, dim), q.dtype, dev) / torch.sqrt(inv_mc)
        h0 = -lp + kinetic(p, inv_mc, lp.dtype)
        # steps beyond a chain's n_steps pass through; stop when none is left
        lf.load(q, p, g, lp, eps, inv_mc, n_steps)
        for _ in range(split.max_int(int(n_steps.max()))):
            lf.step()
        q1, p1, lp1, g1 = lf.q, lf.p, lf.lp, lf.g
        h1 = -lp1 + kinetic(p1, inv_mc, lp.dtype)
        log_acc = torch.clamp(h0 - h1, max=0.0)
        log_acc = torch.where(torch.isfinite(log_acc), log_acc, -math.inf)
        acc_prob = torch.exp(log_acc)
        accept = torch.log(draws.uniform((c,), log_acc.dtype, dev)) < log_acc
        q_new = torch.where(accept[:, None], q1, q)
        lp_new = torch.where(accept, lp1, lp)
        g_new = torch.where(accept[:, None], g1, g)

        # eps: dual averaging on the cross-chain mean acceptance
        if adapt_eps:
            st["da"] = da = da_update(da, torch.mean(split.gather(acc_prob)),
                                      target=target_accept)

        # T: Adam ascent on the ChEES gradient; divergent chains are masked
        # out of the cross-chain statistics
        if adapt_t:
            ok = torch.all(torch.isfinite(q1), dim=-1) & torch.isfinite(
                acc_prob)
            w = torch.where(ok, acc_prob, 0.0)
            q1m = torch.where(ok[:, None], q1, 0.0)
            m = torch.sum(split.gather(q1m), dim=0) / torch.clamp(
                torch.sum(split.gather(ok.long())), min=1)
            dsq = (torch.sum((q1m - m) ** 2, dim=-1)
                   - torch.sum((q - m) ** 2, dim=-1))
            v1 = inv_mc * torch.where(ok[:, None], p1, 0.0)
            dirn = torch.sum((q1m - m) * v1, dim=-1)
            w, wdd = split.gather(torch.stack([w, w * dsq * dirn], 1)
                                  ).T.contiguous()
            grad_t = (torch.sum(wdd)
                      / torch.clamp(torch.sum(w), min=1e-6)) * u
            grad_lt = grad_t * torch.exp(st["log_t"])
            grad_lt = torch.where(torch.isfinite(grad_lt), grad_lt, 0.0)
            adam_i1 = st["adam_i"] + 1.0
            m1 = 0.9 * st["adam_m"] + 0.1 * grad_lt
            v1a = 0.999 * st["adam_v"] + 0.001 * grad_lt**2
            mhat = m1 / (1.0 - 0.9**adam_i1)
            vhat = v1a / (1.0 - 0.999**adam_i1)
            log_t_new = st["log_t"] + adam_lr * mhat / (torch.sqrt(vhat)
                                                         + 1e-8)
            # keep the trajectory inside this chunk's bound
            eps_da = torch.exp(da.log_eps)
            st["log_t"] = torch.clamp(log_t_new, min=torch.log(eps_da),
                                      max=torch.log(eps_da * l_max))
            st.update(adam_m=m1, adam_v=v1a, adam_i=adam_i1)

        # mass: cross-chain + time second moments
        if adapt_mass:
            q_all = split.gather(q_new)
            st["msum"] = st["msum"] + torch.sum(q_all, dim=0)
            st["msq"] = st["msq"] + torch.sum(q_all**2, dim=0)
            st["mcnt"] = st["mcnt"] + n_chains
        return q_new, lp_new, g_new, acc_prob

    halton_i = 0
    last_l_max = 4

    def drive(q, lp, g, total, flags, sink=None):
        nonlocal halton_i, last_l_max
        accs = []
        done = 0
        while done < total:
            step = min(dispatch_chunk, total - done)
            l_max = _bucket(float(torch.exp(st["log_t"])),
                            float(torch.exp(st["da"].log_eps)), max_leapfrog)
            last_l_max = l_max
            us = _halton2(np.arange(halton_i, halton_i + step))
            halton_i += step
            for u in us.astype(np.float32):
                q, lp, g, acc = one_iter(q, lp, g, float(u), l_max, *flags)
                if sink is not None:
                    sink.add(q)
                    accs.append(acc)
            done += step
        return q, lp, g, accs

    n1, n2, n3 = warmup_windows(n_warmup)
    # phase 1: eps + T under the initial mass
    q, lp, g, _ = drive(q, lp, g, n1, (True, True, False))
    # phase 2: + second-moment accumulation
    q, lp, g, _ = drive(q, lp, g, n2, (True, True, True))
    # phase 3: freeze mass := accumulated variance, re-adapt eps
    mean = st["msum"] / torch.clamp(st["mcnt"], min=1.0)
    var = st["msq"] / torch.clamp(st["mcnt"], min=1.0) - mean**2
    w_sh = st["mcnt"] / (st["mcnt"] + 5.0)
    # the q-variance floor holds only where a real inv_mass0 was given
    floor = mass_floor_frac * inv_mass if inv_mass0 is not None else 0.0
    st["inv_m"] = torch.clamp(torch.maximum(
        w_sh * var + (1.0 - w_sh) * inv_mass,
        torch.as_tensor(floor, dtype=var.dtype, device=dev)),
        min=1e-8).to(torch.float32)
    st["da"] = da_init(torch.exp(st["da"].log_eps))
    q, lp, g, _ = drive(q, lp, g, n3, (True, True, False))
    # freeze everything for sampling (optionally with a longer T)
    da = st["da"]
    st["da"] = da._replace(log_eps=da.log_eps_avg)
    st["log_t"] = st["log_t"] + math.log(float(sample_traj_mult))
    # the leapfrog bound caps at max_leapfrog: clamp a longer trajectory
    # on the host and report it
    eps_s = float(torch.exp(st["da"].log_eps))
    traj_req = float(torch.exp(st["log_t"]))
    traj_truncated = traj_req > eps_s * max_leapfrog
    if traj_truncated:
        st["log_t"] = torch.log(torch.tensor(
            eps_s * max_leapfrog, dtype=torch.float32)).to(
                **f64)
    sink = SampleSink(dispatch_chunk)
    q, lp, g, accs = drive(q, lp, g, n_samples, (False, False, False), sink)
    samples = samples_dict(target, gather_samples(split, sink), True)
    return split.share((samples, {
        "accept_rate": float(stack_chains(split, accs).mean()),
        "eps": float(torch.exp(st["da"].log_eps)),
        "trajectory_length": float(torch.exp(st["log_t"])),
        "n_leapfrog_bucket": last_l_max,
        "traj_truncated": bool(traj_truncated),
        "draws": draws.calls,
    }))
