"""Sequential Monte Carlo with adaptive likelihood tempering (port of
terastructure_tpu/mcmc/smc.py).

Particles carry the unconstrained PSD parameters on a leading axis; the
temperature ladder is chosen adaptively by bisecting the next inverse
temperature so the effective sample size (ESS) of the incremental
weights stays at `ess_target` * n_particles (Del Moral et al. 2006
adaptive SMC). Resampling is systematic; mutation moves are HMC kernels
targeting the tempered posterior, with the step size adapted from the
acceptance pooled over all particles. The stage loop runs on the host.

The log-densities are evaluated and differentiated 64 particles at a
time (hmc.Target's chunk): at 512 particles and 500 x 5,000 one
evaluation over all of them would touch 1.28e9 entries. The chunk is
fixed, not read from free memory, so results do not depend on the
machine.

Over ranks (mcmc/chains.py; the reference's "collective resampling and
step-size adaptation") each rank holds P/d particles and evaluates and
mutates only those. A stage gathers the (P,) log-likelihoods, so every
rank computes the same next temperature, evidence increment and
systematic-resampling parents (one shared draw); it then gathers the
(P, dim) positions and takes its slice's parents: (d - 1)/d * P * dim * 4
bytes received a rank a stage. A mutation round's mean acceptance is
taken over the gathered (P,) acceptances, so eps adapts from every
particle; the particles are gathered at the end.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from terastructure_tpu_torch.mcmc import chains
from terastructure_tpu_torch.mcmc.hmc import (
    Target, TorchDraws, _sync, as_batched, as_generator, batched,
    hmc_kernel)


def ess(log_w):
    """1 / sum(w^2) of the normalized weights (numpy, any float dtype)."""
    w = _softmax(log_w)
    return 1.0 / np.sum(w * w)


def _softmax(x):
    e = np.exp(x - np.max(x))
    return e / np.sum(e)


def systematic_resample(draws, log_w, n):
    """Systematic resampling: (P,) log weights -> (n,) parent indices."""
    w = torch.softmax(log_w, dim=0)
    cum = torch.cumsum(w, dim=0)
    u0 = draws.uniform((), log_w.dtype, log_w.device)
    pts = (u0 + torch.arange(n, dtype=log_w.dtype, device=log_w.device)) / n
    idx = torch.searchsorted(cum, pts, right=True)
    # an index past the end (rounding of the last cumulative weight) takes
    # the last particle, as the reference's clamped gather does
    return torch.clamp(idx, max=log_w.shape[0] - 1)


def _next_temp(log_lik, temp, ess_target_frac, n_particles):
    """Bisect the largest dtemp in (0, 1-temp] with ESS >= target, on the
    host in log_lik's dtype. log_lik: (P,) numpy array."""
    dt = log_lik.dtype.type
    target = ess_target_frac * n_particles

    def ess_at(new_temp):
        return ess((new_temp - temp) * log_lik)

    lo, hi, it = dt(temp), dt(1.0), 0
    while it < 40 and hi - lo > 1e-6:
        mid = dt(0.5) * (lo + hi)
        if ess_at(mid) >= target:
            lo = mid
        else:
            hi = mid
        it += 1
    # if jumping straight to temp = 1 keeps ESS above target, do that
    new = dt(1.0) if ess_at(dt(1.0)) >= target else lo
    return max(new, dt(temp + 1e-6))


def run_smc(
    key,
    log_prior: Callable,
    log_lik: Callable,
    init_particles,
    *,
    n_particles: int,
    n_mutations: int = 3,
    n_leapfrog: int = 16,
    mutation_eps: float = 0.05,
    ess_target_frac: float = 0.5,
    max_stages: int = 100,
    shard_particles: bool = True,
    inv_mass0=None,
    inv_mass_prior=None,
    target_accept: float = 0.65,
    adapt_eps: bool = True,
):
    """Adaptive tempered SMC from the prior sample `init_particles` (a dict
    with a leading particle axis).

    key: an int seed or a torch.Generator on the particles' device.
    Returns (particles, diagnostics) where particles approximate the
    posterior prior * lik at temp=1; diagnostics include the log-evidence
    estimate and the realized temperature ladder.

    adapt_eps: after each mutation round the HMC step size is rescaled
    from the mean acceptance across all particles, log-eps moving toward
    target_accept. `mutation_eps` seeds the schedule.

    In a process group (shard_particles), the particles are split over
    the ranks (see above) and every rank returns all of them;
    diagnostics["draws"] counts this rank's generator calls.
    """
    split = chains.split(n_particles, shard_particles)
    if not split.holds:
        return split.idle()
    params = {k: torch.as_tensor(v)
              for k, v in split.local(init_particles).items()}
    template = {k: v[0] for k, v in params.items()}
    prior_b, lik_b = as_batched(log_prior), as_batched(log_lik)
    lik_t = Target(lik_b, template)
    q = lik_t.flat(params).to(torch.float32)
    dev = q.device
    draws = split.draws(TorchDraws(as_generator(key, dev)))
    if inv_mass0 is not None:
        im1 = lik_t.flat({k: torch.as_tensor(v, device=dev)[None]
                          for k, v in inv_mass0.items()})[0]
    if inv_mass_prior is not None:
        imp = lik_t.flat({k: torch.as_tensor(v, device=dev)[None]
                          for k, v in inv_mass_prior.items()})[0]

    # the tempered target's temperature and mass are buffers, so one
    # kernel (one captured leapfrog step on a card) serves every stage
    temp_now = torch.zeros((), dtype=torch.float64, device=dev)

    @batched
    def tempered(p):
        return prior_b(p) + temp_now * lik_b(p)

    target = Target(tempered, template)
    kernel = hmc_kernel(target, n_leapfrog)
    log_weights = None
    temp = 0.0
    log_evidence = 0.0
    eps = float(mutation_eps)
    temps, acc_rates, eps_trace = [0.0], [], []
    for _ in range(max_stages):
        ll = split.gather(lik_t.value(q))            # (P,), every rank
        ll_host = ll.cpu().numpy()
        if log_weights is None:
            log_weights = torch.zeros(n_particles, dtype=ll.dtype, device=dev)
        new_temp = float(_next_temp(ll_host, temp, ess_target_frac,
                                    n_particles))
        inc = (new_temp - temp) * ll
        log_w = log_weights + inc
        # evidence increment: log mean of incremental weights under the
        # previous (normalized) weights
        prev = torch.log_softmax(log_weights, dim=0)
        log_z_inc = torch.logsumexp(prev + inc, dim=0)
        parents = systematic_resample(draws, log_w, n_particles)
        q = split.gather(q)[parents[split.lo:split.hi] if split.sharded
                            else parents]

        # mutate with HMC targeting the tempered posterior
        temp_now.fill_(new_temp)
        if inv_mass0 is None:
            inv_mass = torch.ones(q.shape[1], dtype=q.dtype, device=dev)
        elif inv_mass_prior is None:
            # preconditioned mutations: any per-stage-fixed mass is a valid
            # HMC kernel for every tempered target
            inv_mass = im1
        else:
            # geometric interpolation in log-variance tracks the ladder
            inv_mass = torch.exp((1.0 - new_temp) * torch.log(imp)
                                 + new_temp * torch.log(im1))
        accs = []
        for _ in range(n_mutations):
            lp, g = target.value_and_grad(q)
            q, _, _, acc = kernel(draws, q, lp, g, eps, inv_mass)
            # cross-particle reduction, over every rank's particles
            mean_acc = float(torch.mean(split.gather(acc)))
            if adapt_eps:
                eps = float(np.clip(
                    eps * np.exp(0.7 * (mean_acc - target_accept)),
                    1e-4, 10.0))
            accs.append(mean_acc)
        log_weights = torch.zeros(n_particles, dtype=ll.dtype, device=dev)
        temp = new_temp
        log_evidence += float(log_z_inc)
        temps.append(temp)
        acc_rates.append(float(np.mean(accs)))
        eps_trace.append(eps)
        if temps[-1] >= 1.0 - 1e-9:
            break
    _sync(dev)
    q = split.gather(q)
    particles = {k: v.cpu().numpy() for k, v in lik_t.unflat(q).items()}
    return split.share((particles, {
        "temps": temps,
        "acceptance": acc_rates,
        "eps": eps_trace,
        "log_evidence": log_evidence,
        "n_stages": len(temps) - 1,
        "draws": draws.calls,
    }))
