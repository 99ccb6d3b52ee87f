"""What each rank of the port's chains-over-ranks CPU tests runs (through
terastructure_tpu_torch/parallel/ranks.py's RankPool). Imports torch and
the port only, never JAX. Every case is called with the same arguments
on every rank and returns this rank's result (the samplers return every
chain's on every rank); shard=False runs the one-rank program on every
rank, the comparison's other side."""

from __future__ import annotations

import numpy as np
import torch

from terastructure_tpu_torch.mcmc import chains, run_chees, run_nuts, run_smc
from terastructure_tpu_torch.mcmc.hmc import Target, TorchDraws, chain_start
from terastructure_tpu_torch.mcmc.nuts import nuts_kernel


def gauss_logp(params):
    """The 8-dim standard Gaussian of tests/test_sharded_chains.py."""
    return -0.5 * torch.sum(params["x"] ** 2)


def smc_log_prior(p):
    return -0.5 * torch.sum(p["x"] ** 2)


def smc_log_lik(p):
    return -0.5 * torch.sum((p["x"] - 1.0) ** 2)


def gauss_init(n_chains, dim=8, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n_chains, dim)).astype(np.float32)


def _where():
    rank, world = chains._world()
    return dict(rank=rank, world=world)


def nuts(n_chains=4, shard=True, n_samples=200, n_warmup=100, seed=0):
    init = {"x": torch.from_numpy(gauss_init(n_chains))}
    samples, diag = run_nuts(seed, gauss_logp, init, n_samples=n_samples,
                             n_warmup=n_warmup, n_chains=n_chains,
                             shard_chains=shard)
    sp = chains.split(n_chains, shard)
    return dict(_where(), x=samples["x"], diag=diag, d=sp.d, lo=sp.lo,
                hi=sp.hi)


def nuts_transitions(n_chains=4, shard=True, n=10, eps=0.3, seed=0):
    """n NUTS transitions from gauss_init at a fixed step size and unit
    mass, every chain's position after each (n, C, 8), and the
    generator's calls on this rank."""
    sp = chains.split(n_chains, shard)
    init = {"x": torch.from_numpy(gauss_init(n_chains))}
    target, q, _ = chain_start(gauss_logp, sp.local(init), n_chains, None)
    gen = torch.Generator().manual_seed(seed)
    draws = sp.draws(TorchDraws(gen))
    kernel = nuts_kernel(target, split=sp)
    out = []
    for _ in range(n):
        q, _ = kernel(draws, q, eps, torch.ones_like(q))
        out.append(sp.gather(q))
    return dict(_where(), q=torch.stack(out).numpy(), draws=draws.calls)


def smc(shard=True, n_p=64, seed=2):
    init = {"x": torch.from_numpy(
        np.random.default_rng(3).standard_normal((n_p, 4)).astype(
            np.float32))}
    particles, diag = run_smc(seed, smc_log_prior, smc_log_lik, init,
                              n_particles=n_p, n_mutations=1, n_leapfrog=4,
                              mutation_eps=0.3, max_stages=20,
                              shard_particles=shard)
    return dict(_where(), x=particles["x"], diag=diag)


def chees(shard=True, n_chains=4, n_warmup=12, n_samples=4, seed=5):
    """A short ChEES run: eps and the trajectory length it adapted (from
    every chain's statistics) and its samples."""
    init = {"x": torch.from_numpy(gauss_init(n_chains))}
    samples, diag = run_chees(seed, gauss_logp, init, n_samples=n_samples,
                              n_warmup=n_warmup, n_chains=n_chains,
                              dispatch_chunk=4, shard_chains=shard)
    return dict(_where(), x=samples["x"], diag=diag)


def target_rows(n_chains=4):
    """The log-density of every chain's gauss_init row evaluated on this
    rank's rows alone and on all rows: each chain's value is its own."""
    sp = chains.split(n_chains, True)
    x = torch.from_numpy(gauss_init(n_chains))
    t = Target(gauss_logp, {"x": x[0]})
    return dict(_where(), local=t.value(sp.local(x)), whole=t.value(x),
                lo=sp.lo, hi=sp.hi)


def hmc(shard=True, n_chains=4, seed=3):
    from terastructure_tpu_torch.mcmc import run_hmc

    init = {"x": torch.from_numpy(gauss_init(n_chains))}
    samples, diag = run_hmc(seed, gauss_logp, init, n_samples=100,
                            n_warmup=60, n_leapfrog=8, n_chains=n_chains,
                            shard_chains=shard)
    return dict(_where(), x=samples["x"], diag=diag)
