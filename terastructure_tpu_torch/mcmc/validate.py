"""Small-K validator: compare SVI variational moments against MCMC (port
of terastructure_tpu/mcmc/validate.py).

Runs the port's SVI fit and a sampler (NUTS, HMC, ChEES or SMC) on the
same dense genotype matrix and reports label-aligned discrepancies of
E[theta] and E[beta]. The potential sums its energies in float64
(`acc_dtype`), passed down explicitly: the port sets no global precision
flag. Everything runs on `device`: None means the first CUDA card, and
raises where there is none; device="cpu" runs on the CPU.

In a process group of several ranks (`cli validate --distributed`,
`converge --config 4 --ranks R`), every rank calls compare_svi_mcmc on
the same matrix: the lead (rank 0) alone fits SVI and broadcasts the
fitted gamma and lambda, then every rank runs the sampler on its share
of the chains or particles (mcmc/chains.py) and returns the same report.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from terastructure_tpu_torch.config import SVIConfig
from terastructure_tpu_torch.data.dataset import GenotypeData
from terastructure_tpu_torch.mcmc import run_chees, run_hmc, run_nuts, run_smc
from terastructure_tpu_torch.mcmc.diagnostics import split_rhat, summarize
from terastructure_tpu_torch.mcmc.hmc import batched
from terastructure_tpu_torch.mcmc.potential import (
    PSDPotential, init_params, logsumexp_last, q_z_moments,
    svi_informed_inits)
from terastructure_tpu_torch.models import psd
from terastructure_tpu_torch.svi import fit
from terastructure_tpu_torch.svi.engine import SVIState
from terastructure_tpu_torch.utils.labels import align_columns


@dataclasses.dataclass
class ValidationReport:
    theta_mae: float          # mean |E_svi[theta] - E_mcmc[theta]| aligned
    beta_mae: float
    theta_svi: np.ndarray
    theta_mcmc: np.ndarray
    beta_svi: np.ndarray
    beta_mcmc: np.ndarray
    sampler_diag: dict
    svi_steps: int
    svi_s: float = 0.0        # seconds of the SVI fit
    sampler_s: float = 0.0    # seconds of the sampler and its moments


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("compare_svi_mcmc: no CUDA card; pass "
                               "device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def _seed(seed: int, tag: int) -> int:
    """A seed for one of the run's draw streams."""
    return int(np.random.SeedSequence([seed, tag]).generate_state(1)[0])


def mcmc_moments(x, k, *, alpha, sampler="nuts", seed=0, n_samples=600,
                 n_warmup=400, svi_state=None, scale_sigma=0.05,
                 overdisperse=2.0, device=None,
                 acc_dtype=torch.float64, **kw):
    """Posterior means of theta/beta under the chosen sampler.

    The potential sums energies in acc_dtype (float64: at validator
    shapes the float32 Hamiltonian's rounding noise otherwise swamps the
    acceptance signal and dual averaging freezes the chains); dynamics
    and gradients stay float32.

    scale_sigma pins the per-individual unidentified scale direction
    (PSDPotential.scale_sigma); None reverts to the iid-Gamma prior.
    svi_state: a fitted SVIState whose (gamma, lamb) warm-start the
    chains and precondition the mass (potential.svi_informed_inits),
    overdispersed by `overdisperse` so R-hat keeps its power."""
    dev = _device(device)
    pot = PSDPotential(x=torch.as_tensor(np.asarray(x), device=dev),
                       alpha=alpha, scale_sigma=scale_sigma,
                       acc_dtype=acc_dtype)
    g_init = np.random.default_rng(_seed(seed, 1))
    key = _seed(seed, 2)
    if sampler == "smc":
        n_particles = kw.pop("n_particles", 512)
        if svi_state is not None:
            return _smc_bridge_moments(
                pot, k, n_particles=n_particles, key=key, rng=g_init,
                svi_state=svi_state, scale_sigma=scale_sigma,
                k_alpha=k * alpha, **kw)
        # particles start as exact draws from the potential's prior
        lg = np.log(g_init.standard_gamma(alpha, (n_particles, pot.n, k)))
        if scale_sigma is not None:
            zt = lg - logsumexp_last(lg)
            zt = zt + scale_sigma * g_init.standard_normal(
                (n_particles, pot.n, 1))
        else:
            zt = lg
        u = g_init.uniform(1e-4, 1 - 1e-4, (n_particles, pot.l, k))
        particles0 = {
            "z_theta": torch.as_tensor(zt.astype(np.float32), device=dev),
            "z_beta": torch.as_tensor(np.log(u / (1 - u)).astype(np.float32),
                                      device=dev),
        }
        particles, diag = run_smc(
            key, pot.log_prior, pot.log_lik, particles0,
            n_particles=n_particles, **kw)
        return _smc_postprocess(particles, diag)

    # ChEES adapts from cross-chain statistics: it wants many chains
    n_chains = kw.pop("n_chains", 16 if sampler == "chees" else 1)
    inv_mass0 = None
    if svi_state is not None:
        params0, inv_mass0 = svi_informed_inits(
            svi_state.gamma[:pot.n], svi_state.lamb[:pot.l], g_init,
            n_chains=n_chains if n_chains > 1 else 0,
            overdisperse=overdisperse, scale_sigma=scale_sigma,
            k_alpha=k * alpha, device=dev)
    else:
        params0 = init_params(pot, _seed(seed, 3), k=k,
                              n_chains=n_chains if n_chains > 1 else 0)
    runner = {"nuts": run_nuts, "hmc": run_hmc, "chees": run_chees}[sampler]
    samples, diag = runner(
        key, pot, params0, n_samples=n_samples, n_warmup=n_warmup,
        n_chains=n_chains, inv_mass0=inv_mass0, **kw)
    theta_s, beta_s = _constrain(samples)
    if n_chains > 1:
        # Diagnose the constrained parameters, with every chain's
        # component labels aligned to chain 0 first: the posterior is
        # invariant to permuting the K populations. The permutation comes
        # from the chain-mean theta (Hungarian on column L1 distance) and
        # is applied to theta and beta.
        perms = []
        for c in range(1, theta_s.shape[0]):
            _, perm = align_columns(theta_s[c].mean(axis=0),
                                    theta_s[0].mean(axis=0))
            theta_s[c] = theta_s[c][..., perm]
            beta_s[c] = beta_s[c][..., perm]
            perms.append(perm.tolist())
        diag = dict(diag)
        diag["convergence"] = summarize({"theta": theta_s, "beta": beta_s},
                                        max_params=64)
        # beyond the reference's 64-coordinate summary: the split R-hat
        # of every coordinate (vectorized, cheap)
        diag["max_split_rhat_all"] = {
            name: float(np.nanmax(split_rhat(a)))
            for name, a in (("theta", theta_s), ("beta", beta_s))}
        diag["chain_label_perms"] = perms
        # moments from the aligned constrained samples
        theta_s = theta_s.reshape((-1,) + theta_s.shape[2:])
        beta_s = beta_s.reshape((-1,) + beta_s.shape[2:])
    return theta_s.mean(axis=0), beta_s.mean(axis=0), diag


def _constrain(samples):
    """(theta, beta) of host samples, float64."""
    zt = np.asarray(samples["z_theta"], np.float64)
    g = np.exp(zt - zt.max(-1, keepdims=True))
    theta = g / g.sum(-1, keepdims=True)
    beta = 1.0 / (1.0 + np.exp(-np.asarray(samples["z_beta"], np.float64)))
    return theta, beta


def align_ensemble(theta_s, beta_s):
    """Align every member's K component labels to member 0 (Hungarian on
    theta's columns); the permutation is shared with beta. Input leading
    axis is the ensemble (particles, or chains' pooled draws). Returns
    (theta_s, beta_s, n_realigned) with arrays modified in place."""
    k = theta_s.shape[-1]
    flipped = 0
    for i in range(1, theta_s.shape[0]):
        _, perm = align_columns(theta_s[i], theta_s[0])
        if not np.array_equal(perm, np.arange(k)):
            flipped += 1
            theta_s[i] = theta_s[i][..., perm]
            beta_s[i] = beta_s[i][..., perm]
    return theta_s, beta_s, flipped


def _smc_postprocess(particles, diag):
    """Constrain + per-particle label alignment + ensemble moments: the
    posterior is K!-symmetric and tempered SMC mixes between the label
    modes, so the raw ensemble mean would collapse toward theta = 1/K."""
    theta_s, beta_s = _constrain(particles)
    theta_s, beta_s, flipped = align_ensemble(theta_s, beta_s)
    diag = dict(diag)
    diag["particles_label_aligned"] = flipped
    return theta_s.mean(axis=0), beta_s.mean(axis=0), diag


def _smc_bridge_moments(pot, k, *, n_particles, key, rng, svi_state,
                        scale_sigma, k_alpha, **kw):
    """Variational-bridge SMC: temper from a diagonal Gaussian qhat built
    on the fitted q's z-moments to the exact posterior,

        log pi_t = log qhat + t * (log p - log qhat),

    instead of prior -> posterior (from the prior the ladder needs
    thousands of stages at validator shapes). The target at t = 1 is
    still exact; the mutation mass is the bridge base's variance; the
    base is overdispersed (1.5x q variance) for tail cover, and its draws
    and density use the same qhat. diag["log_evidence"] estimates
    log E_qhat[p/qhat] = log Z.
    """
    kw.pop("inv_mass0", None)
    kw.pop("inv_mass_prior", None)
    dev = pot.x.device
    mean, var = q_z_moments(svi_state.gamma[:pot.n], svi_state.lamb[:pot.l],
                            scale_sigma=scale_sigma, k_alpha=k_alpha,
                            device=dev)
    var_b = {name: 1.5 * v for name, v in var.items()}
    acc = pot.acc_dtype

    @batched
    def log_qb(params):
        tot = 0.0
        for name in ("z_theta", "z_beta"):
            z, m, v = params[name], mean[name], var_b[name]
            tot = tot - 0.5 * torch.sum((z - m) ** 2 / v, dim=(-2, -1),
                                        dtype=acc) \
                - 0.5 * torch.sum(torch.log(v), dtype=acc)
        return tot

    @batched
    def delta(params):
        return pot(params) - log_qb(params)

    particles0 = {}
    for name in ("z_theta", "z_beta"):
        z = rng.standard_normal((n_particles,) + tuple(mean[name].shape))
        particles0[name] = mean[name] + torch.sqrt(var_b[name]) \
            * torch.as_tensor(z.astype(np.float32), device=dev)
    particles, diag = run_smc(
        key, log_qb, delta, particles0, n_particles=n_particles,
        inv_mass0=var_b, **kw)
    theta_m, beta_m, diag = _smc_postprocess(particles, diag)
    diag["path"] = "variational_bridge"
    return theta_m, beta_m, diag


def _lead_fit(cfg: SVIConfig, x, seed: int, dev):
    """(the fitted SVIState, its steps): the SVI fit on this device, or in
    a process group of several ranks the lead's fit, broadcast to every
    rank (one broadcast of gamma, lambda and the step count)."""
    multi = dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1
    res = None
    if not multi or dist.get_rank() == 0:
        data = GenotypeData.from_dense(
            x, validation_frac=0.01, heldout_frac=0.0, seed=seed)
        res = fit(cfg, data, device=dev)
        if not multi:
            return res.state, res.steps
    box = [None if res is None else (res.state.gamma.cpu(),
                                     res.state.lamb.cpu(), res.state.t,
                                     res.steps)]
    dist.broadcast_object_list(box, src=0)
    gamma, lamb, t, steps = box[0]
    return SVIState(gamma=gamma.to(dev), lamb=lamb.to(dev), t=t,
                    seed=cfg.seed), steps


def compare_svi_mcmc(
    x: np.ndarray,
    k: int,
    *,
    sampler: str = "nuts",
    svi_config: Optional[SVIConfig] = None,
    seed: int = 0,
    warm_start: bool = True,
    device=None,
    **sampler_kw,
) -> ValidationReport:
    """Fit SVI and run MCMC on the same dense genotype matrix x (N, L).

    warm_start: initialize the chains (or the SMC bridge) from the
    overdispersed fitted variational posterior with its z-variance as the
    mass preconditioner (mcmc_moments svi_state). False forces the cold
    init."""
    dev = _device(device)
    n, l = x.shape
    cfg = svi_config or SVIConfig(
        n=n, l=l, k=k, batch_size=min(64, l), max_steps=4000,
        rfreq=200, seed=seed,
    )
    t0 = time.time()
    state, svi_steps = _lead_fit(cfg, x, seed, dev)
    theta_svi = psd.theta_mean(state.gamma[:n]).cpu().numpy()
    beta_svi = psd.beta_mean(state.lamb[:l]).cpu().numpy()
    t1 = time.time()

    theta_mcmc, beta_mcmc, diag = mcmc_moments(
        x, k, alpha=cfg.alpha_value, sampler=sampler, seed=seed,
        svi_state=state if warm_start else None, device=dev,
        **sampler_kw)
    t2 = time.time()

    aligned_theta, perm = align_columns(theta_svi, theta_mcmc)
    theta_mae = float(np.abs(aligned_theta - theta_mcmc).mean())
    beta_mae = float(np.abs(beta_svi[:, perm] - beta_mcmc).mean())
    return ValidationReport(
        theta_mae=theta_mae,
        beta_mae=beta_mae,
        theta_svi=aligned_theta,
        theta_mcmc=theta_mcmc,
        beta_svi=beta_svi[:, perm],
        beta_mcmc=beta_mcmc,
        sampler_diag=diag,
        svi_steps=svi_steps,
        svi_s=t1 - t0,
        sampler_s=t2 - t1,
    )
