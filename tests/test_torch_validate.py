"""The port's validator as a whole (terastructure_tpu_torch/mcmc/validate.py)
on the CPU: both packages' compare_svi_mcmc on one matrix, the port's
mirrors of tests/test_validate.py at its sizes and limits, the command
line's `validate` and `converge --config 4`."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from terastructure_tpu.data import simulate_psd
from terastructure_tpu.mcmc import validate as ref_validate
from terastructure_tpu_torch import SVIConfig, cli, converge
from terastructure_tpu_torch.mcmc.validate import (align_ensemble,
                                                   compare_svi_mcmc)
from terastructure_tpu_torch.utils.labels import align_columns

ROOT = Path(__file__).resolve().parents[1]


def _svi(x, seed):
    """compare_svi_mcmc's own SVI settings (B = min(64, L), 4,000 steps,
    rfreq 200) on the dense path: the one the reference's tests run on
    the CPU, where its kernel "auto" resolves to dense (ROADMAP Queue 3);
    the port's "auto" takes K1's twin there, ~4x slower a step."""
    n, l = x.shape
    return SVIConfig(n=n, l=l, k=2, batch_size=min(64, l), max_steps=4000,
                     rfreq=200, seed=seed, kernel="dense")


def test_both_packages_validate_one_matrix():
    """compare_svi_mcmc in both packages on one simulated matrix (30 x 80,
    K = 2, NUTS, 2 chains, 150 + 150, as tests/test_validate.py:34):
    each package's theta MAE against its own SVI under the reference
    test's limit (0.05), and the two MCMC theta means, label-aligned,
    within a Monte-Carlo limit: their mean absolute difference under
    0.03, about five standard errors of a difference of two 300-draw
    means of theta at L = 80 (posterior sd ~0.05, ESS >= ~30 a
    coordinate). Both SVI fits take the dense path (`_svi`)."""
    _, _, x = simulate_psd(30, 80, 2, seed=23, structured=True)
    kw = dict(k=2, sampler="nuts", seed=23, n_samples=150, n_warmup=150,
              n_chains=2, max_depth=6)
    ref = ref_validate.compare_svi_mcmc(x, **kw)
    ours = compare_svi_mcmc(x, device="cpu", svi_config=_svi(x, 23), **kw)
    assert ref.theta_mae < 0.05 and ours.theta_mae < 0.05, (
        ref.theta_mae, ours.theta_mae)
    assert set(ours.sampler_diag["convergence"]) == set(
        ref.sampler_diag["convergence"]) == {"theta", "beta"}
    aligned, _ = align_columns(ours.theta_mcmc, ref.theta_mcmc)
    assert np.abs(aligned - ref.theta_mcmc).mean() < 0.03


def test_svi_vs_nuts_moments_agree():
    _, _, x = simulate_psd(50, 200, 2, seed=21, structured=True)
    rep = compare_svi_mcmc(x, k=2, sampler="nuts", seed=21, device="cpu",
                           svi_config=_svi(x, 21), n_samples=400,
                           n_warmup=300, max_depth=6)
    # theta is well-identified at L=200; beta (per-SNP) is noisier
    assert rep.theta_mae < 0.05, rep.theta_mae
    assert rep.beta_mae < 0.10, rep.beta_mae


def test_svi_vs_smc_moments_agree():
    _, _, x = simulate_psd(40, 120, 2, seed=22, structured=True)
    rep = compare_svi_mcmc(x, k=2, sampler="smc", seed=22, device="cpu",
                           svi_config=_svi(x, 22), n_particles=256,
                           n_mutations=2, n_leapfrog=8, mutation_eps=0.1)
    assert rep.theta_mae < 0.08, rep.theta_mae
    assert rep.beta_mae < 0.12, rep.beta_mae
    assert rep.sampler_diag["path"] == "variational_bridge"
    assert rep.sampler_diag["temps"][-1] >= 1.0 - 1e-9


def test_particle_ensemble_alignment_recovers_mode():
    """A particle ensemble split across the K! label modes must not
    average to the symmetric collapse (theta -> 1/K)."""
    rng = np.random.default_rng(0)
    n, l, k, p = 30, 50, 2, 64
    base_t = rng.dirichlet(np.ones(k) * 0.5, size=n)
    base_b = rng.uniform(0.05, 0.95, size=(l, k))
    theta_s = np.repeat(base_t[None], p, axis=0) + rng.normal(0, 0.01,
                                                              (p, n, k))
    beta_s = np.repeat(base_b[None], p, axis=0) + rng.normal(0, 0.01,
                                                             (p, l, k))
    flip = rng.random(p) < 0.5
    flip[0] = False
    theta_s[flip] = theta_s[flip][..., ::-1]
    beta_s[flip] = beta_s[flip][..., ::-1]
    assert np.abs(theta_s.mean(0) - base_t).mean() > 0.1
    theta_a, beta_a, nfl = align_ensemble(theta_s.copy(), beta_s.copy())
    assert nfl == int(flip.sum())
    assert np.abs(theta_a.mean(0) - base_t).mean() < 0.02
    assert np.abs(beta_a.mean(0) - base_b).mean() < 0.02


def test_validate_refuses_an_unknown_flag():
    with pytest.raises(SystemExit) as e:
        cli.main(["validate", "--simulate", "-n", "16", "-l", "32", "-k",
                  "2", "--particles", "8", "--force-cpu"])
    assert e.value.code == 2


def test_validate_without_a_card_exits_naming_it():
    proc = subprocess.run(
        [sys.executable, "-m", "terastructure_tpu_torch.cli", "validate",
         "--simulate", "-n", "16", "-l", "32", "-k", "2"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA card" in proc.stderr


def test_converge_config4_record_at_a_tiny_size():
    """converge --config 4: the validator's record (NUTS, 2 chains), with
    the SVI fit's twin calls (K1's, as the reference's B = 64 takes the
    fused branch) and no kernel launch on the CPU."""
    rec = converge.run_validate(4, device="cpu", scale=0.03, chains=2,
                                n_samples=40, n_warmup=40, svi_max_steps=200)
    assert (rec["n"], rec["l"], rec["k"]) == (12, 144, 3)
    for key in ("theta_mae", "beta_mae", "svi_s", "sampler_s", "warmup_s",
                "sample_s", "max_rhat_theta", "max_rhat_beta",
                "min_ess_theta", "min_ess_beta"):
        assert np.isfinite(rec[key]), key
    assert rec["svi_steps"] == 200
    assert rec["leapfrog_warmup"] > 0 and rec["leapfrog_sample"] > 0
    assert rec["twin_calls"]["fused_local_solve"] == rec["svi_steps"]
    assert rec["launches"] == {name: 0 for name in rec["launches"]}
    json.dumps(rec)


def test_config4_limits_name_what_a_record_misses():
    """converge's config #4 limits: the reference's records (BASELINE.md:92)
    pass; a MAE over its limit, a low ESS, and a NaN or missing R-hat are
    each named."""
    ref = dict(theta_mae=0.00626, beta_mae=0.00321, max_rhat_theta=1.029,
               max_rhat_beta=1.01, min_ess_theta=120.0)
    assert converge.config4_misses(ref) == []
    bad = dict(ref, theta_mae=0.013, min_ess_theta=40.0,
               max_rhat_beta=float("nan"))
    del bad["max_rhat_theta"]
    assert converge.config4_misses(bad) == [
        "theta_mae", "max_rhat_theta", "max_rhat_beta", "min_ess_theta"]
