"""The port's MCMC validators (terastructure_tpu_torch/mcmc/) against the
reference's (terastructure_tpu/mcmc/) on the CPU.

- The potential's value and gradient against jax.value_and_grad of the
  reference's, its float64 energy sums, the scale pin, the q moments;
  models/psd.py's priors and full-data log-likelihood.
- One HMC and one NUTS transition with the reference's draws replayed:
  the test rebuilds the reference's key schedule, draws with jax.random,
  and hands the draws to the port's kernel through its draw source.
- The deterministic pieces (dual averaging, Welford, the U-turn
  checkpoints, the Halton jitter, SMC's temperature bisection) and the
  diagnostics, on the same inputs; the leapfrog's per-chain step counts.
- The samplers against exact answers at the reference tests' own sizes
  and limits (tests/test_mcmc.py): the two packages cannot share draws.

Inputs come from numpy seeds; each comparison states its tolerance.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from terastructure_tpu.mcmc import hmc as ref_hmc
from terastructure_tpu.mcmc import nuts as ref_nuts
from terastructure_tpu.mcmc import potential as ref_pot
from terastructure_tpu.mcmc import smc as ref_smc
from terastructure_tpu.mcmc import chees as ref_chees
from terastructure_tpu.mcmc import diagnostics as ref_diag
from terastructure_tpu.models import psd as ref_psd
from terastructure_tpu_torch.data.simulate import simulate_psd
from terastructure_tpu_torch.mcmc import (PSDPotential, run_hmc, run_nuts,
                                          run_smc)
from terastructure_tpu_torch.mcmc import chains, chees, diagnostics, hmc, nuts
from terastructure_tpu_torch.mcmc import potential, smc
from terastructure_tpu_torch.mcmc.potential import init_params
from terastructure_tpu_torch.models import psd


@pytest.fixture
def x64():
    """The reference's validators run with JAX's x64 on (its energy sums
    in float64), as mcmc.validate sets it."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _pair(x, alpha, scale_sigma):
    """The reference's potential and the port's (float64 sums) on x."""
    ref = ref_pot.PSDPotential(x=jnp.asarray(x), alpha=alpha,
                               scale_sigma=scale_sigma)
    ours = PSDPotential(x=torch.from_numpy(x), alpha=alpha,
                        scale_sigma=scale_sigma, acc_dtype=torch.float64)
    return ref, ours


def _params(rng, n, l, k, lead=()):
    return {"z_beta": (0.8 * rng.standard_normal(lead + (l, k))).astype(
                np.float32),
            "z_theta": (0.5 * rng.standard_normal(lead + (n, k))).astype(
                np.float32)}


# --------------------------------------------------------------------------
# the potential


@pytest.mark.parametrize("scale_sigma", [None, 0.05])
@pytest.mark.parametrize("missing", [False, True])
@pytest.mark.parametrize("chains_", [0, 3])
def test_potential_value_and_grad_match_the_reference(x64, scale_sigma,
                                                      missing, chains_):
    """Value to 2e-7 relative (float32 terms, float64 sums: the packages'
    exp/log differ by an ulp a term); the float32 gradient to 2e-5 of its
    largest magnitude. With a chain axis the reference is vmapped."""
    rng = np.random.default_rng(11)
    _, _, x = simulate_psd(24, 40, 3, seed=4)
    if missing:
        x = x.copy()
        x[rng.random(x.shape) < 0.15] = 3
    ref, ours = _pair(x, 0.5, scale_sigma)
    lead = (chains_,) if chains_ else ()
    pr = _params(rng, 24, 40, 3, lead)
    vg = jax.value_and_grad(lambda p: ref(p))
    v_ref, g_ref = jax.vmap(vg)(pr) if chains_ else vg(pr)
    pt = {k: _t(v).requires_grad_(True) for k, v in pr.items()}
    v = ours(pt)
    g = torch.autograd.grad(v.sum(), [pt["z_beta"], pt["z_theta"]])
    assert v.dtype == torch.float64 and g[0].dtype == torch.float32
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(v_ref),
                               rtol=2e-7)
    for a, b in zip(g, (g_ref["z_beta"], g_ref["z_theta"])):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=2e-5 * np.abs(b).max())
    # prior and likelihood apart, and the tempered sum
    for name in ("log_prior", "log_lik"):
        f = jax.vmap(getattr(ref, name)) if chains_ else getattr(ref, name)
        np.testing.assert_allclose(
            getattr(ours, name)(pt).detach().numpy(), np.asarray(f(pr)),
            rtol=2e-7)
    tf = jax.vmap(ref.tempered(0.3)) if chains_ else ref.tempered(0.3)
    np.testing.assert_allclose(ours.tempered(0.3)(pt).detach().numpy(),
                               np.asarray(tf(pr)), rtol=2e-7)


@pytest.mark.parametrize("scale_sigma", [None, 0.05])
def test_one_node_density_matches_its_plain_twin(scale_sigma):
    """The potential's closed-form gradient (one autograd node) against
    autograd of the elementwise formula, in float64: 1e-12 of the largest
    magnitude, for the prior, the likelihood, their sum and a tempered
    sum, with MISSING entries and a chain axis."""
    rng = np.random.default_rng(3)
    _, _, x = simulate_psd(16, 30, 3, seed=2)
    x = x.copy()
    x[rng.random(x.shape) < 0.1] = 3
    pot = PSDPotential(x=torch.from_numpy(x), alpha=0.4,
                       scale_sigma=scale_sigma, acc_dtype=torch.float64)
    p = {k: _t(v, np.float64).requires_grad_(True)
         for k, v in _params(rng, 16, 30, 3, (2,)).items()}
    cases = [(pot.log_prior, dict(lik=False)), (pot.log_lik, dict(prior=False)),
             (pot, {}), (pot.tempered(0.3), None)]
    for f, kw in cases:
        v = f(p)
        if kw is None:
            w = pot.plain(p, lik=False) + 0.3 * pot.plain(p, prior=False)
        else:
            w = pot.plain(p, **kw)
        g = torch.autograd.grad(v.sum(), list(p.values()))
        h = torch.autograd.grad(w.sum(), list(p.values()))
        np.testing.assert_allclose(v.detach().numpy(), w.detach().numpy(),
                                   rtol=1e-12)
        for a, b in zip(g, h):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-12 * float(b.abs().max()))


def test_energy_sums_widen_to_float64_dynamics_stay_f32():
    """Mirror of the reference's frozen-chain regression
    (tests/test_mcmc.py:119): with acc_dtype float64 the likelihood sum
    matches a numpy float64 oracle to 0.1 nats of ~1e6, while the inits
    and a NUTS transition stay float32."""
    import scipy.special as sps

    _, _, x = simulate_psd(400, 1200, 3, seed=3)
    pot = PSDPotential(x=torch.from_numpy(x), alpha=1 / 3,
                       acc_dtype=torch.float64)
    params = init_params(pot, 0, k=3)
    assert params["z_theta"].dtype == torch.float32
    ll = pot.log_lik(params)
    assert ll.dtype == torch.float64
    zt = params["z_theta"].numpy()
    zb = params["z_beta"].numpy()
    g = np.exp(zt)
    theta = g / g.sum(-1, keepdims=True)
    p = (theta @ sps.expit(zb).T).astype(np.float64)
    xi = x.astype(np.float64)
    ref = float(np.sum(xi * np.log(p + 1e-12) + (2 - xi) * np.log(1 - p + 1e-12)
                       + np.log([1.0, 2.0, 1.0])[x]))
    assert abs(float(ll) - ref) < 0.1, (float(ll), ref)

    target = hmc.Target(pot, params)
    kern = nuts.nuts_kernel(target, max_depth=3)
    q = target.flat({k: v[None] for k, v in params.items()})
    draws = hmc.TorchDraws(torch.Generator().manual_seed(1))
    new, info = kern(draws, q, 0.01, torch.ones_like(q))
    assert new.dtype == torch.float32
    assert info["accept_prob"].dtype == torch.float64
    assert np.isfinite(float(info["accept_prob"][0]))


def test_scale_pinned_prior_is_posterior_invariant():
    """Mirror of tests/test_mcmc.py:169: scale_sigma changes only the
    unidentified per-row scale direction."""
    _, _, x = simulate_psd(20, 40, 3, seed=5)
    sig = 0.05
    legacy = PSDPotential(x=torch.from_numpy(x), alpha=0.5,
                          acc_dtype=torch.float64)
    pinned = PSDPotential(x=torch.from_numpy(x), alpha=0.5, scale_sigma=sig,
                          acc_dtype=torch.float64)
    p1 = init_params(legacy, 0, k=3)
    p2 = init_params(legacy, 1, k=3)

    def with_scales(p, ref):
        w_p = torch.logsumexp(p["z_theta"], -1, keepdim=True)
        w_r = torch.logsumexp(ref["z_theta"], -1, keepdim=True)
        return {"z_theta": p["z_theta"] - w_p + w_r, "z_beta": p["z_beta"]}

    shift = {"z_theta": p1["z_theta"] + 0.7, "z_beta": p1["z_beta"]}
    np.testing.assert_allclose(float(pinned.log_lik(shift)),
                               float(pinned.log_lik(p1)), rtol=1e-5)
    p2s = with_scales(p2, p1)
    d_legacy = float(legacy.log_prior(p2s)) - float(legacy.log_prior(p1))
    d_pinned = float(pinned.log_prior(p2s)) - float(pinned.log_prior(p1))
    np.testing.assert_allclose(d_pinned, d_legacy, rtol=1e-4, atol=1e-3)
    w = torch.logsumexp(p1["z_theta"], -1).double().numpy()
    c = 0.3
    d = float(pinned.log_prior({"z_theta": p1["z_theta"] + c,
                                "z_beta": p1["z_beta"]})) \
        - float(pinned.log_prior(p1))
    expect = float((-((w + c) ** 2 - w**2) / (2 * sig**2)).sum())
    np.testing.assert_allclose(d, expect, rtol=1e-3)


def test_likelihood_product_is_true_float32():
    """f32_product sums K float32 products: equal to a float64 product
    rounded once per term, far inside what a TF32 product (10-bit
    mantissa) would give; no matmul is involved."""
    rng = np.random.default_rng(2)
    th = rng.dirichlet(np.ones(3), size=50).astype(np.float32)
    be = rng.uniform(0.01, 0.99, (70, 3)).astype(np.float32)
    p = psd.f32_product(torch.from_numpy(th), torch.from_numpy(be))
    exact = th.astype(np.float64) @ be.astype(np.float64).T
    assert p.dtype == torch.float32
    np.testing.assert_allclose(p.numpy(), exact, rtol=4e-7, atol=0)


@pytest.mark.parametrize("mask_given", [False, True])
def test_psd_priors_and_data_loglik_match_the_reference(mask_given):
    """models/psd.py's log_dirichlet_prior, log_beta_prior and data_loglik
    against the reference's on the same float32 inputs, with MISSING
    entries (the mask derived, or given): the priors to 1e-6 of their
    largest magnitude (float32 terms; the normalizers are a float64
    lgamma here and a float32 gammaln there, and values cross zero), the
    summed log-likelihood to 1e-5 relative (two float32 sums of 1,200
    terms in different orders)."""

    rng = np.random.default_rng(9)
    _, _, x = simulate_psd(30, 40, 3, seed=9)
    x = x.copy()
    x[rng.random(x.shape) < 0.15] = psd.MISSING
    th = rng.dirichlet(np.full(3, 0.7), size=30).astype(np.float32)
    be = rng.uniform(0.02, 0.98, (40, 3)).astype(np.float32)
    for got, want in (
            (psd.log_dirichlet_prior(_t(th), 0.4),
             ref_psd.log_dirichlet_prior(jnp.asarray(th), 0.4)),
            (psd.log_beta_prior(_t(be), 1.5, 0.8),
             ref_psd.log_beta_prior(jnp.asarray(be), 1.5, 0.8))):
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    mask = x != psd.MISSING
    got = psd.data_loglik(_t(th), _t(be), _t(x),
                          _t(mask) if mask_given else None)
    want = ref_psd.data_loglik(jnp.asarray(th), jnp.asarray(be),
                               jnp.asarray(x),
                               jnp.asarray(mask) if mask_given else None)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_q_z_moments_match_the_reference_and_monte_carlo():
    """The closed forms equal the reference's (float32, 1e-6) and agree
    with brute-force sampling (tests/test_mcmc.py:213's limits)."""
    rng = np.random.default_rng(0)
    gamma = rng.uniform(0.5, 50.0, size=(4, 3))
    lamb = rng.uniform(0.8, 60.0, size=(5, 3, 2))
    mean, var = potential.q_z_moments(gamma, lamb, scale_sigma=0.05)
    for sig, ka in ((0.05, None), (None, 1.0)):
        m1, v1 = potential.q_z_moments(gamma, lamb, scale_sigma=sig,
                                       k_alpha=ka)
        m2, v2 = ref_pot.q_z_moments(gamma, lamb, scale_sigma=sig,
                                     k_alpha=ka)
        for a, b in ((m1, m2), (v1, v2)):
            for k in a:
                np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                           rtol=1e-6)
    S = 200_000
    g = rng.gamma(gamma, size=(S,) + gamma.shape)
    log_theta = np.log(g) - np.log(g.sum(-1, keepdims=True))
    np.testing.assert_allclose(mean["z_theta"].numpy(), log_theta.mean(0),
                               atol=0.02)
    np.testing.assert_allclose(var["z_theta"].numpy(),
                               log_theta.var(0) + 0.05**2, rtol=0.05,
                               atol=1e-4)
    a = rng.gamma(lamb[..., 0], size=(S,) + lamb.shape[:-1])
    b = rng.gamma(lamb[..., 1], size=(S,) + lamb.shape[:-1])
    zb = np.log(a) - np.log(b)
    np.testing.assert_allclose(mean["z_beta"].numpy(), zb.mean(0), atol=0.02)
    np.testing.assert_allclose(var["z_beta"].numpy(), zb.var(0), rtol=0.05)


def test_svi_informed_inits_shapes_and_overdispersion():
    """Mirror of tests/test_mcmc.py:241."""
    rng = np.random.default_rng(1)
    gamma = rng.uniform(5.0, 80.0, size=(6, 2))
    lamb = rng.uniform(5.0, 80.0, size=(8, 2, 2))
    params0, inv_mass = potential.svi_informed_inits(
        gamma, lamb, 0, n_chains=64, overdisperse=2.0, scale_sigma=0.05)
    assert params0["z_theta"].shape == (64, 6, 2)
    assert params0["z_beta"].shape == (64, 8, 2)
    assert params0["z_theta"].dtype == torch.float32
    assert inv_mass["z_theta"].shape == (6, 2)
    assert all(float(v.min()) > 0 for v in inv_mass.values())
    _, var = potential.q_z_moments(gamma, lamb, scale_sigma=0.05)
    emp = params0["z_beta"].numpy().var(axis=0)
    np.testing.assert_allclose(emp, 4.0 * var["z_beta"].numpy(), rtol=0.8)
    assert np.std(params0["z_theta"].numpy()[:, 0, 0]) > 0


# --------------------------------------------------------------------------
# transitions with the reference's draws replayed


class _ReplayHMC:
    """The reference's hmc_kernel draws (hmc.py:100-121): split(key, 3)
    into k_mom, k_acc; the momentum noise one normal a leaf, keys
    split(k_mom, leaves) in the flat order."""

    def __init__(self, key, template):
        self.k_mom, self.k_acc, _ = jax.random.split(key, 3)
        self.template = template

    def momentum(self, shape, dtype, device):
        leaves = jax.tree.leaves(self.template)
        keys = jax.random.split(self.k_mom, len(leaves))
        z = [np.asarray(jax.random.normal(k, x.shape, x.dtype)).ravel()
             for k, x in zip(keys, leaves)]
        return _t(np.concatenate(z)).reshape(shape)

    def accept_uniform(self, shape, dtype, device):
        return _t(np.asarray(jax.random.uniform(self.k_acc)),
                  np.float64).reshape(shape).to(dtype)


class _ReplayNUTS:
    """The reference's nuts_kernel draws (nuts.py:126-282): split(key) into
    k_mom, k_traj; each doubling split(k_traj, 4) into the direction,
    subtree and merge keys; each leaf split(subtree key)."""

    def __init__(self, key):
        self.k_mom, self.k_traj = jax.random.split(key)
        self.calls = []

    def momentum(self, shape, dtype, device):
        self.calls.append("momentum")
        z = jax.random.normal(self.k_mom, (shape[-1],), jnp.float32)
        return _t(np.asarray(z)).reshape(shape)

    def direction(self, shape, device):
        self.calls.append("direction")
        k_dir, self.k_sub, self.k_merge, self.k_traj = jax.random.split(
            self.k_traj, 4)
        return torch.tensor([bool(jax.random.bernoulli(k_dir))])

    def leaf_uniform(self, shape, dtype, device):
        self.calls.append("leaf")
        k_sel, self.k_sub = jax.random.split(self.k_sub)
        return _t([float(jax.random.uniform(k_sel))], np.float64).to(dtype)

    def merge_uniform(self, shape, dtype, device):
        self.calls.append("merge")
        return _t([float(jax.random.uniform(self.k_merge))],
                  np.float64).to(dtype)


def _flat_ref(tree):
    return np.asarray(jax.flatten_util.ravel_pytree(tree)[0])


def _replay_setup(seed=3):
    rng = np.random.default_rng(seed)
    _, _, x = simulate_psd(12, 20, 2, seed=seed)
    ref, ours = _pair(x, 0.5, 0.05)
    pr = _params(rng, 12, 20, 2)
    im = {k: (0.5 + rng.random(v.shape)).astype(np.float32)
          for k, v in pr.items()}
    target = hmc.Target(ours, {k: _t(v) for k, v in pr.items()})
    q = target.flat({k: _t(v)[None] for k, v in pr.items()})
    inv_mass = target.flat({k: _t(v)[None] for k, v in im.items()})
    return ref, ours, pr, im, target, q, inv_mass


def test_hmc_transition_with_replayed_draws_matches_the_reference(x64):
    """One HMC transition (12 leapfrog steps): the new params to 1e-4
    relative, log p to 1e-6 relative, the accept probability to 1e-5."""
    import jax.flatten_util  # noqa: F401

    ref, ours, pr, im, target, q, inv_mass = _replay_setup()
    key = jax.random.PRNGKey(5)
    for eps in (0.004, 0.02):
        lp_ref = ref(pr)
        new_ref, lp_new_ref, acc_ref, _ = ref_hmc.hmc_kernel(ref, 12)(
            key, pr, lp_ref, eps, im)
        lp, g = target.value_and_grad(q)
        new, lp_new, _, acc = hmc.hmc_kernel(target, 12)(
            _ReplayHMC(key, pr), q, lp, g, eps, inv_mass)
        np.testing.assert_allclose(new[0].numpy(), _flat_ref(new_ref),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(lp_new[0]), float(lp_new_ref),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(acc[0]), float(acc_ref), atol=1e-5)


def test_nuts_transition_with_replayed_draws_matches_the_reference(x64):
    """One NUTS transition that builds a tree of depth >= 3: the same
    depth, leapfrog steps and divergence flag; the proposal and the
    accept probability within 1e-4 relative, log p within 1e-6."""
    import jax.flatten_util  # noqa: F401

    ref, ours, pr, im, target, q, inv_mass = _replay_setup()
    depths = []
    for seed, eps in ((7, 0.01), (8, 0.003)):
        key = jax.random.PRNGKey(seed)
        new_ref, info_ref = ref_nuts.nuts_kernel(ref, max_depth=8)(
            key, pr, eps, im)
        draws = _ReplayNUTS(key)
        new, info = nuts.nuts_kernel(target, max_depth=8)(
            draws, q, eps, inv_mass)
        assert int(info["depth"][0]) == int(info_ref["depth"])
        assert int(info["num_steps"][0]) == int(info_ref["num_steps"])
        assert bool(info["diverging"][0]) == bool(info_ref["diverging"])
        np.testing.assert_allclose(new[0].numpy(), _flat_ref(new_ref),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(float(info["accept_prob"][0]),
                                   float(info_ref["accept_prob"]), rtol=1e-4)
        np.testing.assert_allclose(float(info["log_prob"][0]),
                                   float(info_ref["log_prob"]), rtol=1e-6)
        assert draws.calls.count("leaf") == int(info_ref["num_steps"])
        depths.append(int(info_ref["depth"]))
    assert max(depths) >= 3, depths


# --------------------------------------------------------------------------
# the deterministic pieces


def test_dual_averaging_matches_the_reference(x64):
    accs = [0.3, 0.95, 0.71, 0.0, 1.0, 0.82, 0.64]
    st_ref = ref_hmc.da_init(jnp.asarray(0.1))
    st = hmc.da_init(0.1)
    for a in accs:
        st_ref = ref_hmc.da_update(st_ref, a, target=0.8)
        st = hmc.da_update(st, a, target=0.8)
        for f in st._fields:
            np.testing.assert_allclose(float(getattr(st, f)),
                                       float(getattr(st_ref, f)), rtol=1e-13)
    # per chain, as the samplers run it
    st = hmc.da_init(torch.tensor([0.1, 0.2], dtype=torch.float64))
    st = hmc.da_update(st, torch.tensor([0.3, 0.9], dtype=torch.float64))
    for i, (e, a) in enumerate(((0.1, 0.3), (0.2, 0.9))):
        r = ref_hmc.da_update(ref_hmc.da_init(jnp.asarray(e)), a)
        np.testing.assert_allclose(float(st.log_eps[i]), float(r.log_eps),
                                   rtol=1e-13)


def test_welford_matches_the_reference():
    """float32 running moments: 1e-6 relative."""
    rng = np.random.default_rng(4)
    xs = rng.standard_normal((9, 2, 7)).astype(np.float32)
    wr = ref_hmc.welford_init({"a": jnp.zeros((2, 7), jnp.float32)})
    w = hmc.welford_init(torch.zeros(2, 7))
    for x in xs:
        wr = ref_hmc.welford_update(wr, {"a": jnp.asarray(x)})
        w = hmc.welford_update(w, _t(x))
    np.testing.assert_allclose(w.mean.numpy(), np.asarray(wr.mean["a"]),
                               rtol=1e-6)
    np.testing.assert_allclose(w.m2.numpy(), np.asarray(wr.m2["a"]),
                               rtol=1e-6)
    prior = (0.1 + rng.random((2, 7))).astype(np.float32)
    for pv in (None, prior):
        vr = ref_hmc.welford_variance(
            wr, prior=None if pv is None else {"a": jnp.asarray(pv)})["a"]
        v = hmc.welford_variance(w, prior=None if pv is None else _t(pv))
        np.testing.assert_allclose(v.numpy(), np.asarray(vr), rtol=1e-6)


def test_uturn_checkpoints_match_the_reference():
    """_leaf_to_ckpt for leaves 0..299, the leaf table's rows, and
    _iterative_turning on random momenta (per chain, against the
    reference on each chain)."""
    leaf_ref = jax.jit(ref_nuts._leaf_to_ckpt)
    for n in range(300):
        lo, hi = leaf_ref(jnp.int32(n))
        assert nuts._leaf_to_ckpt(n) == (int(lo), int(hi)), n
    rng = np.random.default_rng(6)
    c, d, dim = 5, 9, 6
    inv_mass = (0.5 + rng.random((c, dim))).astype(np.float32)
    p = rng.standard_normal((c, dim)).astype(np.float32)
    p_sum = rng.standard_normal((c, dim)).astype(np.float32)
    ck = rng.standard_normal((c, d, dim)).astype(np.float32)
    ps = rng.standard_normal((c, d, dim)).astype(np.float32)
    turn_ref = jax.jit(ref_nuts._iterative_turning, static_argnums=(5, 6))
    table = nuts._leaf_table(8, "cpu")
    for n in (1, 3, 7, 11, 15, 63):
        lo, hi = nuts._leaf_to_ckpt(n)
        assert table[n].tolist() == [0, 0, lo, hi]
        slots = torch.arange(d)
        ours = nuts._iterative_turning(_t(inv_mass), _t(p), _t(p_sum),
                                       _t(ck), _t(ps),
                                       (slots >= lo) & (slots <= hi))
        for i in range(c):
            r = turn_ref(inv_mass[i], p[i], p_sum[i], ck[i], ps[i], lo, hi)
            assert bool(ours[i]) == bool(r), (n, i)


def test_halton_jitter_matches_the_reference():
    i = np.arange(0, 1000)
    np.testing.assert_array_equal(chees._halton2(i), ref_chees._halton2(i))


def test_smc_temperature_bisection_matches_the_reference(x64):
    """The next inverse temperature on fixed log-likelihoods, float64:
    1e-12 absolute."""
    rng = np.random.default_rng(8)
    next_ref = jax.jit(ref_smc._next_temp, static_argnums=(2, 3))
    for spread, temp in ((1.0, 0.0), (40.0, 0.0), (300.0, 0.25),
                         (5.0, 0.9), (2000.0, 0.5)):
        ll = -spread * rng.random(128) - 1e3
        ours = smc._next_temp(ll, temp, 0.5, 128)
        ref = next_ref(jnp.asarray(ll), jnp.asarray(temp, jnp.float64),
                       0.5, 128)
        np.testing.assert_allclose(float(ours), float(ref), atol=1e-12)


@pytest.mark.parametrize("shape", [(4, 500), (3, 200, 5), (2, 64, 3, 2)])
def test_diagnostics_equal_the_references(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).cumsum(axis=1) * 0.1 \
        + rng.standard_normal(shape)
    for f in ("split_rhat", "rank_normalized_rhat", "ess"):
        np.testing.assert_allclose(getattr(diagnostics, f)(x),
                                   getattr(ref_diag, f)(x), rtol=1e-12)
    tree = {"b": x, "a": 2.0 * x[:, ::-1]}
    for mp in (0, 2):
        assert diagnostics.summarize(tree, max_params=mp) == \
            ref_diag.summarize(tree, max_params=mp)


def test_leapfrog_step_counts_mask_each_chain():
    """hmc.Leapfrog with per-chain step counts (1, 3, 5), as ChEES's
    jittered trajectories load it: each chain ends, bitwise, where every
    chain ends after its count of unmasked steps; its count reaches 0."""
    rng = np.random.default_rng(6)
    _, _, x = simulate_psd(12, 20, 2, seed=6)
    pot = PSDPotential(x=torch.from_numpy(x), alpha=0.5, scale_sigma=0.05,
                       acc_dtype=torch.float64)
    pr = _params(rng, 12, 20, 2, (3,))
    target = hmc.Target(pot, {k: _t(v[0]) for k, v in pr.items()})
    q = target.flat({k: _t(v) for k, v in pr.items()})
    p = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    lp, g = target.value_and_grad(q)
    lf = hmc.Leapfrog(target, q, lp)

    def run(steps, n):
        lf.load(q, p, g, lp, 0.01, 1.0, steps)
        for _ in range(n):
            lf.step()
        return [t.clone() for t in (lf.q, lf.p, lf.g, lf.lp)]

    counts = torch.tensor([1, 3, 5])
    masked = run(counts, 5)
    assert int(lf.left.abs().sum()) == 0
    for i, n in enumerate(counts.tolist()):
        for a, b in zip(masked, run(n, n)):
            assert torch.equal(a[i], b[i])


def test_chains_stay_in_place_on_one_device():
    tree = {"z": torch.zeros(4, 3)}
    assert chains.maybe_shard_leading(tree, 4, True) is tree
    assert chains.maybe_shard_leading(tree, 4, False) is tree


# --------------------------------------------------------------------------
# the samplers against exact answers (tests/test_mcmc.py's sizes and limits)


def _conjugate_problem(seed=0, n=40, l=6):
    """K = 1: beta_j | x ~ Beta(1 + sum_i x_ij, 1 + sum_i (2 - x_ij))."""
    rng = np.random.default_rng(seed)
    beta_true = rng.uniform(0.2, 0.8, size=l)
    x = rng.binomial(2, np.broadcast_to(beta_true, (n, l))).astype(np.int8)
    a = 1.0 + x.sum(0)
    b = 1.0 + (2 - x).sum(0)
    post_mean = a / (a + b)
    post_var = a * b / ((a + b) ** 2 * (a + b + 1))
    return PSDPotential(x=torch.from_numpy(x), alpha=1.0), post_mean, post_var


def _beta(samples):
    return 1.0 / (1.0 + np.exp(-np.asarray(samples["z_beta"], np.float64)))


def test_hmc_matches_conjugate_posterior():
    pot, post_mean, post_var = _conjugate_problem()
    samples, info = run_hmc(2, pot, init_params(pot, 1, k=1),
                            n_samples=2000, n_warmup=600, n_leapfrog=24)
    beta = _beta(samples)[:, :, 0]
    assert 0.5 < info["accept_rate"] <= 1.0
    np.testing.assert_allclose(beta.mean(0), post_mean, atol=0.03)
    np.testing.assert_allclose(beta.var(0), post_var, rtol=0.6, atol=5e-4)


def test_nuts_matches_conjugate_posterior():
    pot, post_mean, post_var = _conjugate_problem()
    samples, info = run_nuts(4, pot, init_params(pot, 3, k=1),
                             n_samples=500, n_warmup=300, max_depth=6)
    beta = _beta(samples)[:, :, 0]
    assert info["divergence_rate"] < 0.05
    np.testing.assert_allclose(beta.mean(0), post_mean, atol=0.03)
    np.testing.assert_allclose(beta.var(0), post_var, rtol=0.6, atol=5e-4)


def test_nuts_multichain():
    pot, post_mean, _ = _conjugate_problem()
    samples, info = run_nuts(6, pot, init_params(pot, 5, k=1, n_chains=2),
                             n_samples=200, n_warmup=200, max_depth=6,
                             n_chains=2)
    beta = _beta(samples)                        # (2, S, L, 1)
    assert beta.shape[:2] == (2, 200) and info["eps"].shape == (2,)
    np.testing.assert_allclose(beta[0].mean(0), beta[1].mean(0), atol=0.05)
    np.testing.assert_allclose(beta.mean((0, 1))[:, 0], post_mean, atol=0.04)


def test_smc_matches_conjugate_posterior():
    pot, post_mean, _ = _conjugate_problem(n=30, l=4)
    n_particles = 256
    g = torch.Generator().manual_seed(7)
    u = torch.rand((n_particles, pot.l, 1), generator=g) \
        * (1 - 2e-4) + 1e-4
    zt = torch.log(torch.from_numpy(np.random.default_rng(7).standard_gamma(
        pot.alpha, (n_particles, pot.n, 1)).astype(np.float32)))
    particles0 = {"z_theta": zt, "z_beta": torch.log(u / (1 - u))}
    particles, diag = run_smc(8, pot.log_prior, pot.log_lik, particles0,
                              n_particles=n_particles, n_mutations=3,
                              n_leapfrog=8, mutation_eps=0.2)
    assert diag["temps"][-1] >= 1.0 - 1e-6
    beta = _beta(particles)[:, :, 0]
    np.testing.assert_allclose(beta.mean(0), post_mean, atol=0.05)


def _gaussian():
    cov = np.array([[1.0, 0.6], [0.6, 0.5]])
    prec = torch.from_numpy(np.linalg.inv(cov).astype(np.float32))

    def log_prob(params):
        z = params["z"]
        return -0.5 * z @ prec @ z

    return cov, log_prob


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_gaussian_target(sampler):
    """A correlated 2-D Gaussian written for one chain (the samplers vmap
    it)."""
    cov, log_prob = _gaussian()
    params0 = {"z": torch.zeros(2)}
    if sampler == "hmc":
        samples, _ = run_hmc(0, log_prob, params0, n_samples=2000,
                             n_warmup=500, n_leapfrog=8)
    else:
        samples, _ = run_nuts(0, log_prob, params0, n_samples=2000,
                              n_warmup=500, max_depth=6)
    z = samples["z"]
    np.testing.assert_allclose(z.mean(0), [0, 0], atol=0.12)
    np.testing.assert_allclose(np.cov(z.T), cov, atol=0.15)


def test_nuts_nonfinite_energy_is_divergence():
    """Mirror of tests/test_mcmc.py:284: a NaN cliff outside |q| < 2."""

    def log_prob(params):
        q = params["q"]
        lp = -0.5 * torch.sum(q**2)
        return torch.where(torch.all(torch.abs(q) < 2.0), lp, torch.nan)

    samples, info = run_nuts(0, log_prob, {"q": torch.zeros(3, 2)},
                             n_samples=50, n_warmup=50, max_depth=5,
                             init_eps=0.5)
    assert np.isfinite(np.asarray(info["eps"])).all()
    assert np.isfinite(samples["q"]).all()
    assert info["accept_rate"] > 0.1
    assert info["divergence_rate"] > 0


def test_chees_matches_conjugate_posterior():
    pot, post_mean, post_var = _conjugate_problem()
    samples, info = chees.run_chees(10, pot,
                                    init_params(pot, 9, k=1, n_chains=16),
                                    n_samples=150, n_warmup=300, n_chains=16)
    beta = _beta(samples)                        # (16, S, L, 1)
    assert beta.shape[0] == 16
    assert 0.2 < info["accept_rate"] <= 1.0
    pooled = beta.reshape(-1, beta.shape[2])
    np.testing.assert_allclose(pooled.mean(0), post_mean, atol=0.03)
    np.testing.assert_allclose(pooled.var(0), post_var, rtol=0.6, atol=5e-4)


def test_chees_gaussian_covariance():
    cov, log_prob = _gaussian()
    C = 16
    init = {"z": 0.1 * torch.randn((C, 2),
                                   generator=torch.Generator().manual_seed(1))}
    s, info = chees.run_chees(0, log_prob, init, n_samples=300,
                              n_warmup=300, n_chains=C)
    z = s["z"].reshape(-1, 2)
    np.testing.assert_allclose(z.mean(0), [0, 0], atol=0.12)
    np.testing.assert_allclose(np.cov(z.T), cov, atol=0.15)
    assert info["trajectory_length"] > 2 * info["eps"]


def test_chees_traj_mult_truncation_clamps_and_reports():
    def log_prob(params):
        z = params["z"]
        return -0.5 * torch.sum(z * z)

    C = 8
    init = {"z": 0.1 * torch.randn((C, 2),
                                   generator=torch.Generator().manual_seed(2))}
    kw = dict(n_samples=20, n_warmup=60, n_chains=C, dispatch_chunk=20)
    _, info_big = chees.run_chees(3, log_prob, init, sample_traj_mult=1e6,
                                  max_leapfrog=64, **kw)
    assert info_big["traj_truncated"] is True
    assert info_big["trajectory_length"] <= info_big["eps"] * 64 * 1.001
    _, info_ok = chees.run_chees(3, log_prob, init, sample_traj_mult=1.0,
                                 max_leapfrog=1024, **kw)
    assert info_ok["traj_truncated"] is False
    with pytest.raises(ValueError, match=">= 2 chains"):
        chees.run_chees(3, log_prob, {"z": torch.zeros(1, 2)}, n_samples=2,
                        n_chains=1)
