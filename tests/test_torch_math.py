"""The port's model math, packing, dense statistics and data layer against
the JAX reference on identical numpy inputs (CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.special as sps
import torch

from terastructure_tpu.data import GenotypeData as RefData
from terastructure_tpu.data import pack as ref_pack
from terastructure_tpu.data import simulate_psd as ref_simulate_psd
from terastructure_tpu.models import psd as ref_psd
from terastructure_tpu.ops import stats_dense as ref_ops
from terastructure_tpu_torch.data import GenotypeData, pack, simulate_psd
from terastructure_tpu_torch.models import psd
from terastructure_tpu_torch.ops import fused_step
from terastructure_tpu_torch.ops import stats_dense as ops

# f32 math on both sides, different libraries: a few ulp
TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _inputs(seed=0, m=40, k=4):
    rng = np.random.default_rng(seed)
    return dict(
        gamma=rng.uniform(0.1, 5.0, (m, k)).astype(np.float32),
        lamb=rng.uniform(0.2, 8.0, (m, k, 2)).astype(np.float32),
        x=rng.integers(0, 3, m).astype(np.int8),
        p=rng.uniform(0.01, 0.99, m).astype(np.float32),
        ind=rng.integers(0, m, m).astype(np.int32),
        snp=rng.integers(0, m, m).astype(np.int32),
    )


PSD_CASES = {
    "elog_dirichlet": lambda m, a: m.elog_dirichlet(a["gamma"]),
    "elog_beta": lambda m, a: m.elog_beta(a["lamb"]),
    "theta_mean": lambda m, a: m.theta_mean(a["gamma"]),
    "beta_mean": lambda m, a: m.beta_mean(a["lamb"]),
    "binomial2_loglik": lambda m, a: m.binomial2_loglik(a["x"], a["p"]),
    "variational_probs": lambda m, a: m.variational_predictive_probs(
        a["gamma"], a["lamb"]),
    "variational_loglik": lambda m, a: m.variational_predictive_loglik(
        a["gamma"], a["lamb"], a["x"]),
    "predictive_plugin": lambda m, a: m.predictive_loglik(
        a["gamma"], a["lamb"], a["ind"], a["snp"], a["x"]),
    "predictive_variational": lambda m, a: m.predictive_loglik(
        a["gamma"], a["lamb"], a["ind"], a["snp"], a["x"],
        form="variational"),
}


@pytest.mark.parametrize("name", sorted(PSD_CASES))
def test_psd_matches_reference(name):
    a = _inputs()
    got = PSD_CASES[name](psd, {k: _t(v) for k, v in a.items()})
    want = PSD_CASES[name](ref_psd, {k: _j(v) for k, v in a.items()})
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_pack_bitwise_and_torch_unpack():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 4, (7, 37)).astype(np.int8)       # ragged N
    p = pack.pack2bit(x)
    np.testing.assert_array_equal(p, ref_pack.pack2bit(x))
    np.testing.assert_array_equal(pack.unpack2bit(p, 37),
                                  ref_pack.unpack2bit(p, 37))
    np.testing.assert_array_equal(
        pack.unpack2bit_torch(_t(p), 37).numpy(),
        np.asarray(ref_pack.unpack2bit_jnp(_j(p), 37)))


def _dense_problem(b=12, n=96, k=3, seed=2):
    rng = np.random.default_rng(seed)
    return dict(
        xb=rng.integers(0, 4, (b, n)).astype(np.int8),
        gamma=rng.uniform(0.3, 3.0, (n, k)).astype(np.float32),
        lamb=rng.uniform(0.5, 4.0, (b, k, 2)).astype(np.float32),
    )


def _stats_case(m, a, which):
    a1, a0 = m.allele_counts(a["xb"], a["f32"])
    u = m.exp_elog_theta(a["gamma"])
    t1, t0 = m.exp_elog_beta(a["lamb"])
    if which == "allele_counts":
        return a1, a0
    if which == "exp_elog":
        return u, t1, t0
    if which == "lambda_stats":
        return m.lambda_stats(a1, a0, u, t1, t0)
    return tuple(m.batch_stats(a1, a0, u, t1, t0))


@pytest.mark.parametrize("which", ["allele_counts", "exp_elog",
                                   "lambda_stats", "batch_stats"])
def test_stats_dense_matches_reference(which):
    a = _dense_problem()
    got = _stats_case(ops, {**{k: _t(v) for k, v in a.items()},
                            "f32": torch.float32}, which)
    want = _stats_case(ref_ops, {**{k: _j(v) for k, v in a.items()},
                                 "f32": jnp.float32}, which)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5, atol=1e-4)


def test_aitken_final_matches_reference():
    rng = np.random.default_rng(3)
    prev, cur, new = (rng.normal(2.0, 1.0, (64, 3, 2)).astype(np.float32)
                      for _ in range(3))
    cur[0, 0, 0] = prev[0, 0, 0] + 1.0                     # den == 0 branch
    new[0, 0, 0] = cur[0, 0, 0] + 1.0
    np.testing.assert_array_equal(
        ops.aitken_final(_t(prev), _t(cur), _t(new)).numpy(),
        np.asarray(ref_ops.aitken_final(_j(prev), _j(cur), _j(new))))


def _firing_tol(a):
    """A tol between the observed deltas after plain passes 2 and 3, so
    the tol-gated loop stops mid-loop (as tests/test_solve_schedule.py)."""
    xb, gamma = _j(a["xb"]), _j(a["gamma"])
    a1, a0 = ref_ops.allele_counts(xb, jnp.float32)
    u = ref_ops.exp_elog_theta(gamma)
    lam = jnp.ones(a["lamb"].shape, jnp.float32)
    deltas = []
    for _ in range(3):
        t1, t0 = ref_ops.exp_elog_beta(lam)
        l0, l1 = ref_ops.lambda_stats(a1, a0, u, t1, t0)
        new = jnp.stack([1.0 + l0, 1.0 + l1], -1)
        deltas.append(float(jnp.mean(jnp.abs(new - lam))
                            / (jnp.mean(jnp.abs(lam)) + 1.0)))
        lam = new
    assert deltas[2] < deltas[1]
    return float(np.sqrt(deltas[1] * deltas[2]))


@pytest.mark.parametrize("accel,iters,tol", [
    (False, 6, -1.0), (True, 6, -1.0),            # loop + accel tail
    (False, 7, "fires"), (True, 7, "fires"),      # tol fires mid-loop
    (True, 2, -1.0),                              # accel needs >= 3 passes
])
def test_local_solve_schedule_matches_reference(accel, iters, tol):
    a = _dense_problem(b=16, n=128, k=3, seed=5)
    if tol == "fires":
        tol = _firing_tol(a)
    ones = np.ones_like(a["lamb"])

    def solve(m, conv, f32):
        a1, a0 = m.allele_counts(conv(a["xb"]), f32)
        u = m.exp_elog_theta(conv(a["gamma"]))
        return m.local_solve(a1, a0, u, conv(ones), beta_a=1.0, beta_b=1.0,
                             local_iters=iters, local_tol=tol, accel=accel)

    got = solve(ops, _t, torch.float32).numpy()
    want = np.asarray(solve(ref_ops, _j, jnp.float32))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_solve_schedule_masking_stops_where_the_loop_would():
    """Device-side masking == the reference's tol-gated while loop on a
    scalar contraction whose delta sequence is known exactly."""
    def it_t(lam):
        return 0.5 * lam + 1.0

    lam0 = np.full((4, 2, 2), 10.0, np.float32)
    for tol in (0.3, 0.05, 1e-3, -1.0):
        for accel in (False, True):
            got = ops.solve_schedule(it_t, _t(lam0), local_iters=7,
                                     local_tol=tol, accel=accel)
            want = ref_ops.solve_schedule(it_t, _j(lam0), local_iters=7,
                                          local_tol=tol, accel=accel)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_kernel_digamma_matches_scipy():
    # down to 1e-3, the aitken_final floor (tests/test_fused.py:17-27)
    rng = np.random.default_rng(42)
    x = np.concatenate([rng.uniform(1e-3, 0.05, 200),
                        rng.uniform(0.05, 6.0, 500),
                        rng.uniform(6.0, 5000.0, 500)]).astype(np.float32)
    got = fused_step.digamma(_t(x)).numpy()
    np.testing.assert_allclose(got, sps.digamma(x.astype(np.float64)),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        got, np.asarray(ref_fused_digamma(_j(x))), rtol=1e-6, atol=1e-6)


def ref_fused_digamma(x):
    from terastructure_tpu.ops import fused_step as ref_fused

    return ref_fused.digamma(x)


@pytest.mark.parametrize("missing", [0.0, 0.05])
def test_simulate_and_split_bitwise(missing):
    ref = ref_simulate_psd(50, 300, 3, seed=9, missing_frac=missing)
    got = simulate_psd(50, 300, 3, seed=9, missing_frac=missing)
    for g, w in zip(got, ref):
        np.testing.assert_array_equal(g, w)
    kw = dict(validation_frac=0.02, heldout_frac=0.01, seed=9)
    d = GenotypeData.from_dense(got[2], **kw)
    r = RefData.from_dense(ref[2], **kw)
    np.testing.assert_array_equal(d.packed, r.packed)
    for es, rs in ((d.validation, r.validation), (d.heldout, r.heldout)):
        for f in ("ind_idx", "snp_idx", "x"):
            np.testing.assert_array_equal(getattr(es, f), getattr(rs, f))


def test_from_packed_snp_pool_bitwise():
    _, _, x = ref_simulate_psd(40, 500, 2, seed=4)
    packed = ref_pack.pack2bit(np.ascontiguousarray(x.T))
    kw = dict(validation_frac=0.01, heldout_frac=0.01, seed=4,
              eval_snp_pool=64, copy=True)
    d = GenotypeData.from_packed(packed, 40, **kw)
    r = RefData.from_packed(packed, 40, **kw)
    np.testing.assert_array_equal(d.packed, r.packed)
    np.testing.assert_array_equal(d.validation.snp_idx, r.validation.snp_idx)
    assert len(np.unique(d.validation.snp_idx)) <= 64
