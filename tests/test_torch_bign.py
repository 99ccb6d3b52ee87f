"""The port's big-N per-iteration path against the reference's (CPU): the
twins of K5, K6, K7 and K8 against the reference's Pallas kernels in
interpret mode (as tests/test_pallas.py runs them), decode_count_planes,
local_solve_acat, and the gate that sends a step there. The step itself
is held to the reference's in tests/test_torch_bign_step.py; the kernels
to their twins on the card in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.data.pack import pack2bit
from terastructure_tpu.ops import fused_step as ref_fused
from terastructure_tpu.ops import stats_dense as ref_ops
from terastructure_tpu.ops import stats_pallas as ref_pk
from terastructure_tpu_torch.ops import stats_packed as pk
from terastructure_tpu_torch.svi import engine

TOL = dict(rtol=2e-5, atol=1e-5)            # as tests/test_pallas.py:98-140
TOL_APPROX = dict(rtol=5e-3, atol=5e-3)     # fast reciprocal vs exact


def _problem(b=24, n=4096, k=4, seed=5):
    """Multi-tile for the reference: b=24 -> 3 batch tiles of 8, n=4096 ->
    2 w-tiles of 512 (tests/test_pallas.py:98-140)."""
    rng = np.random.default_rng(seed)
    rows = pack2bit(rng.integers(0, 4, size=(b, n)).astype(np.int8))
    gamma = rng.uniform(0.3, 3.0, size=(n, k)).astype(np.float32)
    u = np.array(ref_ops.exp_elog_theta(jnp.asarray(gamma)))
    lamb = rng.uniform(0.5, 4.0, size=(b, k, 2)).astype(np.float32)
    t1, t0 = (np.array(t) for t in ref_ops.exp_elog_beta(jnp.asarray(lamb)))
    return rows, u, t1, t0


def _ref_kw(rows):
    tb, tw = ref_pk.pick_tiles(*rows.shape)
    assert rows.shape[1] // tw > 1 and rows.shape[0] // tb > 1
    return dict(tb=tb, tw=tw, dtype=jnp.float32, interpret=True)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def test_decode_count_planes_bitwise():
    rows, *_ = _problem(b=8, n=512)
    got = pk.decode_count_planes(torch.from_numpy(rows))
    want = ref_pk.decode_count_planes(jnp.asarray(rows))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


@pytest.mark.parametrize("approx_div", [False, True])
def test_lambda_stats_acat_twin_matches_reference_kernel(approx_div):
    rows, u, t1, t0 = _problem(seed=7)
    up = np.array(ref_pk.u_to_planes(jnp.asarray(u)))
    a1, a0 = pk.decode_count_planes(torch.from_numpy(rows))
    got = pk.lambda_stats_acat(a1, a0, *_t(up, t1, t0),
                               approx_div=approx_div)
    ra1, ra0 = ref_pk.decode_count_planes(jnp.asarray(rows))
    want = ref_pk.lambda_stats_acat(ra1, ra0, up, t1, t0, approx_div=approx_div,
                                    **_ref_kw(rows))
    _close(got, want, TOL_APPROX if approx_div else TOL)


# K = 4 and the K-width of 12 that the gamma pass and K7 run at K = 9..12
KS = [4, 9, 10, 12, 13]


@pytest.mark.parametrize("k", KS)
def test_gamma_stats_twin_matches_reference_kernel(k):
    rows, u, t1, t0 = _problem(k=k, seed=8)
    up = np.array(ref_pk.u_to_planes(jnp.asarray(u)))
    got = pk.gamma_stats_packed(*_t(rows, up, t1, t0))
    want = ref_pk.gamma_stats_packed(rows, up, t1, t0, **_ref_kw(rows))
    _close([got], [want], TOL)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", ["batch_stats_fused_v2_packed",
                                  "batch_stats_fused_packed",
                                  "batch_stats_packed"])
def test_stats_pass_matches_reference_kernel(name, k):
    """K7, K6 and the pair (K4 + K5) against the reference's kernels, and
    each against the reference's pair."""
    rows, u, t1, t0 = _problem(k=k, seed=6)
    kw = _ref_kw(rows)
    got = getattr(pk, name)(*_t(rows, u, t1, t0))
    _close(got, getattr(ref_pk, name)(rows, u, t1, t0, **kw), TOL)
    _close(got, ref_pk.batch_stats_packed(rows, u, t1, t0, **kw), TOL)


def test_stats_v2_approx_div_matches_reference_kernel():
    rows, u, t1, t0 = _problem(b=16, n=2048, seed=7)
    got = pk.batch_stats_fused_v2_packed(*_t(rows, u, t1, t0),
                                         approx_div=True)
    tb, tw = ref_pk.pick_tiles(*rows.shape)
    kw = dict(tb=tb, tw=tw, dtype=jnp.float32, interpret=True)
    _close(got, ref_pk.batch_stats_fused_v2_packed(
        rows, u, t1, t0, approx_div=True, **kw), TOL_APPROX)
    _close(got, ref_pk.batch_stats_fused_v2_packed(rows, u, t1, t0, **kw),
           TOL_APPROX)


@pytest.mark.parametrize("b", [12, 24])
def test_stats_twins_take_any_batch(b):
    """The port needs no batch padding: a ragged B gives the rows of the
    reference's pass over the batch padded with all-MISSING rows."""
    rows, u, t1, t0 = _problem(b=b, n=1024, seed=b)
    pad = (-b) % 8 + 8 * (b % 8 == 0)
    rows_p = np.pad(rows, ((0, pad), (0, 0)), constant_values=0xFF)
    t1_p = np.pad(t1, ((0, pad), (0, 0)), constant_values=1.0)
    t0_p = np.pad(t0, ((0, pad), (0, 0)), constant_values=1.0)
    tb, tw = ref_pk.pick_tiles(*rows_p.shape)
    want = ref_pk.batch_stats_packed(rows_p, u, t1_p, t0_p, tb=tb, tw=tw,
                                     dtype=jnp.float32, interpret=True)
    for name in ("batch_stats_fused_v2_packed", "batch_stats_fused_packed",
                 "batch_stats_packed"):
        got = getattr(pk, name)(*_t(rows, u, t1, t0))
        _close(got, [want[0], want[1][:b], want[2][:b]], TOL)


@pytest.mark.parametrize("accel,approx_div", [(False, False), (True, False),
                                              (False, True)])
def test_local_solve_acat_matches_reference(accel, approx_div):
    rows, u, _, _ = _problem(b=16, n=512, k=3, seed=11)
    lamb = np.random.default_rng(3).uniform(0.5, 3.0, (16, 3, 2)).astype(
        np.float32)
    kw = dict(beta_a=1.0, beta_b=1.0, local_iters=6, local_tol=-1.0,
              accel=accel, stat_scale=2.0, approx_div=approx_div)
    got = pk.local_solve_acat(*_t(rows, u, lamb), **kw)
    assert got.shape == (16, 3, 2)
    want = ref_pk.local_solve_acat(
        jnp.asarray(rows), jnp.asarray(u), jnp.asarray(lamb), tb=8, tw=128,
        dtype=jnp.float32, interpret=True, **kw)
    if approx_div:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL_APPROX)
    elif accel:     # the clamped Aitken step amplifies sum order
        _accel_close(got.numpy(), np.asarray(want))
    else:       # six passes of f32 sums in another order: 1e-6 normwise
        _normwise(got.numpy(), np.asarray(want), 1e-6)
    # the same solve through the packed-row pass (sub_decode_once=False)
    packed = pk.local_solve_packed(*_t(rows, u, lamb), **kw)
    _normwise(got.numpy(), packed.numpy(), 1e-6)


def _normwise(got, want, tol):
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _accel_close(got, want):
    """tests/test_torch_engine.py's accel rule: 99.5% of the entries
    within 2e-4, all within 5e-3 relative."""
    bad = np.abs(got - want) > 2e-4 + 2e-4 * np.abs(want)
    assert bad.mean() <= 5e-3, bad.mean()
    np.testing.assert_allclose(got, want, rtol=5e-3)


@pytest.mark.parametrize("b,w,k,impl", [
    (4096, 25_088, 10, "pallas"),      # 100K individuals: the biobank regime
    (4096, 640, 8, "fused"),           # the TGP shape
    (12, 128, 3, "pallas"),            # no batch tile: outside the gate
    (256, 256, 3, "fused"),            # config #1
])
def test_gate_sends_big_n_shapes_to_the_per_iteration_path(b, w, k, impl):
    cfg = SVIConfig(n=4 * w, l=100_000, k=k, batch_size=b, snp_group=8)
    assert engine.step_impl(cfg, w) == impl
    assert ref_fused.supports(b, w, k, jnp.float32,
                              accel=cfg.local_accel) == (impl == "fused")
    assert engine.step_impl(cfg.replace(kernel="pallas"), w) == "pallas"
    assert engine.step_impl(cfg.replace(kernel="dense"), w) == "dense"


def test_kernel_wrappers_reject_bad_shapes():
    rows = torch.zeros((8, 128), dtype=torch.uint8)
    u = torch.ones((512, 3))
    t = torch.ones((8, 3))
    with pytest.raises(ValueError):
        pk.batch_stats_fused_v2_packed(rows, u[:256], t, t)
    with pytest.raises(ValueError):
        pk.batch_stats_fused_packed(rows, u, t[:4], t)
    with pytest.raises(ValueError):
        pk.gamma_stats_packed(rows, pk.u_to_planes(u), t, t[:, :2])
    a = torch.zeros((8, 3, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        pk.lambda_stats_acat(a, a, pk.u_to_planes(u), t, t)
