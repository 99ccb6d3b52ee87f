"""The port's kernel twins against the reference's Pallas kernels (run in
interpret mode on the CPU, as tests/test_fused.py and test_pallas.py do),
and the port's fused gate against the reference's. The kernels themselves
are held to their twins on the card by tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from terastructure_tpu.data.pack import pack2bit
from terastructure_tpu.ops import fused_step as ref_fused
from terastructure_tpu.ops import gather as ref_gather
from terastructure_tpu.ops import stats_dense as ref_ops
from terastructure_tpu.ops import stats_pallas as ref_pk
from terastructure_tpu_torch.ops import fused_step, gather, stats_packed

TOL = dict(rtol=2e-4, atol=2e-4)           # as tests/test_fused.py:59-62


def _problem(b=16, n=512, k=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 4, size=(b, n)).astype(np.int8)   # with MISSING
    rows = pack2bit(x)
    gamma = rng.uniform(0.3, 3.0, size=(n, k)).astype(np.float32)
    u = np.asarray(ref_ops.exp_elog_theta(jnp.asarray(gamma)))
    up = np.array(ref_pk.u_to_planes(jnp.asarray(u)))
    lamb = rng.uniform(0.5, 3.0, size=(b, k, 2)).astype(np.float32)
    return rows, up, lamb


def _firing_tol(rows, up, iters=7):
    """A local_tol between the deltas after plain passes 2 and 3."""
    a1, a0 = (np.asarray(a) for a in ref_pk.decode_count_planes(
        jnp.asarray(rows)))
    a1 = jnp.asarray(a1.reshape(a1.shape[0], -1))
    a0 = jnp.asarray(a0.reshape(a0.shape[0], -1))
    u = jnp.asarray(up.reshape(-1, up.shape[-1]))
    lam = jnp.ones((rows.shape[0], up.shape[-1], 2), jnp.float32)
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


K1_CASES = {
    "cold_plain": dict(local_iters=6, local_tol=-1.0),
    "cold_accel": dict(local_iters=6, local_tol=-1.0, accel=True),
    "warm_plain": dict(local_iters=4, local_tol=-1.0, warm_start=True),
    "warm_accel": dict(local_iters=7, local_tol=-1.0, warm_start=True,
                       accel=True),
    "tol_fires_accel": dict(local_iters=7, local_tol="fires", accel=True),
    "tol_fires_plain": dict(local_iters=7, local_tol="fires"),
    "default_accel7": dict(local_iters=7, local_tol=1e-4, accel=True),
}


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_fused_twin_matches_reference_kernel(case):
    rows, up, lamb = _problem(seed=len(case))
    kw = dict(K1_CASES[case], beta_a=1.0, beta_b=1.0)
    if kw["local_tol"] == "fires":
        kw["local_tol"] = _firing_tol(rows, up)
    got = fused_step.fused_local_solve(torch.from_numpy(rows),
                                       torch.from_numpy(up),
                                       torch.from_numpy(lamb), **kw)
    want = ref_fused.fused_local_solve(
        jnp.asarray(rows), jnp.asarray(up), jnp.asarray(lamb),
        dtype=jnp.float32, interpret=True, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_fused_twin_approx_div_matches_reference_kernel():
    rows, up, lamb = _problem(seed=8)
    kw = dict(local_iters=8, local_tol=0.0, beta_a=1.0, beta_b=1.0,
              approx_div=True)
    got = fused_step.fused_local_solve(torch.from_numpy(rows),
                                       torch.from_numpy(up),
                                       torch.from_numpy(lamb), **kw)
    want = ref_fused.fused_local_solve(
        jnp.asarray(rows), jnp.asarray(up), jnp.asarray(lamb),
        dtype=jnp.float32, interpret=True, **kw)
    for g, w in zip(got, want):       # fast reciprocal: tests/test_fused.py:258
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=5e-3, atol=5e-3)


def test_fused_twin_ragged_width_is_padding_invariant():
    """The port accepts any W: 0xFF bytes (MISSING) and u = 1.0 padding
    leave lambda and the real part of g unchanged."""
    rows, up, lamb = _problem(b=8, n=200, k=2, seed=3)        # W = 50
    kw = dict(local_iters=5, local_tol=-1.0, beta_a=1.0, beta_b=1.0)
    got = fused_step.fused_local_solve(torch.from_numpy(rows),
                                       torch.from_numpy(up),
                                       torch.from_numpy(lamb), **kw)
    rows_p = np.pad(rows, ((0, 0), (0, 78)), constant_values=0xFF)
    up_p = np.pad(up, ((0, 0), (0, 78), (0, 0)), constant_values=1.0)
    want = fused_step.fused_local_solve(torch.from_numpy(rows_p),
                                        torch.from_numpy(up_p),
                                        torch.from_numpy(lamb), **kw)
    # the matmuls' sum order depends on W: f32 rounding only
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), want[1][:, :50].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert float(want[1][:, 50:].abs().max()) == 0.0


def test_gather_twin_matches_reference_kernel():
    rng = np.random.default_rng(9)
    src = rng.integers(0, 256, size=(64, 256), dtype=np.uint8)
    blocks = rng.integers(0, 8, size=32).astype(np.int32)
    got = gather.gather_row_blocks(torch.from_numpy(src),
                                   torch.from_numpy(blocks))
    want = ref_gather.gather_row_blocks(jnp.asarray(src), jnp.asarray(blocks),
                                        block=8, blocks_in_flight=16,
                                        interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("approx_div", [False, True])
def test_lambda_stats_twin_matches_reference_kernel(approx_div):
    rows, up, lamb = _problem(b=24, n=1024, k=4, seed=6)
    t1, t0 = (np.array(t) for t in ref_ops.exp_elog_beta(jnp.asarray(lamb)))
    got = stats_packed.lambda_stats_packed(
        torch.from_numpy(rows), torch.from_numpy(up), torch.from_numpy(t1),
        torch.from_numpy(t0), approx_div=approx_div)
    tb, tw = ref_pk.pick_tiles(*rows.shape)
    want = ref_pk.lambda_stats_packed(
        jnp.asarray(rows), jnp.asarray(up), jnp.asarray(t1), jnp.asarray(t0),
        tb=tb, tw=tw, dtype=jnp.float32, interpret=True,
        approx_div=approx_div)
    tol = dict(rtol=5e-3, atol=5e-3) if approx_div else dict(rtol=2e-5,
                                                             atol=1e-4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def test_local_solve_packed_matches_reference():
    rows, up, lamb = _problem(b=16, n=512, k=3, seed=11)
    u = up.transpose(1, 0, 2).reshape(-1, 3)
    kw = dict(beta_a=1.0, beta_b=1.0, local_iters=6, local_tol=-1.0,
              accel=True, stat_scale=2.0)
    got = stats_packed.local_solve_packed(
        torch.from_numpy(rows), torch.from_numpy(u), torch.from_numpy(lamb),
        **kw)
    want = ref_pk.local_solve_packed(
        jnp.asarray(rows), jnp.asarray(u), jnp.asarray(lamb), tb=8, tw=128,
        dtype=jnp.float32, interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


SUPPORTS_GRID = [
    (b, w, k, accel)
    for b in (8, 13, 256, 1024, 2048, 4096, 8192)
    for w in (128, 130, 256, 640, 1280, 2560, 8192)
    for k in (2, 3, 7, 8, 10, 129)
    for accel in (False, True)
]


@pytest.mark.parametrize("accel", [False, True])
def test_supports_matches_reference_gate(accel):
    grid = [g for g in SUPPORTS_GRID if g[3] == accel]
    got = [fused_step.supports(b, w, k, accel=accel) for b, w, k, _ in grid]
    want = [ref_fused.supports(b, w, k, jnp.float32, accel=accel)
            for b, w, k, _ in grid]
    assert got == want
    assert any(got) and not all(got)
    # the bf16 itemsize enters the gate too
    assert (fused_step.supports(4096, 640, 8, torch.bfloat16, accel=True)
            == ref_fused.supports(4096, 640, 8, jnp.bfloat16, accel=True))


def test_supports_reference_cases():
    # tests/test_fused.py:106-200
    assert fused_step.supports(1024, 640)
    assert not fused_step.supports(1024, 8192)
    assert not fused_step.supports(1024, 130)
    assert not fused_step.supports(13, 128)
    assert not fused_step.supports(8192, 256)
    assert not fused_step.supports(4096, 128, 8, accel=True)
    assert fused_step.supports(4096, 256, 8, accel=True)
    assert fused_step.supports(4096, 640, 8, accel=True)
    assert fused_step.supports(1024, 256, 7)


def test_kernel_wrappers_reject_bad_inputs():
    rows = torch.zeros((8, 128), dtype=torch.uint8)
    up = torch.ones((4, 64, 3))
    with pytest.raises(ValueError):
        stats_packed.lambda_stats_packed(rows, up, torch.ones(8, 3),
                                         torch.ones(8, 3))
    with pytest.raises(ValueError):
        fused_step.fused_local_solve(rows, torch.ones(4, 128, 3),
                                     torch.ones(8, 2, 2), local_iters=3,
                                     local_tol=0.0, beta_a=1.0, beta_b=1.0)
