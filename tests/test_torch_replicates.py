"""Batched replicates (svi/replicates.py) in the port: the batched fit
against the port's single fits, bitwise; the batched K1 and K4 twins and
the batched eval re-solve against the reference's vmapped kernels in
interpret mode; the batched step bitwise the single steps on the paths
that once raised (K > 64, kernel="dense"); K2's group DMA, which has no
batched path (CPU). K > 64 and kernel="dense" against the reference:
tests/test_torch_replicates_wide.py. The kernels' replicate axis is held
to the single kernels on the card by tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terastructure_tpu.config import SVIConfig as RefConfig
from terastructure_tpu.data.pack import pack2bit
from terastructure_tpu.ops import fused_step as ref_fused
from terastructure_tpu.ops import stats_dense as ref_ops
from terastructure_tpu.ops import stats_pallas as ref_pk
from terastructure_tpu.svi import postprocess as ref_post
from terastructure_tpu_torch import SVIConfig
from terastructure_tpu_torch.data import GenotypeData, simulate_psd
from terastructure_tpu_torch.ops import fused_step, stats_packed
from terastructure_tpu_torch.svi import engine, fit, postprocess
from terastructure_tpu_torch.svi.replicates import (fit_replicates_batched,
                                                    unstack_state)

BF16 = torch.bfloat16
TOL = dict(rtol=2e-4, atol=2e-4)            # f32, as tests/test_fused.py
SOLVE_TOL = dict(rtol=2e-3, atol=1e-5)      # bf16 solve, test_torch_bf16
PASS_TOL = dict(rtol=1e-3, atol=1e-6)       # bf16 pass, test_torch_bf16
R = 3


def _data(n, l, k, seed, vfrac=0.02, hfrac=0.0):
    _, _, x = simulate_psd(n, l, k, seed=seed)
    return GenotypeData.from_dense(x, validation_frac=vfrac,
                                   heldout_frac=hfrac, seed=seed)


def _outliers(got, want, frac, tol, cap=1e-2):
    """At most `frac` of the entries beyond tol, and every entry within
    rtol `cap`: the accel tail's clamped Aitken step turns sum-order
    differences into up to 18|d1| on a few coordinates
    (tests/test_torch_engine.py)."""
    bad = np.abs(got - want) > tol["atol"] + tol["rtol"] * np.abs(want)
    assert bad.mean() <= frac, bad.mean()
    np.testing.assert_allclose(got, want, rtol=cap, atol=tol["atol"])


# --- the batched fit against single fits ------------------------------------
def test_batched_stored_fit_is_the_single_fits_bitwise():
    """tests/test_replicates.py:20-55 in the port: R = 3 stored-mode
    replicates, convergence off, 60 steps: each replicate's gamma, lambda
    and validation ll are its single fit's, bitwise, and the best index
    is the single fits' ranking."""
    n, l, k = 64, 256, 2
    data = _data(n, l, k, 31)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=32, rfreq=20, max_steps=60,
                    conv_tol=-1e9, lambda_mode="stored", seed=100)
    seeds = [100, 101, 102]
    res = fit_replicates_batched(cfg, data, seeds, device="cpu")
    assert res.trace[-1]["step"] == 60
    lls = []
    for i, s in enumerate(seeds):
        single = fit(cfg.replace(seed=s), data, device="cpu")
        st = unstack_state(res.states, i)
        assert (st.t, st.seed) == (60, s)
        assert torch.equal(st.gamma, single.state.gamma)
        assert torch.equal(st.lamb, single.state.lamb)
        assert res.replicates[i].validation_ll == single.validation_ll
        assert res.replicates[i].steps == single.steps
        lls.append(single.validation_ll)
    assert res.best == int(np.argmax(lls))


def test_batched_local_fit_converges_selects_and_stops_as_single_fits():
    """tests/test_replicates.py:58-76 in the port (local mode, to
    convergence), and each replicate's stop step, gamma at the stop and
    validation and heldout lls are its single fit's. The single fit's
    lambda is the export, which the batched fit does not make (as in the
    reference): the returned lambda is the prior."""
    n, l, k = 64, 256, 3
    data = _data(n, l, k, 33, vfrac=0.03, hfrac=0.03)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=32, rfreq=10, max_steps=1000,
                    conv_tol=1e-4, seed=7)
    seeds = [7, 8, 9]
    res = fit_replicates_batched(cfg, data, seeds, device="cpu")
    assert len(res.replicates) == 3
    assert all(np.isfinite(r.validation_ll) for r in res.replicates)
    assert any(r.converged for r in res.replicates)
    last = res.trace[-1]["step"]
    for i, (s, rr) in enumerate(zip(seeds, res.replicates)):
        assert rr.steps <= last
        single = fit(cfg.replace(seed=s), data, device="cpu")
        assert (rr.converged, rr.steps) == (single.converged, single.steps)
        assert torch.equal(res.states.gamma[i], single.state.gamma)
        assert rr.validation_ll == single.validation_ll
        assert rr.heldout_ll == single.heldout_ll
        assert torch.all(res.states.lamb[i] == 1.0)    # the prior
    best = res.replicates[res.best]
    assert best.validation_ll == max(r.validation_ll for r in res.replicates)


@pytest.mark.parametrize("change", [
    dict(kernel="dense"),
    dict(kernel="pallas", k=72),               # the big-N path at K > 64
    dict(k=72),                                # the K-chunked bodies
])
def test_paths_outside_the_slice_raise(change):
    """The paths that raised NotImplementedError before the replicate
    axis reached the K-chunked bodies and kernel="dense" (the name is
    kept from then): each now runs batched, and three batched steps
    leave every replicate's gamma and lambda bitwise three single steps'
    (dma_gather=False)."""
    cfg = SVIConfig(n=64, l=256, k=3, batch_size=32,
                    lambda_mode="stored").replace(**change)
    rng = np.random.default_rng(len(change))
    packed = torch.from_numpy(engine.pad_width(rng.integers(
        0, 256, size=(256, 16), dtype=np.uint8)))
    seeds = (2, 3)
    state = engine.init_replicate_state(cfg, seeds)
    step = engine.make_replicate_step(cfg)
    for _ in range(3):
        state = step(state, packed)
    one = engine.make_step(cfg.replace(dma_gather=False))
    for i, s in enumerate(seeds):
        st = engine.init_state(cfg.replace(seed=s))
        for _ in range(3):
            st = one(st, packed)
        assert torch.equal(state.gamma[i], st.gamma)
        assert torch.equal(state.lamb[i], st.lamb)


def test_group_dma_path_raises():
    """K2's group DMA (snp_group >= 8 at biobank L) has no batched path,
    in the reference either (its DMA kernel does not lift under vmap):
    the batched step raises before it draws anything, naming that
    limit."""
    l = 65_536 + 64
    cfg = SVIConfig(n=64, l=l, k=3, batch_size=64, snp_group=8)
    assert engine.uses_group_dma(cfg, l)
    with pytest.raises(NotImplementedError,
                       match=r"K2's group DMA.*does not lift under vmap "
                             r"\(terastructure_tpu/svi/replicates.py:26-30\)"):
        engine.make_replicate_step(cfg, l)


def test_batched_fit_takes_a_resident_packed():
    """packed= (the matrix already on the device) gives the bits of the
    fit that uploads it itself; one on another device is refused."""
    data = _data(64, 256, 2, 31)
    cfg = SVIConfig(n=64, l=256, k=2, batch_size=32, rfreq=20, max_steps=40,
                    conv_tol=-1e9, seed=100)
    packed = engine.resident_packed(data.packed, "cpu")
    a = fit_replicates_batched(cfg, data, [100, 101], device="cpu",
                               packed=packed)
    b = fit_replicates_batched(cfg, data, [100, 101], device="cpu")
    assert torch.equal(a.states.gamma, b.states.gamma)
    meta = engine.resident_packed(data.packed, "meta")
    with pytest.raises(ValueError, match="packed is on"):
        fit_replicates_batched(cfg, data, [100, 101], device="cpu",
                               packed=meta)


def test_batched_fit_needs_a_card_or_the_cpu_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    data = _data(64, 256, 2, 31)
    cfg = SVIConfig(n=64, l=256, k=2, batch_size=32, max_steps=20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fit_replicates_batched(cfg, data, [0, 1])


# --- the batched twins against the reference's vmapped kernels --------------
def _problems(r=R, b=16, n=512, k=3, seed=0):
    """r replicates' (rows, u planes, lambda); numpy, from one seed."""
    rng = np.random.default_rng(seed)
    rows = np.stack([pack2bit(rng.integers(0, 4, size=(b, n)).astype(
        np.int8)) for _ in range(r)])
    gamma = rng.uniform(0.3, 3.0, size=(r, n, k)).astype(np.float32)
    u = np.asarray(ref_ops.exp_elog_theta(jnp.asarray(gamma)))
    up = np.stack([np.array(ref_pk.u_to_planes(jnp.asarray(x))) for x in u])
    lamb = rng.uniform(0.5, 3.0, size=(r, b, k, 2)).astype(np.float32)
    return rows, up, lamb


# the schedules: the main path's (accel, tol 1e-4) cold, as the local mode
# runs it, and warm, as the stored mode does; plain warm. At bf16 a warm
# start far from the fixed point meets the accel tail with rounding flips
# of t that the clamped Aitken step amplifies: the single twin and the
# reference then differ on ~5% of g's entries by up to 0.3% (measured on
# these inputs, the same for the single and the vmapped reference), so
# bf16 holds the plain warm schedule, as tests/test_torch_bf16.py does.
K1_CASES = {
    "cold_accel": dict(local_iters=7, local_tol=1e-4, accel=True),
    "warm_accel": dict(local_iters=7, local_tol=1e-4, accel=True,
                       warm_start=True),
    "warm_plain": dict(local_iters=4, local_tol=-1.0, warm_start=True),
}


@pytest.mark.parametrize("dtype,case", [
    ("float32", "cold_accel"), ("float32", "warm_accel"),
    ("float32", "warm_plain"), ("bfloat16", "cold_accel"),
    ("bfloat16", "warm_plain")])
def test_batched_k1_twin_matches_vmapped_reference(dtype, case):
    rows, up, lamb = _problems(seed=len(case))
    kw = dict(K1_CASES[case], beta_a=1.0, beta_b=1.0)
    got = fused_step.fused_local_solve(
        *(torch.from_numpy(a) for a in (rows, up, lamb)),
        dtype=getattr(torch, dtype), **kw)
    want = jax.vmap(lambda r_, u_, l_: ref_fused.fused_local_solve(
        r_, u_, l_, dtype=getattr(jnp, dtype), interpret=True, **kw))(
        jnp.asarray(rows), jnp.asarray(up), jnp.asarray(lamb))
    assert got[0].shape == (R, 16, 3, 2) and got[1].shape == (R, 4, 128, 3)
    tol = TOL if dtype == "float32" else SOLVE_TOL
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **tol)
    _outliers(got[0].numpy(), np.asarray(want[0]),
              1e-2 if kw.get("accel") else 0.0, tol)


def test_replicate_axis_refuses_k_above_64_where_r_exceeds_1():
    """K1 and K4 with R = 2 at K = 72, which raised before the K-chunked
    bodies took the replicate axis (the name is kept from then): each
    replicate of the batched call is bitwise its single call, one twin
    call for all R; R = 1 is one solve."""
    rows, up, lamb = (torch.from_numpy(a) for a in _problems(r=2, k=72))
    kw = dict(local_iters=2, local_tol=-1.0, beta_a=1.0, beta_b=1.0)
    before = fused_step.fused_local_solve.twin_calls
    got = fused_step.fused_local_solve(rows, up, lamb, **kw)
    assert fused_step.fused_local_solve.twin_calls == before + 1
    for i in range(2):
        one = fused_step.fused_local_solve(rows[i], up[i], lamb[i], **kw)
        assert all(torch.equal(g[i], o) for g, o in zip(got, one))
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    got = stats_packed.lambda_stats_packed(rows[0], up, t1, t0)
    for i in range(2):
        one = stats_packed.lambda_stats_packed(rows[0], up[i], t1[i], t0[i])
        assert all(torch.equal(g[i], o) for g, o in zip(got, one))
    one = fused_step.fused_local_solve(rows[:1], up[:1], lamb[:1], **kw)
    want = fused_step.fused_local_solve(rows[0], up[0], lamb[0], **kw)
    assert all(torch.equal(g[0], w) for g, w in zip(one, want))


def test_batched_k1_is_the_single_twin_per_replicate():
    rows, up, lamb = _problems(seed=4)
    kw = dict(local_iters=7, local_tol=1e-4, accel=True, beta_a=1.0,
              beta_b=1.0)
    t = [torch.from_numpy(a) for a in (rows, up, lamb)]
    before = fused_step.fused_local_solve.twin_calls
    got = fused_step.fused_local_solve(*t, **kw)
    assert fused_step.fused_local_solve.twin_calls == before + 1
    for i in range(R):
        one = fused_step.fused_local_solve(t[0][i], t[1][i], t[2][i], **kw)
        assert all(torch.equal(g[i], o) for g, o in zip(got, one))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batched_k4_twin_matches_vmapped_reference(dtype):
    rows, up, lamb = _problems(b=24, n=1024, k=4, seed=6)
    t1, t0 = (np.array(t) for t in ref_ops.exp_elog_beta(jnp.asarray(lamb)))
    shared = rows[0]                           # every replicate's rows
    got = stats_packed.lambda_stats_packed(
        torch.from_numpy(shared), torch.from_numpy(up), torch.from_numpy(t1),
        torch.from_numpy(t0), dtype=getattr(torch, dtype))
    tb, tw = ref_pk.pick_tiles(*shared.shape)
    want = jax.vmap(lambda u_, a_, b_: ref_pk.lambda_stats_packed(
        jnp.asarray(shared), u_, a_, b_, tb=tb, tw=tw,
        dtype=getattr(jnp, dtype), interpret=True), in_axes=(0, 0, 0))(
        jnp.asarray(up), jnp.asarray(t1), jnp.asarray(t0))
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" else PASS_TOL
    for g, w in zip(got, want):
        assert g.shape == (R, 24, 4)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    # rows of each replicate's own: the single pass on each
    own = stats_packed.lambda_stats_packed(
        *(torch.from_numpy(a) for a in (rows, up, t1, t0)))
    for i in range(R):
        one = stats_packed.lambda_stats_packed(
            *(torch.from_numpy(a[i]) for a in (rows, up, t1, t0)))
        assert all(torch.equal(g[i], o) for g, o in zip(own, one))


@pytest.mark.parametrize("accel", [False, True])
def test_batched_solve_lambda_blocks_matches_vmapped_reference(accel):
    """The batched eval re-solve (K4 with the replicate axis inside the
    per-replicate tol loop, rows shared) against the reference's scorer,
    which vmaps solve_lambda_blocks over the gammas; and each replicate
    bitwise the single re-solve."""
    n, l, k = 96, 1100, 3            # two blocks of 1024, the last padded
    _, _, x = simulate_psd(n, l, k, seed=5)
    packed = engine.pad_width(pack2bit(np.ascontiguousarray(x.T)))
    w = packed.shape[1]
    rng = np.random.default_rng(3)
    gammas = rng.uniform(0.5, 20.0, size=(R, n, k)).astype(np.float32)
    kw = dict(n=n, l=l, k=k, local_accel=accel,
              local_iters=7 if accel else 16)
    cfg, ref_cfg = SVIConfig(**kw), RefConfig(**kw)

    def ref_one(g):
        u = ref_ops.exp_elog_theta(g)
        u = jnp.pad(u, ((0, 4 * w - n), (0, 0)), constant_values=1.0)
        return ref_post.solve_lambda_blocks(ref_cfg, u, jnp.asarray(packed),
                                            block=1024)

    want = np.asarray(jax.vmap(ref_one)(jnp.asarray(gammas)))
    u = stats_packed.pad_individuals(
        engine.ops.exp_elog_theta(torch.from_numpy(gammas)), w)
    got = postprocess.solve_lambda_blocks(cfg, u, torch.from_numpy(packed),
                                          sub_seed=cfg.seed ^ 0xE7A1)
    assert got.shape == (R, l, k, 2)
    if accel:
        # the clamped Aitken step: 99.5% of the entries to TOL, as
        # tests/test_torch_engine.py holds compute_lambda, and every entry
        # to rtol 1e-2 (measured here: 0.11% of the 19,800 entries beyond
        # TOL, the largest 0.52% off)
        _outliers(got.numpy(), want, 5e-3, TOL, cap=1e-2)
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    for i in range(R):
        one = postprocess.solve_lambda_blocks(
            cfg, u[i], torch.from_numpy(packed), sub_seed=cfg.seed ^ 0xE7A1)
        assert torch.equal(got[i], one)
