"""The stored lambda mode against the reference (CPU): the grouped gather
and its scatter, a stored-mode step in each branch with the same
minibatch, the stored-mode scorer, a whole stored-mode fit, and
determinism, duplicate rows included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.data import GenotypeData as RefData
from terastructure_tpu.data import simulate_psd
from terastructure_tpu.data.pack import pack2bit, unpack2bit_jnp
from terastructure_tpu.ops import fused_step as ref_fused
from terastructure_tpu.ops import stats_dense as ref_ops
from terastructure_tpu.ops import stats_pallas as ref_pk
from terastructure_tpu.svi import engine as ref_engine
from terastructure_tpu.svi import fit as ref_fit
from terastructure_tpu_torch.data import GenotypeData
from terastructure_tpu_torch.ops import fused_step, stats_packed
from terastructure_tpu_torch.svi import engine, fit

TOL = dict(rtol=2e-4, atol=2e-4)    # f32, the two packages' sum orders
L_BIG = 65552                       # > 65536, a multiple of 8 and 16


def _packed(l, n, seed):
    rng = np.random.default_rng(seed)
    return pack2bit(rng.integers(0, 4, size=(l, n)).astype(np.int8))


def _lamb(l, k, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 3.0, size=(l, k, 2)).astype(np.float32)


@pytest.mark.parametrize("grouped", [True, False])
def test_gather_batch_matches_reference(grouped):
    """Rows and lambda rows as the reference's _gather_batch gathers them
    from the same draw, and a scatter that writes exactly those rows
    (modelled on tests/test_svi_dense.py)."""
    n, k, b, g = 16, 3, 32, 8
    l = 131072 if grouped else 300
    packed = _packed(l, n, seed=8)
    lamb = _lamb(l, k, seed=9)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=b, snp_group=g, seed=8)
    key = jax.random.PRNGKey(0)
    ridx, rrows, rlamb_b, rscatter = ref_engine._gather_batch(
        cfg, jnp.asarray(packed), jnp.asarray(lamb), key, l)
    # the draw the reference made, injected into the port
    draw = (jax.random.randint(key, (b // g,), 0, l // g, dtype=jnp.int32)
            if grouped else ref_engine._sample_batch(key, l, b))
    lamb_t = torch.from_numpy(lamb.copy())
    idx, rows, lamb_b, scatter = engine._gather_batch(
        cfg, torch.from_numpy(packed), lamb_t, None, l,
        draw=torch.from_numpy(np.array(draw)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(rrows))
    np.testing.assert_array_equal(lamb_b.numpy(), np.asarray(rlamb_b))
    if grouped:
        assert (np.diff(idx.numpy().reshape(-1, g), axis=1) == 1).all()
    new = lamb_b + 1.0
    scatter(new)
    want = np.asarray(rscatter(jnp.asarray(lamb), jnp.asarray(new.numpy())))
    np.testing.assert_array_equal(lamb_t.numpy(), want)
    mask = np.ones(l, bool)
    mask[idx.numpy()] = False
    np.testing.assert_array_equal(lamb_t.numpy()[mask], lamb[mask])
    np.testing.assert_array_equal(lamb_t.numpy()[idx.numpy()], new.numpy())


# Each branch of make_step in the stored mode: (config change, L, N).
BRANCHES = {
    "k2": (dict(snp_group=8), L_BIG, 512),
    "k2_accel": (dict(snp_group=8, local_accel=True, local_iters=7),
                 L_BIG, 512),
    "fused_k1": (dict(), 300, 512),
    "pallas_grouped": (dict(kernel="pallas", snp_group=8), L_BIG, 512),
    "dense": (dict(kernel="dense"), 300, 64),
    "dense_grouped": (dict(kernel="dense", snp_group=8), L_BIG, 64),
    # compute_dtype bf16: K2's, K1's and the dense bf16 bodies
    "k2_bf16": (dict(snp_group=8, compute_dtype="bfloat16"), L_BIG, 512),
    "fused_k1_bf16": (dict(compute_dtype="bfloat16"), 300, 512),
    "dense_bf16": (dict(kernel="dense", compute_dtype="bfloat16"), 300, 64),
}
BF16_TOL = dict(rtol=2e-3, atol=1e-5)    # tests/test_torch_bf16.py


def _reference_step(cfg, branch, gamma, lamb, packed, idx, idx0, t):
    """The reference's stored-mode step (svi/engine.py:340-410) on the
    port's minibatch: (gamma, lamb) after it."""
    b, k = cfg.batch_size, cfg.k
    w = packed.shape[1]
    g_ = jnp.asarray(gamma)
    lamb_b = jnp.asarray(lamb[idx])
    kw = dict(local_iters=cfg.local_iters, local_tol=cfg.local_tol,
              beta_a=1.0, beta_b=1.0, dtype=jnp.dtype(cfg.compute_dtype),
              warm_start=True, interpret=True, accel=cfg.local_accel)
    if branch.startswith(("k2", "fused")):
        u = ref_ops.exp_elog_theta(g_)
        u = jnp.pad(u, ((0, 4 * w - u.shape[0]), (0, 0)), constant_values=1.0)
        if branch.startswith("k2"):
            new, gp = ref_fused.fused_local_solve_dma(
                jnp.asarray(idx0), jnp.asarray(packed), ref_pk.u_to_planes(u),
                lamb_b, group=cfg.snp_group, **kw)
        else:
            new, gp = ref_fused.fused_local_solve(
                jnp.asarray(packed[idx]), ref_pk.u_to_planes(u), lamb_b, **kw)
        stat = (u * ref_pk.planes_to_flat(gp))[: cfg.n]
    elif branch.startswith("pallas"):
        new, stat = ref_engine.step_core_packed(
            cfg, g_, jnp.asarray(packed[idx]), lamb_b, interpret=True)
    else:
        xb = unpack2bit_jnp(jnp.asarray(packed[idx]), cfg.n)
        new, stat = ref_engine.step_core_dense(cfg, g_, xb, lamb_b)
    lamb_out = jnp.asarray(lamb).at[jnp.asarray(idx)].set(new)
    gamma_out = ref_engine._global_update(cfg, g_, stat, jnp.int32(t),
                                          packed.shape[0])
    assert new.shape == (b, k, 2)
    return np.asarray(gamma_out), np.asarray(lamb_out)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_stored_step_matches_reference(branch):
    change, l, n = BRANCHES[branch]
    k, b, t = 3, 16, 5
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=b, seed=7, local_accel=False,
                    local_iters=6, lambda_mode="stored").replace(**change)
    packed = _packed(l, n, seed=len(branch))
    if packed.shape[1] % 128 and not branch.startswith("dense"):
        packed = engine.pad_width(packed)
    lamb = _lamb(l, k, seed=3)
    state = engine.init_state(cfg)._replace(lamb=torch.from_numpy(lamb.copy()),
                                            t=t)
    gamma = state.gamma.numpy().copy()
    packed_t = torch.from_numpy(packed)
    new = engine.make_step(cfg)(state, packed_t)
    assert new.lamb is state.lamb            # the scatter is in place

    # replay the port's draw of step t
    gen = engine.step_generator(cfg.seed, t, "cpu")
    idx0 = None
    if engine.uses_group_dma(cfg, l) and branch.startswith("k2"):
        idx0, idx = engine._draw_groups(cfg, gen, l, "cpu")
        idx0 = idx0.numpy()
    elif branch.startswith("fused"):
        idx, _ = engine._sample_rows(cfg, packed_t, gen, l)
    else:
        idx, *_ = engine._gather_batch(cfg, packed_t, torch.from_numpy(lamb),
                                       gen, l)
    idx = idx.long().numpy()
    assert len(np.unique(idx)) == b
    want_gamma, want_lamb = _reference_step(cfg, branch, gamma, lamb, packed,
                                            idx, idx0, t)
    tol = BF16_TOL if cfg.compute_dtype == "bfloat16" else TOL
    np.testing.assert_allclose(new.gamma.numpy(), want_gamma, **tol)
    got_lamb = new.lamb.numpy()
    mask = np.ones(l, bool)
    mask[idx] = False
    np.testing.assert_array_equal(got_lamb[mask], lamb[mask])
    if cfg.local_accel:      # the clamped Aitken tail: 1% of lambda_B
        bad = (np.abs(got_lamb[idx] - want_lamb[idx])
               > tol["atol"] + tol["rtol"] * np.abs(want_lamb[idx]))
        assert bad.mean() <= 1e-2, bad.mean()
    else:
        np.testing.assert_allclose(got_lamb[idx], want_lamb[idx], **tol)
    assert np.abs(got_lamb[idx] - lamb[idx]).max() > 1e-2


def test_step_core_packed_warm_start_matches_reference():
    """The big-N step warm-started from stored lambda rows, with the
    reference's column subsample injected into the port."""
    n, k, b = 4096, 3, 16
    cfg = SVIConfig(n=n, l=100, k=k, batch_size=b, local_sub_n=512,
                    local_accel=False, local_sub_approx_div=False,
                    lambda_mode="stored")
    rows = _packed(b, n, seed=11)
    gamma = np.random.default_rng(12).uniform(
        0.05, 30.0, size=(n, k)).astype(np.float32)
    lamb_b = _lamb(b, k, seed=13)
    key = jax.random.PRNGKey(5)
    idx_w = np.asarray(jax.random.choice(key, rows.shape[1], (128,),
                                         replace=False))
    want = ref_engine.step_core_packed(cfg, jnp.asarray(gamma),
                                       jnp.asarray(rows), jnp.asarray(lamb_b),
                                       interpret=True, key=key)
    got = engine.step_core_packed(cfg, torch.from_numpy(gamma),
                                  torch.from_numpy(rows),
                                  idx_w=torch.from_numpy(idx_w.copy()),
                                  lamb_b=torch.from_numpy(lamb_b))
    cold = engine.step_core_packed(cfg, torch.from_numpy(gamma),
                                   torch.from_numpy(rows),
                                   idx_w=torch.from_numpy(idx_w.copy()))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-5,
                                   atol=3e-5)
    assert not torch.equal(got[0], cold[0])      # the warm start is read


@pytest.mark.parametrize("form", ["plugin", "variational"])
def test_entry_loglik_matches_reference(form):
    rng = np.random.default_rng(1)
    n, l, k, m = 50, 80, 3, 400
    gamma = rng.uniform(0.05, 30.0, size=(n, k)).astype(np.float32)
    lamb = _lamb(l, k, seed=2)
    i = rng.integers(0, n, m).astype(np.int32)
    j = rng.integers(0, l, m).astype(np.int32)
    x = rng.integers(0, 3, m).astype(np.int8)
    want = float(ref_engine.entry_loglik(
        jnp.asarray(gamma), jnp.asarray(lamb), jnp.asarray(i), jnp.asarray(j),
        jnp.asarray(x), form=form))
    got = engine.entry_loglik(torch.from_numpy(gamma), torch.from_numpy(lamb),
                              torch.from_numpy(i).long(),
                              torch.from_numpy(j).long(), torch.from_numpy(x),
                              form=form)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_stored_fit_matches_reference_stored_fit():
    """Whole stored-mode fits on one data split (tests/test_fused.py holds
    the reference's two modes to 0.05 nats the same way). The stored
    lambda is the result: no lambda re-solve (K4) runs, in the scorer or
    at the end."""
    n, l, k = 64, 256, 2
    _, _, x = simulate_psd(n, l, k, seed=33)
    split = dict(validation_frac=0.02, heldout_frac=0.02, seed=33)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=32, rfreq=100, max_steps=800,
                    seed=33, lambda_mode="stored")
    ref = ref_fit(cfg.replace(kernel="dense"), RefData.from_dense(x, **split))
    k4 = stats_packed.lambda_stats_packed.twin_calls
    k1 = fused_step.fused_local_solve.twin_calls
    res = fit(cfg, GenotypeData.from_dense(x, **split), device="cpu")
    assert stats_packed.lambda_stats_packed.twin_calls == k4
    assert fused_step.fused_local_solve.twin_calls - k1 == res.steps
    assert np.isfinite(res.validation_ll) and np.isfinite(res.heldout_ll)
    assert abs(res.heldout_ll - ref.heldout_ll) < 0.05, (res.heldout_ll,
                                                         ref.heldout_ll)
    assert res.state.lamb.shape == (l, k, 2)
    assert float((res.state.lamb - 1.0).abs().max()) > 1.0


def _chunks(cfg, packed, nsteps, chunks):
    state = engine.init_state(cfg)
    run = engine.make_run_chunk(cfg, nsteps, packed.shape[0])
    for _ in range(chunks):
        state = run(state, packed)
    return state


@pytest.mark.parametrize("path", ["k3_duplicate_blocks", "k2"])
def test_stored_same_seed_bitwise_and_chunking_invariant(path):
    """k3_duplicate_blocks: 16 blocks of 8 rows drawn from 8 every step
    (the block gather lowered to L=64), so every batch holds duplicate
    groups; k2: the group-DMA branch at biobank L."""
    if path == "k2":
        cfg = SVIConfig(n=512, l=L_BIG, k=3, batch_size=16, snp_group=8,
                        seed=4, lambda_mode="stored")
    else:
        cfg = SVIConfig(n=512, l=64, k=3, batch_size=128, seed=4,
                        dma_gather_min_l=8, lambda_mode="stored")
    packed = torch.from_numpy(_packed(cfg.l, cfg.n, seed=6))
    a = _chunks(cfg, packed, 6, 2)
    b = _chunks(cfg, packed, 6, 2)
    c = _chunks(cfg, packed, 4, 3)
    assert a.t == b.t == c.t == 12
    for x, y in ((a, b), (a, c)):
        assert torch.equal(x.gamma, y.gamma) and torch.equal(x.lamb, y.lamb)
    moved = (a.lamb != engine.init_state(cfg).lamb).any(-1).any(-1)
    assert 0 < int(moved.sum()) <= 12 * cfg.batch_size
    d = _chunks(cfg.replace(seed=5), packed, 6, 2)
    assert not torch.equal(a.lamb, d.lamb)


@pytest.mark.parametrize("core", ["k2", "k1", "pallas", "dense"])
def test_duplicate_rows_carry_bitwise_equal_lambda(core):
    """A row's new lambda depends only on the row and the batch-wide tol
    flag, so duplicates in a batch (a group drawn twice, a draw with
    replacement) scatter the same bits whichever write lands last."""
    n, k, g = 512, 3, 8
    cfg = SVIConfig(n=n, l=64, k=k, batch_size=32, snp_group=g,
                    kernel={"k2": "fused", "k1": "fused"}.get(core, core),
                    lambda_mode="stored")
    packed = torch.from_numpy(_packed(64, n, seed=1))
    gamma = torch.from_numpy(np.random.default_rng(2).uniform(
        0.3, 3.0, size=(n, k)).astype(np.float32))
    idx0 = torch.tensor([16, 0, 16, 40], dtype=torch.int32)   # group 16 twice
    idx = (idx0.long()[:, None] + torch.arange(g)).reshape(-1)
    lamb_b = torch.from_numpy(_lamb(64, k, seed=3))[idx]
    if core == "k2":
        new, _ = engine.step_core_fused_dma(cfg, gamma, packed, idx0, lamb_b)
    elif core == "k1":
        new, _ = engine.step_core_fused(cfg, gamma, packed[idx], lamb_b)
    elif core == "pallas":
        new, _ = engine.step_core_packed(cfg, gamma, packed[idx],
                                         lamb_b=lamb_b)
    else:
        from terastructure_tpu_torch.data.pack import unpack2bit_torch
        new, _ = engine.step_core_dense(cfg, gamma,
                                        unpack2bit_torch(packed[idx], n),
                                        lamb_b)
    assert torch.equal(new[:g], new[2 * g:3 * g])
    assert not torch.equal(new[:g], new[g:2 * g])
