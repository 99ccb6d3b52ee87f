"""The port's engine against the reference's on one state: a step with
injected minibatch indices, the eval scorer and compute_lambda, the bf16
statistic rounding, determinism, block sampling, the option that is not
ported yet and those that now take the big-N step (CPU). The group-DMA
step (K2) and the stored lambda mode have their own files,
test_torch_group_dma.py and test_torch_stored.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.data import GenotypeData as RefData
from terastructure_tpu.data import simulate_psd
from terastructure_tpu.ops import fused_step as ref_fused
from terastructure_tpu.ops import stats_dense as ref_ops
from terastructure_tpu.ops import stats_pallas as ref_pk
from terastructure_tpu.svi import engine as ref_engine
from terastructure_tpu.svi import postprocess as ref_post
from terastructure_tpu_torch.ops import fused_step, gather, stats_packed
from terastructure_tpu_torch.svi import engine, postprocess

TOL = dict(rtol=2e-4, atol=2e-4)


def _data(n=96, l=300, k=3, seed=5):
    _, _, x = simulate_psd(n, l, k, seed=seed)
    data = RefData.from_dense(x, validation_frac=0.02, heldout_frac=0.02,
                              seed=seed)
    return data, engine.pad_width(data.packed)


@pytest.mark.parametrize("accel,t", [(True, 0), (True, 37), (False, 5)])
def test_step_matches_reference_with_injected_indices(accel, t):
    n, l, k, b = 96, 300, 3, 32
    data, packed = _data(n, l, k)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=b, seed=5, local_accel=accel,
                    local_iters=7 if accel else 6)
    s0 = ref_engine.init_state(cfg)._replace(t=jnp.int32(t))
    idx = np.random.default_rng(t).choice(l, b, replace=False)
    rows = packed[idx]

    # reference: the fused branch of make_step (engine.py:347-380, 409)
    u = ref_ops.exp_elog_theta(s0.gamma)
    u = jnp.pad(u, ((0, 4 * packed.shape[1] - n), (0, 0)),
                constant_values=1.0)
    _, g = ref_fused.fused_local_solve(
        jnp.asarray(rows), ref_pk.u_to_planes(u),
        jnp.zeros((b, k, 2), jnp.float32), local_iters=cfg.local_iters,
        local_tol=cfg.local_tol, beta_a=1.0, beta_b=1.0, dtype=jnp.float32,
        interpret=True, accel=accel)
    stat = (u * ref_pk.planes_to_flat(g))[:n]
    want = ref_engine._global_update(cfg, s0.gamma, stat, s0.t, l)

    st = engine.state_from_reference(s0.gamma, s0.lamb, s0.t, cfg.seed)
    _, got_stat = engine.step_core_fused(cfg, st.gamma, torch.from_numpy(rows))
    got = engine._global_update(cfg, st.gamma, got_stat, st.t, l)
    np.testing.assert_allclose(got_stat.numpy(), np.asarray(stat), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dense_step_core_matches_reference():
    n, l, k, b = 64, 100, 2, 16
    rng = np.random.default_rng(2)
    xb = rng.integers(0, 4, (b, n)).astype(np.int8)
    gamma = rng.uniform(0.3, 3.0, (n, k)).astype(np.float32)
    lamb = np.ones((b, k, 2), np.float32)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=b, kernel="dense")
    got = engine.step_core_dense(cfg, torch.from_numpy(gamma),
                                 torch.from_numpy(xb), torch.from_numpy(lamb))
    want = ref_engine.step_core_dense(cfg, jnp.asarray(gamma),
                                      jnp.asarray(xb), jnp.asarray(lamb))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **TOL)


def _trained_gamma(n, k, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.05, 30.0, (n, k)).astype(np.float32)


@pytest.mark.parametrize("predictive", ["plugin", "variational"])
def test_eval_scorer_matches_reference(predictive):
    n, l, k = 96, 300, 3
    data, packed = _data(n, l, k)
    cfg = SVIConfig(n=n, l=l, k=k, seed=5, predictive=predictive)
    es = data.validation
    uniq, inv = np.unique(es.snp_idx, return_inverse=True)
    gamma = _trained_gamma(n, k)
    want = ref_engine.make_entry_loglik_recompute(
        cfg, packed[uniq], inv.astype(np.int32), es.ind_idx, es.x)(
            jnp.asarray(gamma))
    got = engine.make_entry_loglik_recompute(
        cfg, packed[uniq], inv, es.ind_idx, es.x, device="cpu")(
            torch.from_numpy(gamma))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("accel", [False, True])
def test_compute_lambda_matches_reference(accel):
    n, l, k = 96, 1500, 3           # two blocks of 1024, the last padded
    data, packed = _data(n, l, k)
    cfg = SVIConfig(n=n, l=l, k=k, seed=5, local_accel=accel,
                    local_iters=7 if accel else 16)
    gamma = _trained_gamma(n, k, seed=2)
    got = postprocess.compute_lambda(cfg, torch.from_numpy(gamma),
                                     torch.from_numpy(packed)).numpy()
    want = np.asarray(ref_post.compute_lambda(cfg, jnp.asarray(gamma),
                                              jnp.asarray(packed)))
    assert got.shape == (l, k, 2)
    beta = postprocess.compute_beta(cfg, torch.from_numpy(gamma), packed)
    want_beta = np.asarray(ref_post.compute_beta(
        cfg, jnp.asarray(gamma), jnp.asarray(packed)))
    if not accel:
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(beta, want_beta, **TOL)
        return
    # The clamped Aitken step is discontinuous where d0 - d1 changes sign,
    # so f32 sum-order differences (matmul in planar vs flat order) move a
    # few coordinates by up to 18|d1|: hold 99.5% of entries to TOL.
    for g_, w_ in ((got, want), (beta, want_beta)):
        bad = np.abs(g_ - w_) > TOL["atol"] + TOL["rtol"] * np.abs(w_)
        assert bad.mean() <= 5e-3, bad.mean()
        np.testing.assert_allclose(g_, w_, rtol=5e-3)


def test_eval_column_subsample_matches_reference_math():
    """At big N the eval re-solve iterates on a fixed byte-aligned column
    subsample (the reference's TPU branch, postprocess.py:75-93): the
    port equals that math run through the reference kernels on the same
    subsample."""
    n, k, s = 2048, 3, 40
    cfg = SVIConfig(n=n, l=s, k=k, local_sub_n=512, seed=3)   # sub_w = 128
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 256, (s, n // 4), dtype=np.uint8)
    u = np.array(ref_ops.exp_elog_theta(jnp.asarray(_trained_gamma(n, k))))
    got = postprocess.solve_lambda_blocks(
        cfg, torch.from_numpy(u), torch.from_numpy(rows), block=64,
        sub_seed=7)

    idx_w = torch.randperm(n // 4, generator=torch.Generator().manual_seed(
        7))[:128].numpy()
    rows_p = np.concatenate([rows, np.full((24, n // 4), 0xFF, np.uint8)])
    u_sub = u.reshape(n // 4, 4, k)[idx_w].reshape(-1, k)
    kw = dict(dtype=jnp.float32, interpret=True)
    lam = ref_pk.local_solve_packed(
        jnp.asarray(rows_p[:, idx_w]), jnp.asarray(u_sub),
        jnp.ones((64, k, 2), jnp.float32), beta_a=1.0, beta_b=1.0,
        local_iters=cfg.local_iters, local_tol=cfg.local_tol, tb=64, tw=128,
        stat_scale=4.0, accel=True, **kw)
    e1, e0 = ref_ops.exp_elog_beta(lam)
    l0, l1 = ref_pk.lambda_stats_packed(
        jnp.asarray(rows_p), ref_pk.u_to_planes(jnp.asarray(u)), e1, e0,
        tb=64, tw=512, **kw)
    want = jnp.stack([1.0 + e1 * l0, 1.0 + e0 * l1], -1)[:s]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bf16_statistic_rounding_matches_reduce_precision():
    cfg = SVIConfig(n=64, l=32, k=3, batch_size=32, gamma_psum_dtype="bf16")
    rng = np.random.default_rng(0)
    stat = rng.uniform(0.0, 500.0, (64, 3)).astype(np.float32)
    gamma = np.zeros((64, 3), np.float32)
    # t=0: rho = 1 and l_sample = B: the update is alpha + round(stat)
    got = engine._global_update(cfg, torch.from_numpy(gamma),
                                torch.from_numpy(stat), 0, 32).numpy()
    want = np.asarray(ref_engine._global_update(
        cfg, jnp.asarray(gamma), jnp.asarray(stat), jnp.int32(0), 32))
    np.testing.assert_array_equal(got, want)
    rounded = np.asarray(jax.lax.reduce_precision(
        jnp.asarray(stat), exponent_bits=8, mantissa_bits=7))
    np.testing.assert_array_equal(got, np.float32(1 / 3) + rounded)
    exact = engine._global_update(cfg.replace(gamma_psum_dtype="f32"),
                                  torch.from_numpy(gamma),
                                  torch.from_numpy(stat), 0, 32).numpy()
    assert np.abs(exact - got).max() > 0


def _chunk_run(cfg, packed, nsteps, chunks):
    state = engine.init_state(cfg)
    run = engine.make_run_chunk(cfg, nsteps)
    for _ in range(chunks):
        state = run(state, packed)
    return state


def test_same_seed_bitwise_and_chunking_invariant():
    n, l, k = 64, 256, 2
    data, packed = _data(n, l, k, seed=3)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=16, seed=3)
    packed = torch.from_numpy(packed)
    a = _chunk_run(cfg, packed, 30, 2)
    b = _chunk_run(cfg, packed, 30, 2)
    c = _chunk_run(cfg, packed, 20, 3)
    assert a.t == b.t == c.t == 60
    assert torch.equal(a.gamma, b.gamma)
    assert torch.equal(a.gamma, c.gamma)     # draws depend on (seed, t) only
    d = _chunk_run(cfg.replace(seed=4), packed, 30, 2)
    assert not torch.equal(a.gamma, d.gamma)


@pytest.mark.parametrize("l,blocks", [(65544, True), (65536, False)])
def test_block_sampling_engages_at_biobank_l(l, blocks):
    cfg = SVIConfig(n=16, l=l, k=2, batch_size=128, seed=1)
    packed = torch.randint(0, 256, (l, 4), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    before = gather.gather_row_blocks.twin_calls
    idx, rows = engine._sample_rows(cfg, packed, engine.step_generator(1, 0,
                                                                       "cpu"),
                                    l)
    idx = idx.long()
    assert torch.equal(rows, packed[idx])
    starts = idx.reshape(-1, 8)
    consecutive = bool((starts - starts[:, :1] ==
                        torch.arange(8)).all() and (starts[:, 0] % 8 == 0).all())
    assert consecutive == blocks
    assert (gather.gather_row_blocks.twin_calls - before) == int(blocks)
    if not blocks:
        assert len(torch.unique(idx)) == 128     # without replacement


@pytest.mark.parametrize("change", [
    dict(kernel="pallas"),
    dict(batch_size=12),                    # outside the fused gate
])
def test_big_n_options_run_the_per_iteration_step(change):
    """kernel="pallas", and a shape the fused gate refuses, run one step
    through the big-N path: the subsampled K8 solve and the K7 statistics
    pass, never K1."""
    cfg = SVIConfig(n=2048, l=256, k=2, batch_size=16,
                    local_sub_n=512).replace(**change)
    packed = torch.randint(0, 256, (cfg.l, 512), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    fns = (fused_step.fused_local_solve, stats_packed.lambda_stats_acat,
           stats_packed.batch_stats_fused_v2_packed)
    before = [f.twin_calls for f in fns]
    state = engine.make_step(cfg)(engine.init_state(cfg), packed)
    after = [f.twin_calls for f in fns]
    assert after[0] == before[0]
    assert after[1] - before[1] == cfg.local_iters
    assert after[2] == before[2] + 1
    assert state.t == 1 and bool(torch.isfinite(state.gamma).all())
