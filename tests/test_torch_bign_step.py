"""The port's big-N step (engine.step_core_packed) against the
reference's, with the same column subsample injected into both (the
reference's Pallas kernels in interpret mode), and a small whole fit
through the big-N path against a reference fit on the same data (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.data import GenotypeData as RefData
from terastructure_tpu.data import simulate_psd
from terastructure_tpu.data.pack import pack2bit
from terastructure_tpu.models import psd as ref_psd
from terastructure_tpu.svi import engine as ref_engine
from terastructure_tpu.svi import fit as ref_fit
from terastructure_tpu.utils.labels import mean_abs_theta_error
from terastructure_tpu_torch.data import GenotypeData
from terastructure_tpu_torch.models import psd
from terastructure_tpu_torch.ops import fused_step
from terastructure_tpu_torch.ops import stats_packed as pk
from terastructure_tpu_torch.ops.stats_dense import pad_share
from terastructure_tpu_torch.svi import engine, fit

N, K = 4096, 3          # W = 1024 byte columns; local_sub_n=512 -> 128


def _inputs(b, seed):
    rng = np.random.default_rng(seed)
    rows = pack2bit(rng.integers(0, 4, size=(b, N)).astype(np.int8))
    gamma = rng.uniform(0.05, 30.0, size=(N, K)).astype(np.float32)
    return rows, gamma


def _both(cfg, rows, gamma, seed, which="both"):
    """(port, reference) step_core_packed results from one subsample;
    which="port" or "ref" runs only that side (the other is None)."""
    key = jax.random.PRNGKey(seed)
    wp = rows.shape[1]
    sub_w = (cfg.local_sub_n // 4 // 128) * 128
    idx_w = np.asarray(jax.random.choice(key, wp, (sub_w,), replace=False))
    b = rows.shape[0]
    lamb_b = jnp.stack([jnp.full((b, K), cfg.beta_a, jnp.float32),
                        jnp.full((b, K), cfg.beta_b, jnp.float32)], -1)
    got = want = None
    if which != "port":
        want = [np.asarray(w) for w in ref_engine.step_core_packed(
            cfg, jnp.asarray(gamma), jnp.asarray(rows), lamb_b,
            interpret=True, key=key)]
    if which != "ref":
        got = [g.numpy() for g in engine.step_core_packed(
            cfg, torch.from_numpy(gamma), torch.from_numpy(rows),
            idx_w=torch.from_numpy(idx_w.copy()))]
    return got, want


@pytest.mark.parametrize("b", [16, 12])
@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("decode_once", [True, False])
@pytest.mark.parametrize("stats_kernel", ["fused_v2", "pair", "fused"])
def test_step_core_packed_matches_reference(stats_kernel, decode_once,
                                            refine, b):
    cfg = SVIConfig(n=N, l=100, k=K, batch_size=b, local_sub_n=512,
                    local_accel=False, local_sub_approx_div=False,
                    stats_kernel=stats_kernel, sub_decode_once=decode_once,
                    local_refine_full=refine)
    rows, gamma = _inputs(b, seed=b + 2 * refine)
    calls = {f: f.twin_calls for f in (pk.lambda_stats_acat,
                                       pk.lambda_stats_packed)}
    got, want = _both(cfg, rows, gamma, seed=b)
    assert got[0].shape == (b, K, 2) and got[1].shape == (N, K)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=3e-5, atol=3e-5)
    solve = pk.lambda_stats_acat if decode_once else pk.lambda_stats_packed
    assert solve.twin_calls - calls[solve] >= cfg.local_iters


def test_step_core_packed_accel_gamma_matches_reference():
    """The default accel tail: the clamped Aitken step amplifies sum order
    in a few lambda coordinates, so only the gamma statistic, all the
    step uses, is held (to K1's 2e-4). With the fast divide of the
    subsampled passes on as well, the two packages' reciprocals differ
    by ~1e-4 relative and the Aitken step carries that to ~2e-3 in gamma:
    that case is held to its twin on the card instead."""
    cfg = SVIConfig(n=N, l=100, k=K, batch_size=16, local_sub_n=512,
                    local_sub_approx_div=False)
    assert cfg.local_accel
    rows, gamma = _inputs(16, seed=9)
    got, want = _both(cfg, rows, gamma, seed=9)
    np.testing.assert_allclose(got[1], want[1], rtol=2e-4, atol=2e-4)
    assert np.isfinite(got[0]).all()


def test_step_core_packed_full_n_without_subsample():
    """N below 4 local_sub_n: every pass is a full-N K4 pass, as in the
    reference's branch without a key."""
    cfg = SVIConfig(n=N, l=100, k=K, batch_size=16, local_sub_n=8192,
                    local_accel=False)
    rows, gamma = _inputs(16, seed=4)
    gen = engine.step_generator(0, 0, "cpu", engine.SUB_TAG)
    got = engine.step_core_packed(cfg, torch.from_numpy(gamma),
                                  torch.from_numpy(rows), gen=gen)
    lamb_b = jnp.stack([jnp.ones((16, K)), jnp.ones((16, K))], -1)
    want = ref_engine.step_core_packed(cfg, jnp.asarray(gamma),
                                       jnp.asarray(rows), lamb_b,
                                       interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-5,
                                   atol=3e-5)


def test_step_draws_keep_the_block_draw_and_differ_by_step():
    """The subsample has its own stream per step: the minibatch draw of
    step t does not move when the subsample engages, and two steps draw
    different columns."""
    cfg = SVIConfig(n=N, l=100, k=K, batch_size=16, local_sub_n=512)
    a = engine.subsample_columns(cfg, 1024, engine.step_generator(
        3, 5, "cpu", engine.SUB_TAG))
    b = engine.subsample_columns(cfg, 1024, engine.step_generator(
        3, 6, "cpu", engine.SUB_TAG))
    assert a.shape == (128,) and len(torch.unique(a)) == 128
    assert not torch.equal(a, b)
    assert engine.subsample_columns(cfg, 511, None) is None
    g1 = engine.step_generator(3, 5, "cpu")
    g2 = engine.step_generator(3, 5, "cpu")
    engine.subsample_columns(cfg, 1024, engine.step_generator(
        3, 5, "cpu", engine.SUB_TAG))
    assert torch.equal(torch.randperm(100, generator=g1),
                       torch.randperm(100, generator=g2))


def test_big_n_fit_matches_reference_fit():
    """A whole fit through the big-N path (kernel="pallas", subsample on)
    against the reference's fit on the same data split. The reference's
    interpret-mode Pallas fit is too slow on the CPU, so it runs its dense
    kernel, the same model and schedule without the subsample. Compared
    statistically: heldout within 0.05 nats, theta MAE within 0.03."""
    n, l, k = 2048, 1024, 3
    theta_true, _, x = simulate_psd(n, l, k, seed=21)
    split = dict(validation_frac=0.01, heldout_frac=0.01, seed=21)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=64, rfreq=100, max_steps=300,
                    local_sub_n=512, seed=21)
    ref = ref_fit(cfg.replace(kernel="dense"), RefData.from_dense(x, **split))
    before = fused_step.fused_local_solve.twin_calls
    res = fit(cfg.replace(kernel="pallas"), GenotypeData.from_dense(x, **split),
              device="cpu")
    assert fused_step.fused_local_solve.twin_calls == before
    assert res.steps == ref.steps == 300
    assert np.isfinite(res.heldout_ll) and np.isfinite(ref.heldout_ll)
    assert abs(res.heldout_ll - ref.heldout_ll) < 0.05, (res.heldout_ll,
                                                         ref.heldout_ll)
    mae = mean_abs_theta_error(psd.theta_mean(res.state.gamma).numpy(),
                               theta_true)
    ref_mae = mean_abs_theta_error(
        np.asarray(ref_psd.theta_mean(ref.state.gamma)), theta_true)
    assert mae < 0.1 and abs(mae - ref_mae) < 0.03, (mae, ref_mae)


# --- the tol test at B % 8 != 0 ----------------------------------------------
def _exit_pass(run, m_max):
    """The pass at which a solve's tol loop exits: the fewest local_iters
    whose result is bitwise the result at m_max (the loop keeps the exit
    pass's lambda however many passes local_iters allows beyond it)."""
    final = run(m_max)
    for m in range(1, m_max + 1):
        if all(np.array_equal(a, c) for a, c in zip(run(m), final)):
            return m, final
    raise AssertionError("unreachable")


def test_step_core_packed_tol_exit_at_b12_matches_reference(monkeypatch):
    """B = 12: the reference pads the batch with 4 all-MISSING rows, and
    its tol test averages over them. local_tol = 400 lies between the
    first pass's relative change with those rows (~351) and without them
    (~455), so the pass at which the loop exits hangs on them. The port
    exits where the reference does, and its lambda and gamma statistic
    match the reference's to 3e-5 (f32 sum order, as the cases above)."""
    b, seed = 12, 12
    cfg = SVIConfig(n=N, l=100, k=K, batch_size=b, local_sub_n=512,
                    local_accel=False, local_sub_approx_div=False,
                    beta_a=2.0, beta_b=0.5, local_tol=400.0)
    assert engine.batch_pad_rows(b) == 4
    rows, gamma = _inputs(b, seed=seed)

    def run(which, m):
        got, want = _both(cfg.replace(local_iters=m), rows, gamma, seed,
                          which=which)
        return got if which == "port" else want

    port_pass, got = _exit_pass(lambda m: run("port", m), 3)
    ref_pass, want = _exit_pass(lambda m: run("ref", m), 3)
    with monkeypatch.context() as mp:            # the pad share left out
        mp.setattr(engine, "batch_pad_rows", lambda b: 0)
        unpadded_pass, _ = _exit_pass(lambda m: run("port", m), 3)
    assert unpadded_pass != ref_pass
    assert port_pass == ref_pass == 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=3e-5, atol=3e-5)


def test_loop_pass_count_is_the_reference_exit_pass_at_b12(monkeypatch):
    """The count of loop passes that `local_solve_acat` records (the
    histogram chip_smoke.py prints for the big-N fits) on the B = 12 case
    above is the pass at which the reference's while_loop exits, below
    local_iters; without the pad rows' share it would be another."""
    b, seed, m = 12, 12, 3
    cfg = SVIConfig(n=N, l=100, k=K, batch_size=b, local_sub_n=512,
                    local_accel=False, local_sub_approx_div=False,
                    beta_a=2.0, beta_b=0.5, local_tol=400.0, local_iters=m)
    rows, gamma = _inputs(b, seed=seed)
    ref_pass, _ = _exit_pass(
        lambda i: _both(cfg.replace(local_iters=i), rows, gamma, seed,
                        which="ref")[1], m)
    counts = []
    monkeypatch.setattr(pk.local_solve_acat, "loop_passes", counts)
    _both(cfg, rows, gamma, seed, which="port")
    monkeypatch.setattr(engine, "batch_pad_rows", lambda b: 0)
    _both(cfg, rows, gamma, seed, which="port")
    assert [int(c) for c in counts][0] == ref_pass < m
    assert int(counts[1]) != ref_pass


@pytest.mark.parametrize("prior", [(1.0, 1.0), (2.0, 0.5)])
def test_pad_share_equals_a_solve_over_padded_rows(prior):
    """The closed-form share of the pad rows (stats_dense.pad_share)
    against rows really padded: all-MISSING rows with lambda 1.0 give
    those sums on the first pass and on every later one, and a solve over
    B rows with pad_rows = 4 gives the padded solve's lambda at a tol that
    the pad rows decide."""
    b, pad, n, k = 12, 4, 512, 3
    rng = np.random.default_rng(7)
    rows = torch.from_numpy(pack2bit(rng.integers(0, 4, (b, n)).astype(
        np.int8)))
    u = torch.from_numpy(rng.uniform(0.2, 1.0, (n, k)).astype(np.float32))
    lamb = torch.empty((b, k, 2))
    lamb[..., 0], lamb[..., 1] = prior
    padded = torch.cat([rows, rows.new_full((pad, rows.shape[1]), 0xFF)])
    lamb_p = torch.cat([lamb, torch.ones((pad, k, 2))])
    kw = dict(beta_a=prior[0], beta_b=prior[1], stat_scale=8.0)

    lam = lamb_p
    for first in (True, False, False):
        new = pk.local_solve_packed(padded, u, lam, local_iters=1,
                                    local_tol=0.0, **kw)
        got = (float((new[b:] - lam[b:]).abs().sum()),
               float(lam[b:].abs().sum()))
        assert got == pytest.approx(pad_share(pad, k, prior, first),
                                    rel=1e-6, abs=1e-6)
        lam = new

    # the first pass's relative change with and without the pad rows
    # brackets local_tol: the exit pass hangs on them
    deltas = []
    for x, l0 in ((padded, lamb_p), (rows, lamb)):
        new = pk.local_solve_packed(x, u, l0, local_iters=1, local_tol=0.0,
                                    **kw)
        deltas.append(float((new - l0).abs().mean()
                            / (l0.abs().mean() + 1.0)))
    tol = sum(deltas) / 2
    assert min(deltas) < tol < max(deltas)
    for m in (1, 2, 3):
        solve = dict(kw, local_iters=m, local_tol=tol)
        want = pk.local_solve_packed(padded, u, lamb_p, **solve)[:b]
        got = pk.local_solve_packed(rows, u, lamb, pad_rows=pad, **solve)
        unpadded = pk.local_solve_packed(rows, u, lamb, **solve)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
        if m > 1:
            assert not torch.allclose(unpadded, want, rtol=1e-4, atol=1e-4)
