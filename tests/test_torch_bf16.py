"""compute_dtype="bfloat16" on the resident path: the port's bf16 twins of
K1, K2 and K4 and its dense statistics against the reference's at
dtype=jnp.bfloat16 (Pallas in interpret mode on the CPU), one engine
step of each branch, and a short dense fit's gamma.

What bf16 computes (both packages): T, U and R enter the products
rounded to bf16, the products sum in f32, everything else (the divide,
the update beta + t * S with the unrounded t, the tol test, Aitken) is
f32. Tolerances:
- one pass (K4, the dense statistics): rtol 1e-3, atol 1e-6. Both sides
  round the same operands; they differ in the order of the f32 sums, and
  in the rare R whose rounding flips on an ulp of D;
- a fused solve (K1, K2), an engine step, a lambda re-solve: rtol 2e-3
  (atol 1e-5); lambda after the accel tail with the f32 path's allowance
  of 1% of its entries (the clamped Aitken step,
  tests/test_torch_group_dma.py);
- approx_div: 5e-3, the f32 path's tolerance for the fast reciprocal
  (tests/test_torch_kernels.py, tests/test_fused.py:258).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.data.pack import pack2bit
from terastructure_tpu.ops import fused_step as ref_fused
from terastructure_tpu.ops import stats_dense as ref_ops
from terastructure_tpu.ops import stats_pallas as ref_pk
from terastructure_tpu.svi import engine as ref_engine
from terastructure_tpu_torch.ops import fused_step, stats_dense, stats_packed
from terastructure_tpu_torch.svi import engine

PASS_TOL = dict(rtol=1e-3, atol=1e-6)
SOLVE_TOL = dict(rtol=2e-3, atol=1e-5)
APPROX_TOL = dict(rtol=5e-3, atol=5e-3)
BF16 = torch.bfloat16


def _problem(b=16, n=512, k=3, seed=0):
    """Packed rows (B, N/4) with MISSING entries, u_planes (4, W, K), t1,
    t0 (B, K) and lambda rows (B, K, 2), from one numpy seed."""
    rng = np.random.default_rng(seed)
    rows = pack2bit(rng.integers(0, 4, size=(b, n)).astype(np.int8))
    gamma = rng.uniform(0.3, 3.0, size=(n, k)).astype(np.float32)
    u = np.asarray(ref_ops.exp_elog_theta(jnp.asarray(gamma)))
    up = np.array(ref_pk.u_to_planes(jnp.asarray(u)))
    lamb = rng.uniform(0.5, 3.0, size=(b, k, 2)).astype(np.float32)
    t1, t0 = (np.asarray(t) for t in ref_ops.exp_elog_beta(jnp.asarray(lamb)))
    return rows, up, lamb, t1, t0


def _outliers(got, want, frac, tol=SOLVE_TOL):
    bad = np.abs(got - want) > tol["atol"] + tol["rtol"] * np.abs(want)
    assert bad.mean() <= frac, bad.mean()


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# --- the dense twin: bf16 operands, f32 sums --------------------------------
@pytest.mark.parametrize("fn", ["batch_stats", "lambda_stats"])
def test_dense_stats_keep_f32_sums_at_bf16(fn):
    """bf16 x bf16 products summed in f32, as the reference's
    preferred_element_type=float32: D, the lambda statistic and the gamma
    statistic are not rounded to bf16."""
    rng = np.random.default_rng(3)
    b, n, k = 24, 200, 4
    x = rng.integers(0, 4, size=(b, n)).astype(np.int8)
    gamma = rng.uniform(0.3, 3.0, size=(n, k)).astype(np.float32)
    lamb = rng.uniform(0.5, 3.0, size=(b, k, 2)).astype(np.float32)
    a1, a0 = ref_ops.allele_counts(jnp.asarray(x), jnp.float32)
    u = ref_ops.exp_elog_theta(jnp.asarray(gamma))
    t1, t0 = ref_ops.exp_elog_beta(jnp.asarray(lamb))
    want = getattr(ref_ops, fn)(a1, a0, u, t1, t0, jnp.bfloat16)
    got = getattr(stats_dense, fn)(
        *_t(np.asarray(a1), np.asarray(a0), np.asarray(u), np.asarray(t1),
            np.asarray(t0)), BF16)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PASS_TOL)


def test_dense_bf16_differs_from_f32():
    """The rounding happens: bf16 and f32 statistics differ by more than
    f32 rounding somewhere, and by less than bf16's own scale."""
    rng = np.random.default_rng(4)
    b, n, k = 16, 128, 3
    x = torch.from_numpy(rng.integers(0, 4, size=(b, n)).astype(np.int8))
    a1, a0 = stats_dense.allele_counts(x)
    u = stats_dense.exp_elog_theta(
        torch.from_numpy(rng.uniform(0.3, 3.0, (n, k)).astype(np.float32)))
    t1, t0 = stats_dense.exp_elog_beta(
        torch.from_numpy(rng.uniform(0.5, 3.0, (b, k, 2)).astype(np.float32)))
    lo = stats_dense.batch_stats(a1, a0, u, t1, t0, BF16)
    hi = stats_dense.batch_stats(a1, a0, u, t1, t0)
    for g, w in zip(lo, hi):
        rel = float((g - w).abs().max() / w.abs().max())
        assert 1e-4 < rel < 5e-2, rel


# --- K4 and its solve --------------------------------------------------------
@pytest.mark.parametrize("approx", [False, True])
def test_k4_bf16_twin_matches_reference_interpret(approx):
    rows, up, _, t1, t0 = _problem(seed=11)
    before = stats_packed.lambda_stats_packed.twin_calls
    got = stats_packed.lambda_stats_packed(*_t(rows, up, t1, t0),
                                           approx_div=approx, dtype=BF16)
    assert stats_packed.lambda_stats_packed.twin_calls == before + 1
    want = ref_pk.lambda_stats_packed(
        jnp.asarray(rows), jnp.asarray(up), jnp.asarray(t1), jnp.asarray(t0),
        tb=16, tw=128, dtype=jnp.bfloat16, interpret=True,
        approx_div=approx)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   **(APPROX_TOL if approx else PASS_TOL))


@pytest.mark.parametrize("accel", [False, True])
def test_local_solve_packed_bf16_matches_reference_interpret(accel):
    rows, up, lamb, _, _ = _problem(seed=12)
    u = up.transpose(1, 0, 2).reshape(-1, up.shape[-1])
    kw = dict(beta_a=1.0, beta_b=1.0, local_iters=7, local_tol=1e-4,
              accel=accel)
    got = stats_packed.local_solve_packed(*_t(rows, u, lamb), dtype=BF16,
                                          **kw)
    want = ref_pk.local_solve_packed(
        jnp.asarray(rows), jnp.asarray(u), jnp.asarray(lamb), tb=16, tw=128,
        dtype=jnp.bfloat16, interpret=True, **kw)
    _outliers(got.numpy(), np.asarray(want), 1e-2 if accel else 0.0)


def test_wrappers_refuse_other_compute_dtypes():
    rows, up, lamb, t1, t0 = _problem()
    with pytest.raises(NotImplementedError):
        stats_packed.lambda_stats_packed(*_t(rows, up, t1, t0),
                                         dtype=torch.float16)
    with pytest.raises(NotImplementedError):
        fused_step.fused_local_solve(*_t(rows, up, lamb), local_iters=3,
                                     local_tol=-1.0, beta_a=1.0, beta_b=1.0,
                                     dtype=torch.float16)
    # the big-N step's kernels: K5, K6, K7, K8
    rows_t, up_t, t1_t, t0_t = _t(rows, up, t1, t0)
    u_t = stats_packed.planes_to_flat(up_t).contiguous()
    a1, a0 = stats_packed.decode_count_planes(rows_t)
    for call in (
            lambda dt: stats_packed.gamma_stats_packed(rows_t, up_t, t1_t,
                                                       t0_t, dt),
            lambda dt: stats_packed.batch_stats_fused_packed(
                rows_t, u_t, t1_t, t0_t, dtype=dt),
            lambda dt: stats_packed.batch_stats_fused_v2_packed(
                rows_t, u_t, t1_t, t0_t, dtype=dt),
            lambda dt: stats_packed.lambda_stats_acat(a1, a0, up_t, t1_t,
                                                      t0_t, dtype=dt)):
        with pytest.raises(NotImplementedError):
            call(torch.float16)
        assert call(BF16)[0].dtype == torch.float32


# --- K1 and K2 ------------------------------------------------------------
K1_CASES = {
    "cold_plain": dict(local_iters=6, local_tol=-1.0),
    "cold_accel": dict(local_iters=7, local_tol=1e-4, accel=True),
    "warm_plain": dict(local_iters=4, local_tol=-1.0, warm_start=True),
    "warm_accel": dict(local_iters=7, local_tol=-1.0, warm_start=True,
                       accel=True),
    "approx_div": dict(local_iters=6, local_tol=0.0, approx_div=True),
}


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_bf16_twin_matches_reference_interpret(case):
    rows, up, lamb, _, _ = _problem(seed=len(case))
    kw = dict(K1_CASES[case], beta_a=1.0, beta_b=1.0)
    before = fused_step.fused_local_solve.twin_calls
    got = fused_step.fused_local_solve(*_t(rows, up, lamb), dtype=BF16, **kw)
    assert fused_step.fused_local_solve.twin_calls == before + 1
    want = ref_fused.fused_local_solve(
        jnp.asarray(rows), jnp.asarray(up), jnp.asarray(lamb),
        dtype=jnp.bfloat16, interpret=True, **kw)
    tol = APPROX_TOL if kw.get("approx_div") else SOLVE_TOL
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **tol)
    _outliers(got[0].numpy(), np.asarray(want[0]),
              1e-2 if kw.get("accel") else 0.0, tol)


@pytest.mark.parametrize("case", ["plain", "accel_warm"])
def test_k2_bf16_twin_matches_reference_interpret(case):
    rng = np.random.default_rng(21)
    b, n, l, k, g = 32, 512, 128, 3, 8
    packed = pack2bit(rng.integers(0, 4, size=(l, n)).astype(np.int8))
    gamma = rng.uniform(0.3, 3.0, size=(n, k)).astype(np.float32)
    idx0 = (rng.integers(0, l // g, size=b // g) * g).astype(np.int32)
    lamb = rng.uniform(0.5, 3.0, size=(b, k, 2)).astype(np.float32)
    extra = (dict(local_iters=5, local_tol=-1.0) if case == "plain" else
             dict(local_iters=7, local_tol=1e-4, accel=True,
                  warm_start=True))
    kw = dict(beta_a=1.0, beta_b=1.0, **extra)
    u = ref_ops.exp_elog_theta(jnp.asarray(gamma))
    up = np.array(ref_pk.u_to_planes(u))
    want = ref_fused.fused_local_solve_dma(
        jnp.asarray(idx0), jnp.asarray(packed), jnp.asarray(up),
        jnp.asarray(lamb), group=g, dtype=jnp.bfloat16, interpret=True, **kw)
    got = fused_step.fused_local_solve_dma(*_t(idx0, packed, up, lamb),
                                           group=g, dtype=BF16, **kw)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               **SOLVE_TOL)
    _outliers(got[0].numpy(), np.asarray(want[0]),
              1e-2 if kw.get("accel") else 0.0)
    # K2 is K1 on the gathered rows, bitwise
    rows = packed[(idx0[:, None] + np.arange(g)).reshape(-1)]
    k1 = fused_step.fused_local_solve(*_t(rows, up, lamb), dtype=BF16, **kw)
    assert all(torch.equal(a, c) for a, c in zip(got, k1))


# --- the engine's branches -----------------------------------------------
@pytest.mark.parametrize("accel,t", [(True, 0), (False, 9)])
def test_fused_step_bf16_matches_reference_with_injected_indices(accel, t):
    """One local-mode step through the fused branch (K1) at bf16, the
    reference's side assembled from its make_step (engine.py:347-380,
    409) with the same minibatch."""
    n, l, k, b = 96, 300, 3, 32
    rng = np.random.default_rng(t)
    packed = engine.pad_width(pack2bit(
        rng.integers(0, 4, size=(l, n)).astype(np.int8)))
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=b, seed=5, local_accel=accel,
                    local_iters=7 if accel else 6, compute_dtype="bfloat16")
    s0 = ref_engine.init_state(cfg)._replace(t=jnp.int32(t))
    rows = packed[rng.choice(l, b, replace=False)]
    u = ref_ops.exp_elog_theta(s0.gamma)
    u = jnp.pad(u, ((0, 4 * packed.shape[1] - n), (0, 0)),
                constant_values=1.0)
    _, g = ref_fused.fused_local_solve(
        jnp.asarray(rows), ref_pk.u_to_planes(u),
        jnp.zeros((b, k, 2), jnp.float32), local_iters=cfg.local_iters,
        local_tol=cfg.local_tol, beta_a=1.0, beta_b=1.0, dtype=jnp.bfloat16,
        interpret=True, accel=accel)
    stat = (u * ref_pk.planes_to_flat(g))[:n]
    want = ref_engine._global_update(cfg, s0.gamma, stat, s0.t, l)

    st = engine.state_from_reference(s0.gamma, s0.lamb, s0.t, cfg.seed)
    before = fused_step.fused_local_solve.twin_calls
    _, got_stat = engine.step_core_fused(cfg, st.gamma, torch.from_numpy(rows))
    assert fused_step.fused_local_solve.twin_calls == before + 1
    got = engine._global_update(cfg, st.gamma, got_stat, st.t, l)
    np.testing.assert_allclose(got_stat.numpy(), np.asarray(stat),
                               **SOLVE_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SOLVE_TOL)


def _dense_problem(seed, n=64, b=16, k=2):
    rng = np.random.default_rng(seed)
    xb = rng.integers(0, 4, (b, n)).astype(np.int8)
    gamma = rng.uniform(0.3, 3.0, (n, k)).astype(np.float32)
    return xb, gamma, np.ones((b, k, 2), np.float32)


@pytest.mark.parametrize("accel", [False, True])
def test_dense_step_core_bf16_matches_reference(accel):
    n, l, k, b = 64, 100, 2, 16
    xb, gamma, lamb = _dense_problem(2, n, b, k)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=b, kernel="dense",
                    compute_dtype="bfloat16", local_accel=accel)
    got = engine.step_core_dense(cfg, *_t(gamma, xb, lamb))
    want = ref_engine.step_core_dense(cfg, jnp.asarray(gamma),
                                      jnp.asarray(xb), jnp.asarray(lamb))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               **SOLVE_TOL)
    _outliers(got[0].numpy(), np.asarray(want[0]), 1e-2 if accel else 0.0)


def test_short_dense_fit_gamma_bf16_matches_reference():
    """Five dense bf16 steps with the same injected minibatches on both
    sides: gamma after the last one. Without the accel tail: its clamped
    Aitken step is discontinuous, so once a lambda coordinate lands on
    the other side of a clamp (the 1% the single-step tests allow), the
    next steps' gamma statistics move by percents on either side; a step
    with accel is held by the tests above, a whole fit with it by
    tests/test_torch_lambda_pass.py."""
    n, l, k, b = 64, 120, 2, 16
    rng = np.random.default_rng(7)
    x = rng.integers(0, 4, (l, n)).astype(np.int8)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=b, kernel="dense",
                    compute_dtype="bfloat16", seed=7, local_accel=False)
    ref_gamma = ref_engine.init_state(cfg).gamma
    gamma = torch.from_numpy(np.array(ref_gamma))
    lamb0 = np.ones((b, k, 2), np.float32)
    for t in range(5):
        xb = x[rng.choice(l, b, replace=False)]
        _, stat = ref_engine.step_core_dense(cfg, ref_gamma, jnp.asarray(xb),
                                             jnp.asarray(lamb0))
        ref_gamma = ref_engine._global_update(cfg, ref_gamma, stat,
                                              jnp.int32(t), l)
        _, stat = engine.step_core_dense(cfg, gamma, *_t(xb, lamb0))
        gamma = engine._global_update(cfg, gamma, stat, t, l)
    np.testing.assert_allclose(gamma.numpy(), np.asarray(ref_gamma),
                               **SOLVE_TOL)


def test_gamma_pass_bf16_twin_matches_reference_interpret():
    """The γ pass at bf16 (K5's bf16 entry, the last pass of K1 and K2)
    against the reference's gamma_stats_packed at dtype=jnp.bfloat16."""
    rows, up, _, t1, t0 = _problem(b=32, seed=13)
    before = stats_packed.gamma_stats_packed.twin_calls
    got = stats_packed.gamma_stats_packed(*_t(rows, up, t1, t0), dtype=BF16)
    assert stats_packed.gamma_stats_packed.twin_calls == before + 1
    want = ref_pk.gamma_stats_packed(
        jnp.asarray(rows), jnp.asarray(up), jnp.asarray(t1), jnp.asarray(t0),
        tb=32, tw=128, dtype=jnp.bfloat16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PASS_TOL)
