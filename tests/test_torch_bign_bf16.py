"""compute_dtype="bfloat16" on the big-N path: the port's bf16 twins of K5,
K6, K7 and K8 and its big-N step (engine.step_core_packed) against the
reference's at dtype=jnp.bfloat16, with the Pallas kernels in interpret
mode on the CPU and the same column subsample injected into both steps.
The bf16 bodies on the card are held to these twins in
tests/test_torch_cuda.py and chip_smoke.py.

What bf16 computes (both packages): T, U and R = A / (D + eps) enter the
products rounded to bf16, R after the f32 divide; the products sum in
f32; the wrappers scale by the unrounded t and u; K8's count planes are
bf16 at both dtypes (exact for counts 0, 1, 2); everything else (the
schedule, the tol test with the pad rows' share, Aitken, the update) is
f32. Tolerances, as tests/test_torch_bf16.py states them:
- one pass (K5, K6, K7, K8, the pair): rtol 1e-3, atol 1e-6. Both sides
  round the same operands; they differ in the order of the f32 sums, and
  in the rare R whose rounding flips on an ulp of D;
- a solve or a step: rtol 2e-3, atol 1e-5; lambda after the accel tail
  with the f32 path's allowance of 1% of its entries (its clamped Aitken
  step, tests/test_torch_group_dma.py);
- the fast divide: 5e-3, the f32 path's tolerance for the fast
  reciprocal (tests/test_torch_bign.py).

Inputs are small and made from a numpy seed: B <= 24, W <= 256 byte
columns, K in {3, 10} for the kernels; the step needs W >= 512 for its
column subsample to engage (4 x 128 columns), and the tol-exit case
keeps the f32 test's shape, whose local_tol the pad rows decide.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.data.pack import pack2bit
from terastructure_tpu.ops import stats_dense as ref_ops
from terastructure_tpu.ops import stats_pallas as ref_pk
from terastructure_tpu.svi import engine as ref_engine
from terastructure_tpu_torch.ops import stats_packed as pk
from terastructure_tpu_torch.svi import engine

PASS_TOL = dict(rtol=1e-3, atol=1e-6)
SOLVE_TOL = dict(rtol=2e-3, atol=1e-5)
APPROX_TOL = dict(rtol=5e-3, atol=5e-3)
BF16 = torch.bfloat16
KS = [3, 10]
REF = dict(tb=8, tw=128, dtype=jnp.bfloat16, interpret=True)  # 3 x 2 tiles


def _problem(k, seed, b=24, n=1024):
    """Packed rows (B, N/4) with MISSING entries, u (N, K), t1, t0 (B, K)."""
    rng = np.random.default_rng(seed)
    rows = pack2bit(rng.integers(0, 4, size=(b, n)).astype(np.int8))
    gamma = rng.uniform(0.3, 3.0, size=(n, k)).astype(np.float32)
    u = np.array(ref_ops.exp_elog_theta(jnp.asarray(gamma)))
    lamb = rng.uniform(0.5, 4.0, size=(b, k, 2)).astype(np.float32)
    t1, t0 = (np.array(t) for t in ref_ops.exp_elog_beta(jnp.asarray(lamb)))
    return rows, u, t1, t0


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


def _outliers(got, want, frac, tol=SOLVE_TOL):
    bad = np.abs(got - want) > tol["atol"] + tol["rtol"] * np.abs(want)
    assert bad.mean() <= frac, bad.mean()


# --- the kernels' twins --------------------------------------------------------
@pytest.mark.parametrize("k", KS)
def test_k5_bf16_twin_matches_reference_interpret(k):
    rows, u, t1, t0 = _problem(k, seed=k)
    up = np.array(ref_pk.u_to_planes(jnp.asarray(u)))
    before = pk.gamma_stats_packed.twin_calls
    got = pk.gamma_stats_packed(*_t(rows, up, t1, t0), dtype=BF16)
    assert pk.gamma_stats_packed.twin_calls == before + 1
    want = ref_pk.gamma_stats_packed(rows, up, t1, t0, **REF)
    _close([got], [want], PASS_TOL)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("name", ["batch_stats_fused_v2_packed",
                                  "batch_stats_fused_packed",
                                  "batch_stats_packed"])
def test_stats_pass_bf16_matches_reference_interpret(name, k):
    """K7, K6 and the pair (K4 + K5) at bf16 against the reference's
    kernels at bf16."""
    rows, u, t1, t0 = _problem(k, seed=10 + k)
    got = getattr(pk, name)(*_t(rows, u, t1, t0), dtype=BF16)
    _close(got, getattr(ref_pk, name)(rows, u, t1, t0, **REF), PASS_TOL)


@pytest.mark.parametrize("k", KS)
def test_k7_bf16_fast_divide_matches_reference_interpret(k):
    rows, u, t1, t0 = _problem(k, seed=20 + k)
    before = pk.batch_stats_fused_v2_packed.twin_calls
    got = pk.batch_stats_fused_v2_packed(*_t(rows, u, t1, t0),
                                         approx_div=True, dtype=BF16)
    assert pk.batch_stats_fused_v2_packed.twin_calls == before + 1
    want = ref_pk.batch_stats_fused_v2_packed(rows, u, t1, t0,
                                              approx_div=True, **REF)
    _close(got, want, APPROX_TOL)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("approx_div", [False, True])
def test_k8_bf16_twin_matches_reference_interpret(approx_div, k):
    rows, u, t1, t0 = _problem(k, seed=30 + k)
    up = np.array(ref_pk.u_to_planes(jnp.asarray(u)))
    a1, a0 = pk.decode_count_planes(torch.from_numpy(rows))
    before = pk.lambda_stats_acat.twin_calls
    got = pk.lambda_stats_acat(a1, a0, *_t(up, t1, t0),
                               approx_div=approx_div, dtype=BF16)
    assert pk.lambda_stats_acat.twin_calls == before + 1
    ra1, ra0 = ref_pk.decode_count_planes(jnp.asarray(rows))
    want = ref_pk.lambda_stats_acat(ra1, ra0, up, t1, t0,
                                    approx_div=approx_div, **REF)
    _close(got, want, APPROX_TOL if approx_div else PASS_TOL)


@pytest.mark.parametrize("accel", [False, True])
def test_local_solve_acat_bf16_matches_reference_interpret(accel):
    rows, u, _, _ = _problem(3, seed=41, b=16, n=512)
    lamb = np.random.default_rng(4).uniform(0.5, 3.0, (16, 3, 2)).astype(
        np.float32)
    kw = dict(beta_a=1.0, beta_b=1.0, local_iters=7, local_tol=1e-4,
              accel=accel, stat_scale=2.0)
    got = pk.local_solve_acat(*_t(rows, u, lamb), dtype=BF16, **kw)
    want = ref_pk.local_solve_acat(
        jnp.asarray(rows), jnp.asarray(u), jnp.asarray(lamb), **REF, **kw)
    _outliers(got.numpy(), np.asarray(want), 1e-2 if accel else 0.0)


# --- the step ------------------------------------------------------------------
def _both(cfg, rows, gamma, seed, which="both"):
    """(port, reference) step_core_packed results from one column
    subsample drawn by the reference's key; which="port" or "ref" runs
    only that side (the other is None)."""
    key = jax.random.PRNGKey(seed)
    b, wp = rows.shape
    sub_w = (cfg.local_sub_n // 4 // 128) * 128
    idx_w = np.asarray(jax.random.choice(key, wp, (sub_w,), replace=False))
    lamb_b = jnp.stack([jnp.full((b, cfg.k), cfg.beta_a, jnp.float32),
                        jnp.full((b, cfg.k), cfg.beta_b, jnp.float32)], -1)
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


def _step_inputs(b, n, k, seed):
    rng = np.random.default_rng(seed)
    rows = pack2bit(rng.integers(0, 4, size=(b, n)).astype(np.int8))
    gamma = rng.uniform(0.05, 30.0, size=(n, k)).astype(np.float32)
    return rows, gamma


@pytest.mark.parametrize("decode_once", [True, False])
@pytest.mark.parametrize("stats_kernel", ["fused_v2", "pair", "fused"])
def test_step_core_packed_bf16_matches_reference(stats_kernel, decode_once):
    """The big-N step at bf16, each statistics kernel, the subsampled solve
    through K8 (count planes decoded once) or K4: lambda_B and the gamma
    statistic within the step tolerance; the bf16 bodies ran (on the CPU,
    their twins) and no f32 one."""
    n, k, b = 2048, 3, 16
    cfg = SVIConfig(n=n, l=100, k=k, batch_size=b, local_sub_n=512,
                    local_accel=False, local_sub_approx_div=False,
                    stats_kernel=stats_kernel, sub_decode_once=decode_once,
                    compute_dtype="bfloat16")
    rows, gamma = _step_inputs(b, n, k, seed=50 + decode_once)
    solve = pk.lambda_stats_acat if decode_once else pk.lambda_stats_packed
    before = solve.twin_calls
    got, want = _both(cfg, rows, gamma, seed=5)
    assert got[0].shape == (b, k, 2) and got[1].shape == (n, k)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **SOLVE_TOL)
    assert solve.twin_calls - before >= cfg.local_iters


def test_step_core_packed_bf16_accel_gamma_matches_reference():
    """The default accel tail at bf16 (exact divide in the subsampled
    passes): the gamma statistic, all the step uses, within the step
    tolerance; lambda_B, which the clamped Aitken step extrapolates, with
    the 1% allowance. A lambda coordinate that the Aitken step moves
    turns its row's bf(t) by an ulp of bf16 (2^-8) and that row's share of
    the gamma statistic with it, so at most 0.1% of the gamma entries may
    lie beyond the step tolerance (chip_smoke.py's FLIP_FRAC). (With the
    fast divide as well, the two packages' reciprocals differ and the
    Aitken step carries that into gamma, as at f32,
    tests/test_torch_bign_step.py: that case is held to its twin on the
    card.)"""
    n, k, b = 2048, 3, 16
    cfg = SVIConfig(n=n, l=100, k=k, batch_size=b, local_sub_n=512,
                    local_sub_approx_div=False, compute_dtype="bfloat16")
    assert cfg.local_accel
    rows, gamma = _step_inputs(b, n, k, seed=53)
    got, want = _both(cfg, rows, gamma, seed=6)
    _outliers(got[1], want[1], 1e-3)
    _outliers(got[0], want[0], 1e-2)


def test_step_core_packed_bf16_tol_exit_at_b12_matches_reference():
    """B = 12 at bf16: the reference pads the batch with 4 all-MISSING
    rows and its tol test averages over them; local_tol = 400 lies
    between the first pass's relative change with those rows and
    without, so the exit pass hangs on them (the f32 case,
    tests/test_torch_bign_step.py). The port exits where the reference
    does, and matches it within the step tolerance."""
    n, k, b, seed = 4096, 3, 12, 12
    cfg = SVIConfig(n=n, l=100, k=k, batch_size=b, local_sub_n=512,
                    local_accel=False, local_sub_approx_div=False,
                    beta_a=2.0, beta_b=0.5, local_tol=400.0,
                    compute_dtype="bfloat16")
    assert engine.batch_pad_rows(b) == 4
    rows, gamma = _step_inputs(b, n, k, seed=seed)

    def exit_pass(which):
        runs = [_both(cfg.replace(local_iters=m), rows, gamma, seed,
                      which=which)[which == "ref"] for m in (1, 2, 3)]
        m = next(m for m in (1, 2, 3) if all(
            np.array_equal(a, c) for a, c in zip(runs[m - 1], runs[-1])))
        return m, runs[-1]

    port_pass, got = exit_pass("port")
    ref_pass, want = exit_pass("ref")
    assert port_pass == ref_pass == 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **SOLVE_TOL)


def test_bign_bf16_step_differs_from_f32():
    """The rounding happens: on the same inputs and subsample the bf16
    step's gamma statistic and lambda_B differ from the f32 step's by more
    than f32 rounding somewhere, and by less than bf16's own scale."""
    n, k, b = 2048, 3, 16
    cfg = SVIConfig(n=n, l=100, k=k, batch_size=b, local_sub_n=512,
                    local_accel=False)
    rows, gamma = _step_inputs(b, n, k, seed=54)
    lo, _ = _both(cfg.replace(compute_dtype="bfloat16"), rows, gamma, 7,
                  which="port")
    hi, _ = _both(cfg, rows, gamma, 7, which="port")
    for g, w in zip(lo, hi):
        rel = float(np.abs(g - w).max() / np.abs(w).max())
        assert 1e-4 < rel < 5e-2, rel
