"""Batched replicates at K > 64 and with kernel="dense" (CPU): the batched
twins of K1, K4, K5, K6, K7 and K8 at K = 72 (3 chunks of the K-chunked
bodies) and K = 130 (5, the last ragged) against jax.vmap of the
reference's kernels in interpret mode, each replicate bitwise its single
twin; the batched step (the fused branch, kernel="pallas" under every
stats_kernel, and kernel="dense") against the reference's vmapped step on
injected minibatches, in both lambda modes; whole batched fits bitwise
the port's single fits; the command line's batched replicates at K = 72
and with --kernel dense. On the card the kernels'
replicate axis is held to the single wide kernels by
tests/test_torch_cuda.py (`-k rep_`) and chip_smoke.py.

Tolerances, as the K <= 64 replicate tests state them
(tests/test_torch_replicates.py, tests/test_torch_replicates_bign.py):
K1 f32 2e-4 (tests/test_fused.py), bf16 rtol 2e-3 / atol 1e-5 (a solve,
tests/test_torch_bf16.py); one pass (K4-K8) f32 rtol 2e-5 / atol 1e-5,
bf16 rtol 1e-3 / atol 1e-6; a big-N step 3e-5 (tests/test_torch_bign_
step.py); a fused or dense step 2e-4 (tests/test_torch_engine.py). The
twins and the reference sum in other orders; lambda after the accel
tail's clamped Aitken step may move on a few coordinates
(`_outliers`)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_replicates import _outliers
from test_torch_replicates_bign import (_close, _ports, _singles_bitwise,
                                        _step_inputs)

from terastructure_tpu.config import SVIConfig as RefConfig
from terastructure_tpu.data.pack import pack2bit
from terastructure_tpu.ops import fused_step as ref_fused
from terastructure_tpu.ops import stats_dense as ref_ops
from terastructure_tpu.ops import stats_pallas as ref_pk
from terastructure_tpu.svi import engine as ref_engine
from terastructure_tpu_torch import SVIConfig, cli
from terastructure_tpu_torch.data import GenotypeData, simulate_psd
from terastructure_tpu_torch.ops import fused_step
from terastructure_tpu_torch.ops import stats_packed as pk
from terastructure_tpu_torch.ops.stats_dense import solve_schedule
from terastructure_tpu_torch.svi import engine, fit
from terastructure_tpu_torch.svi.replicates import fit_replicates_batched

R = 3
SOLVE_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
             "bfloat16": dict(rtol=2e-3, atol=1e-5)}
PASS_TOL = {"float32": dict(rtol=2e-5, atol=1e-5),
            "bfloat16": dict(rtol=1e-3, atol=1e-6)}
STEP_TOL = dict(rtol=3e-5, atol=3e-5)      # a big-N step
CORE_TOL = dict(rtol=2e-4, atol=2e-4)      # a fused or dense step
# K1's schedule: the local mode's (cold, accel) at f32; at bf16 the plain
# warm schedule, as tests/test_torch_replicates.py holds K1[rep] at bf16
# (a rounding flip of bf(t) that the accel tail's Aitken step amplifies
# moves g by up to 0.3% there, the single twin as much as the batched)
K1_KW = {"float32": dict(local_iters=7, local_tol=1e-4, accel=True),
         "bfloat16": dict(local_iters=4, local_tol=-1.0, warm_start=True)}


def _inputs(k, b=16, n=512, seed=0):
    """R replicates' packed rows (B, N/4), u (N, K), u planes and lambda
    (B, K, 2) with t1, t0 from it, each of its own draw (numpy)."""
    rng = np.random.default_rng(seed)
    rows = np.stack([pack2bit(rng.integers(0, 4, size=(b, n)).astype(
        np.int8)) for _ in range(R)])
    rows[1, : b // 2] = 0xFF              # rows of one replicate MISSING
    gamma = rng.uniform(0.3, 3.0, size=(R, n, k)).astype(np.float32)
    u = np.array(ref_ops.exp_elog_theta(jnp.asarray(gamma)))
    up = np.stack([np.array(ref_pk.u_to_planes(jnp.asarray(x))) for x in u])
    lamb = rng.uniform(0.5, 3.0, size=(R, b, k, 2)).astype(np.float32)
    t1, t0 = (np.array(t) for t in ref_ops.exp_elog_beta(jnp.asarray(lamb)))
    return rows, u, up, lamb, t1, t0


def _k1(dtype):
    """K1's (port call, reference call, wrapper) on (rows, up, lamb)."""
    kw = dict(K1_KW[dtype], beta_a=1.0, beta_b=1.0)

    def port(rows, up, lamb):
        return fused_step.fused_local_solve(rows, up, lamb,
                                            dtype=getattr(torch, dtype), **kw)

    def ref(rows, up, lamb):
        return ref_fused.fused_local_solve(rows, up, lamb,
                                           dtype=getattr(jnp, dtype),
                                           interpret=True, **kw)
    return port, ref


def _k4(dtype):
    """K4 over rows every replicate shares (the batched eval's pass)."""
    def port(rows, up, t1, t0):
        return pk.lambda_stats_packed(rows, up, t1, t0,
                                      dtype=getattr(torch, dtype))

    def ref(rows, up, t1, t0):
        tb, tw = ref_pk.pick_tiles(*rows.shape)
        return ref_pk.lambda_stats_packed(rows, up, t1, t0, tb=tb, tw=tw,
                                          dtype=getattr(jnp, dtype),
                                          interpret=True)
    return port, ref


WRAPPERS = {"K1": fused_step.fused_local_solve, "K4": pk.lambda_stats_packed,
            "K5": pk.gamma_stats_packed, "K6": pk.batch_stats_fused_packed,
            "K7": pk.batch_stats_fused_v2_packed, "K8": pk.lambda_stats_acat}


# --- the batched twins against the reference's vmapped kernels --------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [72, 130])
@pytest.mark.parametrize("kernel", ["K1", "K4", "K5", "K6", "K7", "K8"])
def test_batched_wide_twin_matches_vmapped_reference(kernel, k, dtype):
    """Each kernel at K > 64 with a leading R = 3 against jax.vmap of the
    reference's Pallas function in interpret mode, on the same numpy
    inputs; one twin call for all R; each replicate bitwise the port's
    single call."""
    rows, u, up, lamb, t1, t0 = _inputs(k, seed=k + len(kernel + dtype))
    fn = WRAPPERS[kernel]
    if kernel == "K1":
        port, ref = _k1(dtype)
        args, in_axes = (rows, up, lamb), 0
    elif kernel == "K4":
        port, ref = _k4(dtype)
        args, in_axes = (rows[0], up, t1, t0), (None, 0, 0, 0)
    else:
        port, ref = _ports(kernel, dtype)
        args, in_axes = (rows, u, up, t1, t0), 0
    t = [torch.from_numpy(a) for a in args]
    before = fn.twin_calls
    got = port(*t)
    assert fn.twin_calls == before + 1
    want = jax.vmap(ref, in_axes=in_axes)(*(jnp.asarray(a) for a in args))
    assert all(g.shape[0] == R for g in got)
    if kernel == "K1":
        tol = SOLVE_TOL[dtype]
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **tol)
        _outliers(got[0].numpy(), np.asarray(want[0]),
                  1e-2 if K1_KW[dtype].get("accel") else 0.0, tol)
    else:
        _close(got, want, PASS_TOL[dtype])
    shared = {0} if kernel == "K4" else set()      # K4's rows
    _singles_bitwise(got, [port(*(a if j in shared else a[i]
                                  for j, a in enumerate(t)))
                           for i in range(R)])


def _solve_f64(rows, up, lamb, **schedule):
    """K1's lambda (warm start, prior 1, 1) with every sum in float64."""
    k = up.shape[-1]
    u = up.reshape(-1, k).double()
    a1, a0 = (a.double() for a in pk.plane_counts(rows))

    def one(lam):
        t1, t0 = fused_step.exp_elog_beta_kernel(lam)
        r1, r0 = a1 / (t1 @ u.T + pk._EPS), a0 / (t0 @ u.T + pk._EPS)
        return torch.stack([1.0 + t1 * (r1 @ u), 1.0 + t0 * (r0 @ u)], -1)
    return one(solve_schedule(one, lamb.double(), **schedule))


@pytest.mark.parametrize("seed", range(6))
def test_accel_tail_moves_lambda_at_k72_in_f32_alone(seed):
    """What chip_smoke.py's REP_WIDE_FRAC (4e-2) rests on: at K1[rep]'s
    timed shape (B = 1,024, W = 640, K = 72) the f32 twin on the warm
    accel schedule differs from the same schedule summed in float64 on
    some lambda entries beyond 2e-4, but on no more than 2% of them
    (1.03-1.64% at these six seeds), while on the plain schedule it
    differs on none: the clamped Aitken step amplifies sum order, so two
    f32 orders (the kernel's and the twin's) may differ on twice that."""
    rng = np.random.default_rng(seed)
    b, n, k = 1024, 2560, 72
    rows = torch.from_numpy(pack2bit(rng.integers(0, 4, size=(b, n)).astype(
        np.int8)))
    gamma = rng.uniform(0.3, 3.0, size=(n, k)).astype(np.float32)
    up = pk.u_to_planes(torch.from_numpy(np.array(ref_ops.exp_elog_theta(
        jnp.asarray(gamma)))))
    lamb = torch.from_numpy(rng.uniform(0.5, 3.0, size=(b, k, 2)).astype(
        np.float32))
    shares = []
    for schedule in (dict(local_iters=7, local_tol=1e-4, accel=True),
                     dict(local_iters=4, local_tol=-1.0, accel=False)):
        got = fused_step.fused_local_solve_twin(
            rows, up, lamb, beta_a=1.0, beta_b=1.0, warm_start=True,
            **schedule)[0].double()
        want = _solve_f64(rows, up, lamb, **schedule)
        shares.append(float(((got - want).abs()
                             > 2e-4 + 2e-4 * want.abs()).double().mean()))
    assert 0.0 < shares[0] <= 2e-2 and shares[1] == 0.0, shares


# --- the batched step against the reference's vmapped step ------------------
def _warm(rng, b, k):
    """(R', B, K, 2) lambda rows of the stored mode's warm start."""
    return rng.uniform(0.5, 3.0, size=(2, b, k, 2)).astype(np.float32)


def _ref_fused_core(cfg, gamma, rows, lamb, w):
    """The fused branch of the reference's make_step (svi/engine.py:
    357-385) on given rows: u padded to 4W, K1, the gamma statistic."""
    n = gamma.shape[0]
    u = ref_ops.exp_elog_theta(gamma)
    u = jnp.pad(u, ((0, 4 * w - n), (0, 0)), constant_values=1.0)
    warm = cfg.lambda_mode != "local"
    new, g = ref_fused.fused_local_solve(
        rows, ref_pk.u_to_planes(u),
        lamb if warm else jnp.zeros_like(lamb), local_iters=cfg.local_iters,
        local_tol=cfg.local_tol, beta_a=cfg.beta_a, beta_b=cfg.beta_b,
        dtype=jnp.float32, warm_start=warm, interpret=True,
        approx_div=cfg.stats_approx_div, accel=cfg.local_accel)
    return new, (u * ref_pk.planes_to_flat(g))[:n]


STEP_CASES = [("fused", None), ("pallas", "fused_v2"), ("pallas", "pair"),
              ("pallas", "fused")]


@pytest.mark.parametrize("mode", ["local", "stored"])
@pytest.mark.parametrize("impl,stats_kernel", STEP_CASES)
def test_batched_wide_step_matches_vmapped_reference(impl, stats_kernel,
                                                     mode):
    """The batched step at K = 72, R = 2, on injected rows (and on the
    big-N path each replicate's column subsample from its own key)
    against jax.vmap of the reference's step, cold at the prior (local)
    or warm from lambda rows (stored); each replicate bitwise the port's
    single step."""
    k, b = 72, 16
    seeds = (7 + len(mode), 8)
    n = 4096 if impl == "pallas" else 512
    rows, gamma = _step_inputs(b, seeds, n=n, k=k)
    rng = np.random.default_rng(seeds[0])
    lamb = _warm(rng, b, k)
    if impl == "fused":
        cfg = RefConfig(n=n, l=100, k=k, batch_size=b, lambda_mode=mode)
        warm = torch.from_numpy(lamb) if mode == "stored" else None
        before = fused_step.fused_local_solve.twin_calls
        got = engine.step_core_fused(cfg, torch.from_numpy(gamma),
                                     torch.from_numpy(rows), warm)
        assert fused_step.fused_local_solve.twin_calls == before + 1
        want = jax.vmap(lambda g, r_, l_: _ref_fused_core(
            cfg, g, r_, l_, rows.shape[-1]))(
            jnp.asarray(gamma), jnp.asarray(rows), jnp.asarray(lamb))
        singles = [engine.step_core_fused(
            cfg, torch.from_numpy(gamma[i]), torch.from_numpy(rows[i]),
            None if warm is None else warm[i]) for i in range(2)]
        # the accel tail's clamped Aitken step moves a few lambda
        # coordinates far, and each shifts g in every column its row
        # touches (chip_smoke.py's REP_G_CAP): measured here, 17 of
        # 73,728 entries of g beyond CORE_TOL, the largest 7.5e-4 of
        # |reference|, the single step's as much as the batched
        _outliers(got[1].numpy(), np.asarray(want[1]), 1e-3, CORE_TOL)
        _outliers(got[0].numpy(), np.asarray(want[0]), 1e-2, CORE_TOL)
    else:
        cfg = RefConfig(n=n, l=100, k=k, batch_size=b, local_sub_n=512,
                        local_accel=False, local_sub_approx_div=False,
                        stats_kernel=stats_kernel, lambda_mode=mode)
        if mode == "local":
            lamb = np.stack([np.stack([np.full((b, k), cfg.beta_a),
                                       np.full((b, k), cfg.beta_b)], -1)
                             ] * 2).astype(np.float32)
        keys = [jax.random.PRNGKey(s) for s in seeds]
        idx_w = np.stack([np.asarray(jax.random.choice(
            kk, rows.shape[-1], (128,), replace=False)) for kk in keys])
        got = engine.step_core_packed(
            cfg, torch.from_numpy(gamma), torch.from_numpy(rows),
            idx_w=torch.from_numpy(idx_w), lamb_b=torch.from_numpy(lamb))
        want = jax.vmap(lambda g, r_, l_, k_: ref_engine.step_core_packed(
            cfg, g, r_, l_, interpret=True, key=k_))(
            jnp.asarray(gamma), jnp.asarray(rows), jnp.asarray(lamb),
            jnp.stack(keys))
        singles = [engine.step_core_packed(
            cfg, torch.from_numpy(gamma[i]), torch.from_numpy(rows[i]),
            idx_w=torch.from_numpy(idx_w[i]),
            lamb_b=torch.from_numpy(lamb[i])) for i in range(2)]
        _close(got, want, STEP_TOL)
    assert got[0].shape == (2, b, k, 2) and got[1].shape == (2, n, k)
    _singles_bitwise(got, singles)


@pytest.mark.parametrize("mode", ["local", "stored"])
@pytest.mark.parametrize("k", [3, 72])
def test_batched_dense_step_matches_vmapped_reference(k, mode):
    """kernel="dense": the batched step's dense core on each replicate's
    unpacked rows against jax.vmap of the reference's step_core_dense,
    cold at the prior (local) or warm (stored); each replicate bitwise
    its single dense step."""
    b, n = 16, 256
    rng = np.random.default_rng(k + len(mode))
    xb = rng.integers(0, 4, size=(2, b, n)).astype(np.int8)
    gamma = rng.uniform(0.05, 30.0, size=(2, n, k)).astype(np.float32)
    cfg = RefConfig(n=n, l=100, k=k, batch_size=b, kernel="dense",
                    lambda_mode=mode)
    lamb = (_warm(rng, b, k) if mode == "stored" else
            np.ones((2, b, k, 2), np.float32))
    t = [torch.from_numpy(a) for a in (gamma, xb, lamb)]
    got = engine.step_core_dense(cfg, *t)
    want = jax.vmap(lambda g, x, lm: ref_engine.step_core_dense(
        cfg, g, x, lm))(*(jnp.asarray(a) for a in (gamma, xb, lamb)))
    assert got[0].shape == (2, b, k, 2) and got[1].shape == (2, n, k)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               **CORE_TOL)
    _outliers(got[0].numpy(), np.asarray(want[0]), 1e-2, CORE_TOL)
    _singles_bitwise(got, [engine.step_core_dense(cfg, *(a[i] for a in t))
                           for i in range(2)])


# --- whole batched fits against single fits ---------------------------------
def _data(n, l, k, seed, vfrac, hfrac):
    _, _, x = simulate_psd(n, l, k, seed=seed)
    return GenotypeData.from_dense(x, validation_frac=vfrac,
                                   heldout_frac=hfrac, seed=seed)


FITS = {"K=72": dict(k=72), "dense": dict(kernel="dense")}


@pytest.mark.parametrize("case", sorted(FITS))
def test_batched_stored_fit_is_the_single_fits_bitwise(case):
    """R = 3 stored-mode replicates at K = 72 (the fused branch's
    K-chunked K1) and with kernel="dense", 40 steps, convergence off:
    each replicate's gamma, lambda, validation ll and steps are its
    single fit's, bitwise, and the best is the single fits' best."""
    data = _data(64, 256, 2, 31, 0.02, 0.0)
    cfg = SVIConfig(n=64, l=256, k=2, batch_size=32, rfreq=20, max_steps=40,
                    conv_tol=-1e9, lambda_mode="stored",
                    seed=100).replace(**FITS[case])
    seeds = [100, 101, 102]
    res = fit_replicates_batched(cfg, data, seeds, device="cpu")
    lls = []
    for i, s in enumerate(seeds):
        single = fit(cfg.replace(seed=s, dma_gather=False), data,
                     device="cpu")
        assert torch.equal(res.states.gamma[i], single.state.gamma)
        assert torch.equal(res.states.lamb[i], single.state.lamb)
        assert res.replicates[i].validation_ll == single.validation_ll
        assert res.replicates[i].steps == single.steps == 40
        lls.append(single.validation_ll)
    assert res.best == int(np.argmax(lls))


@pytest.mark.parametrize("case", sorted(FITS))
def test_batched_local_fit_stops_as_the_single_fits(case):
    """The local mode to convergence at K = 72 and with kernel="dense":
    each replicate's stop step, gamma at the stop and validation and
    heldout lls are its single fit's, bitwise (the batched eval re-solve
    through K4's replicate axis, at K = 72 its K-chunked twin)."""
    data = _data(64, 256, 3, 33, 0.03, 0.03)
    cfg = SVIConfig(n=64, l=256, k=3, batch_size=32, rfreq=10,
                    max_steps=400, conv_tol=1e-3, conv_patience=1,
                    seed=7).replace(**FITS[case])
    seeds = [7, 8]
    before = pk.lambda_stats_packed.twin_calls
    res = fit_replicates_batched(cfg, data, seeds, device="cpu")
    assert pk.lambda_stats_packed.twin_calls > before     # the batched eval
    assert any(rr.converged for rr in res.replicates)
    for i, s in enumerate(seeds):
        rr = res.replicates[i]
        single = fit(cfg.replace(seed=s, dma_gather=False), data,
                     device="cpu")
        assert (rr.converged, rr.steps) == (single.converged, single.steps)
        assert torch.equal(res.states.gamma[i], single.state.gamma)
        assert rr.validation_ll == single.validation_ll
        assert rr.heldout_ll == single.heldout_ll


# --- the command line -------------------------------------------------------
@pytest.mark.parametrize("flags", [["-k", "72"], ["-k", "2", "--kernel",
                                                  "dense"],
                                   ["-k", "72", "--kernel", "dense"]])
def test_cli_batched_replicates_wide_and_dense(tmp_path, flags):
    """`fit --replicates 2 --batched` with -k 72 (K1's K-chunked passes
    with the replicate axis) and with --kernel dense, at the data's K and
    at K = 72, through cli.main on
    the CPU, the reference's flags and run directory: best.json names
    the replicate with the best validation ll, and its text model is
    written."""
    stem = str(tmp_path / "toy")
    cli.main(["simulate", "-n", "24", "-l", "60", "-k", "2", "--seed", "5",
              "-o", stem])
    cli.main(["fit", "--bed", stem + ".bed", *flags, "--replicates", "2",
              "--batched", "--batch-size", "16", "--rfreq", "25",
              "--max-steps", "50", "--label", "reps", "--out-base",
              str(tmp_path), "--seed", "7", "--force-cpu"])
    k = flags[1]
    run_dir = tmp_path / f"n24-k{k}-l60-reps"
    best = json.loads((run_dir / "best.json").read_text())
    lls = {d: json.loads((run_dir / d / "result.json").read_text())[
        "validation_ll"] for d in ("replicate-s7", "replicate-s8")}
    assert best["dir"] == max(lls, key=lls.get)
    assert best["validation_ll"] == lls[best["dir"]]
    lines = (run_dir / best["dir"] / "theta.txt").read_text().splitlines()
    assert len(lines) == 24
    assert all(len(x.split("\t")) == 2 + int(k) for x in lines)

