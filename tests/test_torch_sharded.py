"""The port's sharded step (terastructure_tpu_torch/parallel/sharded.py)
against the reference's, on the CPU.

The port's ranks are spawned processes over gloo (parallel/ranks.py's
RankPool, running tests/_torch_rank_cases.py; no JAX in them); the reference runs `_build_step_parts`' closures under
jax.shard_map on the emulated devices tests/conftest.py gives. Minibatch
rows, their indices and the column subsample are injected into both
packages (threefry and torch's generators never agree). Held: one step at
(1, 4) through K1's twin and at (2, 2) through the per-iteration branch
(K8 on the subsample or K4, then K7 or K4 + K5) within the reference's
2e-3 (tests/test_sharded.py:214; after the accel tail 1% of lambda
coordinates may lie outside it); `make_plan` and `plan_kernels` against
the reference's over a grid of shapes; the sharded compute-beta against
the port's unsharded compute_lambda; the pipelined chunk bitwise the
per-step runner; the bf16 reduction; fit_sharded at (2, 2) to convergence
against the reference's fit_sharded, its init rows and a re-run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_rank_cases as cases
from terastructure_tpu import SVIConfig as RefConfig
from terastructure_tpu.data import GenotypeData as RefData
from terastructure_tpu.parallel import mesh as ref_meshlib
from terastructure_tpu.parallel import sharded as ref_sharded
from terastructure_tpu_torch import SVIConfig
from terastructure_tpu_torch.data import GenotypeData, simulate_psd
from terastructure_tpu_torch.parallel import mesh as meshlib
from terastructure_tpu_torch.parallel import sharded
from terastructure_tpu_torch.svi import engine
from terastructure_tpu_torch.svi.postprocess import compute_lambda
from terastructure_tpu_torch.utils.labels import mean_abs_theta_error
from terastructure_tpu_torch.parallel.ranks import RankPool

TOL = 2e-3          # tests/test_sharded.py:214
LAMBDA_FRAC = 0.01  # lambda coordinates past TOL after the accel tail


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = RankPool(4, tmp_path_factory.mktemp("ranks"), device="cpu",
                    timeout=240, threads=1)
    yield pool
    pool.close()


def _cfgs(**kw):
    return SVIConfig(**kw), RefConfig(**kw)


def _data(n, l, k, seed, vfrac=0.0, hfrac=0.0):
    _, _, x = simulate_psd(n, l, k, seed=seed)
    return (GenotypeData.from_dense(x, validation_frac=vfrac,
                                    heldout_frac=hfrac, seed=seed),
            RefData.from_dense(x, validation_frac=vfrac, heldout_frac=hfrac,
                               seed=seed))


def _assemble(outs, key, axis_rank):
    """The whole array from the ranks' shards: gamma is split over i
    (the same on every s), lambda over s (the same on every i). Checks
    the copies are bitwise equal."""
    by = {}
    for o in outs:
        part = o[axis_rank]
        if part in by:
            np.testing.assert_array_equal(o[key], by[part])
        by[part] = o[key]
    return np.concatenate([by[p] for p in sorted(by)])


def _ref_step(cfg, grid, gamma, lamb, rows, idx, key):
    """The reference's shard_map'ed step on injected rows and indices."""
    mesh = ref_meshlib.make_mesh(ref_meshlib.MeshSpec(*grid))
    plan = ref_sharded.make_plan(cfg, mesh)
    _, stats_from_rows, apply_gamma, psum_gamma = (
        ref_sharded._build_step_parts(cfg, plan, mesh))

    def local(g, lam, rows_l, idx_l, key):
        s_idx = jax.lax.axis_index(ref_meshlib.SNP_AXIS)
        kb = jax.random.fold_in(jax.random.fold_in(key, 0), s_idx)
        lam, gs = stats_from_rows(g, lam, rows_l, idx_l, jnp.int32(0), kb)
        return apply_gamma(g, psum_gamma(gs), jnp.int32(0)), lam

    f = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(ref_meshlib.GAMMA_SPEC, ref_meshlib.LAMB_SPEC,
                  ref_meshlib.PACKED_SPEC, P(ref_meshlib.SNP_AXIS), P()),
        out_specs=(ref_meshlib.GAMMA_SPEC, ref_meshlib.LAMB_SPEC),
        check_vma=False))
    g, lam = f(jnp.asarray(gamma), jnp.asarray(lamb), jnp.asarray(rows),
               jnp.asarray(idx), key)
    return np.asarray(g), np.asarray(lam)


def _ref_subsample(cfg, plan, key, grid):
    """The reference's column subsample of every (s, i) at step 0:
    choice(fold_in(fold_in(kb, i), 0x5B)), kb = fold_in(fold_in(key, 0),
    s) (terastructure_tpu/parallel/sharded.py:293-299)."""
    ind, snp = grid
    wl = plan.n_padded // 4 // ind
    sub_w = ((cfg.local_sub_n // 4 // ind) // 128) * 128
    out = {}
    for s in range(snp):
        kb = jax.random.fold_in(jax.random.fold_in(key, 0), s)
        for i in range(ind):
            ks = jax.random.fold_in(jax.random.fold_in(kb, i), 0x5B)
            out[(s, i)] = np.asarray(jax.random.choice(
                ks, wl, (sub_w,), replace=False)).astype(np.int64)
    return out


STEP_CASES = {
    # (grid, n, kernel, local_sub_n, stats_kernel)
    "1x4 K1": ((1, 4), 512, "fused", 0, "fused_v2"),
    "2x2 K4 fused_v2": ((2, 2), 1024, "pallas", 0, "fused_v2"),
    "2x2 K4 pair": ((2, 2), 1024, "pallas", 0, "pair"),
    "2x2 K8 fused_v2": ((2, 2), 4096, "pallas", 1024, "fused_v2"),
    "2x2 K8 pair": ((2, 2), 4096, "pallas", 1024, "pair"),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_one_step_holds_the_references(ranks, case):
    grid, n, kernel, sub_n, stats_kernel = STEP_CASES[case]
    l, k, b, seed = 64, 3, 32, 11
    cfg, ref_cfg = _cfgs(n=n, l=l, k=k, batch_size=b, seed=seed,
                         kernel=kernel, lambda_mode="stored",
                         local_sub_n=sub_n, stats_kernel=stats_kernel,
                         dma_gather=False, local_sub_approx_div=False)
    plan = sharded.make_plan(cfg, meshlib.MeshSpec(*grid))
    kp = sharded.plan_kernels(cfg, plan)
    assert kp.want_fused == (kernel == "fused") and kp.use_pk
    data, _ = _data(n, l, k, seed)
    rng = np.random.default_rng(seed)
    gamma = (cfg.alpha_value + rng.random((plan.n_padded, k))).astype(
        np.float32)
    lamb = (1.0 + rng.random((plan.l_padded, k, 2))).astype(np.float32)
    idx = rng.integers(0, plan.l_local, size=b).astype(np.int32)
    block = np.full((plan.l_padded, plan.n_padded // 4), 0xFF, np.uint8)
    block[:l, : data.packed.shape[1]] = data.packed
    s_of = np.repeat(np.arange(grid[1]), plan.batch_per_shard)
    rows = block[s_of * plan.l_local + idx]
    key = jax.random.PRNGKey(seed)
    idx_w = (_ref_subsample(cfg, plan, key, grid) if sub_n else None)
    if sub_n:
        assert next(iter(idx_w.values())).shape == (128,)
    outs = ranks.run(cases.one_step, grid, cfg, gamma, lamb, rows, idx, idx_w)
    got_g = _assemble(outs, "gamma", "i")
    got_l = _assemble(outs, "lamb", "s")
    ref_g, ref_l = _ref_step(ref_cfg, grid, gamma, lamb, rows, idx, key)
    np.testing.assert_allclose(got_g, ref_g, rtol=TOL, atol=TOL)
    off = ~np.isclose(got_l, ref_l, rtol=TOL, atol=TOL)
    assert off.mean() <= LAMBDA_FRAC, (off.sum(), np.abs(got_l - ref_l).max())
    # the sampled rows moved, the others stayed where they were
    moved = np.zeros(plan.l_padded, bool)
    moved[s_of * plan.l_local + idx] = True
    np.testing.assert_array_equal(got_l[~moved], lamb[~moved])


@pytest.mark.parametrize("kernel", ["auto", "fused", "pallas", "dense"])
def test_plan_is_the_references(kernel, monkeypatch):
    """make_plan and plan_kernels against the reference's, which on the CPU
    run as they would on the TPU: the port reaches a kernel (or its twin)
    on every device, as the reference does on the TPU."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for grid in ((1, 1), (1, 4), (2, 2), (4, 2), (1, 8)):
        if kernel == "fused" and grid[0] > 1:
            continue
        ref_mesh = ref_meshlib.make_mesh(ref_meshlib.MeshSpec(*grid))
        for n, l, b, k, dma_min in ((64, 96, 16, 3, 65537),
                                    (2504, 4000, 1024, 8, 8),
                                    (100_000, 100_000, 4096, 10, 65537),
                                    (5000, 800, 256, 12, 64),
                                    (700, 10_000, 4088, 5, 8)):
            if b % grid[1]:
                continue
            kw = dict(n=n, l=l, k=k, batch_size=b, kernel=kernel,
                      dma_gather_min_l=dma_min)
            cfg, ref_cfg = _cfgs(**kw)
            plan = sharded.make_plan(cfg, meshlib.MeshSpec(*grid))
            ref_plan = ref_sharded.make_plan(ref_cfg, ref_mesh)
            assert tuple(plan) == tuple(ref_plan), (grid, kw)
            kp = sharded.plan_kernels(cfg, plan)
            rk = ref_sharded.plan_kernels(ref_cfg, ref_plan, backend="tpu")
            assert (kp.want_fused, kp.use_pk, kp.dma_blocks, kp.wl) == (
                rk.want_fused, rk.use_pk, rk.dma_blocks, rk.wl), (grid, kw)


@pytest.mark.parametrize("entry", ["make_mesh", "fit_sharded"])
def test_no_card_raises_unless_the_cpu_is_asked(entry, monkeypatch):
    """With no process group and no device named, make_mesh and
    fit_sharded take the card, and raise where there is none; the CPU
    runs only where asked for."""
    from terastructure_tpu_torch.parallel import fit_sharded, multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(multihost, "_device", None)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert not torch.distributed.is_initialized()
    cfg = SVIConfig(n=16, l=32, k=2, batch_size=8, max_steps=4, rfreq=2)
    data, _ = _data(16, 32, 2, 0, vfrac=0.05)
    call = dict(make_mesh=lambda **kw: meshlib.make_mesh(**kw),
                fit_sharded=lambda **kw: fit_sharded(cfg, data, **kw))[entry]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        call()
    if entry == "make_mesh":
        assert call(device="cpu").device == torch.device("cpu")
    else:
        assert call(device="cpu").steps == 4


@pytest.mark.parametrize("accel,tol", [(False, 1e-4), (True, 5e-3)])
def test_sharded_compute_lambda_holds_the_unsharded(ranks, accel, tol):
    """The sharded compute-beta core at (2, 2) against the port's
    unsharded compute_lambda, at the reference's tolerances
    (tests/test_sharded.py:251)."""
    n, l, k = 64, 48, 3
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=16, seed=13, local_iters=8,
                    local_accel=accel)
    data, _ = _data(n, l, k, 13)
    gamma = engine.init_state(cfg).gamma.numpy()
    outs = ranks.run(cases.compute_lambda, (2, 2), cfg, data, gamma, 8)
    got = _assemble(outs, "lamb", "s")[:l]
    want = compute_lambda(cfg, torch.from_numpy(gamma),
                          engine.resident_packed(data.packed, "cpu"),
                          block=8).numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_pipelined_chunk_is_the_per_step_runner(ranks):
    """The chunk that gathers step t + 1 inside step t's gamma all-reduce
    is bitwise the per-step runner and the plain chunk, in the stored
    mode (the lambda scatter runs too), at (2, 2) and (1, 4)."""
    n, l, k = 64, 96, 3
    data, _ = _data(n, l, k, 7)
    for grid in ((2, 2), (1, 4)):
        cfg = SVIConfig(n=n, l=l, k=k, batch_size=32, seed=7,
                        lambda_mode="stored")
        for o in ranks.run(cases.chunks, grid, cfg, data, 5):
            for name in ("plain", "step"):
                for a, b in zip(o["overlap"], o[name]):
                    np.testing.assert_array_equal(a, b)
            assert o["overlap"][2] == 5


def test_bf16_reduction_rounds_the_partials(ranks):
    """gamma_psum_dtype="bf16": each rank's partial is rounded to bf16
    before the all-reduce, so one step differs from f32 and a short
    trajectory tracks it (the reference's tests/test_sharded.py:342)."""
    n, l, k = 512, 256, 3
    data, _ = _data(n, l, k, 11)
    gammas = {}
    for dt in ("f32", "bf16"):
        cfg = SVIConfig(n=n, l=l, k=k, batch_size=64, seed=11,
                        lambda_mode="local", gamma_psum_dtype=dt)
        for steps in (1, 120):
            outs = ranks.run(cases.chunks, (2, 2), cfg, data, steps,
                             variants=("overlap",))
            gammas[dt, steps] = _assemble(
                [dict(o, g=o["overlap"][0]) for o in outs], "g", "i")[:n]
    assert not np.array_equal(gammas["bf16", 1], gammas["f32", 1])
    np.testing.assert_allclose(gammas["bf16", 1], gammas["f32", 1],
                               rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(gammas["bf16", 120], gammas["f32", 120],
                               rtol=2e-2, atol=2e-2)


def test_init_rows_are_the_single_device_init(ranks):
    cfg = SVIConfig(n=1000, l=64, k=3, batch_size=16, seed=5)
    for o in ranks.run(cases.init_rows, cfg, (2, 2)):
        rows = slice(o["i"] * 512, o["i"] * 512 + 512)
        single = o["single"][rows]
        np.testing.assert_array_equal(o["mine"][: len(single)], single)


def test_fit_sharded_holds_the_references(ranks):
    """fit_sharded at (2, 2) to convergence: theta MAE and heldout within
    Monte-Carlo error of the reference's fit_sharded on the same data (the
    reference runs its dense path on the CPU, the port its kernels'
    twins; their draws differ); every rank takes the same decisions, and
    a short re-run from the same seed is bitwise."""
    from terastructure_tpu.models import psd as ref_psd
    from terastructure_tpu.parallel import fit_sharded as ref_fit_sharded

    n, l, k, seed = 64, 512, 2, 6
    theta, _, x = simulate_psd(n, l, k, seed=seed)
    data = GenotypeData.from_dense(x, validation_frac=0.02,
                                   heldout_frac=0.02, seed=seed)
    ref_data = RefData.from_dense(x, validation_frac=0.02,
                                  heldout_frac=0.02, seed=seed)
    kw = dict(n=n, l=l, k=k, batch_size=64, rfreq=50, max_steps=4000,
              seed=seed, ind_shards=2, snp_shards=2)
    cfg, ref_cfg = _cfgs(**kw)
    short = cfg.replace(max_steps=100)
    outs = ranks.run(cases.fit, (2, 2), [cfg, short, short], data)
    full, a, b = outs[0]["runs"]
    np.testing.assert_array_equal(a["gamma"], b["gamma"])
    assert a["trace"] == b["trace"] and a["steps"] == 100
    for o in outs:
        assert o["runs"][0]["trace"] == full["trace"]
        assert o["runs"][0]["heldout_ll"] == full["heldout_ll"]
    ref = ref_fit_sharded(ref_cfg, ref_data, mesh=ref_meshlib.make_mesh(
        ref_meshlib.MeshSpec(2, 2)))
    ref_gamma = np.asarray(ref.state.gamma)[:n]
    g = full["gamma"][:n]
    mae = mean_abs_theta_error(g / g.sum(1, keepdims=True), theta)
    ref_mae = mean_abs_theta_error(np.asarray(ref_psd.theta_mean(
        jnp.asarray(ref_gamma))), theta)
    assert full["converged"] and ref.converged
    assert mae < 0.05 and abs(mae - ref_mae) < 0.01, (mae, ref_mae)
    assert abs(full["heldout_ll"] - ref.heldout_ll) < 0.01, (
        full["heldout_ll"], ref.heldout_ll)
