"""Batched replicates on the big-N path (CPU): the batched twins of K5-K8
and the batched step (engine.step_core_packed on stacked inputs, each
replicate's own column subsample injected) against jax.vmap of the
reference's kernels and step in interpret mode, as the reference's
batched fit vmaps its step (terastructure_tpu/svi/replicates.py:98-107);
each replicate bitwise the port's single call, step and fit, including
a tol exit that one replicate takes before the other; the command line's
batched fit on the big-N path. The kernels' replicate axis is held to
the single kernels on the card by tests/test_torch_cuda.py."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terastructure_tpu.config import SVIConfig as RefConfig
from terastructure_tpu.data.pack import pack2bit
from terastructure_tpu.ops import stats_dense as ref_ops
from terastructure_tpu.ops import stats_pallas as ref_pk
from terastructure_tpu.svi import engine as ref_engine
from terastructure_tpu_torch import SVIConfig, cli
from terastructure_tpu_torch.data import GenotypeData, simulate_psd
from terastructure_tpu_torch.ops import stats_packed as pk
from terastructure_tpu_torch.svi import engine, fit
from terastructure_tpu_torch.svi.replicates import fit_replicates_batched

N, K = 4096, 3          # W = 1024 byte columns; local_sub_n=512 -> 128
R = 2
TOL = dict(rtol=2e-5, atol=1e-5)            # one pass, tests/test_torch_bign.py
PASS_TOL = dict(rtol=1e-3, atol=1e-6)       # a bf16 pass, test_torch_bign_bf16
STEP_TOL = dict(rtol=3e-5, atol=3e-5)       # a step, test_torch_bign_step
SOLVE_TOL = dict(rtol=2e-3, atol=1e-5)      # a bf16 step, test_torch_bign_bf16


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol)


def _singles_bitwise(got, singles):
    """Replicate i of a batched call's outputs is bitwise singles[i]."""
    for i, one in enumerate(singles):
        assert all(torch.equal(g[i], o) for g, o in zip(got, one)), i


# --- the batched twins against the reference's vmapped kernels --------------
def _pass_inputs(b=24, n=1024, k=4, seed=5):
    """R replicates' packed rows, u (N, K), its planes and t1, t0 (B, K),
    each of its own draw (numpy)."""
    rng = np.random.default_rng(seed)
    rows = np.stack([pack2bit(rng.integers(0, 4, size=(b, n)).astype(
        np.int8)) for _ in range(R)])
    gamma = rng.uniform(0.3, 3.0, size=(R, n, k)).astype(np.float32)
    u = np.array(ref_ops.exp_elog_theta(jnp.asarray(gamma)))
    up = np.stack([np.array(ref_pk.u_to_planes(jnp.asarray(x))) for x in u])
    lamb = rng.uniform(0.5, 4.0, size=(R, b, k, 2)).astype(np.float32)
    t1, t0 = (np.array(t) for t in ref_ops.exp_elog_beta(jnp.asarray(lamb)))
    return rows, u, up, t1, t0


def _ports(kernel, dtype):
    """(port call, reference call) of a kernel on (rows, u, up, t1, t0)."""
    tdt = getattr(torch, dtype)
    kw = dict(dtype=getattr(jnp, dtype), interpret=True)

    def tiles(rows):
        tb, tw = ref_pk.pick_tiles(*rows.shape)
        return dict(kw, tb=tb, tw=tw)

    if kernel == "K8":
        def port(rows, u, up, t1, t0):
            a1, a0 = pk.decode_count_planes(rows)
            return pk.lambda_stats_acat(a1, a0, up, t1, t0, dtype=tdt)

        def ref(rows, u, up, t1, t0):
            a1, a0 = ref_pk.decode_count_planes(rows)
            return ref_pk.lambda_stats_acat(a1, a0, up, t1, t0, **tiles(rows))
    elif kernel == "K5":
        def port(rows, u, up, t1, t0):
            return [pk.gamma_stats_packed(rows, up, t1, t0, tdt)]

        def ref(rows, u, up, t1, t0):
            return [ref_pk.gamma_stats_packed(rows, up, t1, t0, **tiles(rows))]
    else:
        name = {"K6": "batch_stats_fused_packed",
                "K7": "batch_stats_fused_v2_packed"}[kernel]

        def port(rows, u, up, t1, t0):
            return getattr(pk, name)(rows, u, t1, t0, dtype=tdt)

        def ref(rows, u, up, t1, t0):
            return getattr(ref_pk, name)(rows, u, t1, t0, **tiles(rows))
    return port, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["K5", "K6", "K7", "K8"])
def test_batched_twin_matches_vmapped_reference(kernel, dtype):
    """Each kernel with a leading R on every per-replicate input against
    jax.vmap of the reference's kernel, and each replicate bitwise the
    port's single call; one twin call for all R."""
    arrays = _pass_inputs(seed=len(kernel) + len(dtype))
    port, ref = _ports(kernel, dtype)
    fn = {"K8": pk.lambda_stats_acat, "K5": pk.gamma_stats_packed,
          "K6": pk.batch_stats_fused_packed,
          "K7": pk.batch_stats_fused_v2_packed}[kernel]
    t = [torch.from_numpy(a) for a in arrays]
    before = fn.twin_calls
    got = port(*t)
    assert fn.twin_calls == before + 1
    want = jax.vmap(ref)(*(jnp.asarray(a) for a in arrays))
    assert all(g.shape[0] == R for g in got)
    _close(got, want, TOL if dtype == "float32" else PASS_TOL)
    _singles_bitwise(got, [port(*(a[i] for a in t)) for i in range(R)])


def test_batched_kernels_refuse_a_mix_and_k_above_64():
    """Every per-replicate input takes the leading R, or none does. R > 1
    at K > 64, which raised before the K-chunked bodies took the
    replicate axis (the name is kept from then), now runs: each
    replicate bitwise its single call."""
    rows, u, up, t1, t0 = (torch.from_numpy(a) for a in _pass_inputs())
    with pytest.raises(ValueError, match="leading R"):
        pk.gamma_stats_packed(rows, up[0], t1, t0)
    with pytest.raises(ValueError, match="leading R"):
        pk.batch_stats_fused_v2_packed(rows, u, t1[0], t0)
    a1, a0 = pk.decode_count_planes(rows)
    assert a1.shape == (R, 24, 4, 256)
    with pytest.raises(ValueError, match="leading R"):
        pk.lambda_stats_acat(a1, a0, up[0], t1[0], t0[0])
    wide = [torch.from_numpy(a) for a in _pass_inputs(b=8, n=512, k=72)]
    for kernel in ("K5", "K6", "K7", "K8"):
        port, _ = _ports(kernel, "float32")
        _singles_bitwise(port(*wide), [port(*(a[i] for a in wide))
                                       for i in range(R)])


# --- the batched step against the reference's vmapped step ------------------
def _step_inputs(b, seeds, codes=(4, 4), n=N, k=K):
    """Replicate r's packed rows (B, n/4) (genotype codes below codes[r]:
    4 draws MISSING entries, 3 none) and gamma (n, k), from seeds[r]."""
    rows, gammas = [], []
    for seed, c in zip(seeds, codes):
        rng = np.random.default_rng(seed)
        rows.append(pack2bit(rng.integers(0, c, size=(b, n)).astype(np.int8)))
        gammas.append(rng.uniform(0.05, 30.0, size=(n, k)).astype(np.float32))
    return np.stack(rows), np.stack(gammas)


def _steps(cfg, rows, gamma, seeds):
    """(port, reference) step_core_packed results for R replicates, each
    with the column subsample its own key draws: the port batched with
    idx_w (R, sub_w), the reference vmapped over (gamma, rows, key). cfg
    is the reference's SVIConfig, which the port's step reads as its own
    (tests/test_torch_bign_step.py)."""
    keys = [jax.random.PRNGKey(s) for s in seeds]
    wp = rows.shape[-1]
    sub_w = (cfg.local_sub_n // 4 // 128) * 128
    idx_w = np.stack([np.asarray(jax.random.choice(k, wp, (sub_w,),
                                                   replace=False))
                      for k in keys])
    b = rows.shape[1]
    got = engine.step_core_packed(cfg, torch.from_numpy(gamma),
                                  torch.from_numpy(rows),
                                  idx_w=torch.from_numpy(idx_w))
    lamb = jnp.stack([jnp.full((R, b, cfg.k), cfg.beta_a, jnp.float32),
                      jnp.full((R, b, cfg.k), cfg.beta_b, jnp.float32)], -1)
    want = jax.vmap(lambda g, r_, l_, k_: ref_engine.step_core_packed(
        cfg, g, r_, l_, interpret=True, key=k_))(
        jnp.asarray(gamma), jnp.asarray(rows), lamb, jnp.stack(keys))
    return got, want, idx_w


def _single_steps(cfg, rows, gamma, idx_w):
    return [engine.step_core_packed(cfg, torch.from_numpy(gamma[i]),
                                    torch.from_numpy(rows[i]),
                                    idx_w=torch.from_numpy(idx_w[i]))
            for i in range(R)]


@pytest.mark.parametrize("decode_once", [True, False])
@pytest.mark.parametrize("stats_kernel", ["fused_v2", "pair", "fused"])
def test_batched_step_matches_vmapped_reference(stats_kernel, decode_once):
    """The batched big-N step, each replicate's subsample from its own
    key, against jax.vmap of the reference's step (its Pallas kernels in
    interpret mode), to the single step's tolerance; each replicate
    bitwise the port's single step; the solve's kernel ran once a pass
    for both replicates."""
    cfg = RefConfig(n=N, l=100, k=K, batch_size=16, local_sub_n=512,
                    local_accel=False, local_sub_approx_div=False,
                    stats_kernel=stats_kernel, sub_decode_once=decode_once)
    seeds = (21 + decode_once, 31)
    rows, gamma = _step_inputs(16, seeds)
    solve = pk.lambda_stats_acat if decode_once else pk.lambda_stats_packed
    before = solve.twin_calls
    got, want, idx_w = _steps(cfg, rows, gamma, seeds)
    pair_k4 = not decode_once and stats_kernel == "pair"   # K4 of the pair
    assert solve.twin_calls - before == cfg.local_iters + pair_k4
    assert got[0].shape == (R, 16, K, 2) and got[1].shape == (R, N, K)
    _close(got, want, STEP_TOL)
    _singles_bitwise(got, _single_steps(cfg, rows, gamma, idx_w))


def test_batched_step_bf16_matches_vmapped_reference():
    """The same at compute dtype bf16 (the bf16 twins of K8 and K7), to
    the bf16 step's tolerance."""
    cfg = RefConfig(n=N, l=100, k=K, batch_size=16, local_sub_n=512,
                    local_accel=False, local_sub_approx_div=False,
                    compute_dtype="bfloat16")
    seeds = (41, 42)
    rows, gamma = _step_inputs(16, seeds)
    got, want, idx_w = _steps(cfg, rows, gamma, seeds)
    _close(got, want, SOLVE_TOL)
    _singles_bitwise(got, _single_steps(cfg, rows, gamma, idx_w))


def test_batched_step_tol_exit_at_b12_one_replicate_first(monkeypatch):
    """B = 12, where the reference pads 4 all-MISSING rows that its tol
    test counts (tests/test_torch_bign_step.py's case): replicate 0 exits
    the loop after its first pass, replicate 1 (no MISSING genotypes, so
    larger statistics) after its second. Under jax.vmap the reference's
    while_loop runs until both have exited and keeps replicate 0's
    lambda; the port's schedule freezes replicate 0 the same way. The
    loop-pass count is one a replicate; each replicate bitwise its single
    step; both within the step tolerance of the vmapped reference."""
    b = 12
    cfg = RefConfig(n=N, l=100, k=K, batch_size=b, local_sub_n=512,
                    local_accel=False, local_sub_approx_div=False,
                    beta_a=2.0, beta_b=0.5, local_tol=400.0, local_iters=3)
    assert engine.batch_pad_rows(b) == 4
    seeds = (12, 13)
    rows, gamma = _step_inputs(b, seeds, codes=(4, 3))
    counts = []
    monkeypatch.setattr(pk.local_solve_acat, "loop_passes", counts)
    got, want, idx_w = _steps(cfg, rows, gamma, seeds)
    assert [int(c) for c in counts] == [1, 2]
    _close(got, want, STEP_TOL)
    _singles_bitwise(got, _single_steps(cfg, rows, gamma, idx_w))
    assert [int(c) for c in counts[2:]] == [1, 2]   # the single solves


# --- the batched replicate step and fit against single ones -----------------
L_BIG = 65_536 + 64     # biobank L: the stored mode draws groups of 8


@pytest.fixture(scope="module")
def big_packed():
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, 256, size=(L_BIG, N // 4),
                                         dtype=np.uint8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["local", "stored"])
@pytest.mark.parametrize("decode_once", [True, False])
@pytest.mark.parametrize("stats_kernel", ["fused_v2", "pair", "fused"])
def test_replicate_step_is_the_single_steps(big_packed, stats_kernel,
                                            decode_once, mode, dtype):
    """engine.make_replicate_step takes the big-N path for every
    stats_kernel and sub_decode_once, in both lambda modes, at both
    compute dtypes: two batched steps leave each replicate's gamma and
    lambda bitwise two single steps' (dma_gather=False). The stored
    mode draws groups of snp_group = 8 rows and scatters each
    replicate's lambda rows in place."""
    cfg = SVIConfig(n=N, l=L_BIG, k=K, batch_size=16, local_sub_n=512,
                    kernel="pallas", stats_kernel=stats_kernel,
                    sub_decode_once=decode_once, lambda_mode=mode,
                    snp_group=8, compute_dtype=dtype)
    assert engine._group_size(cfg, L_BIG) == 8
    seeds = (5, 6)
    state = engine.init_replicate_state(cfg, seeds)
    step = engine.make_replicate_step(cfg, L_BIG)
    for _ in range(2):
        state = step(state, big_packed)
    one = engine.make_step(cfg.replace(dma_gather=False), L_BIG)
    for i, s in enumerate(seeds):
        st = engine.init_state(cfg.replace(seed=s))
        for _ in range(2):
            st = one(st, big_packed)
        assert torch.equal(state.gamma[i], st.gamma)
        assert torch.equal(state.lamb[i], st.lamb)
    moved = (state.lamb[..., 0] != cfg.beta_a).any(-1).sum(-1)
    assert moved.tolist() == ([0, 0] if mode == "local" else [32, 32])


def _shared_eval_subsample(monkeypatch, seed):
    """Score every fit with the local mode's eval subsample of `seed`: the
    batched scorer draws one for all replicates from cfg.seed (the
    reference's rule, svi/replicates.py), a single fit from its own."""
    orig = engine.make_entry_loglik_recompute
    monkeypatch.setattr(engine, "make_entry_loglik_recompute",
                        lambda cfg, *a, **kw: orig(cfg.replace(seed=seed),
                                                   *a, **kw))


@pytest.mark.parametrize("mode", ["local", "stored"])
def test_batched_pallas_fit_is_the_single_fits(mode, monkeypatch):
    """A kernel="pallas" batched fit, the column subsample engaged (N =
    2,048, local_sub_n = 512), against a single fit per seed: stop steps,
    gamma (and in the stored mode lambda) and every score bitwise. The
    local mode runs to convergence, the replicates stopping at steps of
    their own; its eval re-solve engages the subsample, so both sides
    score with the batched scorer's (cfg.seed's)."""
    n, l, k = 2048, 1024, 3
    _, _, x = simulate_psd(n, l, k, seed=21)
    data = GenotypeData.from_dense(x, validation_frac=0.01,
                                   heldout_frac=0.01, seed=21)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=16, rfreq=20, local_sub_n=512,
                    seed=3, kernel="pallas", lambda_mode=mode,
                    **(dict(max_steps=400, conv_tol=1e-3) if mode == "local"
                       else dict(max_steps=60, conv_tol=-1e9)))
    _shared_eval_subsample(monkeypatch, cfg.seed)
    seeds = [3, 4]
    res = fit_replicates_batched(cfg, data, seeds, device="cpu")
    steps = [rr.steps for rr in res.replicates]
    if mode == "local":
        assert all(rr.converged for rr in res.replicates)
        assert steps[0] != steps[1]
    for i, s in enumerate(seeds):
        single = fit(cfg.replace(seed=s, dma_gather=False), data,
                     device="cpu")
        rr = res.replicates[i]
        assert (rr.converged, rr.steps) == (single.converged, single.steps)
        assert torch.equal(res.states.gamma[i], single.state.gamma)
        if mode == "stored":
            assert torch.equal(res.states.lamb[i], single.state.lamb)
        assert rr.validation_ll == single.validation_ll
        assert rr.heldout_ll == single.heldout_ll


def test_cli_batched_replicates_on_the_big_n_path(tmp_path):
    """`fit --replicates 2 --batched --kernel pallas` through cli.main on
    the CPU: the big-N step (its K7 twin) runs, and best.json names a
    replicate with a finite heldout."""
    stem = str(tmp_path / "toy")
    cli.main(["simulate", "-n", "24", "-l", "60", "-k", "2", "--seed", "5",
              "-o", stem])
    before = pk.batch_stats_fused_v2_packed.twin_calls
    cli.main(["fit", "--bed", stem + ".bed", "-k", "2", "--replicates", "2",
              "--batched", "--kernel", "pallas", "--batch-size", "16",
              "--rfreq", "50", "--max-steps", "100", "--label", "reps",
              "--out-base", str(tmp_path), "--seed", "7", "--force-cpu"])
    assert pk.batch_stats_fused_v2_packed.twin_calls - before >= 100
    run_dir = tmp_path / "n24-k2-l60-reps"
    best = json.loads((run_dir / "best.json").read_text())
    assert best["dir"] in ("replicate-s7", "replicate-s8")
    assert np.isfinite(best["heldout_ll"])
    assert (run_dir / best["dir"] / "theta.txt").exists()
