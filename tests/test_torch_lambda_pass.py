"""The lambda and gamma passes' grids, the twins at K above the widest instantiated
K-width, and the lambda re-solve and a dense fit at bf16 (CPU).

K = 72 is above the widest instantiated K-width (64): on CPU tensors the
wrappers run their twins, which take any K, and match the reference's
kernels in interpret mode. On CUDA tensors they launch the K > 64
("wide") bodies, held to the twins in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terastructure_tpu.config import SVIConfig
from terastructure_tpu.data import GenotypeData as RefData
from terastructure_tpu.data import simulate_psd
from terastructure_tpu.data.pack import pack2bit
from terastructure_tpu.ops import fused_step as ref_fused
from terastructure_tpu.ops import stats_dense as ref_ops
from terastructure_tpu.ops import stats_pallas as ref_pk
from terastructure_tpu.models import psd as ref_psd
from terastructure_tpu.svi import engine as ref_engine
from terastructure_tpu.svi import fit as ref_fit
from terastructure_tpu.svi import postprocess as ref_post
from terastructure_tpu.utils.labels import mean_abs_theta_error
from terastructure_tpu_torch.data import GenotypeData
from terastructure_tpu_torch.models import psd
from terastructure_tpu_torch.ops import fused_step, stats_packed
from terastructure_tpu_torch.svi import engine, fit, postprocess

TOL = dict(rtol=2e-4, atol=2e-4)    # f32, the two packages' sum orders
K_WIDE = 72
# the K <= 64 body's split (K > 64: tests/test_torch_lambda_wide.py)
K_NARROW = 8


# --- the grid -----------------------------------------------------------
PATH_SHAPES = [(1024, 640), (4096, 640), (256, 256), (4096, 2048), (33, 235)]


@pytest.mark.parametrize("b,w", PATH_SHAPES)
def test_lambda_grid_covers_w_in_16_byte_chunks(b, w):
    nsplit, chunk = stats_packed.lambda_grid(b, w, K_NARROW)
    assert chunk % 16 == 0 and 16 <= chunk <= 128
    assert nsplit * chunk >= w               # the splits cover W ...
    assert (nsplit - 1) * chunk < w          # ... and none is empty
    # what the kernels derive from nsplit (tt::split_chunk)
    assert chunk == -(-(-(-w // nsplit)) // 16) * 16


@pytest.mark.parametrize("b,w", PATH_SHAPES)
def test_lambda_grid_is_a_function_of_the_shape_only(b, w):
    first = stats_packed.lambda_grid(b, w, K_NARROW)
    torch.manual_seed(b)                     # no hidden state enters
    stats_packed.lambda_stats_packed.launches += 1
    assert stats_packed.lambda_grid(b, w, K_NARROW) == first
    stats_packed.lambda_stats_packed.launches -= 1
    # the rows of a ragged last warp change nothing, nor K up to 64
    assert stats_packed.lambda_grid(32 * (-(-b // 32)), w, K_NARROW) == first
    assert stats_packed.lambda_grid(b, w, 64) == first


def test_lambda_grid_fills_the_card_at_config3():
    nsplit, _ = stats_packed.lambda_grid(1024, 640, K_NARROW)
    assert (1024 // stats_packed.LAMBDA_ROWS) * nsplit >= 2 * 132
    # and a bigger batch takes wider chunks, not more partial sums
    assert (stats_packed.lambda_grid(4096, 640, K_NARROW)[1]
            > stats_packed.lambda_grid(1024, 640, K_NARROW)[1])


@pytest.mark.parametrize("b,w", PATH_SHAPES)
def test_gamma_grid_keeps_four_ctas_an_sm_and_32_row_slices(b, w):
    nsplit = stats_packed.gamma_grid(b, w, 8)
    ncol = -(-w // stats_packed.GAMMA_COLS)
    assert 1 <= nsplit <= -(-b // 32)        # no slice under 32 rows ...
    assert nsplit == 1 or ncol * nsplit <= 4 * stats_packed.SM_COUNT
    torch.manual_seed(w)                     # ... and no hidden state
    assert stats_packed.gamma_grid(b, w, 8) == nsplit
    # the wide body (K > 64) keeps its own split, of whole 64-row tiles
    assert stats_packed.gamma_grid(b, w, 72) <= -(-b // 64)


def test_gamma_grid_fills_the_card_at_the_main_path_shapes():
    # K1 at the TGP shape and K2 at config #3: 20 column tiles, 26 slices
    for b in (4096, 1024):
        nsplit = stats_packed.gamma_grid(b, 640, 8)
        assert 20 * nsplit > 3 * stats_packed.SM_COUNT


# --- the grids of the bf16 tensor-core bodies (K <= 64) -------------------
BF16 = torch.bfloat16
# the paths' shapes, the big-N step's (and its padded tol batch) and a
# batch of 200 rows of 235 bytes (the card tests' long walks)
GRID_SHAPES = PATH_SHAPES + [(4096, 25_088), (4092, 25_088), (200, 235)]
GRID_KS = [1, 8, 10, 16, 17, 33, 64]
# lambda_grid and gamma_grid at f32 (K = 8) and at K > 64 (K = 72, both
# dtypes) as they were before the bf16 branches: (nsplit, chunk), nsplit
EARLIER_GRIDS = {
    8: {(1024, 640): ((40, 16), 26), (4096, 640): ((20, 32), 26),
        (256, 256): ((16, 16), 8), (4096, 2048): ((19, 112), 8),
        (33, 235): ((15, 16), 2), (4096, 25_088): ((196, 128), 1),
        (4092, 25_088): ((196, 128), 1), (200, 235): ((15, 16), 7)},
    72: {(1024, 640): ((8, 80), 16), (4096, 640): ((4, 160), 13),
         (256, 256): ((8, 32), 4), (4096, 2048): ((8, 256), 1),
         (33, 235): ((8, 32), 1), (4096, 25_088): ((98, 256), 1),
         (4092, 25_088): ((98, 256), 1), (200, 235): ((8, 32), 4)},
}


@pytest.mark.parametrize("k", GRID_KS)
@pytest.mark.parametrize("b,w", GRID_SHAPES)
def test_bf16_lambda_grid_covers_w_with_no_empty_cta(b, w, k):
    nsplit, chunk = stats_packed.lambda_grid(b, w, k, BF16)
    assert chunk % 16 == 0 and chunk >= 16
    assert nsplit * chunk >= w               # the splits cover W ...
    assert (nsplit - 1) * chunk < w          # ... and none is empty
    assert chunk == -(-(-(-w // nsplit)) // 16) * 16   # tt::split_chunk
    # the launch's grid (row tiles, nsplit, R) within the CUDA limits
    assert 1 <= nsplit <= 65_535
    assert -(-b // stats_packed.LAMBDA_ROWS) < 2 ** 31


@pytest.mark.parametrize("k", GRID_KS)
@pytest.mark.parametrize("b,w", GRID_SHAPES)
def test_bf16_gamma_grid_covers_b_with_no_empty_slice(b, w, k):
    nsplit = stats_packed.gamma_grid(b, w, k, BF16)
    bchunk = -(-b // nsplit)                 # the kernels' slice
    assert 1 <= nsplit <= 65_535             # grid (column tiles, nsplit, R)
    assert nsplit * bchunk >= b and (nsplit - 1) * bchunk < b
    assert -(-w // stats_packed.GAMMA_COLS) < 2 ** 31


@pytest.mark.parametrize("b,w", GRID_SHAPES)
def test_bf16_grids_are_functions_of_the_shape_and_dtype_only(b, w):
    first = [(stats_packed.lambda_grid(b, w, k, BF16),
              stats_packed.gamma_grid(b, w, k, BF16)) for k in GRID_KS]
    torch.manual_seed(b)                     # no hidden state enters
    stats_packed.lambda_stats_packed.bf16_launches += 1
    stats_packed.gamma_stats_packed.bf16_launches += 1
    again = [(stats_packed.lambda_grid(b, w, k, BF16),
              stats_packed.gamma_grid(b, w, k, BF16)) for k in GRID_KS]
    stats_packed.lambda_stats_packed.bf16_launches -= 1
    stats_packed.gamma_stats_packed.bf16_launches -= 1
    assert again == first


@pytest.mark.parametrize("k", sorted(EARLIER_GRIDS))
@pytest.mark.parametrize("b,w", GRID_SHAPES)
def test_f32_and_wide_grids_are_the_earlier_ones(b, w, k):
    want = EARLIER_GRIDS[k][(b, w)]
    dtypes = [torch.float32] + ([BF16] if k > 64 else [])
    for dtype in dtypes:
        assert (stats_packed.lambda_grid(b, w, k, dtype),
                stats_packed.gamma_grid(b, w, k, dtype)) == want
    assert (stats_packed.lambda_grid(b, w, k),
            stats_packed.gamma_grid(b, w, k)) == want


def _pick_km(k, km12):
    """The K-width a K <= 64 body runs at (csrc tt::pick_km): the γ pass
    also instantiates 12."""
    if km12 and 8 < k <= 12:
        return 12
    return next(km for km in (4, 8, 16, 32, 64) if k <= km)


@pytest.mark.parametrize("k", range(1, 65))
def test_mma_kp_is_the_bodies_padded_k(k):
    # the bodies' KP: 16 x the k16 steps of D for KN = ceil(KM / 8) n8
    # tiles, at the λ pass's K-widths and the γ pass's
    for km12 in (False, True):
        kn = -(-_pick_km(k, km12) // 8)
        assert stats_packed.mma_kp(k) == 16 * ((kn + 1) // 2)


def test_rounded_scratch_only_at_bf16_and_k_up_to_64():
    cpu = torch.device("cpu")
    assert stats_packed.rounded_scratch((), 40, 8, cpu, torch.float32) is None
    assert stats_packed.rounded_scratch((3,), 40, 72, cpu, BF16) is None
    x = stats_packed.rounded_scratch((3,), 40, 17, cpu, BF16)
    assert x.shape == (3, 40, 32) and x.dtype == BF16
    assert stats_packed.rounded_scratch((), 40, 64, cpu, BF16).shape == (40,
                                                                         64)


# --- K above the CUDA kernels' limit, on the CPU ---------------------------
def _problem(b=16, n=512, k=K_WIDE, seed=0):
    rng = np.random.default_rng(seed)
    rows = pack2bit(rng.integers(0, 4, size=(b, n)).astype(np.int8))
    gamma = rng.uniform(0.3, 3.0, size=(n, k)).astype(np.float32)
    u = np.asarray(ref_ops.exp_elog_theta(jnp.asarray(gamma)))
    up = np.array(ref_pk.u_to_planes(jnp.asarray(u)))
    lamb = rng.uniform(0.5, 3.0, size=(b, k, 2)).astype(np.float32)
    return rows, up, lamb


K_ANY = 256     # a K whose wide bodies stage D's operands in 8 pieces


@pytest.mark.parametrize("name", ["lambda_stats_packed", "lambda_stats_acat",
                                  "gamma_stats_packed",
                                  "batch_stats_fused_v2_packed",
                                  "batch_stats_fused_packed"])
def test_twins_take_k256_as_the_reference_kernels(name):
    """K = 256: the twins the card's wide bodies are held to (at this K in
    tests/test_torch_cuda.py) against the reference's kernels in interpret
    mode, to this file's tolerance."""
    rows, up, lamb = _problem(b=16, n=1024, k=K_ANY, seed=256)
    t1, t0 = (np.array(t) for t in ref_ops.exp_elog_beta(jnp.asarray(lamb)))
    u = np.array(ref_pk.planes_to_flat(jnp.asarray(up)))
    tb, tw = ref_pk.pick_tiles(*rows.shape)
    kw = dict(tb=tb, tw=tw, dtype=jnp.float32, interpret=True)
    fn = getattr(stats_packed, name)
    before = fn.twin_calls
    if name == "lambda_stats_acat":
        a1, a0 = stats_packed.decode_count_planes(torch.from_numpy(rows))
        got = fn(a1, a0, *map(torch.from_numpy, (up, t1, t0)))
        want = ref_pk.lambda_stats_acat(
            *ref_pk.decode_count_planes(jnp.asarray(rows)), up, t1, t0, **kw)
    else:
        x = u if name.startswith("batch") else up
        got = fn(*map(torch.from_numpy, (rows, x, t1, t0)))
        want = getattr(ref_pk, name)(rows, x, t1, t0, **kw)
    assert fn.twin_calls == before + 1
    if name == "gamma_stats_packed":
        got, want = [got], [want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_lambda_stats_twin_takes_k72():
    rows, up, lamb = _problem(b=24, n=1024, seed=6)
    t1, t0 = (np.array(t) for t in ref_ops.exp_elog_beta(jnp.asarray(lamb)))
    before = stats_packed.lambda_stats_packed.twin_calls
    got = stats_packed.lambda_stats_packed(
        torch.from_numpy(rows), torch.from_numpy(up), torch.from_numpy(t1),
        torch.from_numpy(t0))
    assert stats_packed.lambda_stats_packed.twin_calls == before + 1
    tb, tw = ref_pk.pick_tiles(*rows.shape)
    want = ref_pk.lambda_stats_packed(
        jnp.asarray(rows), jnp.asarray(up), jnp.asarray(t1), jnp.asarray(t0),
        tb=tb, tw=tw, dtype=jnp.float32, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_fused_twin_takes_k72():
    rows, up, lamb = _problem(seed=1)
    kw = dict(local_iters=5, local_tol=-1.0, beta_a=1.0, beta_b=1.0)
    before = fused_step.fused_local_solve.twin_calls
    got = fused_step.fused_local_solve(torch.from_numpy(rows),
                                       torch.from_numpy(up),
                                       torch.from_numpy(lamb), **kw)
    assert fused_step.fused_local_solve.twin_calls == before + 1
    want = ref_fused.fused_local_solve(
        jnp.asarray(rows), jnp.asarray(up), jnp.asarray(lamb),
        dtype=jnp.float32, interpret=True, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_group_dma_twin_takes_k72():
    b, n, l, g = 32, 512, 128, 8
    packed, up, _ = _problem(b=l, n=n, seed=2)
    rng = np.random.default_rng(3)
    idx0 = (rng.integers(0, l // g, size=b // g) * g).astype(np.int32)
    lamb = rng.uniform(0.5, 3.0, size=(b, K_WIDE, 2)).astype(np.float32)
    kw = dict(local_iters=4, local_tol=-1.0, beta_a=1.0, beta_b=1.0,
              warm_start=True)
    before = fused_step.fused_local_solve_dma.twin_calls
    got = fused_step.fused_local_solve_dma(
        torch.from_numpy(idx0), torch.from_numpy(packed),
        torch.from_numpy(up), torch.from_numpy(lamb), group=g, **kw)
    assert fused_step.fused_local_solve_dma.twin_calls == before + 1
    want = ref_fused.fused_local_solve_dma(
        jnp.asarray(idx0), jnp.asarray(packed), jnp.asarray(up),
        jnp.asarray(lamb), group=g, dtype=jnp.float32, interpret=True, **kw)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


def test_step_at_k72_matches_reference_with_injected_indices():
    n, l, k, b, t = 96, 300, K_WIDE, 32, 4
    _, _, x = simulate_psd(n, l, 3, seed=5)
    data = RefData.from_dense(x, validation_frac=0.02, heldout_frac=0.02,
                              seed=5)
    packed = engine.pad_width(data.packed)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=b, seed=5, local_accel=False,
                    local_iters=6)
    s0 = ref_engine.init_state(cfg)._replace(t=jnp.int32(t))
    idx = np.random.default_rng(t).choice(l, b, replace=False)
    rows = packed[idx]

    u = ref_ops.exp_elog_theta(s0.gamma)
    u = jnp.pad(u, ((0, 4 * packed.shape[1] - n), (0, 0)),
                constant_values=1.0)
    _, g = ref_fused.fused_local_solve(
        jnp.asarray(rows), ref_pk.u_to_planes(u),
        jnp.zeros((b, k, 2), jnp.float32), local_iters=cfg.local_iters,
        local_tol=cfg.local_tol, beta_a=1.0, beta_b=1.0, dtype=jnp.float32,
        interpret=True, accel=False)
    stat = (u * ref_pk.planes_to_flat(g))[:n]
    want = ref_engine._global_update(cfg, s0.gamma, stat, s0.t, l)

    st = engine.state_from_reference(s0.gamma, s0.lamb, s0.t, cfg.seed)
    _, got_stat = engine.step_core_fused(cfg, st.gamma, torch.from_numpy(rows))
    got = engine._global_update(cfg, st.gamma, got_stat, st.t, l)
    np.testing.assert_allclose(got_stat.numpy(), np.asarray(stat), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --- the lambda re-solve and a dense fit at bf16 --------------------------
def test_compute_lambda_refuses_bfloat16():
    """The lambda re-solve at compute_dtype="bfloat16" (the test keeps the
    name of the refusal this slice lifted): solve_lambda_blocks,
    compute_lambda and compute_beta run K4's bf16 twin and match the
    reference's re-solve at bf16 (its dense path on the CPU), to 2e-3
    with 1% of lambda's entries allowed past it (the accel tail)."""
    n, l, k = 96, 1500, 3           # two blocks of 1024, the last padded
    _, _, x = simulate_psd(n, l, k, seed=6)
    packed = engine.pad_width(RefData.from_dense(x, seed=6).packed)
    cfg = SVIConfig(n=n, l=l, k=k, compute_dtype="bfloat16")
    gamma = np.random.default_rng(6).uniform(0.3, 3.0, (n, k)).astype(
        np.float32)
    want = np.asarray(ref_post.compute_lambda(cfg, jnp.asarray(gamma),
                                              packed))
    before = stats_packed.lambda_stats_packed.twin_calls
    got = postprocess.compute_lambda(cfg, torch.from_numpy(gamma),
                                     torch.from_numpy(packed)).numpy()
    assert stats_packed.lambda_stats_packed.twin_calls > before
    assert got.shape == want.shape == (l, k, 2)
    assert (np.abs(got - want) > 2e-3 * (1.0 + np.abs(want))).mean() <= 1e-2
    beta = postprocess.compute_beta(cfg, torch.from_numpy(gamma),
                                    torch.from_numpy(packed))
    want_beta = np.asarray(ref_post.compute_beta(cfg, jnp.asarray(gamma),
                                                 packed))
    assert (np.abs(beta - want_beta) > 2e-3).mean() <= 1e-2


def test_dense_bfloat16_fit_fails_at_its_first_check():
    """A dense fit at compute_dtype="bfloat16" (the test keeps the name of
    the refusal this slice lifted) runs to its end with the eval
    re-solve at bf16, and matches the reference's dense bf16 fit on the
    same split as tests/test_torch_fit.py holds two fits: scores finite,
    heldout within 0.05 nats, theta MAE within 0.03."""
    n, l, k = 64, 256, 2
    theta_true, _, x = simulate_psd(n, l, k, seed=2)
    split = dict(validation_frac=0.02, heldout_frac=0.02, seed=2)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=32, rfreq=100, max_steps=300,
                    seed=2, kernel="dense", compute_dtype="bfloat16")
    ref = ref_fit(cfg, RefData.from_dense(x, **split))
    res = fit(cfg, GenotypeData.from_dense(x, **split), device="cpu")
    assert res.steps == ref.steps == 300
    for r in (res, ref):
        assert np.isfinite(r.validation_ll) and np.isfinite(r.heldout_ll)
    assert abs(res.heldout_ll - ref.heldout_ll) < 0.05
    mae = mean_abs_theta_error(psd.theta_mean(res.state.gamma).numpy(),
                               theta_true)
    ref_mae = mean_abs_theta_error(
        np.asarray(ref_psd.theta_mean(ref.state.gamma)), theta_true)
    assert abs(mae - ref_mae) < 0.03, (mae, ref_mae)


def test_bf16_heldout_gap_is_the_references():
    """The bf16-minus-f32 heldout gap after 300 dense steps, in the port
    and in the reference, over four seeds of the shape above: the port's
    mean gap lies within three standard errors of the reference's (the
    seeds' spread, both packages' fits being independent draws of their
    own minibatches). At this shape both gaps are ~1e-4 nats, far below
    the spread of the f32 fits themselves; a port whose bf16 fit lagged
    where the reference's does not would show here."""
    n, l, k = 64, 256, 2
    gaps = {"port": [], "ref": []}
    for seed in range(2, 6):
        _, _, x = simulate_psd(n, l, k, seed=seed)
        split = dict(validation_frac=0.02, heldout_frac=0.02, seed=seed)
        ll = {}
        for dtype in ("float32", "bfloat16"):
            cfg = SVIConfig(n=n, l=l, k=k, batch_size=32, rfreq=300,
                            max_steps=300, seed=seed, kernel="dense",
                            compute_dtype=dtype)
            ll["ref", dtype] = ref_fit(
                cfg, RefData.from_dense(x, **split)).heldout_ll
            ll["port", dtype] = fit(cfg, GenotypeData.from_dense(x, **split),
                                    device="cpu").heldout_ll
        for side in gaps:
            gaps[side].append(ll[side, "bfloat16"] - ll[side, "float32"])
    port, ref = np.array(gaps["port"]), np.array(gaps["ref"])
    se = np.sqrt(port.var(ddof=1) / port.size + ref.var(ddof=1) / ref.size)
    assert np.isfinite(port).all() and np.isfinite(ref).all()
    assert abs(port.mean() - ref.mean()) <= 3 * se, (gaps, se)
