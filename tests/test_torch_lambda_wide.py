"""The λ pass at K > 64 (CPU): the column split its launch takes
(`lambda_grid`'s K > 64 branch) and the K4 and K8 twins against the
reference's `lambda_stats_packed` and `lambda_stats_acat` in interpret
mode at K = 65, 128 and 129, where the card's body
(`lambda_pass_wide_kernel`, csrc/lambda_wide.cuh) takes K as one piece of
80 columns, one of 128, and two of 80, and the reference's K axis fills
one 128-lane tile and then takes a second. The card's body is held to the
twins by tests/test_torch_cuda.py (`-k wide`) and chip_smoke.py.

Tolerances, as tests/test_torch_k7_wide.py states them for one pass: f32
rtol 2e-5 / atol 1e-5, bf16 rtol 1e-3 / atol 1e-6 (the twin and the
reference sum in other orders), the fast divide rtol / atol 5e-3."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terastructure_tpu.data.pack import pack2bit
from terastructure_tpu.ops import stats_dense as ref_ops
from terastructure_tpu.ops import stats_pallas as ref_pk
from terastructure_tpu_torch.ops import stats_packed as pk

PASS_TOL = {"float32": dict(rtol=2e-5, atol=1e-5),
            "bfloat16": dict(rtol=1e-3, atol=1e-6)}
APPROX_TOL = dict(rtol=5e-3, atol=5e-3)

# B, W at which the paths run the λ pass at K > 64: K1 and K4 at config
# #3's width, K8 on the big-N step's subsample (and B = 4,092, the padded
# tol test's), the K = 256 timed shape, config #1's step (phase 2c), a
# ragged B with an odd W, and K4's export block at N = 1M
WIDE_SHAPES = [(1024, 640), (4096, 2048), (4092, 2048), (1024, 2048),
               (256, 256), (40, 235), (33, 20), (4096, 250_112)]


@pytest.mark.parametrize("k", [65, 72, 256, 1000])
@pytest.mark.parametrize("b,w", WIDE_SHAPES)
def test_wide_lambda_grid_covers_w_in_16_byte_chunks(b, w, k):
    """K > 64: chunks of 32 to 256 byte columns (2 to 16 sub-tiles of 16),
    covering W, none empty, the chunk the kernels derive from nsplit."""
    nsplit, chunk = pk.lambda_grid(b, w, k)
    assert chunk % pk.LAMBDA_WIDE_COLS == 0
    assert 2 * pk.LAMBDA_WIDE_COLS <= chunk <= 256
    assert nsplit * chunk >= w and (nsplit - 1) * chunk < w
    assert chunk == -(-(-(-w // nsplit)) // 16) * 16   # tt::split_chunk
    assert 1 <= nsplit <= 65_535


@pytest.mark.parametrize("b,w", WIDE_SHAPES)
def test_wide_lambda_grid_is_a_function_of_the_shape_only(b, w):
    """The same split at every K > 64 (the body takes K in pieces, not the
    grid), whatever ran before, and for the rows of a ragged row tile; at
    K <= 64 the split of the K <= 64 body."""
    first = pk.lambda_grid(b, w, 65)
    torch.manual_seed(w)
    pk.lambda_stats_acat.launches += 1
    for k in (72, 128, 129, 256, 1000):
        assert pk.lambda_grid(b, w, k) == first
    pk.lambda_stats_acat.launches -= 1
    assert pk.lambda_grid(64 * -(-b // 64), w, 72) == first
    assert pk.lambda_grid(b, w, 64) == pk.lambda_grid(b, w, 8)


@pytest.mark.parametrize("b,w,k", [(4096, 2048, 72), (1024, 640, 72),
                                   (1024, 2048, 256)])
def test_wide_lambda_grid_leaves_enough_ctas(b, w, k):
    """At K8 wide's shape (the big-N step's subsample), config #3's width
    (K1 and K4) and the K = 256 timed shape: at least a wave of CTAs of 8
    warps on the card's SMs, their last wave at least 95% full, each CTA
    walking at least two sub-tiles, and no more splits than the card has
    SMs (the partial sums the reductions read stay few)."""
    nsplit, chunk = pk.lambda_grid(b, w, k)
    ctas = -(-b // pk.LAMBDA_ROWS) * nsplit
    waves = -(-ctas // pk.SM_COUNT)
    assert ctas >= 0.95 * pk.SM_COUNT
    assert ctas >= 0.95 * waves * pk.SM_COUNT
    assert chunk >= 2 * pk.LAMBDA_WIDE_COLS
    assert nsplit <= pk.SM_COUNT


def _inputs(k, b=16, n=512, seed=0):
    """Packed rows (B, N/4) with two rows MISSING, u planes (4, N/4, K),
    t1 and t0 (B, K) from a random lambda (numpy)."""
    rng = np.random.default_rng(seed)
    rows = pack2bit(rng.integers(0, 4, size=(b, n)).astype(np.int8))
    rows[[3, b - 1]] = 0xFF
    gamma = rng.uniform(0.3, 3.0, size=(n, k)).astype(np.float32)
    u = ref_ops.exp_elog_theta(jnp.asarray(gamma))
    up = np.array(ref_pk.u_to_planes(u))
    lamb = rng.uniform(0.5, 3.0, size=(b, k, 2)).astype(np.float32)
    t1, t0 = (np.array(t) for t in ref_ops.exp_elog_beta(jnp.asarray(lamb)))
    return rows, up, t1, t0


@pytest.mark.parametrize("approx_div", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [65, 128, 129])
@pytest.mark.parametrize("name", ["lambda_stats_packed", "lambda_stats_acat"])
def test_wide_lambda_twins_match_reference_at_the_piece_edges(
        name, k, dtype, approx_div):
    """K4 and K8 on CPU tensors (their twins, counted in twin_calls)
    against the reference's Pallas kernels in interpret mode on the same
    numpy inputs: both λ statistics."""
    rows, up, t1, t0 = _inputs(k, seed=k + len(name))
    fn = getattr(pk, name)
    tb, tw = ref_pk.pick_tiles(*rows.shape)
    kw = dict(approx_div=approx_div)
    ref_kw = dict(kw, tb=tb, tw=tw, dtype=getattr(jnp, dtype),
                  interpret=True)
    before = fn.twin_calls
    if name == "lambda_stats_acat":
        a1, a0 = pk.decode_count_planes(torch.from_numpy(rows))
        got = fn(a1, a0, *(torch.from_numpy(a) for a in (up, t1, t0)),
                 dtype=getattr(torch, dtype), **kw)
        want = ref_pk.lambda_stats_acat(
            *ref_pk.decode_count_planes(jnp.asarray(rows)), up, t1, t0,
            **ref_kw)
    else:
        got = fn(*(torch.from_numpy(a) for a in (rows, up, t1, t0)),
                 dtype=getattr(torch, dtype), **kw)
        want = ref_pk.lambda_stats_packed(rows, up, t1, t0, **ref_kw)
    assert fn.twin_calls == before + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape == (16, k)
        np.testing.assert_allclose(
            g.numpy(), np.asarray(w),
            **(APPROX_TOL if approx_div else PASS_TOL[dtype]))
    assert float(got[0][3].abs().max()) == 0.0    # a MISSING row adds 0
