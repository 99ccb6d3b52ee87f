"""The γ pass at K > 64 (CPU): the row split its launch takes
(`gamma_grid`'s K > 64 branch) and K5's twin against the reference's
`gamma_stats_packed` in interpret mode at K = 65, 128 and 129, where the
card's body (`gamma_pass_wide_kernel`, csrc/gamma_wide.cuh) takes K as
one piece of 80 columns, one of 128, and two of 80, and the reference's
K axis fills one 128-lane tile and then takes a second. The card's body
is held to the twin by tests/test_torch_cuda.py (`-k wide_gamma` and
`-k k_above_64`) and chip_smoke.py.

Tolerances, as tests/test_torch_lambda_wide.py states them for one pass:
f32 rtol 2e-5 / atol 1e-5, bf16 rtol 1e-3 / atol 1e-6 (the twin and the
reference sum in other orders)."""

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

# B, W at which the paths run the γ pass at K > 64: K1 and K2 at config
# #3's width, K5 at the big-N shape (and B = 4,092, the padded tol
# test's), K1 at the TGP shape, the K = 256 timed shape, config #1's step,
# a ragged B with an odd W, and K5 at N = 1M
WIDE_SHAPES = [(1024, 640), (4096, 25_088), (4092, 25_088), (4096, 640),
               (1024, 2048), (256, 256), (40, 235), (4096, 250_112)]


def _kernel_rows(b, nsplit):
    """The rows a split takes, as the launch derives them from nsplit
    (csrc/gamma_wide.cuh `gamma_stats_wide`): ceil(b / nsplit) rounded up
    to whole row tiles."""
    rows = -(-b // nsplit)
    return -(-rows // pk.GAMMA_WIDE_ROWS) * pk.GAMMA_WIDE_ROWS


@pytest.mark.parametrize("k", [65, 72, 256, 1000])
@pytest.mark.parametrize("b,w", WIDE_SHAPES)
def test_wide_gamma_grid_covers_b_in_64_row_tiles(b, w, k):
    """K > 64: splits of 1 to 64 whole row tiles covering B, none empty,
    within the grid's limit."""
    nsplit = pk.gamma_grid(b, w, k)
    rows = _kernel_rows(b, nsplit)
    assert rows % pk.GAMMA_WIDE_ROWS == 0
    assert pk.GAMMA_WIDE_ROWS <= rows <= 64 * pk.GAMMA_WIDE_ROWS
    assert nsplit * rows >= b and (nsplit - 1) * rows < b
    assert 1 <= nsplit <= 65_535


@pytest.mark.parametrize("b,w", WIDE_SHAPES)
def test_wide_gamma_grid_is_a_function_of_the_shape_only(b, w):
    """The same split at every K > 64 (the body takes K in pieces, not the
    grid), whatever ran before, and for the rows of a ragged row tile; at
    K <= 64 the split of the K <= 64 body."""
    first = pk.gamma_grid(b, w, 65)
    torch.manual_seed(w)
    pk.gamma_stats_packed.launches += 1
    for k in (72, 128, 129, 256, 1000):
        assert pk.gamma_grid(b, w, k) == first
    pk.gamma_stats_packed.launches -= 1
    assert pk.gamma_grid(64 * -(-b // 64), w, 72) == first
    assert pk.gamma_grid(b, w, 64) == pk.gamma_grid(b, w, 8)


@pytest.mark.parametrize("b,w", [(1024, 640), (4096, 25_088), (4096, 640)])
def test_wide_gamma_grid_leaves_enough_ctas(b, w):
    """At config #3's width (K1's and K2's last pass), the big-N shape
    (K5) and the TGP shape (K1): at least a wave of CTAs of 8 warps on the
    card's SMs and their last wave at least 95% full."""
    nsplit = pk.gamma_grid(b, w, 72)
    ctas = -(-w // pk.GAMMA_WIDE_COLS) * nsplit
    waves = -(-ctas // pk.SM_COUNT)
    assert ctas >= 0.95 * pk.SM_COUNT
    assert ctas >= 0.95 * waves * pk.SM_COUNT


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [65, 128, 129])
def test_wide_gamma_twin_matches_reference_at_the_piece_edges(k, dtype):
    """K5 on CPU tensors (its twin, counted in twin_calls) against the
    reference's Pallas kernel in interpret mode on the same numpy inputs,
    with two rows MISSING."""
    rows, up, t1, t0 = _inputs(k, seed=k)
    tb, tw = ref_pk.pick_tiles(*rows.shape)
    before = pk.gamma_stats_packed.twin_calls
    got = pk.gamma_stats_packed(*(torch.from_numpy(a)
                                  for a in (rows, up, t1, t0)),
                                dtype=getattr(torch, dtype))
    assert pk.gamma_stats_packed.twin_calls == before + 1
    want = ref_pk.gamma_stats_packed(rows, up, t1, t0, tb=tb, tw=tw,
                                     dtype=getattr(jnp, dtype),
                                     interpret=True)
    assert got.shape == want.shape == up.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **PASS_TOL[dtype])
    # the MISSING rows add nothing: the statistic of the other rows alone
    keep = [i for i in range(rows.shape[0]) if i not in (3, rows.shape[0] - 1)]
    alone = pk.gamma_stats_packed_twin(
        *(torch.from_numpy(a) for a in (rows[keep], up, t1[keep], t0[keep])),
        dtype=getattr(torch, dtype))
    np.testing.assert_allclose(got.numpy(), alone.numpy(), rtol=1e-6,
                               atol=1e-7)
