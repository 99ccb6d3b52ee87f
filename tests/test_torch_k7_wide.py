"""K7 at K > 64 (CPU): the tile rows, B tiles and partial buffers its
launch takes, and its twin against the reference's
batch_stats_fused_v2_packed in interpret mode at K = 128 and 129, where
the reference's K axis fills one 128-lane tile and then takes a second.
The card's body (`stats_v2_wide_kernel`, csrc/stats_fused.cuh) is held
to the twin by tests/test_torch_cuda.py (`-k k7_wide`) and
chip_smoke.py.

Tolerances, as tests/test_torch_replicates_wide.py states them for one
pass: f32 rtol 2e-5 / atol 1e-5, bf16 rtol 1e-3 / atol 1e-6 (the twin
and the reference sum in other orders)."""

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


@pytest.mark.parametrize("k, dtype, rows", [
    (8, torch.float32, 128), (64, torch.float32, 128),
    (10, torch.bfloat16, 128), (32, torch.bfloat16, 64),
    (64, torch.bfloat16, 32),
    (65, torch.float32, 64), (72, torch.bfloat16, 64),
    (128, torch.float32, 64), (1000, torch.bfloat16, 64)])
def test_v2_tile_rows(k, dtype, rows):
    """K <= 64 keeps its bodies' rows; K > 64 takes 64 rows at both
    dtypes (the body's 8 warps over 128 M-rows)."""
    assert pk.v2_tile_rows(k, dtype) == rows


@pytest.mark.parametrize("b, w, k, dtype, rows", [
    # 98 W tiles x 16 B tiles of 256 rows: 1,568 CTAs
    (4096, 25_088, 72, torch.float32, 256),
    (4096, 25_088, 1000, torch.bfloat16, 256),
    # N = 1M: 977 W tiles
    (4092, 250_112, 72, torch.float32, 256),
    # 8 W tiles: 4 row tiles would leave 128 CTAs, 2 leave 256
    (4096, 2048, 72, torch.float32, 128),
    (4096, 2048, 72, torch.bfloat16, 128),
    # 8 x 8 CTAs even at 2: one row tile (the K = 256 timed shape)
    (1024, 2048, 256, torch.float32, 64),
    (40, 300, 72, torch.float32, 64),
    # K <= 64: the body's row tile whatever the shape
    (4096, 25_088, 10, torch.float32, 128),
    (4096, 25_088, 64, torch.bfloat16, 32),
    # config #1's step (B = 256, N = 1,000): one W tile, so one row tile
    # at K > 64 and the body's row tile at K <= 64
    (256, 250, 72, torch.float32, 64), (256, 250, 72, torch.bfloat16, 64),
    (256, 250, 10, torch.float32, 128), (256, 250, 10, torch.bfloat16, 128)])
def test_v2_b_tile(b, w, k, dtype, rows):
    """K > 64: 4 row tiles of 64 a B tile (one γ partial), or 2 or 1
    where 4 would leave fewer than V2_WIDE_MIN_CTAS CTAs; K <= 64: the
    body's row tile."""
    assert pk.v2_b_tile(b, w, k, dtype) == rows
    if k > 64 and rows > 64:
        nwt = -(-w // pk.V2_TILE_COLS)
        assert nwt * -(-b // rows) >= pk.V2_WIDE_MIN_CTAS
        if rows < 256:
            assert nwt * -(-b // (2 * rows)) < pk.V2_WIDE_MIN_CTAS


@pytest.mark.parametrize("b, w, k, dtype, lpart, gpart", [
    # the big-N step at K = 72: 98 W tiles, 16 B tiles of 256 rows (0.46
    # GB of γ partials in f32, the K-chunked body's)
    (4096, 25_088, 72, torch.float32, (98, 4096, 72, 2), (16, 100_352, 72)),
    (4096, 25_088, 72, torch.bfloat16, (98, 4096, 72, 2),
     (16, 100_352, 72)),
    # ragged B and W: the last tiles hold 11 rows and 45 byte columns
    (75, 301, 129, torch.float32, (2, 75, 129, 2), (2, 1204, 129)),
    # B tiles of 128 rows, the last of 4 (2 row tiles, 4 rows in the last)
    (4100, 2048, 72, torch.float32, (8, 4100, 72, 2), (33, 8192, 72)),
    # K <= 64 as before: 128-row tiles at f32, 32 at bf16 K = 64
    (4096, 25_088, 10, torch.float32, (98, 4096, 10, 2), (32, 100_352, 10)),
    (4096, 640, 64, torch.bfloat16, (3, 4096, 64, 2), (128, 2560, 64)),
    # config #1's step: one W tile; 4 row tiles of 64 at K = 72, 2 of 128
    # at K = 10
    (256, 250, 72, torch.float32, (1, 256, 72, 2), (4, 1000, 72)),
    (256, 250, 10, torch.bfloat16, (1, 256, 10, 2), (2, 1000, 10)),
])
def test_v2_partial_shapes(b, w, k, dtype, lpart, gpart):
    """The λ partials (W tiles, B, K, 2) and the γ partials (B tiles, 4W,
    K) that the wrapper allocates for K7's launch."""
    assert pk.v2_partial_shapes(b, w, k, dtype) == (lpart, gpart)
    nbt = gpart[0]
    assert nbt == -(-b // pk.v2_b_tile(b, w, k, dtype))
    assert lpart[0] == -(-w // pk.V2_TILE_COLS)


def _inputs(k, b=16, n=512, seed=0):
    """Packed rows (B, N/4) with two rows MISSING, u (N, K), t1 and t0
    (B, K) from a random lambda (numpy)."""
    rng = np.random.default_rng(seed)
    rows = pack2bit(rng.integers(0, 4, size=(b, n)).astype(np.int8))
    rows[[3, b - 1]] = 0xFF
    gamma = rng.uniform(0.3, 3.0, size=(n, k)).astype(np.float32)
    u = np.array(ref_ops.exp_elog_theta(jnp.asarray(gamma)))
    lamb = rng.uniform(0.5, 3.0, size=(b, k, 2)).astype(np.float32)
    t1, t0 = (np.array(t) for t in ref_ops.exp_elog_beta(jnp.asarray(lamb)))
    return rows, u, t1, t0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [128, 129])
def test_k7_twin_matches_reference_at_the_lane_tile_edge(k, dtype):
    """The port's K7 on CPU tensors (its twin, counted in twin_calls)
    against the reference's Pallas kernel in interpret mode on the same
    numpy inputs: γ statistic and both λ statistics."""
    rows, u, t1, t0 = _inputs(k, seed=k)
    fn = pk.batch_stats_fused_v2_packed
    before = fn.twin_calls
    got = fn(*(torch.from_numpy(a) for a in (rows, u, t1, t0)),
             dtype=getattr(torch, dtype))
    assert fn.twin_calls == before + 1
    tb, tw = ref_pk.pick_tiles(*rows.shape)
    want = ref_pk.batch_stats_fused_v2_packed(
        jnp.asarray(rows), jnp.asarray(u), jnp.asarray(t1), jnp.asarray(t0),
        tb=tb, tw=tw, dtype=getattr(jnp, dtype), interpret=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   **PASS_TOL[dtype])
