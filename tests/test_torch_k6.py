"""K6, `batch_stats_fused_packed` (CPU): its twin against the reference's
`batch_stats_fused_packed` in interpret mode at K = 64, 65, 128 and 129,
the edges of the card's K-widths and pieces, at f32 and bf16. On the card
K6 is K7's launch at the exact divide (csrc/stats_fused.cuh), whose grid
and partial buffers tests/test_torch_k7_wide.py checks; the card's bodies
are held to the twin, to K7 and to their own re-runs by
tests/test_torch_cuda.py (`-k k6`) and chip_smoke.py.

Tolerances: f32 rtol 2e-5 / atol 1e-5, bf16 rtol 1e-3 / atol 1e-6 (one
pass each, as tests/test_torch_gamma_wide.py states them: the twin and the
reference sum in other orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terastructure_tpu.data.pack import pack2bit
from terastructure_tpu.ops import stats_dense as ref_ops
from terastructure_tpu.ops import stats_pallas as ref_pk
from terastructure_tpu_torch.ops import stats_packed as pk

TOL = {"float32": dict(rtol=2e-5, atol=1e-5),
       "bfloat16": dict(rtol=1e-3, atol=1e-6)}


def _inputs(k, b=24, n=4096, seed=0):
    """Packed rows (B, N/4) with two rows MISSING, u (N, K), t1 and t0
    (B, K) from a random λ (numpy): 3 batch tiles of 8 and 2 W tiles of
    512 for the reference (tests/test_pallas.py:98-140)."""
    rng = np.random.default_rng(seed)
    rows = pack2bit(rng.integers(0, 4, size=(b, n)).astype(np.int8))
    rows[[3, b - 1]] = 0xFF
    gamma = rng.uniform(0.3, 3.0, size=(n, k)).astype(np.float32)
    u = np.array(ref_ops.exp_elog_theta(jnp.asarray(gamma)))
    lamb = rng.uniform(0.5, 3.0, size=(b, k, 2)).astype(np.float32)
    t1, t0 = (np.array(t) for t in ref_ops.exp_elog_beta(jnp.asarray(lamb)))
    return rows, u, t1, t0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [64, 65, 128, 129])
def test_k6_twin_matches_reference_at_the_piece_edges(k, dtype):
    """K6 on CPU tensors (its twin, counted in twin_calls) against the
    reference's Pallas kernel in interpret mode on the same numpy inputs,
    rows MISSING: K = 64 (the last K <= 64 width), 65 and 128 (one piece
    of K at K > 64) and 129 (two)."""
    rows, u, t1, t0 = _inputs(k, seed=k)
    tb, tw = ref_pk.pick_tiles(*rows.shape)
    before = pk.batch_stats_fused_packed.twin_calls
    got = pk.batch_stats_fused_packed(
        *(torch.from_numpy(a) for a in (rows, u, t1, t0)),
        dtype=getattr(torch, dtype))
    assert pk.batch_stats_fused_packed.twin_calls == before + 1
    want = ref_pk.batch_stats_fused_packed(rows, u, t1, t0, tb=tb, tw=tw,
                                           dtype=getattr(jnp, dtype),
                                           interpret=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL[dtype])
