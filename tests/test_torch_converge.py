"""The converged-fit script (terastructure_tpu_torch/converge.py) and the
beta replay its oracle uses, at a tiny size on the CPU."""

import numpy as np
import torch

from terastructure_tpu_torch import converge
from terastructure_tpu_torch.data import simulate_packed_device
from terastructure_tpu_torch.data.simulate import simulated_beta


def test_simulated_beta_replays_the_device_draw():
    """Regenerate the packed matrix from the replayed beta and the
    draw's torch generator: it equals the simulator's."""
    n, l, k, seed, chunk = 16, 50, 3, 7, 16
    packed, theta = simulate_packed_device(n, l, k, seed=seed, chunk=chunk,
                                           device="cpu")
    beta = simulated_beta(n, l, k, seed=seed, chunk=chunk)
    assert beta.shape == (l, k) and beta.dtype == np.float32
    gen = torch.Generator().manual_seed(seed)
    rows = []
    for j0 in range(0, l, chunk):
        p = (torch.from_numpy(beta[j0:j0 + chunk])
             @ torch.from_numpy(theta).T).clamp_(0.0, 1.0)
        u = torch.rand(p.shape, generator=gen)
        x = ((u >= (1 - p) * (1 - p)).int() + (u >= 1 - p * p).int()).numpy()
        q = x.reshape(len(x), n // 4, 4) << np.arange(0, 8, 2)
        rows.append(np.bitwise_or.reduce(q, axis=-1).astype(np.uint8))
    np.testing.assert_array_equal(np.concatenate(rows), packed)


def test_converge_record_at_a_tiny_size():
    rec = converge.run(3, device="cpu", max_steps=200, scale=0.002,
                       batch_size=64)
    assert (rec["n"], rec["l"], rec["k"]) == (4, 2000, 8)
    assert rec["steps"] == 200 and rec["checks"] == 2
    for key in ("theta_mae", "heldout_ll", "oracle_ll", "validation_ll",
                "snp_updates_per_s"):
        assert np.isfinite(rec[key]), key
    assert rec["oracle_ll"] < 0 and rec["launches"] == {
        name: 0 for name in rec["launches"]}
    assert rec["twin_calls"]["fused_local_solve"] == 200


def test_converge_stream_record_at_a_tiny_size():
    """--stream: the matrix goes through a .bed and the on-disk cache and
    is fitted out of core (the big-N step's twins here, K1's never), and
    the temporary directory is removed."""
    import tempfile
    from pathlib import Path

    before = set(Path(tempfile.gettempdir()).glob("converge_stream_*"))
    rec = converge.run(5, device="cpu", max_steps=100, scale=0.0004,
                       batch_size=64, stream=True)
    assert (rec["n"], rec["l"], rec["k"]) == (400, 400, 10)
    assert rec["stream"] and rec["steps"] == 100
    assert rec["bed_write_s"] >= 0 and rec["ingest_s"] >= 0
    for key in ("theta_mae", "heldout_ll", "validation_ll"):
        assert np.isfinite(rec[key]), key
    assert rec["twin_calls"]["batch_stats_fused_v2_packed"] == 100
    assert rec["twin_calls"]["fused_local_solve"] == 0
    assert set(Path(tempfile.gettempdir()).glob("converge_stream_*")) == before


def test_converge_replicates_records_at_a_tiny_size():
    """--replicates: one record a replicate (seeds 0..R-1, K1's batched
    twin once a lockstep step) and the best's last, marked."""
    recs = converge.run_replicates(1, 2, device="cpu", max_steps=100,
                                   scale=0.05, batch_size=64)
    assert len(recs) == 3 and recs[-1]["best"]
    assert [r["seed"] for r in recs[:2]] == [0, 1]
    best = max(recs[:2], key=lambda r: r["validation_ll"])
    assert recs[-1]["seed"] == best["seed"]
    for r in recs:
        assert (r["n"], r["l"], r["k"], r["replicates"]) == (48, 496, 3, 2)
        assert r["steps"] <= r["lockstep_steps"] <= 100
        for key in ("theta_mae", "heldout_ll", "oracle_ll", "validation_ll",
                    "snp_updates_per_s"):
            assert np.isfinite(r[key]), key
        assert r["twin_calls"]["fused_local_solve"] == r["lockstep_steps"]
        assert r["rep_launches"]["fused_local_solve"] == 0
