"""Per-rank ingest and the multi-process command line of the port
(terastructure_tpu_torch/parallel/multihost.py, cli.py) on the CPU.

Mirrors tests/test_multihost.py: the byte-column ranges tile the width;
two ranks that read only their blocks of the .bed (load_bed_shard: the
rows of their SNP shard, the byte columns of their individual shard) fit
bit for bit what the same two ranks fit from the whole matrix with the
same eval carve, at (2, 1) and (1, 2), resident and streamed from the
blocks; the carve is the reference's load_bed_shard's bit for bit; and
`fit --distributed --coordinator ...` and `compute-beta --distributed` in
two fresh processes: the lead alone writes the run directory and
beta.txt, which holds the single-device post-pass of the same checkpoint
on the same row blocks.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_rank_cases as cases
from terastructure_tpu import SVIConfig as RefConfig
from terastructure_tpu.parallel import mesh as ref_meshlib
from terastructure_tpu.parallel import multihost as ref_multihost
from terastructure_tpu_torch import SVIConfig
from terastructure_tpu_torch.data import GenotypeData, simulate_psd
from terastructure_tpu_torch.data.bed import write_bed, write_bim, write_fam
from terastructure_tpu_torch.data.pack import pack2bit
from terastructure_tpu_torch.io.checkpoint import restore_checkpoint
from terastructure_tpu_torch.io.export import load_matrix
from terastructure_tpu_torch.parallel import mesh as meshlib
from terastructure_tpu_torch.parallel import multihost
from terastructure_tpu_torch.svi.engine import resident_packed
from terastructure_tpu_torch.svi.postprocess import compute_beta
from terastructure_tpu_torch.parallel.ranks import RankPool

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = RankPool(2, tmp_path_factory.mktemp("ranks"), device="cpu",
                    timeout=240, threads=1)
    yield pool
    pool.close()


def _write_sim_bed(path, n, l, k, seed=0):
    _, _, x = simulate_psd(n, l, k, seed=seed, missing_frac=0.02)
    stem = str(path / "sim")
    write_bed(stem + ".bed", pack2bit(np.ascontiguousarray(x.T)), n)
    write_fam(stem + ".fam", [f"i{i}" for i in range(n)])
    write_bim(stem + ".bim", [f"s{j}" for j in range(l)])
    return stem + ".bed"


def _rank_mesh(grid, rank):
    return meshlib.Mesh(spec=meshlib.MeshSpec(*grid), rank=rank,
                        device="cpu", backend="gloo")


def test_local_byte_cols_partition():
    """The ranks' byte-column ranges tile the padded width exactly, and
    their SNP rows the padded length."""
    n_padded, ind = 64, 2
    w = n_padded // 4
    slices = [multihost.host_byte_slice(n_padded, ind, s)
              for s in range(ind)]
    assert slices[0][0] == 0 and slices[-1][1] == w
    for (a, b), (c, d) in zip(slices, slices[1:]):
        assert b == c
    for grid in ((2, 2), (4, 1), (1, 4)):
        cols, rows = set(), set()
        for r in range(grid[0] * grid[1]):
            m = _rank_mesh(grid, r)
            cols.add(multihost.local_byte_cols(m, 96, 512))
            rows.add(multihost.local_snp_rows(m, 96))
        assert sorted(cols)[0][0] == 0 and sorted(cols)[-1][1] == 512
        assert sorted(rows)[0][0] == 0 and sorted(rows)[-1][1] == 96
        assert len(cols) == grid[0] and len(rows) == grid[1]


def test_nccl_refuses_more_local_ranks_than_cards(monkeypatch):
    """Under NCCL a rank takes card LOCAL_RANK: more local ranks than
    cards is an error naming both counts, raised before any rendezvous."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="2 local ranks for 1 visible"):
        multihost.initialize("file:///nonexistent/store", 2, 1)


def test_eval_carve_is_the_references(tmp_path):
    """load_bed_shard's carve (the pool, the entries, the recode into the
    block) bit for bit the reference's on one device."""
    n, l, k = 600, 96, 3
    bed = _write_sim_bed(tmp_path, n, l, k)
    kw = dict(n=n, l=l, k=k, batch_size=16, seed=3, kernel="dense")
    ours = multihost.load_bed_shard(bed, SVIConfig(**kw), _rank_mesh(
        (1, 1), 0), eval_snp_pool=16)
    ref = ref_multihost.load_bed_shard(
        bed, RefConfig(**kw), ref_meshlib.make_mesh(
            ref_meshlib.MeshSpec(1, 1)), eval_snp_pool=16)
    np.testing.assert_array_equal(ours.packed, np.asarray(ref.packed))
    np.testing.assert_array_equal(ours.eval_rows_full, ref.eval_rows_full)
    np.testing.assert_array_equal(ours.eval_row_snps, ref.eval_row_snps)
    for es in ("validation", "heldout"):
        a, b = getattr(ours, es), getattr(ref, es)
        for f in ("ind_idx", "snp_idx", "x"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_pad_snps_is_the_references():
    from terastructure_tpu.data import GenotypeData as RefData

    _, _, x = simulate_psd(40, 93, 2, seed=1)
    ours = GenotypeData.from_dense(x, validation_frac=0.05,
                                   heldout_frac=0.0, seed=1)
    ref = RefData.from_dense(x, validation_frac=0.05, heldout_frac=0.0,
                             seed=1)
    for m in (4, 31, 93):
        np.testing.assert_array_equal(ours.pad_snps(m).packed,
                                      np.asarray(ref.pad_snps(m).packed))
    assert ours.pad_snps(93) is ours
    assert not ours.is_local_slice


@pytest.mark.parametrize("grid", [(2, 1), (1, 2)])
def test_block_ingest_fits_the_whole_matrix_bitwise(ranks, tmp_path, grid):
    """Each rank reads its block only; resident from the blocks, and
    streamed from them through the native gather, the fit is bitwise the
    fit of the same ranks given the whole matrix."""
    n, l, k = 600, 96, 3
    bed = _write_sim_bed(tmp_path, n, l, k)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=16, rfreq=20, max_steps=60,
                    seed=0)
    for stream in (False, True):
        outs = ranks.run(cases.fit_from_bed, grid, cfg, bed, stream=stream)
        lead = outs[0]
        np.testing.assert_array_equal(lead["block"]["gamma"],
                                      lead["whole"]["gamma"])
        for o in outs:
            assert o["block"]["validation_ll"] == o["whole"]["validation_ll"]
            assert o["block"]["heldout_ll"] == o["whole"]["heldout_ll"]
            assert o["whole_width"] == (n + 3) // 4
        shapes = {o["rank"]: (o["block"], o["offsets"]) for o in outs}
        if grid == (2, 1):      # 1024 padded individuals: 128 bytes a rank
            assert [shapes[r][1] for r in (0, 1)] == [(0, 0), (0, 128)]
        else:                   # 96 SNPs: 48 rows a rank
            assert [shapes[r][1] for r in (0, 1)] == [(0, 0), (48, 0)]


def _cli_ranks(tmp_path, argv_of, name):
    """Two fresh processes of the command line, rank r running
    argv_of(r); their outputs, after both exit 0."""
    coordinator = "file://" + str(tmp_path / f"{name}.store")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for key in ("XLA_FLAGS", "JAX_PLATFORMS"):
        env.pop(key, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "terastructure_tpu_torch.cli", *argv_of(r),
         "--coordinator", coordinator, "--num-processes", "2",
         "--process-id", str(r), "--force-cpu"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o[-4000:]}"
    return outs


def test_cli_distributed_fit_and_compute_beta(tmp_path):
    n, l, k = 48, 120, 2
    bed = _write_sim_bed(tmp_path, n, l, k, seed=3)
    bases = [tmp_path / f"out{r}" for r in (0, 1)]
    for b in bases:
        b.mkdir()
    _cli_ranks(tmp_path, lambda r: [
        "fit", "--bed", bed, "-k", str(k), "--batch-size", "32",
        "--rfreq", "50", "--max-steps", "100", "--seed", "3", "--label",
        "t", "--out-base", str(bases[r]), "--snp-shards", "2"], "fit")
    run = bases[0] / f"n{n}-k{k}-l{l}-t"
    assert not any(bases[1].iterdir())          # the lead alone writes
    names = {p.name for p in run.iterdir()}
    assert {"gamma.txt", "theta.txt", "result.json", "config.json",
            "metrics.jsonl", "validation.txt", "infer.log",
            "checkpoint"} <= names
    res = json.loads((run / "result.json").read_text())
    assert res["processes"] == 2 and res["mesh"] == {"ind": 1, "snp": 2}
    assert res["steps"] == 100 and np.isfinite(res["validation_ll"])
    theta = load_matrix(run / "theta.txt")
    assert theta.shape == (n, k)

    _cli_ranks(tmp_path, lambda r: [
        "compute-beta", "--run-dir", str(run), "--bed", bed], "beta")
    beta = load_matrix(run / "beta.txt")
    assert not any(bases[1].iterdir())
    # each rank solved its 60 rows as one block (ind = 1: nothing to
    # reduce), which is the single-device post-pass at block = 60
    state, cfg = restore_checkpoint(str(run / "checkpoint"))
    data = GenotypeData.from_bed(bed, validation_frac=0, heldout_frac=0)
    want = compute_beta(cfg, state.gamma[:n],
                        resident_packed(data.packed, "cpu"), block=60)
    np.testing.assert_allclose(beta, want, rtol=1e-6, atol=1e-7)
