"""The sharded stream (terastructure_tpu_torch/parallel/stream.py) on the
CPU: at (2, 2), a streamed sharded fit is bitwise the resident sharded
fit (the reference's parallel/fit.py:40-43 promise), with per-row draws
and with the 8-row block draws the resident step gathers with K3's twin;
the host batch of a step is the resident gather's rows; a host matrix
that does not hold a rank's block is refused.
"""

import numpy as np
import pytest
import torch

import _torch_rank_cases as cases
from terastructure_tpu_torch import SVIConfig
from terastructure_tpu_torch.data import GenotypeData, simulate_psd
from terastructure_tpu_torch.parallel import mesh as meshlib
from terastructure_tpu_torch.parallel import sharded
from terastructure_tpu_torch.parallel.stream import ShardedBatchStream
from terastructure_tpu_torch.parallel.ranks import RankPool


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    pool = RankPool(4, tmp_path_factory.mktemp("ranks"), device="cpu",
                    timeout=240, threads=1)
    yield pool
    pool.close()


def _data(n, l, k, seed):
    _, _, x = simulate_psd(n, l, k, seed=seed)
    return GenotypeData.from_dense(x, validation_frac=0.02,
                                   heldout_frac=0.02, seed=seed)


@pytest.mark.parametrize("blocks", [False, True])
def test_streamed_fit_is_the_resident_fit(ranks, blocks):
    n, l, k = 600, 512, 3
    data = _data(n, l, k, 4)
    kw = (dict(batch_size=512, dma_gather_min_l=8) if blocks
          else dict(batch_size=32))
    cfg = SVIConfig(n=n, l=l, k=k, rfreq=10, max_steps=30, seed=4, **kw)
    plan = sharded.make_plan(cfg, meshlib.MeshSpec(2, 2))
    assert sharded.plan_kernels(cfg, plan).dma_blocks == blocks
    res = ranks.run(cases.fit, (2, 2), [cfg], data)
    strm = ranks.run(cases.fit, (2, 2), [cfg], data, stream=True)
    np.testing.assert_array_equal(res[0]["runs"][0]["gamma"],
                                  strm[0]["runs"][0]["gamma"])
    for a, b in zip(res, strm):
        assert a["runs"][0]["trace"] == b["runs"][0]["trace"]
        assert a["runs"][0]["heldout_ll"] == b["runs"][0]["heldout_ll"]


def _mesh(grid, rank):
    return meshlib.Mesh(spec=meshlib.MeshSpec(*grid), rank=rank,
                        device=torch.device("cpu"), backend=None)


@pytest.mark.parametrize("blocks", [False, True])
def test_host_batch_is_the_resident_gather(blocks):
    """Every rank's host batch of a step: the rows the resident step
    gathers from its block (padding rows and columns 0xFF)."""
    n, k = 600, 3
    l = 512 if blocks else 509              # 509: a padding row at (., 2)
    data = _data(n, l, k, 5)
    kw = (dict(batch_size=512, dma_gather_min_l=8) if blocks
          else dict(batch_size=32))
    cfg = SVIConfig(n=n, l=l, k=k, seed=5, **kw)
    plan = sharded.make_plan(cfg, meshlib.MeshSpec(2, 2))
    assert sharded.plan_kernels(cfg, plan).dma_blocks == blocks
    for rank in range(4):
        mesh = _mesh((2, 2), rank)
        plan, packed_l = sharded.prepare(cfg, data, mesh)
        sample = sharded._build_step_parts(cfg, plan, mesh)[0]
        bs = ShardedBatchStream(cfg, plan, mesh, data.packed)
        for t in range(40):
            rows, _ = sample(packed_l, t, cfg.seed)
            np.testing.assert_array_equal(bs.host_batch(t), rows.numpy())


def test_a_host_matrix_without_the_block_is_refused():
    n, l, k = 600, 64, 3
    data = _data(n, l, k, 6)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=32, seed=6)
    mesh = _mesh((2, 2), 1)                     # i = 0, s = 1
    plan = sharded.make_plan(cfg, mesh)
    with pytest.raises(ValueError, match="byte columns"):
        ShardedBatchStream(cfg, plan, mesh, data.packed[:, 200:].copy(),
                           byte_col_offset=200)
    bs = ShardedBatchStream(cfg, plan, mesh, data.packed[:16].copy())
    with pytest.raises(ValueError, match="rows"):
        bs.host_batch(0)
