"""The multi-card fit over torch.distributed (port of
terastructure_tpu/parallel/): the grid (mesh), process setup and per-rank
ingest (multihost), the sharded step (sharded), the fit (fit), the
sharded stream (stream), and a pool of ranks spawned on one host for the
programs that hold this path on one machine (ranks)."""

from terastructure_tpu_torch.parallel.mesh import MeshSpec, make_mesh  # noqa: F401
from terastructure_tpu_torch.parallel.sharded import (  # noqa: F401
    make_sharded_run_chunk, make_sharded_step, shard_state)
from terastructure_tpu_torch.parallel.fit import fit_sharded  # noqa: F401
