"""The turnkey multi-card fit: the grid, the sharded chunk runner and the
driver's convergence loop (port of terastructure_tpu/parallel/fit.py).

    from terastructure_tpu_torch.parallel import fit_sharded
    res = fit_sharded(cfg, data, mesh=mesh)   # on every rank

Ranks: call multihost.initialize() first (torchrun's environment, or a
coordinator); every rank runs the same program. Without a process group
the fit is a world of one rank on one card.
"""

from __future__ import annotations

from typing import Optional

from terastructure_tpu_torch.config import SVIConfig
from terastructure_tpu_torch.data.dataset import GenotypeData
from terastructure_tpu_torch.parallel import mesh as meshlib
from terastructure_tpu_torch.parallel import multihost, sharded
from terastructure_tpu_torch.parallel import stream as pstream
from terastructure_tpu_torch.svi import driver


def fit_sharded(
    cfg: SVIConfig,
    data: GenotypeData,
    *,
    mesh: Optional[meshlib.Mesh] = None,
    stream: bool = False,
    device=None,
    **fit_kw,
) -> driver.FitResult:
    """fit() over the (ind x snp) grid of ranks (by default every rank on
    'snp'; cfg.ind_shards and cfg.snp_shards set it).

    mesh: this rank's Mesh; None makes one (make_mesh, on `device`: None
    is this rank's card). `state=` (a whole state: a restored checkpoint)
    is padded and cut to the rank's shards (shard_state).

    stream=True keeps the packed matrix on the host and streams each
    rank's minibatch block to its card (parallel/stream.py): bitwise the
    resident sharded fit. The result's state is this rank's shards
    (gather with sharded.gather_state).
    """
    if mesh is None:
        spec = meshlib.choose_mesh_shape(multihost.process_count(),
                                         cfg.ind_shards, cfg.snp_shards)
        mesh = meshlib.make_mesh(spec, device=device)
    state = fit_kw.pop("state", None)
    plan = sharded.make_plan(cfg, mesh)
    if state is None:
        state = sharded.init_sharded_state(cfg, plan, mesh)
    else:
        state = sharded.shard_state(state, plan, mesh)   # e.g. resume

    if stream:
        def factory(cfg_, nsteps, l_sample):
            return pstream.make_sharded_stream_chunk(
                cfg_, plan, mesh, nsteps,
                byte_col_offset=data.byte_col_offset,
                snp_row_offset=data.snp_row_offset)

        return driver.fit(cfg, data, state=state, step_fn_factory=factory,
                          mesh=mesh, stream=True, **fit_kw)

    _, packed = sharded.prepare(cfg, data, mesh)

    def factory(cfg_, nsteps, l_sample):
        return sharded.make_sharded_run_chunk(cfg_, plan, mesh, nsteps)

    return driver.fit(cfg, data, state=state, step_fn_factory=factory,
                      packed=packed, mesh=mesh, **fit_kw)
