"""What each rank of the port's multi-rank CPU tests runs (through
terastructure_tpu_torch/parallel/ranks.py's RankPool). Imports torch and the port only, never JAX.
Every case takes the grid (ind, snp) of a world of ind * snp ranks on the
CPU and returns this rank's part; the test assembles and compares."""

from __future__ import annotations

import numpy as np
import torch

from terastructure_tpu_torch.parallel import mesh as meshlib
from terastructure_tpu_torch.parallel import multihost, sharded
from terastructure_tpu_torch.parallel.fit import fit_sharded
from terastructure_tpu_torch.svi import engine
from terastructure_tpu_torch.svi.engine import SVIState


def _mesh(grid):
    return meshlib.make_mesh(meshlib.MeshSpec(*grid), device="cpu")


def _where(mesh):
    return dict(rank=mesh.rank, i=mesh.i, s=mesh.s)


def one_step(grid, cfg, gamma, lamb, rows, idx, idx_w=None, t=0):
    """One sharded step from the whole state (gamma (n_padded, K), lamb
    (l_padded, K, 2)) on injected rows: rows (B, W_padded) hold SNP shard
    s's minibatch at [s B_l, (s + 1) B_l), idx (B,) their local row
    indices, idx_w {(s, i): columns} the column subsample. This rank's
    gamma and lambda shards and its reduced gamma statistic."""
    mesh = _mesh(grid)
    plan = sharded.make_plan(cfg, mesh)
    st = sharded.shard_state(SVIState(torch.tensor(gamma), torch.tensor(lamb),
                                      t, cfg.seed), plan, mesh)
    _, stats, apply_gamma, psum = sharded._build_step_parts(cfg, plan, mesh)
    b = plan.batch_per_shard
    (_, _), (c0, c1) = sharded.block_bounds(plan, mesh)
    sl = slice(mesh.s * b, (mesh.s + 1) * b)
    rows_l = torch.from_numpy(np.ascontiguousarray(rows[sl, c0:c1]))
    iw = (None if idx_w is None
          else torch.from_numpy(np.asarray(idx_w[(mesh.s, mesh.i)])))
    lamb_l, g = stats(st.gamma, st.lamb, rows_l, torch.from_numpy(idx[sl]),
                      t, cfg.seed, idx_w=iw)
    g = psum(g)()
    return dict(_where(mesh), gamma=apply_gamma(st.gamma, g, t).numpy(),
                lamb=lamb_l.numpy(), gstat=g.numpy())


def chunks(grid, cfg, data, nsteps, variants=("overlap", "plain", "step")):
    """From one init: the pipelined chunk ("overlap"), the plain chunk
    ("plain") and make_sharded_step nsteps times ("step"): this rank's
    (gamma, lambda, t) after each of `variants`."""
    mesh = _mesh(grid)
    plan, packed = sharded.prepare(cfg, data, mesh)
    runs = dict(
        overlap=sharded.make_sharded_run_chunk(cfg, plan, mesh, nsteps),
        plain=sharded.make_sharded_run_chunk(cfg, plan, mesh, nsteps,
                                             overlap=False))
    step = sharded.make_sharded_step(cfg, plan, mesh)

    def stepped(st, packed_l):
        for _ in range(nsteps):
            st = step(st, packed_l)
        return st

    runs["step"] = stepped
    out = {}
    for name in variants:
        st = runs[name](sharded.init_sharded_state(cfg, plan, mesh), packed)
        out[name] = (st.gamma.numpy(), st.lamb.numpy(), st.t)
    return dict(_where(mesh), **out)


def compute_lambda(grid, cfg, data, gamma, block):
    """The sharded compute-beta core on the whole gamma (n, K): this
    rank's lambda rows (L_local, K, 2)."""
    mesh = _mesh(grid)
    plan, packed = sharded.prepare(cfg, data, mesh)
    st = sharded.shard_state(SVIState(torch.tensor(gamma), torch.zeros(
        (cfg.l, cfg.k, 2)), 0, cfg.seed), plan, mesh)
    fn = sharded.make_sharded_compute_lambda(cfg, plan, mesh, block=block)
    return dict(_where(mesh), lamb=fn(st.gamma, packed).numpy())


def _gathered(res, mesh):
    full = sharded.gather_state(res.state, mesh, lamb=False)
    return None if full is None else full.gamma.numpy()


def fit(grid, cfgs, data, stream=False):
    """fit_sharded with each config of `cfgs`: the lead's gathered gamma
    (n_padded, K), the scores, steps and validation trace of each."""
    mesh = _mesh(grid)
    out = dict(_where(mesh), runs=[])
    for cfg in cfgs:
        res = fit_sharded(cfg, data, mesh=mesh, stream=stream)
        out["runs"].append(dict(gamma=_gathered(res, mesh),
                                steps=res.steps, converged=res.converged,
                                validation_ll=res.validation_ll,
                                heldout_ll=res.heldout_ll,
                                trace=[r.get("validation_ll")
                                       for r in res.trace]))
    return out


def fit_from_bed(grid, cfg, bed, stream=False):
    """The fit of this rank's own block (multihost.load_bed_shard) and
    the fit of the whole matrix with the same carve (the loader on a
    1 x 1 grid), on this grid: the lead's gathered gamma of each, and the
    block this rank read."""
    mesh = _mesh(grid)
    whole = meshlib.Mesh(spec=meshlib.MeshSpec(1, 1), rank=0,
                         device=torch.device("cpu"), backend=None)
    mine = multihost.load_bed_shard(bed, cfg, mesh, eval_snp_pool=16)
    full = multihost.load_bed_shard(bed, cfg, whole, eval_snp_pool=16)
    out = dict(_where(mesh), block=mine.packed.shape,
               offsets=(mine.snp_row_offset, mine.byte_col_offset),
               whole_width=full.packed.shape[1])
    for name, data, strm in (("block", mine, stream), ("whole", full, False)):
        res = fit_sharded(cfg, data, mesh=mesh, stream=strm)
        out[name] = dict(gamma=_gathered(res, mesh),
                         validation_ll=res.validation_ll,
                         heldout_ll=res.heldout_ll, steps=res.steps)
    return out


def init_rows(cfg, grid):
    """This rank's init gamma rows and engine.init_state's (N, K)."""
    mesh = _mesh(grid)
    plan = sharded.make_plan(cfg, mesh)
    return dict(_where(mesh),
                mine=sharded.init_sharded_state(cfg, plan, mesh).gamma.numpy(),
                single=engine.init_state(cfg).gamma.numpy())
