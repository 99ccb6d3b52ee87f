"""Process group setup and per-rank data ingest (port of
terastructure_tpu/parallel/multihost.py).

One process (rank) per card, over torch.distributed: `torchrun` starts
them and sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT;
or every process is given the coordinator's address, the world size and
its rank. Rank r takes card LOCAL_RANK (r where LOCAL_RANK is not set).

Data (what makes 1M x 1M, 250 GB packed, runnable): a rank owns one card,
so it reads only its block of the .bed (`load_bed_shard`): the rows of
its SNP shard and the byte columns of its individual shard. The
reference reads all rows of its host's columns; on a 1 x 4 grid at 1M x
1M that would be the whole 250 GB on every rank. Every rank also reads
the full-width rows of the small, seeded eval-SNP pool, so that every
rank carves the same validation and heldout entries and the lead can
score them.

Usage (the same on every rank):

    from terastructure_tpu_torch.parallel import mesh as meshlib, multihost
    multihost.initialize()            # torchrun's environment
    mesh = meshlib.make_mesh(meshlib.choose_mesh_shape(
        multihost.process_count(), ind=cfg.ind_shards, snp=cfg.snp_shards))
    data = multihost.load_bed_shard(path, cfg, mesh)
    res = fit_sharded(cfg, data, mesh=mesh)
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_device = None       # the card (or the CPU) initialize() set up this rank on


def _local_rank() -> int:
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None, device=None) -> torch.device:
    """torch.distributed.init_process_group for this rank; returns its
    device.

    coordinator_address: "host:port" (tcp://host:port), or an init-method
    URL (tcp://..., file://...), with num_processes and process_id; None
    reads torchrun's environment (env://).
    device: "cuda" (the default: card LOCAL_RANK) or "cpu"; a torch.device
    with an index is taken as it is (ranks sharing a card).
    backend: None is NCCL on CUDA cards, gloo on the CPU. Under NCCL a
    local rank beyond the visible cards is an error naming both counts.
    """
    global _device
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("multihost.initialize: no CUDA card; pass "
                           "device='cpu' to run the ranks on the CPU")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and "
                             "process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        kw = dict(init_method=url, world_size=num_processes, rank=process_id)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get(
            "LOCAL_RANK", process_id if process_id is not None
            else os.environ.get("RANK", 0)))
        cards = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", local + 1))
        if backend == "nccl" and max(local + 1, local_world) > cards:
            raise RuntimeError(
                f"{max(local + 1, local_world)} local ranks for {cards} "
                "visible CUDA cards: NCCL takes one card a rank")
        dev = torch.device("cuda", local % cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, **kw)
    _device = dev
    return dev


def device() -> torch.device:
    """This rank's device: the one initialize() set up, else card
    LOCAL_RANK of an initialized group; raises where there is no card."""
    if _device is not None:
        return _device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card for this rank; pass device='cpu' "
                           "to make_mesh or fit_sharded to run on the CPU")
    return torch.device("cuda", _local_rank() % torch.cuda.device_count())


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_byte_slice(n: int, ind_shards: int, shard: int) -> tuple[int, int]:
    """[lo, hi) byte columns of the packed matrix owned by `shard`.

    Requires n padded to a multiple of 4*ind_shards (sharded.make_plan).
    """
    w = (n + 3) // 4
    if w % ind_shards:
        raise ValueError(
            f"packed width {w} not divisible by {ind_shards} shards; "
            "pad individuals first (sharded.prepare does this)")
    per = w // ind_shards
    return shard * per, (shard + 1) * per


def local_byte_cols(mesh, l_padded: int, w_padded: int) -> tuple[int, int]:
    """[lo, hi) byte columns of the global (l_padded, w_padded) packed
    matrix this rank's block covers: what it must load from disk."""
    return host_byte_slice(4 * w_padded, mesh.spec.ind, mesh.i)


def local_snp_rows(mesh, l_padded: int) -> tuple[int, int]:
    """[lo, hi) SNP rows of the padded matrix this rank's block covers."""
    per = l_padded // mesh.spec.snp
    return mesh.s * per, (mesh.s + 1) * per


def load_bed_shard(
    path: str,
    cfg,
    mesh,
    *,
    validation_frac: float = 0.005,
    heldout_frac: float = 0.005,
    eval_snp_pool: int = 2048,
    max_eval_entries: Optional[int] = None,
    seed: Optional[int] = None,
):
    """This rank's ingest (deterministic across ranks).

    Every rank computes the same eval carve (the same seed: the same pool,
    the same entries; the reference's carve bit for bit) but reads only
    its own block of the training matrix: the rows of its SNP shard and
    the byte columns of its individual shard, clipped to the real matrix.
    Peak host memory is O(L_local * W_local + pool * W).
    """
    from terastructure_tpu_torch.data.bed import read_bed, read_bed_rows
    from terastructure_tpu_torch.data.dataset import (GenotypeData,
                                                      _carve_entries)
    from terastructure_tpu_torch.data.pack import packed_width
    from terastructure_tpu_torch.models.psd import MISSING
    from terastructure_tpu_torch.parallel import sharded

    n, l = cfg.n, cfg.l
    seed = cfg.seed if seed is None else seed
    plan = sharded.make_plan(cfg, mesh)
    w_real = packed_width(n)
    lo, hi = local_byte_cols(mesh, plan.l_padded, packed_width(plan.n_padded))
    r0, r1 = local_snp_rows(mesh, plan.l_padded)
    hi_real, r1_real = min(hi, w_real), min(r1, l)
    lo, r0 = min(lo, hi_real), min(r0, r1_real)     # a block of padding
    packed_local, _, _ = read_bed(path, n, l, byte_cols=(lo, hi_real),
                                  snp_rows=(r0, r1_real))

    if validation_frac == 0 and heldout_frac == 0:
        # no eval carve (the compute-beta post-pass)
        return GenotypeData(n=n, l=l, packed=packed_local,
                            byte_col_offset=lo, snp_row_offset=r0)

    # the eval carve on the pool rows (the same on every rank)
    rng = np.random.default_rng(seed + 1_000_003)
    cap = (GenotypeData.MAX_EVAL_ENTRIES if max_eval_entries is None
           else max_eval_entries)
    pool_size = min(eval_snp_pool or l, l)
    pool = np.sort(rng.choice(l, size=pool_size, replace=False)).astype(
        np.int32)
    rows_full = read_bed_rows(path, n, l, pool)
    # Entry counts target the full matrix's present entries (from_packed's
    # fractions); the missing rate is estimated on the pool rows.
    probe_i = rng.integers(0, n, size=min(1 << 20, n * pool_size))
    probe_r = rng.integers(0, pool_size, size=probe_i.size)
    byte = rows_full[probe_r, probe_i >> 2]
    miss_rate = float((((byte >> (2 * (probe_i & 3)).astype(np.uint8)) & 3)
                       == MISSING).mean())
    nnz = int(n * l * (1.0 - miss_rate))
    n_val = min(int(round(validation_frac * nnz)), cap)
    n_held = min(int(round(heldout_frac * nnz)), cap)
    validation, heldout = _carve_entries(
        rows_full, n, pool_size, n_val, n_held, rng)
    # pool-relative SNP indices to global; the MISSING recode mirrored
    # into this rank's block of the training matrix
    for es in (validation, heldout):
        if es is None:
            continue
        es.snp_idx = pool[es.snp_idx]
        col = es.ind_idx >> 2
        sel = ((col >= lo) & (col < hi_real)
               & (es.snp_idx >= r0) & (es.snp_idx < r1_real))
        if sel.any():
            i, j = es.ind_idx[sel], es.snp_idx[sel]
            shift = (2 * (i & 3)).astype(np.uint8)
            np.bitwise_or.at(packed_local, (j - r0, (i >> 2) - lo),
                             np.uint8(3) << shift)
    return GenotypeData(
        n=n, l=l, packed=packed_local,
        validation=validation, heldout=heldout,
        byte_col_offset=lo, snp_row_offset=r0,
        eval_rows_full=rows_full, eval_row_snps=pool,
    )
