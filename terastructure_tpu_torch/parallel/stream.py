"""Out-of-core SVI over the grid of ranks: streaming x sharding (port of
terastructure_tpu/parallel/stream.py).

The packed matrix stays on the host (an array or an np.memmap: the whole
matrix, or the rank's block from multihost.load_bed_shard). Each rank
draws step t's minibatch exactly as the resident sharded step draws it
(sharded.draw_rows: the CPU generator of (seed, t, s), the same blocks
where the resident step gathers 8-row blocks with K3), gathers its own
(B_local, W_local) block of those rows from the host matrix and copies it
to its card; a streamed sharded fit is therefore bitwise the resident
one, while each card holds only O(B_local x W_local) bytes of genotypes a
step.

Transfers as in svi/stream.py's BatchStream: the native `gather_groups`
(the GIL released) into pinned buffer t % 2, whose 0xFF padding columns
are written once, then a non_blocking copy on a stream of its own and an
event the compute stream waits on; a pinned buffer is refilled only after
its last copy completed, each batch lands in a fresh device tensor marked
as used by the compute stream (record_stream), and a worker's exception
surfaces through future.result(). The native gather needs the rank's
block as it is (its byte columns from column 0); a host matrix that holds
more columns is cut with numpy indexing.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from terastructure_tpu_torch import native
from terastructure_tpu_torch.config import SVIConfig
from terastructure_tpu_torch.data.pack import packed_width
from terastructure_tpu_torch.parallel import sharded


class ShardedBatchStream:
    """Host-side minibatch sampler of one rank, reproducing the resident
    sharded step's draw.

    packed_host: (rows, cols) uint8, C-contiguous, the matrix or a block
    of it whose first row is SNP `snp_row_offset` and first column byte
    `byte_col_offset`. Batches are (B_local, W_local) on `mesh.device`:
    rows beyond the real matrix and bytes beyond the real width 0xFF."""

    def __init__(self, cfg: SVIConfig, plan: sharded.ShardPlan, mesh,
                 packed_host, byte_col_offset: int = 0,
                 snp_row_offset: int = 0):
        if (not isinstance(packed_host, np.ndarray) or packed_host.ndim != 2
                or packed_host.dtype != np.uint8
                or not packed_host.flags.c_contiguous):
            raise ValueError("streaming needs the packed matrix as a "
                             "C-contiguous uint8 host array or np.memmap")
        self.plan = plan
        self.kp = sharded.plan_kernels(cfg, plan)
        self.seed = cfg.seed
        self.s = mesh.s
        self.packed = packed_host
        self.b = plan.batch_per_shard
        self.wl = plan.w_local
        (self.r0, _), (self.c0, _) = sharded.block_bounds(plan, mesh)
        self.row0, self.col0 = snp_row_offset, byte_col_offset
        # the real byte columns of this rank's block, and where they sit
        # in the host matrix
        self.ncols = max(0, min(self.wl, packed_width(cfg.n) - self.c0))
        self.hcol = self.c0 - byte_col_offset
        if self.ncols and (self.hcol < 0
                           or self.hcol + self.ncols > packed_host.shape[1]):
            raise ValueError(
                f"the host matrix's byte columns [{byte_col_offset}, "
                f"{byte_col_offset + packed_host.shape[1]}) do not cover "
                f"this rank's [{self.c0}, {self.c0 + self.ncols})")
        self.native = (self.hcol == 0
                       and packed_host.shape[1] == self.ncols)
        self.l_real = cfg.l
        self.device = torch.device(mesh.device)
        if self.device.type == "cuda":
            self.copy_stream = torch.cuda.Stream(self.device)
            self._pinned = [torch.full((self.b, self.wl), 0xFF,
                                       dtype=torch.uint8, pin_memory=True)
                            for _ in range(2)]
            self._copied = [None, None]

    def fill(self, t: int, out: np.ndarray) -> None:
        """The block of step t's rows into out (B_local, W_local): the
        real columns written, the rest left as they are (0xFF)."""
        blocks, idx = sharded.draw_rows(self.plan, self.kp, self.seed, t,
                                        self.s)
        rows = self.r0 + idx.numpy().astype(np.int64)     # global SNP rows
        valid = rows < self.l_real
        local = rows - self.row0
        if valid.any() and (local[valid].min() < 0 or local[valid].max()
                            >= self.packed.shape[0]):
            raise ValueError("the host matrix does not hold the rows of "
                             "this rank's SNP shard")
        if self.native and valid.all():
            g = 8 if blocks is not None else 1
            native.gather_groups(self.packed, local[::g], g, out)
            return
        out[~valid] = 0xFF
        out[valid, : self.ncols] = self.packed[
            local[valid], self.hcol: self.hcol + self.ncols]

    def host_batch(self, t: int) -> np.ndarray:
        out = np.full((self.b, self.wl), 0xFF, dtype=np.uint8)
        self.fill(t, out)
        return out

    def batch(self, t: int):
        """Gather step t's block and start its move to the device:
        (rows on the device, the copy's event, None on the CPU)."""
        if self.device.type != "cuda":
            return torch.from_numpy(self.host_batch(t)).to(self.device), None
        i = t % 2
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        buf = self._pinned[i]
        self.fill(t, buf.numpy())
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self.copy_stream):
            rows = torch.empty((self.b, self.wl), dtype=torch.uint8,
                               device=self.device)
            rows.copy_(buf, non_blocking=True)
            done = torch.cuda.Event(blocking=True)
            done.record(self.copy_stream)
        self._copied[i] = done
        return rows, done

    def ready(self, batch):
        """The rows of a `batch` result, usable on the current stream."""
        rows, done = batch
        if done is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(done)
            rows.record_stream(compute)
        return rows


def make_sharded_stream_chunk(cfg: SVIConfig, plan, mesh, nsteps: int,
                              byte_col_offset: int = 0,
                              snp_row_offset: int = 0):
    """Chunk runner over a host matrix: (state, packed_host) -> state.
    While step t is enqueued, one worker thread gathers and starts to copy
    the block of step t + 1."""
    step = sharded.make_sharded_step(cfg, plan, mesh, streaming=True)
    cache = {}

    def run(state, packed_host):
        bs = cache.get("stream")
        if bs is None or bs.packed is not packed_host:
            bs = cache["stream"] = ShardedBatchStream(
                cfg, plan, mesh, packed_host, byte_col_offset=byte_col_offset,
                snp_row_offset=snp_row_offset)
        t0 = state.t
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(bs.batch, t0)
            for s in range(nsteps):
                rows = bs.ready(fut.result())
                if s + 1 < nsteps:
                    fut = ex.submit(bs.batch, t0 + s + 1)
                state = step(state, rows)
        return state

    return run
