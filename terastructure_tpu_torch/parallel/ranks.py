"""A pool of ranks spawned on this host, for the programs that hold the
multi-card path on one machine: the CPU tests (ranks on the CPU),
`converge --ranks` and chip_smoke.py's phase 13 (ranks sharing one card).

Each rank is a process started with the "spawn" method (never fork: the
parent may hold JAX or a CUDA context) that joins a process group through
a file store under a temporary directory (no ports, no clash between
pools) and then runs the tasks it is sent. A task is a module-level
function (picklable by name) that every rank calls with the same
arguments; `RankPool.run` returns the ranks' results in rank order. A
rank that raises fails the task with its traceback, a rank that dies
fails it with its exit code, and ranks that outlast the task's timeout
fail it too, naming the ranks that did not answer; either way the pool is torn down (the other ranks may be waiting
in a collective) and the next task starts a new one.

    with RankPool(4, tmp, device="cpu", timeout=240, threads=1) as pool:
        outs = pool.run(module.case, grid, cfg)
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from typing import Optional


def _worker(rank, world, store, device, threads, inq, outq):
    import torch
    import torch.distributed as dist

    from terastructure_tpu_torch.parallel import multihost

    if threads:
        torch.set_num_threads(threads)
    try:
        multihost.initialize(f"file://{store}", world, rank, backend="gloo",
                             device=device)
    except BaseException:                # reported to the parent, which fails
        outq.put((rank, False, traceback.format_exc()))
        return
    while True:
        task = inq.get()
        if task is None:
            break
        fn, args, kw = task
        try:
            outq.put((rank, True, fn(*args, **kw)))
        except BaseException:            # reported to the parent, which fails
            outq.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """`world` ranks on `device` ("cpu", or a card such as
    torch.device("cuda", 0) that the ranks share) over gloo (NCCL refuses
    two ranks on one card), started on first use and kept
    for the tasks that follow. timeout: the seconds a task may take,
    the pool's start included. threads: torch's threads a rank (None
    leaves torch's default)."""

    def __init__(self, world: int, tmpdir, *, device, timeout: float,
                 threads: Optional[int] = None):
        self.world = world
        self.timeout = timeout
        self.tmpdir = str(tmpdir)
        self.device = device
        self.threads = threads
        self.procs = None
        self.starts = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(kill=exc[0] is not None)

    def _start(self):
        ctx = multiprocessing.get_context("spawn")
        self.starts += 1
        store = os.path.join(self.tmpdir, f"store{self.starts}")
        self.outq = ctx.Queue()
        self.inqs = [ctx.Queue() for _ in range(self.world)]
        self.procs = [ctx.Process(target=_worker, daemon=True,
                                  args=(r, self.world, store, self.device,
                                        self.threads, self.inqs[r],
                                        self.outq))
                      for r in range(self.world)]
        for p in self.procs:
            p.start()

    def run(self, fn, *args, **kw) -> list:
        """Every rank calls fn(*args, **kw); their results in rank order.
        Raises RuntimeError where a rank failed (its traceback), died (its
        exit code) or the ranks outlasted the pool's timeout (the ranks
        that did not answer)."""
        if self.procs is None:
            self._start()
        for q in self.inqs:
            q.put((fn, args, kw))
        out = {}
        deadline = time.time() + self.timeout
        while len(out) < self.world:
            try:
                rank, ok, res = self.outq.get(timeout=1.0)
            except queue.Empty:
                missing = sorted(set(range(self.world)) - set(out))
                dead = {r: self.procs[r].exitcode for r in missing
                        if self.procs[r].exitcode is not None}
                if dead or time.time() > deadline:
                    self.close(kill=True)
                    raise RuntimeError(
                        f"{fn.__name__}: ranks {sorted(dead)} exited (codes "
                        f"{list(dead.values())}) without a result" if dead
                        else f"{fn.__name__}: ranks {missing} did not finish "
                        f"in {self.timeout} s") from None
                continue
            if not ok:
                self.close(kill=True)
                raise RuntimeError(f"{fn.__name__} failed on rank {rank}:\n"
                                   f"{res}")
            out[rank] = res
        return [out[r] for r in range(self.world)]

    def close(self, kill: bool = False):
        """Stop every rank: ask them to leave (kill=False), then kill what
        is still alive."""
        if self.procs is None:
            return
        if not kill:
            for q in self.inqs:
                q.put(None)
        for p in self.procs:
            if p.pid is None:                # never started
                continue
            p.join(timeout=0.1 if kill else 30)
            if p.is_alive():
                p.kill()
                p.join(timeout=30)
        self.procs = None


def run_ranks(world: int, fn, args=(), *, timeout: float, device,
              threads: Optional[int] = None) -> list:
    """One task on a pool of `world` new ranks, stopped before this
    returns: fn(*args) on every rank, the results in rank order."""
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp, \
            RankPool(world, tmp, device=device, timeout=timeout,
                     threads=threads) as pool:
        return pool.run(fn, *args)
