"""Out-of-core SVI: fit datasets larger than the card's memory (port of
terastructure_tpu/svi/stream.py).

The packed genotype matrix stays on the host, an array or an on-disk
np.memmap (data/bed.bed_to_packed_cache), instead of resident on the
card. Each rfreq chunk runs a host loop: one worker thread gathers the
next minibatch's rows from the host matrix and starts their copy to the
card while the current step computes there. At B = 4096 and N = 1M a
batch is ~1 GB; with grouped sampling (cfg.snp_group) the host read is
B/G contiguous row blocks.

Determinism: the minibatch of step t is a pure function of (cfg.seed, t)
through np.random.default_rng(SeedSequence((seed, t))), the reference's
draw, so the port's minibatches are the reference's bitwise and the
prefetch schedule cannot change results. The step's own draw (the big-N
column subsample) comes from the resident step's stream,
engine.step_generator(seed, t, device, SUB_TAG), so a streamed step on
rows r is bitwise the resident big-N step on rows r.

Transfers on CUDA (`BatchStream.batch`): the gather goes through the
native `gather_groups` (ctypes releases the GIL) into pinned host buffer
t % 2, whose 0xFF pad columns are written once; the copy to the card runs
non_blocking on a stream of its own, and an event recorded after it is
what the step waits on (`BatchStream.ready`: the compute stream waits
for the event, the host does not). Three hazards, each handled where it
arises:

  (a) a pinned buffer is refilled two batches later, only after the
      event of its last copy has completed (the worker waits on it);
  (b) every batch lands in a fresh device tensor that is marked as used
      by the compute stream (`Tensor.record_stream`), so the allocator
      does not hand its memory to a later batch before the step that
      reads it is done;
  (c) an exception in the worker surfaces in the chunk through
      `future.result()`.

On the CPU there is no pinned memory: each batch is a fresh CPU tensor.

Only lambda_mode="local" is supported: lambda stays derived state, so
nothing SNP-indexed needs scattering back into a matrix that is not
resident.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from terastructure_tpu_torch import native
from terastructure_tpu_torch.config import SVIConfig
from terastructure_tpu_torch.data.pack import unpack2bit_torch
from terastructure_tpu_torch.models import psd
from terastructure_tpu_torch.ops import stats_dense as ops
from terastructure_tpu_torch.ops.stats_packed import pad_individuals
from terastructure_tpu_torch.svi import engine
from terastructure_tpu_torch.svi.postprocess import solve_lambda_blocks


def _check_host_matrix(packed_host):
    if (not isinstance(packed_host, np.ndarray) or packed_host.ndim != 2
            or packed_host.dtype != np.uint8
            or not packed_host.flags.c_contiguous):
        raise ValueError("streaming needs the packed matrix as a C-contiguous"
                         " uint8 (L, W) host array or np.memmap")


class BatchStream:
    """Deterministic host-side minibatch sampler over a host matrix.

    packed_host: (L, W) uint8 ndarray or np.memmap, C-contiguous. Batches
    are width-padded to a 128-byte multiple Wp (padding bytes 0xFF =
    MISSING) and land on `device`.
    """

    def __init__(self, cfg: SVIConfig, packed_host, device="cpu"):
        _check_host_matrix(packed_host)
        self.packed = packed_host
        self.seed = cfg.seed
        self.b = cfg.batch_size
        self.l, self.w = packed_host.shape
        self.wp = self.w + (-self.w) % 128
        g = cfg.snp_group
        self.g = g if (g > 1 and self.b % g == 0) else 1
        self.device = torch.device(device)
        if self.device.type == "cuda":
            self.copy_stream = torch.cuda.Stream(self.device)
            self._pinned = [torch.full((self.b, self.wp), 0xFF,
                                       dtype=torch.uint8, pin_memory=True)
                            for _ in range(2)]
            self._copied = [None, None]   # event of each buffer's last copy
        elif self.device.type != "cpu":
            raise ValueError(f"BatchStream: unsupported device {device}")

    def starts(self, t: int) -> np.ndarray:
        """The B/G group starts of step t (G = 1: the B rows), the
        reference's draw."""
        rng = np.random.default_rng(np.random.SeedSequence((self.seed, t)))
        return rng.integers(0, self.l, size=self.b // self.g)

    def gather(self, t: int, out: np.ndarray) -> None:
        """The rows of step t into columns [0, W) of out (B, Wp): groups
        of G consecutive rows, wrapping at L."""
        native.gather_groups(self.packed, self.starts(t), self.g, out)

    def host_batch(self, t: int) -> np.ndarray:
        """The padded batch of step t as a fresh host array (B, Wp)."""
        out = np.full((self.b, self.wp), 0xFF, dtype=np.uint8)
        self.gather(t, out)
        return out

    def batch(self, t: int):
        """Gather step t's rows and start their move to the device.
        Returns (rows (B, Wp) uint8 on the device, the event the copy
        records, None on the CPU); `ready` makes them usable."""
        if self.device.type == "cpu":
            return torch.from_numpy(self.host_batch(t)), None
        i = t % 2
        if self._copied[i] is not None:
            self._copied[i].synchronize()          # hazard (a)
        buf = self._pinned[i]
        self.gather(t, buf.numpy())
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self.copy_stream):
            rows = torch.empty((self.b, self.wp), dtype=torch.uint8,
                               device=self.device)
            rows.copy_(buf, non_blocking=True)
            done = torch.cuda.Event(blocking=True)
            done.record(self.copy_stream)
        self._copied[i] = done
        return rows, done

    def ready(self, batch):
        """The rows of a `batch` result, usable on the current stream: it
        waits for the copy (on the device; the host goes on) and marks
        the rows as used by it (hazard (b))."""
        rows, done = batch
        if done is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(done)
            rows.record_stream(compute)
        return rows


def make_stream_step(cfg: SVIConfig, l_sample: int):
    """The SVI step on a batch of rows already on the device:
    (state, rows (B, Wp)) -> state.

    The resident step's local-mode branch with the minibatch gather
    lifted out to the host. As in the reference, kernel "auto"/"fused"
    resolves to the big-N per-iteration path (engine.step_core_packed:
    K8 and K7, or K4 + K5, or K6, by cfg.stats_kernel); "dense" stays
    dense.
    """
    if cfg.lambda_mode != "local":
        raise ValueError("streaming SVI requires lambda_mode='local'")
    impl = engine._resolve_kernel(cfg)
    if impl == "fused":
        impl = "pallas"

    def step(state: engine.SVIState, rows) -> engine.SVIState:
        gamma = state.gamma
        dev = rows.device
        if impl == "pallas":
            sub_gen = engine.step_generator(state.seed, state.t, dev,
                                            engine.SUB_TAG)
            _, gamma_stat = engine.step_core_packed(cfg, gamma, rows,
                                                    gen=sub_gen)
        else:
            xb = unpack2bit_torch(rows, cfg.n)
            _, gamma_stat = engine.step_core_dense(
                cfg, gamma, xb, engine._prior_lamb(cfg, cfg.batch_size, dev))
        gamma = engine._global_update(cfg, gamma, gamma_stat, state.t,
                                      l_sample)
        return state._replace(gamma=gamma, t=state.t + 1)

    return step


def make_stream_chunk(cfg: SVIConfig, nsteps: int,
                      l_sample: int | None = None):
    """Chunk runner of `nsteps` streamed steps: (state, packed_host) ->
    state, on the device of state.gamma. While step t is enqueued, one
    worker thread gathers batch t + 1 and starts its copy. The host never
    waits on the device inside a chunk."""
    step = make_stream_step(cfg, l_sample or cfg.l)
    cache = {}

    def run(state: engine.SVIState, packed_host) -> engine.SVIState:
        dev = state.gamma.device
        bs = cache.get("stream")
        if bs is None or bs.packed is not packed_host or bs.device != dev:
            bs = cache["stream"] = BatchStream(cfg, packed_host, dev)
        t0 = state.t
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(bs.batch, t0)
            for s in range(nsteps):
                rows = bs.ready(fut.result())       # hazard (c)
                if s + 1 < nsteps:
                    fut = ex.submit(bs.batch, t0 + s + 1)
                state = step(state, rows)
        return state

    return run


def compute_lambda_stream(cfg: SVIConfig, gamma, packed_host, *,
                          block: int = 1024,
                          chunk_bytes: int = 1 << 30) -> np.ndarray:
    """Streaming equivalent of postprocess.compute_lambda: the converged
    lambda (L, K, 2) f32 as a host array, on gamma's device.

    SNP rows move in chunks of ~chunk_bytes (a multiple of `block` rows)
    through one staging buffer, pinned on CUDA, padded to Wp with 0xFF,
    and each chunk is solved by solve_lambda_blocks in blocks of `block`
    rows (the block size is part of the result: with chunks a multiple of
    it, this is bitwise postprocess.compute_lambda).
    """
    _check_host_matrix(packed_host)
    l, w = packed_host.shape
    wp = w + (-w) % 128
    dev = gamma.device
    u = pad_individuals(ops.exp_elog_theta(gamma), wp)
    rows_per = max(block, (chunk_bytes // wp) // block * block)
    rows_per = min(rows_per, -(-l // block) * block)
    stage = torch.full((rows_per, wp), 0xFF, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    stage_np = stage.numpy()
    out = np.empty((l, cfg.k, 2), dtype=np.float32)
    for lo in range(0, l, rows_per):
        hi = min(lo + rows_per, l)
        stage_np[: hi - lo, :w] = packed_host[lo:hi]
        rows = stage[: hi - lo].to(dev, non_blocking=True)
        lam = solve_lambda_blocks(cfg, u, rows, block=block)
        # the read-back waits for the solve, which follows the copy on
        # the stream: the stage is free to refill after it
        out[lo:hi] = lam.cpu().numpy()
    return out[: cfg.l]


def compute_beta_stream(cfg: SVIConfig, gamma, packed_host, *,
                        block: int = 1024) -> np.ndarray:
    """Final beta estimates (L, K) as numpy from a host matrix (the
    compute-beta post-pass of a streamed fit)."""
    lam = compute_lambda_stream(cfg, gamma, packed_host, block=block)
    return psd.beta_mean(torch.from_numpy(lam)).numpy()
