"""Fit driver: the host-side outer loop with convergence assessment (port
of terastructure_tpu/svi/driver.py, resident single-process path).

Every `rfreq` steps the validation predictive log-likelihood is computed;
the fit has converged when the relative improvement stays below
`conv_tol` for `conv_patience` consecutive checks (or it decreases). The
trace keeps each check's metrics, with the phase budget `chunk_s` (the
chunk of rfreq steps until its result is host-visible) and `eval_s` (the
validation scorer).

lambda_mode "local" scores by re-solving the eval SNPs' lambdas from the
current gamma and materializes lambda at the end; "stored" scores the
stored lambda (engine.entry_loglik), which is the result.

`fit` runs on the first CUDA card unless the caller names a device;
device="cpu" runs the kernels' plain twins.

compute_dtype "bfloat16" runs every kernel on its bf16 body (the
resident fit's K1, K2 at snp_group 8; the big-N step's K8, K7, or K4 +
K5 or K6; eval and export through K4): T, U and R enter the products
rounded to bf16, the sums and everything outside the products stay f32.

stream=True keeps the packed matrix on the host (an array or the
np.memmap of data/bed.bed_to_packed_cache) and streams each minibatch to
the device (svi/stream.py): the out-of-core path for a matrix larger
than the card's memory. It requires lambda_mode="local".

The reference's hooks: `state=` continues a fit (a restored checkpoint,
io/checkpoint.py, or a text model, io/export.state_from_text_model);
`packed=` is the width-padded matrix already on the device;
`metrics_path` appends one JSON record a check, `trace_path` the plain
trace `step<TAB>validation ll<TAB>wall s`; `callback(rec)` sees each
record; `checkpoint_dir` saves the state asynchronously every
`checkpoint_every` checks and at convergence, and the last save is
written before `fit` returns. Step t draws from (seed, t), so a fit
restored at step t and run to T ends bitwise where an uninterrupted run
to T ends. init="spectral" starts gamma from svi/init.spectral_gamma.

The sharded path (parallel/fit.fit_sharded) passes `step_fn_factory`
(its chunk runner), `mesh`, this rank's shards as `state` and its packed
block as `packed` (or stream=True and the rank's host block). Then every
check gathers gamma (and in the stored mode lambda) to the lead rank,
which scores and broadcasts the log-likelihood, so every rank takes the
same convergence decision; only the lead writes metrics, the trace and
checkpoints (a checkpoint is the whole padded state, gathered first). In
a run of several ranks the local mode's lambda is left at the prior (the
sharded compute-beta is the export); a world of one rank materializes it
as the single-device fit does.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from terastructure_tpu_torch.config import SVIConfig
from terastructure_tpu_torch.data.dataset import GenotypeData
from terastructure_tpu_torch.io import checkpoint as ckpt
from terastructure_tpu_torch.svi import engine, stream as stream_mod
from terastructure_tpu_torch.svi.init import spectral_gamma
from terastructure_tpu_torch.svi.postprocess import compute_lambda

log = logging.getLogger("terastructure_tpu_torch")


@dataclasses.dataclass
class FitResult:
    state: engine.SVIState
    trace: List[dict]                 # per-check metrics
    converged: bool
    steps: int
    validation_ll: float
    heldout_ll: Optional[float]
    wall_s: float
    # seconds of the fit's parts outside the trace's chunk_s and eval_s:
    # init_s (the initial gamma), export_s (the local mode's lambda),
    # checkpoint_wait_s (the step loop inside save_checkpoint: the wait
    # for the previous save and the snapshot), heldout_s
    timings: dict = dataclasses.field(default_factory=dict)


def eval_rows(data: GenotypeData, uniq: np.ndarray):
    """Width-padded full-width packed rows of the eval SNPs `uniq`
    (sorted): from data.eval_rows_full where the loader set it (a rank's
    block holds only some columns), else from the matrix. Rows that lie
    on a device (data/dataset.carve_eval_device) are gathered and padded
    there, a tensor on that device; host rows give a host array."""
    if data.eval_rows_full is not None:
        snps = np.asarray(data.eval_row_snps)
        pos = np.searchsorted(snps, uniq)
        if (pos >= len(snps)).any() or not np.array_equal(snps[pos], uniq):
            raise ValueError("eval entry SNPs missing from eval_rows_full")
        src, at = data.eval_rows_full, pos
    elif data.is_local_slice:
        raise ValueError("a block of the matrix needs eval_rows_full for the "
                         "local mode's eval (multihost.load_bed_shard sets "
                         "it)")
    else:
        src, at = data.packed, uniq
    if isinstance(src, torch.Tensor):
        return engine.pad_width(src[torch.from_numpy(at).to(src.device,
                                                             torch.long)])
    return engine.pad_width(np.asarray(src)[at])


def make_scorer(cfg: SVIConfig, data: GenotypeData, es, device):
    """(gamma, lamb) -> the mean predictive log-lik of an entry set (a 0-d
    tensor), or None for an empty set. Local mode: the lambdas of its
    SNPs are re-solved from gamma (lamb is not read). Stored mode: lamb
    is read. Stacked replicates, gamma (R, N, K) and lamb (R, L, K, 2),
    give (R,) log-liks, each replicate's as its single state's."""
    if es is None or not len(es):
        return None
    if cfg.lambda_mode != "local":
        i, j, xv = (torch.as_tensor(np.asarray(a)).to(device)
                    for a in (es.ind_idx, es.snp_idx, es.x))
        i, j = i.long(), j.long()

        def stored(gamma, lamb):
            if gamma.dim() == 3:
                return torch.stack([engine.entry_loglik(
                    g, lm, i, j, xv, form=cfg.predictive)
                    for g, lm in zip(gamma, lamb)])
            return engine.entry_loglik(gamma, lamb, i, j, xv,
                                       form=cfg.predictive)

        return stored
    uniq, inv = np.unique(es.snp_idx, return_inverse=True)
    f = engine.make_entry_loglik_recompute(
        cfg, eval_rows(data, uniq), inv.astype(np.int64), es.ind_idx, es.x,
        device=device)
    return lambda gamma, lamb: f(gamma)


def _wait(device) -> None:
    """Wait for the device's queued work (where a timing needs it)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit(
    cfg: SVIConfig,
    data: GenotypeData,
    *,
    device=None,
    state: Optional[engine.SVIState] = None,
    step_fn_factory: Optional[Callable] = None,
    packed: Optional[torch.Tensor] = None,
    metrics_path: Optional[str] = None,
    trace_path: Optional[str] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 5,
    callback: Optional[Callable[[dict], None]] = None,
    stream: bool = False,
    mesh=None,
) -> FitResult:
    """Run SVI until convergence or cfg.max_steps on one device, or on
    this rank of a grid (step_fn_factory and mesh, parallel/fit.py).

    device: where the fit runs. None means the first CUDA card, and
    raises RuntimeError where there is none; pass device="cpu" to run on
    the CPU. The width-padded packed matrix moves there once (or comes as
    `packed`, a uint8 tensor on that device), unless stream=True: then it
    stays on the host, and only minibatches, the eval SNPs' rows and the
    export's row chunks move. A given `state` moves to the device; in
    the stored lambda mode its lamb is stepped in place when it is
    already there.
    """
    if cfg.n != data.n or cfg.l != data.l:
        raise ValueError("config/data shape mismatch")
    sharded = step_fn_factory is not None
    if sharded and (mesh is None or state is None):
        raise ValueError("step_fn_factory takes the grid (mesh) and this "
                         "rank's sharded state (parallel.fit_sharded)")
    if sharded:
        device = mesh.device
    elif device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("fit: no CUDA card; pass device='cpu' to run "
                               "on the CPU")
        device = "cuda"
    device = torch.device(device)
    local_mode = cfg.lambda_mode == "local"
    timings = {}

    if stream:
        if packed is not None:
            raise ValueError("stream=True keeps the host matrix on the "
                             "host; don't pass a device `packed`")
        packed = data.packed                     # stays on the host
        run_chunk = (step_fn_factory or stream_mod.make_stream_chunk)(
            cfg, cfg.rfreq, int(packed.shape[0]))
    elif sharded:
        if packed is None:
            raise ValueError("the sharded fit passes this rank's packed "
                             "block")
        run_chunk = step_fn_factory(cfg, cfg.rfreq, int(packed.shape[0]))
    else:
        if packed is None:
            packed = engine.resident_packed(data.packed, device)
        elif packed.device.type != device.type:
            raise ValueError(f"packed is on {packed.device}, the fit runs "
                             f"on {device}")
        run_chunk = engine.make_run_chunk(cfg, cfg.rfreq,
                                          int(packed.shape[0]))
    ti = time.time()
    if state is None:
        state = engine.init_state(cfg, l_padded=packed.shape[0],
                                  device=device)
        if cfg.init == "spectral":
            # the resident matrix where there is one, else the host's
            src = data.packed if stream else packed
            state = state._replace(gamma=spectral_gamma(
                src, cfg.n, cfg.k, alpha=cfg.alpha_value, seed=cfg.seed,
                l_real=cfg.l, device=device))
            _wait(device)
    else:
        state = state._replace(gamma=state.gamma.to(device),
                               lamb=state.lamb.to(device))
    timings["init_s"] = round(time.time() - ti, 3)

    lead = mesh is None or mesh.lead
    multiproc = mesh is not None and mesh.world > 1

    def scorer_for(es):
        """state -> the mean log-lik of an entry set (None for an empty
        one), the same float on every rank: on a grid the lead scores the
        gathered state and broadcasts the value."""
        if es is None or not len(es):
            return None
        scorer = make_scorer(cfg, data, es, device) if lead else None
        if not sharded:
            return lambda st: float(scorer(st.gamma, st.lamb))
        from terastructure_tpu_torch.parallel.sharded import gather_state

        def f(st):
            full = gather_state(st, mesh, lamb=not local_mode)
            ll = 0.0
            if lead:
                lamb = None if local_mode else full.lamb[: cfg.l]
                ll = float(scorer(full.gamma[: cfg.n], lamb))
            return mesh.broadcast_float(ll)

        return f

    val_scorer = scorer_for(data.validation)

    trace: List[dict] = []
    best_ll = -np.inf
    stall = 0
    converged = False
    checks = 0
    timings["checkpoint_wait_s"] = 0.0
    t0 = time.time()
    mfile = open(metrics_path, "a") if metrics_path and lead else None
    tfile = open(trace_path, "a") if trace_path and lead else None
    try:
        while state.t < cfg.max_steps:
            tc = time.time()
            state = run_chunk(state, packed)
            # the chunk only enqueues work: read one value to wait for it
            float(state.gamma[0, 0])
            tc = time.time() - tc
            rec = {
                "step": state.t,
                "wall_s": round(time.time() - t0, 3),
                "rho": float(cfg.rho(float(state.t))),
                "chunk_s": round(tc, 3),
            }
            if not trace:
                rec["predictive"] = cfg.predictive
            if val_scorer is not None:
                te = time.time()
                ll = val_scorer(state)
                rec["eval_s"] = round(time.time() - te, 3)
                rec["validation_ll"] = ll
                if not np.isfinite(ll):
                    log.error("validation ll is not finite at step %d",
                              state.t)
                    break
                rel = (ll - best_ll) / (abs(best_ll) + 1e-12)
                if ll > best_ll:
                    best_ll = ll
                stall = stall + 1 if rel < cfg.conv_tol else 0
                if stall >= cfg.conv_patience:
                    converged = True
            trace.append(rec)
            log.info("step %(step)d  val_ll %(validation_ll).6f",
                     {**{"validation_ll": float("nan")}, **rec})
            if mfile:
                mfile.write(json.dumps(rec) + "\n")
                mfile.flush()
            if tfile and "validation_ll" in rec:
                # the reference's plain trace: iteration, loglik, wall
                tfile.write(f"{rec['step']}\t{rec['validation_ll']:.8f}"
                            f"\t{rec['wall_s']}\n")
                tfile.flush()
            if callback:
                callback(rec)
            checks += 1
            if checkpoint_dir and (converged or
                                   checks % max(checkpoint_every, 1) == 0):
                ts = time.time()
                snap = state
                if sharded:      # the whole padded state, on the lead
                    from terastructure_tpu_torch.parallel.sharded import \
                        gather_state
                    snap = gather_state(state, mesh)
                if lead:         # the write overlaps the next chunk's steps
                    ckpt.save_checkpoint(checkpoint_dir, snap, cfg,
                                         block=False)
                timings["checkpoint_wait_s"] += time.time() - ts
            if converged:
                break
    finally:
        if mfile:
            mfile.close()
        if tfile:
            tfile.close()
    timings["checkpoint_wait_s"] = round(timings["checkpoint_wait_s"], 3)

    if local_mode and multiproc:
        # no rank holds every column of the matrix: the sharded
        # compute-beta post-pass is the export; eval never read lambda
        log.info("multi-process run: lambda left at prior in the result; "
                 "run compute-beta for final per-SNP estimates")
    elif local_mode:
        # lambda is derived state in the local mode: materialize it for
        # export (the stored mode's lambda is the result)
        tx = time.time()
        gamma = state.gamma[: cfg.n]
        if stream:
            lamb = torch.from_numpy(stream_mod.compute_lambda_stream(
                cfg, gamma, packed)).to(device)
        else:
            lamb = compute_lambda(cfg, gamma, packed)
        state = state._replace(lamb=lamb)
        _wait(device)
        timings["export_s"] = round(time.time() - tx, 3)

    if checkpoint_dir:
        ckpt.wait_until_finished()         # the last save, written
    th = time.time()
    held_scorer = scorer_for(data.heldout)
    held_ll = held_scorer(state) if held_scorer is not None else None
    timings["heldout_s"] = round(time.time() - th, 3)
    return FitResult(
        state=state,
        trace=trace,
        converged=converged,
        steps=state.t,
        validation_ll=(float(trace[-1].get("validation_ll", np.nan))
                       if trace else np.nan),
        heldout_ll=held_ll,
        wall_s=time.time() - t0,
        timings=timings,
    )
