"""Batched multi-seed replicates: the R-seed workflow as one lockstep run
(port of terastructure_tpu/svi/replicates.py).

The reference's protocol fits R seeds and keeps the best validation
log-likelihood. R serial `fit` calls pay the host's enqueue of every step
R times; here the R states are stacked and stepped in lockstep
(engine.make_replicate_step): every replicate shares the packed matrix
on the card, and one K1 launch sequence (or, on the big-N path, one
batched `step_core_packed`) with a replicate axis solves all R
minibatches, so a step's launches are paid once for all R. The
validation scorer of the local lambda mode re-solves the eval SNPs'
lambdas for all R at once (K4 with its replicate axis, the eval rows
shared).

Semantics, as the reference's:
  - each replicate's math is a single fit's with its seed and
    dma_gather=False (its own minibatch stream; per-row draws, no K3; on
    the big-N path its own column subsample), so its gamma trajectory, and in the stored mode its lambda, is bitwise
    that fit's;
  - each replicate's convergence is tracked on its own (driver.fit's
    rule); its score is frozen at its own stop, and the batch runs until
    every replicate has stopped (or max_steps);
  - the best replicate is the nanargmax of the frozen scores.
Unlike the reference, each replicate's returned state is its state at its
own stop (a device copy of gamma, and of lambda in the stored mode, taken
then), and its heldout log-likelihood is scored from that state: what a
serial fit with its seed returns, but the export (the local mode's final
lambda, which the batched fit does not make, as the reference does not).

Ported, in both lambda modes at both compute dtypes, at any K: the
fused branch (K1 on gathered rows), the big-N path where the fused gate
refuses the shape (K8, K7, K4 with their replicate axis; K5 or K6 under
stats_kernel "pair" or "fused"; K > 64 the wide bodies with the
axis) and kernel="dense" (each replicate's dense step; the eval K4 with
the axis). K2's group DMA raises NotImplementedError, as the reference
has no batched path through it (engine.check_replicate_path).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from terastructure_tpu_torch.config import SVIConfig
from terastructure_tpu_torch.data.dataset import GenotypeData
from terastructure_tpu_torch.svi import engine
from terastructure_tpu_torch.svi.driver import make_scorer
from terastructure_tpu_torch.svi.engine import ReplicateState, unstack_state

__all__ = ["ReplicateResult", "BatchedFitResult", "fit_replicates_batched",
           "unstack_state"]


@dataclasses.dataclass
class ReplicateResult:
    seed: int
    converged: bool
    steps: int                  # step of this replicate's stop
    validation_ll: float        # ll frozen at its stop
    heldout_ll: Optional[float]  # scored from its state at its stop


@dataclasses.dataclass
class BatchedFitResult:
    replicates: List[ReplicateResult]
    best: int                   # index into replicates / states
    states: ReplicateState      # each replicate's state at its stop; t
    #                             is the batch's last step, each stop
    #                             step is replicates[i].steps
    trace: List[dict]
    wall_s: float


def fit_replicates_batched(cfg: SVIConfig, data: GenotypeData, seeds, *,
                           device=None, packed: Optional[torch.Tensor] = None,
                           callback=None) -> BatchedFitResult:
    """Fit len(seeds) replicates in lockstep on one device.

    Each replicate stops by driver.fit's rule (relative validation-ll
    improvement below conv_tol for conv_patience consecutive checks);
    callback(rec) gets each check's record. device: None means the first
    CUDA card (RuntimeError where there is none); device="cpu" runs the
    kernels' twins. packed: the width-padded matrix already on that
    device (engine.resident_packed), else it moves there once. The
    validation scorer's column subsample (big N only) uses cfg.seed for
    every replicate, as the reference's does.
    """
    if cfg.n != data.n or cfg.l != data.l:
        raise ValueError("config/data shape mismatch")
    if cfg.init != "random":
        raise NotImplementedError(
            f"batched replicates start from random gamma; init={cfg.init!r} "
            "is refused rather than ignored: the reference's batched fit "
            "starts every replicate from random gamma whatever cfg.init "
            "says (terastructure_tpu/svi/replicates.py:68-72), a quirk not "
            "copied. Fit the replicates one by one (fit --replicates R "
            "without --batched) for a spectral start")
    seeds = [int(s) for s in seeds]
    r = len(seeds)
    if r < 1:
        raise ValueError("fit_replicates_batched: no seeds")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("fit_replicates_batched: no CUDA card; pass "
                               "device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    cfg_b = cfg.replace(dma_gather=False)
    stored = cfg.lambda_mode == "stored"

    if packed is None:
        packed = engine.resident_packed(data.packed, device)
    elif packed.device.type != device.type:
        raise ValueError(f"packed is on {packed.device}, the fit runs on "
                         f"{device}")
    l_sample = int(packed.shape[0])
    run_chunk = engine.make_replicate_run_chunk(cfg_b, cfg.rfreq, l_sample)
    state = engine.init_replicate_state(cfg_b, seeds, l_padded=l_sample,
                                        device=device)
    val = make_scorer(cfg_b, data, data.validation, device)

    def lls_of(scorer, st):
        return scorer(st.gamma, st.lamb).cpu().numpy().astype(np.float64)

    best_ll = np.full(r, -np.inf)
    stall = np.zeros(r, np.int64)
    done = np.zeros(r, bool)
    ll_at_stop = np.full(r, np.nan)
    step_at_stop = np.zeros(r, np.int64)
    gamma_at_stop: list = [None] * r
    lamb_at_stop: list = [None] * r
    trace: List[dict] = []
    t0 = time.time()
    while state.t < cfg.max_steps:
        tc = time.time()
        state = run_chunk(state, packed)
        float(state.gamma[0, 0, 0])          # wait for the chunk
        tc = time.time() - tc
        steps_done = state.t
        rec = {"step": steps_done, "wall_s": round(time.time() - t0, 3),
               "chunk_s": round(tc, 3)}
        if val is not None:
            te = time.time()
            lls = lls_of(val, state)
            rec["eval_s"] = round(time.time() - te, 3)
            rec["validation_ll"] = [float(v) for v in lls]
            if not np.isfinite(lls).all():
                trace.append(rec)
                break
            with np.errstate(invalid="ignore"):
                # first check: best_ll is -inf -> rel = +inf (improved)
                rel = np.where(
                    np.isfinite(best_ll),
                    (lls - best_ll) / (np.abs(best_ll) + 1e-12), np.inf)
            best_ll = np.maximum(best_ll, lls)
            stall = np.where(rel < cfg.conv_tol, stall + 1, 0)
            newly = (~done) & (stall >= cfg.conv_patience)
            for i in np.flatnonzero(newly):
                ll_at_stop[i] = lls[i]
                step_at_stop[i] = steps_done
                gamma_at_stop[i] = state.gamma[i].clone()
                if stored:
                    lamb_at_stop[i] = state.lamb[i].clone()
            done |= newly
            rec["stopped"] = [bool(d) for d in done]
        trace.append(rec)
        if callback:
            callback(rec)
        if val is not None and done.all():
            break

    # replicates still running: their state and score at the last step
    if not done.all():
        lls_final = (lls_of(val, state) if val is not None
                     else np.full(r, np.nan))
        for i in np.flatnonzero(~done):
            ll_at_stop[i] = lls_final[i]
            step_at_stop[i] = state.t
            gamma_at_stop[i] = state.gamma[i]
            lamb_at_stop[i] = state.lamb[i]
    # the local mode's lambda is the prior, never stepped (the export is
    # not made)
    states = ReplicateState(
        gamma=torch.stack(gamma_at_stop),
        lamb=torch.stack(lamb_at_stop) if stored else state.lamb,
        t=state.t, seeds=tuple(seeds))
    held = make_scorer(cfg_b, data, data.heldout, device)
    held = lls_of(held, states) if held is not None else [None] * r

    reps = [ReplicateResult(
        seed=seeds[i], converged=bool(done[i]), steps=int(step_at_stop[i]),
        validation_ll=float(ll_at_stop[i]),
        heldout_ll=None if held[i] is None else float(held[i]))
        for i in range(r)]
    best = (int(np.nanargmax(ll_at_stop)) if np.isfinite(ll_at_stop).any()
            else 0)
    return BatchedFitResult(replicates=reps, best=best, states=states,
                            trace=trace, wall_s=time.time() - t0)
