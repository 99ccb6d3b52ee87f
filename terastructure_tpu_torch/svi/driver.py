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

Not yet ported (NotImplementedError): step_fn_factory (multi-GPU, S8),
checkpoint_dir (S9), init="spectral" (S7).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from terastructure_tpu_torch.config import SVIConfig
from terastructure_tpu_torch.data.dataset import GenotypeData
from terastructure_tpu_torch.svi import engine, stream as stream_mod
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
    rows = engine.pad_width(np.asarray(data.packed)[uniq])
    f = engine.make_entry_loglik_recompute(
        cfg, rows, inv.astype(np.int64), es.ind_idx, es.x, device=device)
    return lambda gamma, lamb: f(gamma)


def _not_ported(what, slice_):
    raise NotImplementedError(f"{what} is not ported yet ({slice_})")


def fit(
    cfg: SVIConfig,
    data: GenotypeData,
    *,
    device=None,
    step_fn_factory: Optional[Callable] = None,
    checkpoint_dir: Optional[str] = None,
    stream: bool = False,
) -> FitResult:
    """Run SVI until convergence or cfg.max_steps on one device.

    device: where the fit runs. None means the first CUDA card, and
    raises RuntimeError where there is none; pass device="cpu" to run on
    the CPU. The width-padded packed matrix moves there once, unless
    stream=True: then it stays on the host, and only minibatches, the
    eval SNPs' rows and the export's row chunks move.
    """
    if cfg.n != data.n or cfg.l != data.l:
        raise ValueError("config/data shape mismatch")
    if step_fn_factory is not None:
        _not_ported("step_fn_factory", "slice S8, multi-GPU")
    if checkpoint_dir is not None:
        _not_ported("checkpoint_dir", "slice S9, I/O")
    if cfg.init != "random":
        _not_ported(f"init={cfg.init!r}", "slice S7, spectral init")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("fit: no CUDA card; pass device='cpu' to run "
                               "on the CPU")
        device = "cuda"
    device = torch.device(device)
    local_mode = cfg.lambda_mode == "local"

    if stream:
        packed = data.packed                     # stays on the host
        run_chunk = stream_mod.make_stream_chunk(cfg, cfg.rfreq,
                                                 int(packed.shape[0]))
    else:
        packed = torch.from_numpy(engine.pad_width(np.asarray(data.packed)))
        packed = packed.to(device)
        run_chunk = engine.make_run_chunk(cfg, cfg.rfreq,
                                          int(packed.shape[0]))
    state = engine.init_state(cfg, l_padded=packed.shape[0], device=device)

    val_scorer = make_scorer(cfg, data, data.validation, device)

    trace: List[dict] = []
    best_ll = -np.inf
    stall = 0
    converged = False
    t0 = time.time()
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
            ll = float(val_scorer(state.gamma, state.lamb))
            rec["eval_s"] = round(time.time() - te, 3)
            rec["validation_ll"] = ll
            if not np.isfinite(ll):
                log.error("validation ll is not finite at step %d", state.t)
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
        if converged:
            break

    if local_mode:
        # lambda is derived state in the local mode: materialize it for
        # export (the stored mode's lambda is the result)
        if stream:
            lamb = torch.from_numpy(stream_mod.compute_lambda_stream(
                cfg, state.gamma, packed)).to(device)
        else:
            lamb = compute_lambda(cfg, state.gamma, packed)
        state = state._replace(lamb=lamb)

    held_scorer = make_scorer(cfg, data, data.heldout, device)
    held_ll = (float(held_scorer(state.gamma, state.lamb))
               if held_scorer is not None else None)
    return FitResult(
        state=state,
        trace=trace,
        converged=converged,
        steps=state.t,
        validation_ll=(float(trace[-1].get("validation_ll", np.nan))
                       if trace else np.nan),
        heldout_ll=held_ll,
        wall_s=time.time() - t0,
    )
