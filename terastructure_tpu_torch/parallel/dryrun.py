"""The multi-rank dry run: one sharded step of each branch of the
multi-card fit over N ranks at tiny shapes (port of __graft_entry__.py's
dryrun_multichip, over parallel/ranks.py's RankPool).

    python -m terastructure_tpu_torch.parallel.dryrun --ranks 4
    python -m terastructure_tpu_torch.parallel.dryrun --ranks 4 --device cpu

The ranks are spawned on this host over gloo; with --device cuda (the
default) they share the first card, so the kernels launch there; with
--device cpu their plain twins run. Four passes, the reference's:

  1. the default sharded step on an (ind x snp) grid, ind = 2 where N is
     even and at least 4, then the validation entries' log-likelihood;
  2. the fused branch at ind = 1 (K1 on every rank);
  3. the big-N step with the column subsample and K3's block gather
     engaged (kernel "pallas", dma_gather_min_l lowered to 8: K3, K8, K4
     for the full refinement pass, K7);
  4. two steps of the pipelined chunk runner (comm_overlap) with the
     gamma statistic all-reduced in bf16.

Each pass gathers gamma to the lead, which asserts it finite and > 0 and
scores the validation entries (a finite log-likelihood, broadcast to
every rank), and reports the branch it was meant to take beside the
kernels' launch counters (their twins' calls on the CPU): a pass whose
counters show another branch fails. Prints one JSON line of the passes
and exits non-zero where a pass fails.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from terastructure_tpu_torch.config import SVIConfig
from terastructure_tpu_torch.data import GenotypeData, simulate_psd
from terastructure_tpu_torch.ops import fused_step, gather, stats_packed
from terastructure_tpu_torch.parallel import mesh as meshlib
from terastructure_tpu_torch.parallel import sharded
from terastructure_tpu_torch.parallel.ranks import run_ranks
from terastructure_tpu_torch.svi import engine

KERNELS = {"K1": fused_step.fused_local_solve,
           "K2": fused_step.fused_local_solve_dma,
           "K3": gather.gather_row_blocks,
           "K4": stats_packed.lambda_stats_packed,
           "K5": stats_packed.gamma_stats_packed,
           "K6": stats_packed.batch_stats_fused_packed,
           "K7": stats_packed.batch_stats_fused_v2_packed,
           "K8": stats_packed.lambda_stats_acat}

# the kernels each branch must run (and, for "dense", none)
BRANCHES = {"dense": (), "fused": ("K1",),
            "kernels": ("K4", "K7"),
            "kernels+K3+subsample": ("K3", "K4", "K7", "K8")}


def _problem(n, l, k, batch_size, seed=0):
    """The reference's _make_problem: a config and a simulated dataset."""
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=batch_size, seed=seed)
    _, _, x = simulate_psd(n, l, k, seed=seed)
    data = GenotypeData.from_dense(x, validation_frac=0.005,
                                   heldout_frac=0.005, seed=seed)
    return cfg, data


def _reset():
    for f in KERNELS.values():
        f.launches = f.twin_calls = 0
        if hasattr(f, "bf16_launches"):
            f.bf16_launches = 0


def _counts():
    """name -> (launches of either dtype's body, twin calls)."""
    return {name: (f.launches + getattr(f, "bf16_launches", 0),
                   f.twin_calls) for name, f in KERNELS.items()}


def _branch(cfg, plan) -> str:
    kp = sharded.plan_kernels(cfg, plan)
    if kp.want_fused:
        return "fused"
    if not kp.use_pk:
        return "dense"
    sub_w = ((cfg.local_sub_n // 4 // plan.ind) // 128) * 128
    if kp.dma_blocks and sub_w >= 128 and kp.wl >= 4 * sub_w:
        return "kernels+K3+subsample"
    return "kernels"


def _pass(name, want, cfg, data, grid, nsteps=1):
    """One pass on this rank: nsteps sharded steps from the init, gamma
    checked and the validation entries scored on the lead."""
    mesh = meshlib.make_mesh(meshlib.MeshSpec(*grid))
    plan, packed = sharded.prepare(cfg, data, mesh)
    branch = _branch(cfg, plan)
    state = sharded.init_sharded_state(cfg, plan, mesh)
    _reset()
    if nsteps == 1:
        state = sharded.make_sharded_step(cfg, plan, mesh)(state, packed)
    else:
        state = sharded.make_sharded_run_chunk(cfg, plan, mesh,
                                               nsteps)(state, packed)
    counts = _counts()
    full = sharded.gather_state(state, mesh)
    ll = 0.0
    gamma_ok = True
    if mesh.lead:
        g = full.gamma[: cfg.n]
        gamma_ok = bool(torch.isfinite(g).all() and (g > 0).all())
        val = data.validation
        i, j, xv = (torch.as_tensor(np.asarray(a)).to(mesh.device)
                    for a in (val.ind_idx, val.snp_idx, val.x))
        ll = float(engine.entry_loglik(g, full.lamb[: cfg.l], i.long(),
                                       j.long(), xv))
    ll = mesh.broadcast_float(ll)
    gamma_ok = bool(mesh.broadcast_float(float(gamma_ok)))
    return dict(name=name, grid=list(grid), want=want, branch=branch,
                steps=state.t, counts=counts, gamma_ok=gamma_ok,
                loglik=ll)


def rank_passes(n_ranks: int) -> list:
    """The four passes on this rank (every rank of the pool calls it)."""
    ind = 2 if n_ranks % 2 == 0 and n_ranks >= 4 else 1
    grid = (ind, n_ranks // ind)
    cfg, data = _problem(8 * n_ranks, 16 * n_ranks, 4, 2 * n_ranks)
    out = [_pass("default", None, cfg, data, grid)]

    cfg_f, data_f = _problem(8 * n_ranks, 16 * n_ranks, 4, 8 * n_ranks)
    out.append(_pass("fused", "fused", cfg_f.replace(kernel="fused"),
                     data_f, (1, n_ranks)))

    cfg_b, data_b = _problem(2048 * ind * 4, 64 * n_ranks, 3,
                             128 * (n_ranks // ind))
    cfg_b = cfg_b.replace(kernel="pallas", lambda_mode="local",
                          local_iters=3, local_sub_n=1024 * ind,
                          local_refine_full=True, dma_gather=True,
                          dma_gather_min_l=8)
    out.append(_pass("big-N", "kernels+K3+subsample", cfg_b, data_b, grid))

    cfg_p = cfg.replace(comm_overlap=True, gamma_psum_dtype="bf16")
    out.append(_pass("comm_overlap+bf16", None, cfg_p, data, grid,
                     nsteps=2))
    return out


def check(passes: list, device) -> list:
    """The failures of the lead's passes: a branch other than the one
    named, counters that do not show the branch's kernels (launches on a
    card, twin calls on the CPU; none of another kernel), gamma not
    finite and positive, a log-likelihood not finite."""
    on_card = torch.device(device).type == "cuda"
    bad = []
    for p in passes:
        name = p["name"]
        if p["want"] is not None and p["branch"] != p["want"]:
            bad.append(f"{name}: took {p['branch']}, not {p['want']}")
        used = {k for k, (launches, twins) in p["counts"].items()
                if launches or twins}
        expect = set(BRANCHES[p["branch"]])
        if used != expect:
            bad.append(f"{name}: kernels {sorted(used)}, the {p['branch']} "
                       f"branch runs {sorted(expect)}")
        for k, (launches, twins) in p["counts"].items():
            if on_card and twins:
                bad.append(f"{name}: {k} ran its twin on the card")
            if not on_card and launches:
                bad.append(f"{name}: {k} launched on the CPU")
        if not p["gamma_ok"]:
            bad.append(f"{name}: gamma not finite and positive")
        if not np.isfinite(p["loglik"]):
            bad.append(f"{name}: log-likelihood {p['loglik']}")
    return bad


def dryrun(n_ranks: int, device="cuda", timeout: float = 600.0,
           threads=None) -> dict:
    """The four passes over n_ranks spawned ranks on `device` ("cuda":
    the first card, shared; "cpu"). Returns {"ranks", "device", "passes"
    (the lead's), "failures"}; every rank's passes must agree on the
    branch, counters and log-likelihood."""
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(
        device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun: no CUDA card; pass device='cpu' to run "
                           "the ranks on the CPU")
    outs = run_ranks(n_ranks, rank_passes, (n_ranks,), timeout=timeout,
                     device=dev, threads=threads)
    bad = check(outs[0], dev)
    for r, o in enumerate(outs[1:], 1):
        for a, b in zip(o, outs[0]):
            if (a["branch"], a["loglik"]) != (b["branch"], b["loglik"]):
                bad.append(f"{a['name']}: rank {r} differs from the lead")
    return dict(ranks=n_ranks, device=str(dev), passes=outs[0],
                failures=bad)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    rep = dryrun(args.ranks, args.device, args.timeout)
    print(json.dumps(rep))
    return 1 if rep["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
