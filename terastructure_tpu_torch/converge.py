"""Fit one of the reference's acceptance configurations to convergence on
the card and report its quality and rates.

    python -m terastructure_tpu_torch.converge --config 3
    python -m terastructure_tpu_torch.converge --config 1 --compute-dtype bfloat16
    python -m terastructure_tpu_torch.converge --config 5 --scale 0.1

The configurations are those of the reference's acceptance runner
(benchmarks/baseline_configs.py): the published shapes (config 5 cut by
--scale, as the runner's own option does), its batch sizes, rfreq 100,
at most 20,000 steps, snp_group 8, seed 0, so configs 2 and 3 take the
group-addressed fused solve (K2), config 1 (L = 10,000) K1 and config 5
the big-N path. The genotypes are simulated on the card (`simulate_packed_device`, the
reference's structured theta) and carved as the runner carves them: 0.5%
validation and heldout entries, at most 200,000 each, over a pool of
2,048 SNPs at biobank N or L. Prints the
card (nvidia-smi name and power limit) and one JSON line: steps,
converged, theta MAE against the truth, heldout and validation
log-likelihood, the oracle's heldout log-likelihood (the true theta and
beta), fit wall, the sums of chunk_s and eval_s, SNP-updates/s over the
chunks, and the kernels' launch counts (f32 and bf16 bodies apart).
--compute-dtype is the reference CLI's flag: "bfloat16" runs the bf16
bodies (configs 1-3: K1 or K2, and K4; config 5, the big-N step: K8, K7,
K3 and K4).

    python -m terastructure_tpu_torch.converge --config 5 --scale 0.1 --stream

--stream fits out of core, as a matrix larger than the card is fitted:
the simulated matrix is written as a PLINK .bed/.fam/.bim in a temporary
directory, ingested into an on-disk cache (data/bed.bed_to_packed_cache),
carved there, and fitted with fit(stream=True), which keeps the matrix
on the host and streams each minibatch to the card (svi/stream.py; the
big-N step's K8 and K7, K4 for the eval and the export). The record adds
the seconds of the .bed write and of the ingest; the directory is
removed at the end.

    python -m terastructure_tpu_torch.converge --config 1 --replicates 4

--replicates R fits seeds 0..R-1 in lockstep with fit_replicates_batched
(svi/replicates.py: K1 and K4 with their replicate axis; at config 5 the
big-N path, K8, K7 and K4 with it) at the reference's replicates_ab.py
settings (snp_group 1: the reference's batched fit has no path through
K2's group DMA), and prints one record per replicate (its seed, stop
step, scores and theta MAE beside the batch's fields) and then the best
replicate's, marked "best": the R-seed workflow on the card. A scan of
K over R seeds is `python -m terastructure_tpu_torch.cli fit --replicates
R --batched -k K`.

    python -m terastructure_tpu_torch.converge --config 5 --scale 0.1 --ranks 4 --ind-shards 2

--ranks R fits with fit_sharded (parallel/) over R ranks on a grid of
--ind-shards x R / --ind-shards, spawned processes that share the one
card through gloo (`run_ranks`): the multi-card program's quality on one
card (each rank reads its block of the matrix; the lead scores). Its
times are no speed figures: the ranks share the card's SMs and gloo
copies every all-reduce through the host.

    python -m terastructure_tpu_torch.converge --config 4 --chains 4 --n-samples 600

Config 4 is the reference's validator (500 x 5,000, K = 3): simulated and
carved as the others, its matrix unpacked to dense, then
mcmc/validate.compare_svi_mcmc fits SVI (K1 or the big-N step at
B = 64, K4 in eval and export) and runs the sampler warm-started from
it, as the reference's runner does (NUTS, 400 warmup + 500 samples by
default; --sampler smc: the variational bridge with 512 particles, 2
mutations of 8 leapfrog steps, the reference's validator_bench settings).
Its record: theta and beta MAE against SVI, the largest aligned R-hat
and the smallest ESS of theta and of beta (64 coordinates each, as the
reference summarizes; and the largest split R-hat over every
coordinate), SVI steps, the seconds of SVI, of the sampler's
warmup and of its sampling, leapfrog steps, the peak device memory, and
the kernels' launches. With NUTS at --scale 1 the record's
`missed_limits` names each of CONFIG4_LIMITS it misses, and the exit
code is 1 if it misses any.

    python -m terastructure_tpu_torch.converge --config 4 --ranks 4 [--sampler smc]

With --ranks R, config 4 runs over R spawned ranks that share the card
through gloo (`run_ranks`): each simulates the same matrix, the lead fits
SVI (K1, K4) and broadcasts it, the chains or particles are split over
the ranks (mcmc/chains.py), and the lead's record, with `ranks`, is
printed. Its times are no speed figures.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from terastructure_tpu_torch import SVIConfig
from terastructure_tpu_torch.data import (GenotypeData, bed,
                                          simulate_packed_device)
from terastructure_tpu_torch.data.simulate import simulated_beta
from terastructure_tpu_torch.models import psd
from terastructure_tpu_torch.ops import fused_step, gather, stats_packed
from terastructure_tpu_torch.parallel.ranks import run_ranks
from terastructure_tpu_torch.svi import fit
from terastructure_tpu_torch.utils.labels import mean_abs_theta_error

CONFIGS = {        # benchmarks/baseline_configs.py:31-38
    1: dict(n=1000, l=10_000, k=3, batch=256),           # the canonical sim
    2: dict(n=940, l=640_000, k=7, batch=1024),          # HGDP shape
    3: dict(n=2504, l=1_000_000, k=8, batch=1024),       # TGP shape
    4: dict(n=500, l=5000, k=3, batch=256),               # the validator
    5: dict(n=1_000_000, l=1_000_000, k=10, batch=4096),  # big-N regime
}
COUNTED = (fused_step.fused_local_solve_dma, fused_step.fused_local_solve,
           gather.gather_row_blocks, stats_packed.lambda_stats_packed,
           stats_packed.lambda_stats_acat,
           stats_packed.batch_stats_fused_v2_packed,
           stats_packed.gamma_stats_packed,
           stats_packed.batch_stats_fused_packed)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def to_cache(packed, n, tmp):
    """Write packed (L, W) as tmp/sim.bed (+ .fam/.bim) and ingest it into
    the on-disk cache tmp/sim.cache.npy. Returns (the cache memmap, the
    write's seconds, the ingest's seconds)."""
    t0 = time.time()
    path = f"{tmp}/sim.bed"
    bed.write_bed(path, packed, n)
    bed.write_fam(f"{tmp}/sim.fam", range(n))
    bed.write_bim(f"{tmp}/sim.bim", range(packed.shape[0]))
    t1 = time.time()
    cache, _, _ = bed.bed_to_packed_cache(path, f"{tmp}/sim.cache.npy")
    return cache, t1 - t0, time.time() - t1


def run(config: int, *, device, max_steps: int = 20_000, scale: float = 1.0,
        batch_size: int | None = None, compute_dtype: str = "float32",
        stream: bool = False) -> dict:
    """Simulate, carve and fit `config`; return the record. scale shrinks
    N and L (keeping N % 4 == 0 and L % 8 == 0); batch_size overrides the
    config's (a small rehearsal); stream fits out of core from a .bed."""
    with (tempfile.TemporaryDirectory(prefix="converge_stream_") if stream
          else contextlib.nullcontext()) as tmp:
        return _fit(config, device, max_steps, scale, batch_size,
                    compute_dtype, tmp)


def _data(config, device, scale, tmp):
    """Simulate and carve `config` (a .bed and its cache in tmp, unless
    None). Returns (n, l, k, data, theta, the oracle's heldout ll, the
    I/O seconds, the seconds of it all)."""
    spec = CONFIGS[config]
    n = max(4, int(spec["n"] * scale) // 4 * 4)
    l = max(8, int(spec["l"] * scale) // 8 * 8)
    k = spec["k"]
    t0 = time.time()
    packed, theta = simulate_packed_device(n, l, k, seed=0, device=device)
    io = {}
    if tmp is not None:
        packed, io["bed_write_s"], io["ingest_s"] = to_cache(packed, n, tmp)
    data = GenotypeData.from_packed(
        packed, n, seed=0, validation_frac=0.005, heldout_frac=0.005,
        max_eval_entries=min(max(int(0.005 * n * l), 100), 200_000),
        eval_snp_pool=2048 if (n >= 50_000 or l >= 131_072) else 0)
    h = data.heldout
    beta = simulated_beta(n, l, k, seed=0)
    p = (theta[h.ind_idx] * beta[h.snp_idx]).sum(-1)
    oracle = float(psd.binomial2_loglik(torch.from_numpy(h.x),
                                        torch.from_numpy(p)).mean())
    return n, l, k, data, theta, oracle, io, time.time() - t0


def _reset_counts():
    for f in COUNTED:
        f.launches = f.twin_calls = 0
        for c in ("bf16_launches", "rep_launches"):
            if hasattr(f, c):
                setattr(f, c, 0)


def _counts():
    """The kernels' launch counts: f32 bodies, bf16 bodies, launches with
    the replicate axis (both dtypes), twin calls."""
    return {key: {f.__name__: getattr(f, attr, 0) for f in COUNTED}
            for key, attr in (("launches", "launches"),
                              ("bf16_launches", "bf16_launches"),
                              ("rep_launches", "rep_launches"),
                              ("twin_calls", "twin_calls"))}


def _fit(config, device, max_steps, scale, batch_size, compute_dtype, tmp):
    """run()'s body; tmp is the directory of the .bed and its cache, or
    None for a resident fit."""
    n, l, k, data, theta, oracle, io, sim_s = _data(config, device, scale,
                                                    tmp)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=min(
        batch_size or CONFIGS[config]["batch"], l), rfreq=100,
        max_steps=max_steps, seed=0, snp_group=8, compute_dtype=compute_dtype)
    _reset_counts()
    res = fit(cfg, data, device=device, stream=tmp is not None)
    counts = _counts()
    th = psd.theta_mean(res.state.gamma[:n]).cpu().numpy()
    chunk_s = sum(r["chunk_s"] for r in res.trace)
    return dict(
        config=config, n=n, l=l, k=k, batch_size=cfg.batch_size,
        compute_dtype=compute_dtype, stream=tmp is not None, **io,
        device=str(torch.device(device)), steps=res.steps,
        converged=res.converged, theta_mae=mean_abs_theta_error(th, theta),
        heldout_ll=res.heldout_ll, oracle_ll=oracle,
        validation_ll=res.validation_ll, wall_s=res.wall_s,
        chunk_s=chunk_s, eval_s=sum(r.get("eval_s", 0.0) for r in res.trace),
        checks=len(res.trace), sim_s=sim_s,
        snp_updates_per_s=res.steps * cfg.batch_size / chunk_s, **counts)


def run_validate(config: int, *, device, scale: float = 1.0,
                 sampler: str = "nuts", chains: int = 4,
                 n_samples: int = 500, n_warmup: int = 400,
                 svi_max_steps: int = 4000) -> dict:
    """Simulate and carve `config` (4: the validator) as run() does, unpack
    it to a dense matrix and run compare_svi_mcmc on it (its SVI settings:
    B = 64, rfreq 200, at most svi_max_steps steps); return the record."""
    from terastructure_tpu_torch.data.pack import unpack2bit
    from terastructure_tpu_torch.mcmc.validate import compare_svi_mcmc

    n, l, k, data, _, _, _, sim_s = _data(config, device, scale, None)
    x = unpack2bit(data.packed, n).T
    if sampler == "smc":
        kw = dict(n_particles=512, n_mutations=2, n_leapfrog=8,
                  mutation_eps=0.05)
    else:
        kw = dict(n_samples=n_samples, n_warmup=n_warmup, n_chains=chains)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=min(64, l),
                    max_steps=svi_max_steps, rfreq=200, seed=0)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    _reset_counts()
    rep = compare_svi_mcmc(x, k, sampler=sampler, seed=0, device=device,
                           svi_config=cfg, **kw)
    diag = rep.sampler_diag
    conv = diag.get("convergence", {})
    rec = dict(
        config=config, n=n, l=l, k=k, sampler=sampler,
        device=str(torch.device(device)), theta_mae=rep.theta_mae,
        beta_mae=rep.beta_mae, svi_steps=rep.svi_steps, svi_s=rep.svi_s,
        sampler_s=rep.sampler_s, sim_s=sim_s, peak_device_gb=(
            torch.cuda.max_memory_allocated(device) / 1e9 if on_card
            else None), **_counts())
    if sampler == "smc":
        rec.update(n_stages=diag["n_stages"], temps=diag["temps"],
                   acceptance=diag["acceptance"])
        return rec
    rec.update(
        chains=chains, n_samples=n_samples, n_warmup=n_warmup,
        warmup_s=diag["warmup_s"], sample_s=diag["sample_s"],
        leapfrog_warmup=diag["leapfrog_warmup"],
        leapfrog_sample=diag["leapfrog_sample"],
        accept_rate=diag["accept_rate"],
        divergence_rate=diag["divergence_rate"],
        eps=np.asarray(diag["eps"]).tolist())
    for name in ("theta", "beta"):
        if name in diag.get("max_split_rhat_all", {}):
            rec[f"max_rhat_all_{name}"] = diag["max_split_rhat_all"][name]
        if name in conv:
            rec[f"max_rhat_{name}"] = conv[name]["max_rhat"]
            rec[f"max_rank_rhat_{name}"] = conv[name]["max_rank_rhat"]
            rec[f"min_ess_{name}"] = conv[name]["min_ess"]
    return rec


# config 4 with NUTS at full size: twice the reference's MAE records
# (BASELINE.md:92), its R-hat and ESS acceptance limits
CONFIG4_LIMITS = dict(theta_mae=0.0125, beta_mae=0.0065, max_rhat_theta=1.05,
                      max_rhat_beta=1.05, min_ess_theta=50.0)


def _validate_rank(config, scale, sampler, chains, n_samples):
    """One rank of run_validate over ranks: the lead's record (None on the
    other ranks)."""
    from terastructure_tpu_torch.parallel import multihost

    rec = run_validate(config, device=multihost.device(), scale=scale,
                       sampler=sampler, chains=chains, n_samples=n_samples)
    return rec if multihost.process_index() == 0 else None


def run_validate_ranks(config: int, ranks: int, *, scale: float = 1.0,
                       sampler: str = "nuts", chains: int = 4,
                       n_samples: int = 500, timeout: float = 3000.0) -> dict:
    """run_validate over `ranks` ranks sharing the card through gloo
    (run_ranks): the lead's record, with `ranks`."""
    recs = run_ranks(ranks, _validate_rank,
                     (config, scale, sampler, chains, n_samples),
                     timeout=timeout, device=torch.device("cuda", 0))
    return dict(recs[0], ranks=ranks, shared_card=True)


def config4_misses(rec: dict) -> list:
    """The names of CONFIG4_LIMITS that the record misses (an upper limit,
    but min_ess_theta a lower one; a missing or NaN field misses)."""
    missed = []
    for name, limit in CONFIG4_LIMITS.items():
        v = float(rec.get(name, math.nan))
        if not (v > limit if name.startswith("min_") else v < limit):
            missed.append(name)
    return missed


def run_replicates(config: int, replicates: int, *, device,
                   max_steps: int = 20_000, scale: float = 1.0,
                   batch_size: int | None = None,
                   compute_dtype: str = "float32") -> list:
    """Simulate and carve `config` as run() does and fit seeds
    0..replicates-1 with fit_replicates_batched at the reference's
    replicates_ab.py settings (rfreq 100, snp_group 1). Returns one record
    per replicate and last the best replicate's, marked best=True. The
    batch's fields (wall, chunk and eval seconds, lockstep steps,
    SNP-updates/s of all replicates over the chunks, launch counts) are
    in every record."""
    from terastructure_tpu_torch.svi.replicates import fit_replicates_batched

    n, l, k, data, theta, oracle, _, sim_s = _data(config, device, scale,
                                                   None)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=min(
        batch_size or CONFIGS[config]["batch"], l), rfreq=100,
        max_steps=max_steps, seed=0, compute_dtype=compute_dtype)
    _reset_counts()
    res = fit_replicates_batched(cfg, data, range(replicates), device=device)
    chunk_s = sum(r["chunk_s"] for r in res.trace)
    steps = res.trace[-1]["step"] if res.trace else 0
    batch = dict(
        config=config, n=n, l=l, k=k, batch_size=cfg.batch_size,
        compute_dtype=compute_dtype, replicates=replicates,
        device=str(torch.device(device)), oracle_ll=oracle,
        lockstep_steps=steps, wall_s=res.wall_s, chunk_s=chunk_s,
        eval_s=sum(r.get("eval_s", 0.0) for r in res.trace),
        checks=len(res.trace), sim_s=sim_s,
        snp_updates_per_s=replicates * steps * cfg.batch_size / chunk_s,
        **_counts())
    out = []
    for i, rr in enumerate(res.replicates):
        th = psd.theta_mean(res.states.gamma[i]).cpu().numpy()
        out.append(dict(batch, seed=rr.seed, steps=rr.steps,
                        converged=rr.converged,
                        theta_mae=mean_abs_theta_error(th, theta),
                        heldout_ll=rr.heldout_ll,
                        validation_ll=rr.validation_ll))
    return out + [dict(out[res.best], best=True)]


def _sharded_rank(cfg, packed_path, validation, heldout, theta):
    """One rank of run_sharded: fit_sharded on this rank's block of the
    saved matrix; the lead's record (None on the other ranks)."""
    from terastructure_tpu_torch.parallel import fit_sharded
    from terastructure_tpu_torch.parallel import mesh as meshlib
    from terastructure_tpu_torch.parallel.sharded import gather_state

    mesh = meshlib.make_mesh(meshlib.choose_mesh_shape(
        cfg.ind_shards * cfg.snp_shards, cfg.ind_shards, cfg.snp_shards))
    data = GenotypeData(n=cfg.n, l=cfg.l,
                        packed=np.load(packed_path, mmap_mode="r"),
                        validation=validation, heldout=heldout)
    _reset_counts()
    res = fit_sharded(cfg, data, mesh=mesh)
    counts = _counts()
    full = gather_state(res.state, mesh, lamb=False)
    if not mesh.lead:
        return None
    th = psd.theta_mean(full.gamma[: cfg.n]).cpu().numpy()
    chunk_s = sum(r["chunk_s"] for r in res.trace)
    return dict(
        steps=res.steps, converged=res.converged,
        theta_mae=mean_abs_theta_error(th, theta),
        heldout_ll=res.heldout_ll, validation_ll=res.validation_ll,
        wall_s=res.wall_s, chunk_s=chunk_s,
        eval_s=sum(r.get("eval_s", 0.0) for r in res.trace),
        checks=len(res.trace),
        snp_updates_per_s=res.steps * cfg.batch_size / chunk_s, **counts)


def run_sharded(config: int, ranks: int, ind_shards: int, *,
                max_steps: int = 20_000, scale: float = 1.0,
                timeout: float = 3000.0) -> dict:
    """Simulate and carve `config` as run() does, then fit it with
    fit_sharded over `ranks` ranks (ind_shards x ranks / ind_shards)
    that share the one card through gloo (run_ranks): the multi-card
    program's results on one card. Its times are no speed figures: the
    ranks share the card's SMs and gloo copies through the host."""
    n, l, k, data, theta, oracle, _, sim_s = _data(config, "cuda", scale,
                                                   None)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=min(CONFIGS[config]["batch"], l),
                    rfreq=100, max_steps=max_steps, seed=0, snp_group=8,
                    ind_shards=ind_shards, snp_shards=ranks // ind_shards)
    with tempfile.TemporaryDirectory(prefix="converge_ranks_") as tmp:
        path = f"{tmp}/packed.npy"
        np.save(path, data.packed)
        recs = run_ranks(ranks, _sharded_rank,
                         (cfg, path, data.validation, data.heldout, theta),
                         timeout=timeout, device=torch.device("cuda", 0))
    return dict(config=config, n=n, l=l, k=k, batch_size=cfg.batch_size,
                ranks=ranks, mesh=dict(ind=ind_shards,
                                       snp=ranks // ind_shards),
                shared_card=True, oracle_ll=oracle, sim_s=sim_s, **recs[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=int, choices=sorted(CONFIGS), default=3)
    ap.add_argument("--max-steps", type=int, default=20_000)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--compute-dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--stream", action="store_true",
                    help="fit out of core from a .bed through an on-disk "
                         "cache (fit(stream=True))")
    ap.add_argument("--replicates", type=int, default=0, metavar="R",
                    help="fit seeds 0..R-1 in lockstep "
                         "(fit_replicates_batched); a record a replicate, "
                         "then the best's")
    ap.add_argument("--ranks", type=int, default=0,
                    help="fit with fit_sharded over this many ranks that "
                         "share the card through gloo (run_sharded); "
                         "config 4: split the chains over them")
    ap.add_argument("--ind-shards", type=int, default=1,
                    help="with --ranks: the grid's 'ind' axis")
    ap.add_argument("--sampler", choices=("nuts", "smc"), default="nuts",
                    help="config 4: the sampler held against SVI")
    ap.add_argument("--chains", type=int, default=4,
                    help="config 4, NUTS: chains (aligned R-hat/ESS)")
    ap.add_argument("--n-samples", type=int, default=500,
                    help="config 4, NUTS: samples a chain")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("converge: no CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    if args.config == 4:
        if args.ranks:
            rec = run_validate_ranks(4, args.ranks, scale=args.scale,
                                     sampler=args.sampler, chains=args.chains,
                                     n_samples=args.n_samples)
        else:
            rec = run_validate(4, device="cuda", scale=args.scale,
                               sampler=args.sampler, chains=args.chains,
                               n_samples=args.n_samples)
        if args.sampler == "nuts" and args.scale == 1.0:
            rec["missed_limits"] = config4_misses(rec)
        print(json.dumps(rec), flush=True)
        return 1 if rec.get("missed_limits") else 0
    if args.ranks:
        print(json.dumps(run_sharded(args.config, args.ranks, args.ind_shards,
                                     max_steps=args.max_steps,
                                     scale=args.scale)), flush=True)
        return 0
    if args.replicates:
        for rec in run_replicates(args.config, args.replicates,
                                  device="cuda", max_steps=args.max_steps,
                                  scale=args.scale,
                                  compute_dtype=args.compute_dtype):
            print(json.dumps(rec), flush=True)
        return 0
    print(json.dumps(run(args.config, device="cuda", max_steps=args.max_steps,
                         scale=args.scale, compute_dtype=args.compute_dtype,
                         stream=args.stream)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
