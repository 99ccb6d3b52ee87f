"""Command line (port of terastructure_tpu/cli.py): the same subcommands,
flags, defaults, run directory and files.

A fit creates the run directory ``n{N}-k{K}-l{L}-{label}/`` holding
infer.log, config.json, metrics.jsonl, validation.txt (the validation
log-likelihood trace), the text model gamma/theta/lambda/beta.txt,
checkpoint/ and result.json:

    python -m terastructure_tpu_torch.cli simulate -n 1000 -l 10000 -k 3 -o sim
    python -m terastructure_tpu_torch.cli fit --bed sim.bed -k 3 [--replicates 10]
    python -m terastructure_tpu_torch.cli fit --bed sim.bed -k 3 --resume --max-steps 40000
    python -m terastructure_tpu_torch.cli compute-beta --run-dir n1000-k3-l10000-run --bed sim.bed
    python -m terastructure_tpu_torch.cli pca --bed sim.bed --components 10
    python -m terastructure_tpu_torch.cli plot n1000-k3-l10000-run

Every subcommand that computes runs on the first CUDA card, and exits
non-zero naming the missing card where there is none; --force-cpu runs
it on the CPU (the kernels' plain twins). The workflow of R seeds that
keeps the best validation run is `fit --replicates R` (`--batched`: in
lockstep, svi/replicates.py). result.json adds `timings`, the seconds
of the fit's parts.

`validate` fits SVI and an MCMC sampler (NUTS, HMC, ChEES or SMC) on one
matrix and prints the label-aligned discrepancy of their moments as one
JSON line (mcmc/validate.compare_svi_mcmc):

    python -m terastructure_tpu_torch.cli validate --simulate -n 200 -l 1000 -k 3

With --distributed (or --coordinator) the lead fits SVI and broadcasts
it, the chains or particles are split over the ranks and the lead prints
the line:

    torchrun --nproc-per-node 4 -m terastructure_tpu_torch.cli validate \
        --simulate -n 200 -l 1000 -k 3 --chains 4 --distributed

Over several cards (parallel/), one process a card: started by torchrun,

    torchrun --nproc-per-node 8 -m terastructure_tpu_torch.cli fit \
        --bed big.bed -k 10 --distributed --snp-shards 8

or on each host with `--coordinator host:port --num-processes P
--process-id r`. Each rank reads only its block of the .bed; the lead
(rank 0) writes the run directory (gamma.txt, theta.txt, result.json
with `processes` and `mesh`), and `compute-beta --distributed` writes
beta.txt. In one process, `--ind-shards`/`--snp-shards` run the sharded
fit on one card (a world of one rank: a grid of 1 x 1 only).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
import time

import numpy as np
import torch

def _add_model_args(p):
    p.add_argument("-k", type=int, required=True, help="ancestral populations")
    p.add_argument("--alpha", type=float, default=None,
                   help="Dirichlet prior (default 1/K)")
    p.add_argument("--beta-a", type=float, default=1.0)
    p.add_argument("--beta-b", type=float, default=1.0)


def _add_svi_args(p):
    p.add_argument("--batch-size", type=int, default=256,
                   help="SNP minibatch per iteration")
    p.add_argument("--tau0", type=float, default=1.0)
    p.add_argument("--kappa", type=float, default=0.5)
    p.add_argument("--local-iters", type=int, default=None,
                   help="coordinate-ascent passes per minibatch. Default "
                        "7 with the Aitken accel (or 16 plain under "
                        "--no-accel). An EXPLICIT value runs the plain "
                        "schedule unless paired with --accel")
    p.add_argument("--accel", action="store_true",
                   help="pair an explicit --local-iters with the Aitken-"
                        "accelerated schedule")
    p.add_argument("--no-accel", action="store_true",
                   help="disable the Aitken-accelerated local solve "
                        "(SVIConfig.local_accel): the plain fixed-point "
                        "schedule (16 passes by default)")
    p.add_argument("--fast", action="store_true",
                   help="big-N throughput preset: approximate divides in "
                        "the exact statistics pass (stats_approx_div)")
    p.add_argument("--rfreq", type=int, default=100,
                   help="validation check every rfreq iterations")
    p.add_argument("--max-steps", type=int, default=20000)
    p.add_argument("--validation-frac", type=float, default=0.005)
    p.add_argument("--heldout-frac", type=float, default=0.005)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--label", default="run")
    p.add_argument("--out-base", default=".", help="where to create the run dir")
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--kernel", default="auto",
                   choices=["auto", "fused", "pallas", "dense"])
    p.add_argument("--init-mode", default="random",
                   choices=["random", "spectral"],
                   help="gamma init: random, or randomized-PCA + soft "
                        "k-means warm start")
    p.add_argument("--predictive", default="plugin",
                   choices=["plugin", "variational"],
                   help="heldout predictive: plug-in Binom(2, E[th]^T "
                        "E[beta]) or the proper variational form")
    p.add_argument("--lambda-mode", default="local",
                   choices=["local", "stored"],
                   help="local: lambda recomputed on demand (fast); "
                        "stored: warm start + scatter")
    p.add_argument("--ind-shards", type=int, default=0,
                   help="grid axis over individuals (hosts); 0 = auto")
    p.add_argument("--snp-shards", type=int, default=0,
                   help="grid axis over SNPs (the cards of a host); 0 = "
                        "auto")
    p.add_argument("--gamma-psum-dtype", default="f32",
                   choices=("f32", "bf16"),
                   help="precision of the gamma statistic's all-reduce over "
                        "'snp': bf16 halves its payload")
    p.add_argument("--force-cpu", action="store_true",
                   help="run on the CPU (tests/debug)")
    p.add_argument("--stream", action="store_true",
                   help="out-of-core fit: keep the packed matrix on the "
                        "host (a disk memmap for --bed) and stream "
                        "minibatches to the card (requires --lambda-mode "
                        "local)")
    p.add_argument("--stream-cache", default=None,
                   help="path for the on-disk packed cache of --bed "
                        "(default: <bed stem>.terapacked.npy)")
    p.add_argument("--eval-snp-pool", type=int, default=0,
                   help="restrict eval entries to this many unique SNPs "
                        "(bounds local-mode eval cost at big N; 0 = off)")
    _add_dist_args(p)


def _add_dist_args(p):
    p.add_argument("--distributed", action="store_true",
                   help="one process a card over torch.distributed "
                        "(torchrun's environment, or --coordinator)")
    p.add_argument("--coordinator", default=None,
                   help="coordinator address host:port, or an init-method "
                        "URL (tcp://, file://); implies --distributed")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)


def _add_data_args(p):
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--bed", help="PLINK .bed (with sibling .bim/.fam)")
    g.add_argument("--txt", help="text genotype matrix (SNP-major rows)")
    g.add_argument("--simulate", action="store_true",
                   help="fit a simulated PSD dataset (-n/-l required)")
    p.add_argument("-n", type=int, help="individuals (txt/simulate)")
    p.add_argument("-l", type=int, help="SNPs (txt/simulate)")
    p.add_argument("--idfile", default=None,
                   help="one individual ID per line; overrides .fam IDs "
                        "in every output")


def _device(args) -> torch.device:
    """The CPU under --force-cpu, else the first CUDA card; exits
    non-zero where there is none."""
    if args.force_cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("terastructure_tpu_torch: no CUDA card; pass "
                         "--force-cpu to run on the CPU")
    return torch.device("cuda")


def _load_data(args, *, seed: int):
    from terastructure_tpu_torch.data import GenotypeData
    from terastructure_tpu_torch.data.bed import read_text_genotypes
    from terastructure_tpu_torch.data.simulate import simulate_psd

    vf = getattr(args, "validation_frac", 0.005)
    hf = getattr(args, "heldout_frac", 0.005)
    pool = getattr(args, "eval_snp_pool", 0)
    if args.bed:
        if getattr(args, "stream", False):
            # out-of-core ingest: the .bed into an on-disk packed cache,
            # the eval sets carved on its memmap
            from terastructure_tpu_torch.data.bed import bed_to_packed_cache

            cache = (getattr(args, "stream_cache", None)
                     or os.path.splitext(args.bed)[0] + ".terapacked.npy")
            packed, ind_ids, snp_ids = bed_to_packed_cache(args.bed, cache)
            data = GenotypeData.from_packed(
                packed, len(ind_ids), validation_frac=vf, heldout_frac=hf,
                seed=seed, ind_ids=ind_ids, snp_ids=snp_ids,
                eval_snp_pool=pool)
        else:
            data = GenotypeData.from_bed(
                args.bed, validation_frac=vf, heldout_frac=hf, seed=seed,
                eval_snp_pool=pool)
    elif args.txt:
        x = read_text_genotypes(args.txt).T            # (N, L)
        if args.n and x.shape[0] != args.n:
            raise SystemExit(
                f"-n {args.n} does not match {x.shape[0]} individuals in "
                f"{args.txt}")
        data = GenotypeData.from_dense(
            x, validation_frac=vf, heldout_frac=hf, seed=seed,
            eval_snp_pool=pool)
    else:
        if not (args.n and args.l):
            raise SystemExit("--simulate requires -n and -l")
        _, _, x = simulate_psd(args.n, args.l, args.k, seed=seed)
        data = GenotypeData.from_dense(
            x, validation_frac=vf, heldout_frac=hf, seed=seed,
            eval_snp_pool=pool)
    idfile = getattr(args, "idfile", None)
    if idfile:
        with open(idfile) as f:
            ids = [ln.split()[0] for ln in f if ln.strip()]
        if len(ids) != data.n:
            raise SystemExit(
                f"--idfile has {len(ids)} IDs for {data.n} individuals")
        data = dataclasses.replace(data, ind_ids=ids)
    return data


def _setup_run_dir(cfg, base):
    run_dir = cfg.make_run_dir(base)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
        handlers=[
            logging.FileHandler(os.path.join(run_dir, "infer.log")),
            logging.StreamHandler(sys.stderr),
        ],
        force=True,
    )
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    return run_dir


def _cfg_from_args(args, n, l):
    from terastructure_tpu_torch.config import SVIConfig

    fast = getattr(args, "fast", False)
    # The accel default applies only at local_iters 7: an explicit
    # --local-iters runs the plain schedule unless --accel opts the
    # extrapolation back in.
    no_accel = getattr(args, "no_accel", False)
    want_accel = getattr(args, "accel", False)
    explicit_iters = args.local_iters is not None
    accel = (not no_accel) and (want_accel or not explicit_iters)
    iters = (args.local_iters if explicit_iters
             else (7 if accel else 16))
    if accel and iters < 3:
        accel = False              # extrapolation needs three iterates
    if explicit_iters and not (want_accel or no_accel):
        print(f"note: --local-iters {iters} runs the PLAIN fixed-point "
              "schedule; add --accel for the Aitken-accelerated solve "
              "or --no-accel to silence this note", file=sys.stderr)
    return SVIConfig(
        n=n, l=l, k=args.k, alpha=args.alpha,
        beta_a=args.beta_a, beta_b=args.beta_b,
        batch_size=min(args.batch_size, l),
        tau0=args.tau0, kappa=args.kappa,
        local_iters=iters,
        local_accel=accel,
        stats_approx_div=fast,
        rfreq=args.rfreq, max_steps=args.max_steps,
        validation_frac=args.validation_frac,
        heldout_frac=args.heldout_frac,
        compute_dtype=args.compute_dtype,
        predictive=args.predictive,
        kernel=args.kernel, lambda_mode=args.lambda_mode,
        ind_shards=args.ind_shards, snp_shards=args.snp_shards,
        gamma_psum_dtype=getattr(args, "gamma_psum_dtype", "f32"),
        seed=args.seed, label=args.label,
        init=getattr(args, "init_mode", "random"),
    )


def _fit_batched(args, cfg0, data0, packed, seeds, run_dir, dev, log):
    """`fit --replicates R --batched`: R seeds in lockstep; each
    replicate's result.json, the best one's text model and checkpoint,
    and best.json with its validation and heldout log-likelihoods.
    packed: the resident matrix, shared by the fit and the export."""
    from terastructure_tpu_torch.io.checkpoint import save_checkpoint
    from terastructure_tpu_torch.io.export import save_model
    from terastructure_tpu_torch.svi.postprocess import compute_lambda
    from terastructure_tpu_torch.svi.replicates import (
        fit_replicates_batched, unstack_state)

    if args.stream or args.resume:
        raise SystemExit("--batched replicates is a single-device "
                         "resident path (no --stream/--resume)")
    res_b = fit_replicates_batched(cfg0, data0, seeds, device=dev,
                                   packed=packed)
    for rep in res_b.replicates:
        sub = os.path.join(run_dir, f"replicate-s{rep.seed}")
        os.makedirs(sub, exist_ok=True)
        with open(os.path.join(sub, "result.json"), "w") as f:
            json.dump(dict(seed=rep.seed, converged=rep.converged,
                           steps=rep.steps, validation_ll=rep.validation_ll,
                           heldout_ll=rep.heldout_ll, batched=True),
                      f, indent=2)
    best = res_b.replicates[res_b.best]
    st = unstack_state(res_b.states, res_b.best)
    cfg_best = cfg0.replace(seed=best.seed)
    sub = os.path.join(run_dir, f"replicate-s{best.seed}")
    if cfg0.lambda_mode == "local":
        # the derived lambda of the selected replicate, once
        st = st._replace(lamb=compute_lambda(
            cfg_best, st.gamma[: cfg0.n], packed))
    save_model(sub, st.gamma, st.lamb, n=cfg0.n, l=cfg0.l,
               ind_ids=data0.ind_ids, snp_ids=data0.snp_ids)
    save_checkpoint(os.path.join(sub, "checkpoint"), st, cfg_best)
    log.info("batched replicates: best seed=%d validation_ll=%.6f "
             "(%.1fs for %d lockstep fits)", best.seed, best.validation_ll,
             res_b.wall_s, len(seeds))
    with open(os.path.join(run_dir, "best.json"), "w") as f:
        json.dump(dict(seed=best.seed, validation_ll=best.validation_ll,
                       heldout_ll=best.heldout_ll, batched=True,
                       dir=os.path.basename(sub)), f, indent=2)
    print(run_dir)


def _distributed(args) -> bool:
    return args.distributed or args.coordinator is not None


def _mesh(cfg, dev):
    """This rank's grid (cfg.ind_shards x cfg.snp_shards over the world);
    exits non-zero, naming the world size, where they do not fit it."""
    from terastructure_tpu_torch.parallel import mesh as meshlib
    from terastructure_tpu_torch.parallel import multihost

    try:
        spec = meshlib.choose_mesh_shape(multihost.process_count(),
                                         cfg.ind_shards, cfg.snp_shards)
    except ValueError as e:
        raise SystemExit(f"terastructure_tpu_torch: {e}") from None
    return meshlib.make_mesh(spec, device=dev)


def _initialize(args, dev):
    """Join the process group (--distributed/--coordinator); the rank's
    device."""
    from terastructure_tpu_torch.parallel import multihost

    return multihost.initialize(args.coordinator, args.num_processes,
                                args.process_id, device=dev.type)


def _fit_multiprocess(args, dev):
    """One rank of a multi-process `fit` (the same on every rank). Each
    rank reads only its block of the .bed (multihost.load_bed_shard); the
    lead writes the run directory with the gamma and theta text exports,
    result.json and the checkpoint (the whole padded state). Per-SNP
    lambda and beta come from the compute-beta post-pass, which reads
    that checkpoint."""
    from terastructure_tpu_torch.data.bed import read_bim, read_fam
    from terastructure_tpu_torch.io.checkpoint import save_checkpoint
    from terastructure_tpu_torch.io.export import _write_matrix
    from terastructure_tpu_torch.parallel import multihost
    from terastructure_tpu_torch.parallel.fit import fit_sharded
    from terastructure_tpu_torch.parallel.sharded import gather_state

    if not args.bed:
        raise SystemExit("multi-process fit requires --bed")
    stem = os.path.splitext(args.bed)[0]
    ind_ids = read_fam(stem + ".fam")
    snp_ids = read_bim(stem + ".bim")
    cfg = _cfg_from_args(args, len(ind_ids), len(snp_ids))
    mesh = _mesh(cfg, dev)
    ti = time.time()
    data = multihost.load_bed_shard(
        args.bed, cfg, mesh,
        validation_frac=cfg.validation_frac,
        heldout_frac=cfg.heldout_frac,
        eval_snp_pool=args.eval_snp_pool or 2048)
    ingest_s = round(time.time() - ti, 3)
    run_dir = _setup_run_dir(cfg, args.out_base) if mesh.lead else None
    log = logging.getLogger("terastructure_tpu_torch")
    res = fit_sharded(
        cfg, data, mesh=mesh, stream=args.stream,
        metrics_path=(os.path.join(run_dir, "metrics.jsonl") if mesh.lead
                      else None),
        trace_path=(os.path.join(run_dir, "validation.txt") if mesh.lead
                    else None))
    full = gather_state(res.state, mesh)
    if mesh.lead:
        # the whole padded state (lambda at the prior in the local mode):
        # what the compute-beta post-pass reads
        save_checkpoint(os.path.join(run_dir, "checkpoint"), full, cfg)
        gamma = full.gamma[: cfg.n].cpu().numpy()
        theta = gamma / gamma.sum(axis=1, keepdims=True)
        _write_matrix(os.path.join(run_dir, "gamma.txt"), gamma, ind_ids)
        _write_matrix(os.path.join(run_dir, "theta.txt"), theta, ind_ids)
        with open(os.path.join(run_dir, "result.json"), "w") as f:
            json.dump(
                dict(seed=cfg.seed, converged=res.converged, steps=res.steps,
                     validation_ll=res.validation_ll,
                     heldout_ll=res.heldout_ll, wall_s=res.wall_s,
                     processes=multihost.process_count(),
                     mesh=dict(ind=mesh.spec.ind, snp=mesh.spec.snp),
                     timings=dict(ingest_s=ingest_s, **res.timings)),
                f, indent=2)
        log.info("multi-process fit done: %s", run_dir)
        print(run_dir)


def cmd_fit(args):
    from terastructure_tpu_torch.io.checkpoint import (restore_checkpoint,
                                                       save_checkpoint)
    from terastructure_tpu_torch.io.export import (save_model,
                                                   state_from_text_model)
    from terastructure_tpu_torch.parallel import multihost
    from terastructure_tpu_torch.svi import fit
    from terastructure_tpu_torch.svi.engine import resident_packed

    dev = _device(args)
    if _distributed(args):
        try:
            dev = _initialize(args, dev)
            if multihost.process_count() > 1:
                return _fit_multiprocess(args, dev)
        finally:
            if multihost.process_count() > 1:
                torch.distributed.destroy_process_group()
    sharded = bool(args.ind_shards or args.snp_shards)
    ti = time.time()
    data0 = _load_data(args, seed=args.seed)
    ingest_s = round(time.time() - ti, 3)
    cfg0 = _cfg_from_args(args, data0.n, data0.l)
    run_dir = _setup_run_dir(cfg0, args.out_base)
    log = logging.getLogger("terastructure_tpu_torch")
    log.info("ingest: %.3f s", ingest_s)

    seeds = [args.seed + i for i in range(max(args.replicates, 1))]
    if args.stream and sharded:
        raise SystemExit("--stream is a single-device path; drop "
                         "--ind-shards/--snp-shards")
    if len(seeds) > 1 and args.batched and sharded:
        raise SystemExit("--batched replicates is a single-device resident "
                         "path (no --stream/--*-shards/--resume)")
    # one upload of the matrix for every replicate and the export
    packed = (None if args.stream or sharded
              else resident_packed(data0.packed, dev))
    if len(seeds) > 1 and args.batched:
        return _fit_batched(args, cfg0, data0, packed, seeds, run_dir, dev,
                            log)

    best = None
    for seed in seeds:
        cfg = cfg0.replace(seed=seed)
        # Replicates share one data split (comparable validation lls);
        # the seed varies the init and the minibatch stream only.
        data = data0
        sub = run_dir if len(seeds) == 1 else os.path.join(
            run_dir, f"replicate-s{seed}")
        os.makedirs(sub, exist_ok=True)
        log.info("fitting seed=%d -> %s", seed, sub)
        ckpt_dir = os.path.join(sub, "checkpoint")
        state = None
        if args.resume and os.path.exists(os.path.join(ckpt_dir,
                                                       "config.json")):
            state, ck_cfg = restore_checkpoint(ckpt_dir, device=dev)
            # The model's hyperparameters come from the checkpoint (they
            # define the run); the runtime controls stay with the flags.
            merged = ck_cfg.replace(
                max_steps=cfg.max_steps, rfreq=cfg.rfreq, label=cfg.label,
                conv_tol=cfg.conv_tol, conv_patience=cfg.conv_patience)
            if merged != cfg:
                log.warning("resume: using checkpointed model "
                            "hyperparameters")
            cfg = merged
            log.info("resuming from step %d", state.t)
        elif args.init_model:
            state = state_from_text_model(args.init_model, cfg, device=dev)
            log.info("initialized from text model %s", args.init_model)
        fit_kw = dict(state=state,
                      metrics_path=os.path.join(sub, "metrics.jsonl"),
                      trace_path=os.path.join(sub, "validation.txt"),
                      checkpoint_dir=ckpt_dir)
        if sharded:
            from terastructure_tpu_torch.parallel import fit_sharded

            res = fit_sharded(cfg, data, mesh=_mesh(cfg, dev), **fit_kw)
        else:
            res = fit(cfg, data, device=dev, packed=packed,
                      stream=args.stream, **fit_kw)
        log.info(
            "seed=%d converged=%s steps=%d validation_ll=%.6f heldout_ll=%s",
            seed, res.converged, res.steps, res.validation_ll,
            f"{res.heldout_ll:.6f}" if res.heldout_ll is not None else "n/a",
        )
        tw = time.time()
        save_model(sub, res.state.gamma, res.state.lamb, n=cfg.n, l=cfg.l,
                   ind_ids=data.ind_ids, snp_ids=data.snp_ids)
        write_s = time.time() - tw
        save_checkpoint(ckpt_dir, res.state, cfg)
        timings = dict(
            ingest_s=ingest_s,
            chunk_s=round(sum(r["chunk_s"] for r in res.trace), 3),
            eval_s=round(sum(r.get("eval_s", 0.0) for r in res.trace), 3),
            **res.timings, write_s=round(write_s, 3),
            checkpoint_s=round(time.time() - tw - write_s, 3))
        log.info("timings: %s", timings)
        with open(os.path.join(sub, "result.json"), "w") as f:
            json.dump(
                dict(seed=seed, converged=res.converged, steps=res.steps,
                     validation_ll=res.validation_ll,
                     heldout_ll=res.heldout_ll, wall_s=res.wall_s,
                     timings=timings),
                f, indent=2)
        if best is None or res.validation_ll > best[1]:
            best = (seed, res.validation_ll, sub, res.heldout_ll)
    if len(seeds) > 1:
        log.info("best replicate: seed=%d validation_ll=%.6f (%s)",
                 best[0], best[1], best[2])
        # selection by validation ll; the chosen replicate's heldout ll
        # is the quantity to compare
        with open(os.path.join(run_dir, "best.json"), "w") as f:
            json.dump(dict(seed=best[0], validation_ll=best[1],
                           heldout_ll=best[3],
                           dir=os.path.basename(best[2])), f, indent=2)
    print(run_dir)


def cmd_compute_beta(args):
    """beta.txt of a run directory from its checkpoint's gamma: lambda
    re-solved for every SNP with theta frozen (K4)."""
    from terastructure_tpu_torch.io.checkpoint import restore_checkpoint
    from terastructure_tpu_torch.io.export import _write_matrix
    from terastructure_tpu_torch.svi.engine import resident_packed
    from terastructure_tpu_torch.svi.postprocess import compute_beta
    from terastructure_tpu_torch.svi.stream import compute_beta_stream

    dev = _device(args)
    state, cfg = restore_checkpoint(os.path.join(args.run_dir, "checkpoint"),
                                    device=dev)
    if _distributed(args):
        return _compute_beta_multiprocess(args, state, cfg, dev)
    data = _load_data(args, seed=cfg.seed)
    if (data.n, data.l) != (cfg.n, cfg.l):
        raise SystemExit(
            f"data shape {(data.n, data.l)} != run config {(cfg.n, cfg.l)}")
    gamma = state.gamma[: cfg.n]
    if args.stream:
        beta = compute_beta_stream(cfg, gamma, data.packed)
    else:
        beta = compute_beta(cfg, gamma, resident_packed(data.packed, dev))
    out = os.path.join(args.run_dir, "beta.txt")
    _write_matrix(out, beta, data.snp_ids)
    print(out)


def _compute_beta_multiprocess(args, state, cfg, dev):
    """The sharded compute-beta post-pass: each rank reads only its block,
    lambda is solved with the individual sums all-reduced over 'ind', and
    the lead writes beta.txt (the reference's `-compute-beta`)."""
    from terastructure_tpu_torch.io.export import _write_matrix
    from terastructure_tpu_torch.models import psd
    from terastructure_tpu_torch.parallel import multihost, sharded

    if not args.bed:
        raise SystemExit("distributed compute-beta requires --bed")
    dev = _initialize(args, dev)
    try:
        mesh = _mesh(cfg, dev)
        data = multihost.load_bed_shard(args.bed, cfg, mesh,
                                        validation_frac=0, heldout_frac=0)
        plan, packed = sharded.prepare(cfg, data, mesh)
        st = sharded.shard_state(state, plan, mesh)
        lamb = sharded.make_sharded_compute_lambda(cfg, plan, mesh)(
            st.gamma, packed)
        full = sharded.gather_state(st._replace(lamb=lamb), mesh)
        if mesh.lead:
            beta = psd.beta_mean(full.lamb[: cfg.l]).cpu().numpy()
            out = os.path.join(args.run_dir, "beta.txt")
            _write_matrix(out, beta)
            print(out)
    finally:
        if multihost.process_count() > 1:
            torch.distributed.destroy_process_group()


def cmd_simulate(args):
    from terastructure_tpu_torch.data.bed import write_bed, write_bim, write_fam
    from terastructure_tpu_torch.data.pack import pack2bit
    from terastructure_tpu_torch.data.simulate import simulate_psd
    from terastructure_tpu_torch.io.export import _write_matrix

    theta, beta, x = simulate_psd(
        args.n, args.l, args.k, alpha=args.alpha,
        beta_a=args.beta_a, beta_b=args.beta_b,
        missing_frac=args.missing_frac, seed=args.seed,
        structured=not args.unstructured,
    )
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    packed = pack2bit(np.ascontiguousarray(x.T))
    write_bed(args.out + ".bed", packed, args.n)
    write_fam(args.out + ".fam", [f"ind{i}" for i in range(args.n)])
    write_bim(args.out + ".bim", [f"snp{j}" for j in range(args.l)])
    _write_matrix(args.out + ".theta_true.txt", theta)
    if args.l <= 100_000:
        _write_matrix(args.out + ".beta_true.txt", beta)
    else:  # a text export of 1M rows takes seconds; npy is instant
        np.save(args.out + ".beta_true.npy", beta)
    print(args.out + ".bed")


def cmd_pca(args):
    """EIGENSTRAT-style principal components of the genotype matrix
    (Patterson, Price and Reich 2006): the randomized SVD of
    svi/init.pca_embedding over the packed matrix on the card."""
    from terastructure_tpu_torch.io.export import _write_matrix
    from terastructure_tpu_torch.svi.engine import resident_packed
    from terastructure_tpu_torch.svi.init import pca_embedding

    dev = _device(args)
    data = _load_data(args, seed=args.seed)
    e = pca_embedding(resident_packed(data.packed, dev), data.n,
                      args.components + 1, seed=args.seed, l_real=data.l)
    out = args.out or "pcs.txt"
    _write_matrix(out, e.cpu().numpy(), data.ind_ids)
    print(out)


def cmd_plot(args):
    from terastructure_tpu_torch import viz

    viz.main([args.source, "-o", args.out]
             + (["--no-sort"] if args.no_sort else []))


def cmd_validate(args):
    """SVI against a sampler on the same dense matrix: the reference's
    JSON (theta_mae, beta_mae, svi_steps, sampler, and with several
    chains the aligned R-hat/ESS summary). As in the reference, the SVI
    fit takes compare_svi_mcmc's own settings, not the SVI flags.

    --distributed (torchrun's environment, or --coordinator): every rank
    loads the same matrix, the lead fits SVI and broadcasts it, the
    chains (particles) are split over the ranks (mcmc/chains.py), and
    the lead prints the JSON line."""
    from terastructure_tpu_torch.data.pack import unpack2bit
    from terastructure_tpu_torch.mcmc.validate import compare_svi_mcmc
    from terastructure_tpu_torch.parallel import multihost

    if args.ind_shards or args.snp_shards:
        raise SystemExit("validate splits chains over the ranks: no "
                         "--ind-shards or --snp-shards")
    dev = _device(args)
    if _distributed(args):
        dev = _initialize(args, dev)
    try:
        data = _load_data(args, seed=args.seed)
        x = unpack2bit(data.packed, data.n).T
        if args.sub_n or args.sub_l:
            x = x[: args.sub_n or x.shape[0], : args.sub_l or x.shape[1]]
        kw = {}
        if args.sampler in ("nuts", "hmc", "chees"):
            kw = dict(n_samples=args.n_samples, n_warmup=args.n_warmup,
                      n_chains=args.chains)
        rep = compare_svi_mcmc(x, k=args.k, sampler=args.sampler,
                               seed=args.seed,
                               warm_start=not args.cold_start, device=dev,
                               **kw)
        out = dict(theta_mae=rep.theta_mae, beta_mae=rep.beta_mae,
                   svi_steps=rep.svi_steps,
                   sampler=args.sampler)
        conv = rep.sampler_diag.get("convergence")
        if conv:
            out["convergence"] = {k_: {m: round(float(v), 4)
                                       for m, v in d.items()}
                                  for k_, d in conv.items()}
        if multihost.process_index() == 0:
            print(json.dumps(out))
    finally:
        if multihost.process_count() > 1:
            torch.distributed.destroy_process_group()


def _translate_legacy(argv):
    """Translate reference-binary flags to the fit subcommand.

    The upstream command line looks like
        terastructure -file g.bed -n 1000 -l 10000 -k 3 -label x \\
                      -rfreq 100 -seed 7 [-force] [-compute-beta]
    and is detected when the first token is such a flag.
    """
    known = {"-file", "-n", "-l", "-k", "-label", "-rfreq", "-seed",
             "-force", "-compute-beta", "-nthreads", "-idfile"}
    if not argv or argv[0] not in known:
        return None
    flags = {}
    i = 0
    while i < len(argv):
        tok = argv[i]
        if tok in ("-force", "-compute-beta"):
            flags[tok] = True
            i += 1
        elif tok in known:
            flags[tok] = argv[i + 1]
            i += 2
        else:
            i += 1
    if "-file" not in flags or "-k" not in flags:
        raise SystemExit("legacy mode needs at least -file and -k")
    out = ["fit", "--bed", flags["-file"], "-k", str(flags["-k"])]
    if flags.get("-compute-beta"):
        raise SystemExit(
            "legacy -compute-beta: use `compute-beta --run-dir ... --bed ...`")
    if "-label" in flags:
        out += ["--label", flags["-label"]]
    if "-rfreq" in flags:
        out += ["--rfreq", str(flags["-rfreq"])]
    if "-seed" in flags:
        out += ["--seed", str(flags["-seed"])]
    if "-idfile" in flags:
        out += ["--idfile", flags["-idfile"]]
    # -n/-l are read from .fam/.bim; -nthreads has no meaning here
    return out


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    legacy = _translate_legacy(list(argv))
    if legacy is not None:
        print(f"[legacy flags] -> {' '.join(legacy)}", file=sys.stderr)
        argv = legacy
    ap = argparse.ArgumentParser(
        prog="terastructure_tpu_torch",
        description="SVI for the PSD/admixture model on a CUDA card",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("fit", help="fit the model with SVI")
    _add_data_args(p)
    _add_model_args(p)
    _add_svi_args(p)
    p.add_argument("--replicates", type=int, default=1,
                   help="multi-seed replicates; keep best validation ll")
    p.add_argument("--batched", action="store_true",
                   help="run all replicates in lockstep on one card "
                        "(svi/replicates.py): one packed matrix, one "
                        "launch sequence a step for all R")
    p.add_argument("--resume", action="store_true",
                   help="resume from the run dir's checkpoint")
    p.add_argument("--init-model", default=None,
                   help="continue from a TEXT model dir (gamma.txt [+ "
                        "lambda.txt]) of either package")
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser("compute-beta",
                       help="refit per-SNP beta with theta frozen")
    p.add_argument("--run-dir", required=True)
    _add_data_args(p)
    p.add_argument("-k", type=int, required=False, help="(ignored; from run)")
    p.add_argument("--force-cpu", action="store_true")
    p.add_argument("--stream", action="store_true",
                   help="out-of-core post-pass over a host-side matrix")
    p.add_argument("--stream-cache", default=None)
    _add_dist_args(p)
    p.set_defaults(fn=cmd_compute_beta)

    p = sub.add_parser("simulate", help="draw a PSD dataset, write PLINK files")
    p.add_argument("-n", type=int, required=True)
    p.add_argument("-l", type=int, required=True)
    _add_model_args(p)
    p.add_argument("--missing-frac", type=float, default=0.0)
    p.add_argument("--unstructured", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-o", "--out", required=True, help="output path stem")
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("pca", help="top principal components of the "
                       "genotype matrix (randomized SVD on the card)")
    _add_data_args(p)
    p.add_argument("--components", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--force-cpu", action="store_true")
    p.add_argument("-o", "--out", default=None, help="output text path")
    p.set_defaults(fn=cmd_pca)

    p = sub.add_parser("plot", help="STRUCTURE-style admixture bar plot")
    p.add_argument("source", help="run dir (with theta.txt) or a theta.txt")
    p.add_argument("-o", "--out", default="admixture.png")
    p.add_argument("--no-sort", action="store_true")
    p.set_defaults(fn=cmd_plot)

    p = sub.add_parser("validate", help="SVI vs NUTS/HMC/SMC moments")
    _add_data_args(p)
    _add_model_args(p)
    _add_svi_args(p)
    p.add_argument("--sampler", default="nuts",
                   choices=["nuts", "hmc", "chees", "smc"])
    p.add_argument("--sub-n", type=int, default=0, help="subsample individuals")
    p.add_argument("--sub-l", type=int, default=0, help="subsample SNPs")
    p.add_argument("--n-samples", type=int, default=500)
    p.add_argument("--n-warmup", type=int, default=400)
    p.add_argument("--chains", type=int, default=4,
                   help="NUTS/HMC chains (label-aligned R-hat/ESS "
                        "reported when > 1)")
    p.add_argument("--cold-start", action="store_true",
                   help="disable the SVI warm-start/mass preconditioner")
    p.set_defaults(fn=cmd_validate)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
