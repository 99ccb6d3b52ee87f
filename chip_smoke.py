"""Drive the PyTorch + CUDA port on one H100 and check it end to end.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card of compute
capability 9.0. Phases, each of which must pass (no phase is caught):

0. the card (nvidia-smi name and power limit), torch and CUDA versions,
   and the nvcc build of csrc/*.cu;
1. every kernel of the main path against its plain PyTorch twin on the
   same inputs at main-path shapes, with errors, times, the library
   call's time where one exists, and each kernel's bound (the larger of
   its FP32 operations at 67 TFLOP/s and its bytes at 3.35 TB/s); K2
   also bitwise against K1 on the gathered rows; the lambda pass alone
   (one launch of the body K1, K2, K4 and K8 share) and the gamma pass
   alone (K1's and K2's last pass, through K5's entry; at K = 72 and
   config #3's width too, f32 and bf16, held to its twin first) timed at
   the shapes the paths run them, beside their bounds; K7 at the big-N shape
   at K = 8, 10 and 16; K7 (both divides) and K5 against their twins at
   K = 9, 10, 12 and 13, where the K-width of 12 begins and ends, with a
   bitwise re-run of each; K1, K2, K4 and K8 against their
   twins on ragged B, odd W, K = 3..33, whole rows MISSING and a null
   group, with a bitwise re-run of each; K3 against `index_select` in
   turns, from a CUDA graph and eagerly, and at odd W (the 8-byte path)
   and G = 1; the K > 64 bodies (the λ pass's, through K1, K2, K4 and
   K8, at K = 65, 72, 96, 128, 129, 256 and 1000, K7 at K = 65..1000 too,
   at f32 and bf16 with both divides; the γ pass's through K5 at K = 72,
   130 and 256, both dtypes; K6 at K = 72, 130 and 256, both dtypes
   (K6 is K7's launch at the exact divide: wherever it runs it is held
   bitwise to K7 there); K8 at the big-N
   step's subsample and K7 and K5 at the big-N shape with K = 72, both
   dtypes (and divides); against their twins and their own
   second runs; one timed shape per family); the bf16 bodies
   (compute_dtype="bfloat16") of K1, K2, K4 and of the λ and γ passes
   against their bf16 twins at the TGP shape, config #1's and config #3's
   K2 step, ragged B, odd W, K = 3..33 and 72, rows MISSING, a null group,
   both divides and the stored-λ warm start, each re-run bitwise and
   pinned against the f32 body on the same inputs (the rounding happened,
   and stayed within bf16's scale), K2[bf16] bitwise K1[bf16]; their times
   in turns with the f32 bodies, beside the bf16 bounds; the bf16 bodies of
   the big-N step, K7 (both divides), K6, K5 and K8 (both divides), the
   same way at the big-N shape, a ragged B (4,092), K = 3, 8, 16 and 72,
   rows MISSING;
2. the canonical config #1 fit (1000 x 10K, K=3) through `fit`: converged,
   theta MAE < 0.05, heldout within 0.02 of the oracle; 2b. the same in
   the stored lambda mode (K1 warm-started, no K4); 2c. one chunk at
   K = 72 through the fused branch (K1's wide bodies, no twin), re-run
   bitwise equal;
3. the TGP-shape fit (2504 x 1M, K=8, B=4096, 200 steps): SNP-updates/s,
   launch counts of K1, K3 and K4 > 0 with no twin run, and one chunk
   re-run twice from the same state bitwise equal;
4. the big-N fit (100K x 100K, K=10, B=4096, snp_group=8, 300 steps),
   which the fused gate refuses: K1 never launches, K3, K4, K7 and K8 do
   with no twin run; then one step each with stats_kernel "pair" (K4 +
   K5), "fused" (K6) and "fused_v2" (K7) from one state, their gammas
   within 1e-4, and one chunk re-run twice bitwise equal; 4b. one step at
   K = 72 and B = 4,092 on the same data (the big-N path, the tol test
   padded as the reference pads B; K8's and K7's wide bodies), re-run
   bitwise equal;
5. config #3 as the reference's acceptance runner sets it (2504 x 1M,
   K=8, B=1024, snp_group=8; phase 3's data): (a) 200 steps in the local
   mode, K2 once a step, K1 and K3 never, K4 for the eval; (b) 100 steps
   in the stored mode from a fresh state, K2 warm-started, the lambda
   rows of the sampled groups off the prior and every other row bitwise
   at it; (c) one chunk re-run twice from a cloned state, bitwise equal,
   in each mode;
6. compute_dtype "bfloat16": config #1 to convergence in both lambda
   modes (K1[bf16], K4[bf16]; phase 2's quality limits) and config #3 for
   200 steps through K2[bf16] (and 100 in the stored mode), each beside
   its f32 run; no f32 body of K1, K2 or K4 and no twin runs;
7. compute_dtype "bfloat16" on phase 4's data: the big-N fit for 300
   steps in the local mode (K3, K8[bf16] and K7[bf16]; K4[bf16] for the
   eval and export), its heldout within BIGN_BF16_HELDOUT_GAP of phase
   4's, and for 100 in the stored mode, no f32 body of K4-K8 and no twin;
   one step each with stats_kernel "pair" (K4[bf16] + K5[bf16]), "fused"
   (K6[bf16]) and "fused_v2" (K7[bf16]) from one state, their gammas
   within the bf16 pass tolerance; one chunk re-run twice bitwise equal;
8. out-of-core streaming (svi/stream.py) from a PLINK .bed through an
   on-disk cache, in a temporary directory removed at the end: (a) phase
   4's matrix, re-simulated from seed 0, written with `write_bed`,
   ingested with `bed_to_packed_cache` into an np.memmap and carved there
   (its eval sets and carved bytes equal phase 4's), then
   fit(stream=True) for 300 steps: K7 and K8 every step, K4 in the eval
   and export, K1, K2 and K3 never, no twin; the heldout within
   STREAM_HELDOUT_GAP of phase 4's resident fit; the device batches of
   steps 0-2 bitwise the rows of SeedSequence((0, t))'s draw; one
   streamed step bitwise step_core_packed + _global_update on its rows;
   one chunk re-run bitwise; the streamed step's, the gather's and the
   copy's ms beside phase 4's step; (b) the same data at bf16 for 100
   steps, no f32 body of K4-K8; (c) config #5's width of N (1M
   individuals, W = 250,000 bytes) with L cut to 16,384 so that the .bed
   is 4.1 GB, not 250 GB: 20 streamed steps at rfreq 10, the launches
   of (a), the step, gather and copy ms and the export's seconds, and K7
   at the step's shape and K4 at the export's block against their twins
   (summed over 256-row slices) with their times and bounds;
9. batched replicates (`fit_replicates_batched`, R_REP = 4 seeds in
   lockstep; `phase_replicates`): (a) config #1 to convergence in the
   local mode against a single fit per seed (stop step, gamma at the
   stop bitwise, validation ll within 1e-6, the same best), each within
   phase 2's limits, K1 and K4 launched only with the replicate axis, no
   twin, no K2 or K3, and the batched step's ms against R single steps
   in turns; (b) the stored mode, R = 3, 100 steps, gamma and lambda
   bitwise; (c) bf16, 100 steps, bitwise, no f32 body; (d) config #2's
   width (940 x 640,000, K = 7, B = 1,024) to convergence, each
   replicate's stop, scores and theta MAE, the best within theta MAE
   0.02 and 0.02 nats of the oracle and bitwise its single fit;
10. the command line (`cli.main`, as `python -m
   terastructure_tpu_torch.cli` runs it; `phase_cli`) from PLINK files in
   a temporary directory removed at the end: (a) config #1 through
   `simulate` and `fit` (the run directory's files, converged, theta MAE
   < 0.05 against theta_true.txt, heldout within 0.02 of the oracle; K1
   and K4 only), `compute-beta` (its beta.txt the fit's, text for text),
   `fit --replicates 2 --batched` (a finite heldout in best.json) and
   `fit --stream` at N = 32,768 (K7, K8, K4); (b) `fit --resume` from
   400 to 800 steps against a straight 800, gamma.txt and lambda.txt byte
   for byte, in both lambda modes, and a checkpoint saved asynchronously
   at a mid-fit check restored bitwise to that check's state; (c) config
   #3's width (2,504 x 1M, K = 8) from a .bed written from
   simulate_packed_device, `fit --batch-size 1024 --eval-snp-pool 2048
   --init-mode spectral` to convergence (K1, K3, K4; theta MAE < 0.02,
   heldout within 0.02 of the oracle) with its seconds by part, the
   spectral init's own PCA and k-means seconds and theta MAE, a
   random-init `fit` at the same settings, and `pca --components 10`,
   whose first 7 columns, the init's embedding and the exact top
   principal subspace (the Gram matrix's eigenvectors) agree as
   subspaces (every principal cosine >= PCA_SUBSPACE_COS).
11. batched replicates on the big-N path (`phase_replicates_bign`, on
   phase 4's data): (a) the local mode, R_REP = 4 seeds, 300 steps,
   against a single fit per seed with dma_gather=False (gamma, every
   check's validation ll and the heldout bitwise, both scored with the
   batched scorer's eval subsample), K8, K7 and K4 launched only with the
   replicate axis, no twin; the batched step's ms in turns with R single
   steps, the 2R generators' host ms a step; (b) the stored mode, R = 2,
   100 steps, snp_group 8, gamma and lambda bitwise; (c) bf16, R = 2, 100
   steps, bitwise, no f32 body of K4-K8; (d) one step each with
   stats_kernel "pair" (K4[rep] + K5[rep]) and "fused" (K6[rep]), bitwise
   the single steps; (e) config #5's width (N = 1M resident, L cut to
   16,384), R = 2, 20 steps, bitwise the single fits, with the step's ms
   and the peak device memory.
12. the MCMC validators (mcmc/; `phase_validate`): (a) PSDPotential's
   value and gradient at config #4's shape (500 x 5,000, K = 3, 4 chains,
   float64 sums) with TF32 allowed for matmuls, against the same
   potential in float64 on the CPU, within limits that TF32-rounded
   operands miss (their errors and those of a plain matmul printed
   beside); (b) HMC and NUTS on the reference's conjugate K = 1 problem,
   posterior means within 0.03 of the exact ones, and a short 2-chain
   NUTS run re-run bitwise; (c) compare_svi_mcmc at the reference's
   scaled validator shapes, NUTS at 200 x 1,000 (2 chains, 200 + 200) and
   SMC at 80 x 300 (256 particles), K = 3: theta MAE against SVI under
   0.05 and 0.08, the SVI fit's K1 and K4 launches, no twin; (d) `cli
   validate --simulate` prints the reference's JSON keys.
13. the multi-card fit (parallel/; `phase_sharded`): (a) one rank over
   NCCL (world size 1): an NCCL all-reduce, then fit_sharded at config
   #3's width (2,504 x 1M, K = 8, B = 1,024) for 200 steps (K1 and K4),
   re-run bitwise; then four spawned ranks that share the card through
   gloo with CUDA tensors (NCCL refuses two ranks on one GPU), each
   with a timeout, every rank's failure raised here: (b) at (1, 4) on
   config #3's width (B_local 256, 250,000 rows x 640 bytes a rank) one
   step at local_tol 0, its reduced gamma statistic within 2e-4 of the
   largest magnitude of the single-device K1 step's on the same 1,024
   rows, gamma bitwise equal on the four ranks; (c) at (2, 2) on phase
   4's data (the config-5 regime, 100K x 100K, K = 10, B = 4,096;
   W_local 12,544, L_local 50,000) one step at local_sub_n 0,
   kernel "pallas" and local_tol 0 against step_core_packed on the same
   rows, the statistic within 2e-4 the same way; then 200 steps with the
   default subsample (K8 and K7 on every rank) and the sharded
   compute-beta of each rank's 50,000 rows (K4 on every rank), the 200
   steps re-run bitwise. Its times are no speed figures: four processes
   share one card's SMs, and gloo copies every all-reduce through the
   host.
14. batched replicates at K > 64 and with kernel="dense"
   (`phase_replicates_wide`): (a) the fused branch at config #3's width
   (2,504 x 1M, phase 3's data), K = 72, B = 1,024, snp_group 1, R = 4:
   100 steps of fit_replicates_batched's chunk runner, K1[rep] once a
   step (its K > 64 passes), K2 and K3 never, no twin, each replicate
   bitwise its single 100 steps, then one batched eval through K4[rep],
   each score its single scorer's; (b) the big-N branch on phase 4's
   data, K = 72, B = 4,096, R = 2: 10 steps, K8[rep] 7 and K7[rep] 1 a
   step, bitwise the single steps, the step's ms and the peak device
   memory; (c) kernel="dense" at config #1, R = 4: one chunk bitwise the
   single dense chunks (no kernel launches: the dense step has none),
   then the batched eval (K4[rep]); (d) `cli fit --replicates 4
   --batched -k 72 --max-steps 2000` at config #1: best.json names the
   replicate with the best validation ll.
15. the rest of the multi-card slice (`phase_chains`): (a) MCMC chains
   and SMC particles over ranks (mcmc/chains.py): four spawned ranks
   sharing the card through gloo each call compare_svi_mcmc as `cli
   validate --distributed` does (the lead fits SVI through K1 and K4
   and broadcasts it; the chains or particles are split), NUTS at 200 x
   1,000, K = 3, 4 chains (one a rank), and SMC at 80 x 300 with 64
   particles, each twice: the second run bitwise the first on every rank,
   the generator calls equal on every rank (lockstep), the moments within
   CHAINS_MOMENT_TOL of the one-rank run in this process and within
   phase 12's theta MAE limits of SVI; then the one-rank SMC again inside
   a process group of one NCCL rank, bitwise the run without a group;
   (b) the multi-rank dry run (parallel/dryrun.py) over four ranks
   sharing the card: its four passes (the default step at (2, 2), the
   fused branch through K1, the big-N step through K3, K8, K4 and K7, the
   pipelined bf16 all-reduce), each on its named branch by the launch
   counters, with finite gamma > 0 and log-likelihood; (c) the biobank
   demo's resident fit: N = 1,000,448, L = 32,768, K = 10, simulated on
   the card (simulate_packed_device_resident, 8.2 GB, bitwise
   simulate_packed_device at a small shape first), carved there
   (carve_eval_device) and fitted for 300 big-N steps with the demo's
   settings (K3, K8, K7; K4 in the eval and export), the matrix and the
   eval rows never on the host, the seconds of each part, the step time
   and the peak device memory.
Phase 1 also holds K1 and K4 with the replicate axis (R = 4) at the
shapes phase 9 runs them at (config #1's and config #2's step and eval
block, W = 256), the TGP step and a ragged B, f32 and bf16: every replicate
bitwise the single call on its inputs, a replicate that exits its tol
loop alone, times in turns with R single calls beside R x the single
bound (`phase_kernels_rep`); and K8, K7, K5 and K6 with the axis (R = 4)
at the big-N step's shape (K8 on the subsample's count planes), a
ragged B = 4,092 and K = 3 and 16, f32 and bf16, each replicate bitwise
its single call, re-runs bitwise, held to the twins, timed in turns with
R single calls at the step's shape (`phase_kernels_rep_bign`); and the
K > 64 bodies with the axis (`phase_kernels_rep_wide`): K1, K4, K5,
K6, K7 and K8 at R = 4, K = 72 and 256 (K7 at 128 too), f32 and bf16, each
replicate bitwise its single wide call, held to the twins, then timed
at K = 72 in turns with R single calls at the batched paths' shapes
(K1 and K4 at config #3's width, B = 1,024; K8 on the big-N step's
subsample; K5-K7 at the big-N step's shape), beside the bounds.

Prints the kernels' JSON line (the bf16 bodies as entries of their own,
"fused_local_solve[bf16]" and so on, the replicate axis as
"fused_local_solve[rep]", "lambda_stats_packed[rep]",
"lambda_stats_acat[rep]", "batch_stats_fused_v2_packed[rep]",
"gamma_stats_packed[rep]" and "batch_stats_fused_packed[rep]"), the
card line, and last
{"ok": true, "device": {...}}. Exits non-zero without a result when there
is no CUDA card.

    python3 chip_smoke.py --kernels

stops after phase 1 and prints the kernels' line (without launch counts)
and the card line: the quick check and timing of a changed kernel. It also
times the lambda pass at other column splits than the one `lambda_grid`
chooses, at K <= 64 (f32 and bf16, and K8 on the big-N subsample) and at
K > 64 (`split_sweep`), and the γ pass at other row splits than
`gamma_grid`'s, at K <= 64 and K > 64, f32 and bf16
(`gamma_split_sweep`).

    python3 chip_smoke.py --digest

prints a digest of each kernel's outputs on seeded inputs at K <= 64 and
at K = 72 (the K > 64 bodies), the eager time of the K3 and K4
wrappers and the host cost of the calls they make for the device and
the stream, the device time of K7 and K8 at bf16 at the big-N shapes,
of K7 at K > 64 (the big-N shape at K = 72, B = 1,024 W = 2,048
K = 256, and R = 4 at K = 72; f32 and bf16), of the λ pass at K > 64
(`wide_lambda_ms`: K8 on the big-N subsample, single and R = 4; K4 at
config #3's width, K = 72 and 256; K1 there on the accel schedule; f32
and bf16) and of the γ pass at K > 64 (`wide_gamma_ms`: K5 at the big-N
shape with K = 72, single and R = 4; the γ pass alone at config #3's
width with K = 72; f32 and bf16), of K6 (`k6_ms`: the big-N shape at
K = 10 and 72, single and R = 4, K7 beside it at K = 10; f32 and bf16)
and of the big-N step with stats_kernel "fused" (K6) and "fused_v2"
(K7) at K = 10 and 72 (`bign_step_ms`), and of the λ and γ passes at
K <= 64 (`narrow_ms`: K5 at the big-N shape, the passes alone at the TGP
and config #3 shapes, K1, K2, K4 and K8 at their paths' shapes, K1, K4
and K5 with R = 4; f32 and bf16), through the wrappers only:
a copy of this script run from
another tree's root (an earlier commit unpacked with `git archive`)
prints that tree's bits and times.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from terastructure_tpu_torch import SVIConfig, _build, cli
from terastructure_tpu_torch.converge import card_line
from terastructure_tpu_torch.data import (GenotypeData, bed,
                                          simulate_packed_device, simulate_psd)
from terastructure_tpu_torch.data.pack import packed_width
from terastructure_tpu_torch.data.simulate import simulated_beta
from terastructure_tpu_torch.io.checkpoint import restore_checkpoint
from terastructure_tpu_torch.io.export import load_matrix
from terastructure_tpu_torch.mcmc import PSDPotential, run_hmc, run_nuts
from terastructure_tpu_torch.mcmc import hmc as mcmc_hmc
from terastructure_tpu_torch.mcmc.potential import f32_product, init_params
from terastructure_tpu_torch.mcmc.validate import compare_svi_mcmc
from terastructure_tpu_torch.models import psd
from terastructure_tpu_torch.ops import fused_step, gather, stats_packed
from terastructure_tpu_torch.ops.stats_dense import exp_elog_theta
from terastructure_tpu_torch.parallel import dryrun, fit_sharded, multihost
from terastructure_tpu_torch.parallel import mesh as meshlib
from terastructure_tpu_torch.parallel import sharded
from terastructure_tpu_torch.parallel import stream as pstream
from terastructure_tpu_torch.parallel.ranks import RankPool, run_ranks
from terastructure_tpu_torch.svi import engine, fit, init, stream
from terastructure_tpu_torch.utils.labels import mean_abs_theta_error

TOL = 2e-4          # f32 kernel vs twin (sum order differs), as the reference's
TOL_APPROX = 5e-3   # approx_div: fast divide vs the twin's reciprocal
# bf16 bodies vs their bf16 twins (rtol, atol): both round the same
# operands and differ in the order of the f32 sums and in the rare R whose
# rounding flips on an ulp of D. One pass (K4, the λ and γ passes) 1e-3;
# a fused solve 2e-3 (λ after the accel tail with the f32 path's 1%
# allowance); approx_div TOL_APPROX, as in f32.
TOL_BF16_PASS = (1e-3, 1e-6)
TOL_BF16_SOLVE = (2e-3, 1e-5)
# lambda_B of a bf16 solve: at most this share of its entries beyond
# TOL_BF16_SOLVE. The kernel and the twin sum D in other orders, so now
# and then bf(t) of a row rounds the other way on an ulp of lambda; one
# such flip moves bf(t[b,k]) by 2^-8 and, where k dominates D, the row's
# next lambda by up to ~3e-3 (measured: 9 of 65,536 entries at the TGP
# shape, 7 plain passes). g sums over rows and holds TOL_BF16_SOLVE.
FLIP_FRAC = 1e-3
# The divergence pin: a bf16 body's output differs from the f32 body's on
# the same inputs by more than PIN_LO somewhere (the rounding happened)
# and by less than PIN_HI everywhere, relative to the largest magnitude.
PIN_LO, PIN_HI = 1e-4, 5e-2
# Phase 7: the big-N fit at bf16 against phase 4's f32 fit on the same
# data, seed and minibatches (300 steps, far from converged): |heldout
# gap| in nats, at least 3x the gap measured on the card. bf16 trails f32
# early (0.0625 nats and theta MAE 0.123 against 0.090 at step 300,
# NVIDIA H100 80GB HBM3, 700 W; both converge to the oracle's heldout
# within 0.0006 nats: PERF.md §6). Where both packages can run 300 steps
# at both dtypes (dense, on the CPU) the port's gap is the reference's
# within Monte-Carlo error (tests/test_torch_lambda_pass.py
# `test_bf16_heldout_gap_is_the_references`); no reference figure exists
# at the big-N shape.
BIGN_BF16_HELDOUT_GAP = 0.2

FP32_FLOPS = 67e12  # H100 SXM: FP32 outside the tensor cores (data sheet)
BF16_FLOPS = 989e12  # H100 SXM: dense bf16 on the tensor cores (data sheet)
HBM_BYTES = 3.35e12  # H100 SXM: HBM3 bytes/s

KERNELS = {
    "fused_local_solve": dict(
        fn=fused_step.fused_local_solve,
        source="terastructure_tpu_torch/csrc/fused_step.cu",
        replaces="terastructure_tpu/ops/fused_step.py:423"),
    "fused_local_solve_dma": dict(
        fn=fused_step.fused_local_solve_dma,
        source="terastructure_tpu_torch/csrc/fused_step_dma.cu",
        replaces="terastructure_tpu/ops/fused_step.py:493"),
    "gather_row_blocks": dict(
        fn=gather.gather_row_blocks,
        source="terastructure_tpu_torch/csrc/gather.cu",
        replaces="terastructure_tpu/ops/gather.py:58"),
    "lambda_stats_packed": dict(
        fn=stats_packed.lambda_stats_packed,
        source="terastructure_tpu_torch/csrc/stats_packed.cu",
        replaces="terastructure_tpu/ops/stats_pallas.py:152"),
    "gamma_stats_packed": dict(
        fn=stats_packed.gamma_stats_packed,
        source="terastructure_tpu_torch/csrc/stats_gamma.cu",
        replaces="terastructure_tpu/ops/stats_pallas.py:194"),
    "batch_stats_fused_packed": dict(
        fn=stats_packed.batch_stats_fused_packed,
        source="terastructure_tpu_torch/csrc/stats_fused.cuh",
        replaces="terastructure_tpu/ops/stats_pallas.py:263"),
    "batch_stats_fused_v2_packed": dict(
        fn=stats_packed.batch_stats_fused_v2_packed,
        source="terastructure_tpu_torch/csrc/stats_fused.cuh",
        replaces="terastructure_tpu/ops/stats_pallas.py:355"),
    "lambda_stats_acat": dict(
        fn=stats_packed.lambda_stats_acat,
        source="terastructure_tpu_torch/csrc/stats_acat.cu",
        replaces="terastructure_tpu/ops/stats_pallas.py:463"),
    # the bf16 bodies (compute_dtype="bfloat16"), counted apart
    "fused_local_solve[bf16]": dict(
        fn=fused_step.fused_local_solve, counter="bf16_launches",
        source="terastructure_tpu_torch/csrc/fused_step_bf16.cu",
        replaces="terastructure_tpu/ops/fused_step.py:423"),
    "fused_local_solve_dma[bf16]": dict(
        fn=fused_step.fused_local_solve_dma, counter="bf16_launches",
        source="terastructure_tpu_torch/csrc/fused_step_dma_bf16.cu",
        replaces="terastructure_tpu/ops/fused_step.py:493"),
    "lambda_stats_packed[bf16]": dict(
        fn=stats_packed.lambda_stats_packed, counter="bf16_launches",
        source="terastructure_tpu_torch/csrc/stats_packed.cu",
        replaces="terastructure_tpu/ops/stats_pallas.py:152"),
    "gamma_stats_packed[bf16]": dict(
        fn=stats_packed.gamma_stats_packed, counter="bf16_launches",
        source="terastructure_tpu_torch/csrc/stats_gamma.cu",
        replaces="terastructure_tpu/ops/stats_pallas.py:194"),
    "batch_stats_fused_packed[bf16]": dict(
        fn=stats_packed.batch_stats_fused_packed, counter="bf16_launches",
        source="terastructure_tpu_torch/csrc/stats_fused_bf16.cu",
        replaces="terastructure_tpu/ops/stats_pallas.py:263"),
    "batch_stats_fused_v2_packed[bf16]": dict(
        fn=stats_packed.batch_stats_fused_v2_packed, counter="bf16_launches",
        source="terastructure_tpu_torch/csrc/stats_fused_bf16.cu",
        replaces="terastructure_tpu/ops/stats_pallas.py:355"),
    "lambda_stats_acat[bf16]": dict(
        fn=stats_packed.lambda_stats_acat, counter="bf16_launches",
        source="terastructure_tpu_torch/csrc/stats_acat.cu",
        replaces="terastructure_tpu/ops/stats_pallas.py:463"),
    # the replicate axis (batched replicates): R solves or passes in one
    # launch, both dtypes counted in rep_launches (and in launches or
    # bf16_launches as well); times at R = 4, f32 (bf16 as bf16_ms)
    "fused_local_solve[rep]": dict(
        fn=fused_step.fused_local_solve, counter="rep_launches",
        source="terastructure_tpu_torch/csrc/fused_step.cu",
        replaces="terastructure_tpu/ops/fused_step.py:423"),
    "lambda_stats_packed[rep]": dict(
        fn=stats_packed.lambda_stats_packed, counter="rep_launches",
        source="terastructure_tpu_torch/csrc/stats_packed.cu",
        replaces="terastructure_tpu/ops/stats_pallas.py:152"),
    "lambda_stats_acat[rep]": dict(
        fn=stats_packed.lambda_stats_acat, counter="rep_launches",
        source="terastructure_tpu_torch/csrc/stats_acat.cu",
        replaces="terastructure_tpu/ops/stats_pallas.py:463"),
    "batch_stats_fused_v2_packed[rep]": dict(
        fn=stats_packed.batch_stats_fused_v2_packed, counter="rep_launches",
        source="terastructure_tpu_torch/csrc/stats_fused.cuh",
        replaces="terastructure_tpu/ops/stats_pallas.py:355"),
    "gamma_stats_packed[rep]": dict(
        fn=stats_packed.gamma_stats_packed, counter="rep_launches",
        source="terastructure_tpu_torch/csrc/stats_gamma.cu",
        replaces="terastructure_tpu/ops/stats_pallas.py:194"),
    "batch_stats_fused_packed[rep]": dict(
        fn=stats_packed.batch_stats_fused_packed, counter="rep_launches",
        source="terastructure_tpu_torch/csrc/stats_fused.cuh",
        replaces="terastructure_tpu/ops/stats_pallas.py:263"),
}
# the f32 bodies of the big-N step's kernels: none may launch at bf16
BIGN_F32 = ("lambda_stats_packed", "gamma_stats_packed",
            "batch_stats_fused_packed", "batch_stats_fused_v2_packed",
            "lambda_stats_acat")
BF16 = torch.bfloat16
BIGN = (4096, 25_088, 10)   # B, W, K of the big-N step (100K individuals)
BIGN_SUB_W = 2048           # byte columns of its subsample (local_sub_n 8192)
TGP = (2504, 1_000_000, 8)  # N, L, K of the TGP shape (config #3)


def log(msg):
    print(msg, flush=True)


def reset_counts():
    for spec in KERNELS.values():
        setattr(spec["fn"], spec.get("counter", "launches"), 0)
        spec["fn"].twin_calls = 0


def read_counts(rec, path, expect, absent=()):
    """Add the launches of a main-path run to rec; fail where a kernel of
    `expect` did not launch, one of `absent` did, or any twin ran.
    Returns the run's counts."""
    counts = {name: getattr(spec["fn"], spec.get("counter", "launches"))
              for name, spec in KERNELS.items()}
    log(f"  {path} launches: {counts}")
    for name, spec in KERNELS.items():
        rec[name]["launches"] = rec[name].get("launches", 0) + counts[name]
        if spec["fn"].twin_calls:
            raise AssertionError(f"{path}: {name} ran its twin")
    for name in expect:
        if counts[name] <= 0:
            raise AssertionError(f"{path}: {name} never launched")
    for name in absent:
        if counts[name]:
            raise AssertionError(f"{path}: {name} launched {counts[name]}x")
    return counts


def time_ms(fn, reps=20):
    """Mean device time of fn() over reps launches (CUDA events), after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=100):
    """Mean device time of fn() with the host out of the way: reps calls
    captured into one CUDA graph (the wrappers' allocations included),
    replayed once to warm up and once under CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def present(rows):
    """Entries of packed rows (B, W) that are not MISSING: the entries a
    pass does work for."""
    return sum(int((((rows >> (2 * s)) & 3) != 3).sum()) for s in range(4))


def set_bound(r, flops, nbytes_):
    """r's bound_ms: the larger of the operations at the FP32 peak and
    the bytes (each input read once, each output written once) at the
    memory rate, and which of the two binds. A divide counts as one
    operation, an FMA as two."""
    t_ops = flops / FP32_FLOPS * 1e3
    t_bytes = nbytes_ / HBM_BYTES * 1e3
    r["bound_ms"] = max(t_ops, t_bytes)
    r["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    r.setdefault("library_ms", None)
    log(f"  bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
        f"{flops / 1e9:.3f} G operations, {nbytes_ / 1e6:.3f} MB)")


def set_bound_bf16(r, entries, k, nbytes_, sums=1):
    """r's bound_ms for a bf16 body doing `entries` (present entry, pass)
    pairs: the larger of its products at the bf16 tensor core peak (D1,
    D0 and `sums` pairs of K-sums: one for a λ or γ pass, 8K operations
    an entry; two for K6/K7's λ and γ sums, 12K; an FMA two), its FP32
    work outside them at the FP32 peak (two divides an entry, one
    operation each) and its bytes at the memory rate."""
    t_mma = entries * (2 + 2 * sums) * 2 * k / BF16_FLOPS * 1e3
    t_fp32 = entries * 2 / FP32_FLOPS * 1e3
    t_bytes = nbytes_ / HBM_BYTES * 1e3
    r["bound_ms"] = max(t_mma, t_fp32, t_bytes)
    r["bound_by"] = "operations" if max(t_mma, t_fp32) >= t_bytes else "bytes"
    r.setdefault("library_ms", None)
    log(f"  bound {r['bound_ms']:.5f} ms ({r['bound_by']}: products "
        f"{t_mma:.5f} ms, FP32 {t_fp32:.5f} ms, bytes {t_bytes:.5f} ms)")


def lambda_pass_flops(k):
    """Per present entry of a lambda pass: D1, D0 and the two K-sums (4K
    FMAs) and two divides. A gamma pass does the same count."""
    return 8 * k + 2


def solve_passes(rows, up, lamb, *, local_iters, local_tol, beta_a, beta_b,
                 accel=False, warm_start=False, approx_div=False,
                 dtype=torch.float32):
    """Lambda passes the fused solve does work for on these inputs: loop
    passes until the batch-wide change is not above local_tol, the accel
    tail's two, and the exact final one (the twin's schedule replayed)."""
    acc = accel and local_iters >= 3
    k = up.shape[-1]
    u = up.reshape(-1, k)
    a1, a0 = stats_packed.plane_counts(rows)
    lam = lamb if warm_start else torch.stack(
        [torch.full_like(lamb[..., 0], beta_a),
         torch.full_like(lamb[..., 1], beta_b)], -1)
    ran = 0
    uo = u if dtype == torch.float32 else u.to(dtype).float()
    for _ in range(local_iters - 2 if acc else local_iters):
        t1, t0 = fused_step.exp_elog_beta_kernel(lam)
        r1, r0 = stats_packed.ratios_planar(a1, a0, u, t1, t0, approx_div,
                                            dtype)
        new = torch.stack([beta_a + t1 * (r1 @ uo), beta_b + t0 * (r0 @ uo)],
                          -1)
        ran += 1
        delta = (new - lam).abs().mean() / (lam.abs().mean() + 1.0)
        lam = new
        if not float(delta) > local_tol:
            break
    return ran + (2 if acc else 0) + 1


def solve_bound(r, rows, up, lamb, kw, extra_bytes=0):
    """The fused solve's bound: its lambda passes and the gamma pass over
    the present entries; rows, u, lamb_init (when read) in, lambda_B and
    g out. At bf16 the products count at the bf16 rate (`set_bound_bf16`)."""
    k = up.shape[-1]
    passes = solve_passes(rows, up, lamb, **kw)
    moved = nbytes(rows, up, up) + lamb.numel() * 4 * (
        2 if kw.get("warm_start") else 1) + extra_bytes
    log(f"  {passes} lambda passes + 1 gamma pass")
    if kw.get("dtype") == BF16:
        set_bound_bf16(r, present(rows) * (passes + 1), k, moved)
    else:
        set_bound(r, present(rows) * lambda_pass_flops(k) * (passes + 1),
                  moved)


def compare(name, got, want, tol, outlier_frac=0.0, cap=None):
    """Max abs error; fails where |got - want| > atol + rtol*|want| on more
    than `outlier_frac` of the entries, or on any non-finite value. tol is
    rtol = atol, or the pair (rtol, atol). cap: also fails where any entry
    is beyond atol + cap*|want| (the outliers' size)."""
    rtol, atol = tol if isinstance(tol, tuple) else (tol, tol)
    got = [g.float() for g in got]
    want = [w.float() for w in want]
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    out = max(float(((g - w).abs() > atol + rtol * w.abs()).float().mean())
              for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    log(f"  {name}: max_abs_err={err:.3e} tol={tol} "
        f"outside_tol={out:.2e} (allowed {outlier_frac:g}) finite={finite}")
    if cap is not None:
        rel = max(float(((g - w).abs() / w.abs().clamp_min(atol)).max())
                  for g, w in zip(got, want))
        log(f"  {name}: largest deviation {rel:.3e} of |twin| (cap {cap:g})")
        if not all(bool(((g - w).abs() <= atol + cap * w.abs()).all())
                   for g, w in zip(got, want)):
            raise AssertionError(f"{name}: an entry beyond the cap")
    if out > outlier_frac or not finite:
        raise AssertionError(f"{name}: kernel disagrees with its twin")
    return err


def twice(label, fn):
    """fn()'s outputs, after checking that a second call gives the same
    bits."""
    got = fn()
    if not all(torch.equal(a, c) for a, c in zip(got, fn())):
        raise AssertionError(f"{label}: a second run is not bitwise equal")
    return got


def hold(rec, name, label, got, want, tol, frac=0.0, cap=None):
    """compare, and keep the largest error in rec[name]["max_abs_err"]."""
    err = compare(label, got, want, tol, frac, cap)
    rec[name]["max_abs_err"] = max(rec[name].get("max_abs_err", 0.0), err)


def twin_stats(rows, up, t1, t0, approx_div=False, dtype=torch.float32):
    """The plain version of K5-K7's statistics, in their wrappers' form."""
    g, l0, l1 = stats_packed.batch_stats_fused_twin(
        rows, up, t1, t0, approx_div=approx_div, dtype=dtype)
    u = stats_packed.planes_to_flat(up)
    return u * stats_packed.planes_to_flat(g), t1 * l0, t0 * l1


def _solve_inputs(b, w, k, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randint(0, 256, (b, w), generator=g, device=dev,
                         dtype=torch.uint8)
    gamma = 0.3 + 2.7 * torch.rand((4 * w, k), generator=g, device=dev)
    up = stats_packed.u_to_planes(exp_elog_theta(gamma))
    lamb = 0.5 + 2.5 * torch.rand((b, k, 2), generator=g, device=dev)
    return rows, up, lamb


def phase_kernels(dev, rec, sweep=False):
    """Each kernel against its twin at the main path's shapes. sweep: also
    time the lambda pass at other column splits than the chosen one."""
    # K1 at the TGP and config #1 step shapes, warm start, approx_div.
    # Without accel every entry holds 2e-4. The accel tail's clamped
    # Aitken step is discontinuous where d0 - d1 changes sign (its size is
    # capped at 9|d1| and its sign follows d0 - d1), so ~1e-6 relative
    # differences in the iterates (sum order) can move a coordinate of
    # lambda_B by up to 18|d1|. With accel, g (the only output the local
    # lambda mode's step uses) must hold 2e-4 everywhere, and at most 1%
    # of the lambda_B entries may exceed it.
    plain = dict(local_iters=7, local_tol=-1.0, accel=False)
    main = dict(local_iters=7, local_tol=1e-4, accel=True)
    cases = [
        ("K1 B=4096 W=640 K=8 plain7", (4096, 640, 8), plain, TOL, 0.0),
        ("K1 B=4096 W=640 K=8 accel", (4096, 640, 8), main, TOL, 1e-2),
        ("K1 B=256 W=256 K=3 plain7", (256, 256, 3), plain, TOL, 0.0),
        ("K1 B=256 W=256 K=3 accel", (256, 256, 3), main, TOL, 1e-2),
        ("K1 warm_start", (256, 256, 3), dict(plain, warm_start=True),
         TOL, 0.0),
        ("K1 approx_div", (256, 256, 3), dict(plain, approx_div=True),
         TOL_APPROX, 0.0),
    ]
    r = rec["fused_local_solve"]
    r["max_abs_err"] = 0.0
    for label, (b, w, k), extra, tol, frac in cases:
        rows, up, lamb = _solve_inputs(b, w, k, b + w + k, dev)
        kw = dict(beta_a=1.0, beta_b=1.0, **extra)
        got = fused_step.fused_local_solve(rows, up, lamb, **kw)
        want = fused_step.fused_local_solve_twin(rows, up, lamb, **kw)
        compare(f"{label} g", got[1:], want[1:], tol)
        err = compare(f"{label} lambda", got[:1], want[:1], tol, frac)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if extra is main:
            ms = time_ms(lambda: fused_step.fused_local_solve(
                rows, up, lamb, **kw))
            plain_ms = time_ms(lambda: fused_step.fused_local_solve_twin(
                rows, up, lamb, **kw))
            log(f"  {label}: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms")
            if "ms" not in r:           # the TGP step shape
                r["ms"], r["plain_ms"] = ms, plain_ms
                solve_bound(r, rows, up, lamb, kw)

    # K3: 8-row blocks out of a 1M-row matrix, bitwise
    g = torch.Generator(device=dev).manual_seed(3)
    src = torch.randint(0, 256, (1_000_000, 640), generator=g, device=dev,
                        dtype=torch.uint8)
    starts = torch.randint(0, 1_000_000 // 8, (4096 // 8,), generator=g,
                           device=dev, dtype=torch.int32)
    got = gather.gather_row_blocks(src, starts)
    want = gather.gather_row_blocks_twin(src, starts)
    if not torch.equal(got, want):
        raise AssertionError("gather_row_blocks differs from its twin")
    # the library call that computes the same function (a yardstick only)
    def library():
        return src.view(-1, 8 * src.shape[1]).index_select(0, starts)

    if not torch.equal(library().view_as(got), got):
        raise AssertionError("index_select differs from gather_row_blocks")
    r = rec["gather_row_blocks"]
    r["max_abs_err"] = 0.0
    r["plain_ms"] = time_ms(lambda: gather.gather_row_blocks_twin(src, starts))
    # kernel and library call in turns (A-B-A-B): from a CUDA graph of 200
    # calls (the device's time), then 200 eager launches each (the host's
    # call included)
    fns = (lambda: gather.gather_row_blocks(src, starts), library) * 2
    graph = [device_ms(fn, 200) for fn in fns]
    turns = [time_ms(fn, 200) for fn in fns]
    r["ms"] = (graph[0] + graph[2]) / 2
    r["library_ms"] = (graph[1] + graph[3]) / 2
    r["eager_ms"] = (turns[0] + turns[2]) / 2
    r["library_eager_ms"] = (turns[1] + turns[3]) / 2
    r["graph_turns_ms"], r["eager_turns_ms"] = graph, turns
    log(f"  K3 L=1M B=4096 W=640: bitwise equal; twin {r['plain_ms']:.4f} ms; "
        "kernel, index_select in turns, from a CUDA graph: "
        + ", ".join(f"{t:.5f}" for t in graph) + " ms; eager: "
        + ", ".join(f"{t:.5f}" for t in turns) + " ms")
    set_bound(r, 0, nbytes(starts, got, got))
    # the byte path (odd W) and one run, bitwise
    for w, g in ((235, 512), (235, 1), (640, 1)):
        s_ = src[:8192, :w].contiguous()
        st = starts[:g] % 1024
        got = gather.gather_row_blocks(s_, st)
        if not (torch.equal(got, gather.gather_row_blocks_twin(s_, st))
                and torch.equal(got, s_.view(-1, 8 * w).index_select(0, st)
                                .view_as(got))):
            raise AssertionError(f"K3 W={w} G={g} differs from its twin")
    log("  K3 W=235 (the byte path) and G=1: bitwise equal")
    del src

    # K4: the eval/export block shape
    b, w, k = 1024, 640, 8
    rows, up, lamb = _solve_inputs(b, w, k, 4, dev)
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    r = rec["lambda_stats_packed"]
    r["max_abs_err"] = 0.0
    for approx, tol in ((False, TOL), (True, TOL_APPROX)):
        got = stats_packed.lambda_stats_packed(rows, up, t1, t0,
                                               approx_div=approx)
        want = stats_packed.lambda_stats_packed_twin(rows, up, t1, t0,
                                                     approx_div=approx)
        err = compare(f"K4 B=1024 W=640 K=8 approx={approx}", got, want, tol)
        r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ms"] = time_ms(lambda: stats_packed.lambda_stats_packed(rows, up, t1, t0))
    r["plain_ms"] = time_ms(
        lambda: stats_packed.lambda_stats_packed_twin(rows, up, t1, t0))
    log(f"  K4: kernel {r['ms']:.4f} ms, twin {r['plain_ms']:.4f} ms")
    set_bound(r, present(rows) * lambda_pass_flops(k),
              nbytes(rows, up, t1, t0, t1, t0))
    phase_lambda_pass(dev, rec, sweep)
    if sweep:
        gamma_split_sweep(dev, rec)
    phase_kernels_bign(dev, rec)
    phase_kernels_dma(dev, rec)
    phase_kernels_tiling(dev, rec)
    tr = time.time()
    phase_kernels_wide(dev, rec)
    log(f"  the K > 64 bodies in {time.time() - tr:.1f} s")
    phase_kernels_bf16(dev, rec)
    phase_kernels_rep(dev, rec)
    phase_kernels_rep_bign(dev, rec)
    tr = time.time()
    phase_kernels_rep_wide(dev, rec)
    log(f"  the K > 64 bodies with the replicate axis in "
        f"{time.time() - tr:.1f} s")


# B, W, K at which the paths run one lambda pass: K1 at the TGP shape; K2
# at config #3 and K4 in eval and export; K1 at config #1.
PASS_SHAPES = [(4096, 640, 8), (1024, 640, 8), (256, 256, 3)]


def phase_lambda_pass(dev, rec, sweep=False):
    """The lambda pass alone, through K4's entry (one launch of the pass
    body plus the split reduction), at the shapes the paths run it, with
    the exact and the fast divide, beside its bound. The wrapper's host
    work (~0.05 ms) exceeds the pass at these sizes, so the device time is
    taken from a CUDA graph of 100 calls; the eager time stands beside it."""
    r = rec["lambda_stats_packed"]
    r["passes"] = []
    for b, w, k in PASS_SHAPES:
        rows, up, lamb = _solve_inputs(b, w, k, b + w + k, dev)
        t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
        e = dict(shape=f"B={b} W={w} K={k}")
        for key, approx in (("ms", False), ("approx_ms", True)):
            e[key] = device_ms(lambda: stats_packed.lambda_stats_packed(
                rows, up, t1, t0, approx_div=approx))
        e["eager_ms"] = time_ms(lambda: stats_packed.lambda_stats_packed(
            rows, up, t1, t0), 100)
        log(f"  lambda pass {e['shape']}: {e['ms']:.4f} ms, fast divide "
            f"{e['approx_ms']:.4f} ms (device time, launches replayed from "
            f"a CUDA graph); launched eagerly {e['eager_ms']:.4f} ms")
        set_bound(e, present(rows) * lambda_pass_flops(k),
                  nbytes(rows, up, t1, t0, t1, t0))
        e["share_of_bound"] = e["bound_ms"] / e["ms"]
        log(f"  share of the bound {e['share_of_bound']:.4f}")
        r["passes"].append(e)
        if sweep:
            split_sweep(e, (rows, up, t1, t0), k, SWEEP_CHUNKS, device_ms,
                        (False, True))
    if sweep:
        for b, w, k in NARROW_SWEEP_SHAPES:
            rows, up, lamb = _solve_inputs(b, w, k, b + w + k, dev)
            t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
            e = dict(shape=f"B={b} W={w} K={k}")
            split_sweep(e, (rows, up, t1, t0), k, SWEEP_CHUNKS,
                        lambda fn: time_ms(fn, 5), (False, True))
            r.setdefault("narrow_split_sweep", []).append(e)
            if w == BIGN_SUB_W and hasattr(stats_packed,
                                           "launch_lambda_stats_acat"):
                # K8 on the step's subsample, its fast divide
                a1, a0 = stats_packed.decode_count_planes(rows)
                e = dict(shape=f"K8 B={b} (4, {w}) K={k} approx")
                split_sweep(e, (rows, up, t1, t0), k, SWEEP_CHUNKS,
                            lambda fn: time_ms(fn, 20), (False, True),
                            lambda nsplit, bf16: (
                                stats_packed.launch_lambda_stats_acat(
                                    a1, a0, up, t1, t0, nsplit, True, bf16)))
                rec["lambda_stats_acat"].setdefault(
                    "narrow_split_sweep", []).append(e)
                del a1, a0
            del rows, up, lamb, t1, t0
            torch.cuda.empty_cache()
        for b, w, k in WIDE_SWEEP_SHAPES:
            x = wide_lambda_inputs(dev, "K4", b, w, k)[0]
            e = dict(shape=f"B={b} W={w} K={k}")
            split_sweep(e, (x[0], x[1], x[3], x[4]), k, WIDE_SWEEP_CHUNKS,
                        lambda fn: time_ms(fn, 10), (False, True))
            r.setdefault("wide_split_sweep", []).append(e)


# The λ pass at other column splits than `lambda_grid`'s (--kernels):
# chunks of byte columns at K <= 64 (PASS_SHAPES, then K8's shape and
# K5's big-N shape through K4's entry: the same body over packed rows;
# f32 and bf16), and at K > 64 K8's shape, config #3's width and the
# K = 256 timed shape
SWEEP_CHUNKS = (16, 32, 48, 64, 96, 128, 192, 256, 384, 512, 1024, 2048)
NARROW_SWEEP_SHAPES = [(BIGN[0], BIGN_SUB_W, BIGN[2]), BIGN]
WIDE_SWEEP_CHUNKS = (*range(32, 257, 16), 512)
WIDE_SWEEP_SHAPES = [(BIGN[0], BIGN_SUB_W, 72), (1024, 640, 72),
                     (1024, 2048, 256)]


def bf16_grid(grid, b, w, k):
    """grid(b, w, k) at bf16, in a tree whose grids take the dtype (an
    older tree's take the shape alone)."""
    import inspect
    if "dtype" in inspect.signature(grid).parameters:
        return grid(b, w, k, BF16)
    return grid(b, w, k)


def split_sweep(e, x, k, chunks, timer, bf16s=(False,), launch=None):
    """Device ms (`timer`) of the λ pass through K4's entry, exact divide
    (or of launch(nsplit, bf16)), on x = (rows, up, t1, t0) at the column
    splits that chunks of `chunks` byte columns give, into
    e["split_sweep_ms"] (and e["bf16_split_sweep_ms"] where True is in
    bf16s), logged beside the split `lambda_grid` chose."""
    rows, up, t1, t0 = x
    if launch is None:
        def launch(nsplit, bf16):
            return stats_packed.launch_lambda_stats_packed(
                rows, up, t1, t0, nsplit, False, bf16)
    b, w = rows.shape
    keys = {False: "split_sweep_ms", True: "bf16_split_sweep_ms"}
    e["chosen"] = stats_packed.lambda_grid(b, w, k)[0]
    e["bf16_chosen"] = bf16_grid(stats_packed.lambda_grid, b, w, k)[0]
    for bf16 in bf16s:
        e[keys[bf16]] = {}
    for chunk in chunks:
        nsplit = -(-w // chunk)
        if nsplit in e[keys[bf16s[0]]]:
            continue
        for bf16 in bf16s:
            e[keys[bf16]][nsplit] = timer(lambda: launch(nsplit, bf16))
    log(f"  λ pass {e['shape']}, column splits (chosen {e['chosen']}, "
        f"bf16 {e['bf16_chosen']}): "
        + ", ".join(f"{n}: " + " / ".join(f"{e[keys[f]][n]:.4f}"
                                          for f in bf16s)
                    for n in e[keys[bf16s[0]]])
        + " ms" + (" (f32 / bf16)" if len(bf16s) > 1 else ""))


def phase_kernels_tiling(dev, rec):
    """What the lambda pass's tiling can break: ragged row blocks, byte
    widths that no chunk divides, K across the instantiated widths, whole
    rows MISSING, a null group (K2), the exact and the fast divide. K1,
    K4 and K8 against their twins, K2 bitwise against K1 on the gathered
    rows, and every kernel bitwise against its own second run."""
    plain = dict(local_iters=4, local_tol=-1.0, beta_a=1.0, beta_b=1.0)
    for b, w, k in ((33, 235, 3), (1000, 626, 7), (33, 626, 10),
                    (1000, 235, 16), (72, 640, 33)):
        rows, up, lamb = _solve_inputs(b, w, k, b + w + k, dev)
        rows[5] = 0xFF                      # whole rows MISSING
        rows[-1] = 0xFF
        t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
        a1, a0 = stats_packed.decode_count_planes(rows)
        shape = f"B={b} W={w} K={k}"
        for approx, tol in ((False, TOL), (True, TOL_APPROX)):
            got = twice(f"K4 {shape}",
                        lambda: stats_packed.lambda_stats_packed(
                            rows, up, t1, t0, approx_div=approx))
            hold(rec, "lambda_stats_packed", f"K4 {shape} approx={approx}", got,
                 stats_packed.lambda_stats_packed_twin(
                     rows, up, t1, t0, approx_div=approx), tol)
            got = twice(f"K8 {shape}",
                        lambda: stats_packed.lambda_stats_acat(
                            a1, a0, up, t1, t0, approx_div=approx))
            hold(rec, "lambda_stats_acat", f"K8 {shape} approx={approx}", got,
                 stats_packed.lambda_stats_acat_twin(
                     a1, a0, up, t1, t0, approx_div=approx), tol)
            kw = dict(plain, approx_div=approx)
            got = twice(f"K1 {shape}", lambda: fused_step.fused_local_solve(
                rows, up, lamb, **kw))
            hold(rec, "fused_local_solve", f"K1 {shape} approx={approx}", got,
                 fused_step.fused_local_solve_twin(rows, up, lamb, **kw), tol)

    # K2 where its gate admits the shape (W % 128 = 0, B % 8 = 0)
    g, l = 8, 4096
    for b, w, k in ((1000, 640, 8), (40, 256, 3), (72, 128, 10),
                    (136, 384, 16), (1000, 640, 33)):
        packed, up, lamb = _solve_inputs(l, w, k, b + w + k, dev)
        lamb = lamb[:b].contiguous()
        gen = torch.Generator(device=dev).manual_seed(b)
        idx0 = torch.randint(0, l // g, (b // g,), generator=gen, device=dev,
                             dtype=torch.int32) * g
        packed[int(idx0[0]) + 3] = 0xFF     # a whole row MISSING
        idx0[1] = l                         # a null group: reads as MISSING
        idx = (idx0.long().clamp(max=l - g)[:, None]
               + torch.arange(g, device=dev)).reshape(b)
        rows = packed[idx]
        rows[g:2 * g] = 0xFF
        shape = f"B={b} W={w} K={k} g={g}"
        for approx, tol in ((False, TOL), (True, TOL_APPROX)):
            kw = dict(plain, approx_div=approx, warm_start=True)
            got = twice(f"K2 {shape}",
                        lambda: fused_step.fused_local_solve_dma(
                            idx0, packed, up, lamb, group=g, **kw))
            k1 = fused_step.fused_local_solve(rows, up, lamb, **kw)
            if not all(torch.equal(a, c) for a, c in zip(got, k1)):
                raise AssertionError(f"K2 {shape}: differs from K1 on the "
                                     "gathered rows")
            hold(rec, "fused_local_solve_dma", f"K2 {shape} approx={approx}", got,
                 fused_step.fused_local_solve_twin(rows, up, lamb, **kw), tol)
    log("  tiling cases: every second run bitwise equal; K2 bitwise equal "
        "to K1 on the gathered rows")


def phase_kernels_dma(dev, rec):
    """K2 at config #3's step shape: packed (1M, 640), B=1024, g=8, K=8.
    Against its twin, and bitwise against K1 on the gathered rows; times
    of K2, of K1 on the gathered rows, and of K3 + K1."""
    l, w, k, b, g = 1_000_000, 640, 8, 1024, 8
    gen = torch.Generator(device=dev).manual_seed(5)
    packed = torch.randint(0, 256, (l, w), generator=gen, device=dev,
                           dtype=torch.uint8)
    gamma = 0.3 + 2.7 * torch.rand((4 * w, k), generator=gen, device=dev)
    up = stats_packed.u_to_planes(exp_elog_theta(gamma))
    idx0 = torch.randint(0, l // g, (b // g,), generator=gen, device=dev,
                         dtype=torch.int32) * g
    idx = (idx0.long()[:, None] + torch.arange(g, device=dev)).reshape(b)
    lamb = 0.5 + 2.5 * torch.rand((b, k, 2), generator=gen, device=dev)
    rows = packed[idx]
    plain = dict(local_iters=7, local_tol=-1.0, accel=False)
    main = dict(local_iters=7, local_tol=1e-4, accel=True)
    cases = [("plain7", plain, TOL, 0.0), ("accel7", main, TOL, 1e-2),
             ("warm_start", dict(plain, warm_start=True), TOL, 0.0),
             ("approx_div", dict(plain, approx_div=True), TOL_APPROX, 0.0)]
    r = rec["fused_local_solve_dma"]
    r["max_abs_err"] = 0.0
    for label, extra, tol, frac in cases:
        kw = dict(beta_a=1.0, beta_b=1.0, **extra)
        got = fused_step.fused_local_solve_dma(idx0, packed, up, lamb,
                                               group=g, **kw)
        want = fused_step.fused_local_solve_dma_twin(idx0, packed, up, lamb,
                                                     group=g, **kw)
        label = f"K2 B={b} W={w} K={k} g={g} {label}"
        compare(f"{label} g", got[1:], want[1:], tol)
        err = compare(f"{label} lambda", got[:1], want[:1], tol, frac)
        r["max_abs_err"] = max(r["max_abs_err"], err)
        k1 = fused_step.fused_local_solve(rows, up, lamb, **kw)
        if not all(torch.equal(a, c) for a, c in zip(got, k1)):
            raise AssertionError(f"{label}: K2 differs from K1 on the "
                                 "gathered rows")
    log("  K2 bitwise equal to K1 on the gathered rows in every case")
    kw = dict(beta_a=1.0, beta_b=1.0, **main)
    r["ms"] = time_ms(lambda: fused_step.fused_local_solve_dma(
        idx0, packed, up, lamb, group=g, **kw))
    r["plain_ms"] = time_ms(lambda: fused_step.fused_local_solve_dma_twin(
        idx0, packed, up, lamb, group=g, **kw))
    k1_ms = time_ms(lambda: fused_step.fused_local_solve(rows, up, lamb, **kw))
    k3k1_ms = time_ms(lambda: fused_step.fused_local_solve(
        gather.gather_row_blocks(packed, idx0 // 8), up, lamb, **kw))
    log(f"  K2 accel7: kernel {r['ms']:.4f} ms, twin {r['plain_ms']:.4f} ms; "
        f"K1 on the gathered rows {k1_ms:.4f} ms, K3 + K1 {k3k1_ms:.4f} ms")
    solve_bound(r, rows, up, lamb, kw, extra_bytes=nbytes(idx0))


def _stats_inputs(b, w, k, seed, dev):
    rows, up, lamb = _solve_inputs(b, w, k, seed, dev)
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    return rows, up, stats_packed.planes_to_flat(up).contiguous(), t1, t0


def _timed(rec, label, kernel, twin, flops, moved, reps=5):
    """Kernel and twin times at the main-path shape, and the bound; twin
    run and freed before the next (the big-N twins hold ~10 GB)."""
    ms = time_ms(kernel, reps)
    plain_ms = time_ms(twin, reps)
    torch.cuda.empty_cache()
    log(f"  {label}: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms")
    rec["ms"], rec["plain_ms"] = ms, plain_ms
    set_bound(rec, flops, moved)


def k6_is_k7(label, rows, u, t1, t0, dtype=torch.float32):
    """K6 is K7's launch at the exact divide: its outputs must be K7's
    bitwise, and bitwise on a re-run."""
    k6 = twice(label, lambda: stats_packed.batch_stats_fused_packed(
        rows, u, t1, t0, dtype=dtype))
    k7 = stats_packed.batch_stats_fused_v2_packed(rows, u, t1, t0,
                                                  dtype=dtype)
    if not all(torch.equal(a, c) for a, c in zip(k6, k7)):
        raise AssertionError(f"{label}: K6 differs from K7 (exact divide)")
    log(f"  {label}: bitwise K7 (exact divide) and its own re-run")


def phase_kernels_bign(dev, rec):
    """K5-K8 against their twins at the big-N step's shapes and at a
    ragged small shape (B=12, W=384, K=3)."""
    shapes = [("big-N", BIGN), ("ragged", (12, 384, 3))]
    sub = (BIGN[0], BIGN_SUB_W, BIGN[2])    # K8: the step's subsample
    for name in ("gamma_stats_packed", "batch_stats_fused_packed",
                 "batch_stats_fused_v2_packed", "lambda_stats_acat"):
        rec[name]["max_abs_err"] = 0.0

    def check(name, label, got_fn, want_fn, tol):
        err = compare(label, got_fn(), want_fn(), tol)
        torch.cuda.empty_cache()          # the twin's ~10 GB of temporaries
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)

    for tag, (b, w, k) in shapes:
        rows, up, u, t1, t0 = _stats_inputs(b, w, k, b + w + k, dev)
        shape = f"B={b} W={w} K={k}"
        for approx, tol in ((False, TOL), (True, TOL_APPROX)):
            check("batch_stats_fused_v2_packed",
                  f"K7 {shape} approx={approx}",
                  lambda: stats_packed.batch_stats_fused_v2_packed(
                      rows, u, t1, t0, approx_div=approx),
                  lambda: twin_stats(rows, up, t1, t0, approx), tol)
        check("batch_stats_fused_packed", f"K6 {shape}",
              lambda: stats_packed.batch_stats_fused_packed(rows, u, t1, t0),
              lambda: twin_stats(rows, up, t1, t0), TOL)
        k6_is_k7(f"K6 {shape}", rows, u, t1, t0)
        check("gamma_stats_packed", f"K5 {shape}",
              lambda: [stats_packed.gamma_stats_packed(rows, up, t1, t0)],
              lambda: [stats_packed.gamma_stats_packed_twin(rows, up, t1,
                                                            t0)], TOL)
        if tag == "big-N":
            pr = present(rows)
            # K7, K6: D, the lambda sums and the gamma sums (6K FMAs) and
            # two divides per present entry; g, l0, l1 out
            fused_flops = pr * (12 * k + 2)
            fused_bytes = nbytes(rows, u, t1, t0, u, t1, t0)
            _timed(rec["batch_stats_fused_v2_packed"], f"K7 {shape}",
                   lambda: stats_packed.batch_stats_fused_v2_packed(
                       rows, u, t1, t0),
                   lambda: twin_stats(rows, up, t1, t0),
                   fused_flops, fused_bytes)
            _timed(rec["batch_stats_fused_packed"], f"K6 {shape}",
                   lambda: stats_packed.batch_stats_fused_packed(
                       rows, u, t1, t0),
                   lambda: twin_stats(rows, up, t1, t0),
                   fused_flops, fused_bytes)
            _timed(rec["gamma_stats_packed"], f"K5 {shape}",
                   lambda: stats_packed.gamma_stats_packed(rows, up, t1, t0),
                   lambda: stats_packed.gamma_stats_packed_twin(
                       rows, up, t1, t0),
                   pr * lambda_pass_flops(k), nbytes(rows, up, t1, t0, up))
        del rows, up, u, t1, t0

    # K7 across K at the big-N shape: K = 8 and 16 beside the step's 10
    # (what padding K to the instantiated width costs shows as K = 10 ~ 16)
    r = rec["batch_stats_fused_v2_packed"]
    r["k_sweep"] = []
    for k in (8, 10, 16):
        b, w, _ = BIGN
        rows, up, u, t1, t0 = _stats_inputs(b, w, k, b + w + k, dev)
        e = dict(shape=f"B={b} W={w} K={k}", ms=time_ms(
            lambda: stats_packed.batch_stats_fused_v2_packed(rows, u, t1, t0),
            5))
        log(f"  K7 {e['shape']}: kernel {e['ms']:.4f} ms")
        set_bound(e, present(rows) * (12 * k + 2),
                  nbytes(rows, u, t1, t0, u, t1, t0))
        r["k_sweep"].append(e)
        del rows, up, u, t1, t0
    phase_gamma_pass(dev, rec)
    phase_kernels_km12(dev, rec)

    for tag, (b, w, k) in (("big-N", sub), shapes[1]):
        rows, up, _, t1, t0 = _stats_inputs(b, w, k, b + w, dev)
        a1, a0 = stats_packed.decode_count_planes(rows)
        for approx, tol in ((False, TOL), (True, TOL_APPROX)):
            check("lambda_stats_acat",
                  f"K8 B={b} (4, {w}) K={k} approx={approx}",
                  lambda: stats_packed.lambda_stats_acat(
                      a1, a0, up, t1, t0, approx_div=approx),
                  lambda: stats_packed.lambda_stats_acat_twin(
                      a1, a0, up, t1, t0, approx_div=approx), tol)
        if tag == "big-N":
            _timed(rec["lambda_stats_acat"], f"K8 B={b} (4, {w}) K={k}",
                   lambda: stats_packed.lambda_stats_acat(
                       a1, a0, up, t1, t0, approx_div=True),
                   lambda: stats_packed.lambda_stats_acat_twin(
                       a1, a0, up, t1, t0, approx_div=True),
                   int(((a1 + a0) > 0).sum()) * lambda_pass_flops(k),
                   nbytes(a1, a0, up, t1, t0, t1, t0), reps=20)


# B, W, K at which the paths run one gamma pass: K1's at the TGP shape,
# K2's at config #3; at K > 64 K1's and K2's at config #3's width
GAMMA_SHAPES = [(4096, 640, 8), (1024, 640, 8)]
GAMMA_WIDE_SHAPES = [(1024, 640, 72)]


def phase_gamma_pass(dev, rec):
    """The gamma pass alone, through K5's entry (the pass body K1 and K2
    end with, plus its slice reduction), at the shapes the paths run it,
    from a CUDA graph of 100 calls, beside its bound; at K > 64
    (`gamma_pass_wide_kernel`) f32 and bf16, each held to its twin and
    bitwise on a re-run first."""
    r = rec["gamma_stats_packed"]
    r["passes"] = []
    for b, w, k in GAMMA_SHAPES + GAMMA_WIDE_SHAPES:
        rows, up, lamb = _solve_inputs(b, w, k, b + w + k, dev)
        t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
        e = dict(shape=f"B={b} W={w} K={k}")
        if k > 64:
            for dtype, name, tol in (
                    (torch.float32, "gamma_stats_packed", TOL),
                    (BF16, "gamma_stats_packed[bf16]", TOL_BF16_PASS)):
                hold(rec, name, f"γ pass {e['shape']} {dtype}",
                     twice("γ pass", lambda: [stats_packed.gamma_stats_packed(
                         rows, up, t1, t0, dtype)]),
                     [stats_packed.gamma_stats_packed_twin(rows, up, t1, t0,
                                                           dtype)], tol)
        e["ms"] = device_ms(
            lambda: stats_packed.gamma_stats_packed(rows, up, t1, t0))
        log(f"  gamma pass {e['shape']}: {e['ms']:.4f} ms (device time, "
            "launches replayed from a CUDA graph)")
        set_bound(e, present(rows) * lambda_pass_flops(k),
                  nbytes(rows, up, t1, t0, up))
        e["share_of_bound"] = e["bound_ms"] / e["ms"]
        if k > 64:
            e["bf16_ms"] = device_ms(lambda: stats_packed.gamma_stats_packed(
                rows, up, t1, t0, BF16))
            tmp = {}
            set_bound_bf16(tmp, present(rows), k, nbytes(rows, up, t1, t0, up))
            e["bf16_bound_ms"] = tmp["bound_ms"]
            log(f"  gamma pass[bf16] {e['shape']}: {e['bf16_ms']:.4f} ms "
                "(CUDA graph)")
        r["passes"].append(e)


# The γ pass at K > 64 at other row splits than `gamma_grid`'s
# (--kernels): config #3's width, the big-N shape and the K = 256 timed
# shape, at row splits of 1 to 64 row tiles
GAMMA_SWEEP_SHAPES = [(1024, 640, 72), (BIGN[0], BIGN[1], 72),
                      (1024, 2048, 256)]
GAMMA_SWEEP_TILES = (1, 2, 3, 4, 6, 8, 16, 32, 64)


# The γ pass at K <= 64 at other row splits than `gamma_grid`'s
# (--kernels): the shapes K1 and K2 end with and K5's big-N shape, at
# GAMMA_NARROW_SPLITS row slices (none under 32 rows)
GAMMA_NARROW_SWEEP_SHAPES = GAMMA_SHAPES + [BIGN]
GAMMA_NARROW_SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 20, 26, 32, 48, 64, 128)


def gamma_split_sweep(dev, rec):
    """Device ms of the γ pass through K5's entry, f32 and bf16, at other
    row splits than the one `gamma_grid` chose: at K <= 64 at
    GAMMA_NARROW_SPLITS slices, at K > 64 at the splits that slices of
    GAMMA_SWEEP_TILES row tiles give (from a CUDA graph of 50 calls; at
    the big-N shape CUDA events over 3 launches)."""
    out = rec["gamma_stats_packed"].setdefault("narrow_split_sweep", [])
    for b, w, k in GAMMA_NARROW_SWEEP_SHAPES:
        rows, up, _, t1, t0 = _stats_inputs(b, w, k, b + w + k, dev)
        e = dict(shape=f"B={b} W={w} K={k}", split_sweep_ms={},
                 bf16_split_sweep_ms={},
                 chosen=stats_packed.gamma_grid(b, w, k),
                 bf16_chosen=bf16_grid(stats_packed.gamma_grid, b, w, k))

        def timer(fn):
            return time_ms(fn, 3) if w > 4096 else device_ms(fn, 50)

        for nsplit in GAMMA_NARROW_SPLITS:
            if nsplit > -(-b // 32) or (w > 4096 and nsplit > 8):
                continue
            for key, bf16 in (("split_sweep_ms", False),
                              ("bf16_split_sweep_ms", True)):
                e[key][nsplit] = timer(
                    lambda: stats_packed.launch_gamma_stats_packed(
                        rows, up, t1, t0, nsplit, bf16))
        log(f"  γ pass {e['shape']}, row splits (chosen {e['chosen']}, "
            f"bf16 {e['bf16_chosen']}): "
            + ", ".join(f"{n}: {e['split_sweep_ms'][n]:.4f} / "
                        f"{e['bf16_split_sweep_ms'][n]:.4f}"
                        for n in e["split_sweep_ms"]) + " ms (f32 / bf16)")
        out.append(e)
        del rows, up, t1, t0
        torch.cuda.empty_cache()
    out = rec["gamma_stats_packed"].setdefault("wide_split_sweep", [])
    for b, w, k in GAMMA_SWEEP_SHAPES:
        rows, up, _, t1, t0 = k7_wide_inputs(dev, b, w, k)
        tiles = -(-b // 64)
        e = dict(shape=f"B={b} W={w} K={k}",
                 chosen=stats_packed.gamma_grid(b, w, k),
                 split_sweep_ms={}, bf16_split_sweep_ms={})
        def timer(fn):
            return time_ms(fn, 3) if w > 4096 else device_ms(fn, 50)

        for n in GAMMA_SWEEP_TILES:
            nsplit = -(-tiles // n)
            if nsplit in e["split_sweep_ms"] or n > tiles:
                continue
            for key, bf16 in (("split_sweep_ms", False),
                              ("bf16_split_sweep_ms", True)):
                e[key][nsplit] = timer(
                    lambda: stats_packed.launch_gamma_stats_packed(
                        rows, up, t1, t0, nsplit, bf16))
        log(f"  γ pass {e['shape']}, row splits (chosen {e['chosen']}): "
            + ", ".join(f"{n}: {e['split_sweep_ms'][n]:.4f} / "
                        f"{e['bf16_split_sweep_ms'][n]:.4f}"
                        for n in e["split_sweep_ms"]) + " ms (f32 / bf16)")
        out.append(e)
        del rows, up, t1, t0
        torch.cuda.empty_cache()


def phase_kernels_km12(dev, rec):
    """K7 (both divides) and K5 against their twins at the K where a
    K-width of 12 begins and ends (9, 10, 12, 13), on a ragged B and an odd
    W with whole rows MISSING, each bitwise against its second run."""
    for k in (9, 10, 12, 13):
        b, w = 300, 385
        rows, up, u, t1, t0 = _stats_inputs(b, w, k, k + 12, dev)
        rows[7] = 0xFF
        rows[-1] = 0xFF
        shape = f"B={b} W={w} K={k}"
        for approx, tol in ((False, TOL), (True, TOL_APPROX)):
            hold(rec, "batch_stats_fused_v2_packed",
                 f"K7 {shape} approx={approx}",
                 twice(f"K7 {shape}",
                       lambda: stats_packed.batch_stats_fused_v2_packed(
                           rows, u, t1, t0, approx_div=approx)),
                 twin_stats(rows, up, t1, t0, approx), tol)
        hold(rec, "gamma_stats_packed", f"K5 {shape}",
             twice(f"K5 {shape}", lambda: [stats_packed.gamma_stats_packed(
                 rows, up, t1, t0)]),
             [stats_packed.gamma_stats_packed_twin(rows, up, t1, t0)], TOL)
    log("  K = 9, 10, 12, 13: K7 and K5 within tolerance, re-runs bitwise")


def phase_kernels_wide(dev, rec):
    """K > 64. K1, K2, K4 and K8 (the λ pass's K > 64 body,
    `lambda_pass_wide_kernel`) at K = 65..1000 (WIDE_LAMBDA_KS: one piece
    of K up to 128, then two and eight), f32 and bf16, both divides (K1's
    loop passes: the Newton step, or fast), ragged B, odd W, rows MISSING,
    a null group for K2; K5, K6 and K7 at K = 72, 130 and 256 (K7 at
    K7_WIDE_KS, both dtypes); each against its twin and bitwise against
    its second run, K2 bitwise K1 on the gathered rows. Then K8 at the
    big-N step's subsample held to its twin at both dtypes and divides,
    and one timed shape per family beside its bound."""
    plain = dict(local_iters=4, local_tol=-1.0, beta_a=1.0, beta_b=1.0)
    for k in WIDE_LAMBDA_KS:
        rows, up, lamb = _solve_inputs(40, 235, k, k, dev)
        rows[5] = 0xFF
        rows[-1] = 0xFF
        t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
        a1, a0 = stats_packed.decode_count_planes(rows)
        b, g, l = 40, 8, 1024
        packed, up2, lamb2 = _solve_inputs(l, 256, k, k + 1, dev)
        lamb2 = lamb2[:b].contiguous()
        gen = torch.Generator(device=dev).manual_seed(b)
        idx0 = torch.randint(0, l // g, (b // g,), generator=gen, device=dev,
                             dtype=torch.int32) * g
        idx0[1] = l                         # a null group: reads as MISSING
        rows2 = packed[(idx0.long().clamp(max=l - g)[:, None]
                        + torch.arange(g, device=dev)).reshape(b)]
        rows2[g:2 * g] = 0xFF
        for dtype, approx in ((torch.float32, False), (torch.float32, True),
                              (BF16, False), (BF16, True)):
            bf16 = dtype == BF16
            tag = "[bf16]" if bf16 else ""
            tol = (TOL_APPROX if approx else
                   TOL_BF16_PASS if bf16 else TOL)
            stol = (TOL_APPROX if approx else
                    TOL_BF16_SOLVE if bf16 else TOL)
            kind = f"{'bf16' if bf16 else 'f32'} approx={approx}"
            shape = f"B=40 W=235 K={k} {kind}"
            want = stats_packed.lambda_stats_packed_twin(
                rows, up, t1, t0, approx_div=approx, dtype=dtype)
            hold(rec, f"lambda_stats_packed{tag}", f"K4 wide {shape}",
                 twice("K4 wide", lambda: stats_packed.lambda_stats_packed(
                     rows, up, t1, t0, approx_div=approx, dtype=dtype)),
                 want, tol)
            hold(rec, f"lambda_stats_acat{tag}", f"K8 wide {shape}",
                 twice("K8 wide", lambda: stats_packed.lambda_stats_acat(
                     a1, a0, up, t1, t0, approx_div=approx, dtype=dtype)),
                 want, tol)
            kw = dict(plain, approx_div=approx, dtype=dtype)
            got = twice("K1 wide", lambda: fused_step.fused_local_solve(
                rows, up, lamb, **kw))
            want = fused_step.fused_local_solve_twin(rows, up, lamb, **kw)
            hold(rec, f"fused_local_solve{tag}", f"K1 wide {shape} g",
                 got[1:], want[1:], stol)
            hold(rec, f"fused_local_solve{tag}", f"K1 wide {shape} lambda",
                 got[:1], want[:1], stol, FLIP_FRAC if bf16 else 0.0)
            kw = dict(kw, warm_start=True)
            got = twice("K2 wide", lambda: fused_step.fused_local_solve_dma(
                idx0, packed, up2, lamb2, group=g, **kw))
            k1 = fused_step.fused_local_solve(rows2, up2, lamb2, **kw)
            if not all(torch.equal(a, c) for a, c in zip(got, k1)):
                raise AssertionError(f"K2 wide {shape}: differs from K1 on "
                                     "the gathered rows")
            want = fused_step.fused_local_solve_twin(rows2, up2, lamb2, **kw)
            hold(rec, f"fused_local_solve_dma{tag}",
                 f"K2 wide B=40 W=256 K={k} g=8 {kind} g", got[1:],
                 want[1:], stol)
            hold(rec, f"fused_local_solve_dma{tag}",
                 f"K2 wide B=40 W=256 K={k} g=8 {kind} lambda",
                 got[:1], want[:1], stol, FLIP_FRAC if bf16 else 0.0)

    for kk in K7_WIDE_KS:
        rows3, up3, u3, t13, t03 = _stats_inputs(40, 300, kk, kk, dev)
        rows3[3] = 0xFF
        shape = f"B=40 W=300 K={kk}"
        if kk in (72, 130, 256):
            for dtype, name, tol in (
                    (torch.float32, "gamma_stats_packed", TOL),
                    (BF16, "gamma_stats_packed[bf16]", TOL_BF16_PASS)):
                hold(rec, name, f"K5 wide {shape} {dtype}",
                     twice("K5 wide", lambda: [stats_packed.gamma_stats_packed(
                         rows3, up3, t13, t03, dtype)]),
                     [stats_packed.gamma_stats_packed_twin(
                         rows3, up3, t13, t03, dtype)], tol)
            for dtype, name, tol in (
                    (torch.float32, "batch_stats_fused_packed", TOL),
                    (BF16, "batch_stats_fused_packed[bf16]", TOL_BF16_PASS)):
                hold(rec, name, f"K6 wide {shape} {dtype}",
                     twice("K6 wide",
                           lambda: stats_packed.batch_stats_fused_packed(
                               rows3, u3, t13, t03, dtype=dtype)),
                     twin_stats(rows3, up3, t13, t03, dtype=dtype), tol)
                k6_is_k7(f"K6 wide {shape} {dtype}", rows3, u3, t13, t03,
                         dtype)
        for dtype, approx in ((torch.float32, False), (torch.float32, True),
                              (BF16, False), (BF16, True)):
            tol = (TOL_APPROX if approx else
                   TOL if dtype == torch.float32 else TOL_BF16_PASS)
            name = ("batch_stats_fused_v2_packed[bf16]" if dtype == BF16
                    else "batch_stats_fused_v2_packed")
            hold(rec, name, f"K7 wide {shape} {dtype} approx={approx}",
                 twice("K7 wide",
                       lambda: stats_packed.batch_stats_fused_v2_packed(
                           rows3, u3, t13, t03, approx_div=approx,
                           dtype=dtype)),
                 twin_stats(rows3, up3, t13, t03, approx, dtype), tol)
    log("  wide bodies: every second run bitwise equal; K2 bitwise K1")

    # K8 at the big-N step's subsample (B = 4,096, 4 x 2,048 individuals,
    # K = 72; 7 a step there, with the fast divide): held to its twin at
    # both dtypes and both divides, then timed beside its bound
    b, w, k = BIGN[0], BIGN_SUB_W, REP_WIDE_K
    x, call = wide_lambda_inputs(dev, "K8", b, w, k)
    a1, a0, up, t1, t0 = x
    for dtype, approx in ((torch.float32, False), (torch.float32, True),
                          (BF16, False), (BF16, True)):
        bf16 = dtype == BF16
        hold(rec, "lambda_stats_acat[bf16]" if bf16 else "lambda_stats_acat",
             f"K8 wide B={b} (4, {w}) K={k} {'bf16' if bf16 else 'f32'} "
             f"approx={approx}",
             twice("K8 wide", lambda: call(dtype, approx)),
             stats_packed.lambda_stats_acat_twin(
                 a1, a0, up, t1, t0, approx_div=approx, dtype=dtype),
             TOL_APPROX if approx else TOL_BF16_PASS if bf16 else TOL)
    e = dict(shape=f"B={b} (4, {w}) K={k} approx", plain_ms=None)
    moved = nbytes(a1, a0, up, t1, t0, t1, t0)
    entries = int(((a1 + a0) > 0).sum())
    _timed(e, f"K8 wide {e['shape']}", lambda: call(approx=True),
           lambda: stats_packed.lambda_stats_acat_twin(a1, a0, up, t1, t0,
                                                       approx_div=True),
           entries * lambda_pass_flops(k), moved, reps=20)
    _wide_lambda_bf16(e, lambda: call(BF16, True), entries, k, moved)
    rec["lambda_stats_acat"]["wide"] = [e]
    del x, call, up, t1, t0, a1, a0

    # one timed shape per family at K = 72 and 256, beside its bound (the
    # work of the function: 8K+2 operations per present entry for a lambda
    # or gamma pass, 12K+2 for K6/K7, whatever a body recomputes); the
    # twins only at K = 72 (at K = 256 their dense (B, 4W, K) products
    # would hold ~9 GB each)
    for name in ("lambda_stats_packed", "gamma_stats_packed",
                 "batch_stats_fused_v2_packed", "batch_stats_fused_packed"):
        rec[name]["wide"] = []
    for k in (72, 256):
        b, w = 1024, 640
        (rows, up, _, t1, t0), call = wide_lambda_inputs(dev, "K4", b, w, k)
        e = dict(shape=f"B={b} W={w} K={k}", body="wide λ pass (K4's entry)",
                 plain_ms=None)
        e["ms"] = device_ms(call)
        e["approx_ms"] = device_ms(lambda: call(approx=True))
        if k == 72:
            e["plain_ms"] = time_ms(
                lambda: stats_packed.lambda_stats_packed_twin(rows, up, t1, t0))
        log(f"  wide λ pass {e['shape']}: {e['ms']:.4f} ms, fast divide "
            f"{e['approx_ms']:.4f} ms (CUDA graph); twin {e['plain_ms']} ms")
        set_bound(e, present(rows) * lambda_pass_flops(k),
                  nbytes(rows, up, t1, t0, t1, t0))
        _wide_lambda_bf16(e, lambda: call(BF16), present(rows), k,
                          nbytes(rows, up, t1, t0, t1, t0), graph=True)
        rec["lambda_stats_packed"]["wide"].append(e)

        b, w = 1024, 2048
        x = rows, up, u, t1, t0 = k7_wide_inputs(dev, b, w, k)
        pr = present(rows)
        for name, kernel, twin, flops, moved in (
                ("gamma_stats_packed",
                 lambda: stats_packed.gamma_stats_packed(rows, up, t1, t0),
                 lambda: stats_packed.gamma_stats_packed_twin(rows, up, t1,
                                                              t0),
                 pr * lambda_pass_flops(k), nbytes(rows, up, t1, t0, up)),
                ("batch_stats_fused_v2_packed",
                 lambda: stats_packed.batch_stats_fused_v2_packed(rows, u, t1,
                                                                  t0),
                 lambda: twin_stats(rows, up, t1, t0),
                 pr * (12 * k + 2), nbytes(rows, u, t1, t0, u, t1, t0)),
                ("batch_stats_fused_packed",
                 lambda: stats_packed.batch_stats_fused_packed(rows, u, t1,
                                                               t0),
                 lambda: twin_stats(rows, up, t1, t0),
                 pr * (12 * k + 2), nbytes(rows, u, t1, t0, u, t1, t0))):
            e = dict(shape=f"B={b} W={w} K={k}")
            label = f"{name} wide {e['shape']}"
            fused = name != "gamma_stats_packed"
            k6 = name == "batch_stats_fused_packed"
            if k == 72:
                _timed(e, label, kernel, twin, flops, moved)
            else:
                e["ms"], e["plain_ms"] = (
                    k7_wide_ms(x, torch.float32, 5, k6) if fused
                    else time_ms(kernel, 3), None)
                log(f"  {label}: kernel {e['ms']:.4f} ms")
                set_bound(e, flops, moved)
            if fused:
                _k7_wide_bf16(e, x, k, moved, 3 if k == 72 else 5, k6)
            rec[name]["wide"].append(e)
        del rows, up, u, t1, t0, x

    # K7 and K6 at the big-N shape with K = 72: their partial buffers
    # (B tiles of `v2_b_tile` rows of gamma, 256 here, for both) beside
    # the kernel's time. K7 is held to its twin there first, f32 and bf16,
    # both divides, and K6 bitwise to K7 at the exact divide: the shape
    # their B tiles of 4 row tiles and 98 W tiles of 16 sub-tiles take on
    # the main path (the twin's (B, 4W) temporaries, ~10 GB, freed before
    # the timing)
    b, w, _ = BIGN
    k = 72
    x = rows, up, u, t1, t0 = k7_wide_inputs(dev, b, w, k)
    pr = present(rows)
    shape = f"B={b} W={w} K={k}"
    for dtype, approx in ((torch.float32, False), (torch.float32, True),
                          (BF16, False), (BF16, True)):
        hold(rec, ("batch_stats_fused_v2_packed[bf16]" if dtype == BF16
                   else "batch_stats_fused_v2_packed"),
             f"K7 wide {shape} {dtype} approx={approx}",
             twice("K7 wide", lambda: stats_packed.batch_stats_fused_v2_packed(
                 rows, u, t1, t0, approx_div=approx, dtype=dtype)),
             twin_stats(rows, up, t1, t0, approx, dtype),
             TOL_APPROX if approx else
             TOL if dtype == torch.float32 else TOL_BF16_PASS)
        torch.cuda.empty_cache()
        if not approx:
            k6_is_k7(f"K6 wide {shape} {dtype}", rows, u, t1, t0, dtype)
    plain_ms = time_ms(lambda: twin_stats(rows, up, t1, t0), 2)
    torch.cuda.empty_cache()
    for name, k6 in (("batch_stats_fused_v2_packed", False),
                     ("batch_stats_fused_packed", True)):
        e = dict(shape=shape, plain_ms=plain_ms, gamma_partials_bytes=(
            stats_packed.v2_partial_shapes(b, w, k)[1][0] * 4 * w * k * 4))
        e["ms"] = k7_wide_ms(x, torch.float32, 3, k6)
        log(f"  {name} wide {e['shape']}: kernel {e['ms']:.4f} ms, twin "
            f"{plain_ms:.3f} ms, gamma partials "
            f"{e['gamma_partials_bytes'] / 1e9:.3f} GB")
        moved = nbytes(rows, u, t1, t0, u, t1, t0)
        set_bound(e, pr * (12 * k + 2), moved)
        _k7_wide_bf16(e, x, k, moved, 3, k6)
        rec[name]["wide"].append(e)
        torch.cuda.empty_cache()
    # K5 at the big-N shape with K = 72 (`gamma_pass_wide_kernel`: 1,568
    # column tiles walking all 64 row tiles), held to its twin at both
    # dtypes, bitwise on a re-run, then timed beside its bounds
    for dtype, name, tol in ((torch.float32, "gamma_stats_packed", TOL),
                             (BF16, "gamma_stats_packed[bf16]",
                              TOL_BF16_PASS)):
        hold(rec, name, f"K5 wide {shape} {dtype}",
             twice("K5 wide", lambda: [stats_packed.gamma_stats_packed(
                 rows, up, t1, t0, dtype)]),
             [stats_packed.gamma_stats_packed_twin(rows, up, t1, t0, dtype)],
             tol)
        torch.cuda.empty_cache()
    e = dict(shape=shape, plain_ms=None)
    moved = nbytes(rows, up, t1, t0, up)
    _timed(e, f"K5 wide {shape}",
           lambda: stats_packed.gamma_stats_packed(rows, up, t1, t0),
           lambda: stats_packed.gamma_stats_packed_twin(rows, up, t1, t0),
           pr * lambda_pass_flops(k), moved)
    e["bf16_ms"] = time_ms(lambda: stats_packed.gamma_stats_packed(
        rows, up, t1, t0, BF16), 5)
    tmp = {}
    set_bound_bf16(tmp, pr, k, moved)
    e["bf16_bound_ms"] = tmp["bound_ms"]
    log(f"  K5[bf16] wide {shape}: kernel {e['bf16_ms']:.4f} ms, bound "
        f"{e['bf16_bound_ms']:.5f} ms")
    rec["gamma_stats_packed"]["wide"].append(e)
    torch.cuda.empty_cache()
    del rows, up, u, t1, t0, x
    # K2 at config #3's step with K = 72 on the main path's accel schedule
    # (`wide_k2_inputs`): bitwise K1 on the gathered rows, then timed
    # beside its bound (its λ passes and its γ pass over the gathered
    # rows' present entries) and its twin, f32 and bf16
    idx0, packed, up2, lamb2, rows2 = wide_k2_inputs(dev)
    b, w = rows2.shape
    e = dict(shape=f"L={packed.shape[0]} B={b} W={w} K={k} g=8 accel7")
    for dtype, key in ((torch.float32, ""), (BF16, "bf16_")):
        kw = dict(REP_WIDE_MAIN, dtype=dtype)

        def call():
            return fused_step.fused_local_solve_dma(idx0, packed, up2, lamb2,
                                                    group=8, **kw)

        if not all(torch.equal(a, c) for a, c in zip(
                call(), fused_step.fused_local_solve(rows2, up2, lamb2,
                                                     **kw))):
            raise AssertionError(f"K2 wide {e['shape']} {dtype}: differs "
                                 "from K1 on the gathered rows")
        e[key + "ms"] = time_ms(call, 10)
        tmp = {}
        solve_bound(tmp, rows2, up2, lamb2, kw, extra_bytes=nbytes(idx0))
        e[key + "bound_ms"] = tmp["bound_ms"]
        if not key:
            e["bound_by"] = tmp["bound_by"]
    e["plain_ms"] = time_ms(lambda: fused_step.fused_local_solve_twin(
        rows2, up2, lamb2, **dict(REP_WIDE_MAIN)), 2)
    e["library_ms"] = None
    log(f"  K2 wide {e['shape']}: bitwise K1 on the gathered rows; kernel "
        f"{e['ms']:.4f} ms (bf16 {e['bf16_ms']:.4f}), bound "
        f"{e['bound_ms']:.4f} (bf16 {e['bf16_bound_ms']:.5f}) ms, twin "
        f"{e['plain_ms']:.3f} ms")
    rec["fused_local_solve_dma"]["wide"] = [e]
    del idx0, packed, up2, lamb2, rows2


def wide_lambda_inputs(dev, kernel, b, w, k):
    """The λ pass at K > 64 through K8's entry (kernel "K8": the count
    planes of rows from the seed 8, as the big-N step's subsample) or K4's
    (packed rows from the seed b + w + k): its inputs x, (a1, a0, up, t1,
    t0) or (rows, up, λ, t1, t0), and call(dtype, approx), one pass on
    them. phase_kernels_wide and --digest build and time it so."""
    if kernel == "K8":
        rows, up, _, t1, t0 = _stats_inputs(b, w, k, 8, dev)
        a1, a0 = stats_packed.decode_count_planes(rows)
        del rows
        return (a1, a0, up, t1, t0), (
            lambda dtype=torch.float32, approx=False:
            stats_packed.lambda_stats_acat(a1, a0, up, t1, t0,
                                           approx_div=approx, dtype=dtype))
    rows, up, lamb = _solve_inputs(b, w, k, b + w + k, dev)
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    return (rows, up, lamb, t1, t0), (
        lambda dtype=torch.float32, approx=False:
        stats_packed.lambda_stats_packed(rows, up, t1, t0,
                                         approx_div=approx, dtype=dtype))


def wide_k2_inputs(dev, b=1024, w=640, k=72, l=65_536, g=8):
    """K2 at config #3's step with K > 64: g-row groups of a (L, W) matrix
    from the seed 21, b / g distinct group starts, and lambda of its first
    b rows: (idx0, packed, u planes, lambda, the gathered rows).
    phase_kernels_wide and --digest build and time it so."""
    packed, up, lamb = _solve_inputs(l, w, k, 21, dev)
    idx0 = torch.randperm(l // g, generator=torch.Generator(
        device=dev).manual_seed(21), device=dev)[:b // g].int() * g
    rows = packed[(idx0.long()[:, None]
                   + torch.arange(g, device=dev)).reshape(b)]
    return idx0, packed, up, lamb[:b].contiguous(), rows


def k7_wide_inputs(dev, b, w, k, r=None):
    """K7's inputs at K > 64 from the seed b + w + k: rows, u planes, u,
    t1 and t0, each with a leading r where r is given (`_rep_inputs`)."""
    if r is None:
        return _stats_inputs(b, w, k, b + w + k, dev)
    rows, up, lamb = _rep_inputs(b, w, k, b + w + k, dev, r)
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    return rows, up, stats_packed.planes_to_flat(up).contiguous(), t1, t0


def k7_wide_ms(x, dtype, reps, k6=False):
    """Device ms of a call of K7 (K6 where `k6`) through its wrapper on x
    (`k7_wide_inputs`) at dtype: CUDA events over reps launches after a
    warm-up. phase_kernels_wide and --digest time it so."""
    rows, _, u, t1, t0 = x
    fn = (stats_packed.batch_stats_fused_packed if k6
          else stats_packed.batch_stats_fused_v2_packed)
    ms = time_ms(lambda: fn(rows, u, t1, t0, dtype=dtype), reps)
    torch.cuda.empty_cache()
    return ms


def _k7_wide_bf16(e, x, k, moved, reps, k6=False):
    """K7's (K6's where `k6`) bf16 body at K > 64 timed beside the f32
    body's entry e (`k7_wide_ms`), with its bf16 bound."""
    e["bf16_ms"] = k7_wide_ms(x, BF16, reps, k6)
    tmp = {}
    set_bound_bf16(tmp, present(x[0]), k, moved, sums=2)
    e["bf16_bound_ms"] = tmp["bound_ms"]
    log(f"  {'K6' if k6 else 'K7'}[bf16] wide {e['shape']}: kernel "
        f"{e['bf16_ms']:.4f} ms, bound {e['bf16_bound_ms']:.5f} ms")


def _wide_lambda_bf16(e, kernel, entries, k, moved, graph=False):
    """The K > 64 λ pass's bf16 body timed beside the f32 body's entry e
    (from a CUDA graph where `graph`), with its bf16 bound."""
    e["bf16_ms"] = (device_ms if graph else time_ms)(kernel, 20)
    tmp = {}
    set_bound_bf16(tmp, entries, k, moved)
    e["bf16_bound_ms"] = tmp["bound_ms"]
    log(f"  wide λ pass[bf16] {e['shape']}: kernel {e['bf16_ms']:.4f} ms, "
        f"bound {e['bf16_bound_ms']:.5f} ms")


def pin(label, got, f32, free=()):
    """The divergence pin: each output of a bf16 body differs from the f32
    body's on the same inputs by more than PIN_LO somewhere and by less
    than PIN_HI everywhere, relative to its largest magnitude. Outputs
    whose index is in `free` are printed but not pinned: lambda after the
    accel tail, an extrapolation whose clamped Aitken step turns the
    bodies' ~1e-3 gap in the iterates into up to 9|d1| a coordinate (on
    random inputs far from the fixed point, 16% of lambda_B moves by more
    than PIN_HI); the gamma statistic computed from it stays pinned."""
    rel = [float(((a - b).abs() / b.abs().max()).max())
           for a, b in zip(got, f32)]
    log(f"  {label} bf16 vs f32: " + ", ".join(
        f"{x:.2e}" + (" (accel lambda, not pinned)" if i in free else "")
        for i, x in enumerate(rel))
        + f" of the largest magnitude (pin {PIN_LO:g}..{PIN_HI:g})")
    if not all(PIN_LO < x < PIN_HI
               for i, x in enumerate(rel) if i not in free):
        raise AssertionError(f"{label}: bf16 body outside the divergence pin")


def hold_bf16(rec, name, label, kernel, twin, tol, frac=0.0, accel=False):
    """A bf16 case: kernel(dtype) re-run bitwise, held against its bf16
    twin at tol, and pinned against the f32 body on the same inputs. A
    solve's outputs (lambda_B, g) are held apart: lambda_B with the share
    frac of its entries allowed beyond tol, g everywhere; with accel,
    lambda_B is not pinned (`pin`)."""
    got = twice(label, lambda: kernel(BF16))
    want = twin()
    if len(got) == 2 and frac:
        hold(rec, name, f"{label} g", got[1:], want[1:], tol)
        hold(rec, name, f"{label} lambda", got[:1], want[:1], tol, frac)
    else:
        hold(rec, name, label, got, want, tol)
    pin(label, got, kernel(torch.float32), (0,) if accel else ())
    return got


def in_turns(fa, fb, timer="events", reps=20):
    """Times of fa and fb in turns (a, b, b, a), by `time_ms` or, with
    timer "graph", `device_ms`: their means."""
    timer = device_ms if timer == "graph" else time_ms
    t = [timer(f, reps) for f in (fa, fb, fb, fa)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


# K7 at K > 64 (`stats_v2_wide_kernel`): one piece of K (65..128, pieces
# of 80, 96 and 128 columns) and several (129, 130: two of 80; 256: two of
# 128; 1000: eight of 128)
K7_WIDE_KS = (65, 72, 96, 128, 129, 130, 256, 1000)
# The λ pass at K > 64 (`lambda_pass_wide_kernel`, K1, K2, K4, K8), the
# same tile: one piece of K (65..128: run 80 wide to K = 80, else 128),
# two (129: two of 80; 256: two of 128) and eight (1000)
WIDE_LAMBDA_KS = (65, 72, 96, 128, 129, 256, 1000)
R_REP = 4    # replicates of the replicate-axis checks and of phase 9
# B, W, K of the replicate-axis cases and the kernels each runs there:
# first the shapes phase 9 runs (pad_width makes config #1's 1,000 and
# config #2's 940 individuals 256 bytes; the eval re-solves blocks of
# 1,024 rows), then the TGP step and a ragged B. The kernels' line takes
# each kernel's times and bound from its first shape.
REP_G_CAP = 1e-2    # every entry of K1[rep]'s g at the warm accel start
REP_SHAPES = [
    (256, 256, 3, ("K1",)),           # config #1's step (phase 9a-c)
    (1024, 256, 3, ("K4",)),          # config #1's eval block
    (1024, 256, 7, ("K1", "K4")),     # config #2's step and eval block (9d)
    (4096, 640, 8, ("K1", "K4")),     # the TGP step
    (1000, 256, 3, ("K1", "K4")),     # ragged B
]


def _rep_inputs(b, w, k, seed, dev, r=R_REP):
    """r replicates' solve inputs, each `_solve_inputs` of its own seed:
    rows (r, B, W), u planes (r, 4, W, K), lambda (r, B, K, 2)."""
    ins = [_solve_inputs(b, w, k, seed + i, dev) for i in range(r)]
    return tuple(torch.stack(x) for x in zip(*ins))


def _bitwise_per_replicate(label, got, singles):
    """Each replicate's outputs of a batched call are bitwise the single
    call's on its inputs."""
    for i, one in enumerate(singles):
        if not all(torch.equal(g[i], o) for g, o in zip(got, one)):
            raise AssertionError(f"{label}: replicate {i} differs from the "
                                 "single call")


def phase_kernels_rep(dev, rec):
    """K1 and K4 with the replicate axis (R = 4) at the shapes phase 9
    runs them at (config #1's step and eval block, config #2's step and
    eval block), the TGP step and a ragged B, f32 and bf16: each
    replicate's outputs bitwise the single kernel's on its inputs, a
    second run bitwise, and held against the twins (the single calls'
    tolerances). K1 cold (the local mode) and warm (the stored mode),
    with replicate 0 warm-started at its fixed point, so that its tol
    loop exits after the first pass while the others run on (its single
    solve with the loop forced on differs: the exit was its own). K4 over
    rows every replicate shares and over rows of their own. Times in turns
    with the R single calls, beside R x the single bound (the passes each
    replicate's data needs).
    """
    main = dict(local_iters=7, local_tol=1e-4, accel=True, beta_a=1.0,
                beta_b=1.0)
    r1, r4 = rec["fused_local_solve[rep]"], rec["lambda_stats_packed[rep]"]
    r1["max_abs_err"] = r4["max_abs_err"] = 0.0
    r1["shapes"], r4["shapes"] = [], []
    for b, w, k, kernels in REP_SHAPES:
        shape = f"R={R_REP} B={b} W={w} K={k}"
        rows, up, lamb = _rep_inputs(b, w, k, b + w + k, dev)
        if "K1" in kernels:
            _hold_k1_rep(rec, shape, rows, up, lamb, main)
        t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
        if "K4" in kernels:
            _hold_k4_rep(rec, shape, rows, up, t1, t0)
        _time_rep(rec, shape, kernels, rows, up, lamb, t1, t0, main)


def _hold_k1_rep(rec, shape, rows, up, lamb, main, wide=False):
    """K1[rep] cold, warm and cold with replicate 0 all MISSING, f32 and
    bf16 (`phase_kernels_rep`). wide (K > 64): g and lambda of every case
    may differ from the twins on REP_WIDE_FRAC of their entries, g's each
    within rtol REP_G_CAP."""
    rows_m = rows.clone()
    rows_m[0] = 0xFF              # replicate 0 all MISSING
    for dtype in (torch.float32, BF16):
        dname = "bf16" if dtype == BF16 else "f32"
        lam0 = lamb.clone()
        # replicate 0 at its fixed point: 200 plain passes at this dtype
        lam0[0] = fused_step.fused_local_solve(
            rows[0], up[0], lamb[0], local_iters=200, local_tol=-1.0,
            beta_a=1.0, beta_b=1.0, warm_start=True, dtype=dtype)[0]
        for case, warm, rr in (("cold", False, rows), ("warm", True, rows),
                               ("cold, replicate 0 MISSING", False,
                                rows_m)):
            kw = dict(main, dtype=dtype, warm_start=warm)
            label = f"K1[rep] {shape} {dname} {case}"
            got = twice(label, lambda: fused_step.fused_local_solve(
                rr, up, lam0, **kw))
            singles = [fused_step.fused_local_solve(
                rr[i], up[i], lam0[i], **kw) for i in range(R_REP)]
            _bitwise_per_replicate(label, got, singles)
            twins = [fused_step.fused_local_solve_twin(
                rr[i], up[i], lam0[i], **kw) for i in range(R_REP)]
            tol = TOL if dtype == torch.float32 else TOL_BF16_SOLVE
            want = [torch.stack(x) for x in zip(*twins)]
            # a warm start far from the fixed point meets the accel
            # tail's clamped Aitken step: a lambda coordinate it moves far
            # shifts g in every column its row touches, so g is held by
            # the size of every entry (rtol REP_G_CAP), not by the share
            # beyond tol (measured on NVIDIA H100 80GB HBM3,
            # 700 W: 2.77% of the 4 replicates' g beyond TOL at config
            # #2's step, the largest 8.3e-4 of |twin|; the single K1 does
            # the same, each replicate being bitwise its single call)
            frac = 1.0 if warm else REP_WIDE_FRAC if wide else 0.0
            hold(rec, "fused_local_solve[rep]", f"{label} g", got[1:],
                 want[1:], tol, frac, cap=REP_G_CAP if frac else None)
            hold(rec, "fused_local_solve[rep]", f"{label} lambda",
                 got[:1], want[:1], tol, REP_WIDE_FRAC if wide else 1e-2)
            passes = [solve_passes(rr[i], up[i], lam0[i], **kw)
                      for i in range(R_REP)]
            log(f"  {label}: each replicate bitwise its single solve; "
                f"lambda passes a replicate (twin replay) {passes}")
            # replicate 0's own exit: at its fixed point (f32; bf16's
            # rounding keeps its change above the tol) and MISSING
            if case == "cold" or (case == "warm" and dtype == BF16):
                continue
            if passes[0] != 4 or min(passes[1:]) <= 4:
                raise AssertionError(f"{label}: replicate 0 does not "
                                     f"exit after the first pass alone")
            if case == "warm":
                forced = fused_step.fused_local_solve(
                    rr[0], up[0], lam0[0], **dict(kw, local_tol=-1.0))
                if torch.equal(forced[1], got[1][0]):
                    raise AssertionError(f"{label}: replicate 0's early "
                                         "exit changed nothing")
            log(f"  {label}: replicate 0 exits after the first loop "
                "pass, the others run on"
                + ("; its solve with the loop forced on differs"
                   if case == "warm" else ""))


def _hold_k4_rep(rec, shape, rows, up, t1, t0):
    """K4[rep] over rows shared and rows of each replicate's own, f32 and
    bf16, both divides (`phase_kernels_rep`)."""
    for dtype in (torch.float32, BF16):
        dname = "bf16" if dtype == BF16 else "f32"
        for approx in (False, True):
            for shared in (True, False):
                rr = rows[0] if shared else rows
                label = (f"K4[rep] {shape} {dname} approx={approx} "
                         f"rows {'shared' if shared else 'own'}")
                got = twice(label, lambda: stats_packed.lambda_stats_packed(
                    rr, up, t1, t0, approx_div=approx, dtype=dtype))
                singles = [stats_packed.lambda_stats_packed(
                    rr if shared else rr[i], up[i], t1[i], t0[i],
                    approx_div=approx, dtype=dtype)
                    for i in range(R_REP)]
                _bitwise_per_replicate(label, got, singles)
                twins = [stats_packed.lambda_stats_packed_twin(
                    rr if shared else rr[i], up[i], t1[i], t0[i],
                    approx_div=approx, dtype=dtype)
                    for i in range(R_REP)]
                tol = (TOL_APPROX if approx else
                       TOL if dtype == torch.float32 else TOL_BF16_PASS)
                hold(rec, "lambda_stats_packed[rep]", label, got,
                     [torch.stack(x) for x in zip(*twins)], tol)
    log(f"  K4[rep] {shape}: each replicate bitwise its single pass")


def _time_rep(rec, shape, kernels, rows, up, lamb, t1, t0, main):
    """K1 (cold, the local mode's step) and K4 (rows shared, the eval's
    pass) at R = 4 in turns with R single calls, f32 and bf16, beside R x
    the single bound; each kernel's first shape gives its entry in the
    kernels' line and the twins' time."""
    k = up.shape[-1]
    out = []
    if "K1" in kernels:
        e = dict(shape=shape)
        flops = moved = entries = 0
        for i in range(R_REP):
            kw = dict(main, warm_start=False)
            n_pass = solve_passes(rows[i], up[i], lamb[i], **kw) + 1
            flops += present(rows[i]) * lambda_pass_flops(k) * n_pass
            entries += present(rows[i]) * n_pass
            moved += nbytes(rows[i], up[i], up[i]) + lamb[i].numel() * 4
        for dtype, key in ((torch.float32, ""), (BF16, "bf16_")):
            kw = dict(main, dtype=dtype)
            e[key + "serial_ms"], e[key + "ms"] = in_turns(
                lambda: [fused_step.fused_local_solve(rows[i], up[i],
                                                      lamb[i], **kw)
                         for i in range(R_REP)],
                lambda: fused_step.fused_local_solve(rows, up, lamb, **kw))
        set_bound(e, flops, moved)
        e["bf16_bound_ms"] = max(entries * 8 * k / BF16_FLOPS * 1e3,
                                 entries * 2 / FP32_FLOPS * 1e3,
                                 moved / HBM_BYTES * 1e3)
        out.append(("K1[rep]", rec["fused_local_solve[rep]"], e,
                    lambda: [fused_step.fused_local_solve_twin(
                        rows[i], up[i], lamb[i], **main)
                        for i in range(R_REP)]))
    if "K4" in kernels:
        e = dict(shape=shape)
        for dtype, key in ((torch.float32, ""), (BF16, "bf16_")):
            e[key + "serial_ms"], e[key + "ms"] = in_turns(
                lambda: [stats_packed.lambda_stats_packed(
                    rows[0], up[i], t1[i], t0[i], dtype=dtype)
                    for i in range(R_REP)],
                lambda: stats_packed.lambda_stats_packed(rows[0], up, t1, t0,
                                                         dtype=dtype))
        ent = present(rows[0]) * R_REP
        moved = nbytes(rows[0], up, t1, t0, t1, t0)
        set_bound(e, ent * lambda_pass_flops(k), moved)
        e["bf16_bound_ms"] = max(ent * 8 * k / BF16_FLOPS * 1e3,
                                 ent * 2 / FP32_FLOPS * 1e3,
                                 moved / HBM_BYTES * 1e3)
        out.append(("K4[rep]", rec["lambda_stats_packed[rep]"], e,
                    lambda: [stats_packed.lambda_stats_packed_twin(
                        rows[0], up[i], t1[i], t0[i])
                        for i in range(R_REP)]))
    for name, r, e, twins in out:
        log(f"  {name} {shape}: batched {e['ms']:.4f} ms, {R_REP} single "
            f"calls in turns {e['serial_ms']:.4f} ms; bf16 "
            f"{e['bf16_ms']:.4f} / {e['bf16_serial_ms']:.4f} ms; bound "
            f"{e['bound_ms']:.5f} (bf16 {e['bf16_bound_ms']:.5f}) ms")
        r["shapes"].append(e)
        if "ms" not in r:              # the kernel's first shape
            r.update({key: e[key] for key in (
                "shape", "ms", "serial_ms", "bf16_ms", "bf16_serial_ms",
                "bound_ms", "bound_by", "bf16_bound_ms")})
            r["library_ms"] = None
            r["plain_ms"] = time_ms(twins, 5)
            log(f"  {name} twins at {shape}: {R_REP} calls "
                f"{r['plain_ms']:.3f} ms")


# The big-N step's kernels with the replicate axis (R_REP replicates, each
# of its own inputs): the step's shape (K8 on its subsample's 4 x
# BIGN_SUB_W count planes), a ragged B and K = 3 and 16; the first is
# timed.
REP_BIGN_SHAPES = [BIGN, (4092, BIGN[1], BIGN[2]), (BIGN[0], BIGN[1], 3),
                   (BIGN[0], BIGN[1], 16)]
REP_BIGN = {"K8": "lambda_stats_acat[rep]",
            "K7": "batch_stats_fused_v2_packed[rep]",
            "K5": "gamma_stats_packed[rep]",
            "K6": "batch_stats_fused_packed[rep]"}


def _bign_rep_calls(x, dtype, approx):
    """name -> (the call of K8, K7, K5 or K6 at dtype on inputs x, single
    or with a leading R; the twin of one replicate i)."""
    rows, up, u, t1, t0, a1, a0, ups = x
    return {
        "K8": (lambda: stats_packed.lambda_stats_acat(
                   a1, a0, ups, t1, t0, approx_div=approx, dtype=dtype),
               lambda i: stats_packed.lambda_stats_acat_twin(
                   a1[i], a0[i], ups[i], t1[i], t0[i], approx_div=approx,
                   dtype=dtype)),
        "K7": (lambda: stats_packed.batch_stats_fused_v2_packed(
                   rows, u, t1, t0, approx_div=approx, dtype=dtype),
               lambda i: twin_stats(rows[i], up[i], t1[i], t0[i], approx,
                                    dtype)),
        "K5": (lambda: [stats_packed.gamma_stats_packed(rows, up, t1, t0,
                                                        dtype)],
               lambda i: [stats_packed.gamma_stats_packed_twin(
                   rows[i], up[i], t1[i], t0[i], dtype)]),
        "K6": (lambda: stats_packed.batch_stats_fused_packed(
                   rows, u, t1, t0, dtype=dtype),
               lambda i: twin_stats(rows[i], up[i], t1[i], t0[i],
                                    dtype=dtype)),
    }


def _bign_rep_inputs(b, w, k, dev):
    """R_REP replicates' big-N inputs: rows (R, B, W), u planes, u, t1,
    t0, and K8's count planes and u planes over the first BIGN_SUB_W
    columns (the step's subsample)."""
    rows, up, lamb = _rep_inputs(b, w, k, b + w + k, dev)
    rows[1, ::7] = 0xFF                   # rows of one replicate MISSING
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    u = stats_packed.planes_to_flat(up).contiguous()
    ws = min(w, BIGN_SUB_W)
    a1, a0 = stats_packed.decode_count_planes(rows[..., :ws].contiguous())
    ups = up[..., :ws, :].contiguous()
    return rows, up, u, t1, t0, a1, a0, ups


def _one(x, i):
    return tuple(t[i] for t in x)


def phase_kernels_rep_bign(dev, rec):
    """K8, K7, K5 and K6 with the replicate axis (R = 4) at
    REP_BIGN_SHAPES, f32 and bf16 (K8 and K7 with both divides at the
    step's shape): each replicate's outputs bitwise the single call's on
    its inputs, a second run bitwise, and held against the twins at the
    single kernels' tolerances (phase_kernels_bign,
    phase_kernels_bign_bf16). At the step's shape each is timed in turns
    with the R single calls, beside R x the single bound (the present
    entries of every replicate), at both dtypes."""
    for name in REP_BIGN.values():
        rec[name]["max_abs_err"] = 0.0
        rec[name]["shapes"] = []
    for b, w, k in REP_BIGN_SHAPES:
        x = _bign_rep_inputs(b, w, k, dev)
        timed = (b, w, k) == BIGN
        for dtype in (torch.float32, BF16):
            dname = "bf16" if dtype == BF16 else "f32"
            for kernel, name in REP_BIGN.items():
                for approx in ((False, True) if timed and kernel in (
                        "K7", "K8") else (False,)):
                    shape = (f"R={R_REP} B={b} (4, {BIGN_SUB_W}) K={k}"
                             if kernel == "K8" else
                             f"R={R_REP} B={b} W={w} K={k}")
                    label = f"{kernel}[rep] {shape} {dname} approx={approx}"
                    call, twin = _bign_rep_calls(x, dtype, approx)[kernel]
                    got = twice(label, call)
                    _bitwise_per_replicate(label, got, [
                        _bign_rep_calls(_one(x, i), dtype, approx)[kernel][0]()
                        for i in range(R_REP)])
                    want = [torch.stack(t) for t in zip(
                        *[twin(i) for i in range(R_REP)])]
                    tol = (TOL_APPROX if approx else
                           TOL if dtype == torch.float32 else TOL_BF16_PASS)
                    hold(rec, name, label, got, want, tol)
                    del got, want
                    torch.cuda.empty_cache()   # the twins' ~10 GB each
        log(f"  K5-K8[rep] R={R_REP} B={b} W={w} K={k}: each replicate "
            "bitwise its single call, re-runs bitwise")
        if timed:
            _time_rep_bign(rec, x)
        del x
        torch.cuda.empty_cache()


def _time_rep_bign(rec, x):
    """K8 (fast divide, as the step runs it), K7, K5 and K6 with the
    replicate axis at the step's shape in turns with R_REP single calls,
    f32 and bf16, beside R x the single bound, and R twins' time."""
    rows, up, u, t1, t0, a1, a0, ups = x
    k = up.shape[-1]
    pr = present(rows)
    ent8 = int(((a1 + a0) > 0).sum())
    # (operations a present entry, entries, bytes, bf16 sums)
    work = {"K8": (lambda_pass_flops(k), ent8,
                   nbytes(a1, a0, ups, t1, t0, t1, t0), 1),
            "K7": (12 * k + 2, pr, nbytes(rows, u, t1, t0, u, t1, t0), 2),
            "K5": (lambda_pass_flops(k), pr, nbytes(rows, up, t1, t0, up), 1),
            "K6": (12 * k + 2, pr, nbytes(rows, u, t1, t0, u, t1, t0), 2)}
    for kernel, name in REP_BIGN.items():
        approx = kernel == "K8"
        shape = (f"R={R_REP} B={rows.shape[1]} (4, {ups.shape[-2]}) K={k}"
                 if kernel == "K8" else
                 f"R={R_REP} B={rows.shape[1]} W={rows.shape[2]} K={k}")
        e = dict(shape=shape)
        reps = 5 if kernel != "K8" else 20
        for dtype, key in ((torch.float32, ""), (BF16, "bf16_")):
            singles = [_bign_rep_calls(_one(x, i), dtype, approx)[kernel][0]
                       for i in range(R_REP)]
            e[key + "serial_ms"], e[key + "ms"] = in_turns(
                lambda: [f() for f in singles],
                _bign_rep_calls(x, dtype, approx)[kernel][0], reps=reps)
        flops, entries, moved, sums = work[kernel]
        set_bound(e, entries * flops, moved)
        tmp = {}
        set_bound_bf16(tmp, entries, k, moved, sums)
        e["bf16_bound_ms"] = tmp["bound_ms"]
        r = rec[name]
        r["shapes"].append(e)
        r.update(e)
        twin = _bign_rep_calls(x, torch.float32, approx)[kernel][1]
        r["plain_ms"] = time_ms(lambda: [twin(i) for i in range(R_REP)], 2)
        torch.cuda.empty_cache()
        log(f"  {kernel}[rep] {shape}: batched {e['ms']:.4f} ms, {R_REP} "
            f"single calls in turns {e['serial_ms']:.4f} ms; bf16 "
            f"{e['bf16_ms']:.4f} / {e['bf16_serial_ms']:.4f} ms; bound "
            f"{e['bound_ms']:.5f} (bf16 {e['bf16_bound_ms']:.5f}) ms; "
            f"{R_REP} twins {r['plain_ms']:.3f} ms")


# The K > 64 bodies with the replicate axis, R_REP replicates
# each of its own inputs: every kernel at K = 72 and 256 on ragged shapes
# (held to the twins, bitwise per replicate and on a re-run), then timed at
# K = 72 where the batched paths run them (phase 14): K1 at config #3's
# width (B = 1,024, W = 640), K4 at its eval block (rows shared), K8 on
# the big-N step's subsample, K5-K7 at the big-N step's shape.
REP_WIDE = {"K1": "fused_local_solve[rep]", "K4": "lambda_stats_packed[rep]",
            "K8": "lambda_stats_acat[rep]",
            "K7": "batch_stats_fused_v2_packed[rep]",
            "K5": "gamma_stats_packed[rep]",
            "K6": "batch_stats_fused_packed[rep]"}
REP_WIDE_K = 72
REP_WIDE_TIMED = {"K1": (1024, 640), "K4": (1024, 640),
                  "K8": (BIGN[0], BIGN_SUB_W), "K7": BIGN[:2],
                  "K5": BIGN[:2], "K6": BIGN[:2]}
# K1's schedules: the plain one, held to the twins as the single wide K1
# is (phase_kernels_wide), and the main path's accel one (`_hold_k1_rep`
# at the timed shape). REP_WIDE_FRAC: the share of K1[rep]'s g and lambda
# at K > 64 on the accel schedule allowed beyond tol. There the clamped
# Aitken step moves lambda beyond 2e-4 on up to 2% of its entries in f32
# alone against the same schedule in f64 (tests/test_torch_replicates_
# wide.py::test_accel_tail_moves_lambda_at_k72_in_f32_alone), so two f32
# sum orders may differ on twice that.
REP_WIDE_FRAC = 4e-2
REP_WIDE_PLAIN = dict(local_iters=4, local_tol=-1.0, beta_a=1.0, beta_b=1.0)
REP_WIDE_MAIN = dict(local_iters=7, local_tol=1e-4, accel=True, beta_a=1.0,
                     beta_b=1.0)


def _wide_rep_inputs(b, w, k, dev):
    """R_REP replicates' inputs of every kernel: rows (R, B, W) with rows
    of one replicate MISSING, u planes, u, t1, t0, count planes of all W,
    and lambda."""
    rows, up, lamb = _rep_inputs(b, w, k, b + w + k, dev)
    rows[1, ::5] = 0xFF
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    u = stats_packed.planes_to_flat(up).contiguous()
    a1, a0 = stats_packed.decode_count_planes(rows)
    return rows, up, u, t1, t0, a1, a0, up, lamb


def _wide_rep_calls(x, dtype, approx, kw=REP_WIDE_PLAIN):
    """name -> (the batched call of K1, K4, K5, K6, K7 or K8 at dtype on
    inputs x, single or with a leading R; the twin of replicate i). K4
    reads rows[0] for every replicate (the eval's shared rows); K1 runs
    the schedule kw."""
    calls = _bign_rep_calls(x[:8], dtype, approx)
    rows, up, _, t1, t0 = x[:5]
    lamb = x[8]
    shared = rows if rows.dim() == 2 else rows[0]
    k1 = dict(kw, dtype=dtype, approx_div=approx)
    calls["K1"] = (
        lambda: fused_step.fused_local_solve(rows, up, lamb, **k1),
        lambda i: fused_step.fused_local_solve_twin(rows[i], up[i], lamb[i],
                                                    **k1))
    calls["K4"] = (
        lambda: stats_packed.lambda_stats_packed(shared, up, t1, t0,
                                                 approx_div=approx,
                                                 dtype=dtype),
        lambda i: stats_packed.lambda_stats_packed_twin(
            shared, up[i], t1[i], t0[i], approx_div=approx, dtype=dtype))
    return calls


def _single_wide(x, i, kernel, dtype, approx, kw=REP_WIDE_PLAIN):
    """Replicate i's single call of `kernel` (K4 over rows[0])."""
    xi = list(_one(x, i))
    if kernel == "K4":
        xi[0] = x[0][0]
    return _wide_rep_calls(tuple(xi), dtype, approx, kw)[kernel][0]()


def _hold_wide(rec, kernel, label, got, want, dtype, approx):
    """A wide [rep] call of `kernel` (plain schedule for K1) held to its
    stacked twins at the K <= 64 [rep] tolerances."""
    tol = (TOL_APPROX if approx else
           TOL if dtype == torch.float32 else
           TOL_BF16_SOLVE if kernel == "K1" else TOL_BF16_PASS)
    name = REP_WIDE[kernel]
    if kernel == "K1":
        hold(rec, name, f"{label} g", got[1:], want[1:], tol)
        hold(rec, name, f"{label} lambda", got[:1], want[:1], tol,
             FLIP_FRAC if dtype == BF16 else 0.0)
    else:
        hold(rec, name, label, got, want, tol)


def phase_kernels_rep_wide(dev, rec):
    """K1, K4, K5, K6, K7 and K8 with the replicate axis (R = 4) at
    K = 72 and 256 (K1, K4 and K6-K8 at K = 128 too, the widest single
    piece of K of their bodies), the replicate alone in the grid's z; ragged
    shapes (B = 40, odd W, a replicate's rows MISSING), f32 and bf16, both
    divides at K = 72 and 128 (K1, K4, K7, K8): each
    replicate bitwise its single wide call, a re-run bitwise, held to the
    twins at the K <= 64 [rep] tolerances; K1 also bitwise per replicate
    on the main path's cold accel schedule. Then at K = 72 at the batched
    paths' shapes (`REP_WIDE_TIMED`): held to the twins there and timed
    (`_time_rep_wide`): the K > 64 rows of PERF.md (single = R single
    calls / R)."""
    for name in REP_WIDE.values():
        rec[name]["wide"] = []
    for k in (REP_WIDE_K, 128, 256):
        for kernel, name in REP_WIDE.items():
            if k == 128 and kernel == "K5":   # the widest single piece
                continue                      # of K1, K4 and K6-K8
            w = 235 if kernel in ("K1", "K4", "K8") else 300
            x = _wide_rep_inputs(40, w, k, dev)
            for dtype in (torch.float32, BF16):
                dname = "bf16" if dtype == BF16 else "f32"
                for approx in ((False, True) if k in (REP_WIDE_K, 128) and
                               kernel in ("K1", "K4", "K7", "K8")
                               else (False,)):
                    label = (f"{kernel}[rep] wide R={R_REP} B=40 W={w} K={k} "
                             f"{dname} approx={approx}")
                    call, twin = _wide_rep_calls(x, dtype, approx)[kernel]
                    got = twice(label, call)
                    _bitwise_per_replicate(label, got, [
                        _single_wide(x, i, kernel, dtype, approx)
                        for i in range(R_REP)])
                    _hold_wide(rec, kernel, label, got, [
                        torch.stack(t) for t in zip(
                            *[twin(i) for i in range(R_REP)])], dtype, approx)
                if kernel == "K1":
                    label = f"K1[rep] wide R={R_REP} B=40 W={w} K={k} {dname}"
                    _bitwise_per_replicate(
                        f"{label} cold accel",
                        _wide_rep_calls(x, dtype, False,
                                        REP_WIDE_MAIN)["K1"][0](),
                        [_single_wide(x, i, "K1", dtype, False, REP_WIDE_MAIN)
                         for i in range(R_REP)])
        log(f"  {'K1, K4, K6-K8' if k == 128 else 'K1, K4, K5-K8'}[rep] wide "
            f"R={R_REP} K={k}: each replicate bitwise its single wide call, "
            "re-runs bitwise")
    for kernel in REP_WIDE:
        _time_rep_wide(rec, kernel, dev)
        torch.cuda.empty_cache()


def _time_rep_wide(rec, kernel, dev):
    """`kernel` with the replicate axis at K = 72 at its timed shape, f32
    and bf16 (K8 with the fast divide, as the step runs it): bitwise per
    replicate there and held to the R stacked twins (`_hold_wide`; K1 on
    the plain schedule there, and through `_hold_k1_rep` on the main
    path's accel one: cold, warm with replicate 0 at its fixed point so
    that it exits its tol loop first, and replicate 0 MISSING), then
    in turns with R_REP single calls, beside R x the single bound (what
    each replicate's data needs; the chunks' recompute of D is the body's
    cost, not the function's) and R twins' time."""
    b, w = REP_WIDE_TIMED[kernel]
    k = REP_WIDE_K
    x = _wide_rep_inputs(b, w, k, dev)
    rows, up, u, t1, t0, a1, a0, _, lamb = x
    approx = kernel == "K8"
    kw = REP_WIDE_MAIN if kernel == "K1" else REP_WIDE_PLAIN
    shape = f"R={R_REP} B={b} W={w} K={k}"
    e = dict(shape=shape, library_ms=None)
    reps = 1 if kernel in ("K6", "K7") else 2 if kernel == "K5" else 10
    if kernel == "K1":
        _hold_k1_rep(rec, f"wide {shape}", rows, up, lamb, kw, wide=True)
    for dtype, key in ((torch.float32, ""), (BF16, "bf16_")):
        label = (f"{kernel}[rep] wide {shape} "
                 f"{'bf16' if dtype == BF16 else 'f32'} approx={approx}")
        call, twin = _wide_rep_calls(x, dtype, approx)[kernel]
        got = call()
        _bitwise_per_replicate(label, got, [
            _single_wide(x, i, kernel, dtype, approx)
            for i in range(R_REP)])
        _hold_wide(rec, kernel, label, got, [torch.stack(t) for t in zip(
            *[twin(i) for i in range(R_REP)])], dtype, approx)
        del got
        torch.cuda.empty_cache()
        call = _wide_rep_calls(x, dtype, approx, kw)[kernel][0]
        e[key + "serial_ms"], e[key + "ms"] = in_turns(
            lambda: [_single_wide(x, i, kernel, dtype, approx, kw)
                     for i in range(R_REP)], call, reps=reps)
        e[key + "single_ms"] = e[key + "serial_ms"] / R_REP
    k1 = kernel == "K1"
    if k1:
        entries = moved = 0
        for i in range(R_REP):
            n_pass = solve_passes(rows[i], up[i], lamb[i], **kw) + 1
            entries += present(rows[i]) * n_pass
            moved += nbytes(rows[i], up[i], up[i]) + lamb[i].numel() * 4
        flops, sums = entries * lambda_pass_flops(k), 1
    elif kernel == "K4":
        entries = present(rows[0]) * R_REP
        flops, sums = entries * lambda_pass_flops(k), 1
        moved = nbytes(rows[0], up, t1, t0, t1, t0)
    elif kernel == "K8":
        entries = int(((a1 + a0) > 0).sum())
        flops, sums = entries * lambda_pass_flops(k), 1
        moved = nbytes(a1, a0, up, t1, t0, t1, t0)
    elif kernel == "K5":
        entries = present(rows)
        flops, sums = entries * lambda_pass_flops(k), 1
        moved = nbytes(rows, up, t1, t0, up)
    else:
        entries = present(rows)
        flops, sums = entries * (12 * k + 2), 2
        moved = nbytes(rows, u, t1, t0, u, t1, t0)
    set_bound(e, flops, moved)
    tmp = {}
    set_bound_bf16(tmp, entries, k, moved, sums)
    e["bf16_bound_ms"] = tmp["bound_ms"]
    e["single_bound_ms"] = e["bound_ms"] / R_REP
    e["bf16_single_bound_ms"] = e["bf16_bound_ms"] / R_REP
    twin = _wide_rep_calls(x, torch.float32, approx, kw)[kernel][1]
    e["plain_ms"] = time_ms(lambda: [twin(i) for i in range(R_REP)], 1)
    rec[REP_WIDE[kernel]]["wide"].append(e)
    log(f"  {kernel}[rep] wide {shape}: batched {e['ms']:.4f} ms, {R_REP} "
        f"single calls in turns {e['serial_ms']:.4f} ms (a single call "
        f"{e['single_ms']:.4f}); bf16 {e['bf16_ms']:.4f} / "
        f"{e['bf16_serial_ms']:.4f} ms (single {e['bf16_single_ms']:.4f}); "
        f"bound {e['bound_ms']:.5f} (bf16 {e['bf16_bound_ms']:.5f}) ms, a "
        f"single call's {e['single_bound_ms']:.5f} "
        f"(bf16 {e['bf16_single_bound_ms']:.5f}); {R_REP} twins "
        f"{e['plain_ms']:.3f} ms")


def phase_kernels_bf16(dev, rec):
    """The bf16 bodies of K1, K2, K4 and of the λ and γ passes (the
    reference's kernels at dtype=jnp.bfloat16), each against its bf16
    twin (TOL_BF16_PASS, TOL_BF16_SOLVE; approx_div TOL_APPROX), re-run
    bitwise, and pinned against the f32 body; K2 bitwise against K1 on the
    gathered rows. Cases: the TGP shape, config #1's, config #3's K2 step,
    ragged B, odd W, K = 3..33 and 72 (the K > 64 bodies), rows
    MISSING, a null group, both divides, the stored-λ warm start. Times in
    turns with the f32 bodies, beside the bf16 bounds."""
    for name in ("fused_local_solve[bf16]", "fused_local_solve_dma[bf16]",
                 "lambda_stats_packed[bf16]"):
        rec[name]["max_abs_err"] = 0.0
    plain = dict(local_iters=7, local_tol=-1.0, accel=False)
    main = dict(local_iters=7, local_tol=1e-4, accel=True)
    quick = dict(local_iters=4, local_tol=-1.0)

    def k1_case(label, rows, up, lamb, extra, timed=False):
        kw = dict(beta_a=1.0, beta_b=1.0, **extra)
        tol = TOL_APPROX if kw.get("approx_div") else TOL_BF16_SOLVE
        frac = 1e-2 if kw.get("accel") else FLIP_FRAC
        hold_bf16(rec, "fused_local_solve[bf16]", f"K1[bf16] {label}",
                  lambda dt: fused_step.fused_local_solve(rows, up, lamb,
                                                          dtype=dt, **kw),
                  lambda: fused_step.fused_local_solve_twin(
                      rows, up, lamb, dtype=BF16, **kw), tol, frac,
                  kw.get("accel", False))
        if timed:
            r = rec["fused_local_solve[bf16]"]
            f32_ms, r["ms"] = in_turns(
                lambda: fused_step.fused_local_solve(rows, up, lamb, **kw),
                lambda: fused_step.fused_local_solve(rows, up, lamb,
                                                     dtype=BF16, **kw))
            r["plain_ms"] = time_ms(lambda: fused_step.fused_local_solve_twin(
                rows, up, lamb, dtype=BF16, **kw))
            r["f32_in_turns_ms"] = f32_ms
            log(f"  K1[bf16] {label}: kernel {r['ms']:.4f} ms (f32 body in "
                f"turns {f32_ms:.4f}), twin {r['plain_ms']:.4f} ms")
            solve_bound(r, rows, up, lamb, dict(kw, dtype=BF16))

    def k4_case(label, rows, up, t1, t0, approx, timed=False):
        hold_bf16(rec, "lambda_stats_packed[bf16]", f"K4[bf16] {label} "
                  f"approx={approx}",
                  lambda dt: stats_packed.lambda_stats_packed(
                      rows, up, t1, t0, approx_div=approx, dtype=dt),
                  lambda: stats_packed.lambda_stats_packed_twin(
                      rows, up, t1, t0, approx_div=approx, dtype=BF16),
                  TOL_APPROX if approx else TOL_BF16_PASS)
        if timed:
            r = rec["lambda_stats_packed[bf16]"]
            f32_ms, r["ms"] = in_turns(
                lambda: stats_packed.lambda_stats_packed(rows, up, t1, t0),
                lambda: stats_packed.lambda_stats_packed(rows, up, t1, t0,
                                                         dtype=BF16))
            r["plain_ms"] = time_ms(
                lambda: stats_packed.lambda_stats_packed_twin(
                    rows, up, t1, t0, dtype=BF16))
            r["f32_in_turns_ms"] = f32_ms
            log(f"  K4[bf16] {label}: kernel {r['ms']:.4f} ms eagerly (f32 "
                f"in turns {f32_ms:.4f}), twin {r['plain_ms']:.4f} ms")
            set_bound_bf16(r, present(rows), up.shape[-1],
                           nbytes(rows, up, t1, t0, t1, t0))

    # K1 at the TGP and config #1 step shapes
    for (b, w, k), extra, timed in (
            ((4096, 640, 8), plain, False), ((4096, 640, 8), main, True),
            ((4096, 640, 8), dict(plain, warm_start=True), False),
            ((4096, 640, 8), dict(plain, approx_div=True), False),
            ((256, 256, 3), plain, False), ((256, 256, 3), main, False)):
        rows, up, lamb = _solve_inputs(b, w, k, b + w + k, dev)
        tag = ",".join(f"{key}={v}" for key, v in extra.items())
        k1_case(f"B={b} W={w} K={k} {tag}", rows, up, lamb, extra, timed)

    # K4 at the eval/export block shape
    rows, up, lamb = _solve_inputs(1024, 640, 8, 4, dev)
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    for approx in (False, True):
        k4_case("B=1024 W=640 K=8", rows, up, t1, t0, approx,
                timed=not approx)

    # ragged B, odd W, K across the instantiated widths, K = 72 (the
    # K > 64 bodies), whole rows MISSING, both divides
    for b, w, k in ((33, 235, 3), (1000, 626, 7), (33, 626, 10),
                    (1000, 235, 16), (72, 640, 33), (40, 235, 72)):
        rows, up, lamb = _solve_inputs(b, w, k, b + w + k, dev)
        rows[5] = 0xFF
        rows[-1] = 0xFF
        t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
        shape = f"B={b} W={w} K={k}"
        for approx in (False, True):
            k4_case(shape, rows, up, t1, t0, approx)
            k1_case(f"{shape} approx={approx}", rows, up, lamb,
                    dict(quick, approx_div=approx))
        k1_case(f"{shape} warm_start", rows, up, lamb,
                dict(quick, warm_start=True))

    # K2: config #3's step (B=1024 g=8 out of 1M rows), then the tiling
    # cases with a null group; bitwise K1 on the gathered rows
    def k2_case(label, idx0, packed, up, lamb, rows, extra, timed=False):
        kw = dict(beta_a=1.0, beta_b=1.0, group=8, **extra)
        tol = TOL_APPROX if kw.get("approx_div") else TOL_BF16_SOLVE
        kw1 = {key: v for key, v in kw.items() if key != "group"}
        frac = 1e-2 if kw.get("accel") else FLIP_FRAC
        got = hold_bf16(
            rec, "fused_local_solve_dma[bf16]", f"K2[bf16] {label}",
            lambda dt: fused_step.fused_local_solve_dma(
                idx0, packed, up, lamb, dtype=dt, **kw),
            lambda: fused_step.fused_local_solve_twin(
                rows, up, lamb, dtype=BF16, **kw1), tol, frac,
            kw.get("accel", False))
        k1 = fused_step.fused_local_solve(rows, up, lamb, dtype=BF16, **kw1)
        if not all(torch.equal(a, c) for a, c in zip(got, k1)):
            raise AssertionError(f"K2[bf16] {label}: differs from K1[bf16] "
                                 "on the gathered rows")
        if timed:
            r = rec["fused_local_solve_dma[bf16]"]
            f32_ms, r["ms"] = in_turns(
                lambda: fused_step.fused_local_solve_dma(idx0, packed, up,
                                                         lamb, **kw),
                lambda: fused_step.fused_local_solve_dma(
                    idx0, packed, up, lamb, dtype=BF16, **kw))
            r["plain_ms"] = time_ms(lambda: fused_step.fused_local_solve_twin(
                rows, up, lamb, dtype=BF16, **kw1))
            r["f32_in_turns_ms"] = f32_ms
            log(f"  K2[bf16] {label}: kernel {r['ms']:.4f} ms (f32 body in "
                f"turns {f32_ms:.4f}), twin {r['plain_ms']:.4f} ms")
            solve_bound(r, rows, up, lamb, dict(kw1, dtype=BF16),
                        extra_bytes=nbytes(idx0))

    l, w, k, b, g = 1_000_000, 640, 8, 1024, 8
    gen = torch.Generator(device=dev).manual_seed(5)
    packed = torch.randint(0, 256, (l, w), generator=gen, device=dev,
                           dtype=torch.uint8)
    gamma = 0.3 + 2.7 * torch.rand((4 * w, k), generator=gen, device=dev)
    up = stats_packed.u_to_planes(exp_elog_theta(gamma))
    idx0 = torch.randint(0, l // g, (b // g,), generator=gen, device=dev,
                         dtype=torch.int32) * g
    lamb = 0.5 + 2.5 * torch.rand((b, k, 2), generator=gen, device=dev)
    rows = packed[(idx0.long()[:, None] + torch.arange(g, device=dev))
                  .reshape(b)]
    for extra, timed in ((plain, False), (main, True),
                         (dict(plain, warm_start=True), False),
                         (dict(plain, approx_div=True), False)):
        tag = ",".join(f"{key}={v}" for key, v in extra.items())
        k2_case(f"L=1M B={b} W={w} K={k} g=8 {tag}", idx0, packed, up, lamb,
                rows, extra, timed)
    del packed
    l = 4096
    for b, w, k in ((40, 256, 3), (72, 128, 10), (1000, 640, 8),
                    (136, 384, 16), (1000, 640, 33), (40, 256, 72)):
        packed, up, lamb = _solve_inputs(l, w, k, b + w + k, dev)
        lamb = lamb[:b].contiguous()
        gen = torch.Generator(device=dev).manual_seed(b)
        idx0 = torch.randint(0, l // g, (b // g,), generator=gen, device=dev,
                             dtype=torch.int32) * g
        packed[int(idx0[0]) + 3] = 0xFF     # a whole row MISSING
        idx0[1] = l                         # a null group: reads as MISSING
        rows = packed[(idx0.long().clamp(max=l - g)[:, None]
                       + torch.arange(g, device=dev)).reshape(b)]
        rows[g:2 * g] = 0xFF
        for approx in (False, True):
            k2_case(f"B={b} W={w} K={k} g=8 approx={approx}", idx0, packed,
                    up, lamb, rows, dict(quick, approx_div=approx,
                                         warm_start=True))
    log("  bf16 bodies: every re-run bitwise equal, K2[bf16] bitwise "
        "K1[bf16] on the gathered rows, every output inside the pin")
    phase_passes_bf16(dev, rec)
    phase_kernels_bign_bf16(dev, rec)


# B, W, K of the big-N bf16 cases: the step's shape, a ragged B (the pad
# path), K = 8 and 16 (the K-widths around K7's 12), K = 3, and K = 72
# (the K > 64 bodies); K8 runs on the first 2,048 columns (the step's
# subsample width) or all of a narrower W
BIGN_BF16_SHAPES = [BIGN, (4092, 25_088, 10), (300, 385, 8), (300, 385, 12),
                    (300, 385, 16), (33, 235, 3), (75, 235, 33),
                    (75, 235, 64), (40, 256, 72)]


def phase_kernels_bign_bf16(dev, rec):
    """The bf16 bodies of the big-N step: K7 (both divides), K6, K5 and K8
    (both divides) against their bf16 twins (TOL_BF16_PASS; the fast
    divide TOL_APPROX), each re-run bitwise and pinned against its f32
    body on the same inputs, at BIGN_BF16_SHAPES with two rows MISSING;
    at the big-N shape timed in turns with the f32 bodies, beside the
    bf16 bounds."""
    names = {"K7": "batch_stats_fused_v2_packed[bf16]",
             "K6": "batch_stats_fused_packed[bf16]",
             "K5": "gamma_stats_packed[bf16]",
             "K8": "lambda_stats_acat[bf16]"}
    for name in names.values():   # K7[bf16] may hold its K > 64 cases
        rec[name].setdefault("max_abs_err", 0.0)
    for b, w, k in BIGN_BF16_SHAPES:
        rows, up, u, t1, t0 = _stats_inputs(b, w, k, b + w + k, dev)
        rows[5] = 0xFF
        rows[-1] = 0xFF
        shape = f"B={b} W={w} K={k}"
        for approx in (False, True):
            hold_bf16(rec, names["K7"], f"K7[bf16] {shape} approx={approx}",
                      lambda dt: stats_packed.batch_stats_fused_v2_packed(
                          rows, u, t1, t0, approx_div=approx, dtype=dt),
                      lambda: twin_stats(rows, up, t1, t0, approx, BF16),
                      TOL_APPROX if approx else TOL_BF16_PASS)
            torch.cuda.empty_cache()      # the twin's ~10 GB of temporaries
        hold_bf16(rec, names["K6"], f"K6[bf16] {shape}",
                  lambda dt: stats_packed.batch_stats_fused_packed(
                      rows, u, t1, t0, dtype=dt),
                  lambda: twin_stats(rows, up, t1, t0, dtype=BF16),
                  TOL_BF16_PASS)
        torch.cuda.empty_cache()
        k6_is_k7(f"K6[bf16] {shape}", rows, u, t1, t0, BF16)
        hold_bf16(rec, names["K5"], f"K5[bf16] {shape}",
                  lambda dt: [stats_packed.gamma_stats_packed(
                      rows, up, t1, t0, dt)],
                  lambda: [stats_packed.gamma_stats_packed_twin(
                      rows, up, t1, t0, BF16)], TOL_BF16_PASS)
        torch.cuda.empty_cache()
        ws = min(w, BIGN_SUB_W)
        rs, ups = rows[:, :ws].contiguous(), up[:, :ws].contiguous()
        a1, a0 = stats_packed.decode_count_planes(rs)
        for approx in (False, True):
            hold_bf16(rec, names["K8"],
                      f"K8[bf16] B={b} (4, {ws}) K={k} approx={approx}",
                      lambda dt: stats_packed.lambda_stats_acat(
                          a1, a0, ups, t1, t0, approx_div=approx, dtype=dt),
                      lambda: stats_packed.lambda_stats_acat_twin(
                          a1, a0, ups, t1, t0, approx_div=approx,
                          dtype=BF16),
                      TOL_APPROX if approx else TOL_BF16_PASS)
        if (b, w, k) == BIGN:
            pr = present(rows)
            fused_bytes = nbytes(rows, u, t1, t0, u, t1, t0)
            _timed_bf16(rec[names["K7"]], f"K7[bf16] {shape}",
                        lambda dt: stats_packed.batch_stats_fused_v2_packed(
                            rows, u, t1, t0, dtype=dt),
                        lambda: twin_stats(rows, up, t1, t0, dtype=BF16),
                        pr, k, fused_bytes, sums=2)
            _timed_bf16(rec[names["K6"]], f"K6[bf16] {shape}",
                        lambda dt: stats_packed.batch_stats_fused_packed(
                            rows, u, t1, t0, dtype=dt),
                        lambda: twin_stats(rows, up, t1, t0, dtype=BF16),
                        pr, k, fused_bytes, sums=2)
            _timed_bf16(rec[names["K5"]], f"K5[bf16] {shape}",
                        lambda dt: stats_packed.gamma_stats_packed(
                            rows, up, t1, t0, dt),
                        lambda: stats_packed.gamma_stats_packed_twin(
                            rows, up, t1, t0, BF16),
                        pr, k, nbytes(rows, up, t1, t0, up))
            # the step's K8: the subsampled solve's fast divide
            _timed_bf16(rec[names["K8"]], f"K8[bf16] B={b} (4, {ws}) K={k}",
                        lambda dt: stats_packed.lambda_stats_acat(
                            a1, a0, ups, t1, t0, approx_div=True, dtype=dt),
                        lambda: stats_packed.lambda_stats_acat_twin(
                            a1, a0, ups, t1, t0, approx_div=True,
                            dtype=BF16),
                        int(((a1 + a0) > 0).sum()), k,
                        nbytes(a1, a0, ups, t1, t0, t1, t0), reps=20)
        del rows, up, u, t1, t0, rs, ups, a1, a0
        torch.cuda.empty_cache()
    log("  big-N bf16 bodies (K5-K8): every re-run bitwise equal, every "
        "output inside the pin")


def _timed_bf16(r, label, kernel, twin, entries, k, moved, sums=1, reps=5):
    """A bf16 body's time in turns with its f32 body (kernel(dtype)), its
    twin's time, and the bf16 bound (`set_bound_bf16`)."""
    r["f32_in_turns_ms"], r["ms"] = in_turns(
        lambda: kernel(torch.float32), lambda: kernel(BF16), reps=reps)
    r["plain_ms"] = time_ms(twin, reps)
    torch.cuda.empty_cache()
    log(f"  {label}: kernel {r['ms']:.4f} ms (f32 body in turns "
        f"{r['f32_in_turns_ms']:.4f}), twin {r['plain_ms']:.4f} ms")
    set_bound_bf16(r, entries, k, moved, sums)


def phase_passes_bf16(dev, rec):
    """The λ pass (K4's entry) and the γ pass (K5's entry) at bf16 alone,
    from a CUDA graph of 100 calls, in turns with their f32 bodies, at the
    shapes the paths run them, beside the bf16 bounds; the γ pass (K1's
    and K2's last pass, kept under K1[bf16]) also against its bf16 twin
    and pinned."""
    # their exact divide: the bits of the IEEE reciprocal on every float
    # where D + 1e-30 can lie
    bad = stats_packed.rcp_rn_mismatches(2.0 ** -126, 2.0 ** 126, dev)
    log(f"  bf16 passes' exact reciprocal against __frcp_rn on every float "
        f"in [2^-126, 2^126): {bad} differ")
    if bad:
        raise AssertionError("the bf16 passes' exact divide is not IEEE's")
    r = rec["lambda_stats_packed[bf16]"]
    r["passes"] = []
    for b, w, k in PASS_SHAPES:
        rows, up, lamb = _solve_inputs(b, w, k, b + w + k, dev)
        t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
        e = dict(shape=f"B={b} W={w} K={k}")
        for approx in (False, True):
            hold_bf16(rec, "lambda_stats_packed[bf16]",
                      f"λ pass[bf16] {e['shape']} approx={approx}",
                      lambda dt: stats_packed.lambda_stats_packed(
                          rows, up, t1, t0, approx_div=approx, dtype=dt),
                      lambda: stats_packed.lambda_stats_packed_twin(
                          rows, up, t1, t0, approx_div=approx, dtype=BF16),
                      TOL_APPROX if approx else TOL_BF16_PASS)
        for key, approx in (("ms", False), ("approx_ms", True)):
            e[f"f32_{key}"], e[key] = in_turns(
                lambda: stats_packed.lambda_stats_packed(
                    rows, up, t1, t0, approx_div=approx),
                lambda: stats_packed.lambda_stats_packed(
                    rows, up, t1, t0, approx_div=approx, dtype=BF16),
                "graph", 100)
        log(f"  λ pass[bf16] {e['shape']}: {e['ms']:.5f} ms, fast divide "
            f"{e['approx_ms']:.5f} ms; f32 in turns {e['f32_ms']:.5f} / "
            f"{e['f32_approx_ms']:.5f} ms (CUDA graph)")
        set_bound_bf16(e, present(rows), k, nbytes(rows, up, t1, t0, t1, t0))
        e["share_of_bound"] = e["bound_ms"] / e["ms"]
        r["passes"].append(e)
    for b, w, k in GAMMA_SHAPES:
        rows, up, lamb = _solve_inputs(b, w, k, b + w + k, dev)
        t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
        label = f"γ pass[bf16] B={b} W={w} K={k}"
        hold_bf16(rec, "fused_local_solve[bf16]", label,
                  lambda dt: [stats_packed.gamma_stats_packed(
                      rows, up, t1, t0, dtype=dt)],
                  lambda: [stats_packed.gamma_stats_packed_twin(
                      rows, up, t1, t0, BF16)], TOL_BF16_PASS)
        e = dict(shape=f"B={b} W={w} K={k}")
        e["f32_ms"], e["ms"] = in_turns(
            lambda: stats_packed.gamma_stats_packed(rows, up, t1, t0),
            lambda: stats_packed.gamma_stats_packed(rows, up, t1, t0,
                                                    dtype=BF16),
            "graph", 100)
        log(f"  {label}: {e['ms']:.5f} ms; f32 in turns {e['f32_ms']:.5f} ms "
            "(CUDA graph)")
        set_bound_bf16(e, present(rows), k, nbytes(rows, up, t1, t0, up))
        e["share_of_bound"] = e["bound_ms"] / e["ms"]
        rec["fused_local_solve[bf16]"].setdefault("gamma_passes", []).append(e)
    # long walks: B = 200 (four 64-row blocks, the last of 8 rows) and
    # W = 235 bytes (3.7 λ tiles, a ragged word), rows MISSING, at the n8
    # and k16 edges of the bodies, the λ and γ passes at one split (a CTA
    # walks every tile of its rows, every block of its columns) and K8
    for k in WALK_KS:
        rows, up, lamb = _solve_inputs(200, 235, k, k, dev)
        rows[3] = 0xFF
        rows[-1] = 0xFF
        t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
        a1, a0 = stats_packed.decode_count_planes(rows)
        shape = f"B=200 W=235 K={k}"
        for approx in (False, True):
            tol = TOL_APPROX if approx else TOL_BF16_PASS
            hold(rec, "lambda_stats_packed[bf16]",
                 f"λ pass[bf16] {shape} one split approx={approx}",
                 twice(shape, lambda: stats_packed.launch_lambda_stats_packed(
                     rows, up, t1, t0, 1, approx, True)),
                 stats_packed.lambda_stats_packed_twin(
                     rows, up, t1, t0, approx_div=approx, dtype=BF16), tol)
            hold(rec, "lambda_stats_acat[bf16]",
                 f"K8[bf16] {shape} approx={approx}",
                 twice(shape, lambda: stats_packed.lambda_stats_acat(
                     a1, a0, up, t1, t0, approx_div=approx, dtype=BF16)),
                 stats_packed.lambda_stats_acat_twin(
                     a1, a0, up, t1, t0, approx_div=approx, dtype=BF16), tol)
        hold(rec, "gamma_stats_packed[bf16]",
             f"γ pass[bf16] {shape} one split",
             twice(shape, lambda: [stats_packed.launch_gamma_stats_packed(
                 rows, up, t1, t0, 1, True)]),
             [stats_packed.gamma_stats_packed_twin(rows, up, t1, t0, BF16)],
             TOL_BF16_PASS)
    log("  bf16 passes on long walks: every re-run bitwise equal")


# K of the long walks (`phase_passes_bf16`): the n8 and k16 edges of the
# tensor-core bodies at K <= 64
WALK_KS = (1, 8, 9, 16, 17, 64)


def phase_wide_paths(dev, rec):
    """K = 72 through the steps a user's fit runs: one chunk of the fused
    branch (K1's wide bodies; the reference's gate pads K to 128 lanes,
    so it admits K = 72 where it admits K = 8), run twice from one state,
    bitwise equal; no twin runs."""
    n, l, k = 1000, 10_000, 72
    _, _, x = simulate_psd(n, l, 3, seed=11)
    data = GenotypeData.from_dense(x, validation_frac=0.005,
                                   heldout_frac=0.005, seed=11)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=256, rfreq=20, seed=11)
    packed_d = engine.resident_packed(data.packed, dev)
    if engine.step_impl(cfg, packed_d.shape[1]) != "fused":
        raise AssertionError("K = 72 at B = 256: the gate refused the fused "
                             "branch")
    state = engine.init_state(cfg, device=dev)
    chunk = engine.make_run_chunk(cfg, cfg.rfreq)
    reset_counts()
    a = chunk(state, packed_d)
    counts = read_counts(rec, "K=72 fused chunk", ("fused_local_solve",),
                         absent=("fused_local_solve_dma",
                                 "lambda_stats_packed"))
    if counts["fused_local_solve"] != cfg.rfreq:
        raise AssertionError("K=72 fused chunk: K1 did not run once a step")
    c = chunk(state, packed_d)
    if not (torch.equal(a.gamma, c.gamma)
            and bool(torch.isfinite(a.gamma).all())):
        raise AssertionError("K=72 fused chunk: a re-run is not bitwise "
                             "equal, or gamma is not finite")
    log(f"  K=72 fused chunk: {cfg.rfreq} steps, K1 {counts['fused_local_solve']}"
        " launches, no twin; re-run bitwise equal")


def phase_wide_bign(dev, rec, cfg, packed_d):
    """One big-N step at K = 72 and B = 4,092 on phase 4's data: the gate
    refuses B % 8 != 0, so the step takes the big-N path, pads the tol
    test with the reference's 4 rows, and runs K8's and K7's wide bodies.
    Run twice from one state: bitwise equal and finite."""
    wcfg = cfg.replace(k=72, batch_size=4092)
    if engine.step_impl(wcfg, packed_d.shape[1]) != "pallas":
        raise AssertionError("B=4092: the gate took the fused branch")
    if engine.batch_pad_rows(wcfg.batch_size) != 4:
        raise AssertionError("B=4092: not the pad path")
    state = engine.init_state(wcfg, l_padded=int(packed_d.shape[0]),
                              device=dev)
    step = engine.make_step(wcfg, int(packed_d.shape[0]))
    reset_counts()
    a = step(state, packed_d)
    read_counts(rec, "big-N step K=72 B=4092",
                ("lambda_stats_acat", "batch_stats_fused_v2_packed"),
                absent=("fused_local_solve", "fused_local_solve_dma"))
    c = step(state, packed_d)
    if not (torch.equal(a.gamma, c.gamma)
            and bool(torch.isfinite(a.gamma).all())):
        raise AssertionError("big-N step K=72: a re-run is not bitwise "
                             "equal, or gamma is not finite")
    log("  big-N step K=72 B=4092 (4 pad rows in the tol test): K8 and K7 "
        "wide, re-run bitwise equal, gamma finite")


def canonical_data():
    """Config #1's data as the verify skill's canonical drive makes it:
    (theta, beta, GenotypeData)."""
    theta_true, beta_true, x = simulate_psd(1000, 10_000, 3, seed=11)
    return theta_true, beta_true, GenotypeData.from_dense(
        x, validation_frac=0.005, heldout_frac=0.005, seed=11)


def phase_canonical(dev, rec, lambda_mode="local", dtype="float32"):
    """Config #1 through fit, as the verify skill's canonical drive. The
    stored mode warm-starts K1 from the stored lambda and scores it
    directly: no lambda re-solve (K4). dtype "bfloat16" runs the bf16
    bodies (and never the f32 ones). Returns the fit's summary."""
    theta_true, beta_true, data = canonical_data()
    cfg = SVIConfig(n=1000, l=10_000, k=3, batch_size=256, rfreq=50,
                    max_steps=3000, seed=11, lambda_mode=lambda_mode,
                    compute_dtype=dtype)
    reset_counts()
    res = fit(cfg, data, device=dev)
    stored = lambda_mode == "stored"
    sfx, other = ("[bf16]", "") if dtype == "bfloat16" else ("", "[bf16]")
    read_counts(rec, f"config #1 {lambda_mode} {dtype}",
                (f"fused_local_solve{sfx}",)
                + (() if stored else (f"lambda_stats_packed{sfx}",)),
                absent=("fused_local_solve_dma", "gather_row_blocks",
                        "fused_local_solve_dma[bf16]",
                        f"fused_local_solve{other}",
                        f"lambda_stats_packed{other}")
                + ((f"lambda_stats_packed{sfx}",) if stored else ()))
    th = psd.theta_mean(res.state.gamma[: cfg.n]).cpu().numpy()
    err = mean_abs_theta_error(th, theta_true)
    h = data.heldout
    p = (theta_true[h.ind_idx] * beta_true[h.snp_idx]).sum(-1)
    oracle = float(psd.binomial2_loglik(
        torch.from_numpy(h.x), torch.from_numpy(p).float()).mean())
    chunk_s, _, rate = fit_rates(res, cfg.batch_size)
    log(f"  config #1 {lambda_mode} {dtype}: converged={res.converged} "
        f"steps={res.steps} wall_s={res.wall_s:.2f} theta_mae={err:.4f} "
        f"heldout={res.heldout_ll:.5f} oracle={oracle:.5f} "
        f"snp_updates_per_s={rate:.1f}")
    if not (res.converged and err < 0.05 and res.heldout_ll > oracle - 0.02):
        raise AssertionError("canonical drive failed its quality checks")
    return dict(steps=res.steps, converged=res.converged, theta_mae=err,
                heldout=res.heldout_ll, oracle=oracle, wall_s=res.wall_s,
                snp_updates_per_s=rate)


def fit_rates(res, b):
    """(sum of chunk_s, sum of eval_s, SNP-updates/s over the chunks)."""
    chunk_s = sum(r["chunk_s"] for r in res.trace)
    eval_s = sum(r.get("eval_s", 0.0) for r in res.trace)
    return chunk_s, eval_s, res.steps * b / chunk_s


def phase_tgp(dev, rec):
    """TGP shape through fit, with the kernels' launch counts. Returns
    the data and the true theta for phase 5."""
    n, l, k = TGP
    t0 = time.time()
    packed, theta = simulate_packed_device(n, l, k, seed=0, device=dev)
    data = GenotypeData.from_packed(
        packed, n, seed=0, validation_frac=0.005, heldout_frac=0.005,
        max_eval_entries=200_000, eval_snp_pool=2048)
    log(f"  TGP data: simulate + carve {time.time() - t0:.1f} s")
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=4096, rfreq=50, max_steps=200,
                    seed=0)
    reset_counts()
    res = fit(cfg, data, device=dev)
    read_counts(rec, "TGP fit", ("fused_local_solve", "gather_row_blocks",
                                 "lambda_stats_packed"),
                absent=("fused_local_solve_dma",))
    chunk_s, eval_s, rate = fit_rates(res, cfg.batch_size)
    th = psd.theta_mean(res.state.gamma[:n]).cpu().numpy()
    log(f"  TGP fit: steps={res.steps} chunk_s={chunk_s:.3f} "
        f"eval_s={eval_s:.3f} wall_s={res.wall_s:.2f} "
        f"snp_updates_per_s={rate:.1f} "
        f"validation_ll={res.validation_ll:.5f} heldout={res.heldout_ll:.5f} "
        f"theta_mae={mean_abs_theta_error(th, theta):.4f}")
    if not (np.isfinite(res.validation_ll) and np.isfinite(res.heldout_ll)):
        raise AssertionError("TGP fit scores are not finite")

    packed_d = engine.resident_packed(data.packed, dev)
    state = engine.init_state(cfg, l_padded=l, device=dev)
    chunk = engine.make_run_chunk(cfg, cfg.rfreq, l)
    a = chunk(state, packed_d).gamma.cpu()
    b = chunk(state, packed_d).gamma.cpu()
    if not torch.equal(a, b):
        raise AssertionError("same-seed chunk re-run is not bitwise equal")
    log("  same-seed chunk re-run: gamma bitwise equal")
    return data, theta


def bign_fit(dev, rec, cfg, data, theta, expect, absent, stream=False):
    """fit(cfg, data) on the big-N data with its launch counts (`expect`
    launched, `absent` not, no twin) and finite scores; returns the fit
    and its summary, with the histogram of how many loop passes the
    reference's tol test lets run in each of its subsampled solves (K8's,
    `local_solve_acat.loop_passes`; at most local_iters - 2 with accel)
    and its step time (chunk seconds over steps). stream: fit out of
    core, fit(stream=True)."""
    reset_counts()
    stats_packed.local_solve_acat.loop_passes = []
    try:
        res = fit(cfg, data, device=dev, stream=stream)
        passes = [int(n) for n in stats_packed.local_solve_acat.loop_passes]
    finally:
        stats_packed.local_solve_acat.loop_passes = None
    tag = (f"big-N fit {cfg.lambda_mode} {cfg.compute_dtype}"
           + (" streamed" if stream else ""))
    counts = read_counts(rec, tag, expect, absent)
    chunk_s, eval_s, rate = fit_rates(res, cfg.batch_size)
    th = psd.theta_mean(res.state.gamma[: cfg.n]).cpu().numpy()
    hist = {n: passes.count(n) for n in sorted(set(passes))}
    summary = dict(steps=res.steps, theta_mae=mean_abs_theta_error(th, theta),
                   validation=res.validation_ll, heldout=res.heldout_ll,
                   snp_updates_per_s=rate, loop_passes=hist,
                   step_ms=chunk_s / res.steps * 1e3, counts=counts)
    log(f"  {tag}: steps={res.steps} chunk_s={chunk_s:.3f} "
        f"eval_s={eval_s:.3f} wall_s={res.wall_s:.2f} "
        f"snp_updates_per_s={rate:.1f} "
        f"validation_ll={res.validation_ll:.5f} heldout={res.heldout_ll:.5f} "
        f"theta_mae={summary['theta_mae']:.4f}")
    k7, k8 = (("batch_stats_fused_v2_packed[bf16]", "lambda_stats_acat[bf16]")
              if cfg.compute_dtype == "bfloat16" else
              ("batch_stats_fused_v2_packed", "lambda_stats_acat"))
    loop = cfg.local_iters - 2 if cfg.local_accel else cfg.local_iters
    log(f"  {tag}: step {summary['step_ms']:.3f} ms (chunk seconds over "
        f"steps); K7 launches {counts[k7]}, K8 launches {counts[k8]}; loop "
        f"passes the tol test lets run (of {loop}), by count of solves: "
        f"{hist} over {len(passes)} solves")
    if not (np.isfinite(res.validation_ll) and np.isfinite(res.heldout_ll)):
        raise AssertionError(f"{tag}: scores are not finite")
    return res, summary


def phase_bign(dev, rec):
    """The big-N per-iteration path through fit, at full width. Returns
    the data, the true theta, the config and the fit's summary for
    phase 7."""
    n = l = 100_000
    k = 10
    t0 = time.time()
    packed, theta = simulate_packed_device(n, l, k, seed=0, device=dev)
    data = GenotypeData.from_packed(
        packed, n, seed=0, validation_frac=0.005, heldout_frac=0.005,
        max_eval_entries=200_000, eval_snp_pool=2048)
    del packed
    log(f"  big-N data: simulate + carve {time.time() - t0:.1f} s")
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=4096, rfreq=100,
                    max_steps=300, seed=0, snp_group=8)
    res, summary = bign_fit(
        dev, rec, cfg, data, theta,
        ("gather_row_blocks", "lambda_stats_packed",
         "batch_stats_fused_v2_packed", "lambda_stats_acat"),
        ("fused_local_solve", "fused_local_solve_dma"))

    packed_d = engine.resident_packed(data.packed, dev)
    state = res.state
    gammas = {}
    for sk in ("pair", "fused", "fused_v2"):
        reset_counts()
        gammas[sk] = engine.make_step(cfg.replace(stats_kernel=sk))(
            state, packed_d).gamma
        want = {"pair": ("gamma_stats_packed", "lambda_stats_packed"),
                "fused": ("batch_stats_fused_packed",),
                "fused_v2": ("batch_stats_fused_v2_packed",)}[sk]
        read_counts(rec, f"big-N step stats_kernel={sk}",
                    want + ("lambda_stats_acat",),
                    absent=("fused_local_solve", "fused_local_solve_dma"))
    for sk in ("pair", "fused"):
        compare(f"big-N step gamma {sk} vs fused_v2", [gammas[sk]],
                [gammas["fused_v2"]], 1e-4)
    chunk = engine.make_run_chunk(cfg, cfg.rfreq, int(packed_d.shape[0]))
    a = chunk(state, packed_d).gamma.cpu()
    b = chunk(state, packed_d).gamma.cpu()
    if not torch.equal(a, b):
        raise AssertionError("big-N same-seed chunk re-run is not bitwise "
                             "equal")
    log("  big-N same-seed chunk re-run: gamma bitwise equal")
    log("phase 4b: big-N step at K = 72, B = 4,092 (the pad path)")
    phase_wide_bign(dev, rec, cfg, packed_d)
    return dict(data=data, theta=theta, cfg=cfg, f32=summary)


def clone(state):
    return state._replace(gamma=state.gamma.clone(), lamb=state.lamb.clone())


def phase_config3(dev, rec, data, theta):
    """Config #3 as the reference's runner sets it: B=1024, snp_group=8,
    so every step takes the group-addressed solve (K2)."""
    n, l, k = TGP
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=1024, rfreq=100,
                    max_steps=200, seed=0, snp_group=8)
    reset_counts()
    res = fit(cfg, data, device=dev)
    counts = read_counts(rec, "config #3 local",
                         ("fused_local_solve_dma", "lambda_stats_packed"),
                         absent=("fused_local_solve", "gather_row_blocks"))
    if counts["fused_local_solve_dma"] != res.steps:
        raise AssertionError("config #3: K2 did not run once a step")
    chunk_s, eval_s, rate = fit_rates(res, cfg.batch_size)
    th = psd.theta_mean(res.state.gamma[:n]).cpu().numpy()
    log(f"  config #3 local: steps={res.steps} chunk_s={chunk_s:.3f} "
        f"eval_s={eval_s:.3f} wall_s={res.wall_s:.2f} "
        f"snp_updates_per_s={rate:.1f} validation_ll={res.validation_ll:.5f} "
        f"heldout={res.heldout_ll:.5f} "
        f"theta_mae={mean_abs_theta_error(th, theta):.4f}")
    if not (np.isfinite(res.validation_ll) and np.isfinite(res.heldout_ll)):
        raise AssertionError("config #3 local scores are not finite")
    summary = dict(steps=res.steps, theta_mae=mean_abs_theta_error(th, theta),
                   heldout=res.heldout_ll, snp_updates_per_s=rate)

    scfg = cfg.replace(lambda_mode="stored", max_steps=100, rfreq=50)
    reset_counts()
    res = fit(scfg, data, device=dev)
    counts = read_counts(rec, "config #3 stored", ("fused_local_solve_dma",),
                         absent=("fused_local_solve", "gather_row_blocks",
                                 "lambda_stats_packed"))
    if counts["fused_local_solve_dma"] != res.steps:
        raise AssertionError("config #3 stored: K2 did not run once a step")
    sampled = torch.zeros(l, dtype=torch.bool, device=dev)
    for t in range(res.steps):
        _, idx = engine._draw_groups(
            scfg, engine.step_generator(scfg.seed, t, dev), l, dev)
        sampled[idx.long()] = True
    prior = torch.tensor([scfg.beta_a, scfg.beta_b], device=dev)
    at_prior = (res.state.lamb == prior).all(-1).all(-1)
    if not torch.equal(at_prior, ~sampled):
        raise AssertionError("config #3 stored: lambda rows moved off the "
                             "prior are not exactly the sampled rows")
    chunk_s, eval_s, rate = fit_rates(res, scfg.batch_size)
    log(f"  config #3 stored: steps={res.steps} sampled rows "
        f"{int(sampled.sum())} off the prior, the other "
        f"{int(at_prior.sum())} bitwise at it; chunk_s={chunk_s:.3f} "
        f"eval_s={eval_s:.3f} snp_updates_per_s={rate:.1f} "
        f"validation_ll={res.validation_ll:.5f} "
        f"heldout={res.heldout_ll:.5f}")
    if not (np.isfinite(res.validation_ll) and np.isfinite(res.heldout_ll)):
        raise AssertionError("config #3 stored scores are not finite")

    packed_d = engine.resident_packed(data.packed, dev)
    for c in (cfg, scfg):
        state = engine.init_state(c, l_padded=l, device=dev)
        chunk = engine.make_run_chunk(c, 100, l)
        a, b = chunk(clone(state), packed_d), chunk(clone(state), packed_d)
        if not (torch.equal(a.gamma, b.gamma) and torch.equal(a.lamb, b.lamb)):
            raise AssertionError(f"config #3 {c.lambda_mode}: same-seed "
                                 "chunk re-run is not bitwise equal")
        log(f"  config #3 {c.lambda_mode}: same-seed chunk re-run from a "
            "cloned state: gamma and lambda bitwise equal")
    return summary


def phase_bf16_drives(dev, rec, data, theta, f32):
    """compute_dtype="bfloat16" through `fit`: config #1 to convergence in
    both lambda modes (K1[bf16], K4[bf16] for the local mode's eval and
    export), held to phase 2's quality limits, and config #3 for 200
    steps (phase 5's data; K2[bf16] once a step, K4[bf16]) and 100 in the
    stored mode (K2[bf16] warm-started); no f32 body of K1, K2 or K4 and
    no twin runs. Each beside its f32 run (f32)."""
    for mode in ("local", "stored"):
        got = phase_canonical(dev, rec, lambda_mode=mode, dtype="bfloat16")
        ref = f32[f"config #1 {mode}"]
        log(f"  config #1 {mode}: bf16 / f32 steps {got['steps']} / "
            f"{ref['steps']}, theta_mae {got['theta_mae']:.4f} / "
            f"{ref['theta_mae']:.4f}, heldout {got['heldout']:.5f} / "
            f"{ref['heldout']:.5f} (oracle {got['oracle']:.5f}), "
            f"SNP-updates/s {got['snp_updates_per_s']:.1f} / "
            f"{ref['snp_updates_per_s']:.1f}")
    n, l, k = TGP
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=1024, rfreq=100,
                    max_steps=200, seed=0, snp_group=8,
                    compute_dtype="bfloat16")
    reset_counts()
    res = fit(cfg, data, device=dev)
    counts = read_counts(
        rec, "config #3 local bfloat16",
        ("fused_local_solve_dma[bf16]", "lambda_stats_packed[bf16]"),
        absent=("fused_local_solve", "fused_local_solve_dma",
                "fused_local_solve[bf16]", "gather_row_blocks",
                "lambda_stats_packed"))
    if counts["fused_local_solve_dma[bf16]"] != res.steps:
        raise AssertionError("config #3 bf16: K2[bf16] did not run once a "
                             "step")
    _, _, rate = fit_rates(res, cfg.batch_size)
    th = psd.theta_mean(res.state.gamma[:n]).cpu().numpy()
    mae = mean_abs_theta_error(th, theta)
    if not (np.isfinite(res.validation_ll) and np.isfinite(res.heldout_ll)):
        raise AssertionError("config #3 bf16 scores are not finite")
    h = data.heldout
    beta = simulated_beta(n, l, k, seed=0)
    p = (theta[h.ind_idx] * beta[h.snp_idx]).sum(-1)
    oracle = float(psd.binomial2_loglik(torch.from_numpy(h.x),
                                        torch.from_numpy(p)).mean())
    ref = f32["config #3 local"]
    log(f"  config #3 local, 200 steps: bf16 / f32 theta_mae {mae:.4f} / "
        f"{ref['theta_mae']:.4f}, heldout {res.heldout_ll:.5f} / "
        f"{ref['heldout']:.5f} (oracle {oracle:.5f}), SNP-updates/s "
        f"{rate:.1f} / {ref['snp_updates_per_s']:.1f}")

    # the stored mode: K2[bf16] warm-started, no λ re-solve
    scfg = cfg.replace(lambda_mode="stored", max_steps=100, rfreq=50)
    reset_counts()
    res = fit(scfg, data, device=dev)
    counts = read_counts(
        rec, "config #3 stored bfloat16", ("fused_local_solve_dma[bf16]",),
        absent=("fused_local_solve", "fused_local_solve_dma",
                "fused_local_solve[bf16]", "gather_row_blocks",
                "lambda_stats_packed", "lambda_stats_packed[bf16]"))
    if counts["fused_local_solve_dma[bf16]"] != res.steps:
        raise AssertionError("config #3 stored bf16: K2[bf16] did not run "
                             "once a step")
    if not (np.isfinite(res.validation_ll) and np.isfinite(res.heldout_ll)):
        raise AssertionError("config #3 stored bf16 scores are not finite")
    log(f"  config #3 stored, 100 steps at bf16: K2[bf16] once a step, "
        f"validation_ll={res.validation_ll:.5f} "
        f"heldout={res.heldout_ll:.5f}")


def phase_bign_bf16(dev, rec, bign):
    """compute_dtype="bfloat16" on the big-N path, on phase 4's data: a
    300-step fit in the local mode (K3, K8[bf16] and K7[bf16] in the
    steps, K4[bf16] in the eval and the export) and 100 steps in the
    stored mode, with no f32 body of K4-K8 and no twin; the local fit's
    heldout within BIGN_BF16_HELDOUT_GAP of phase 4's f32 fit. Then one
    step each with stats_kernel "pair" (K4[bf16] + K5[bf16]), "fused"
    (K6[bf16]) and "fused_v2" (K7[bf16]) from one state, their gammas
    within TOL_BF16_PASS, and one chunk re-run twice bitwise equal."""
    data, theta, ref = bign["data"], bign["theta"], bign["f32"]
    cfg = bign["cfg"].replace(compute_dtype="bfloat16")
    absent = BIGN_F32 + ("fused_local_solve", "fused_local_solve_dma",
                         "fused_local_solve[bf16]",
                         "fused_local_solve_dma[bf16]",
                         "gamma_stats_packed[bf16]",
                         "batch_stats_fused_packed[bf16]")
    res, got = bign_fit(dev, rec, cfg, data, theta,
                        ("gather_row_blocks", "lambda_stats_packed[bf16]",
                         "batch_stats_fused_v2_packed[bf16]",
                         "lambda_stats_acat[bf16]"), absent)
    gap = abs(got["heldout"] - ref["heldout"])
    log(f"  big-N local, {got['steps']} steps: bf16 / f32 theta_mae "
        f"{got['theta_mae']:.4f} / {ref['theta_mae']:.4f}, validation "
        f"{got['validation']:.5f} / {ref['validation']:.5f}, heldout "
        f"{got['heldout']:.5f} / {ref['heldout']:.5f} (gap {gap:.2e}, limit "
        f"{BIGN_BF16_HELDOUT_GAP:g}), SNP-updates/s "
        f"{got['snp_updates_per_s']:.1f} / {ref['snp_updates_per_s']:.1f}, "
        f"step {got['step_ms']:.3f} / {ref['step_ms']:.3f} ms, loop passes "
        f"{got['loop_passes']} / {ref['loop_passes']}")
    if not gap < BIGN_BF16_HELDOUT_GAP:
        raise AssertionError("big-N bf16 fit: heldout too far from the f32 "
                             "fit's")
    bign_fit(dev, rec, cfg.replace(lambda_mode="stored", max_steps=100,
                                   rfreq=50), data, theta,
             ("batch_stats_fused_v2_packed[bf16]", "lambda_stats_acat[bf16]"),
             absent + ("lambda_stats_packed[bf16]",))

    packed_d = engine.resident_packed(data.packed, dev)
    state = res.state
    gammas = {}
    for sk in ("pair", "fused", "fused_v2"):
        reset_counts()
        gammas[sk] = engine.make_step(cfg.replace(stats_kernel=sk))(
            state, packed_d).gamma
        want = {"pair": ("gamma_stats_packed[bf16]",
                         "lambda_stats_packed[bf16]"),
                "fused": ("batch_stats_fused_packed[bf16]",),
                "fused_v2": ("batch_stats_fused_v2_packed[bf16]",)}[sk]
        read_counts(rec, f"big-N step bfloat16 stats_kernel={sk}",
                    want + ("lambda_stats_acat[bf16]",),
                    absent=BIGN_F32 + ("fused_local_solve",
                                       "fused_local_solve_dma"))
    for sk in ("pair", "fused"):
        compare(f"big-N step bf16 gamma {sk} vs fused_v2", [gammas[sk]],
                [gammas["fused_v2"]], TOL_BF16_PASS)
    chunk = engine.make_run_chunk(cfg, cfg.rfreq, int(packed_d.shape[0]))
    a = chunk(state, packed_d).gamma.cpu()
    b = chunk(state, packed_d).gamma.cpu()
    if not torch.equal(a, b):
        raise AssertionError("big-N bf16 same-seed chunk re-run is not "
                             "bitwise equal")
    log("  big-N bf16 same-seed chunk re-run: gamma bitwise equal")


# Phase 8: the streamed big-N fit against phase 4's resident fit on the
# same data, seed and initial gamma, 300 steps each. Their minibatch draws
# differ (the stream draws the reference's SeedSequence((seed, t)) groups,
# the resident step its torch generator's K3 blocks), so the heldouts
# differ by the draws' Monte-Carlo error: |gap| in nats, at least 3x the
# gap measured on the card (both fits are deterministic, so every run
# measures the same gap): 8.66e-4 nats (heldout -0.96272 streamed against
# -0.96359 resident, theta MAE 0.0897 / 0.0903, NVIDIA H100 80GB HBM3,
# 700 W).
STREAM_HELDOUT_GAP = 0.005
# Phase 8c: config #5's width of N with L cut from 1M to 16,384 SNPs, so
# that the .bed is 4.1 GB instead of 250 GB (the full 1M x 1M file does
# not fit this run's disk and time).
CONFIG5_WIDTH = (1_000_000, 16_384, 10)    # N, L, K
# the kernels the streamed big-N step never launches: no resident matrix
# (K2), no gather on the card (K3), no fused branch (K1)
STREAM_ABSENT = ("fused_local_solve", "fused_local_solve_dma",
                 "gather_row_blocks", "fused_local_solve[bf16]",
                 "fused_local_solve_dma[bf16]")


def write_plink(tmp, stem, packed, n):
    """packed (L, W) as tmp/stem.bed with its .fam and .bim; the path."""
    path = f"{tmp}/{stem}.bed"
    bed.write_bed(path, packed, n)
    bed.write_fam(f"{tmp}/{stem}.fam", range(n))
    bed.write_bim(f"{tmp}/{stem}.bim", range(packed.shape[0]))
    return path


def stream_data(dev, tmp, stem, n, l, k):
    """simulate_packed_device(n, l, k, seed=0) written as a .bed, ingested
    into an on-disk cache and carved there as phases 3 and 4 carve.
    Returns (data with the cache memmap as its matrix, theta)."""
    t0 = time.time()
    packed, theta = simulate_packed_device(n, l, k, seed=0, device=dev)
    t1 = time.time()
    path = write_plink(tmp, stem, packed, n)
    del packed
    t2 = time.time()
    cache, ind_ids, snp_ids = bed.bed_to_packed_cache(
        path, f"{tmp}/{stem}.cache.npy")
    t3 = time.time()
    data = GenotypeData.from_packed(
        cache, n, seed=0, validation_frac=0.005, heldout_frac=0.005,
        max_eval_entries=200_000, eval_snp_pool=2048, ind_ids=ind_ids,
        snp_ids=snp_ids)
    if not isinstance(data.packed, np.memmap) or len(data.ind_ids) != n:
        raise AssertionError(f"{stem}: the carve left the cache")
    log(f"  {stem}: simulate {t1 - t0:.1f} s, .bed write "
        f"{t2 - t1:.1f} s ({os.path.getsize(path) / 1e9:.2f} GB), ingest "
        f"{t3 - t2:.1f} s, carve {time.time() - t3:.1f} s")
    return data, theta


def stream_io_ms(dev, cfg, packed, reps=10):
    """(gather ms, copy ms, batch bytes) of one streamed batch: the native
    gather of step t's groups into a pinned buffer (host clock, over reps
    steps' draws), and its copy to the card (CUDA events)."""
    bs = stream.BatchStream(cfg, packed)          # its gather only
    buf = torch.full((bs.b, bs.wp), 0xFF, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty((bs.b, bs.wp), dtype=torch.uint8, device=dev)
    bs.gather(0, buf.numpy())
    t = time.perf_counter()
    for i in range(reps):
        bs.gather(1 + i, buf.numpy())
    gather_ms = (time.perf_counter() - t) / reps * 1e3
    copy_ms = time_ms(lambda: dst.copy_(buf, non_blocking=True), reps)
    return gather_ms, copy_ms, bs.b * bs.wp


def steady_step_ms(chunk, state, packed, nsteps):
    """ms a step of chunk(state, packed) (nsteps steps) after a first run
    that builds what the runner keeps (the stream's pinned buffers): host
    clock to a device value read back, the chunk's first batch, which
    nothing overlaps, included."""
    float(chunk(state, packed).gamma[0, 0])
    t = time.perf_counter()
    float(chunk(state, packed).gamma[0, 0])
    return (time.perf_counter() - t) / nsteps * 1e3


def stream_expect(dtype):
    """(launched, absent) kernels of a streamed big-N fit at dtype: K8
    and K7 in the steps, K4 in the eval and the export, no other body."""
    if dtype == "bfloat16":
        return (("lambda_stats_packed[bf16]", "batch_stats_fused_v2_packed"
                 "[bf16]", "lambda_stats_acat[bf16]"),
                STREAM_ABSENT + BIGN_F32 + ("gamma_stats_packed[bf16]",
                                            "batch_stats_fused_packed[bf16]"))
    return (("lambda_stats_packed", "batch_stats_fused_v2_packed",
             "lambda_stats_acat"),
            STREAM_ABSENT + ("gamma_stats_packed", "batch_stats_fused_packed")
            + tuple(n for n in KERNELS if n.endswith("[bf16]")))


def stream_fit(dev, rec, cfg, data, theta):
    """A streamed big-N fit (bign_fit with stream=True) with K7 launched
    once a step and K8 at least once a step."""
    expect, absent = stream_expect(cfg.compute_dtype)
    res, got = bign_fit(dev, rec, cfg, data, theta, expect, absent,
                        stream=True)
    k7, k8 = expect[1], expect[2]
    if got["counts"][k7] != res.steps or got["counts"][k8] < res.steps:
        raise AssertionError(f"streamed fit: {k7} or {k8} missed a step")
    return res, got


def phase_stream(dev, rec, bign):
    """Out-of-core streaming: (a) phase 4's matrix through a .bed and an
    on-disk cache, fit(stream=True) for 300 steps against phase 4's fit;
    (b) the same at bf16 for 100 steps; (c) config #5's width of N."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    try:
        phase_stream_bign(dev, rec, bign, tmp)
        for p in Path(tmp).iterdir():
            p.unlink()
        log("phase 8c: streamed fit at config #5's width of N")
        phase_stream_config5(dev, rec, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_stream_bign(dev, rec, bign, tmp):
    cfg = bign["cfg"]
    n, l = cfg.n, cfg.l
    data, theta = stream_data(dev, tmp, "bign", n, l, cfg.k)
    ref = bign["data"]
    for a, b in ((data.validation, ref.validation),
                 (data.heldout, ref.heldout)):
        if not all(np.array_equal(getattr(a, f), getattr(b, f))
                   for f in ("ind_idx", "snp_idx", "x")):
            raise AssertionError("streamed data: eval sets differ from "
                                 "phase 4's")
    if not np.array_equal(data.packed, ref.packed):
        raise AssertionError("streamed data: carved cache differs from "
                             "phase 4's matrix")
    log("  cache carve: eval sets and carved matrix equal phase 4's")
    res, got = stream_fit(dev, rec, cfg, data, theta)
    f32 = bign["f32"]
    gap = abs(got["heldout"] - f32["heldout"])
    log(f"  streamed / resident, {got['steps']} steps: theta_mae "
        f"{got['theta_mae']:.4f} / {f32['theta_mae']:.4f}, validation "
        f"{got['validation']:.5f} / {f32['validation']:.5f}, heldout "
        f"{got['heldout']:.5f} / {f32['heldout']:.5f} (gap {gap:.2e}, "
        f"limit {STREAM_HELDOUT_GAP:g}), step {got['step_ms']:.3f} / "
        f"{f32['step_ms']:.3f} ms")
    if not gap < STREAM_HELDOUT_GAP:
        raise AssertionError("streamed fit: heldout too far from phase 4's")

    # batches of steps 0-2: the reference's draw, gathered on the host
    b, g = cfg.batch_size, cfg.snp_group
    w = data.packed.shape[1]
    bs = stream.BatchStream(cfg, data.packed, dev)
    batches = []
    for t in range(3):
        rows = bs.ready(bs.batch(t))
        starts = np.random.default_rng(np.random.SeedSequence(
            (cfg.seed, t))).integers(0, l, size=b // g)
        want = np.full((b, bs.wp), 0xFF, dtype=np.uint8)
        want[:, :w] = data.packed[((starts[:, None] + np.arange(g)) % l
                                   ).ravel()]
        if not torch.equal(rows.cpu(), torch.from_numpy(want)):
            raise AssertionError(f"streamed batch {t} is not the draw")
        batches.append(rows)
    log("  device batches of steps 0-2: bitwise packed[starts] of "
        "SeedSequence((0, t))")
    st = clone(res.state)
    got_step = stream.make_stream_step(cfg, l)(st, batches[0]).gamma
    gen = engine.step_generator(cfg.seed, st.t, dev, engine.SUB_TAG)
    _, stat = engine.step_core_packed(cfg, st.gamma, batches[0], gen=gen)
    if not torch.equal(got_step, engine._global_update(cfg, st.gamma, stat,
                                                       st.t, l)):
        raise AssertionError("streamed step differs from step_core_packed "
                             "+ _global_update on its rows")
    log("  streamed step: bitwise step_core_packed + _global_update")
    chunk = stream.make_stream_chunk(cfg, cfg.rfreq, l)
    a = chunk(clone(res.state), data.packed).gamma.cpu()
    if not torch.equal(a, chunk(clone(res.state), data.packed).gamma.cpu()):
        raise AssertionError("streamed chunk re-run is not bitwise equal")
    log("  streamed same-seed chunk re-run: gamma bitwise equal")
    gather_ms, copy_ms, nb = stream_io_ms(dev, cfg, data.packed)
    # steady steps, 20-step chunks from the fit's state in turns resident,
    # streamed, streamed, resident (the resident matrix from the carved
    # cache, which equals phase 4's)
    del batches, bs
    packed_d = engine.resident_packed(data.packed, dev)
    resident = engine.make_run_chunk(cfg, 20, l)
    streamed = stream.make_stream_chunk(cfg, 20, l)
    turns = [steady_step_ms(fn, res.state, p, 20) for fn, p in (
        (resident, packed_d), (streamed, data.packed),
        (streamed, data.packed), (resident, packed_d))]
    del packed_d
    log(f"  host stream B={b} W={w}: batch {nb / 1e6:.1f} MB, gather "
        f"{gather_ms:.3f} ms, copy {copy_ms:.3f} ms "
        f"({nb / copy_ms / 1e6:.2f} GB/s); step in the {got['steps']}-step "
        f"fits streamed {got['step_ms']:.3f} ms, resident {f32['step_ms']:.3f} "
        f"ms; steady step in turns resident, streamed, streamed, resident "
        f"{' / '.join(f'{x:.3f}' for x in turns)} ms")

    log("phase 8b: the streamed fit at bfloat16")
    _, got16 = stream_fit(dev, rec, cfg.replace(compute_dtype="bfloat16",
                                                max_steps=100), data, theta)
    log(f"  streamed bf16, {got16['steps']} steps: step "
        f"{got16['step_ms']:.3f} ms, heldout {got16['heldout']:.5f}")


def phase_stream_config5(dev, rec, tmp):
    n, l, k = CONFIG5_WIDTH
    data, theta = stream_data(dev, tmp, "config5", n, l, k)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=4096, rfreq=10, max_steps=20,
                    seed=0, snp_group=8)
    res, got = stream_fit(dev, rec, cfg, data, theta)
    t = time.time()
    lamb = stream.compute_lambda_stream(cfg, res.state.gamma, data.packed)
    export_s = time.time() - t
    if lamb.shape != (l, k, 2) or not np.isfinite(lamb).all():
        raise AssertionError("config #5 width: export is not finite")
    gather_ms, copy_ms, nb = stream_io_ms(dev, cfg, data.packed, reps=5)
    steady = steady_step_ms(stream.make_stream_chunk(cfg, 10, l), res.state,
                            data.packed, 10)
    log(f"  host stream B={cfg.batch_size} W={data.packed.shape[1]}: batch "
        f"{nb / 1e6:.1f} MB, gather {gather_ms:.3f} ms, copy "
        f"{copy_ms:.3f} ms ({nb / copy_ms / 1e6:.2f} GB/s), step in the "
        f"20-step fit {got['step_ms']:.3f} ms, steady step {steady:.3f} ms "
        f"(10-step chunks), export {export_s:.2f} s")

    # K7 at the step's shape and K4 at the export's block against their
    # twins, the twins summed over 256-row slices (whole, each would hold
    # ~60 GB of (B, 4W) temporaries)
    bs = stream.BatchStream(cfg, data.packed, dev)
    rows = bs.ready(bs.batch(0))
    wp = rows.shape[1]
    u = stats_packed.pad_individuals(exp_elog_theta(res.state.gamma), wp)
    up = stats_packed.u_to_planes(u)
    g = torch.Generator(device=dev).manual_seed(5)
    lamb_b = 0.5 + 2.5 * torch.rand((rows.shape[0], k, 2), generator=g,
                                    device=dev)
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb_b)

    def sliced(fn, b):
        return [fn(slice(i, min(i + 256, b))) for i in range(0, b, 256)]

    def k7_twin():
        parts = sliced(lambda s: twin_stats(rows[s], up, t1[s], t0[s]),
                       rows.shape[0])
        return (sum(p[0] for p in parts), torch.cat([p[1] for p in parts]),
                torch.cat([p[2] for p in parts]))

    shape = f"B={rows.shape[0]} W={wp} K={k}"
    hold(rec, "batch_stats_fused_v2_packed", f"K7 {shape}",
         twice(f"K7 {shape}", lambda: stats_packed.batch_stats_fused_v2_packed(
             rows, u, t1, t0)), k7_twin(), TOL)
    torch.cuda.empty_cache()
    e = dict(shape=shape, ms=time_ms(
        lambda: stats_packed.batch_stats_fused_v2_packed(rows, u, t1, t0), 5))
    log(f"  K7 {shape}: kernel {e['ms']:.4f} ms")
    set_bound(e, present(rows) * (12 * k + 2),
              nbytes(rows, u, t1, t0, u, t1, t0))
    rec["batch_stats_fused_v2_packed"]["config5_width"] = e
    eb = min(1024, rows.shape[0])         # the export's block of rows
    blk, bt1, bt0 = rows[:eb].contiguous(), t1[:eb], t0[:eb]
    shape = f"B={eb} W={wp} K={k}"
    hold(rec, "lambda_stats_packed", f"K4 {shape}",
         twice(f"K4 {shape}", lambda: stats_packed.lambda_stats_packed(
             blk, up, bt1, bt0)),
         [torch.cat(p) for p in zip(*sliced(
             lambda s: stats_packed.lambda_stats_packed_twin(
                 blk[s], up, bt1[s], bt0[s]), eb))], TOL)
    torch.cuda.empty_cache()
    e = dict(shape=shape, ms=time_ms(
        lambda: stats_packed.lambda_stats_packed(blk, up, bt1, bt0), 10))
    log(f"  K4 {shape}: kernel {e['ms']:.4f} ms")
    set_bound(e, present(blk) * lambda_pass_flops(k),
              nbytes(blk, up, bt1, bt0, bt1, bt0))
    rec["lambda_stats_packed"]["config5_width"] = e


# Phase 9: batched replicates (svi/replicates.py), R_REP seeds in lockstep
REP_SEEDS = tuple(range(R_REP))
# config #2's width: the reference's replicates_ab.py shape (:24-27) and
# its eval carve (:55-60)
CONFIG2 = (940, 640_000, 7, 1024)     # N, L, K, B


def _only_batched(path, counts, dtype="float32",
                  kernels=("fused_local_solve", "lambda_stats_packed")):
    """`kernels` (K1 and K4 by default) launched only with the replicate
    axis in a batched run: their launches at `dtype` are the batched
    ones, and the other dtype's body never ran."""
    sfx, other = ("[bf16]", "") if dtype == "bfloat16" else ("", "[bf16]")
    for k in kernels:
        if counts[k + sfx] != counts[k + "[rep]"] or counts[k + other]:
            raise AssertionError(f"{path}: {k} launched without the "
                                 f"replicate axis ({counts[k + sfx]} "
                                 f"{dtype} launches, {counts[k + '[rep]']} "
                                 f"batched, {counts[k + other]} of the other "
                                 "body)")


def _against_serial(path, dev, cfg, data, res, lamb=False, only=None,
                    ll_gap=1e-6):
    """Each replicate of a batched fit (or replicate `only`) against a
    single fit with its seed: the same stop step, gamma (and lambda)
    bitwise at the stop, the validation ll within ll_gap; with every
    replicate, the same best. Returns the single fits."""
    idx = range(len(res.replicates)) if only is None else [only]
    serial = [fit(cfg.replace(seed=res.replicates[i].seed,
                              dma_gather=False), data, device=dev)
              for i in idx]
    for i, sr in zip(idx, serial):
        rr = res.replicates[i]
        same = (rr.steps == sr.steps
                and torch.equal(res.states.gamma[i], sr.state.gamma)
                and (not lamb or torch.equal(res.states.lamb[i],
                                             sr.state.lamb)))
        gap = abs(rr.validation_ll - sr.validation_ll)
        log(f"  {path} seed {rr.seed}: batched / single steps {rr.steps} / "
            f"{sr.steps}, validation ll {rr.validation_ll:.6f} / "
            f"{sr.validation_ll:.6f} (gap {gap:.2e}), heldout "
            f"{rr.heldout_ll:.6f} / {sr.heldout_ll:.6f}, gamma"
            + (" and lambda" if lamb else "") + " bitwise: " + str(same))
        if not (same and gap <= ll_gap):
            raise AssertionError(f"{path}: replicate {i} (seed {rr.seed}) "
                                 "differs from its single fit")
    best = int(np.argmax([sr.validation_ll for sr in serial]))
    if only is None and res.best != best:
        raise AssertionError(f"{path}: best replicate {res.best}, single "
                             f"fits' {best}")
    return serial


def rep_step_ms(dev, cfg, packed, seeds, nsteps):
    """Host-clock ms a step of the batched replicates' steady chunk and of
    len(seeds) single fits' chunks (one after another), in turns (single,
    batched, batched, single), each from fresh states after a warm-up
    chunk, and the host's ms a step for the R generators and draws alone
    (enqueued, not waited for; on the big-N path 2R generators, the
    column subsample's too)."""
    l_s = packed.shape[0]
    cfg = cfg.replace(dma_gather=False)
    rchunk = engine.make_replicate_run_chunk(cfg, nsteps, l_s)
    schunk = engine.make_run_chunk(cfg, nsteps, l_s)

    def timed(run, state):
        state = run(state)                      # warm-up chunk
        torch.cuda.synchronize()
        t = time.perf_counter()
        run(state)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / nsteps * 1e3

    def batched():
        return timed(lambda st: rchunk(st, packed),
                     engine.init_replicate_state(cfg, seeds, l_padded=l_s,
                                                 device=dev))

    def single():
        return timed(lambda sts: [schunk(st, packed) for st in sts],
                     [engine.init_state(cfg.replace(seed=s), l_padded=l_s,
                                        device=dev) for s in seeds])

    turns = [single(), batched(), batched(), single()]
    torch.cuda.synchronize()
    t = time.perf_counter()
    big_n = engine.step_impl(cfg, packed.shape[1]) == "pallas"
    for step in range(nsteps):
        for s in seeds:
            engine._sample_batch(engine.step_generator(s, step, dev), l_s,
                                 cfg.batch_size, dev)
            if big_n:
                engine.subsample_columns(cfg, packed.shape[1],
                                         engine.step_generator(
                                             s, step, dev, engine.SUB_TAG))
    draws = (time.perf_counter() - t) / nsteps * 1e3
    torch.cuda.synchronize()
    return dict(single_ms=(turns[0] + turns[3]) / 2,
                batched_ms=(turns[1] + turns[2]) / 2, turns=turns,
                draws_host_ms=draws)


def phase_replicates(dev, rec):
    """Batched replicates through `fit_replicates_batched`: (a) config #1,
    R = 4, seeds 0-3, to convergence in the local mode against 4 single
    fits (stop step, gamma bitwise at the stop, validation ll, best
    index), every replicate within phase 2's quality limits, K1 and K4
    launched only with the replicate axis, no twin, K3 never; the batched
    step's ms against 4 single steps in turns; (b) the stored mode, R = 3,
    100 steps: gamma and lambda bitwise the single fits'; (c) bf16, R = 4,
    100 steps: bitwise the single bf16 fits', no f32 body; (d) config #2's
    width (940 x 640,000, K = 7, B = 1,024), R = 4, up to 6,000 steps:
    each replicate's stop, validation ll, theta MAE and heldout against
    the oracle, the best seed's single fit beside it (bitwise), the best
    replicate within theta MAE 0.02 and 0.02 nats of the oracle; steps in
    turns."""
    from terastructure_tpu_torch.svi.replicates import fit_replicates_batched

    theta_true, beta_true, data = canonical_data()
    h = data.heldout
    p = (theta_true[h.ind_idx] * beta_true[h.snp_idx]).sum(-1)
    oracle = float(psd.binomial2_loglik(
        torch.from_numpy(h.x), torch.from_numpy(p).float()).mean())
    cfg = SVIConfig(n=1000, l=10_000, k=3, batch_size=256, rfreq=50,
                    max_steps=3000, seed=11)
    absent = ("gather_row_blocks", "fused_local_solve_dma",
              "fused_local_solve_dma[bf16]")

    log("phase 9a: config #1, R = 4, local mode, to convergence")
    reset_counts()
    res = fit_replicates_batched(cfg, data, REP_SEEDS, device=dev)
    counts = read_counts(rec, "phase 9a batched",
                         ("fused_local_solve[rep]",
                          "lambda_stats_packed[rep]"), absent)
    _only_batched("phase 9a", counts)
    last = res.trace[-1]["step"]
    if counts["fused_local_solve[rep]"] != last:
        raise AssertionError("phase 9a: K1[rep] did not run once a step")
    chunk_s = sum(r["chunk_s"] for r in res.trace)
    eval_s = sum(r.get("eval_s", 0.0) for r in res.trace)
    log(f"  batched: {last} lockstep steps, chunk_s={chunk_s:.3f} "
        f"eval_s={eval_s:.3f} wall_s={res.wall_s:.2f}, best seed "
        f"{res.replicates[res.best].seed}")
    for i, rr in enumerate(res.replicates):
        th = psd.theta_mean(res.states.gamma[i]).cpu().numpy()
        err = mean_abs_theta_error(th, theta_true)
        log(f"  seed {rr.seed}: converged={rr.converged} steps={rr.steps} "
            f"validation={rr.validation_ll:.6f} heldout={rr.heldout_ll:.5f} "
            f"(oracle {oracle:.5f}) theta_mae={err:.4f}")
        if not (rr.converged and err < 0.05
                and rr.heldout_ll > oracle - 0.02):
            raise AssertionError(f"phase 9a: seed {rr.seed} failed phase "
                                 "2's quality limits")
    t0 = time.time()
    serial = _against_serial("phase 9a", dev, cfg, data, res)
    serial_chunk_s = sum(r["chunk_s"] for sr in serial for r in sr.trace)
    log(f"  the 4 single fits: {time.time() - t0:.2f} s, chunk_s "
        f"{serial_chunk_s:.3f} (batched {chunk_s:.3f})")
    packed_d = engine.resident_packed(data.packed, dev)
    steps = rep_step_ms(dev, cfg, packed_d, REP_SEEDS, 50)
    log(f"  config #1 step ms, single x {R_REP} / batched in turns: "
        + ", ".join(f"{t:.4f}" for t in steps["turns"])
        + f"; the R draws' host ms a step {steps['draws_host_ms']:.4f}")

    log("phase 9b: config #1, R = 3, stored mode, 100 steps")
    scfg = cfg.replace(lambda_mode="stored", max_steps=100, conv_tol=-1e9)
    reset_counts()
    res = fit_replicates_batched(scfg, data, REP_SEEDS[:3], device=dev)
    counts = read_counts(rec, "phase 9b batched", ("fused_local_solve[rep]",),
                         absent + ("lambda_stats_packed",
                                   "lambda_stats_packed[bf16]"))
    _only_batched("phase 9b", counts)
    _against_serial("phase 9b", dev, scfg, data, res, lamb=True)

    log("phase 9c: config #1, R = 4, compute_dtype bfloat16, 100 steps")
    bcfg = cfg.replace(compute_dtype="bfloat16", max_steps=100,
                       conv_tol=-1e9)
    reset_counts()
    res = fit_replicates_batched(bcfg, data, REP_SEEDS, device=dev)
    counts = read_counts(rec, "phase 9c batched",
                         ("fused_local_solve[rep]",
                          "lambda_stats_packed[rep]"), absent)
    _only_batched("phase 9c", counts, "bfloat16")
    _against_serial("phase 9c", dev, bcfg, data, res)

    log("phase 9d: config #2's width, R = 4, up to 6,000 steps")
    phase_config2_replicates(dev, rec)


def phase_config2_replicates(dev, rec):
    """Phase 9d (phase_replicates)."""
    from terastructure_tpu_torch.svi.replicates import fit_replicates_batched

    n, l, k, b = CONFIG2
    t0 = time.time()
    packed, theta = simulate_packed_device(n, l, k, seed=0, device=dev)
    data = GenotypeData.from_packed(
        packed, n, seed=0, validation_frac=0.005, heldout_frac=0.005,
        max_eval_entries=min(max(int(0.005 * n * l), 100), 200_000),
        eval_snp_pool=2048)
    h = data.heldout
    beta = simulated_beta(n, l, k, seed=0)
    p = (theta[h.ind_idx] * beta[h.snp_idx]).sum(-1)
    oracle = float(psd.binomial2_loglik(torch.from_numpy(h.x),
                                        torch.from_numpy(p)).mean())
    log(f"  config #2 data: simulate + carve {time.time() - t0:.1f} s")
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=b, rfreq=100, max_steps=6000,
                    seed=0)
    reset_counts()
    res = fit_replicates_batched(cfg, data, REP_SEEDS, device=dev)
    counts = read_counts(rec, "phase 9d batched",
                         ("fused_local_solve[rep]",
                          "lambda_stats_packed[rep]"),
                         ("gather_row_blocks", "fused_local_solve_dma"))
    _only_batched("phase 9d", counts)
    last = res.trace[-1]["step"]
    chunk_s = sum(r["chunk_s"] for r in res.trace)
    eval_s = sum(r.get("eval_s", 0.0) for r in res.trace)
    log(f"  batched: {last} lockstep steps, chunk_s={chunk_s:.3f} "
        f"eval_s={eval_s:.3f} wall_s={res.wall_s:.2f}")
    maes = []
    for i, rr in enumerate(res.replicates):
        th = psd.theta_mean(res.states.gamma[i]).cpu().numpy()
        maes.append(mean_abs_theta_error(th, theta))
        log(f"  seed {rr.seed}: converged={rr.converged} steps={rr.steps} "
            f"validation={rr.validation_ll:.6f} heldout={rr.heldout_ll:.5f} "
            f"(oracle {oracle:.5f}) theta_mae={maes[-1]:.5f}")
    if not (maes[res.best] < 0.02
            and abs(res.replicates[res.best].heldout_ll - oracle) < 0.02):
        raise AssertionError("phase 9d: the best replicate misses theta MAE "
                             "0.02 or 0.02 nats of the oracle")
    t0 = time.time()
    single = _against_serial("phase 9d", dev, cfg, data, res,
                             only=res.best)[0]
    log(f"  the best seed's single fit: {time.time() - t0:.2f} s, "
        f"chunk_s {sum(r['chunk_s'] for r in single.trace):.3f}")
    packed_d = engine.resident_packed(data.packed, dev)
    steps = rep_step_ms(dev, cfg, packed_d, REP_SEEDS, 20)
    log(f"  config #2 step ms, single x {R_REP} / batched in turns: "
        + ", ".join(f"{t:.4f}" for t in steps["turns"])
        + f"; the R draws' host ms a step {steps['draws_host_ms']:.4f}")


# Phase 11: batched replicates on the big-N path, on phase 4's data.
REP_BIGN_PATH = ("lambda_stats_acat", "batch_stats_fused_v2_packed",
                 "lambda_stats_packed")      # K8, K7 and K4 (the eval)
REP_BIGN_ABSENT = ("fused_local_solve", "fused_local_solve_dma",
                   "gather_row_blocks", "fused_local_solve[bf16]",
                   "fused_local_solve_dma[bf16]", "gamma_stats_packed",
                   "batch_stats_fused_packed", "gamma_stats_packed[bf16]",
                   "batch_stats_fused_packed[bf16]")


@contextlib.contextmanager
def shared_eval_subsample(seed):
    """Score every fit with the local mode's eval column subsample of
    `seed`: the batched scorer draws one for all replicates from cfg.seed
    (the reference's rule, svi/replicates.py), a single fit its own from
    its seed. At big N the subsample engages, so a single fit is held to
    a batched replicate under the batched scorer's subsample."""
    orig = engine.make_entry_loglik_recompute
    engine.make_entry_loglik_recompute = (
        lambda cfg, *a, **kw: orig(cfg.replace(seed=seed), *a, **kw))
    try:
        yield
    finally:
        engine.make_entry_loglik_recompute = orig


def _rep_bign_fit(path, dev, rec, cfg, data, seeds, expect, absent,
                  lamb=False):
    """fit_replicates_batched on the big-N path: `expect` launched only
    with the replicate axis, `absent` never, no twin; each replicate
    against its single fit (`_against_serial`, every check's validation
    ll bitwise, under the batched scorer's eval subsample). Returns the
    batched fit, its counts and the single fits."""
    from terastructure_tpu_torch.svi.replicates import fit_replicates_batched

    reset_counts()
    stats_packed.local_solve_acat.loop_passes = []
    torch.cuda.reset_peak_memory_stats()
    try:
        res = fit_replicates_batched(cfg, data, seeds, device=dev)
        passes = [int(n) for n in stats_packed.local_solve_acat.loop_passes]
    finally:
        stats_packed.local_solve_acat.loop_passes = None
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts(rec, f"{path} batched",
                         [n + "[rep]" for n in expect], absent)
    _only_batched(path, counts, cfg.compute_dtype, expect)
    last = res.trace[-1]["step"]
    hist = {n: passes.count(n) for n in sorted(set(passes))}
    chunk_s = sum(r["chunk_s"] for r in res.trace)
    log(f"  {path}: {last} lockstep steps, {chunk_s / last * 1e3:.3f} ms a "
        f"step (chunk seconds over steps), wall_s {res.wall_s:.2f}, peak "
        f"device memory {peak / 1e9:.2f} GB; loop passes by count of "
        f"replicate solves {hist}")
    with shared_eval_subsample(cfg.seed):
        serial = _against_serial(path, dev, cfg, data, res, lamb=lamb,
                                 ll_gap=0.0)
    for i, sr in enumerate(serial):
        mine = [r["validation_ll"][i] for r in res.trace]
        theirs = [r["validation_ll"] for r in sr.trace]
        if mine != theirs or res.replicates[i].heldout_ll != sr.heldout_ll:
            raise AssertionError(f"{path}: replicate {i}'s scores differ "
                                 "from its single fit's")
    log(f"  {path}: every check's validation ll and the heldout of each "
        "replicate bitwise its single fit's")
    return res, counts, serial


def phase_replicates_bign(dev, rec, bign):
    """Batched replicates where the fused gate refuses the shape, on phase
    4's data (100K x 100K, K = 10, B = 4,096): (a) the local mode, R = 4
    seeds, 300 steps at rfreq 100, against 4 single fits with
    dma_gather=False (gamma, every check's validation ll and the heldout
    bitwise, under the batched scorer's eval subsample), K8, K7 and K4
    launched only with the replicate axis, no twin; the batched step's ms
    in turns with R single steps and the host ms of the 2R generators a
    step; (b) the stored mode, R = 2, 100 steps, snp_group 8: gamma and
    lambda bitwise; (c) bf16, R = 2, 100 steps: bitwise, no f32 body of
    K4-K8; (d) one step each with stats_kernel "pair" (K4[rep] +
    K5[rep]) and "fused" (K6[rep]), R = 2, bitwise the single steps; (e)
    config #5's width, N = 1M resident with L cut to 16,384 (a 4.1 GB
    matrix), R = 2, 20 steps at rfreq 10, bitwise the single fits, with
    the step ms and the peak device memory."""
    data, cfg0 = bign["data"], bign["cfg"]
    cfg = cfg0.replace(conv_tol=-1e9, dma_gather=False)
    seeds = REP_SEEDS

    log(f"phase 11a: the big-N path, R = {R_REP}, local mode, 300 steps")
    _rep_bign_fit("phase 11a", dev, rec, cfg, data, seeds, REP_BIGN_PATH,
                  REP_BIGN_ABSENT + tuple(n for n in KERNELS
                                          if n.endswith("[bf16]")))
    packed_d = engine.resident_packed(data.packed, dev)
    steps = rep_step_ms(dev, cfg, packed_d, seeds, 20)
    log(f"  big-N step ms, single x {R_REP} / batched in turns: "
        + ", ".join(f"{t:.4f}" for t in steps["turns"])
        + f"; the 2R generators' and draws' host ms a step "
        f"{steps['draws_host_ms']:.4f}")

    log("phase 11b: the big-N path, R = 2, stored mode, snp_group 8, "
        "100 steps")
    scfg = cfg.replace(lambda_mode="stored", max_steps=100)
    _rep_bign_fit("phase 11b", dev, rec, scfg, data, seeds[:2],
                  REP_BIGN_PATH[:2],
                  REP_BIGN_ABSENT + ("lambda_stats_packed",) + tuple(
                      n for n in KERNELS if n.endswith("[bf16]")),
                  lamb=True)

    log("phase 11c: the big-N path, R = 2, bfloat16, 100 steps")
    bcfg = cfg.replace(compute_dtype="bfloat16", max_steps=100)
    _rep_bign_fit("phase 11c", dev, rec, bcfg, data, seeds[:2],
                  REP_BIGN_PATH, REP_BIGN_ABSENT + BIGN_F32)

    log("phase 11d: one step with stats_kernel pair and fused, R = 2")
    l_s = int(packed_d.shape[0])
    for sk, kernels in (("pair", ("lambda_stats_packed",
                                  "gamma_stats_packed")),
                        ("fused", ("batch_stats_fused_packed",))):
        kcfg = cfg.replace(stats_kernel=sk)
        state = engine.init_replicate_state(kcfg, seeds[:2], l_padded=l_s,
                                            device=dev)
        reset_counts()
        got = engine.make_replicate_step(kcfg, l_s)(state, packed_d).gamma
        counts = read_counts(rec, f"phase 11d {sk}",
                             [n + "[rep]" for n in kernels] +
                             ["lambda_stats_acat[rep]"],
                             ("batch_stats_fused_v2_packed",))
        _only_batched(f"phase 11d {sk}", counts, "float32",
                      kernels + ("lambda_stats_acat",))
        for i, seed in enumerate(seeds[:2]):
            one = engine.make_step(kcfg, l_s)(engine.init_state(
                kcfg.replace(seed=seed), l_padded=l_s, device=dev), packed_d)
            if not torch.equal(got[i], one.gamma):
                raise AssertionError(f"phase 11d {sk}: replicate {i} "
                                     "differs from its single step")
        log(f"  phase 11d {sk}: each replicate bitwise its single step")
    del packed_d

    log("phase 11e: config #5's width, N = 1M resident, R = 2, 20 steps")
    n, l, k = CONFIG5_WIDTH
    t0 = time.time()
    packed, _ = simulate_packed_device(n, l, k, seed=0, device=dev)
    wdata = GenotypeData.from_packed(
        packed, n, seed=0, validation_frac=0.005, heldout_frac=0.005,
        max_eval_entries=200_000, eval_snp_pool=2048)
    del packed
    log(f"  config #5 width data: simulate + carve {time.time() - t0:.1f} s")
    wcfg = SVIConfig(n=n, l=l, k=k, batch_size=4096, rfreq=10, max_steps=20,
                     seed=0, snp_group=8, conv_tol=-1e9)
    _rep_bign_fit(
        "phase 11e", dev, rec, wcfg, wdata, seeds[:2], REP_BIGN_PATH,
        REP_BIGN_ABSENT + tuple(n for n in KERNELS if n.endswith("[bf16]")))


# Phase 14: batched replicates at K > 64 (the K > 64 bodies with the
# replicate axis) and with kernel="dense".
WIDE_K = 72


def _steps_ms(run, state, packed, nsteps):
    """run(state, packed) on the card: (its state, host-clock ms a step,
    synchronized at both ends)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    state = run(state, packed)
    torch.cuda.synchronize()
    return state, (time.perf_counter() - t) / nsteps * 1e3


def _singles_bitwise_chunk(path, cfg, packed, states, seeds, nsteps):
    """Each replicate of a batched run (states, a ReplicateState) against
    `nsteps` single steps from its seed's fresh state: gamma (and lambda
    in the stored mode) bitwise. Returns the single states and their ms
    a step (one seed after another)."""
    l_s = int(packed.shape[0])
    chunk = engine.make_run_chunk(cfg, nsteps, l_s)
    singles, ms = [], []
    for i, s in enumerate(seeds):
        st, t = _steps_ms(chunk, engine.init_state(
            cfg.replace(seed=s), l_padded=l_s, device=packed.device),
            packed, nsteps)
        ms.append(t)
        if not (torch.equal(states.gamma[i], st.gamma)
                and bool(torch.isfinite(st.gamma).all())):
            raise AssertionError(f"{path}: replicate {i} (seed {s}) differs "
                                 "from its single steps")
        singles.append(st)
    log(f"  {path}: each replicate's gamma bitwise its single {nsteps} "
        f"steps (single ms a step {', '.join(f'{t:.3f}' for t in ms)})")
    return singles


def phase_replicates_wide(dev, rec, tgp_data, bign):
    """Batched replicates at K > 64 and with kernel="dense": (a) the fused
    branch at config #3's width (2,504 x 1M), K = 72, B = 1,024,
    snp_group 1, R = 4: 100 steps of fit_replicates_batched's chunk
    runner, K1[rep] once a step (its K > 64 passes), K2 and K3 never,
    no twin, each replicate bitwise its single 100 steps; then one
    batched eval through K4[rep], each replicate's score its single
    scorer's; (b) the big-N branch on phase 4's data (100K x 100K),
    K = 72, B = 4,096, R = 2: 10 steps, K8[rep] 7 and K7[rep] 1 a step,
    bitwise the single steps, the step's ms and the peak device memory;
    (c) kernel="dense" at config #1, R = 4: one chunk bitwise the single
    dense chunks (the dense step has no kernel of its own: none
    launches), then the batched eval (K4[rep]); (d) `cli fit --replicates
    4 --batched -k 72 --max-steps 2000` at config #1: best.json names the
    replicate with the best validation ll."""
    from terastructure_tpu_torch.svi.driver import make_scorer

    t_phase = time.time()
    log(f"phase 14a: the fused branch at config #3's width, K = {WIDE_K}, "
        f"B = 1,024, R = {R_REP}, 100 steps")
    n, l, _ = TGP
    cfg = SVIConfig(n=n, l=l, k=WIDE_K, batch_size=1024, rfreq=100, seed=0,
                    snp_group=1, dma_gather=False)
    packed_d = engine.resident_packed(tgp_data.packed, dev)
    l_s = int(packed_d.shape[0])
    if engine.step_impl(cfg, packed_d.shape[1]) != "fused":
        raise AssertionError("phase 14a: the gate refused the fused branch")
    state = engine.init_replicate_state(cfg, REP_SEEDS, l_padded=l_s,
                                        device=dev)
    reset_counts()
    state, ms = _steps_ms(engine.make_replicate_run_chunk(cfg, 100, l_s),
                          state, packed_d, 100)
    counts = read_counts(rec, "phase 14a batched", ("fused_local_solve[rep]",),
                         absent=("gather_row_blocks", "fused_local_solve_dma",
                                 "lambda_stats_packed"))
    _only_batched("phase 14a", counts, kernels=("fused_local_solve",))
    if counts["fused_local_solve[rep]"] != 100:
        raise AssertionError("phase 14a: K1[rep] did not run once a step")
    log(f"  phase 14a: {ms:.3f} ms a batched step of {R_REP} replicates")
    singles = _singles_bitwise_chunk("phase 14a", cfg, packed_d, state,
                                     REP_SEEDS, 100)
    val = make_scorer(cfg, tgp_data, tgp_data.validation, dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lls = val(state.gamma, state.lamb).cpu()
    eval_s = time.perf_counter() - t0
    counts = read_counts(rec, "phase 14a batched eval",
                         ("lambda_stats_packed[rep]",),
                         absent=("fused_local_solve",))
    _only_batched("phase 14a eval", counts, kernels=("lambda_stats_packed",))
    ones = [float(val(st.gamma, st.lamb)) for st in singles]
    log(f"  phase 14a batched eval: {eval_s:.3f} s, validation ll "
        f"{[round(float(v), 6) for v in lls]}, the single scorer's {ones}")
    if [float(v) for v in lls] != ones or not np.isfinite(ones).all():
        raise AssertionError("phase 14a: a batched score differs from its "
                             "single scorer's")
    del packed_d, state, singles

    log(f"phase 14b: the big-N branch at 100K x 100K, K = {WIDE_K}, "
        "B = 4,096, R = 2, 10 steps")
    cfg = bign["cfg"].replace(k=WIDE_K, dma_gather=False)
    packed_d = engine.resident_packed(bign["data"].packed, dev)
    l_s = int(packed_d.shape[0])
    seeds = REP_SEEDS[:2]
    state = engine.init_replicate_state(cfg, seeds, l_padded=l_s, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state, ms = _steps_ms(engine.make_replicate_run_chunk(cfg, 10, l_s),
                          state, packed_d, 10)
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts(rec, "phase 14b batched",
                         ("lambda_stats_acat[rep]",
                          "batch_stats_fused_v2_packed[rep]"),
                         absent=REP_BIGN_ABSENT + ("lambda_stats_packed",))
    _only_batched("phase 14b", counts,
                  kernels=("lambda_stats_acat", "batch_stats_fused_v2_packed"))
    if (counts["lambda_stats_acat[rep]"], counts[
            "batch_stats_fused_v2_packed[rep]"]) != (70, 10):
        raise AssertionError("phase 14b: not K8[rep] 7 and K7[rep] 1 a step")
    log(f"  phase 14b: {ms:.3f} ms a batched step of 2 replicates, peak "
        f"device memory {peak / 1e9:.2f} GB")
    _singles_bitwise_chunk("phase 14b", cfg, packed_d, state, seeds, 10)
    del packed_d, state

    log(f"phase 14c: kernel='dense' at config #1, R = {R_REP}, one chunk")
    _, _, data = canonical_data()
    cfg = SVIConfig(n=1000, l=10_000, k=3, batch_size=256, rfreq=50,
                    seed=11, kernel="dense", dma_gather=False)
    packed_d = engine.resident_packed(data.packed, dev)
    l_s = int(packed_d.shape[0])
    state = engine.init_replicate_state(cfg, REP_SEEDS, l_padded=l_s,
                                        device=dev)
    reset_counts()
    state, ms = _steps_ms(engine.make_replicate_run_chunk(cfg, cfg.rfreq,
                                                          l_s),
                          state, packed_d, cfg.rfreq)
    read_counts(rec, "phase 14c batched dense", (), absent=tuple(KERNELS))
    log(f"  phase 14c: {ms:.3f} ms a batched dense step of {R_REP} "
        "replicates (no kernel of its own launched)")
    _singles_bitwise_chunk("phase 14c", cfg, packed_d, state, REP_SEEDS,
                           cfg.rfreq)
    reset_counts()
    lls = make_scorer(cfg, data, data.validation, dev)(state.gamma,
                                                       state.lamb)
    counts = read_counts(rec, "phase 14c batched eval",
                         ("lambda_stats_packed[rep]",))
    _only_batched("phase 14c eval", counts, kernels=("lambda_stats_packed",))
    log(f"  phase 14c batched eval (K4[rep]): validation ll "
        f"{[round(float(v), 6) for v in lls]}")
    del packed_d, state

    log(f"phase 14d: cli fit --replicates 4 --batched -k {WIDE_K} "
        "--max-steps 2000 at config #1")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_wide_"))
    try:
        stem = tmp / "c1"
        run_cli("simulate", "-n", 1000, "-l", 10_000, "-k", 3, "--seed", 11,
                "-o", stem)
        reset_counts()
        t0 = time.time()
        run_cli("fit", "--bed", f"{stem}.bed", "-k", WIDE_K, "--batch-size",
                256, "--seed", 11, "--replicates", R_REP, "--batched",
                "--max-steps", 2000, "--label", "w", "--out-base", tmp)
        fit_s = time.time() - t0
        launched_only(rec, f"CLI fit --batched -k {WIDE_K}",
                      ("fused_local_solve", "fused_local_solve[rep]",
                       "lambda_stats_packed", "lambda_stats_packed[rep]"),
                      expect=("fused_local_solve[rep]",
                              "lambda_stats_packed[rep]"))
        run = tmp / f"n1000-k{WIDE_K}-l10000-w"
        best = json.loads((run / "best.json").read_text())
        reps = {d.name: json.loads((d / "result.json").read_text())
                for d in sorted(run.glob("replicate-s*"))}
        lls = {d: r["validation_ll"] for d, r in reps.items()}
        log(f"  CLI fit --batched -k {WIDE_K}: {fit_s:.2f} s, replicates "
            + ", ".join(f"{d} steps={r['steps']} validation="
                        f"{r['validation_ll']:.6f}" for d, r in reps.items())
            + f"; best {best}")
        if (len(reps) != R_REP or best["dir"] != max(lls, key=lls.get)
                or not np.isfinite(best["heldout_ll"] or np.nan)):
            raise AssertionError("phase 14d: best.json does not name the "
                                 "replicate with the best validation ll")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  phase 14 in {time.time() - t_phase:.1f} s")


# Phase 10: the command line (cli.py) on the card, from PLINK files in a
# temporary directory. 10a: config #1 through `simulate`, `fit`,
# `compute-beta`, `fit --replicates 2 --batched` and `fit --stream`; 10b:
# `fit --resume` bitwise an uninterrupted fit in both lambda modes, and an
# asynchronous mid-fit checkpoint; 10c: config #3's width from a .bed with
# `--init-mode spectral`, and `pca`.
RUN_FILES = ("theta.txt", "gamma.txt", "beta.txt", "lambda.txt",
             "metrics.jsonl", "validation.txt", "infer.log", "config.json",
             "result.json", "checkpoint")
# the streamed CLI fit: the smallest N at which the big-N step's column
# subsample engages (local_sub_n 8,192 individuals, 2,048 bytes, needs a
# padded width of 4 x 2,048 bytes), so that K8 launches; config #1's N of
# 1,000 runs the whole solve on K4
CLI_STREAM = (32_768, 4_096, 3)      # N, L, K
# The top K-1 = 7 singular values of the standardized config #3 matrix
# lie within ~6% of each other (2,521-2,685 at L = 50,000 on the CPU),
# so a column of one embedding is any rotation of the others' within
# their span: the embeddings are held as subspaces, each principal
# cosine at least this (measured on the CPU at L = 50,000: init against
# the exact subspace 0.986-0.999, pca's first 7 columns against the
# init 0.980-0.997).
PCA_SUBSPACE_COS = 0.95


def run_cli(*argv):
    """cli.main(argv); then the root logger's handlers, which it points at
    the run's infer.log and stderr, closed and removed."""
    try:
        return cli.main([str(a) for a in argv])
    finally:
        for h in logging.root.handlers[:]:
            logging.root.removeHandler(h)
            h.close()


def launched_only(rec, path, launched, expect=None):
    """read_counts with every kernel outside `launched` absent; `expect`
    (default: all of `launched`) must have launched."""
    return read_counts(rec, path, launched if expect is None else expect,
                       absent=tuple(n for n in KERNELS if n not in launched))


def oracle_ll(theta, beta, es):
    """Mean heldout log-likelihood of the generating theta and beta on an
    entry set."""
    p = (np.asarray(theta)[es.ind_idx] * np.asarray(beta)[es.snp_idx]).sum(-1)
    return float(psd.binomial2_loglik(
        torch.from_numpy(es.x), torch.from_numpy(p).float()).mean())


def run_quality(run, theta_true, beta_true, data):
    """(result.json, theta MAE of theta.txt, oracle heldout) of a run."""
    res = json.loads((run / "result.json").read_text())
    err = mean_abs_theta_error(load_matrix(run / "theta.txt"), theta_true)
    return res, err, oracle_ll(theta_true, beta_true, data.heldout)


def phase_cli(dev, rec):
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    try:
        stem = phase_cli_config1(dev, rec, tmp)
        log("phase 10b: resume, bitwise")
        phase_cli_resume(dev, rec, tmp, stem)
        for p in tmp.iterdir():
            shutil.rmtree(p) if p.is_dir() else p.unlink()
        log("phase 10c: config #3's width from a .bed, spectral init")
        phase_cli_config3(dev, rec, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_cli_config1(dev, rec, tmp):
    stem = tmp / "c1"
    t0 = time.time()
    run_cli("simulate", "-n", 1000, "-l", 10_000, "-k", 3, "--seed", 11,
            "-o", stem)
    log(f"  simulate: {time.time() - t0:.2f} s")
    common = ("--bed", f"{stem}.bed", "-k", 3, "--batch-size", 256,
              "--seed", 11, "--out-base", tmp)
    reset_counts()
    t0 = time.time()
    run_cli("fit", *common, "--label", "c1")
    fit_s = time.time() - t0
    launched_only(rec, "CLI fit config #1",
                  ("fused_local_solve", "lambda_stats_packed"))
    run = tmp / "n1000-k3-l10000-c1"
    missing = [f for f in RUN_FILES if not (run / f).exists()]
    if missing:
        raise AssertionError(f"CLI fit: the run dir lacks {missing}")
    data = GenotypeData.from_bed(f"{stem}.bed", seed=11)     # the fit's carve
    res, err, oracle = run_quality(
        run, load_matrix(f"{stem}.theta_true.txt"),
        load_matrix(f"{stem}.beta_true.txt"), data)
    log(f"  CLI fit config #1: {fit_s:.2f} s, converged={res['converged']} "
        f"steps={res['steps']} theta_mae={err:.4f} "
        f"heldout={res['heldout_ll']:.5f} oracle={oracle:.5f} "
        f"timings={res['timings']}")
    if not (res["converged"] and err < 0.05
            and res["heldout_ll"] > oracle - 0.02):
        raise AssertionError("CLI fit config #1 failed its quality checks")

    fit_beta = (run / "beta.txt").read_bytes()
    reset_counts()
    t0 = time.time()
    run_cli("compute-beta", "--run-dir", run, "--bed", f"{stem}.bed")
    launched_only(rec, "CLI compute-beta", ("lambda_stats_packed",))
    if (run / "beta.txt").read_bytes() != fit_beta:
        raise AssertionError("compute-beta's beta.txt differs from the fit's")
    log(f"  compute-beta: {time.time() - t0:.2f} s, beta.txt text for text "
        "the fit's")

    reset_counts()
    t0 = time.time()
    run_cli("fit", *common, "--replicates", 2, "--batched", "--label", "b")
    launched_only(rec, "CLI fit --batched",
                  ("fused_local_solve", "fused_local_solve[rep]",
                   "lambda_stats_packed", "lambda_stats_packed[rep]"),
                  expect=("fused_local_solve[rep]",
                          "lambda_stats_packed[rep]"))
    best = json.loads((tmp / "n1000-k3-l10000-b" / "best.json").read_text())
    log(f"  CLI fit --batched --replicates 2: {time.time() - t0:.2f} s, "
        f"best {best}")
    if not np.isfinite(best["heldout_ll"] or np.nan):
        raise AssertionError("batched best.json: no finite heldout")

    n, l, k = CLI_STREAM
    wide = tmp / "wide"
    t0 = time.time()
    run_cli("simulate", "-n", n, "-l", l, "-k", k, "-o", wide)
    t1 = time.time()
    reset_counts()
    run_cli("fit", "--bed", f"{wide}.bed", "-k", k, "--batch-size", 256,
            "--stream", "--max-steps", 200, "--label", "s", "--out-base", tmp)
    launched_only(rec, "CLI fit --stream",
                  ("lambda_stats_packed", "batch_stats_fused_v2_packed",
                   "lambda_stats_acat"))
    res = json.loads((tmp / f"n{n}-k{k}-l{l}-s" / "result.json").read_text())
    log(f"  CLI fit --stream at N = {n:,}: simulate {t1 - t0:.2f} s, fit "
        f"{time.time() - t1:.2f} s, steps={res['steps']} "
        f"heldout={res['heldout_ll']:.5f} timings={res['timings']}")
    if res["steps"] != 200 or not np.isfinite(res["heldout_ll"]):
        raise AssertionError("CLI streamed fit: wrong steps or no heldout")
    return stem


def phase_cli_resume(dev, rec, tmp, stem):
    for mode in ("local", "stored"):
        common = ("fit", "--bed", f"{stem}.bed", "-k", 3, "--batch-size", 256,
                  "--seed", 11, "--validation-frac", 0, "--heldout-frac", 0,
                  "--lambda-mode", mode, "--out-base", tmp)
        reset_counts()
        t0 = time.time()
        run_cli(*common, "--label", f"r-{mode}", "--max-steps", 400)
        run_cli(*common, "--label", f"r-{mode}", "--max-steps", 800,
                "--resume")
        t1 = time.time()
        run_cli(*common, "--label", f"s-{mode}", "--max-steps", 800)
        launched_only(rec, f"CLI resume {mode}",
                      ("fused_local_solve",)
                      + (("lambda_stats_packed",) if mode == "local" else ()))
        resumed = tmp / f"n1000-k3-l10000-r-{mode}"
        straight = tmp / f"n1000-k3-l10000-s-{mode}"
        steps = json.loads((resumed / "result.json").read_text())["steps"]
        same = {f: (resumed / f).read_bytes() == (straight / f).read_bytes()
                for f in ("gamma.txt", "lambda.txt")}
        log(f"  {mode}: 400 + resume to {steps} in {t1 - t0:.2f} s, "
            f"straight 800 in {time.time() - t1:.2f} s; byte-identical "
            f"{same}")
        if steps != 800 or not all(same.values()):
            raise AssertionError(f"CLI resume ({mode}) is not the "
                                 "uninterrupted fit")

    # a checkpoint saved asynchronously at the second check (step 200),
    # written while steps 201-300 scatter lambda in place
    cfg = SVIConfig(n=1000, l=10_000, k=3, batch_size=256, rfreq=100,
                    max_steps=300, seed=11, lambda_mode="stored",
                    validation_frac=0.0, heldout_frac=0.0)
    data = GenotypeData.from_bed(f"{stem}.bed", seed=11, validation_frac=0.0,
                                 heldout_frac=0.0)
    ck = tmp / "mid"
    reset_counts()
    res = fit(cfg, data, device=dev, checkpoint_dir=str(ck),
              checkpoint_every=2)
    state, _ = restore_checkpoint(str(ck), device=dev)
    at200 = fit(cfg.replace(max_steps=200), data, device=dev)
    launched_only(rec, "mid-fit checkpoint", ("fused_local_solve",))
    ok = (state.t == 200 and torch.equal(state.gamma, at200.state.gamma)
          and torch.equal(state.lamb, at200.state.lamb))
    log(f"  async checkpoint at step {state.t} of a {res.steps}-step stored "
        f"fit: gamma and lambda bitwise a 200-step fit's: {ok}; the loop "
        f"waited {res.timings['checkpoint_wait_s']} s on it")
    if not ok:
        raise AssertionError("the mid-fit checkpoint is not its check's "
                             "state")


def exact_subspace(packed_d, n, dims):
    """The exact top-`dims` right singular vectors (N, dims) of the
    standardized matrix: eigenvectors of its Gram matrix M^T M, summed
    over slabs in f32 and solved in f64 on the card."""
    gram = torch.zeros((n, n), dtype=torch.float32, device=packed_d.device)
    block = init.slab_rows(n)
    for i in range(0, packed_d.shape[0], block):
        z = init._standardized_block(packed_d[i:i + block], n)
        gram += z.T @ z
    evals, evecs = torch.linalg.eigh(gram.double())
    return (evecs[:, -dims:].flip(1).cpu().numpy(),
            evals.flip(0)[:dims + 2].clamp_min(0).sqrt().cpu().numpy())


def principal_cosines(a, b):
    """Cosines of the principal angles between the column spans of a and b."""
    qa, qb = np.linalg.qr(np.asarray(a))[0], np.linalg.qr(np.asarray(b))[0]
    return np.linalg.svd(qa.T @ qb, compute_uv=False)


def sync_s(t0):
    torch.cuda.synchronize()
    return time.time() - t0


def phase_cli_config3(dev, rec, tmp):
    n, l, k = TGP
    t0 = time.time()
    packed, theta = simulate_packed_device(n, l, k, seed=0, device=dev)
    t1 = time.time()
    path = write_plink(tmp, "c3", packed, n)
    del packed
    log(f"  simulate {t1 - t0:.1f} s, .bed write {time.time() - t1:.1f} s "
        f"({os.path.getsize(path) / 1e9:.3f} GB)")
    reset_counts()
    t0 = time.time()
    run_cli("fit", "--bed", path, "-k", k, "--batch-size", 1024,
            "--eval-snp-pool", 2048, "--init-mode", "spectral", "--label",
            "c3", "--out-base", tmp)
    cli_s = time.time() - t0
    launched_only(rec, "CLI fit config #3 width",
                  ("fused_local_solve", "gather_row_blocks",
                   "lambda_stats_packed"))
    run = tmp / f"n{n}-k{k}-l{l}-c3"
    data = GenotypeData.from_bed(path, seed=0, eval_snp_pool=2048)
    beta = simulated_beta(n, l, k, seed=0)
    res, err, oracle = run_quality(run, theta, beta, data)
    tm = res["timings"]
    log(f"  CLI fit --init-mode spectral: {cli_s:.2f} s of command, "
        f"converged={res['converged']} steps={res['steps']} "
        f"theta_mae={err:.5f} heldout={res['heldout_ll']:.5f} "
        f"oracle={oracle:.5f}")
    log("  its seconds: " + ", ".join(f"{key} {v}" for key, v in tm.items())
        + f"; the rest of the command "
        f"{cli_s - sum(tm.values()):.2f} (parse, config, logs)")
    if not (res["converged"] and err < 0.02
            and abs(res["heldout_ll"] - oracle) < 0.02):
        raise AssertionError("CLI fit at config #3's width failed its "
                             "quality checks")

    # the spectral init on its own: its PCA passes and k-means, its theta
    packed_d = engine.resident_packed(data.packed, dev)
    torch.cuda.synchronize()
    t0 = time.time()
    emb = init.pca_embedding(packed_d, n, k, seed=0, l_real=l)
    pca_s = sync_s(t0)
    t0 = time.time()
    g0 = init.gamma_from_embedding(emb, k, alpha=1.0 / k, seed=0)
    kmeans_s = sync_s(t0)
    init_err = mean_abs_theta_error(psd.theta_mean(g0).cpu().numpy(), theta)
    sizes = np.bincount(g0.argmax(1).cpu().numpy(), minlength=k)
    dominant = np.bincount(theta.argmax(1), minlength=k)
    t0 = time.time()
    exact, sv = exact_subspace(packed_d, n, k - 1)
    exact_s = sync_s(t0)
    del packed_d
    cos_init = principal_cosines(emb.cpu().numpy(), exact)
    log(f"  spectral init alone: PCA passes {pca_s:.3f} s, k-means "
        f"{kmeans_s:.3f} s, init theta_mae={init_err:.5f}, k-means "
        f"cluster sizes {sorted(sizes.tolist())} against the dominant "
        f"populations' {sorted(dominant.tolist())}; top singular "
        f"values {np.round(sv, 1).tolist()} (exact, Gram {exact_s:.2f} s); "
        f"principal cosines init / exact {np.round(cos_init, 4).tolist()}")

    cfg = SVIConfig.from_json((run / "config.json").read_text()).replace(
        init="random", label="random")
    reset_counts()
    res_r = fit(cfg, data, device=dev)
    launched_only(rec, "random-init fit config #3 width",
                  ("fused_local_solve", "gather_row_blocks",
                   "lambda_stats_packed"))
    th_r = psd.theta_mean(res_r.state.gamma).cpu().numpy()
    log(f"  steps: spectral init {res['steps']}, random init {res_r.steps} "
        f"(converged={res_r.converged}, theta_mae="
        f"{mean_abs_theta_error(th_r, theta):.5f}, heldout="
        f"{res_r.heldout_ll:.5f}, chunk_s "
        f"{sum(r['chunk_s'] for r in res_r.trace):.2f})")
    del data, res_r

    reset_counts()
    t0 = time.time()
    run_cli("pca", "--bed", path, "--components", 10, "--seed", 0, "-o",
            tmp / "pcs.txt")
    pca_cli_s = time.time() - t0
    launched_only(rec, "CLI pca", ())
    pcs = load_matrix(tmp / "pcs.txt")
    cos_pca = principal_cosines(pcs[:, :k - 1], emb.cpu().numpy())
    cos_pca_x = principal_cosines(pcs[:, :k - 1], exact)
    log(f"  CLI pca --components 10: {pca_cli_s:.2f} s, shape {pcs.shape}; "
        f"principal cosines of its first {k - 1} columns / the init's "
        f"{np.round(cos_pca, 4).tolist()}, / exact "
        f"{np.round(cos_pca_x, 4).tolist()}")
    if pcs.shape != (n, 10) or min(cos_init.min(), cos_pca.min(),
                                   cos_pca_x.min()) < PCA_SUBSPACE_COS:
        raise AssertionError("pca: the embeddings do not span the top "
                             "principal subspace")


# --------------------------------------------------------------------------
# phase 12: the MCMC validators (mcmc/)

VALIDATE_SHAPE = (500, 5_000, 3)   # config #4: N, L, K
POT_CHAINS = 4
POT_VALUE_TOL = 0.05    # nats of |log p| ~ 3e6: f32 terms give ~2e-3,
POT_GRAD_TOL = 2e-5     # and TF32 operands ~6 nats; of max |grad|: f32
                        # ~1e-7, TF32 ~3e-4 (CPU calibration at this shape)
CONJ_MEAN_TOL = 0.03    # the reference tests' limit on posterior means
# 12c NUTS, 2 chains x 200 draws. Chains that do not move from their
# separate overdispersed starts give an aligned split R-hat of infinity or
# NaN and an ESS near 0. beta mixes well there (ESS 224 and 267, R-hat 1.012
# and 1.008 in two H100 runs): its limits are tight. theta has ESS 8-22
# there (R-hat 1.07 and 1.18): too few draws for a tight limit.
VALIDATE_RHAT_BETA = 1.1
VALIDATE_MIN_ESS_BETA = 50.0
VALIDATE_RHAT_THETA = 1.5
VALIDATE_MIN_ACCEPT = 0.5   # its mean accept probability (0.8 targeted)
VALIDATE_KEYS = {"theta_mae", "beta_mae", "svi_steps", "sampler",
                 "convergence"}     # terastructure_tpu/cli.py:597-605


def tf32(x):
    """x's float32 values rounded to TF32's 10-bit mantissa, as a TF32
    tensor-core product reads its operands; straight through for the
    gradient."""
    i = x.detach().contiguous().view(torch.int32)
    r = ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()


def phase_validate(dev, rec):
    """(a) the potential's precision at config #4's shape; (b) HMC and NUTS
    against the exact conjugate posterior, NUTS re-run bitwise; (c)
    compare_svi_mcmc at the reference's scaled validator shapes (NUTS
    200 x 1,000, SMC 80 x 300, K = 3) with the SVI fit's launches; (d)
    `cli validate`."""
    t0 = time.time()
    validate_precision(dev)
    log(f"  12a in {time.time() - t0:.1f} s")
    t1 = time.time()
    validate_exact(dev)
    log(f"  12b in {time.time() - t1:.1f} s")
    t1 = time.time()
    validate_small(dev, rec)
    log(f"  12c in {time.time() - t1:.1f} s")
    t1 = time.time()
    validate_cli(rec)
    log(f"  12d in {time.time() - t1:.1f} s")
    log(f"  phase 12 in {time.time() - t0:.1f} s")


def validate_precision(dev):
    """12a: PSDPotential's value and gradient on the card (4 chains at
    500 x 5,000, K = 3, float64 sums) against the same potential in
    float64 on the CPU, with TF32 allowed for matmuls meanwhile: the
    potential must not use it. Beside them, the errors of its plain
    formula through a matmul (which TF32 may reach) and with TF32-rounded
    operands, which the tolerances must catch."""
    n, l, k = VALIDATE_SHAPE
    _, _, x = simulate_psd(n, l, k, seed=4)
    rng = np.random.default_rng(4)
    host = {"z_theta": torch.from_numpy((0.5 * rng.standard_normal(
                (POT_CHAINS, n, k))).astype(np.float32)),
            "z_beta": torch.from_numpy((0.8 * rng.standard_normal(
                (POT_CHAINS, l, k))).astype(np.float32))}
    kw = dict(alpha=1.0 / k, scale_sigma=0.05, acc_dtype=torch.float64)
    pot = PSDPotential(x=torch.from_numpy(x).to(dev), **kw)
    pot64 = PSDPotential(x=torch.from_numpy(x), **kw)
    tmpl = {name: v[0].to(dev) for name, v in host.items()}
    target = mcmc_hmc.Target(pot, tmpl)
    q = target.flat({name: v.to(dev) for name, v in host.items()})
    # first in the phase: see PERF.md §7, a capture after the checks below
    one, plain = (leaf_ms(mcmc_hmc.Target(f, tmpl), q) for f in (
        pot, mcmc_hmc.batched(lambda d: pot.plain(d))))
    log(f"  12a leapfrog step (a CUDA graph), {POT_CHAINS} chains: "
        f"{one:.3f} ms with the one-node density, {plain:.3f} ms with "
        f"autograd of its plain formula")
    variants = {
        "matmul": mcmc_hmc.batched(lambda d: pot.plain(
            d, product=lambda t, b: t @ b.mT)),
        "TF32 operands": mcmc_hmc.batched(lambda d: pot.plain(
            d, product=lambda t, b: f32_product(tf32(t), tf32(b)))),
    }
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        lp, g = target.value_and_grad(q)
        other = {name: mcmc_hmc.Target(f, tmpl).value_and_grad(q)
                 for name, f in variants.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    lp64, g64 = mcmc_hmc.Target(
        pot64, {name: v[0].double() for name, v in host.items()}
    ).value_and_grad(q.cpu().double())
    gmax = float(g64.abs().max())

    def errs(a, b):
        return (float((a.cpu() - lp64).abs().max()),
                float((b.cpu().double() - g64).abs().max()) / gmax)

    ev, eg = errs(lp, g)
    log(f"  12a potential at {n} x {l} K={k}, {POT_CHAINS} chains, TF32 "
        f"allowed: |log p - f64| {ev:.3g} nats (limit {POT_VALUE_TOL}; "
        f"log p {float(lp64[0]):.6g}), |grad - f64| / max {eg:.3g} (limit "
        f"{POT_GRAD_TOL})")
    for name, (a, b) in other.items():
        e = errs(a, b)
        log(f"  12a   beside it, the plain formula with {name}: "
            f"{e[0]:.3g} nats, {e[1]:.3g}")
    if ev > POT_VALUE_TOL or eg > POT_GRAD_TOL:
        raise AssertionError("12a: the potential is not float32 on the card")
    e_tf = errs(*other["TF32 operands"])
    if e_tf[0] <= POT_VALUE_TOL or e_tf[1] <= POT_GRAD_TOL:
        raise AssertionError("12a: the limits would not catch TF32")
    if torch.backends.cuda.matmul.allow_tf32 != prev:
        raise AssertionError("12a: the TF32 setting was not restored")


def leaf_ms(target, q, reps=20):
    """Milliseconds of one captured hmc.Leapfrog step of `target` from q
    (CUDA events over `reps` replays, after one)."""
    lp, g = target.value_and_grad(q)
    lf = mcmc_hmc.Leapfrog(target, q, lp)
    lf.load(q, torch.zeros_like(q), g, lp, 1e-4, 1.0, reps + 1)
    lf.step()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        lf.step()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def conjugate_problem(dev, seed=0, n=40, l=6):
    """The reference's K = 1 test problem (tests/test_mcmc.py:18-31): the
    exact posterior of beta_j is Beta(1 + sum_i x_ij, 1 + sum_i (2 - x_ij))."""
    rng = np.random.default_rng(seed)
    beta_true = rng.uniform(0.2, 0.8, size=l)
    x = rng.binomial(2, np.broadcast_to(beta_true, (n, l))).astype(np.int8)
    a = 1.0 + x.sum(0)
    b = 1.0 + (2 - x).sum(0)
    return PSDPotential(x=torch.from_numpy(x).to(dev), alpha=1.0), a / (a + b)


def validate_exact(dev):
    """12b: HMC and NUTS means within CONJ_MEAN_TOL of the exact posterior;
    a short NUTS run (2 chains, 200 x 1,000, K = 3) re-run bitwise."""
    pot, post_mean = conjugate_problem(dev)
    for name, run in (
            ("HMC", lambda: run_hmc(2, pot, init_params(pot, 1, k=1),
                                    n_samples=800, n_warmup=300,
                                    n_leapfrog=16)),
            ("NUTS", lambda: run_nuts(4, pot, init_params(pot, 3, k=1),
                                      n_samples=500, n_warmup=300,
                                      max_depth=6))):
        t = time.time()
        samples, info = run()
        beta = 1.0 / (1.0 + np.exp(-samples["z_beta"][:, :, 0]))
        err = float(np.abs(beta.mean(0) - post_mean).max())
        log(f"  12b {name} on the conjugate posterior: max |mean - exact| "
            f"{err:.4f} (limit {CONJ_MEAN_TOL}), accept "
            f"{info['accept_rate']:.3f}, eps {float(info['eps']):.4g}, "
            f"{time.time() - t:.1f} s")
        if err > CONJ_MEAN_TOL:
            raise AssertionError(f"12b: {name} misses the exact posterior")
    _, _, x = simulate_psd(200, 1000, 3, seed=5)
    pot = PSDPotential(x=torch.from_numpy(x).to(dev), alpha=1 / 3,
                       scale_sigma=0.05, acc_dtype=torch.float64)
    runs = [run_nuts(11, pot, init_params(pot, 12, k=3, n_chains=2),
                     n_samples=10, n_warmup=10, max_depth=5, n_chains=2)
            for _ in range(2)]
    same = all(np.array_equal(runs[0][0][v], runs[1][0][v])
               for v in ("z_theta", "z_beta"))
    log(f"  12b NUTS 2 chains 10 + 10 at 200 x 1,000 K=3, re-run bitwise: "
        f"{same} ({runs[0][1]['leapfrog_sample']} leapfrog steps)")
    if not same:
        raise AssertionError("12b: a NUTS re-run with one seed differs")


def validate_small(dev, rec):
    """12c: compare_svi_mcmc on the card at the reference's scaled
    validator shapes (BASELINE.md:25), the SVI fit through K1 and K4 only,
    no twin. Beside theta MAE against SVI: NUTS's aligned R-hat, beta's
    ESS, the accept rate and sampling steps; SMC's last temperature and
    acceptance."""
    for sampler, (n, l), limit, kw in (
            ("nuts", (200, 1000), 0.05,
             dict(n_samples=200, n_warmup=200, n_chains=2)),
            ("smc", (80, 300), 0.08,
             dict(n_particles=256, n_mutations=2, n_leapfrog=8,
                  mutation_eps=0.1))):
        _, _, x = simulate_psd(n, l, 3, seed=0, structured=True)
        reset_counts()
        rep = compare_svi_mcmc(x, 3, sampler=sampler, seed=0, device=dev,
                               **kw)
        launched_only(rec, f"validate {sampler} {n} x {l}",
                      ("fused_local_solve", "lambda_stats_packed"))
        d = rep.sampler_diag
        more = (f"{d['n_stages']} stages" if sampler == "smc" else
                f"leapfrog {d['leapfrog_warmup']} + {d['leapfrog_sample']}, "
                f"warmup {d['warmup_s']:.1f} s, sampling "
                f"{d['sample_s']:.1f} s, {d['convergence']}")
        log(f"  12c {sampler} {n} x {l} K=3: theta MAE {rep.theta_mae:.4f} "
            f"(limit {limit}), beta MAE {rep.beta_mae:.4f}, SVI "
            f"{rep.svi_steps} steps {rep.svi_s:.1f} s, sampler "
            f"{rep.sampler_s:.1f} s; {more}")
        if not rep.theta_mae < limit:
            raise AssertionError(f"12c: {sampler} theta MAE {rep.theta_mae}")
        if sampler == "smc":
            if not (d["temps"][-1] >= 1.0 - 1e-9
                    and min(d["acceptance"]) > 0.0):
                raise AssertionError(
                    f"12c: SMC ended at temperature {d['temps'][-1]} with "
                    f"acceptance {min(d['acceptance'])}")
            continue
        th, be = d["convergence"]["theta"], d["convergence"]["beta"]
        log(f"  12c nuts: aligned R-hat theta {th['max_rhat']:.4f} (limit "
            f"{VALIDATE_RHAT_THETA}), beta {be['max_rhat']:.4f} (limit "
            f"{VALIDATE_RHAT_BETA}); min ESS beta {be['min_ess']:.1f} "
            f"(limit {VALIDATE_MIN_ESS_BETA}); accept "
            f"{d['accept_rate']:.3f} (limit {VALIDATE_MIN_ACCEPT})")
        if not (th["max_rhat"] < VALIDATE_RHAT_THETA
                and be["max_rhat"] < VALIDATE_RHAT_BETA
                and be["min_ess"] > VALIDATE_MIN_ESS_BETA
                and d["accept_rate"] > VALIDATE_MIN_ACCEPT
                and d["leapfrog_sample"] > 0):
            raise AssertionError(
                f"12c: NUTS R-hat theta {th['max_rhat']} beta "
                f"{be['max_rhat']}, ESS beta {be['min_ess']}, accept "
                f"{d['accept_rate']}, {d['leapfrog_sample']} leapfrog "
                f"steps in sampling")


def validate_cli(rec):
    """12d: `cli validate --simulate` prints the reference's keys."""
    import io

    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        run_cli("validate", "--simulate", "-n", 64, "-l", 256, "-k", 2,
                "--n-samples", 50, "--n-warmup", 50, "--chains", 2)
    launched_only(rec, "CLI validate", ("fused_local_solve",
                                        "lambda_stats_packed"))
    line = out.getvalue().strip().splitlines()[-1]
    log(f"  12d CLI validate: {line}")
    got = json.loads(line)
    if set(got) != VALIDATE_KEYS or set(got["convergence"]) != {
            "theta", "beta"}:
        raise AssertionError(f"12d: keys {sorted(got)}")


SHARDED_TOL = 2e-4    # a reduced statistic vs one device's, of its max |.|
RANKS_TIMEOUT = 600   # seconds for phase 13's four ranks, spawn to exit


def phase_sharded(dev, rec, tgp_data, bign):
    """Phase 13: the multi-card fit (parallel/) on the one card. 13a: one
    rank over NCCL; 13b and 13c: four ranks sharing the card over gloo."""
    t0 = time.time()
    phase_sharded_nccl(dev, rec, tgp_data)
    log(f"  phase 13a in {time.time() - t0:.1f} s")
    n, l, k = TGP
    cfg_b = SVIConfig(n=n, l=l, k=k, batch_size=1024, seed=0, local_tol=0.0,
                      snp_shards=4)
    big = bign["cfg"]                  # phase 4's: B = 4,096
    cfg_c = SVIConfig(n=big.n, l=big.l, k=big.k, batch_size=big.batch_size,
                      seed=0, kernel="pallas", local_sub_n=0, local_tol=0.0,
                      ind_shards=2, snp_shards=2)
    # the block gather (K3) where L_local reaches dma_gather_min_l, as
    # config #5 over 8 SNP ranks (L_local 125,000) takes it by default
    cfg_k3 = cfg_c.replace(dma_gather_min_l=big.l // 2)
    cfg_fit = cfg_k3.replace(kernel="auto", local_sub_n=big.local_sub_n,
                             local_tol=big.local_tol)
    rng = np.random.default_rng(13)
    idx_b = rng.integers(0, l // 4, size=1024).astype(np.int32)
    idx_c = rng.integers(0, big.l // 2, size=big.batch_size).astype(np.int32)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        paths = (f"{tmp}/tgp.npy", f"{tmp}/bign.npy")
        np.save(paths[0], tgp_data.packed)
        np.save(paths[1], bign["data"].packed)
        want_b = single_stat(dev, cfg_b, tgp_data.packed, idx_b, 4)
        want_c = single_stat(dev, cfg_c, bign["data"].packed, idx_c, 2)
        want_pair = single_stat(dev, cfg_c.replace(stats_kernel="pair"),
                                bign["data"].packed, idx_c, 2)
        tr = time.time()
        outs = run_ranks(4, rank_phase13, (paths, cfg_b, idx_b, cfg_c, idx_c,
                                           cfg_k3, cfg_fit),
                         timeout=RANKS_TIMEOUT, device=torch.device("cuda", 0))
        log(f"  phase 13b-c: four ranks in {time.time() - tr:.1f} s "
            "(spawn, block reads, steps; ranks share the card: no speed "
            "figure)")
        # the rows K3's blocks drew on SNP shards 0 and 1 (ranks 0 and 1)
        idx_k3 = torch.cat([outs[0]["k3"]["idx"], outs[1]["k3"]["idx"]])
        want_k3 = single_stat(dev, cfg_k3, bign["data"].packed,
                              idx_k3.numpy(), 2)
    for o in outs:
        r = o["rank"]
        rank_counts(rec, f"13b rank {r}", o["b"]["counts"],
                    ("fused_local_solve",))
        rank_counts(rec, f"13c step rank {r}", o["c"]["counts"],
                    ("lambda_stats_packed", "batch_stats_fused_v2_packed"),
                    absent=("gamma_stats_packed", "gather_row_blocks"))
        rank_counts(rec, f"13c pair step rank {r}", o["pair"]["counts"],
                    ("lambda_stats_packed", "gamma_stats_packed"),
                    absent=("batch_stats_fused_v2_packed",))
        rank_counts(rec, f"13c K3 step rank {r}", o["k3"]["counts"],
                    ("gather_row_blocks", "lambda_stats_packed",
                     "batch_stats_fused_v2_packed"))
        rank_counts(rec, f"13c 200 steps + compute-beta rank {r}",
                    o["fit"]["counts"], ("gather_row_blocks",
                                         "lambda_stats_acat",
                                         "batch_stats_fused_v2_packed",
                                         "lambda_stats_packed"))
        rank_counts(rec, f"13c 200 streamed steps rank {r}",
                    o["fit"]["stream_counts"],
                    ("lambda_stats_acat", "batch_stats_fused_v2_packed"),
                    absent=("gather_row_blocks",))
        if not o["k3"]["gathered_bitwise"]:
            raise AssertionError(f"13c rank {r}: K3's 8-row blocks differ "
                                 "from indexing the block on their rows")
        if not o["fit"]["rerun_bitwise"] or not o["fit"]["finite"]:
            raise AssertionError(f"13c rank {r}: the 200 steps re-run "
                                 "differ or are not finite")
        if not o["fit"]["stream_bitwise"]:
            raise AssertionError(f"13c rank {r}: the streamed 200 steps "
                                 "differ from the resident ones")
    for a in outs[1:]:
        if not torch.equal(a["b"]["gamma"], outs[0]["b"]["gamma"]):
            raise AssertionError("13b: gamma differs between the ranks of "
                                 "the snp group")
    log("  13b: gamma bitwise equal on the four ranks")
    hold_sharded("13b (1, 4) reduced gamma statistic vs one K1 step",
                 outs[0]["b"]["gstat"][:n], want_b)
    by_i = {}
    for o in outs:
        g = o["c"]["gstat"]
        if o["i"] in by_i and not torch.equal(by_i[o["i"]], g):
            raise AssertionError("13c: the snp group's statistics differ")
        by_i[o["i"]] = g
    hold_sharded("13c (2, 2) reduced gamma statistic vs step_core_packed",
                 torch.cat([by_i[0], by_i[1]])[:big.n], want_c)
    for key, want, label in (
            ("pair", want_pair, "stats_kernel='pair' (K4 + K5)"),
            ("k3", want_k3, "K3's block gather")):
        hold_sharded(f"13c (2, 2) {label} reduced gamma statistic vs "
                     "step_core_packed", torch.cat(
                         [outs[0][key]["gstat"], outs[2][key]["gstat"]])[
                             :big.n], want)
    log(f"  13c: 200 steps on every rank in "
        f"{max(o['fit']['steps_s'] for o in outs):.2f} s, streamed in "
        f"{max(o['fit']['stream_s'] for o in outs):.2f} s, compute-beta of "
        f"50,000 rows a rank in "
        f"{max(o['fit']['export_s'] for o in outs):.2f} s (four ranks "
        "sharing the card, gloo through the host: no speed figure); re-run "
        "and stream bitwise")


def phase_sharded_nccl(dev, rec, data):
    """13a: one rank over NCCL (world size 1): an NCCL all-reduce, then
    fit_sharded at config #3's width for 200 steps (K1, and K4 in the
    eval and the export), re-run bitwise."""
    import torch.distributed as dist

    n, l, k = TGP
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=1024, rfreq=100,
                    max_steps=200, seed=0, snp_shards=1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        rank_dev = multihost.initialize(f"file://{tmp}/store", 1, 0)
        try:
            x = torch.full((4,), 3.0, device=rank_dev)
            dist.all_reduce(x)
            if dist.get_backend() != "nccl" or not bool((x == 3.0).all()):
                raise AssertionError("13a: the NCCL all-reduce failed")
            mesh = meshlib.make_mesh(meshlib.MeshSpec(1, 1))
            reset_counts()
            res = fit_sharded(cfg, data, mesh=mesh)
            read_counts(rec, "13a fit_sharded (NCCL, one rank)",
                        ("fused_local_solve", "lambda_stats_packed"),
                        absent=("fused_local_solve_dma",))
            again = fit_sharded(cfg, data, mesh=mesh)
        finally:
            dist.destroy_process_group()
    if not (torch.equal(res.state.gamma, again.state.gamma)
            and [r.get("validation_ll") for r in res.trace]
            == [r.get("validation_ll") for r in again.trace]):
        raise AssertionError("13a: a same-seed re-run is not bitwise equal")
    log(f"  13a: backend nccl on {rank_dev}, steps={res.steps} "
        f"validation_ll={res.validation_ll:.5f} "
        f"heldout={res.heldout_ll:.5f}; re-run bitwise")
    if not np.isfinite(res.heldout_ll):
        raise AssertionError("13a: heldout is not finite")


def single_stat(dev, cfg, packed, idx, snp):
    """The single-device gamma statistic (N, K) of one step on the rows
    the sharded step draws (idx: SNP shard s's local rows at [s B_l,
    (s + 1) B_l)), from engine.init_state's gamma: K1 where the fused
    gate passes (13b), else the big-N step_core_packed (13c)."""
    l_local = cfg.l // snp
    b_local = cfg.batch_size // snp
    rows_g = np.repeat(np.arange(snp), b_local) * l_local + idx
    rows = engine.resident_packed(packed[rows_g], dev)
    gamma = engine.init_state(cfg, device=dev).gamma
    reset_counts()
    if engine.step_impl(cfg, rows.shape[1]) == "fused":
        _, g = engine.step_core_fused(cfg, gamma, rows)
    else:
        _, g = engine.step_core_packed(cfg, gamma, rows)
    return g.cpu()


def hold_sharded(label, got, want):
    """got within SHARDED_TOL of want's largest magnitude, everywhere."""
    scale = float(want.abs().max())
    compare(label, [got], [want], (SHARDED_TOL, SHARDED_TOL * scale))


def rank_counts(rec, path, counts, expect, absent=()):
    """A rank's launches (counts: name -> (launches, twin calls)) added to
    rec; fails where a kernel of `expect` did not launch, one of `absent`
    did, or a twin ran."""
    log(f"  {path} launches: "
        f"{ {name: c[0] for name, c in counts.items() if c[0]} }")
    for name, (launches, twins) in counts.items():
        rec[name]["launches"] = rec[name].get("launches", 0) + launches
        if twins:
            raise AssertionError(f"{path}: {name} ran its twin")
    for name in expect:
        if counts[name][0] <= 0:
            raise AssertionError(f"{path}: {name} never launched")
    for name in absent:
        if counts[name][0]:
            raise AssertionError(f"{path}: {name} launched "
                                 f"{counts[name][0]}x")


def _rank_counts():
    return {name: (getattr(spec["fn"], spec.get("counter", "launches")),
                   spec["fn"].twin_calls) for name, spec in KERNELS.items()}


def rank_phase13(paths, cfg_b, idx_b, cfg_c, idx_c, cfg_k3, cfg_fit):
    """What each of phase 13's four ranks runs (spawned; the group is
    joined): 13b at (1, 4); at (2, 2) 13c's step with stats_kernel
    fused_v2 and pair, a step on the rows K3 gathers, and the 200 steps
    resident and streamed."""
    t0 = time.time()
    mesh14 = meshlib.make_mesh(meshlib.MeshSpec(1, 4))
    out = dict(rank=mesh14.rank, b=_rank_step(mesh14, cfg_b, paths[0],
                                              idx_b))
    log(f"  rank {mesh14.rank}: 13b done at {time.time() - t0:.1f} s")
    mesh22 = meshlib.make_mesh(meshlib.MeshSpec(2, 2))
    out.update(i=mesh22.i, s=mesh22.s,
               c=_rank_step(mesh22, cfg_c, paths[1], idx_c),
               pair=_rank_step(mesh22, cfg_c.replace(stats_kernel="pair"),
                               paths[1], idx_c),
               k3=_rank_step(mesh22, cfg_k3, paths[1]))
    log(f"  rank {mesh14.rank}: 13c steps done at {time.time() - t0:.1f} s")
    out["fit"] = _rank_fit(mesh22, cfg_fit, paths[1])
    log(f"  rank {mesh14.rank}: 13c fits done at {time.time() - t0:.1f} s")
    return out


def _rank_block(mesh, cfg, path):
    data = GenotypeData(n=cfg.n, l=cfg.l, packed=np.load(path, mmap_mode="r"))
    return sharded.prepare(cfg, data, mesh)


def _rank_step(mesh, cfg, path, idx=None):
    """One sharded step on the rows idx draws for this rank's SNP shard,
    or with idx None on the rows step 0 draws and gathers (sample_gather:
    K3's 8-row blocks where the plan takes them, held bitwise against
    indexing the block on those rows): its reduced gamma statistic, its
    gamma, its rows' local indices, its launches."""
    plan, packed_l = _rank_block(mesh, cfg, path)
    st = sharded.init_sharded_state(cfg, plan, mesh)
    sample_gather, stats, apply_gamma, psum = sharded._build_step_parts(
        cfg, plan, mesh)
    reset_counts()
    gathered = None
    if idx is None:
        rows, idx_l = sample_gather(packed_l, 0, cfg.seed)
        gathered = torch.equal(rows, packed_l[idx_l.long()])
    else:
        b = plan.batch_per_shard
        idx_l = torch.from_numpy(idx[mesh.s * b:(mesh.s + 1) * b]).to(
            mesh.device)
        rows = packed_l[idx_l.long()]
    _, g = stats(st.gamma, st.lamb, rows, idx_l, 0, cfg.seed)
    g = psum(g)()
    gamma = apply_gamma(st.gamma, g, 0)
    return dict(gstat=g.cpu(), gamma=gamma.cpu(), idx=idx_l.cpu(),
                gathered_bitwise=gathered, counts=_rank_counts())


def _rank_fit(mesh, cfg, path):
    """200 sharded steps (two chunks of 100) from the init, the sharded
    compute-beta of this rank's rows, the 200 steps again, and the 200
    steps streamed from this rank's block on the host (parallel/stream.py,
    as multihost.load_bed_shard leaves it: the real rows and byte columns
    with their offsets)."""
    plan, packed_l = _rank_block(mesh, cfg, path)
    chunk = sharded.make_sharded_run_chunk(cfg, plan, mesh, 100)

    def steps():
        st = sharded.init_sharded_state(cfg, plan, mesh)
        return chunk(chunk(st, packed_l), packed_l)

    reset_counts()
    t0 = time.time()
    st = steps()
    float(st.gamma[0, 0])                  # waits for the steps
    steps_s = time.time() - t0
    t0 = time.time()
    lamb = sharded.make_sharded_compute_lambda(cfg, plan, mesh)(st.gamma,
                                                                packed_l)
    float(lamb[0, 0, 0])
    export_s = time.time() - t0
    counts = _rank_counts()
    again = steps()
    (r0, r1), (c0, c1) = sharded.block_bounds(plan, mesh)
    host = np.ascontiguousarray(np.load(path, mmap_mode="r")[
        r0:min(r1, cfg.l), c0:min(c1, packed_width(cfg.n))])
    run = pstream.make_sharded_stream_chunk(cfg, plan, mesh, 100,
                                            byte_col_offset=c0,
                                            snp_row_offset=r0)
    reset_counts()
    t0 = time.time()
    streamed = run(run(sharded.init_sharded_state(cfg, plan, mesh), host),
                   host)
    float(streamed.gamma[0, 0])
    stream_s = time.time() - t0
    return dict(counts=counts, steps_s=steps_s, export_s=export_s,
                stream_counts=_rank_counts(), stream_s=stream_s,
                rerun_bitwise=torch.equal(st.gamma, again.gamma),
                stream_bitwise=torch.equal(st.gamma, streamed.gamma),
                finite=bool(torch.isfinite(st.gamma).all()
                            and torch.isfinite(lamb).all()))


# Phase 15: the rest of the multi-card slice on the one card.
CHAINS_RANKS = 4
CHAINS_MOMENT_TOL = 0.02   # mean |E[theta]| of the sharded vs one-rank run
CHAINS_RUNS = (            # sampler, (N, L), theta MAE limit, its kwargs
    ("nuts", (200, 1000), 0.05, dict(n_samples=30, n_warmup=30,
                                     n_chains=4)),
    ("smc", (80, 300), 0.08, dict(n_particles=64, n_mutations=2,
                                  n_leapfrog=8, mutation_eps=0.1)))
BIOBANK = (1_000_448, 32_768, 10)   # N, L, K of the demo's resident fit
BIOBANK_CHUNK = 64                  # SNPs a simulated chunk (divides L)
BIOBANK_STEPS = 300


def phase_chains(dev, rec):
    """Phase 15 (see the module's docstring): 15a chains and particles
    over ranks, 15b the dry run, 15c the resident biobank fit."""
    t0 = time.time()
    chains_over_ranks(dev, rec)
    log(f"  15a in {time.time() - t0:.1f} s")
    t1 = time.time()
    rep = dryrun.dryrun(CHAINS_RANKS, dev.type, timeout=RANKS_TIMEOUT)
    # the dry run's K1..K8 under this script's names (its passes run the
    # f32 bodies)
    name_of = {k: next(name for name, spec in KERNELS.items()
                       if spec["fn"] is f and "counter" not in spec)
               for k, f in dryrun.KERNELS.items()}
    for p in rep["passes"]:
        counts = {name: (0, 0) for name in KERNELS}
        counts.update({name_of[k]: tuple(c) for k, c in p["counts"].items()})
        rank_counts(rec, f"15b dry run pass {p['name']} ({p['branch']}, "
                    f"grid {p['grid']}, lead)", counts,
                    [name_of[k] for k in dryrun.BRANCHES[p["branch"]]])
        log(f"  15b {p['name']}: gamma finite > 0 {p['gamma_ok']}, "
            f"log-likelihood {p['loglik']:.6f}, {p['steps']} steps")
    if rep["failures"]:
        raise AssertionError(f"15b: {rep['failures']}")
    log(f"  15b in {time.time() - t1:.1f} s (four ranks sharing the card)")
    t1 = time.time()
    resident_biobank(dev, rec)
    log(f"  15c in {time.time() - t1:.1f} s")


def rank_validate(sampler, shape, kw):
    """What each of 15a's ranks runs: compare_svi_mcmc twice on the same
    matrix (the lead's SVI broadcast, the chains split); the posterior
    means, the generator calls and the lead's launches of each run."""
    n, l = shape
    _, _, x = simulate_psd(n, l, 3, seed=0, structured=True)
    out = []
    for _ in range(2):
        reset_counts()
        t0 = time.time()
        rep = compare_svi_mcmc(x, 3, sampler=sampler, seed=0,
                               device=multihost.device(), **kw)
        out.append(dict(theta=rep.theta_mcmc, beta=rep.beta_mcmc,
                        theta_mae=rep.theta_mae, svi_steps=rep.svi_steps,
                        draws=rep.sampler_diag["draws"],
                        sampler_s=rep.sampler_s, s=time.time() - t0,
                        counts=_rank_counts()))
    return out


def chains_over_ranks(dev, rec):
    """15a (see the module's docstring)."""
    one = {}
    for sampler, shape, limit, kw in CHAINS_RUNS:
        _, _, x = simulate_psd(*shape, 3, seed=0, structured=True)
        reset_counts()
        t0 = time.time()
        rep = compare_svi_mcmc(x, 3, sampler=sampler, seed=0, device=dev,
                               **kw)
        one[sampler] = (rep, x)
        log(f"  15a {sampler} one rank: theta MAE {rep.theta_mae:.4f}, "
            f"{rep.sampler_s:.1f} s of sampler, "
            f"{rep.sampler_diag['draws']} generator calls")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chains_") as tmp, \
            RankPool(CHAINS_RANKS, tmp, device=dev,
                     timeout=RANKS_TIMEOUT, threads=2) as pool:
        for sampler, shape, limit, kw in CHAINS_RUNS:
            outs = pool.run(rank_validate, sampler, shape, kw)
            rep1 = one[sampler][0]
            first = outs[0][0]
            for r, runs in enumerate(outs):
                a, b = runs
                if not (np.array_equal(a["theta"], b["theta"])
                        and np.array_equal(a["beta"], b["beta"])):
                    raise AssertionError(f"15a {sampler}: rank {r}'s re-run "
                                         "is not bitwise its first run")
                if not (np.array_equal(a["theta"], first["theta"])
                        and a["draws"] == first["draws"] > 0):
                    raise AssertionError(
                        f"15a {sampler}: rank {r} differs from the lead "
                        f"(generator calls {a['draws']} vs "
                        f"{first['draws']})")
            for i, run in enumerate(outs[0]):
                rank_counts(rec, f"15a {sampler} run {i + 1} lead",
                            run["counts"], ("fused_local_solve",
                                            "lambda_stats_packed"))
            gap = float(np.abs(first["theta"] - rep1.theta_mcmc).mean())
            bitwise = bool(np.array_equal(first["theta"], rep1.theta_mcmc))
            log(f"  15a {sampler} over {CHAINS_RANKS} ranks: theta MAE "
                f"{first['theta_mae']:.4f} (limit {limit}), mean |E[theta] "
                f"- one rank's| {gap:.2e} (limit {CHAINS_MOMENT_TOL}; "
                f"bitwise {bitwise}), generator calls {first['draws']} on "
                f"every rank (one rank {rep1.sampler_diag['draws']}), "
                f"re-run bitwise; runs {first['s']:.1f} / "
                f"{outs[0][1]['s']:.1f} s (ranks share the card: no speed "
                "figure)")
            if not (first["theta_mae"] < limit and gap < CHAINS_MOMENT_TOL
                    and first["svi_steps"] == rep1.svi_steps):
                raise AssertionError(f"15a {sampler}: theta MAE "
                                     f"{first['theta_mae']}, gap {gap}")
    nccl_smc(dev, rec, *one["smc"])


def nccl_smc(dev, rec, rep1, x):
    """15a's one-rank SMC again inside a process group of one NCCL rank:
    bitwise the run without a group."""
    import torch.distributed as dist

    sampler, shape, limit, kw = CHAINS_RUNS[1]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as tmp:
        multihost.initialize(f"file://{tmp}/store", 1, 0)
        try:
            if dist.get_backend() != "nccl":
                raise AssertionError("15a: the group is not NCCL")
            reset_counts()
            rep = compare_svi_mcmc(x, 3, sampler=sampler, seed=0,
                                   device=dev, **kw)
            launched_only(rec, "15a SMC in an NCCL group of one rank",
                          ("fused_local_solve", "lambda_stats_packed"))
        finally:
            dist.destroy_process_group()
    if not np.array_equal(rep.theta_mcmc, rep1.theta_mcmc):
        raise AssertionError("15a: SMC in an NCCL group of one differs from "
                             "the run without a group")
    log("  15a: SMC in an NCCL group of one rank bitwise the run without "
        "a group")


def resident_biobank(dev, rec):
    """15c (see the module's docstring)."""
    from terastructure_tpu_torch.data.dataset import carve_eval_device
    from terastructure_tpu_torch.data.simulate import (
        simulate_packed_device_resident)
    from terastructure_tpu_torch.svi import driver

    small = simulate_packed_device(4096, 256, 10, seed=3, chunk=64,
                                   missing_frac=0.01, device=dev)[0]
    small_d = simulate_packed_device_resident(4096, 256, 10, seed=3,
                                              chunk=64, missing_frac=0.01,
                                              device=dev)[0]
    if not np.array_equal(small_d.cpu().numpy(), small):
        raise AssertionError("15c: the resident simulator differs from "
                             "simulate_packed_device")
    n, l, k = BIOBANK
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    packed, theta = simulate_packed_device_resident(
        n, l, k, seed=0, chunk=BIOBANK_CHUNK, device=dev)
    sim_s = sync_s(t0)
    t0 = time.time()
    packed, val, held, pool, rows = carve_eval_device(
        packed, n, validation_frac=0.005, heldout_frac=0.005, seed=0,
        max_eval_entries=200_000, eval_snp_pool=2048)
    carve_s = sync_s(t0)
    data = GenotypeData(n=n, l=l, packed=packed, validation=val,
                        heldout=held, eval_row_snps=pool,
                        eval_rows_full=rows)
    uniq = np.unique(val.snp_idx)
    if not (packed.device == rows.device == driver.eval_rows(
            data, uniq).device == dev):
        raise AssertionError("15c: the matrix or its eval rows left the "
                             "card")
    log(f"  15c: {n:,} x {l:,} K={k} simulated on the card in {sim_s:.2f} s "
        f"({packed.numel() / 1e9:.2f} GB packed), carved in {carve_s:.2f} s "
        f"({len(val):,} + {len(held):,} entries over {len(pool)} SNPs)")
    # the demo's settings (benchmarks/biobank_demo.py:224-228)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=min(4096, l // 2),
                    rfreq=BIOBANK_STEPS // 3, max_steps=BIOBANK_STEPS,
                    seed=0, kernel="pallas", lambda_mode="local",
                    stats_approx_div=True, dma_gather_min_l=16_384)
    res, summary = bign_fit(
        dev, rec, cfg, data, theta,
        ("gather_row_blocks", "lambda_stats_acat",
         "batch_stats_fused_v2_packed", "lambda_stats_packed"),
        ("fused_local_solve", "fused_local_solve_dma"))
    beta = simulated_beta(n, l, k, seed=0, chunk=BIOBANK_CHUNK)
    oracle = oracle_ll(theta, beta, held)
    lls = [r["validation_ll"] for r in res.trace]
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else 0.0
    log(f"  15c: {res.steps} steps, {summary['step_ms']:.3f} ms a step, fit "
        f"wall {res.wall_s:.2f} s (export {res.timings['export_s']} s); "
        f"validation ll by check {lls}, heldout {res.heldout_ll:.5f} "
        f"(oracle {oracle:.5f}); peak device memory {peak:.2f} GB")
    if not lls[-1] > lls[0]:
        raise AssertionError(f"15c: the validation ll did not rise: {lls}")
    del data, packed, rows


def digests(dev):
    """sha256 of each kernel's outputs on seeded inputs, through the
    wrappers only, so that another tree's package can run it: two trees
    whose kernels give the same bits print the same digests."""
    import hashlib

    def h(*ts):
        d = hashlib.sha256()
        for t in ts:
            d.update(t.contiguous().cpu().numpy().tobytes())
        return d.hexdigest()[:16]

    out = {}
    for b, w, k in ((4096, 640, 8), (1000, 235, 7), (72, 640, 33)):
        rows, up, lamb = _solve_inputs(b, w, k, b + w + k, dev)
        t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
        a1, a0 = stats_packed.decode_count_planes(rows)
        shape = f"B={b} W={w} K={k}"
        for approx in (False, True):
            out[f"K1 {shape} accel approx={approx}"] = h(
                *fused_step.fused_local_solve(
                    rows, up, lamb, local_iters=7, local_tol=1e-4,
                    beta_a=1.0, beta_b=1.0, accel=True, approx_div=approx))
            out[f"K4 {shape} approx={approx}"] = h(
                *stats_packed.lambda_stats_packed(rows, up, t1, t0,
                                                  approx_div=approx))
            out[f"K8 {shape} approx={approx}"] = h(
                *stats_packed.lambda_stats_acat(a1, a0, up, t1, t0,
                                                approx_div=approx))
    packed, up, lamb = _solve_inputs(4096, 640, 8, 5, dev)
    idx0 = torch.arange(0, 4096, 32, dtype=torch.int32, device=dev)
    out["K2 B=1024 W=640 K=8 g=8"] = h(*fused_step.fused_local_solve_dma(
        idx0, packed, up, lamb[:1024].contiguous(), group=8, local_iters=7,
        local_tol=1e-4, beta_a=1.0, beta_b=1.0, accel=True))
    out["K3 L=4096 W=640 G=128"] = h(gather.gather_row_blocks(
        packed, idx0 // 8))
    for b, w, k in ((1024, 2048, 10), (40, 300, 33)):
        rows, up, u, t1, t0 = _stats_inputs(b, w, k, b + w, dev)
        shape = f"B={b} W={w} K={k}"
        out[f"K5 {shape}"] = h(stats_packed.gamma_stats_packed(
            rows, up, t1, t0))
        out[f"K6 {shape}"] = h(*stats_packed.batch_stats_fused_packed(
            rows, u, t1, t0))
        for approx in (False, True):
            out[f"K7 {shape} approx={approx}"] = h(
                *stats_packed.batch_stats_fused_v2_packed(
                    rows, u, t1, t0, approx_div=approx))
    # K > 64: every K > 64 body
    b, w, k = 40, 256, 72
    packed, up, lamb = _solve_inputs(1024, w, k, 72, dev)
    idx0 = torch.arange(0, 1024, 8 * 5, dtype=torch.int32, device=dev)[:b // 8]
    rows = packed[(idx0.long()[:, None]
                   + torch.arange(8, device=dev)).reshape(b)]
    lamb = lamb[:b].contiguous()
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    a1, a0 = stats_packed.decode_count_planes(rows)
    u = stats_packed.planes_to_flat(up).contiguous()
    shape = f"B={b} W={w} K={k}"
    kw = dict(local_iters=7, local_tol=1e-4, beta_a=1.0, beta_b=1.0,
              accel=True)
    out[f"K1 {shape}"] = h(*fused_step.fused_local_solve(rows, up, lamb, **kw))
    out[f"K2 {shape} g=8"] = h(*fused_step.fused_local_solve_dma(
        idx0, packed, up, lamb, group=8, **kw))
    out[f"K4 {shape}"] = h(*stats_packed.lambda_stats_packed(rows, up, t1, t0))
    out[f"K8 {shape}"] = h(*stats_packed.lambda_stats_acat(a1, a0, up, t1, t0))
    out[f"K5 {shape}"] = h(stats_packed.gamma_stats_packed(rows, up, t1, t0))
    out[f"K6 {shape}"] = h(*stats_packed.batch_stats_fused_packed(
        rows, u, t1, t0))
    out[f"K7 {shape}"] = h(*stats_packed.batch_stats_fused_v2_packed(
        rows, u, t1, t0))
    if hasattr(fused_step.fused_local_solve, "bf16_launches"):
        # the bf16 bodies (trees that have them), K <= 64 and K = 72
        for b, w, k in ((4096, 640, 8), (1000, 235, 7), (72, 640, 33),
                        (40, 256, 72)):
            rows, up, lamb = _solve_inputs(b, w, k, b + w + k, dev)
            t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
            shape = f"B={b} W={w} K={k}"
            for approx in (False, True):
                out[f"K1[bf16] {shape} accel approx={approx}"] = h(
                    *fused_step.fused_local_solve(
                        rows, up, lamb, local_iters=7, local_tol=1e-4,
                        beta_a=1.0, beta_b=1.0, accel=True,
                        approx_div=approx, dtype=BF16))
                out[f"K4[bf16] {shape} approx={approx}"] = h(
                    *stats_packed.lambda_stats_packed(
                        rows, up, t1, t0, approx_div=approx, dtype=BF16))
            out[f"K5[bf16] {shape}"] = h(stats_packed.gamma_stats_packed(
                rows, up, t1, t0, dtype=BF16))
    if hasattr(stats_packed.lambda_stats_acat, "bf16_launches"):
        # the big-N step's bf16 bodies (trees that have them), K <= 64 and
        # K = 72 (K5[bf16] at K = 72 is the block above's)
        for b, w, k in ((1024, 2048, 10), (40, 300, 33), (40, 256, 72)):
            rows, up, u, t1, t0 = _stats_inputs(b, w, k, b + w, dev)
            a1, a0 = stats_packed.decode_count_planes(rows)
            shape = f"B={b} W={w} K={k}"
            if k <= 64:
                out[f"K5[bf16] {shape}"] = h(stats_packed.gamma_stats_packed(
                    rows, up, t1, t0, dtype=BF16))
            out[f"K6[bf16] {shape}"] = h(
                *stats_packed.batch_stats_fused_packed(rows, u, t1, t0,
                                                       dtype=BF16))
            for approx in (False, True):
                out[f"K7[bf16] {shape} approx={approx}"] = h(
                    *stats_packed.batch_stats_fused_v2_packed(
                        rows, u, t1, t0, approx_div=approx, dtype=BF16))
                out[f"K8[bf16] {shape} approx={approx}"] = h(
                    *stats_packed.lambda_stats_acat(
                        a1, a0, up, t1, t0, approx_div=approx, dtype=BF16))
    return out


def wrapper_eager_ms(dev):
    """Eager ms a call of the K3 and K4 wrappers (1,000 launches each, the
    host's call included) at the TGP and eval shapes: the host path, which
    --digest times in whichever tree's package is imported."""
    g = torch.Generator(device=dev).manual_seed(3)
    src = torch.randint(0, 256, (1_000_000, 640), generator=g, device=dev,
                        dtype=torch.uint8)
    starts = torch.randint(0, 1_000_000 // 8, (512,), generator=g,
                           device=dev, dtype=torch.int32)
    rows, up, lamb = _solve_inputs(1024, 640, 8, 4, dev)
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)

    def host_us(fn, n=20_000):
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t) / n * 1e6

    return {"K3 L=1M G=512 W=640": time_ms(
                lambda: gather.gather_row_blocks(src, starts), 1000),
            "K4 B=1024 W=640 K=8": time_ms(
                lambda: stats_packed.lambda_stats_packed(rows, up, t1, t0),
                1000),
            # host microseconds of a call of what a wrapper used to ask
            # every launch (the capability, the stream as a Stream object)
            # and of what it asks now (the raw stream)
            "get_device_capability_us": host_us(
                lambda: torch.cuda.get_device_capability(dev)),
            "current_stream_us": host_us(
                lambda: torch.cuda.current_stream(dev).cuda_stream),
            "stream_ptr_us": host_us(lambda: _build.stream_ptr(dev))}


def bign_bf16_ms(dev):
    """Device ms a call of K7 at bf16 (K = 8, 10, 16) and of K8 at bf16
    (the subsampled solve's fast divide) at the big-N shapes, CUDA events
    over 10 and 50 calls after a warm-up, through the wrappers only:
    --digest prints them in whichever tree's package is imported, so that
    two trees' bodies are timed in turns by one script."""
    b, w, _ = BIGN
    out = {}
    for k in (8, 10, 16):
        rows, up, u, t1, t0 = _stats_inputs(b, w, k, b + w + k, dev)
        out[f"K7[bf16] B={b} W={w} K={k}"] = time_ms(
            lambda: stats_packed.batch_stats_fused_v2_packed(
                rows, u, t1, t0, dtype=BF16), 10)
        del rows, up, u, t1, t0
    rows, up, _, t1, t0 = _stats_inputs(b, BIGN_SUB_W, BIGN[2], 7, dev)
    a1, a0 = stats_packed.decode_count_planes(rows)
    out[f"K8[bf16] B={b} (4, {BIGN_SUB_W}) K={BIGN[2]} approx"] = time_ms(
        lambda: stats_packed.lambda_stats_acat(a1, a0, up, t1, t0,
                                               approx_div=True, dtype=BF16),
        50)
    return out


# K7 at K > 64 as --digest times it (`k7_wide_ms`): the big-N shape at
# K = 72, the K = 256 timed shape of `phase_kernels_wide`, and the big-N
# shape with the replicate axis; (B, W, K, R or None, launches timed)
K7_WIDE_TIMED = ((BIGN[0], BIGN[1], 72, None, 3), (1024, 2048, 256, None, 5),
                 (BIGN[0], BIGN[1], 72, R_REP, 1))


def wide_k7_ms(dev):
    """Device ms a call of K7 at K > 64, f32 and bf16, at K7_WIDE_TIMED:
    --digest prints them in whichever tree's package is imported, so that
    two trees' bodies are timed in turns."""
    out = {}
    for b, w, k, r, reps in K7_WIDE_TIMED:
        x = k7_wide_inputs(dev, b, w, k, r)
        for dtype, name in ((torch.float32, "K7"), (BF16, "K7[bf16]")):
            rep = f"[rep] wide R={r} " if r else " wide "
            out[f"{name}{rep}B={b} W={w} K={k}"] = k7_wide_ms(x, dtype, reps)
        del x
        torch.cuda.empty_cache()
    return out


# K6 as --digest times it (`k6_ms`), at the big-N shape: K = 10 and 72,
# single and with the replicate axis (R = 4); (K, R or None, launches
# timed). K7 beside it at K = 10 (`wide_k7_ms` times it at K = 72).
K6_TIMED = ((10, None, 5), (72, None, 3), (10, R_REP, 3), (72, R_REP, 1))


def k6_ms(dev):
    """Device ms a call of K6 (and of K7 at K = 10) through the wrappers,
    f32 and bf16, at K6_TIMED: --digest prints them in whichever tree's
    package is imported, so that two trees' K6 are timed in turns."""
    out = {}
    b, w, _ = BIGN
    for k, r, reps in K6_TIMED:
        x = k7_wide_inputs(dev, b, w, k, r)
        rep = f"[rep] R={r} " if r else " "
        for dtype, tag in ((torch.float32, ""), (BF16, "[bf16]")):
            out[f"K6{tag}{rep}B={b} W={w} K={k}"] = k7_wide_ms(x, dtype, reps,
                                                                True)
            if k <= 64:
                out[f"K7{tag}{rep}B={b} W={w} K={k}"] = k7_wide_ms(
                    x, dtype, reps)
        del x
        torch.cuda.empty_cache()
    return out


def bign_step_ms(dev):
    """ms a big-N step (100K x 100K packed bytes drawn on the card, B =
    4,096, snp_group 8; 10-step chunks, `steady_step_ms`) with
    stats_kernel "fused" (K6) and "fused_v2" (K7), K = 10 and 72, f32:
    --digest prints them in whichever tree's package is imported."""
    n = l = 100_000
    g = torch.Generator(device=dev).manual_seed(1)
    packed = torch.randint(0, 256, (l, n // 4), generator=g, device=dev,
                           dtype=torch.uint8)
    out = {}
    for k in (10, 72):
        for sk in ("fused", "fused_v2"):
            cfg = SVIConfig(n=n, l=l, k=k, batch_size=4096, rfreq=10,
                            max_steps=10, seed=0, snp_group=8,
                            stats_kernel=sk)
            state = engine.init_state(cfg, l_padded=l, device=dev)
            chunk = engine.make_run_chunk(cfg, 10, l)
            out[f"step {sk} K={k}"] = steady_step_ms(chunk, state, packed,
                                                     10)
            del state, chunk
            torch.cuda.empty_cache()
    return out


# The λ pass at K > 64 as --digest times it (`wide_lambda_ms`): K8 on the
# big-N step's subsample (B = 4,096, 4 x 2,048, K = 72, the step's fast
# divide), single and with the replicate axis (R = 4); K4 at config #3's
# width (B = 1,024, W = 640) at K = 72 and 256, and K1 and K2 there on the
# main path's accel schedule (REP_WIDE_MAIN); f32 and bf16.
def wide_lambda_ms(dev):
    """Device ms a call of the wrappers that run the λ pass at K > 64 (CUDA
    events after a warm-up): --digest prints them in whichever tree's
    package is imported, so that two trees' bodies are timed in turns."""
    out = {}
    dtypes = ((torch.float32, ""), (BF16, "[bf16]"))
    b, w, k = BIGN[0], BIGN_SUB_W, REP_WIDE_K
    call = wide_lambda_inputs(dev, "K8", b, w, k)[1]
    x = _wide_rep_inputs(b, w, k, dev)
    for dtype, tag in dtypes:
        out[f"K8{tag} wide B={b} (4, {w}) K={k} approx"] = time_ms(
            lambda: call(dtype, True), 20)
        out[f"K8{tag}[rep] wide R={R_REP} B={b} (4, {w}) K={k} approx"] = \
            time_ms(_wide_rep_calls(x, dtype, True)["K8"][0], 5)
    del call, x
    b, w = 1024, 640
    for k in (REP_WIDE_K, 256):
        (rows, up, lamb, _, _), call = wide_lambda_inputs(dev, "K4", b, w, k)
        for dtype, tag in dtypes:
            out[f"K4{tag} wide B={b} W={w} K={k}"] = time_ms(
                lambda: call(dtype), 20)
            if k == REP_WIDE_K:
                out[f"K1{tag} wide B={b} W={w} K={k} accel7"] = time_ms(
                    lambda: fused_step.fused_local_solve(
                        rows, up, lamb, dtype=dtype, **REP_WIDE_MAIN), 10)
    # K2 at config #3's step: 128 groups of 8 rows out of a 65,536-row
    # matrix
    idx0, packed, up, lamb, _ = wide_k2_inputs(dev, b, w, REP_WIDE_K)
    for dtype, tag in dtypes:
        out[f"K2{tag} wide L=65536 B={b} W={w} K={REP_WIDE_K} g=8 "
            "accel7"] = time_ms(lambda: fused_step.fused_local_solve_dma(
                idx0, packed, up, lamb, group=8, dtype=dtype,
                **REP_WIDE_MAIN), 10)
    torch.cuda.empty_cache()
    return out


# The γ pass at K > 64 as --digest times it (`wide_gamma_ms`): K5 at the
# big-N shape with K = 72, single and with the replicate axis (R = 4),
# and the γ pass alone through K5's entry at config #3's width with
# K = 72 (K1's and K2's last pass there); f32 and bf16
def wide_gamma_ms(dev):
    """Device ms a call of K5 at K > 64 (CUDA events after a warm-up; the
    γ pass alone from a CUDA graph): --digest prints them in whichever
    tree's package is imported, so that two trees' bodies are timed in
    turns."""
    out = {}
    dtypes = ((torch.float32, ""), (BF16, "[bf16]"))
    b, w, _ = BIGN
    k = REP_WIDE_K
    for r, reps in ((None, 5), (R_REP, 2)):
        rows, up, _, t1, t0 = k7_wide_inputs(dev, b, w, k, r)
        for dtype, tag in dtypes:
            rep = f"[rep] wide R={r}" if r else " wide"
            out[f"K5{tag}{rep} B={b} W={w} K={k}"] = time_ms(
                lambda: stats_packed.gamma_stats_packed(rows, up, t1, t0,
                                                        dtype), reps)
        del rows, up, t1, t0
        torch.cuda.empty_cache()
    for b, w, k in GAMMA_WIDE_SHAPES:
        rows, up, lamb = _solve_inputs(b, w, k, b + w + k, dev)
        t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
        for dtype, tag in dtypes:
            out[f"γ pass{tag} B={b} W={w} K={k}"] = device_ms(
                lambda: stats_packed.gamma_stats_packed(rows, up, t1, t0,
                                                        dtype))
    return out


# The bodies at K <= 64 as --digest times them (`narrow_ms`), f32 and
# bf16: K5 at the big-N shape; the γ pass alone through K5's entry and
# the λ pass alone through K4's entry at PASS_SHAPES' first two (K1's and
# K2's passes, K4 in eval and export), from a CUDA graph; K4 eagerly at
# the eval block; K1 at the TGP step and K2 at config #3's, accel7; K8 on
# the big-N subsample; K5, K1 and K4 with the replicate axis (R = 4)
def narrow_ms(dev):
    """Device ms a call of the wrappers that run the λ and γ passes at
    K <= 64 (CUDA events after a warm-up; the passes alone from a CUDA
    graph of 100 calls): --digest prints them in whichever tree's
    package is imported, so that two trees' bodies are timed in turns."""
    out = {}
    dtypes = ((torch.float32, ""), (BF16, "[bf16]"))
    main = dict(local_iters=7, local_tol=1e-4, accel=True, beta_a=1.0,
                beta_b=1.0)
    b, w, k = BIGN
    rows, up, _, t1, t0 = _stats_inputs(b, w, k, b + w + k, dev)
    for dtype, tag in dtypes:
        out[f"K5{tag} B={b} W={w} K={k}"] = time_ms(
            lambda: stats_packed.gamma_stats_packed(rows, up, t1, t0, dtype),
            5)
    del rows, up, t1, t0
    rows, up, _, t1, t0 = _stats_inputs(b, BIGN_SUB_W, k, 7, dev)
    a1, a0 = stats_packed.decode_count_planes(rows)
    for dtype, tag in dtypes:
        out[f"K8{tag} B={b} (4, {BIGN_SUB_W}) K={k} approx"] = time_ms(
            lambda: stats_packed.lambda_stats_acat(
                a1, a0, up, t1, t0, approx_div=True, dtype=dtype), 50)
    del rows, up, t1, t0, a1, a0
    for b, w, k in PASS_SHAPES[:2]:
        rows, up, lamb = _solve_inputs(b, w, k, b + w + k, dev)
        t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
        shape = f"B={b} W={w} K={k}"
        for dtype, tag in dtypes:
            out[f"γ pass{tag} {shape}"] = device_ms(
                lambda: stats_packed.gamma_stats_packed(rows, up, t1, t0,
                                                        dtype))
            for approx in (False, True):
                out[f"λ pass{tag} {shape}" + " approx" * approx] = device_ms(
                    lambda: stats_packed.lambda_stats_packed(
                        rows, up, t1, t0, approx_div=approx, dtype=dtype))
            if b == 1024:
                out[f"K4{tag} {shape} eager"] = time_ms(
                    lambda: stats_packed.lambda_stats_packed(
                        rows, up, t1, t0, dtype=dtype), 200)
            else:
                out[f"K1{tag} {shape} accel7"] = time_ms(
                    lambda: fused_step.fused_local_solve(
                        rows, up, lamb, dtype=dtype, **main), 20)
    l, w, k, b, g = 1_000_000, 640, 8, 1024, 8
    gen = torch.Generator(device=dev).manual_seed(5)
    packed = torch.randint(0, 256, (l, w), generator=gen, device=dev,
                           dtype=torch.uint8)
    gamma = 0.3 + 2.7 * torch.rand((4 * w, k), generator=gen, device=dev)
    up = stats_packed.u_to_planes(exp_elog_theta(gamma))
    idx0 = torch.randint(0, l // g, (b // g,), generator=gen, device=dev,
                         dtype=torch.int32) * g
    lamb = 0.5 + 2.5 * torch.rand((b, k, 2), generator=gen, device=dev)
    for dtype, tag in dtypes:
        out[f"K2{tag} L=1M B={b} W={w} K={k} g={g} accel7"] = time_ms(
            lambda: fused_step.fused_local_solve_dma(
                idx0, packed, up, lamb, group=g, dtype=dtype, **main), 20)
    del packed
    b, w, k = PASS_SHAPES[0]
    rows, up, lamb = _rep_inputs(b, w, k, 11, dev)
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    for dtype, tag in dtypes:
        out[f"K1{tag}[rep] R={R_REP} B={b} W={w} K={k} accel7"] = time_ms(
            lambda: fused_step.fused_local_solve(rows, up, lamb, dtype=dtype,
                                                 **main), 10)
        out[f"K4{tag}[rep] R={R_REP} B={b} W={w} K={k} rows shared"] = \
            time_ms(lambda: stats_packed.lambda_stats_packed(
                rows[0], up, t1, t0, dtype=dtype), 20)
    del rows, up, lamb, t1, t0
    b, w, k = BIGN
    rows, up, _, t1, t0 = _bign_rep_inputs(b, w, k, dev)[:5]
    for dtype, tag in dtypes:
        out[f"K5{tag}[rep] R={R_REP} B={b} W={w} K={k}"] = time_ms(
            lambda: stats_packed.gamma_stats_packed(rows, up, t1, t0, dtype),
            2)
    del rows, up, t1, t0
    torch.cuda.empty_cache()
    return out


def main(argv=()) -> int:
    if list(argv) not in ([], ["--kernels"], ["--digest"]):
        print("usage: chip_smoke.py [--kernels | --digest]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if torch.cuda.get_device_capability(dev) != (9, 0):
        print("chip_smoke: needs compute capability 9.0", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False    # the twins stay f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"phase 0: card {card}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.time()
    _build.lib()
    log(f"  kernels built in {time.time() - t0:.1f} s "
        f"(nvcc {_build.build_seconds} s) -> {_build.library_path().name}")
    by_source = getattr(_build, "source_seconds", {})  # older trees: none
    if by_source:
        log("  nvcc seconds by source: " + ", ".join(
            f"{name} {t:.1f}" for name, t in by_source.items()))
    rec = {name: {} for name in KERNELS}
    if argv == ["--digest"]:
        print(json.dumps({"digests": digests(dev),
                          "wrapper_eager_ms": wrapper_eager_ms(dev),
                          "bign_bf16_ms": bign_bf16_ms(dev),
                          "wide_k7_ms": wide_k7_ms(dev),
                          "k6_ms": k6_ms(dev),
                          "bign_step_ms": bign_step_ms(dev),
                          "wide_lambda_ms": wide_lambda_ms(dev),
                          "wide_gamma_ms": wide_gamma_ms(dev),
                          "narrow_ms": narrow_ms(dev)}))
        print(card)
        return 0

    log("phase 1: kernels vs twins")
    tr = time.time()
    phase_kernels(dev, rec, sweep=argv == ["--kernels"])
    log(f"  phase 1 in {time.time() - tr:.1f} s")
    if argv:
        log(f"phases 0 and 1 in {time.time() - t0:.1f} s")
        print(json.dumps({"kernels": [dict(name=name, **rec[name])
                                      for name in KERNELS]}))
        print(card)
        return 0
    f32 = {}
    tr = time.time()
    log("phase 2: canonical drive, config #1")
    f32["config #1 local"] = phase_canonical(dev, rec)
    log("phase 2b: config #1, stored lambda mode")
    f32["config #1 stored"] = phase_canonical(dev, rec, lambda_mode="stored")
    log("phase 2c: K = 72 through the fused branch")
    phase_wide_paths(dev, rec)
    log(f"  phase 2 in {time.time() - tr:.1f} s")
    log("phase 3: TGP shape")
    tr = time.time()
    tgp = phase_tgp(dev, rec)
    log(f"  phase 3 in {time.time() - tr:.1f} s")
    log("phase 4: big-N shape")
    tr = time.time()
    bign = phase_bign(dev, rec)
    log(f"  phase 4 in {time.time() - tr:.1f} s")
    log("phase 5: config #3, group-addressed solve (K2)")
    tr = time.time()
    f32["config #3 local"] = phase_config3(dev, rec, *tgp)
    log(f"  phase 5 in {time.time() - tr:.1f} s")
    log("phase 6: compute_dtype bfloat16: config #1 (both lambda modes), "
        "config #3")
    tr = time.time()
    phase_bf16_drives(dev, rec, *tgp, f32)
    log(f"  phase 6 in {time.time() - tr:.1f} s")
    log("phase 7: compute_dtype bfloat16 on the big-N shape")
    tr = time.time()
    phase_bign_bf16(dev, rec, bign)
    log(f"  phase 7 in {time.time() - tr:.1f} s")
    log("phase 8: out-of-core streaming from a .bed through an on-disk "
        "cache")
    tr = time.time()
    phase_stream(dev, rec, bign)
    log(f"  phase 8 in {time.time() - tr:.1f} s")
    log("phase 9: batched replicates (fit_replicates_batched)")
    tr = time.time()
    phase_replicates(dev, rec)
    log(f"  phase 9 in {time.time() - tr:.1f} s")
    log("phase 10: the command line (cli.py); 10a: config #1")
    tr = time.time()
    phase_cli(dev, rec)
    log(f"  phase 10 in {time.time() - tr:.1f} s")
    log("phase 11: batched replicates on the big-N path")
    tr = time.time()
    phase_replicates_bign(dev, rec, bign)
    log(f"  phase 11 in {time.time() - tr:.1f} s")
    log("phase 12: the MCMC validators (mcmc/)")
    phase_validate(dev, rec)
    log("phase 13: the multi-card fit (parallel/): 13a one rank over NCCL")
    tr = time.time()
    phase_sharded(dev, rec, tgp[0], bign)
    log(f"  phase 13 in {time.time() - tr:.1f} s")
    log("phase 14: batched replicates at K > 64 and with kernel='dense'")
    phase_replicates_wide(dev, rec, tgp[0], bign)
    log("phase 15: chains over ranks, the dry run, the resident biobank "
        "fit")
    tr = time.time()
    phase_chains(dev, rec)
    log(f"  phase 15 in {time.time() - tr:.1f} s")
    log(f"all phases in {time.time() - t0:.1f} s")

    kernels = [dict(name=name, route="cuda", source=spec["source"],
                    replaces=spec["replaces"], **rec[name])
               for name, spec in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
