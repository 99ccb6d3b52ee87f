"""Drive the PyTorch + CUDA port on one H100 and check it end to end.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card of compute
capability 9.0. Phases, each of which must pass (no phase is caught):

0. the card (nvidia-smi name and power limit), torch and CUDA versions,
   and the nvcc build of csrc/*.cu;
1. every kernel of the main path against its plain PyTorch twin on the
   same inputs at main-path shapes, with errors and times;
2. the canonical config #1 fit (1000 x 10K, K=3) through `fit`: converged,
   theta MAE < 0.05, heldout within 0.02 of the oracle;
3. the TGP-shape fit (2504 x 1M, K=8, B=4096, 200 steps): SNP-updates/s,
   launch counts of K1, K3 and K4 > 0 with no twin run, and one chunk
   re-run twice from the same state bitwise equal;
4. the big-N fit (100K x 100K, K=10, B=4096, snp_group=8, 300 steps),
   which the fused gate refuses: K1 never launches, K3, K4, K7 and K8 do
   with no twin run; then one step each with stats_kernel "pair" (K4 +
   K5), "fused" (K6) and "fused_v2" (K7) from one state, their gammas
   within 1e-4, and one chunk re-run twice bitwise equal.

Prints the kernels' JSON line, the card line, and last
{"ok": true, "device": {...}}. Exits non-zero without a result when there
is no CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from terastructure_tpu.utils.labels import mean_abs_theta_error
from terastructure_tpu_torch import SVIConfig, _build
from terastructure_tpu_torch.data import (GenotypeData, simulate_packed_device,
                                          simulate_psd)
from terastructure_tpu_torch.models import psd
from terastructure_tpu_torch.ops import fused_step, gather, stats_packed
from terastructure_tpu_torch.ops.stats_dense import exp_elog_theta
from terastructure_tpu_torch.svi import engine, fit

TOL = 2e-4          # f32 kernel vs twin (sum order differs), as the reference's
TOL_APPROX = 5e-3   # approx_div: fast divide vs the twin's reciprocal

KERNELS = {
    "fused_local_solve": dict(
        fn=fused_step.fused_local_solve,
        source="terastructure_tpu_torch/csrc/fused_step.cu",
        replaces="terastructure_tpu/ops/fused_step.py:423"),
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
        source="terastructure_tpu_torch/csrc/stats_fused.cu",
        replaces="terastructure_tpu/ops/stats_pallas.py:263"),
    "batch_stats_fused_v2_packed": dict(
        fn=stats_packed.batch_stats_fused_v2_packed,
        source="terastructure_tpu_torch/csrc/stats_fused.cu",
        replaces="terastructure_tpu/ops/stats_pallas.py:355"),
    "lambda_stats_acat": dict(
        fn=stats_packed.lambda_stats_acat,
        source="terastructure_tpu_torch/csrc/stats_acat.cu",
        replaces="terastructure_tpu/ops/stats_pallas.py:463"),
}
BIGN = (4096, 25_088, 10)   # B, W, K of the big-N step (100K individuals)


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def reset_counts():
    for spec in KERNELS.values():
        spec["fn"].launches = 0
        spec["fn"].twin_calls = 0


def read_counts(rec, path, expect, absent=()):
    """Add the launches of a main-path run to rec; fail where a kernel of
    `expect` did not launch, one of `absent` did, or any twin ran."""
    counts = {name: spec["fn"].launches for name, spec in KERNELS.items()}
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


def compare(name, got, want, tol, outlier_frac=0.0):
    """Max abs error; fails where |got - want| > tol + tol*|want| on more
    than `outlier_frac` of the entries, or on any non-finite value."""
    got = [g.float() for g in got]
    want = [w.float() for w in want]
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    out = max(float(((g - w).abs() > tol + tol * w.abs()).float().mean())
              for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    log(f"  {name}: max_abs_err={err:.3e} tol={tol:g} "
        f"outside_tol={out:.2e} (allowed {outlier_frac:g}) finite={finite}")
    if out > outlier_frac or not finite:
        raise AssertionError(f"{name}: kernel disagrees with its twin")
    return err


def _solve_inputs(b, w, k, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randint(0, 256, (b, w), generator=g, device=dev,
                         dtype=torch.uint8)
    gamma = 0.3 + 2.7 * torch.rand((4 * w, k), generator=g, device=dev)
    up = stats_packed.u_to_planes(exp_elog_theta(gamma))
    lamb = 0.5 + 2.5 * torch.rand((b, k, 2), generator=g, device=dev)
    return rows, up, lamb


def phase_kernels(dev, rec):
    """Each kernel against its twin at the main path's shapes."""
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
    r = rec["gather_row_blocks"]
    r["max_abs_err"] = 0.0
    r["ms"] = time_ms(lambda: gather.gather_row_blocks(src, starts))
    r["plain_ms"] = time_ms(lambda: gather.gather_row_blocks_twin(src, starts))
    log(f"  K3 L=1M B=4096 W=640: bitwise equal; kernel {r['ms']:.4f} ms, "
        f"twin {r['plain_ms']:.4f} ms")
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
    phase_kernels_bign(dev, rec)


def _stats_inputs(b, w, k, seed, dev):
    rows, up, lamb = _solve_inputs(b, w, k, seed, dev)
    t1, t0 = fused_step.exp_elog_beta_kernel(lamb)
    return rows, up, stats_packed.planes_to_flat(up).contiguous(), t1, t0


def _timed(rec, label, kernel, twin, reps=5):
    """Kernel and twin times at the main-path shape; twin run and freed
    before the next (the big-N twins hold ~10 GB)."""
    ms = time_ms(kernel, reps)
    plain_ms = time_ms(twin, reps)
    torch.cuda.empty_cache()
    log(f"  {label}: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms")
    rec["ms"], rec["plain_ms"] = ms, plain_ms


def phase_kernels_bign(dev, rec):
    """K5-K8 against their twins at the big-N step's shapes and at a
    ragged small shape (B=12, W=384, K=3)."""
    shapes = [("big-N", BIGN), ("ragged", (12, 384, 3))]
    sub = (BIGN[0], 2048, BIGN[2])          # K8: the 8192-column subsample
    for name in ("gamma_stats_packed", "batch_stats_fused_packed",
                 "batch_stats_fused_v2_packed", "lambda_stats_acat"):
        rec[name]["max_abs_err"] = 0.0

    def check(name, label, got_fn, want_fn, tol):
        err = compare(label, got_fn(), want_fn(), tol)
        torch.cuda.empty_cache()          # the twin's ~10 GB of temporaries
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)

    def twin_stats(rows, up, t1, t0, approx_div=False):
        g, l0, l1 = stats_packed.batch_stats_fused_twin(
            rows, up, t1, t0, approx_div=approx_div)
        u = stats_packed.planes_to_flat(up)
        return u * stats_packed.planes_to_flat(g), t1 * l0, t0 * l1

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
        check("gamma_stats_packed", f"K5 {shape}",
              lambda: [stats_packed.gamma_stats_packed(rows, up, t1, t0)],
              lambda: [stats_packed.gamma_stats_packed_twin(rows, up, t1,
                                                            t0)], TOL)
        if tag == "big-N":
            _timed(rec["batch_stats_fused_v2_packed"], f"K7 {shape}",
                   lambda: stats_packed.batch_stats_fused_v2_packed(
                       rows, u, t1, t0),
                   lambda: twin_stats(rows, up, t1, t0))
            _timed(rec["batch_stats_fused_packed"], f"K6 {shape}",
                   lambda: stats_packed.batch_stats_fused_packed(
                       rows, u, t1, t0),
                   lambda: twin_stats(rows, up, t1, t0))
            _timed(rec["gamma_stats_packed"], f"K5 {shape}",
                   lambda: stats_packed.gamma_stats_packed(rows, up, t1, t0),
                   lambda: stats_packed.gamma_stats_packed_twin(
                       rows, up, t1, t0))
        del rows, up, u, t1, t0

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
                       a1, a0, up, t1, t0, approx_div=True), reps=20)


def phase_canonical(dev):
    """Config #1 through fit, as the verify skill's canonical drive."""
    theta_true, beta_true, x = simulate_psd(1000, 10_000, 3, seed=11)
    data = GenotypeData.from_dense(x, validation_frac=0.005,
                                   heldout_frac=0.005, seed=11)
    cfg = SVIConfig(n=1000, l=10_000, k=3, batch_size=256, rfreq=50,
                    max_steps=3000, seed=11)
    res = fit(cfg, data, device=dev)
    th = psd.theta_mean(res.state.gamma[: cfg.n]).cpu().numpy()
    err = mean_abs_theta_error(th, theta_true)
    h = data.heldout
    p = (theta_true[h.ind_idx] * beta_true[h.snp_idx]).sum(-1)
    oracle = float(psd.binomial2_loglik(
        torch.from_numpy(h.x), torch.from_numpy(p).float()).mean())
    log(f"  config #1: converged={res.converged} steps={res.steps} "
        f"wall_s={res.wall_s:.2f} theta_mae={err:.4f} "
        f"heldout={res.heldout_ll:.5f} oracle={oracle:.5f}")
    if not (res.converged and err < 0.05 and res.heldout_ll > oracle - 0.02):
        raise AssertionError("canonical drive failed its quality checks")


def phase_tgp(dev, rec):
    """TGP shape through fit, with the kernels' launch counts."""
    n, l, k = 2504, 1_000_000, 8
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
                                 "lambda_stats_packed"))
    chunk_s = sum(r["chunk_s"] for r in res.trace)
    eval_s = sum(r.get("eval_s", 0.0) for r in res.trace)
    th = psd.theta_mean(res.state.gamma[:n]).cpu().numpy()
    log(f"  TGP fit: steps={res.steps} chunk_s={chunk_s:.3f} "
        f"eval_s={eval_s:.3f} wall_s={res.wall_s:.2f} "
        f"snp_updates_per_s={res.steps * cfg.batch_size / chunk_s:.1f} "
        f"validation_ll={res.validation_ll:.5f} heldout={res.heldout_ll:.5f} "
        f"theta_mae={mean_abs_theta_error(th, theta):.4f}")
    if not (np.isfinite(res.validation_ll) and np.isfinite(res.heldout_ll)):
        raise AssertionError("TGP fit scores are not finite")

    packed_d = torch.from_numpy(engine.pad_width(data.packed)).to(dev)
    state = engine.init_state(cfg, l_padded=l, device=dev)
    chunk = engine.make_run_chunk(cfg, cfg.rfreq, l)
    a = chunk(state, packed_d).gamma.cpu()
    b = chunk(state, packed_d).gamma.cpu()
    if not torch.equal(a, b):
        raise AssertionError("same-seed chunk re-run is not bitwise equal")
    log("  same-seed chunk re-run: gamma bitwise equal")


def phase_bign(dev, rec):
    """The big-N per-iteration path through fit, at full width."""
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
    reset_counts()
    res = fit(cfg, data, device=dev)
    read_counts(rec, "big-N fit",
                ("gather_row_blocks", "lambda_stats_packed",
                 "batch_stats_fused_v2_packed", "lambda_stats_acat"),
                absent=("fused_local_solve",))
    chunk_s = sum(r["chunk_s"] for r in res.trace)
    eval_s = sum(r.get("eval_s", 0.0) for r in res.trace)
    th = psd.theta_mean(res.state.gamma[:n]).cpu().numpy()
    log(f"  big-N fit: steps={res.steps} chunk_s={chunk_s:.3f} "
        f"eval_s={eval_s:.3f} wall_s={res.wall_s:.2f} "
        f"snp_updates_per_s={res.steps * cfg.batch_size / chunk_s:.1f} "
        f"validation_ll={res.validation_ll:.5f} heldout={res.heldout_ll:.5f} "
        f"theta_mae={mean_abs_theta_error(th, theta):.4f}")
    if not (np.isfinite(res.validation_ll) and np.isfinite(res.heldout_ll)):
        raise AssertionError("big-N fit scores are not finite")

    packed_d = torch.from_numpy(engine.pad_width(data.packed)).to(dev)
    del data
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
                    absent=("fused_local_solve",))
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


def main() -> int:
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
    rec = {name: {} for name in KERNELS}

    log("phase 1: kernels vs twins")
    phase_kernels(dev, rec)
    log("phase 2: canonical drive, config #1")
    phase_canonical(dev)
    log("phase 3: TGP shape")
    phase_tgp(dev, rec)
    log("phase 4: big-N shape")
    phase_bign(dev, rec)

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
    sys.exit(main())
