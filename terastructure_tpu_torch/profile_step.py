"""Where a step's time goes on the card: a chunk of SVI steps under
torch.profiler, with the device time of each kernel and the device's
busy share.

    python -m terastructure_tpu_torch.profile_step --config 3 --steps 50

The configuration is one of converge.CONFIGS at its published shape
(cut by --scale; its batch size, snp_group 8, seed 0), simulated on the
card. `--batch-size 4096 --snp-group 1` with config 3 is the TGP shape as
the throughput runs set it (the block gather K3 and K1 instead of K2).
`--compute-dtype bfloat16` runs the bf16 bodies (the reference CLI's flag).
One chunk of `--steps` steps warms up, then the same number is timed
unprofiled (host clock around the chunk and a synchronize) and once under
the profiler. Prints the card line and one JSON line: ms a step
unprofiled, the profiled window's wall and kernel time, the busy share
(kernel time over wall), and each kernel's total ms, calls and share of
kernel time, largest first.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from terastructure_tpu_torch import SVIConfig
from terastructure_tpu_torch.converge import CONFIGS, card_line
from terastructure_tpu_torch.data import simulate_packed_device
from terastructure_tpu_torch.svi import engine


def device_ms(evt) -> float:
    """An event's device time in ms (the attribute's name differs across
    torch versions)."""
    us = getattr(evt, "device_time_total", None)
    if us is None:
        us = evt.cuda_time_total
    return us / 1e3


def run(config: int, *, steps: int, lambda_mode: str = "local",
        scale: float = 1.0, batch_size: int = 0, snp_group: int = 8,
        compute_dtype: str = "float32") -> dict:
    spec = CONFIGS[config]
    n = int(spec["n"] * scale) // 4 * 4
    l = int(spec["l"] * scale) // 8 * 8
    k, b = spec["k"], batch_size or spec["batch"]
    dev = torch.device("cuda")
    packed, _ = simulate_packed_device(n, l, k, seed=0, device=dev)
    packed = engine.resident_packed(packed, dev)
    cfg = SVIConfig(n=n, l=l, k=k, batch_size=b, seed=0,
                    snp_group=snp_group, lambda_mode=lambda_mode,
                    compute_dtype=compute_dtype)
    chunk = engine.make_run_chunk(cfg, steps, l)
    state = chunk(engine.init_state(cfg, l_padded=l, device=dev), packed)
    torch.cuda.synchronize()
    t0 = time.time()
    state = chunk(state, packed)
    torch.cuda.synchronize()
    step_ms = (time.time() - t0) / steps * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        state = chunk(state, packed)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(device_ms(e) for e in kernels)
    rows = sorted(((device_ms(e), e.count, e.key) for e in kernels),
                  reverse=True)
    return dict(
        config=config, n=n, l=l, k=k, batch_size=b, snp_group=snp_group,
        lambda_mode=lambda_mode, compute_dtype=compute_dtype,
        steps=steps, step_ms_unprofiled=step_ms,
        snp_updates_per_s=b / step_ms * 1e3,
        profiled_wall_ms=wall_ms, kernel_ms=total,
        busy_share=total / wall_ms if wall_ms else None,
        kernels=[dict(name=name[:120], ms=ms, calls=calls,
                      share=ms / total if total else None)
                 for ms, calls, name in rows])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=int, choices=sorted(CONFIGS), default=3)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--lambda-mode", choices=("local", "stored"),
                    default="local")
    ap.add_argument("--batch-size", type=int, default=0,
                    help="0: the configuration's own")
    ap.add_argument("--snp-group", type=int, default=8)
    ap.add_argument("--compute-dtype", choices=("float32", "bfloat16"),
                    default="float32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    print(json.dumps(run(args.config, steps=args.steps,
                         lambda_mode=args.lambda_mode, scale=args.scale,
                         batch_size=args.batch_size,
                         snp_group=args.snp_group,
                         compute_dtype=args.compute_dtype)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
