"""Profiling and tracing (port of terastructure_tpu/utils/profiling.py).

A step-rate meter driven by the fit callback, and a torch.profiler trace
context that writes a Chrome trace (open it in chrome://tracing or
Perfetto):

    from terastructure_tpu_torch.utils.profiling import StepMeter, trace
    meter = StepMeter(batch_size=cfg.batch_size)
    fit(cfg, data, callback=meter)          # meter(rec) per rfreq chunk
    print(meter.summary())

    with trace("/tmp/tera-trace"):          # writes trace.json there
        run_chunk(state, packed)
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


class StepMeter:
    """Tracks SNP-updates/s from the fit driver's per-check records."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.t0: Optional[float] = None
        self.last_step = 0
        self.last_time: Optional[float] = None
        self.rates: list[float] = []

    def __call__(self, rec: dict):
        now = time.time()
        if self.t0 is None:
            self.t0 = now - rec.get("wall_s", 0.0)
        if self.last_time is not None and rec["step"] > self.last_step:
            dt = now - self.last_time
            if dt > 0:
                self.rates.append(
                    (rec["step"] - self.last_step) * self.batch_size / dt)
        self.last_step = rec["step"]
        self.last_time = now

    @property
    def snp_updates_per_s(self) -> float:
        """Steady-state rate: median of the observed chunk rates."""
        if not self.rates:
            return float("nan")
        srt = sorted(self.rates)
        return srt[len(srt) // 2]

    def summary(self) -> dict:
        return {
            "snp_updates_per_s": self.snp_updates_per_s,
            "chunks": len(self.rates),
            "steps": self.last_step,
        }


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the body (the CPU, and the CUDA card where
    there is one); writes its Chrome trace to log_dir/trace.json when the
    body ends and yields the profiler. What the profiler raises is
    raised."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
