"""Checkpoint and resume of a fit's state (port of
terastructure_tpu/io/checkpoint.py, which saves with Orbax).

A checkpoint directory holds `state/state.pt` (gamma, lamb, t and seed,
written with `torch.save`) and `config.json` (the run's SVIConfig, the
reference's layout). Step t of a fit draws from (seed, t)
(engine.step_generator), so the state is all a fit needs to go on: a fit
restored at step t and run to step T ends where an uninterrupted run to T
ends, bit for bit. A reference Orbax checkpoint is not read; the text
model (io/export.py) carries a fit between the two packages.

`save_checkpoint(..., block=False)` saves asynchronously: gamma and lamb
are snapshotted with a clone on their device, enqueued before the call
returns, and one worker thread copies the snapshot to the host and
writes it, while the step loop goes on. The clone is what makes this
right: in the stored lambda mode the step scatters lambda rows in place
(engine.make_step), so a write of the live tensor could hold a later
state than the step it names. At most one save is in flight (a new save
first waits out the previous one); `wait_until_finished()` commits it and
raises what the worker raised. Each file is written to a temporary name
and renamed, so a checkpoint directory always holds a whole save; the
config is renamed into place after the state.
"""

from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import torch

from terastructure_tpu_torch.config import SVIConfig
from terastructure_tpu_torch.svi.engine import SVIState

_STATE_DIR = "state"
_STATE_FILE = "state.pt"
_CONFIG_FILE = "config.json"


class _Writer:
    """One worker thread and the save it has in flight."""

    def __init__(self):
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: Optional[Future] = None

    def submit(self, fn, *args) -> None:
        self.wait()
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="checkpoint")
        self._pending = self._pool.submit(fn, *args)

    def wait(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()


_writer = _Writer()


def wait_until_finished() -> None:
    """Block until the save in flight (if any) is written; raises what
    its write raised."""
    _writer.wait()


def _replace_file(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _write(path: str, snap: dict, cfg_json: str) -> None:
    host = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in snap.items()}
    os.makedirs(os.path.join(path, _STATE_DIR), exist_ok=True)
    _replace_file(os.path.join(path, _STATE_DIR, _STATE_FILE),
                  lambda p: torch.save(host, p))

    def write_config(p):
        with open(p, "w") as f:
            f.write(cfg_json)

    _replace_file(os.path.join(path, _CONFIG_FILE), write_config)


def save_checkpoint(path: str, state: SVIState, cfg: SVIConfig,
                    block: bool = True) -> None:
    """Save the state and the config to directory `path`.

    block=False returns once the snapshot is enqueued; the write runs on
    the worker thread (see the module docstring). block=True returns once
    the checkpoint is written."""
    path = os.path.abspath(path)
    _writer.wait()
    snap = dict(gamma=state.gamma.detach().clone(),
                lamb=state.lamb.detach().clone(),
                t=int(state.t), seed=int(state.seed))
    _writer.submit(_write, path, snap, cfg.to_json())
    if block:
        _writer.wait()


def restore_checkpoint(path: str, *, device="cpu"
                       ) -> tuple[SVIState, SVIConfig]:
    """(state, config) of the checkpoint in directory `path`, the state's
    tensors on `device` with the bits they were saved with. A save in
    flight is waited out first (it may be this checkpoint)."""
    path = os.path.abspath(path)
    _writer.wait()
    with open(os.path.join(path, _CONFIG_FILE)) as f:
        cfg = SVIConfig.from_json(f.read())
    raw = torch.load(os.path.join(path, _STATE_DIR, _STATE_FILE),
                     map_location="cpu", weights_only=True)
    state = SVIState(gamma=raw["gamma"].to(device),
                     lamb=raw["lamb"].to(device),
                     t=int(raw["t"]), seed=int(raw["seed"]))
    return state, cfg
