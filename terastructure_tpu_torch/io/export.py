"""Text exports of a fit (port of terastructure_tpu/io/export.py).

A run directory holds gamma.txt, theta.txt, lambda.txt and beta.txt, one
tab-separated line a row: the row index, the row's id, then the values as
`{:.8g}`. The files are byte for byte the reference's on the same f32
arrays, so a run directory written by either package loads in the other
(`load_model`, `fit --init-model`).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from terastructure_tpu_torch.svi.engine import SVIState

# rows formatted per % operation: one format string for a chunk of rows
_CHUNK_ROWS = 4096


def _write_matrix(path: str, mat, ids: Optional[list] = None):
    """Write mat (R, C) as text lines `i<TAB>id<TAB>v0<TAB>...` with each
    value `{:.8g}`, ids[i] as the id (the row index without ids).

    One `%` operation formats a chunk of rows: the bytes of the
    reference's per-value f-strings (`%.8g` of a float is `{:.8g}` of
    it), at the speed of C. At L = 1M, lambda.txt holds 16M values."""
    mat = np.asarray(mat)
    line = "%d\t%s" + "\t%.8g" * mat.shape[1] + "\n"
    with open(path, "w") as f:
        for lo in range(0, mat.shape[0], _CHUNK_ROWS):
            hi = min(lo + _CHUNK_ROWS, mat.shape[0])
            labels = ids[lo:hi] if ids is not None else range(lo, hi)
            args = [a for i, label, row in zip(range(lo, hi), labels,
                                               mat[lo:hi].tolist())
                    for a in (i, label, *row)]
            f.write((line * (hi - lo)) % tuple(args))


def load_matrix(path: str) -> np.ndarray:
    """Read back a matrix written by _write_matrix (skips the index and
    id columns) as float64 (R, C)."""
    with open(path) as f:
        first = f.readline()
    if not first:
        return np.zeros((0, 0))
    ncol = len(first.rstrip("\n").split("\t"))
    return np.loadtxt(path, delimiter="\t", usecols=range(2, ncol),
                      dtype=np.float64, ndmin=2, comments=None)


def load_model(run_dir: str):
    """Read a text model (gamma.txt + lambda.txt) as (gamma (N, K) f32,
    lamb (L, K, 2) f32), from a run directory of either package. lamb is
    None when lambda.txt is absent (a theta-only model)."""
    gamma = load_matrix(os.path.join(run_dir, "gamma.txt")).astype(
        np.float32)
    lamb_path = os.path.join(run_dir, "lambda.txt")
    lamb = None
    if os.path.exists(lamb_path):
        flat = load_matrix(lamb_path).astype(np.float32)
        if flat.shape[1] % 2:
            raise ValueError(
                f"lambda.txt has odd column count {flat.shape[1]}")
        lamb = flat.reshape(flat.shape[0], flat.shape[1] // 2, 2)
    return gamma, lamb


def state_from_text_model(run_dir: str, cfg, *, step: int = 0,
                          device="cpu") -> SVIState:
    """An SVIState from a text model, to continue a fit from it.

    A missing lambda.txt gives lambda at the Beta prior (the local mode
    re-derives lambda anyway). `step` starts the Robbins-Monro schedule
    (text models do not record t): 0 restarts it, a large value makes the
    updates conservative. Step t of the continued fit draws from
    (cfg.seed, t), as every fit's step t does."""
    gamma, lamb = load_model(run_dir)
    if gamma.shape != (cfg.n, cfg.k):
        raise ValueError(
            f"gamma.txt shape {gamma.shape} != config {(cfg.n, cfg.k)}")
    if lamb is None:
        lamb = np.stack(
            [np.full((cfg.l, cfg.k), cfg.beta_a, np.float32),
             np.full((cfg.l, cfg.k), cfg.beta_b, np.float32)], axis=-1)
    elif lamb.shape != (cfg.l, cfg.k, 2):
        raise ValueError(
            f"lambda.txt shape {lamb.shape} != config {(cfg.l, cfg.k, 2)}")
    return SVIState(gamma=torch.from_numpy(gamma).to(device),
                    lamb=torch.from_numpy(lamb).to(device),
                    t=int(step), seed=cfg.seed)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_model(
    run_dir: str,
    gamma,
    lamb,
    *,
    n: Optional[int] = None,
    l: Optional[int] = None,
    ind_ids=None,
    snp_ids=None,
) -> None:
    """Write gamma/theta/lambda/beta text files (trimmed to n and l rows).
    gamma (N, K) and lamb (L, K, 2) are f32 tensors on any device or
    arrays; theta and beta are their means in f32, as the reference
    computes them."""
    os.makedirs(run_dir, exist_ok=True)
    gamma = _host(gamma)
    lamb = _host(lamb)
    if n is not None:
        gamma = gamma[:n]
    if l is not None:
        lamb = lamb[:l]
    theta = gamma / gamma.sum(axis=-1, keepdims=True)
    beta = lamb[..., 0] / (lamb[..., 0] + lamb[..., 1])
    _write_matrix(os.path.join(run_dir, "gamma.txt"), gamma, ind_ids)
    _write_matrix(os.path.join(run_dir, "theta.txt"), theta, ind_ids)
    _write_matrix(os.path.join(run_dir, "lambda.txt"),
                  lamb.reshape(lamb.shape[0], -1), snp_ids)
    _write_matrix(os.path.join(run_dir, "beta.txt"), beta, snp_ids)
