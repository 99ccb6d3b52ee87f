"""PSD-model genotype simulator (port of terastructure_tpu/data/simulate.py).

`simulate_psd` is the reference's numpy draw, bitwise equal for the same
seed. `simulate_packed_device` draws Binomial(2, theta.beta) genotypes
and packs them on the torch device in SNP chunks, which builds a
biobank-shaped matrix in seconds on a GPU; it returns the matrix on the
host. `simulate_packed_device_resident` writes the same chunks into a
preallocated matrix on the device, which stays there (no host round
trip: the biobank demo's 8 GB matrix at N = 1M).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from terastructure_tpu_torch.models.psd import MISSING


def simulate_psd(
    n: int,
    l: int,
    k: int,
    *,
    alpha: Optional[float] = None,
    beta_a: float = 1.0,
    beta_b: float = 1.0,
    missing_frac: float = 0.0,
    structured: bool = True,
    seed: int = 0,
):
    """Draw (theta (n, k) f64, beta (l, k) f64, x (n, l) int8) from the PSD
    model; x holds MISSING=3 where masked. Same stream as the reference."""
    rng = np.random.default_rng(seed)
    if structured:
        # Concentrated Dirichlet around a random dominant population.
        dominant = rng.integers(0, k, size=n)
        conc = np.full((n, k), 0.2)
        conc[np.arange(n), dominant] = 5.0
        theta = rng.dirichlet(np.ones(k), size=n) * 0  # keeps the stream
        for i in range(0, n, 4096):
            sl = slice(i, min(i + 4096, n))
            g = rng.gamma(conc[sl], 1.0)
            theta[sl] = g / g.sum(axis=1, keepdims=True)
    else:
        a = (1.0 / k) if alpha is None else alpha
        g = rng.gamma(a, 1.0, size=(n, k))
        theta = g / np.maximum(g.sum(axis=1, keepdims=True), 1e-300)

    beta = rng.beta(beta_a, beta_b, size=(l, k))
    beta = np.clip(beta, 1e-4, 1.0 - 1e-4)

    # Binomial(2, p) as two uniform-threshold draws, SNP-chunked.
    x = np.empty((n, l), np.int8)
    jchunk = max(1024, min(l, (1 << 28) // max(n, 1)))
    for j0 in range(0, l, jchunk):
        j1 = min(j0 + jchunk, l)
        p = np.clip(theta @ beta[j0:j1].T, 0.0, 1.0).astype(np.float32)
        x[:, j0:j1] = (
            (rng.random(p.shape, np.float32) < p).astype(np.int8)
            + (rng.random(p.shape, np.float32) < p).astype(np.int8)
        )

    if missing_frac > 0:
        mask = rng.random((n, l)) < missing_frac
        x[mask] = MISSING
    return theta, beta, x


def _structured_theta(rng, n, k):
    """The reference's structured theta draw (n, k) f32 from rng."""
    dominant = rng.integers(0, k, size=n)
    conc = np.full((n, k), 0.2)
    conc[np.arange(n), dominant] = 5.0
    theta = np.empty((n, k), np.float32)
    for i in range(0, n, 1 << 16):
        sl = slice(i, min(i + (1 << 16), n))
        g = rng.gamma(conc[sl], 1.0)
        theta[sl] = (g / g.sum(1, keepdims=True)).astype(np.float32)
    return theta


def _beta_chunks(rng, n, l, k, chunk):
    """((j0, j1), beta (j1 - j0, k) f32) per SNP chunk, drawn from rng."""
    if chunk <= 0:
        # a handful of (C, N) f32 temps per chunk, ~256 MB each at most
        chunk = int(max(8, min(1 << 16, (1 << 28) // (4 * n))))
    for j0 in range(0, l, chunk):
        j1 = min(j0 + chunk, l)
        yield (j0, j1), np.clip(rng.beta(1, 1, size=(j1 - j0, k)), 1e-4,
                                1 - 1e-4).astype(np.float32)


def simulate_packed_device(n, l, k, *, seed: int = 0,
                           missing_frac: float = 0.0, chunk: int = 0,
                           device="cuda"):
    """Device-side PSD draw -> (packed (l, n/4) uint8 numpy, theta (n, k) f32).

    theta is the reference's structured draw (host numpy, identical to
    the reference `simulate_packed_device` for the same seed). Genotypes
    come from one uniform per entry by inverse CDF,
    x = [u >= (1-p)^2] + [u >= 1-p^2], drawn with a torch generator on
    `device` and packed there; beta ~ U(0, 1) per SNP is drawn on the
    host per chunk and not returned (`simulated_beta` replays it).
    Requires n % 4 == 0.
    """
    if n % 4:
        raise ValueError("simulate_packed_device requires n % 4 == 0")
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    theta = _structured_theta(rng, n, k)
    draw = _ChunkDraw(theta, seed, missing_frac, device)
    packed = np.empty((l, n // 4), np.uint8)
    for (j0, j1), beta in _beta_chunks(rng, n, l, k, chunk):
        packed[j0:j1] = draw(beta).cpu().numpy()
    return packed, theta


class _ChunkDraw:
    """The packed rows (C, n/4) uint8 on the device of one SNP chunk's
    beta (C, k): genotypes by inverse CDF from one uniform per entry, x =
    [u >= (1-p)^2] + [u >= 1-p^2] with p = beta theta^T, then MISSING
    where a second uniform < missing_frac; the uniforms from one torch
    generator seeded with `seed`, in chunk order."""

    def __init__(self, theta, seed, missing_frac, device):
        self.theta_d = torch.from_numpy(theta).to(device)
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.missing_frac = missing_frac
        self.device = device
        self.shifts = torch.arange(0, 8, 2, dtype=torch.int32, device=device)

    def __call__(self, beta):
        dev = self.device
        p = (torch.from_numpy(beta).to(dev) @ self.theta_d.T).clamp_(0.0, 1.0)
        u = torch.rand(p.shape, generator=self.gen, device=dev)
        x = ((u >= (1.0 - p) * (1.0 - p)).to(torch.int32)
             + (u >= 1.0 - p * p).to(torch.int32))
        if self.missing_frac > 0:
            u3 = torch.rand(p.shape, generator=self.gen, device=dev)
            x = torch.where(u3 < self.missing_frac, MISSING, x)
        q = x.reshape(p.shape[0], -1, 4) << self.shifts  # byte b: 4b..4b+3
        return (q[..., 0] | q[..., 1] | q[..., 2] | q[..., 3]).to(torch.uint8)


def simulate_packed_device_resident(n, l, k, *, seed: int = 0,
                                    missing_frac: float = 0.0, chunk: int = 0,
                                    device="cuda", progress=None):
    """simulate_packed_device whose packed matrix stays on the device:
    (packed (l, n/4) uint8 tensor on `device`, theta (n, k) f32 host).

    Each chunk's rows are written into one preallocated (l, n/4) tensor
    (filled with 0xFF, MISSING, first), with no host round trip: for
    matrices that fit the card but whose host copy is the cost (8.2 GB at
    N = 1,000,448, L = 32,768). The draws are simulate_packed_device's,
    so the matrix is bitwise its matrix for the same seed and chunk where
    l % chunk == 0. Otherwise the tail chunk, as in the reference, draws
    a whole chunk and writes it at row l - chunk, over the end of the
    chunk before it (every row stays a PSD draw; the tail's beta is then
    not simulated_beta's). progress(j1, l) is called after each chunk.
    Requires n % 4 == 0."""
    if n % 4:
        raise ValueError("simulate_packed_device requires n % 4 == 0")
    device = torch.device(device)
    if chunk <= 0:
        chunk = int(max(8, min(1 << 16, (1 << 28) // (4 * n))))
    chunk = min(chunk, l)
    rng = np.random.default_rng(seed)
    theta = _structured_theta(rng, n, k)
    draw = _ChunkDraw(theta, seed, missing_frac, device)
    packed = torch.full((l, n // 4), 0xFF, dtype=torch.uint8, device=device)
    for j0 in range(0, l, chunk):
        beta = np.clip(rng.beta(1, 1, size=(chunk, k)), 1e-4,
                       1 - 1e-4).astype(np.float32)
        o = min(j0, l - chunk)           # the clamped tail write
        packed[o:o + chunk] = draw(beta)
        if progress is not None:
            progress(min(j0 + chunk, l), l)
    return packed, theta


def simulated_beta(n, l, k, *, seed: int = 0, chunk: int = 0) -> np.ndarray:
    """The beta (l, k) f32 behind `simulate_packed_device` with the same
    arguments: its numpy generator replayed (the genotype uniforms come
    from the torch generator and are not needed). For the oracle
    log-likelihood of a fit on that draw."""
    rng = np.random.default_rng(seed)
    _structured_theta(rng, n, k)
    return np.concatenate([b for _, b in _beta_chunks(rng, n, l, k, chunk)])
