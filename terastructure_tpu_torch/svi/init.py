"""Spectral warm start of gamma (port of terastructure_tpu/svi/init.py).

Admixture structure is low rank: E[x]/2 = theta beta^T, so the top K-1
principal components of the standardized genotype matrix span the
population structure (Patterson, Price and Reich 2006). A randomized SVD
sketch of the packed matrix (two streamed passes of (Lb, N) x (N, r)
products) gives each individual's PC coordinates, and a soft k-means
assignment in that space gives gamma a weak pull (~5 pseudo-counts)
toward the cluster structure: the fit skips the random start's wander
and keeps its fixed point.

`fit(init="spectral")` starts from `spectral_gamma`; the `pca` CLI
subcommand writes `pca_embedding`. The products are plain f32
`torch.matmul`s (no TF32: PyTorch's default, which this module does not
change), QR and SVD are `torch.linalg`'s, the 2-bit decode is
`data/pack.unpack2bit_torch`. The reference computes all of this outside
its Pallas kernels, so no kernel of the port runs here.

The random draws (Omega and the first k-means centre) come from torch
generators seeded with `seed` on the CPU, not from threefry: the two
packages' draws differ, and `_kmeans` takes the first centre's index
(`first`) so that a test can hand both the same one.
"""

from __future__ import annotations

import numpy as np
import torch

from terastructure_tpu_torch.data.pack import unpack2bit_torch
from terastructure_tpu_torch.models.psd import MISSING

# bytes of one f32 (Lb, N) slab of the standardized matrix
_SLAB_BYTES = 1 << 30


def _standardized_block(packed_blk: torch.Tensor, n: int) -> torch.Tensor:
    """(Lb, W) packed bytes -> (Lb, N) f32 standardized genotypes: each
    SNP centred by 2p and scaled by sqrt(2p(1-p)), its allele frequency p
    from the observed entries (clipped to [1e-4, 1 - 1e-4]); missing
    entries are 0."""
    x = unpack2bit_torch(packed_blk, n)                 # (Lb, N) int8
    obs = x != MISSING
    xf = torch.where(obs, x, 0).to(torch.float32)
    cnt = obs.sum(1).clamp_min(1)
    p = xf.sum(1) / (2.0 * cnt)                          # per-SNP MAF
    p = p.clamp(1e-4, 1 - 1e-4)
    denom = torch.sqrt(2.0 * p * (1.0 - p))
    z = (xf - 2.0 * p[:, None]) / denom[:, None]
    return torch.where(obs, z, 0.0)


def slab_rows(n: int) -> int:
    """SNP rows of a slab: an (Lb, N) f32 slab stays near 1 GB (65,536
    rows, the reference's block, at N <= 4,096). Only the summation order
    of the second pass depends on it."""
    return int(min(65536, max(1, _SLAB_BYTES // (4 * n))))


def _device_of(packed, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if isinstance(packed, torch.Tensor):
        return packed.device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card; pass device='cpu' to run on the "
                           "CPU")
    return torch.device("cuda")


def pca_embedding(packed, n: int, k: int, *, oversample: int = 8,
                  seed: int = 0, block: int | None = None, l_real=None,
                  device=None) -> torch.Tensor:
    """Top-(k-1) PC coordinates of the individuals, (N, k-1) f32, scaled
    by their singular values.

    Randomized range finder (Halko, Martinsson and Tropp): one pass builds
    Y = M Omega (L, r), a QR of Y, a second pass B = Q^T M (r, N), and the
    small SVD of B. M is the (L, N) standardized genotype matrix, made
    slab by slab (`slab_rows(n)` SNPs unless `block`) from the packed
    rows: a tensor (its device is the default) or a host array or
    np.memmap, each slab moved to `device` on demand. device None with a
    host matrix means the first CUDA card (RuntimeError without one).
    """
    dev = _device_of(packed, device)
    l_real = int(l_real if l_real is not None else packed.shape[0])
    block = block or slab_rows(n)
    r = min(max(k - 1, 1) + oversample, n)
    gen = torch.Generator().manual_seed(seed)
    omega = torch.randn((n, r), generator=gen).to(dev)

    def slab(i):
        blk = packed[i:min(i + block, l_real)]
        if not isinstance(blk, torch.Tensor):
            blk = torch.from_numpy(np.ascontiguousarray(blk))
        return _standardized_block(blk.to(dev), n)

    y = torch.cat([slab(i) @ omega for i in range(0, l_real, block)])
    q = torch.linalg.qr(y).Q                             # (L, r)
    b = torch.zeros((r, n), dtype=torch.float32, device=dev)
    for i in range(0, l_real, block):
        b = b + q[i:i + block].T @ slab(i)
    _, s, vt = torch.linalg.svd(b, full_matrices=False)
    dims = max(k - 1, 1)
    return (vt[:dims].T * s[:dims]).to(torch.float32)


def _sq_dist(e: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N, K) squared distances of the rows of e (N, d) to centres c (K, d)."""
    return ((e[:, None, :] - c[None]) ** 2).sum(-1)


def _kmeans(e: torch.Tensor, k: int, seed: int, iters: int = 25,
            first: int | None = None) -> torch.Tensor:
    """Centres (K, d) of k-means on e (N, d), seeded max-min: the first
    centre is row `first` (drawn from `seed` when None), each next the
    row farthest from the centres so far (the first such row). An empty
    cluster's centre becomes the zero vector, as in the reference."""
    n = e.shape[0]
    if first is None:
        first = int(torch.randint(0, n, (), generator=torch.Generator()
                                  .manual_seed(seed)))
    centers = [e[first]]
    d2 = ((e - centers[0]) ** 2).sum(1)
    for _ in range(k - 1):
        centers.append(e[torch.argmax(d2)])
        d2 = torch.minimum(d2, ((e - centers[-1]) ** 2).sum(1))
    c = torch.stack(centers)                             # (K, d)
    for _ in range(iters):
        a = torch.argmin(_sq_dist(e, c), dim=1)
        onehot = torch.nn.functional.one_hot(a, k).to(torch.float32)
        cnt = onehot.sum(0).clamp_min(1.0)
        c = (onehot.T @ e) / cnt[:, None]
    return c


def gamma_from_embedding(e: torch.Tensor, k: int, *, alpha: float,
                         seed: int = 0, strength: float = 5.0,
                         first: int | None = None) -> torch.Tensor:
    """(N, K) gamma = alpha + strength * the soft k-means assignment of
    the embedding e (N, d): a softmax of minus the squared distances over
    their temperature, the mean distance to the assigned centre."""
    c = _kmeans(e, k, seed, first=first)
    d = _sq_dist(e, c)
    tau = d.min(1).values.mean().clamp_min(1e-6)
    soft = torch.softmax(-d / tau, dim=1)
    return (alpha + strength * soft).to(torch.float32)


def spectral_gamma(packed, n: int, k: int, *, alpha: float, seed: int = 0,
                   strength: float = 5.0, l_real=None,
                   device=None) -> torch.Tensor:
    """(N, K) f32 gamma init on the device of `pca_embedding`: alpha +
    strength * the soft cluster assignment in PC space."""
    if k < 2:
        return torch.full((n, k), alpha + strength, dtype=torch.float32,
                          device=_device_of(packed, device))
    e = pca_embedding(packed, n, k, seed=seed, l_real=l_real, device=device)
    return gamma_from_embedding(e, k, alpha=alpha, seed=seed,
                                strength=strength)
