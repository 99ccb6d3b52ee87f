"""MCMC convergence diagnostics: split-R-hat and bulk ESS (the port's copy
of terastructure_tpu/mcmc/diagnostics.py; numpy and scipy only).

Standard definitions (Vehtari et al. 2021, "Rank-normalization, folding,
and localization"): chains are split in half, R-hat compares between- to
within-half variance, ESS integrates autocorrelations via Geyer's
initial monotone positive sequence. Pure numpy — diagnostics run
host-side on gathered samples.
"""

from __future__ import annotations

import numpy as np


def _split_chains(x: np.ndarray) -> np.ndarray:
    """(chains, draws, ...) -> (2*chains, draws//2, ...)."""
    c, n = x.shape[:2]
    n2 = n // 2
    return np.concatenate([x[:, :n2], x[:, n2:2 * n2]], axis=0)


def split_rhat(samples: np.ndarray) -> np.ndarray:
    """Split-R-hat. samples: (chains, draws, ...) -> (...)."""
    x = _split_chains(np.asarray(samples, np.float64))
    m, n = x.shape[:2]
    chain_mean = x.mean(axis=1)                       # (m, ...)
    chain_var = x.var(axis=1, ddof=1)                 # (m, ...)
    w = chain_var.mean(axis=0)
    b = n * chain_mean.var(axis=0, ddof=1)
    var_hat = (n - 1) / n * w + b / n
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sqrt(var_hat / w)


def _rank_normalize(x: np.ndarray) -> np.ndarray:
    """Fractional ranks -> normal scores over the pooled draws
    (Vehtari et al. 2021 eq. 14): rank across ALL chains jointly, map
    through the normal quantile function. Makes R-hat scale-free AND
    robust to heavy tails / nonlinear parameterizations."""
    from scipy.special import ndtri

    c, n = x.shape[:2]
    flat = x.reshape(c * n, -1)
    ranks = np.empty_like(flat)
    order = np.argsort(flat, axis=0)
    np.put_along_axis(
        ranks, order,
        np.broadcast_to(np.arange(1, c * n + 1, dtype=np.float64)[:, None],
                        flat.shape).copy(), axis=0)
    z = ndtri((ranks - 0.375) / (c * n + 0.25))
    return z.reshape(x.shape)


def rank_normalized_rhat(samples: np.ndarray) -> np.ndarray:
    """Max of the rank-normalized split-R-hat on the draws and on the
    FOLDED draws |x - median| (bulk + tail sensitivity, Vehtari et al.
    2021's recommended diagnostic)."""
    x = np.asarray(samples, np.float64)
    bulk = split_rhat(_rank_normalize(x))
    folded = np.abs(x - np.median(x.reshape(-1, *x.shape[2:]), axis=0))
    tail = split_rhat(_rank_normalize(folded))
    return np.maximum(bulk, tail)


def ess(samples: np.ndarray) -> np.ndarray:
    """Bulk effective sample size. samples: (chains, draws, ...) -> (...)."""
    x = _split_chains(np.asarray(samples, np.float64))
    m, n = x.shape[:2]
    flat_shape = x.shape[2:]
    x = x.reshape(m, n, -1)
    out = np.empty(x.shape[2])
    for p in range(x.shape[2]):
        xraw = x[:, :, p]
        # Chain means/vars from the UNCENTERED split chains (Vehtari et al.
        # 2021 eq. 3-4): B/n is the variance of per-chain means, which
        # vanishes if computed after per-chain centering.
        chain_means = xraw.mean(axis=1)
        b_over_n = chain_means.var(ddof=1) if m > 1 else 0.0
        xc = xraw - chain_means[:, None]
        # per-chain autocovariance via FFT
        fsize = 2 * n
        f = np.fft.rfft(xc, fsize, axis=1)
        acov = np.fft.irfft(f * np.conj(f), fsize, axis=1)[:, :n].real / n
        chain_var = acov[:, 0] * n / (n - 1.0)
        w = chain_var.mean()
        if w == 0:
            out[p] = float("nan")
            continue
        mean_acov = acov.mean(axis=0)
        var_hat = (n - 1) / n * w + b_over_n
        rho = 1.0 - (w - mean_acov) / var_hat
        # Geyer initial monotone positive sequence
        t = 1
        rho_sum = 0.0
        prev = np.inf
        while t + 1 < n:
            pair = rho[t] + rho[t + 1]
            if pair < 0:
                break
            pair = min(pair, prev)
            prev = pair
            rho_sum += pair
            t += 2
        tau = 1.0 + 2.0 * rho_sum
        out[p] = m * n / max(tau, 1e-12)
    return out.reshape(flat_shape) if flat_shape else out[0]


def summarize(samples: dict, max_params: int = 0) -> dict:
    """Per-entry worst-case R-hat / min ESS for a dict of
    (chains, draws, ...) arrays (nested dicts are walked, their keys
    joined with "/")."""
    report = {}
    for name, leaf in _flatten(samples):
        arr = np.asarray(leaf)
        if max_params and arr[0, 0].size > max_params:
            flat = arr.reshape(arr.shape[0], arr.shape[1], -1)
            sel = np.linspace(0, flat.shape[2] - 1, max_params).astype(int)
            arr = flat[:, :, sel]
        r = split_rhat(arr)
        rr = rank_normalized_rhat(arr)
        e = ess(arr)
        report[name] = {
            "max_rhat": float(np.nanmax(r)),
            "max_rank_rhat": float(np.nanmax(rr)),
            "min_ess": float(np.nanmin(e)),
        }
    return report


def _flatten(tree, prefix=""):
    """(name, array) pairs of a dict of arrays, keys in sorted order (the
    order of the reference's tree walk)."""
    for key in sorted(tree):
        name = f"{prefix}{key}"
        if isinstance(tree[key], dict):
            yield from _flatten(tree[key], name + "/")
        else:
            yield name, tree[key]
