"""Label-switching alignment for comparing admixture estimates (the port's
copy of terastructure_tpu/utils/labels.py; numpy and scipy only).

The PSD posterior is invariant to permuting the K populations, so a
comparison of theta-hat across runs or against the truth first aligns
columns: the assignment is solved with scipy's Hungarian method on the
column-wise L1 distance matrix.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def align_columns(est: np.ndarray, ref: np.ndarray):
    """Permute columns of `est` (N, K) to best match `ref` (N, K).

    Returns (est_aligned, perm) where est_aligned = est[:, perm].
    """
    est = np.asarray(est, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    k = est.shape[1]
    cost = np.zeros((k, k))
    for a in range(k):
        cost[a] = np.abs(est[:, a:a + 1] - ref).mean(axis=0)
    row, col = linear_sum_assignment(cost)
    perm = np.empty(k, dtype=int)
    perm[col] = row
    return est[:, perm], perm


def mean_abs_theta_error(est: np.ndarray, ref: np.ndarray) -> float:
    """Mean |theta_hat - theta_true| after optimal column alignment."""
    aligned, _ = align_columns(est, ref)
    return float(np.abs(aligned - ref).mean())
