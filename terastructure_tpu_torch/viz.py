"""STRUCTURE-style admixture plot (a copy of terastructure_tpu/viz.py).

The classic stacked-bar admixture plot from theta.txt, from a run
directory or a theta matrix. matplotlib is imported where the plot is
drawn: the rest of the port does not need it.

CLI: python -m terastructure_tpu_torch.viz <run_dir|theta.txt> [-o out.png]
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def sort_by_dominant(theta: np.ndarray) -> np.ndarray:
    """Order individuals by dominant population then by its weight —
    the conventional STRUCTURE plot ordering."""
    dom = theta.argmax(axis=1)
    order = np.lexsort((-theta[np.arange(len(theta)), dom], dom))
    return order


def plot_admixture(
    theta: np.ndarray,
    *,
    labels: Optional[Sequence] = None,
    sort: bool = True,
    ax=None,
    title: Optional[str] = None,
):
    """Stacked-bar admixture plot. theta: (N, K) rows on the simplex."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    theta = np.asarray(theta)
    n, k = theta.shape
    order = sort_by_dominant(theta) if sort else np.arange(n)
    th = theta[order]

    if ax is None:
        _, ax = plt.subplots(figsize=(max(6, min(20, n / 25)), 3))
    bottom = np.zeros(n)
    x = np.arange(n)
    cmap = plt.get_cmap("tab20" if k > 10 else "tab10")
    for j in range(k):
        ax.bar(x, th[:, j], bottom=bottom, width=1.0,
               color=cmap(j % cmap.N), linewidth=0)
        bottom += th[:, j]
    ax.set_xlim(-0.5, n - 0.5)
    ax.set_ylim(0, 1)
    ax.set_ylabel("ancestry fraction")
    ax.set_xlabel("individuals")
    if title:
        ax.set_title(title)
    if labels is not None:
        ticks = np.linspace(0, n - 1, min(20, n)).astype(int)
        ax.set_xticks(ticks)
        ax.set_xticklabels([str(labels[order[t]]) for t in ticks],
                           rotation=90, fontsize=6)
    return ax


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="STRUCTURE-style admixture plot")
    ap.add_argument("source", help="run dir (with theta.txt) or a theta.txt")
    ap.add_argument("-o", "--out", default="admixture.png")
    ap.add_argument("--no-sort", action="store_true")
    args = ap.parse_args(argv)

    from terastructure_tpu_torch.io.export import load_matrix

    path = args.source
    if os.path.isdir(path):
        path = os.path.join(path, "theta.txt")
    theta = load_matrix(path)
    ax = plot_admixture(theta, sort=not args.no_sort,
                        title=os.path.basename(os.path.dirname(path) or path))
    ax.figure.savefig(args.out, dpi=150, bbox_inches="tight")
    print(args.out)


if __name__ == "__main__":
    main()
