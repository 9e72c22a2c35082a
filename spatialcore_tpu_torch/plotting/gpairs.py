"""gpairs-style threshold diagnostic: score histogram + pairwise scatters.

Port of ``spatialcore_tpu/plotting/gpairs.py``, after the original
spatialcore's ``_plot_gpairs``
(the original spatialcore's stats/classify.py:169-416): top panel is the
metagene-score histogram with the threshold line; below, a scatter matrix of
the input features colored by high/low cluster. Sampling for large datasets
is seeded and deterministic.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Union

import numpy as np

from ..core.rng import np_rng
from .utils import save_figure, to_host


def plot_gpairs(
    features: np.ndarray,
    scores: np.ndarray,
    threshold: float,
    clusters: np.ndarray,
    feature_names: List[str],
    path: Union[str, Path],
    n_sample: int = 20000,
    seed: int = 42,
    bins: int = 80,
) -> Path:
    """Render the diagnostic figure and save it to ``path``; the arrays
    may be tensors on any device."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    features, scores, clusters = (to_host(a) for a in (features, scores,
                                                       clusters))
    n, f = features.shape
    if n > n_sample:
        idx = np_rng(seed, "gpairs_sample").choice(n, n_sample, replace=False)
        features, scores, clusters = features[idx], scores[idx], clusters[idx]

    k = max(f, 1)
    fig = plt.figure(figsize=(3.0 * k + 1, 3.0 * k + 3), dpi=110)
    gs = fig.add_gridspec(k + 1, k, height_ratios=[1.2] + [1.0] * k,
                          hspace=0.35, wspace=0.3)

    # Top: score histogram + threshold
    ax = fig.add_subplot(gs[0, :])
    ax.hist(scores, bins=bins, color="#7f7f7f", alpha=0.85)
    ax.axvline(threshold, color="#d62728", lw=2,
               label=f"threshold = {threshold:.3f}")
    frac_high = float((clusters == 1).mean())
    ax.set_title(f"metagene score — {frac_high:.1%} high")
    ax.set_yscale("log")
    ax.legend(frameon=False)

    colors = np.where(clusters == 1, "#d62728", "#1f77b4")
    for i in range(f):
        for j in range(f):
            axi = fig.add_subplot(gs[i + 1, j])
            if i == j:
                axi.hist(features[:, i], bins=bins, color="#1f77b4",
                         alpha=0.8)
                axi.set_yscale("log")
            else:
                axi.scatter(features[:, j], features[:, i], s=2, c=colors,
                            alpha=0.3, rasterized=True, linewidths=0)
            if i == f - 1:
                axi.set_xlabel(feature_names[j], fontsize=8)
            if j == 0:
                axi.set_ylabel(feature_names[i], fontsize=8)
            axi.tick_params(labelsize=7)

    return save_figure(fig, path)
