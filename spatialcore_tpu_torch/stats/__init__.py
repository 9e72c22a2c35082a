"""Threshold-based classification on metagene scores, and the Wilcoxon
rank-sum DEG test.

Port of ``spatialcore_tpu/stats``: ``classify_by_threshold``,
``rank_genes_groups``, and the numeric kernels of ``thresholding``
(metagene aggregation, the KS-style and GMM thresholds), in torch ops on
the card.
"""

from .classify import classify_by_threshold
from .deg import rank_genes_groups
from .thresholding import (
    GMM1D,
    compute_metagene_score,
    gmm_posterior,
    threshold_gmm,
    threshold_ks,
)

__all__ = [
    "classify_by_threshold",
    "rank_genes_groups",
    "compute_metagene_score",
    "threshold_ks",
    "threshold_gmm",
    "gmm_posterior",
    "GMM1D",
]
