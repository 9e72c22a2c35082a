"""Sparse per-gene moments without densification.

Port of ``spatialcore_tpu/utils/sparse.py`` (numpy / scipy): mean/var/std
per gene via ``var = E[X²] − E[X]²`` on the sparse data array, so a
[1M × 18k] CSR never densifies.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp


def sparse_gene_moments(X, ddof: int = 0) -> Tuple[np.ndarray, np.ndarray,
                                                   np.ndarray]:
    """(mean, var, std) per column for sparse or dense X [N, G]."""
    n = X.shape[0]
    if sp.issparse(X):
        Xc = X.tocsc() if not sp.isspmatrix_csc(X) else X
        mean = np.asarray(Xc.mean(axis=0)).ravel()
        sq = Xc.copy()
        sq.data = sq.data ** 2
        ex2 = np.asarray(sq.mean(axis=0)).ravel()
        var = ex2 - mean ** 2
    else:
        X = np.asarray(X)
        mean = X.mean(axis=0)
        var = (X ** 2).mean(axis=0) - mean ** 2
    if ddof:
        var = var * n / max(n - ddof, 1)
    var = np.maximum(var, 0.0)
    return mean, var, np.sqrt(var)
