"""Expression-matrix normalization: detection and application.

Port of ``spatialcore_tpu/core/normalization.py`` (numpy / scipy, host
side, as in the reference). Detection searches raw counts across
``layers[counts/raw_counts/raw]`` → ``raw.X`` → ``X`` (≥95% of non-zero
values integer-like within 1e-6), then classifies ``X`` as
``raw / log1p_10k / log1p_cpm / log1p_other / linear / negative / unknown``
using expm1 row-sum reversal with ±20% tolerance around 10k / 1M targets.
The application side is the scanpy-free ``normalize_total`` + ``log1p``.
Detection reads a sample of rows; a tensor's sample is read back from its
device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import scipy.sparse as sp
import torch

from .logging import get_logger

logger = get_logger("core.normalization")

RAW_COUNT_LAYERS = ["counts", "raw_counts", "raw"]


def _sample_dense(matrix, sample_size: int) -> np.ndarray:
    """The first ``sample_size`` rows on the host (a tensor's read back
    from its device)."""
    n = min(sample_size, matrix.shape[0])
    sub = matrix[:n]
    if isinstance(sub, torch.Tensor):
        return sub.detach().cpu().numpy()
    return sub.toarray() if sp.issparse(sub) else np.asarray(sub)


def _integer_fraction(values: np.ndarray, tolerance: float) -> float:
    if values.size == 0:
        return 0.0
    remainder = np.abs(np.mod(values, 1.0))
    near_int = (remainder < tolerance) | (remainder > 1.0 - tolerance)
    return float(np.mean(near_int))


def _check_raw_counts(
    matrix,
    sample_size: int = 10000,
    integer_tolerance: float = 1e-6,
    integer_threshold: float = 0.95,
) -> Dict[str, Any]:
    """Is this matrix raw counts? (non-negative, ≥threshold integer-like)."""
    sample = _sample_dense(matrix, sample_size)
    nonzero = sample[sample != 0]
    if nonzero.size == 0:
        return {"is_raw": False, "fraction_integer": 0.0,
                "min_val": 0.0, "max_val": 0.0, "reason": "all_zeros"}
    min_val, max_val = float(sample.min()), float(sample.max())
    if min_val < 0:
        return {"is_raw": False, "fraction_integer": 0.0,
                "min_val": min_val, "max_val": max_val, "reason": "negative_values"}
    frac = _integer_fraction(nonzero, integer_tolerance)
    return {"is_raw": frac >= integer_threshold, "fraction_integer": frac,
            "min_val": min_val, "max_val": max_val, "reason": "integer_check"}


def _estimate_target_sum(matrix, sample_size: int = 1000) -> Dict[str, Any]:
    """Reverse log1p and inspect row sums to recover the normalization target."""
    sample = _sample_dense(matrix, sample_size)
    row_sums = np.expm1(sample).sum(axis=1)
    row_sums = row_sums[row_sums > 0]
    if row_sums.size == 0:
        return {"estimated_target_sum": 0.0, "target_sum_std": 0.0,
                "is_log1p_10k": False, "is_log1p_cpm": False}
    median_sum = float(np.median(row_sums))
    return {
        "estimated_target_sum": median_sum,
        "target_sum_std": float(np.std(row_sums)),
        "is_log1p_10k": 8_000 < median_sum < 12_000,
        "is_log1p_cpm": 800_000 < median_sum < 1_200_000,
    }


def find_raw_counts_source(
    adata,
    sample_size: int = 10000,
    integer_tolerance: float = 1e-6,
    integer_threshold: float = 0.95,
) -> Optional[str]:
    """Search layers (priority order) → raw.X → X for raw counts."""
    for layer in RAW_COUNT_LAYERS:
        if layer in adata.layers:
            res = _check_raw_counts(adata.layers[layer], sample_size,
                                    integer_tolerance, integer_threshold)
            if res["is_raw"]:
                return f"layers/{layer}"
    if adata.raw is not None:
        if _check_raw_counts(adata.raw.X, sample_size,
                             integer_tolerance, integer_threshold)["is_raw"]:
            return "raw.X"
    if adata.X is not None:
        if _check_raw_counts(adata.X, sample_size,
                             integer_tolerance, integer_threshold)["is_raw"]:
            return "X"
    return None


def check_normalization_status(
    adata,
    sample_size: int = 1000,
    integer_tolerance: float = 1e-6,
    integer_threshold: float = 0.95,
) -> Dict[str, Any]:
    """Detect the normalization state of ``adata.X``.

    Returns a dict with ``raw_source``, ``x_state``, ``x_target_sum``,
    ``is_usable`` (raw counts found anywhere OR X verified log1p_10k),
    ``has_log1p_uns`` and diagnostic ``stats``.
    """
    raw_source = find_raw_counts_source(
        adata, sample_size * 10, integer_tolerance, integer_threshold)

    sample = _sample_dense(adata.X, sample_size)
    if sample.size == 0:
        raise ValueError(
            "Cannot check normalization status of empty data (0 cells or 0 genes)")

    mean_val, max_val, min_val = (float(sample.mean()), float(sample.max()),
                                  float(sample.min()))
    x_check = _check_raw_counts(adata.X, sample_size * 10,
                                integer_tolerance, integer_threshold)
    stats = {"mean": mean_val, "max": max_val, "min": min_val,
             "fraction_integer": x_check["fraction_integer"]}

    x_target_sum = None
    if x_check["is_raw"]:
        x_state = "raw"
    elif min_val < 0:
        x_state = "negative"
    elif max_val < 25 and mean_val < 10 and min_val >= 0:
        info = _estimate_target_sum(adata.X, sample_size)
        x_target_sum = info["estimated_target_sum"]
        if info["is_log1p_10k"]:
            x_state = "log1p_10k"
        elif info["is_log1p_cpm"]:
            x_state = "log1p_cpm"
        elif x_target_sum > 0:
            x_state = "log1p_other"
        else:
            x_state = "unknown"
        stats["estimated_target_sum"] = x_target_sum
    elif max_val > 25 and x_check["fraction_integer"] < 0.5:
        x_state = "linear"
    else:
        x_state = "unknown"

    return {
        "raw_source": raw_source,
        "x_state": x_state,
        "x_target_sum": x_target_sum,
        "is_usable": (raw_source is not None) or (x_state == "log1p_10k"),
        "has_log1p_uns": "log1p" in adata.uns,
        "stats": stats,
    }


# ---------------------------------------------------------------------------
# Application: the scanpy-free normalize_total / log1p pair
# ---------------------------------------------------------------------------

def normalize_total(adata, target_sum: float = 1e4, layer: Optional[str] = None,
                    inplace: bool = True):
    """Scale each cell so its counts sum to ``target_sum`` (CP10K by default)."""
    X = adata.get_matrix(layer)
    if sp.issparse(X):
        X = X.tocsr().astype(np.float32)
        sums = np.asarray(X.sum(axis=1)).ravel()
        sums[sums == 0] = 1.0
        scale = (target_sum / sums).astype(np.float32)
        X = sp.diags(scale) @ X
    else:
        X = np.asarray(X, dtype=np.float32)
        sums = X.sum(axis=1, keepdims=True)
        sums[sums == 0] = 1.0
        X = X * (target_sum / sums)
    if inplace:
        if layer is None:
            adata.X = X
        else:
            adata.layers[layer] = X
        return adata
    return X


def log1p(adata, layer: Optional[str] = None, inplace: bool = True):
    """Natural-log transform ``log(1 + x)``; records ``uns['log1p']``."""
    X = adata.get_matrix(layer)
    if sp.issparse(X):
        X = X.copy().astype(np.float32)
        X.data = np.log1p(X.data)
    else:
        X = np.log1p(np.asarray(X, dtype=np.float32))
    if inplace:
        if layer is None:
            adata.X = X
        else:
            adata.layers[layer] = X
        adata.uns["log1p"] = {"base": None}
        return adata
    return X


def normalize_log1p_from_raw(adata, target_sum: float = 1e4) -> None:
    """Re-derive log1p(CP-target) X from the detected raw-count source.

    Raises if no raw counts can be found (fail-loud).
    """
    source = find_raw_counts_source(adata)
    if source is None:
        raise ValueError(
            "No raw counts found in layers[counts/raw_counts/raw], raw.X or X; "
            "cannot re-normalize. Pass data that carries raw counts.")
    if source.startswith("layers/"):
        X = adata.layers[source.split("/", 1)[1]]
    elif source == "raw.X":
        raw = adata.raw
        idx = raw.var_names.get_indexer(adata.var_names)
        if (idx < 0).any():
            raise ValueError("raw.X does not contain all current var_names")
        X = raw.X[:, idx]
    else:
        X = adata.X
    adata.X = X.copy() if sp.issparse(X) else np.array(X, copy=True)
    normalize_total(adata, target_sum=target_sum)
    log1p(adata)
