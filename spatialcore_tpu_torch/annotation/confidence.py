"""Confidence transforms and post-annotation filters.

Port of ``spatialcore_tpu/annotation/confidence.py``:
``transform_confidence``, ``extract_decision_scores``,
``filter_low_confidence``, ``filter_low_count_types``, the dual-threshold
``filter_by_marker_validation`` (:177-248: a 3-component GMM of each cell
type's canonical-marker metagene, ``stats.thresholding``, on the card) and
``compute_confidence_from_obsm``. The transforms run in float64 on the
scores' device (the reference's numpy float64 on the host).
"""

from __future__ import annotations

from typing import Literal, Optional, Union

import numpy as np
import pandas as pd
import torch

from ..core.compat import param_aliases
from ..core.container import dense_f32
from ..core.logging import get_logger
from ..core.metadata import update_metadata

logger = get_logger("annotation.confidence")

Device = Union[str, torch.device]

ConfidenceMethod = Literal["raw", "zscore", "softmax", "minmax"]

UNASSIGNED = "Unassigned"


def transform_confidence(
    decision_scores,
    method: ConfidenceMethod = "zscore",
) -> np.ndarray:
    """Per-cell confidence (float64 [N]) from a [N, C] decision-score
    matrix, a tensor (computed on its device) or an array.

    ``zscore``: sigmoid of the winning score's z across the row — high when
    one type clearly dominates, low when scores are flat, whatever the
    logit scale. ``softmax`` / ``minmax`` as named; ``raw`` returns the
    winning score unbounded.
    """
    scores = torch.as_tensor(decision_scores).to(torch.float64)
    if scores.ndim != 2:
        raise ValueError(
            f"Expected (n_cells, n_types) scores, got shape "
            f"{tuple(scores.shape)}")
    c = scores.shape[1]
    if c < 2:
        raise ValueError(f"Expected at least 2 cell types, got {c}")
    winning, win_idx = scores.max(dim=1)
    if method == "raw":
        out = winning
    elif method == "zscore":
        mu = scores.mean(dim=1)
        sd = scores.std(dim=1, unbiased=False)
        sd = torch.where(sd < 1e-10, 1.0, sd)
        out = 1.0 / (1.0 + torch.exp(-(winning - mu) / sd))
    elif method == "softmax":
        e = torch.exp(scores - winning[:, None])
        out = e.gather(1, win_idx[:, None])[:, 0] / e.sum(dim=1)
    elif method == "minmax":
        lo = scores.min(dim=1).values
        rng = torch.where(winning - lo < 1e-10, 1.0, winning - lo)
        out = (winning - lo) / rng
    else:
        raise ValueError(
            f"Unknown confidence method '{method}' "
            "(expected raw/zscore/softmax/minmax)")
    return out.cpu().numpy()


def extract_decision_scores(
    adata,
    celltypist_result=None,
    key_added: str = "celltypist",
    copy: bool = False,
    key: Optional[str] = None,
):
    """Decision-score matrix plumbing, both directions.

    Reference form: pass an annotation result object (anything with
    ``.decision_matrix`` and ``.cell_types``) and its scores are STORED
    under ``obsm[f"{key_added}_decision_scores"]`` /
    ``uns[f"{key_added}_cell_types"]``; returns the adata.

    The other form, ``extract_decision_scores(adata, key)``, READS
    ``obsm[key]`` and returns ``(scores [N, C], classes)``.
    """
    if isinstance(celltypist_result, str) and key is None:
        celltypist_result, key = None, celltypist_result
    if celltypist_result is not None:
        if copy:
            adata = adata.copy()
        matrix = getattr(celltypist_result, "decision_matrix", None)
        if matrix is None:
            raise ValueError(
                "celltypist_result must expose .decision_matrix")
        classes = list(getattr(celltypist_result, "cell_types", None)
                       if getattr(celltypist_result, "cell_types", None)
                       is not None else getattr(matrix, "columns", []))
        scores = np.asarray(matrix, dtype=np.float32)
        store = f"{key_added}_decision_scores"
        adata.obsm[store] = scores
        adata.uns[f"{key_added}_cell_types"] = classes
        adata.uns[f"{store}_classes"] = classes
        return adata
    key = key or "cell_type_decision_scores"
    if key not in adata.obsm:
        raise KeyError(
            f"adata.obsm['{key}'] not found; run annotation first.")
    scores = adata.obsm[key]
    classes = list(adata.uns.get(f"{key}_classes", []))
    if len(classes) != scores.shape[1]:
        raise ValueError(
            f"Class list in uns['{key}_classes'] has {len(classes)} entries "
            f"but scores have {scores.shape[1]} columns.")
    return scores, classes


@param_aliases(label_column="cell_type_column")
def filter_low_confidence(
    adata,
    confidence_column: str = "cell_type_confidence",
    cell_type_column: str = "cell_type",
    threshold: float = 0.8,
    unassigned_label: str = UNASSIGNED,
    copy: bool = False,
):
    """Relabel cells below the confidence threshold as Unassigned."""
    if copy:
        adata = adata.copy()
    for col in (confidence_column, cell_type_column):
        if col not in adata.obs.columns:
            raise ValueError(f"Column '{col}' not found in obs")
    low = adata.obs[confidence_column].to_numpy(float) < threshold
    labels = adata.obs[cell_type_column].astype(str).to_numpy(object)
    labels[low] = unassigned_label
    adata.obs[cell_type_column] = pd.Categorical(labels)
    logger.info(f"filter_low_confidence: {int(low.sum()):,}/{len(low):,} "
                f"cells → {unassigned_label} (threshold {threshold})")
    update_metadata(adata, "filter_low_confidence",
                    parameters={"threshold": threshold,
                                "confidence_column": confidence_column},
                    outputs={"obs": cell_type_column})
    return adata


@param_aliases(label_column="cell_type_column")
def filter_low_count_types(
    adata,
    cell_type_column: str = "cell_type",
    min_cells: int = 20,
    unassigned_label: str = UNASSIGNED,
    copy: bool = False,
):
    """Relabel cell types with fewer than ``min_cells`` as Unassigned."""
    if copy:
        adata = adata.copy()
    if cell_type_column not in adata.obs.columns:
        raise ValueError(f"Column '{cell_type_column}' not found in obs")
    labels = adata.obs[cell_type_column].astype(str)
    counts = labels.value_counts()
    small = set(counts[counts < min_cells].index) - {unassigned_label}
    if small:
        logger.info(f"filter_low_count_types: dropping {len(small)} types "
                    f"below {min_cells} cells: {sorted(small)[:5]}")
        arr = labels.to_numpy(object)
        arr[labels.isin(small).to_numpy()] = unassigned_label
        adata.obs[cell_type_column] = pd.Categorical(arr)
    update_metadata(adata, "filter_low_count_types",
                    parameters={"min_cells": min_cells},
                    outputs={"obs": cell_type_column})
    return adata


@param_aliases(label_column="cell_type_column", canonical_markers="markers")
def filter_by_marker_validation(
    adata,
    cell_type_column: str = "cell_type",
    confidence_column: str = "cell_type_confidence",
    markers: Optional[dict] = None,
    confidence_threshold: float = 0.8,
    marker_probability_threshold: float = 0.3,
    min_cells_per_type: int = 100,
    unassigned_label: str = UNASSIGNED,
    seed: int = 42,
    copy: bool = False,
    n_components: int = 3,
    device: Device = "cuda",
):
    """Dual-threshold QC: keep a cell only if its annotation confidence OR
    its canonical-marker metagene probability passes.

    For each cell type with known markers (≥ 2 in the panel) and ≥
    ``min_cells_per_type`` cells, a 3-component GMM (trimodal spatial
    mode) is fitted on ``device`` to the shifted-geometric-mean marker
    metagene of that type's cells; cells failing both gates are relabeled.
    """
    from ..stats.thresholding import compute_metagene_score, threshold_gmm
    from .markers import load_canonical_markers

    if copy:
        adata = adata.copy()
    if markers is None:
        markers = load_canonical_markers()
    labels = adata.obs[cell_type_column].astype(str)
    conf = adata.obs[confidence_column].to_numpy(float)
    var_index = {g: i for i, g in enumerate(adata.var_names)}
    relabel = np.zeros(adata.n_obs, bool)
    validated_types = []
    for ct in labels.unique():
        if ct == unassigned_label:
            continue
        genes = [g for g in markers.get(ct, []) if g in var_index]
        cells = np.nonzero((labels == ct).to_numpy())[0]
        if len(genes) < 2 or cells.size < min_cells_per_type:
            continue
        sub = dense_f32(adata.X, device, rows=cells,
                        cols=[var_index[g] for g in genes])
        score = compute_metagene_score(sub, "shifted_geometric_mean")
        _, _, prob_high, _ = threshold_gmm(score, n_components=n_components,
                                           seed=seed)
        fail = (prob_high < marker_probability_threshold) & \
               (conf[cells] < confidence_threshold)
        relabel[cells[fail]] = True
        validated_types.append(ct)
        logger.info(f"  {ct}: {len(genes)} markers, "
                    f"{int(fail.sum()):,}/{cells.size:,} failed dual gate")
    arr = labels.to_numpy(object)
    arr[relabel] = unassigned_label
    adata.obs[cell_type_column] = pd.Categorical(arr)
    logger.info(f"filter_by_marker_validation: {int(relabel.sum()):,} cells "
                f"→ {unassigned_label} across {len(validated_types)} types")
    update_metadata(adata, "filter_by_marker_validation",
                    parameters={
                        "confidence_threshold": confidence_threshold,
                        "marker_probability_threshold":
                            marker_probability_threshold,
                        "validated_types": validated_types},
                    outputs={"obs": cell_type_column})
    return adata


@param_aliases(decision_scores_key="key", confidence_column="out_column")
def compute_confidence_from_obsm(
    adata,
    key: str = "cell_type_decision_scores",
    method: ConfidenceMethod = "zscore",
    out_column: str = "cell_type_confidence",
    copy: bool = False,
):
    """Recompute per-cell confidence from stored decision scores."""
    if copy:
        adata = adata.copy()
    scores, _ = extract_decision_scores(adata, key)
    adata.obs[out_column] = transform_confidence(scores, method)
    return adata
