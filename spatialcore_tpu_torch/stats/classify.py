"""Threshold-based cell classification on the SpatialData container.

Port of ``spatialcore_tpu/stats/classify.py`` (``classify_by_threshold``
:86-225): feature extraction from obs / var_names / obsm with colon
syntax, metagene scoring, the KS or GMM threshold, and obs
score / probability / cluster outputs. The numeric path (metagene,
thresholds, full-data posteriors) runs on ``device``
(``stats.thresholding``); the GMM is fitted on the reference's
deterministic ≤ ``max_cells`` subsample (``np_rng(seed,
"classify_subsample")``) and its posteriors are then evaluated on every
cell. The gpairs diagnostic figure is not ported (``plotting``, ROADMAP
Queue 1 item 14d): ``plot=True`` with an ``output_dir`` raises.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import scipy.sparse as sp
import torch

from ..core.logging import get_logger
from ..core.metadata import update_metadata
from ..core.rng import np_rng
from .thresholding import (compute_metagene_score, gmm_posterior,
                           threshold_gmm, threshold_ks)

logger = get_logger("stats.classify")

Device = Union[str, torch.device]

_GEOMETRIC_METHODS = ("geometric_mean", "shifted_geometric_mean")


def _column(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    elif sp.issparse(x):
        x = x.toarray()
    return np.asarray(x, dtype=np.float32).ravel()


def _extract_features(adata, feature_columns: List[str]) -> np.ndarray:
    """Resolve feature names to a dense [N, F] float32 matrix.

    Resolution order per name: obs column → var_names gene → obsm key
    (first column) → colon syntax ``"obsm_key:GENE"`` (the gene resolved
    through ``uns[f"{key}_params"]["genes"]``) or ``"obsm_key:3"`` (a
    column index).
    """
    cols = []
    for name in feature_columns:
        if name in adata.obs.columns:
            cols.append(np.asarray(adata.obs[name], dtype=np.float32))
            continue
        if name in adata.var_names:
            cols.append(_column(adata.X[:, adata.var_names.get_loc(name)]))
            continue
        if name in adata.obsm:
            cols.append(_column(adata.obsm[name][:, 0]))
            continue
        if ":" in name:
            base, sel = name.rsplit(":", 1)
            if base not in adata.obsm:
                raise ValueError(
                    f"Feature '{name}': obsm key '{base}' not found.")
            mat = adata.obsm[base]
            if sel.lstrip("-").isdigit():
                j = int(sel)
                if not (0 <= j < mat.shape[1]):
                    raise ValueError(
                        f"Feature '{name}': column index {j} out of range "
                        f"for obsm['{base}'] with {mat.shape[1]} columns.")
            else:
                params = adata.uns.get(f"{base}_params", {})
                genes = list(params.get("genes", []))
                if sel not in genes:
                    raise ValueError(
                        f"Feature '{name}': gene '{sel}' not found in "
                        f"uns['{base}_params']['genes'].")
                j = genes.index(sel)
            cols.append(_column(mat[:, j]))
            continue
        raise ValueError(
            f"Feature '{name}' not found in adata.obs, adata.var_names, or "
            "adata.obsm (colon syntax: 'obsm_key:GENE' or 'obsm_key:IDX').")
    return np.column_stack(cols)


def classify_by_threshold(
    adata,
    feature_columns: List[str],
    metagene_method: str = "shifted_geometric_mean",
    threshold_method: str = "gmm",
    pseudocount: float = 0.1,
    background_quantile: float = 0.5,
    probability_cutoff: float = 0.3,
    n_components: int = 2,
    max_cells: int = 20000,
    column_prefix: str = "threshold",
    seed: int = 42,
    plot: bool = True,
    output_dir: Optional[Union[str, Path]] = None,
    n_sample_plot: int = 20000,
    copy: bool = False,
    device: Device = "cuda",
):
    """Classify cells as high/low by thresholding a (meta)gene score.

    One feature is thresholded directly; several are first combined into a
    joint-elevation metagene. Writes ``obs[f"{prefix}_score" /
    "_probability" / "_cluster"]`` (cluster −1 for non-finite cells) and
    ``uns[f"{prefix}_params"]``. Scores, thresholds and posteriors run on
    ``device``.
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    if not feature_columns:
        raise ValueError("feature_columns must be a non-empty list")
    if threshold_method not in ("ks", "gmm"):
        raise ValueError(
            f"threshold_method must be 'ks' or 'gmm', got '{threshold_method}'")
    if plot and output_dir is None:
        logger.warning("plot=True but output_dir not set; skipping plot")
        plot = False
    if plot:
        raise NotImplementedError(
            "classify_by_threshold(plot=True) draws its gpairs figure with "
            "the plotting module, which is not ported yet (ROADMAP Queue 1 "
            "item 14d); pass plot=False")

    feats = _extract_features(adata, feature_columns)
    n_cells, n_feats = feats.shape
    valid = np.isfinite(feats).all(axis=1)
    n_valid = int(valid.sum())
    if n_valid < 100:
        raise ValueError(
            f"Only {n_valid} cells have valid (finite) feature values; "
            "at least 100 required for threshold estimation.")
    if n_valid < n_cells:
        logger.warning(f"{n_cells - n_valid} cells have NaN/Inf features; "
                       "they get cluster = -1")

    if n_feats == 1:
        scores_valid = torch.as_tensor(feats[valid, 0], device=device)
    else:
        if metagene_method in _GEOMETRIC_METHODS and (feats[valid] < 0).any():
            raise ValueError(
                f"Negative feature values are incompatible with "
                f"metagene_method='{metagene_method}'. Use "
                "'arithmetic_mean'/'median'/'minimum' or shift features.")
        scores_valid = compute_metagene_score(
            feats[valid], method=metagene_method, pseudocount=pseudocount,
            device=device)

    frac_zero = float((scores_valid == 0).float().mean())
    if threshold_method == "gmm" and frac_zero >= 0.5:
        logger.warning(
            f"{frac_zero:.0%} of scores are exactly zero — sparse marker. "
            "GMM may fit the zero spike; consider threshold_method='ks'.")

    if threshold_method == "ks":
        threshold, probability, method_params = threshold_ks(
            scores_valid, background_quantile=background_quantile)
        clusters_valid = (scores_valid > threshold).cpu().numpy().astype(
            np.int64)
    else:
        fit_scores = scores_valid
        if n_valid > max_cells:
            sub = np_rng(seed, "classify_subsample").choice(
                n_valid, size=max_cells, replace=False)
            fit_scores = scores_valid[torch.as_tensor(
                sub, device=scores_valid.device)]
        threshold, _, _, method_params = threshold_gmm(
            fit_scores, probability_cutoff=probability_cutoff,
            n_components=n_components, seed=seed)
        post = gmm_posterior(scores_valid, method_params.pop("gmm_model"))
        if n_components == 2:
            probability = post[:, method_params["high_component_idx"]]
        else:
            order = method_params["sorted_component_indices"]
            probability = post[:, torch.as_tensor(
                order[1:], device=post.device)].sum(dim=1)
        probability = probability.cpu().numpy()
        clusters_valid = (probability > probability_cutoff).astype(np.int64)

    scores = np.full(n_cells, np.nan, np.float32)
    probs = np.full(n_cells, np.nan, np.float32)
    clusters = np.full(n_cells, -1, np.int64)
    scores[valid] = scores_valid.cpu().numpy()
    probs[valid] = probability
    clusters[valid] = clusters_valid

    n_high = int((clusters == 1).sum())
    n_low = int((clusters == 0).sum())
    adata.obs[f"{column_prefix}_score"] = scores
    adata.obs[f"{column_prefix}_probability"] = probs
    adata.obs[f"{column_prefix}_cluster"] = clusters
    adata.uns[f"{column_prefix}_params"] = {
        "threshold": float(threshold),
        "feature_columns": list(feature_columns),
        "metagene_method": None if n_feats == 1 else metagene_method,
        "threshold_method": threshold_method,
        "n_high": n_high,
        "n_low": n_low,
        "n_invalid": n_cells - n_valid,
        "seed": seed,
        **method_params,
    }
    logger.info(
        f"classify_by_threshold[{column_prefix}]: threshold={threshold:.4f}, "
        f"{n_high:,} high / {n_low:,} low / {n_cells - n_valid:,} invalid "
        f"({time.time() - start:.1f}s)")
    update_metadata(
        adata, "classify_by_threshold",
        parameters={"feature_columns": list(feature_columns),
                    "metagene_method": metagene_method,
                    "threshold_method": threshold_method,
                    "n_components": n_components, "seed": seed},
        outputs={"obs": [f"{column_prefix}_score",
                         f"{column_prefix}_probability",
                         f"{column_prefix}_cluster"],
                 "uns": f"{column_prefix}_params"})
    return adata
