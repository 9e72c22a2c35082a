"""Cell-type annotation with trained models (single or ensemble).

Port of ``spatialcore_tpu/annotation/annotate.py`` (``annotate_cells``
:78-213, ``annotate_celltypist``, ``TISSUE_MODEL_PRESETS``,
``get_model_gene_overlap``, ``get_annotation_summary``,
``get_models_for_tissue``): model resolution, the gene-overlap gate,
subset-and-renormalize, optional cell batching, multi-model
max-confidence ensembling and the output columns and decision-score
matrix. Scoring runs on ``device``: the overlap renormalization (expm1,
row sums, log1p) runs there in torch ops, and in the reference's host
numpy only when ``device`` is the CPU. Decision scores stay a tensor on
the card in ``obsm`` where X is a CUDA tensor, as the port's other
outputs do.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import pandas as pd
import torch

from ..core.compat import param_aliases
from ..core.container import dense_f32
from ..core.logging import get_logger
from ..core.metadata import update_metadata
from .confidence import ConfidenceMethod, transform_confidence
from .model import CellTypeModel
from .registry import DEFAULT_MODELS_DIR, resolve_model

logger = get_logger("annotation.annotate")

Device = Union[str, torch.device]

#: tissue → suggested model artifact names (train locally or drop into
#: DEFAULT_MODELS_DIR)
TISSUE_MODEL_PRESETS: Dict[str, List[str]] = {
    "lung": ["lung_airway", "lung_parenchyma", "immune_global"],
    "liver": ["liver", "immune_global"],
    "brain": ["brain_cortex", "brain_glia"],
    "heart": ["heart", "immune_global"],
    "kidney": ["kidney", "immune_global"],
    "breast": ["breast", "immune_global"],
    "colon": ["intestine_colon", "immune_global"],
    "intestine": ["intestine_colon", "immune_global"],
    "pancreas": ["pancreas", "immune_global"],
    "skin": ["skin", "immune_global"],
    "blood": ["immune_blood", "immune_global"],
    "bone_marrow": ["immune_bone_marrow", "immune_global"],
    "lymph_node": ["immune_lymphoid", "immune_global"],
    "spleen": ["immune_lymphoid", "immune_global"],
    "tonsil": ["immune_lymphoid", "immune_global"],
}


def get_models_for_tissue(tissue: str) -> List[str]:
    """Suggested model names for a tissue preset."""
    key = tissue.strip().lower().replace(" ", "_")
    if key not in TISSUE_MODEL_PRESETS:
        raise ValueError(
            f"Unknown tissue '{tissue}'. Available: "
            f"{sorted(TISSUE_MODEL_PRESETS)}")
    return TISSUE_MODEL_PRESETS[key]


def _resolve_model(m, models_dir: Path) -> CellTypeModel:
    return m if isinstance(m, CellTypeModel) else resolve_model(
        m, models_dir=models_dir)


def _gene_overlap(model: CellTypeModel, var_names) -> np.ndarray:
    """int32 [n_model_genes] index into var_names (−1 where absent)."""
    pos = {g: i for i, g in enumerate(var_names)}
    return np.array([pos.get(g, -1) for g in model.genes], np.int32)


def _renormalize(xb: torch.Tensor) -> torch.Tensor:
    """log1p(counts / Σ counts · 10⁴) of the panel subset, counts =
    expm1(xb); on the CPU in the reference's numpy float32."""
    if xb.device.type == "cpu":
        counts = np.expm1(xb.numpy())
        tot = counts.sum(axis=1, keepdims=True)
        tot = np.where(tot <= 0, 1.0, tot)
        return torch.from_numpy(np.log1p(counts / tot * 1e4))
    counts = torch.expm1(xb)
    tot = counts.sum(dim=1, keepdim=True)
    tot = torch.where(tot <= 0, 1.0, tot)
    return torch.log1p(counts / tot * 1e4)


def annotate_cells(
    adata,
    models: Union[str, CellTypeModel, Sequence],
    confidence_method: ConfidenceMethod = "zscore",
    min_gene_overlap_pct: float = 25.0,
    batch_size: Optional[int] = None,
    renormalize_overlap: bool = True,
    models_dir: Optional[Union[str, Path]] = None,
    store_decision_scores: bool = True,
    over_clustering: Optional[str] = None,
    copy: bool = False,
    device: Device = "cuda",
):
    """Annotate cells with one model or an ensemble (max confidence wins).

    Outputs: ``obs['cell_type']`` (final label), ``'cell_type_predicted'``,
    ``'cell_type_confidence'`` (transformed), ``'cell_type_confidence_raw'``
    (winning logit), ``'cell_type_model'`` (source model per cell), and
    ``obsm['cell_type_decision_scores']`` (+ class list in uns) for the
    model that won the most cells. Scoring runs on ``device``.
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    models_dir = Path(models_dir) if models_dir else DEFAULT_MODELS_DIR
    if isinstance(models, (str, Path, CellTypeModel)):
        models = [models]
    resolved = [_resolve_model(m, models_dir) for m in models]
    if not resolved:
        raise ValueError("At least one model is required")

    X = adata.X
    on_card = isinstance(X, torch.Tensor) and X.is_cuda
    var_names = list(adata.var_names)
    n = adata.n_obs
    batch = batch_size or n

    per_model = []
    for model in resolved:
        name = model.metadata.get("model_name", "model")
        gene_idx = _gene_overlap(model, var_names)
        present = gene_idx >= 0
        n_overlap = int(present.sum())
        overlap_pct = 100.0 * n_overlap / model.n_genes
        if overlap_pct < min_gene_overlap_pct:
            raise ValueError(
                f"Model '{name}': only {n_overlap}/{model.n_genes} genes "
                f"({overlap_pct:.1f}%) overlap the panel — below the "
                f"{min_gene_overlap_pct}% gate. Train a panel-specific "
                "model (train_and_annotate) instead.")
        logger.info(f"Model '{name}': {n_overlap}/{model.n_genes} genes "
                    f"({overlap_pct:.1f}% overlap), {model.n_classes} types")

        cols = gene_idx[present]
        present_t = torch.as_tensor(np.flatnonzero(present), device=device)
        mean = torch.as_tensor(np.asarray(model.scaler_mean, np.float32),
                               device=device)
        scores = torch.empty((n, model.n_classes), dtype=torch.float32,
                             device=device)
        for s in range(0, n, batch):
            xb = dense_f32(X, device, rows=np.arange(s, min(s + batch, n)),
                           cols=cols)
            if renormalize_overlap:
                xb = _renormalize(xb)
            full = mean[None, :].repeat(xb.shape[0], 1)
            full[:, present_t] = xb
            scores[s:s + batch] = model.decision_scores(full)
        raw, win = scores.max(dim=1)
        per_model.append({
            "name": name, "model": model, "scores": scores,
            "conf": transform_confidence(scores, confidence_method),
            "raw": raw.cpu().numpy(),
            "pred": np.asarray(model.classes, object)[win.cpu().numpy()],
            "overlap_pct": overlap_pct,
        })

    # ensemble: max transformed confidence wins per cell
    winner = np.stack([m["conf"] for m in per_model]).argmax(axis=0)
    final_pred = np.empty(n, object)
    final_conf = np.empty(n, float)
    final_raw = np.empty(n, float)
    final_model = np.empty(n, object)
    for mi, m in enumerate(per_model):
        rows = winner == mi
        final_pred[rows] = m["pred"][rows]
        final_conf[rows] = m["conf"][rows]
        final_raw[rows] = m["raw"][rows]
        final_model[rows] = m["name"]

    adata.obs["cell_type_predicted"] = pd.Categorical(final_pred)
    final_label = final_pred
    if over_clustering is not None:
        # majority vote within precomputed clusters
        if over_clustering not in adata.obs.columns:
            raise ValueError(
                f"over_clustering column '{over_clustering}' not in obs")
        clusters = adata.obs[over_clustering].astype(str).to_numpy()
        final_label = final_pred.copy()
        for cl in pd.unique(clusters):
            rows = clusters == cl
            vals, cnts = np.unique(final_pred[rows].astype(str),
                                   return_counts=True)
            final_label[rows] = vals[cnts.argmax()]
        logger.info(f"Majority voting over '{over_clustering}' "
                    f"({len(pd.unique(clusters))} clusters)")
    adata.obs["cell_type"] = pd.Categorical(final_label)
    adata.obs["cell_type_confidence"] = final_conf
    adata.obs["cell_type_confidence_raw"] = final_raw
    adata.obs["cell_type_model"] = pd.Categorical(final_model)

    if store_decision_scores:
        # scores of the model that won the most cells
        best = per_model[int(np.bincount(winner,
                                         minlength=len(per_model)).argmax())]
        adata.obsm["cell_type_decision_scores"] = (
            best["scores"] if on_card else best["scores"].cpu().numpy())
        adata.uns["cell_type_decision_scores_classes"] = \
            list(best["model"].classes)

    n_types = len(pd.unique(final_pred))
    logger.info(f"Annotated {n:,} cells → {n_types} types using "
                f"{len(per_model)} model(s) ({time.time() - start:.1f}s)")
    update_metadata(
        adata, "annotate_cells",
        parameters={"models": [m["name"] for m in per_model],
                    "confidence_method": confidence_method,
                    "min_gene_overlap_pct": min_gene_overlap_pct,
                    "gene_overlap_pct": [round(m["overlap_pct"], 2)
                                         for m in per_model]},
        outputs={"obs": ["cell_type", "cell_type_confidence",
                         "cell_type_model"],
                 "obsm": "cell_type_decision_scores"})
    return adata


@param_aliases(confidence_method="confidence_transform",
               models="custom_model_path")
def annotate_celltypist(
    adata,
    tissue: str = "unknown",
    ensemble_mode: bool = True,
    custom_model_path=None,
    majority_voting: bool = False,
    over_clustering: Optional[str] = None,
    min_prop: float = 0.0,
    min_gene_overlap_pct: float = 25.0,
    min_confidence: float = 0.5,
    store_decision_scores: bool = True,
    confidence_transform: ConfidenceMethod = "zscore",
    batch_size: Optional[int] = None,
    renormalize_overlap: bool = True,
    models_dir: Optional[Union[str, Path]] = None,
    copy: bool = False,
    device: Device = "cuda",
):
    """Reference-signature annotation front end.

    Resolves models from ``custom_model_path`` (one model, a list for an
    ensemble, or a ``CellTypeModel``) or from the ``tissue`` preset table;
    ``ensemble_mode=False`` keeps only the first model. Runs
    ``annotate_cells``, then optional majority voting over
    ``over_clustering`` (a vote below ``min_prop`` of its cluster keeps
    the per-cell label), and finally marks cells below ``min_confidence``
    Unassigned.
    """
    from .confidence import filter_low_confidence

    if custom_model_path is not None:
        models = (list(custom_model_path)
                  if isinstance(custom_model_path, (list, tuple))
                  else [custom_model_path])
    else:
        models = get_models_for_tissue(tissue)
    if not ensemble_mode:
        models = models[:1]

    if majority_voting and over_clustering is None:
        raise ValueError(
            "majority_voting=True needs over_clustering (a precomputed "
            "cluster column in obs); on-the-fly over-clustering is a "
            "scanpy-side feature this package does not bundle")
    adata = annotate_cells(
        adata, models, confidence_method=confidence_transform,
        min_gene_overlap_pct=min_gene_overlap_pct, batch_size=batch_size,
        renormalize_overlap=renormalize_overlap, models_dir=models_dir,
        store_decision_scores=store_decision_scores,
        over_clustering=None, copy=copy, device=device)

    if majority_voting:
        clusters = adata.obs[over_clustering].astype(str).to_numpy()
        pred = adata.obs["cell_type_predicted"].astype(str).to_numpy()
        final = pred.copy()
        for cl in pd.unique(clusters):
            rows = clusters == cl
            vals, cnts = np.unique(pred[rows], return_counts=True)
            win = cnts.argmax()
            if cnts[win] / rows.sum() >= min_prop:
                final[rows] = vals[win]
        adata.obs["cell_type"] = pd.Categorical(final)
        logger.info(f"Majority voting over '{over_clustering}' "
                    f"(min_prop={min_prop})")

    if min_confidence and min_confidence > 0:
        adata = filter_low_confidence(adata, threshold=min_confidence)
    return adata


@param_aliases(adata="query_genes")
def get_model_gene_overlap(model_path, query_genes) -> dict:
    """Overlap stats between a model's genes and the query panel.

    ``model_path`` is a saved artifact path or a ``CellTypeModel``;
    ``query_genes`` a gene list or a container (its var_names are used).
    Returns n_model_genes, n_query_genes, n_overlap, overlap_pct,
    overlapping_genes and missing_genes.
    """
    model = (model_path if isinstance(model_path, CellTypeModel)
             else CellTypeModel.load(model_path))
    if hasattr(query_genes, "var_names"):
        query_genes = list(query_genes.var_names)
    present = _gene_overlap(model, list(query_genes)) >= 0
    n = int(present.sum())
    return {"n_model_genes": model.n_genes,
            "n_query_genes": len(query_genes),
            "n_overlap": n,
            "overlap_pct": round(100.0 * n / model.n_genes, 2),
            "overlapping_genes": [g for g, p in zip(model.genes, present)
                                  if p],
            "missing_genes": [g for g, p in zip(model.genes, present)
                              if not p]}


def get_annotation_summary(adata) -> dict:
    """Post-annotation summary: per-type counts + pipeline provenance."""
    out = dict(adata.uns.get("spatialcore_annotation", {}))
    if "cell_type" in adata.obs.columns:
        out["type_counts"] = (adata.obs["cell_type"].astype(str)
                              .value_counts().to_dict())
    if "cell_type_confidence" in adata.obs.columns:
        out["median_confidence"] = float(adata.obs["cell_type_confidence"]
                                         .median())
    return out
