"""Annotation validation suite: marker heatmap, 2D validation, QC bundle.

Port of ``spatialcore_tpu/plotting/validation.py``, after the original
spatialcore's plotting/validation.py: marker heatmap (:34), the confidence × marker-score 2D validation (:184), marker
dotplot (:456), celltype-confidence spatial+jitter (:590), DEG heatmap
(:732), ontology mapping table (:954), and ``generate_annotation_plots``
(:1222) — same public signatures and the {figures, summary, paths} bundle
return. The metagene scores, GMM thresholds and DEG ranks run in the
port's torch ops on ``device``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import pandas as pd
import scipy.sparse as sp

from ..core.compat import param_aliases
from ..core.logging import get_logger
from .utils import save_figure, to_host, _grid

logger = get_logger("plotting.validation")


def _matrix(adata, genes, var_index, layer: Optional[str] = None):
    """The genes' columns as host float32 (a tensor X on any device is
    indexed where it lies and copied once)."""
    mat = adata.layers[layer] if layer else adata.X
    X = mat[:, [var_index[g] for g in genes]]
    if sp.issparse(X):
        X = np.asarray(X.todense())
    return to_host(X).astype(np.float32)


@param_aliases(cell_type_column="label_column", path="save")
def plot_marker_heatmap(
    adata,
    label_column: str = "cell_type",
    markers: Optional[Dict[str, List[str]]] = None,
    cluster: bool = True,
    layer: Optional[str] = None,
    figsize: Optional[tuple] = None,
    cmap: str = "RdBu_r",
    center: float = 0,
    title: Optional[str] = None,
    save: Optional[Union[str, Path]] = None,
    max_markers_per_type: int = 4,
):
    """Mean expression of canonical markers per cell type (z-scored rows).

    ``cluster=True`` orders the cell-type rows by hierarchical clustering
    of their marker profiles (ref plotting/validation.py:34).
    """
    if markers is None:
        from ..annotation.markers import load_canonical_markers

        markers = load_canonical_markers()
    var_index = {g: i for i, g in enumerate(adata.var_names)}
    labels = adata.obs[label_column].astype(str)
    types = sorted(labels.unique())
    genes = []
    for ct in types:
        found = [g for g in markers.get(ct, []) if g in var_index]
        for g in found[:max_markers_per_type]:
            if g not in genes:
                genes.append(g)
    if not genes:
        raise ValueError(
            "No canonical markers found in the panel for any cell type")

    X = _matrix(adata, genes, var_index, layer)
    mat = np.zeros((len(types), len(genes)), np.float32)
    for i, ct in enumerate(types):
        mat[i] = X[(labels == ct).to_numpy()].mean(axis=0)
    mu = mat.mean(axis=0, keepdims=True)
    sd = mat.std(axis=0, keepdims=True)
    matz = (mat - mu) / np.where(sd < 1e-9, 1.0, sd)

    if cluster and len(types) > 2:
        from scipy.cluster.hierarchy import leaves_list, linkage

        order = leaves_list(linkage(matz, method="average"))
        types = [types[i] for i in order]
        matz = matz[order]

    fig, axes = _grid(ax_width=max(6, 0.28 * len(genes)),
                      ax_height=max(4, 0.3 * len(types)), figsize=figsize)
    ax = axes[0, 0]
    im = ax.imshow(matz, aspect="auto", cmap=cmap,
                   vmin=center - 2.5, vmax=center + 2.5)
    ax.set_xticks(range(len(genes)))
    ax.set_xticklabels(genes, rotation=90, fontsize=7)
    ax.set_yticks(range(len(types)))
    ax.set_yticklabels(types, fontsize=8)
    fig.colorbar(im, ax=ax, label="mean expression (z)")
    ax.set_title(title or "canonical markers by annotated type")
    if save:
        return save_figure(fig, save)
    return fig


@param_aliases(cell_type_column="label_column", path="save",
               min_cells="min_cells_per_type")
def plot_2d_validation(
    adata,
    label_column: str = "cell_type",
    confidence_column: str = "cell_type_confidence",
    markers: Optional[Dict[str, List[str]]] = None,
    confidence_threshold: float = 0.8,
    min_cells_per_type: int = 15,
    n_components: int = 3,
    ncols: int = 4,
    figsize_per_panel: Tuple[float, float] = (3.6, 3.2),
    save: Optional[Union[str, Path]] = None,
    marker_probability_threshold: float = 0.3,
    seed: int = 42,
    device="cuda",
):
    """Confidence × GMM marker-metagene scatter per cell type.

    Green = passes either gate, red = fails both (the dual-threshold QC
    view, reference validation.py:184). Returns (figure, summary
    DataFrame). Scores and GMM fits run on ``device``.
    """
    from ..annotation.markers import load_canonical_markers
    from ..stats.thresholding import compute_metagene_score, threshold_gmm

    markers = markers or load_canonical_markers()
    var_index = {g: i for i, g in enumerate(adata.var_names)}
    labels = adata.obs[label_column].astype(str)
    conf = adata.obs[confidence_column].to_numpy(float)

    panels = []
    for ct in sorted(labels.unique()):
        genes = [g for g in markers.get(ct, []) if g in var_index]
        cells = np.nonzero((labels == ct).to_numpy())[0]
        if len(genes) < 2 or cells.size < min_cells_per_type:
            continue
        X = _matrix(adata, genes, var_index)[cells]
        score = to_host(compute_metagene_score(
            X, "shifted_geometric_mean", device=device))
        _, _, prob, _ = threshold_gmm(score, n_components=n_components,
                                      seed=seed, device=device)
        prob = to_host(prob)
        panels.append((ct, cells, score, prob))
    if not panels:
        raise ValueError("No cell types with markers and enough cells")

    ncols = min(ncols, len(panels))
    nrows = -(-len(panels) // ncols)
    fig, axes = _grid(ncols=ncols, nrows=nrows,
                      ax_width=figsize_per_panel[0],
                      ax_height=figsize_per_panel[1])
    rows = []
    for i, (ct, cells, score, prob) in enumerate(panels):
        ax = axes[i // ncols, i % ncols]
        c_pass = conf[cells] >= confidence_threshold
        m_pass = prob >= marker_probability_threshold
        ok = c_pass | m_pass
        ax.scatter(conf[cells][ok], score[ok], s=3, c="#2ca02c", alpha=0.4,
                   rasterized=True, linewidths=0)
        ax.scatter(conf[cells][~ok], score[~ok], s=3, c="#d62728", alpha=0.5,
                   rasterized=True, linewidths=0)
        ax.axvline(confidence_threshold, color="gray", lw=0.8, ls="--")
        ax.set_title(f"{ct}\n{ok.mean():.0%} pass", fontsize=8)
        ax.set_xlabel("confidence", fontsize=7)
        ax.set_ylabel("marker metagene", fontsize=7)
        rows.append({"cell_type": ct, "n_cells": cells.size,
                     "pct_pass": round(100 * float(ok.mean()), 1),
                     "pct_conf_pass": round(100 * float(c_pass.mean()), 1),
                     "pct_marker_pass": round(100 * float(m_pass.mean()), 1)})
    for j in range(len(panels), nrows * ncols):
        axes[j // ncols, j % ncols].axis("off")
    summary = pd.DataFrame(rows)
    if save:
        save_figure(fig, save)
    return fig, summary


@param_aliases(cell_type_column="label_column", path="save")
def plot_marker_dotplot(
    adata,
    label_column: str = "cell_type",
    markers: Optional[Dict[str, List[str]]] = None,
    layer: Optional[str] = None,
    figsize: Optional[tuple] = None,
    cmap: str = "Reds",
    title: Optional[str] = None,
    save: Optional[Union[str, Path]] = None,
    max_markers_per_type: int = 3,
):
    """Dotplot: dot size = fraction expressing, color = mean expression."""
    if markers is None:
        from ..annotation.markers import load_canonical_markers

        markers = load_canonical_markers()
    var_index = {g: i for i, g in enumerate(adata.var_names)}
    labels = adata.obs[label_column].astype(str)
    types = sorted(labels.unique())
    genes = []
    for ct in types:
        for g in [g for g in markers.get(ct, []) if g in var_index][
                :max_markers_per_type]:
            if g not in genes:
                genes.append(g)
    if not genes:
        raise ValueError("No canonical markers found in the panel")
    X = _matrix(adata, genes, var_index, layer)
    frac = np.zeros((len(types), len(genes)))
    mean = np.zeros((len(types), len(genes)))
    for i, ct in enumerate(types):
        sub = X[(labels == ct).to_numpy()]
        frac[i] = (sub > 0).mean(axis=0)
        mean[i] = sub.mean(axis=0)
    fig, axes = _grid(ax_width=max(6, 0.3 * len(genes)),
                      ax_height=max(4, 0.33 * len(types)), figsize=figsize)
    ax = axes[0, 0]
    yy, xx = np.mgrid[0:len(types), 0:len(genes)]
    scp = ax.scatter(xx.ravel(), yy.ravel(), s=frac.ravel() * 180 + 2,
                     c=mean.ravel(), cmap=cmap)
    ax.set_xticks(range(len(genes)))
    ax.set_xticklabels(genes, rotation=90, fontsize=7)
    ax.set_yticks(range(len(types)))
    ax.set_yticklabels(types, fontsize=8)
    ax.invert_yaxis()
    fig.colorbar(scp, ax=ax, label="mean expression")
    if title:
        ax.set_title(title)
    if save:
        return save_figure(fig, save)
    return fig


@param_aliases(cell_type_column="label_column", path="save")
def plot_deg_heatmap(
    adata,
    label_column: str = "cell_type",
    n_genes: int = 5,
    method: str = "wilcoxon",
    layer: Optional[str] = None,
    figsize: Optional[Tuple[float, float]] = None,
    cmap: str = "RdBu_r",
    save: Optional[Union[str, Path]] = None,
    title: Optional[str] = None,
    min_cells: int = 10,
    key: str = "rank_genes_groups",
    device="cuda",
):
    """Top DEG-per-type heatmap (z-scored means); runs the port's
    ``method`` ranking (``stats.deg``, on ``device``) if ``uns[key]`` is
    absent (reference validation.py:732 runs scanpy's)."""
    labels = adata.obs[label_column].astype(str)
    big = [t for t, c in labels.value_counts().items() if c >= min_cells]
    if len(big) < 2:
        raise ValueError(
            f"DEG heatmap needs ≥2 types with ≥{min_cells} cells")
    if key not in adata.uns:
        from ..stats.deg import rank_genes_groups

        rank_genes_groups(adata, label_column, groups=big, method=method,
                          min_cells=min_cells, key_added=key, device=device)
    deg = adata.uns[key]
    genes = []
    for grp in sorted(deg["names"]):
        for g in deg["names"][grp][:n_genes]:
            if g not in genes:
                genes.append(g)
    var_index = {g: i for i, g in enumerate(adata.var_names)}
    X = _matrix(adata, genes, var_index, layer)
    types = sorted(deg["names"])
    mat = np.vstack([X[(labels == t).to_numpy()].mean(axis=0)
                     for t in types])
    mu, sd = mat.mean(axis=0, keepdims=True), mat.std(axis=0, keepdims=True)
    matz = (mat - mu) / np.where(sd < 1e-9, 1.0, sd)
    fig, axes = _grid(ax_width=max(6, 0.25 * len(genes)),
                      ax_height=max(4, 0.33 * len(types)), figsize=figsize)
    ax = axes[0, 0]
    im = ax.imshow(matz, aspect="auto", cmap=cmap, vmin=-2.5, vmax=2.5)
    ax.set_xticks(range(len(genes)))
    ax.set_xticklabels(genes, rotation=90, fontsize=6)
    ax.set_yticks(range(len(types)))
    ax.set_yticklabels(types, fontsize=8)
    fig.colorbar(im, ax=ax, label="mean expr (z)")
    ax.set_title(title or f"top {n_genes} DEGs per type ({method})")
    if save:
        return save_figure(fig, save)
    return fig


def plot_celltype_confidence_spatial(
    adata,
    cell_types=None,
    cell_type_column: str = "cell_type",
    confidence_column: str = "cell_type_confidence",
    spatial_key: str = "spatial",
    point_size: float = 2.0,
    seed: int = 0,
    path: Optional[Union[str, Path]] = None,
):
    """Per-type spatial confidence maps + a jittered confidence strip.

    Left: where the type sits in the tissue, colored by confidence (other
    cells dim gray). Right: jittered per-type confidence distribution
    (reference validation.py:590).
    """
    from ..core.rng import np_rng

    if spatial_key not in adata.obsm:
        raise ValueError(f"adata.obsm['{spatial_key}'] not found")
    coords = to_host(adata.obsm[spatial_key])[:, :2]
    labels = adata.obs[cell_type_column].astype(str)
    conf = adata.obs[confidence_column].to_numpy(float)
    if cell_types is None:
        cell_types = labels.value_counts().head(4).index.tolist()
    rng = np_rng(seed, "conf_jitter")

    nrows = len(cell_types)
    fig, axes = _grid(ncols=2, nrows=nrows, ax_width=5.0,
                      ax_height=3.6)
    for i, ct in enumerate(cell_types):
        m = (labels == ct).to_numpy()
        ax = axes[i, 0]
        ax.scatter(coords[~m, 0], coords[~m, 1], s=point_size * 0.4,
                   c="#dddddd", rasterized=True, linewidths=0)
        scp = ax.scatter(coords[m, 0], coords[m, 1], s=point_size,
                         c=conf[m], cmap="viridis", vmin=0, vmax=1,
                         rasterized=True, linewidths=0)
        fig.colorbar(scp, ax=ax, shrink=0.85)
        ax.set_aspect("equal")
        ax.set_title(f"{ct} (n={int(m.sum()):,})", fontsize=9)
        ax.set_xticks([])
        ax.set_yticks([])

        axj = axes[i, 1]
        y = conf[m]
        x = rng.uniform(-0.25, 0.25, y.size)
        axj.scatter(x, y, s=3, alpha=0.35, c="#1f77b4", rasterized=True,
                    linewidths=0)
        axj.set_xlim(-1, 1)
        axj.set_ylim(0, 1.02)
        axj.set_xticks([])
        axj.axhline(float(np.median(y)) if y.size else 0, color="#d62728",
                    lw=1.0)
        axj.set_ylabel(confidence_column, fontsize=7)
    if path:
        return save_figure(fig, path)
    return fig


def plot_celltype_confidence(adata, label_column: str = "cell_type",
                             confidence_column: str = "cell_type_confidence",
                             spatial_key: str = "spatial",
                             threshold: float = 0.8,
                             max_cell_types: int = 20,
                             figsize: Tuple[float, float] = (14, 6),
                             save=None):
    """Reference-spelled spatial + jitter confidence figure (ref
    plotting/validation.py:590); delegates to
    :func:`plot_celltype_confidence_spatial` showing the most numerous
    types (row count bounded at 6 to keep the figure readable)."""
    del threshold, figsize  # layout fixed by the delegate
    labels = adata.obs[label_column].astype(str)
    top = labels.value_counts().head(min(max_cell_types, 6)).index.tolist()
    return plot_celltype_confidence_spatial(
        adata, cell_types=top, cell_type_column=label_column,
        confidence_column=confidence_column, spatial_key=spatial_key,
        path=save)


@param_aliases(cell_type_column="label_column", path="save")
def plot_ontology_mapping_table(
    adata,
    label_column: str = "cell_type",
    ontology_column: str = "cell_type_ontology_term_id",
    ontology_name_column: Optional[str] = None,
    mapping_table: Optional[pd.DataFrame] = None,
    figsize: Optional[Tuple[float, float]] = None,
    title: Optional[str] = None,
    save: Optional[Union[str, Path]] = None,
):
    """Figure-rendered table: label → CL ID / name / tier / score / cells.

    ``mapping_table`` (a DataFrame from ``create_mapping_table``) renders
    directly when given; otherwise the table is aggregated from obs.
    """
    if mapping_table is not None:
        agg = mapping_table.copy()
    else:
        from ..annotation.ontology import ontology_provenance_columns
        cols = [label_column, ontology_column,
                *ontology_provenance_columns(ontology_column)]
        if ontology_name_column and ontology_name_column in adata.obs:
            cols.insert(2, ontology_name_column)
        for c in cols[:2]:
            if c not in adata.obs.columns:
                raise ValueError(
                    f"Column '{c}' not found; run add_ontology_ids")
        df = adata.obs[[c for c in cols if c in adata.obs.columns]].copy()
        agg = (df.groupby(label_column, observed=True)
               .agg({c: "first" for c in df.columns if c != label_column}))
        agg["n_cells"] = df[label_column].value_counts()
        agg = agg.reset_index().sort_values("n_cells", ascending=False)
    fig, axes = _grid(ax_width=9, ax_height=max(2.5, 0.3 * len(agg)),
                      figsize=figsize)
    ax = axes[0, 0]
    ax.axis("off")
    table = ax.table(cellText=agg.round(3).astype(str).values,
                     colLabels=agg.columns, loc="center",
                     cellLoc="left")
    table.auto_set_font_size(False)
    table.set_fontsize(7)
    table.scale(1, 1.3)
    if title:
        ax.set_title(title)
    if save:
        return save_figure(fig, save)
    return fig


@param_aliases(source_label_column="label_column",
               ontology_id_column="ontology_column")
def plot_ontology_mapping(adata, label_column: str = "cell_type",
                          ontology_name_column: Optional[str] = None,
                          ontology_column: str =
                          "cell_type_ontology_term_id",
                          mapping_table: Optional[pd.DataFrame] = None,
                          title: Optional[str] = None,
                          figsize: Tuple[float, float] = (14, 8),
                          save: Optional[Union[str, Path]] = None):
    """Reference-spelled ontology mapping table figure (ref
    plotting/validation.py:954)."""
    return plot_ontology_mapping_table(
        adata, label_column=label_column, ontology_column=ontology_column,
        ontology_name_column=ontology_name_column,
        mapping_table=mapping_table, figsize=figsize, title=title,
        save=save)


@param_aliases(cell_type_column="label_column")
def generate_annotation_plots(
    adata,
    label_column: str = "cell_type",
    confidence_column: str = "cell_type_confidence",
    output_dir: Optional[Union[str, Path]] = None,
    prefix: str = "celltyping",
    confidence_threshold: float = 0.8,
    markers: Optional[Dict[str, List[str]]] = None,
    n_deg_genes: int = 10,
    spatial_key: str = "spatial",
    source_label_column: Optional[str] = None,
    ontology_name_column: Optional[str] = None,
    ontology_id_column: Optional[str] = None,
    device="cuda",
) -> Dict:
    """The standard QC bundle (pipeline Stage 8): distribution, confidence
    histogram + by-type, 2D validation, DEG heatmap, and the ontology
    mapping table when ontology columns exist. Returns
    ``{"figures", "summary", "paths"}`` (ref plotting/validation.py:1222);
    figures save under ``output_dir/<prefix>_*.png`` when ``output_dir``
    is given. The 2D validation and the DEG ranking run on ``device``.
    """
    from .celltype import plot_celltype_distribution
    from .confidence import (plot_confidence_by_celltype,
                             plot_confidence_histogram)

    out = Path(output_dir) if output_dir else None
    if out:
        out.mkdir(parents=True, exist_ok=True)
    results: Dict = {"figures": {}, "summary": None, "paths": {}}

    if source_label_column is None:
        source_label_column = ("cell_type_predicted"
                               if "cell_type_predicted" in adata.obs.columns
                               else label_column)
    if (ontology_name_column is None
            and "cell_type_ontology_label" in adata.obs.columns):
        ontology_name_column = "cell_type_ontology_label"
    if (ontology_id_column is None
            and "cell_type_ontology_term_id" in adata.obs.columns):
        ontology_id_column = "cell_type_ontology_term_id"

    def _emit(name, fig):
        results["figures"][name] = fig
        if out:
            p = save_figure(fig, out / f"{prefix}_{name}.png")
            results["paths"][name] = p

    _emit("distribution", plot_celltype_distribution(adata, label_column))
    _emit("confidence_histogram", plot_confidence_histogram(
        adata, confidence_column, threshold=confidence_threshold))
    _emit("confidence_by_celltype", plot_confidence_by_celltype(
        adata, label_column, confidence_column))
    try:
        fig2d, summary = plot_2d_validation(
            adata, label_column, confidence_column, markers=markers,
            confidence_threshold=confidence_threshold, device=device)
        results["summary"] = summary
        _emit("validation_2d", fig2d)
        if out:
            summary.to_csv(out / f"{prefix}_validation_summary.csv",
                           index=False)
    except ValueError as e:
        logger.warning(f"2D validation skipped: {e}")
    try:
        _emit("deg_heatmap", plot_deg_heatmap(
            adata, label_column, n_genes=n_deg_genes, device=device))
    except ValueError as e:
        logger.warning(f"DEG heatmap skipped: {e}")
    if ontology_id_column and ontology_id_column in adata.obs.columns:
        try:
            _emit("ontology_mapping", plot_ontology_mapping_table(
                adata, label_column=source_label_column,
                ontology_column=ontology_id_column,
                ontology_name_column=ontology_name_column))
        except ValueError as e:
            logger.warning(f"Ontology mapping table skipped: {e}")
    logger.info(f"QC plots: {sorted(results['figures'])}"
                + (f" → {out}" if out else " (not saved)"))
    return results
