"""Cell-type composition figures.

Port of ``spatialcore_tpu/plotting/celltype.py``, after the original
spatialcore's plotting/celltype.py (distribution bar :29, pie :135, embedding scatter :216) — same public
signatures; ``plot_celltype_embedding`` is this package's generic extra
(any obsm basis, e.g. ``spatial``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import pandas as pd

from ..core.compat import param_aliases
from .utils import generate_celltype_palette, save_figure, to_host, _grid


@param_aliases(cell_type_column="label_column", path="save")
def plot_celltype_distribution(
    adata,
    label_column: str = "cell_type",
    colors: Optional[Dict[str, str]] = None,
    horizontal: bool = False,
    top_n: Optional[int] = None,
    figsize: Optional[tuple] = None,
    title: Optional[str] = None,
    save: Optional[Union[str, Path]] = None,
    log_scale: bool = False,
):
    """Bar chart of cell counts per type, largest first."""
    counts = adata.obs[label_column].value_counts()
    if top_n:
        counts = counts.head(top_n)
    palette = generate_celltype_palette(counts.index, custom_colors=colors)
    if horizontal:
        fig, axes = _grid(ax_width=7, ax_height=max(3, 0.3 * len(counts)),
                          figsize=figsize)
        ax = axes[0, 0]
        ax.barh(range(len(counts)), counts.values[::-1],
                color=[palette[c] for c in counts.index[::-1]])
        ax.set_yticks(range(len(counts)))
        ax.set_yticklabels(counts.index[::-1], fontsize=8)
        ax.set_xlabel("cells")
        if log_scale:
            ax.set_xscale("log")
    else:
        fig, axes = _grid(ax_width=max(6, 0.4 * len(counts)), ax_height=5,
                          figsize=figsize)
        ax = axes[0, 0]
        ax.bar(range(len(counts)), counts.values,
               color=[palette[c] for c in counts.index])
        ax.set_xticks(range(len(counts)))
        ax.set_xticklabels(counts.index, fontsize=8, rotation=60,
                           ha="right")
        ax.set_ylabel("cells")
        if log_scale:
            ax.set_yscale("log")
    ax.set_title(title or f"{label_column}: {len(counts)} types, "
                 f"{int(counts.sum()):,} cells")
    if save:
        return save_figure(fig, save)
    return fig


@param_aliases(cell_type_column="label_column", path="save")
def plot_celltype_pie(
    adata,
    label_column: str = "cell_type",
    colors: Optional[Dict[str, str]] = None,
    min_pct: float = 2.0,
    other_label: str = "Other",
    figsize: tuple = (8, 8),
    title: Optional[str] = None,
    save: Optional[Union[str, Path]] = None,
):
    """Pie chart; types below ``min_pct`` percent collapse into Other."""
    counts = adata.obs[label_column].value_counts()
    frac = counts / counts.sum() * 100
    major = counts[frac >= min_pct]
    other = counts[frac < min_pct].sum()
    if other > 0:
        major = pd.concat([major, pd.Series({other_label: other})])
    palette = generate_celltype_palette(major.index, custom_colors=colors)
    fig, axes = _grid(figsize=figsize)
    ax = axes[0, 0]
    ax.pie(major.values, labels=major.index,
           colors=[palette[c] for c in major.index],
           autopct="%1.1f%%", textprops={"fontsize": 8})
    ax.set_title(title or label_column)
    if save:
        return save_figure(fig, save)
    return fig


@param_aliases(cell_type_column="label_column", path="save",
               basis="obsm_key")
def plot_celltype_embedding(
    adata,
    label_column: str = "cell_type",
    colors: Optional[Dict[str, str]] = None,
    obsm_key: str = "spatial",
    point_size: float = 2.0,
    alpha: float = 0.8,
    legend_loc: str = "right margin",
    figsize: Optional[tuple] = None,
    title: Optional[str] = None,
    save: Optional[Union[str, Path]] = None,
):
    """Scatter of an obsm embedding colored by cell type (rasterized)."""
    if obsm_key not in adata.obsm:
        raise ValueError(f"adata.obsm['{obsm_key}'] not found")
    coords = to_host(adata.obsm[obsm_key])[:, :2]
    labels = adata.obs[label_column].astype(str)
    palette = generate_celltype_palette(labels.unique(),
                                        custom_colors=colors)
    fig, axes = _grid(ax_width=8, ax_height=8, figsize=figsize)
    ax = axes[0, 0]
    for ct in sorted(labels.unique()):
        m = (labels == ct).to_numpy()
        ax.scatter(coords[m, 0], coords[m, 1], s=point_size, c=palette[ct],
                   alpha=alpha, label=ct, rasterized=True, linewidths=0)
    ax.set_aspect("equal")
    if legend_loc == "right margin":
        ax.legend(markerscale=4, fontsize=7, loc="center left",
                  bbox_to_anchor=(1.0, 0.5), frameon=False)
    elif legend_loc == "on data":
        for ct in sorted(labels.unique()):
            m = (labels == ct).to_numpy()
            if m.any():
                ax.annotate(ct, np.median(coords[m], axis=0), fontsize=7,
                            ha="center", weight="bold")
    elif legend_loc not in (None, "none"):
        ax.legend(markerscale=4, fontsize=7, loc=legend_loc, frameon=False)
    ax.set_title(title or f"{label_column} on {obsm_key}")
    if save:
        return save_figure(fig, save)
    return fig


@param_aliases(basis="obsm_key")
def plot_celltype_umap(adata, label_column: str = "cell_type",
                       obsm_key: str = "X_umap", **kwargs):
    """Embedding scatter under the reference's UMAP-specific name
    (ref plotting/celltype.py:216)."""
    return plot_celltype_embedding(adata, label_column=label_column,
                                   obsm_key=obsm_key, **kwargs)
