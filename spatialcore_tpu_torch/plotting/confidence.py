"""Annotation-confidence figures.

Port of ``spatialcore_tpu/plotting/confidence.py``, after the original
spatialcore's plotting/confidence.py (histogram :30, by-celltype :135, violin :247, model contribution :341)
— same public signatures.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Union

from ..core.compat import param_aliases
from .utils import generate_celltype_palette, save_figure, _grid


@param_aliases(path="save")
def plot_confidence_histogram(
    adata,
    confidence_column: str = "cell_type_confidence",
    bins: int = 50,
    threshold: Optional[float] = None,
    threshold_color: str = "#FF0000",
    figsize: tuple = (8, 5),
    title: Optional[str] = None,
    save: Optional[Union[str, Path]] = None,
):
    """Distribution of per-cell confidence with optional threshold line."""
    conf = adata.obs[confidence_column].dropna().to_numpy(float)
    fig, axes = _grid(figsize=figsize)
    ax = axes[0, 0]
    ax.hist(conf, bins=bins, color="#1f77b4", alpha=0.85)
    if threshold is not None:
        below = float((conf < threshold).mean())
        ax.axvline(threshold, color=threshold_color, lw=2,
                   label=f"threshold {threshold} ({below:.1%} below)")
        ax.legend(frameon=False)
    ax.set_xlabel(confidence_column)
    ax.set_ylabel("cells")
    if title:
        ax.set_title(title)
    if save:
        return save_figure(fig, save)
    return fig


@param_aliases(cell_type_column="label_column", path="save")
def plot_confidence_by_celltype(
    adata,
    label_column: str = "cell_type",
    confidence_column: str = "cell_type_confidence",
    colors: Optional[Dict[str, str]] = None,
    top_n: Optional[int] = 20,
    kind: str = "box",
    figsize: Optional[tuple] = None,
    title: Optional[str] = None,
    save: Optional[Union[str, Path]] = None,
):
    """Per-type confidence distributions (box or violin), sorted by median.

    ``top_n`` keeps the most numerous types (reference
    plotting/confidence.py:135); None plots all.
    """
    df = adata.obs[[label_column, confidence_column]].dropna()
    if top_n:
        keep = df[label_column].value_counts().head(top_n).index
        df = df[df[label_column].isin(keep)]
    order = (df.groupby(label_column, observed=True)[confidence_column]
             .median().sort_values(ascending=False).index.tolist())
    groups = [df.loc[df[label_column] == ct, confidence_column
                     ].to_numpy(float) for ct in order]
    palette = generate_celltype_palette(order, custom_colors=colors)
    fig, axes = _grid(ax_width=max(6, 0.45 * len(order)), figsize=figsize)
    ax = axes[0, 0]
    if kind == "violin":
        parts = ax.violinplot(groups, showmedians=True)
        for body, ct in zip(parts["bodies"], order):
            body.set_facecolor(palette[ct])
    else:
        bp = ax.boxplot(groups, patch_artist=True, showfliers=False)
        for patch, ct in zip(bp["boxes"], order):
            patch.set_facecolor(palette[ct])
    ax.set_xticks(range(1, len(order) + 1))
    ax.set_xticklabels(order, rotation=60, ha="right", fontsize=7)
    ax.set_ylabel(confidence_column)
    if title:
        ax.set_title(title)
    if save:
        return save_figure(fig, save)
    return fig


def plot_confidence_violin(adata, label_column: str = "cell_type",
                           confidence_column: str = "cell_type_confidence",
                           colors: Optional[Dict[str, str]] = None,
                           top_n: Optional[int] = 15, **kwargs):
    """Violin variant of the per-type confidence figure (ref
    plotting/confidence.py:247)."""
    kwargs.setdefault("kind", "violin")
    return plot_confidence_by_celltype(
        adata, label_column=label_column,
        confidence_column=confidence_column, colors=colors, top_n=top_n,
        **kwargs)


@param_aliases(path="save")
def plot_model_contribution(
    adata,
    model_column: str = "cell_type_model",
    figsize: tuple = (8, 6),
    title: Optional[str] = None,
    save: Optional[Union[str, Path]] = None,
):
    """Share of cells won by each ensemble model."""
    if model_column not in adata.obs.columns:
        raise ValueError(f"Column '{model_column}' not found")
    counts = adata.obs[model_column].value_counts()
    fig, axes = _grid(figsize=figsize)
    ax = axes[0, 0]
    ax.bar(range(len(counts)), counts.values, color="#1f77b4")
    ax.set_xticks(range(len(counts)))
    ax.set_xticklabels(counts.index, rotation=30, ha="right")
    ax.set_ylabel("cells won")
    ax.set_title(title or "ensemble model contribution")
    if save:
        return save_figure(fig, save)
    return fig
