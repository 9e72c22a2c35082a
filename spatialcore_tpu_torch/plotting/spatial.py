"""Spatial scatter figures: cell types, confidence, genes, domains.

Port of ``spatialcore_tpu/plotting/spatial.py``, after the original
spatialcore's plotting/spatial.py (``plot_spatial_celltype`` :31 with its dark background + rasterized
per-type scatter, confidence map :166, gene map :287, multi-gene :404,
``plot_domain_distances`` :510 centroid-connection map) — same public
signatures. Extras: hotspot map, Moran scatter, correlogram and
co-occurrence curves, and the per-cell ``plot_distance_map``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import scipy.sparse as sp

from ..core.compat import param_aliases
from .utils import (despine, generate_celltype_palette, save_figure,
                    to_host, _grid)


def _coords(adata, spatial_key):
    if spatial_key not in adata.obsm:
        raise ValueError(f"adata.obsm['{spatial_key}'] not found")
    return to_host(adata.obsm[spatial_key])[:, :2]


def _dark(fig, ax):
    ax.set_facecolor("#111111")
    fig.patch.set_facecolor("#111111")
    ax.tick_params(colors="white")
    for spine in ax.spines.values():
        spine.set_color("white")


def _apply_lims(ax, xlim, ylim):
    if xlim is not None:
        ax.set_xlim(*xlim)
    if ylim is not None:
        ax.set_ylim(*ylim)


@param_aliases(cell_type_column="label_column", path="save")
def plot_spatial_celltype(
    adata,
    label_column: str = "cell_type",
    spatial_key: str = "spatial",
    colors: Optional[Dict[str, str]] = None,
    point_size: float = 1.5,
    alpha: float = 0.8,
    figsize: tuple = (10, 10),
    dark_background: bool = True,
    legend_loc: str = "right margin",
    xlim: Optional[Tuple[float, float]] = None,
    ylim: Optional[Tuple[float, float]] = None,
    title: Optional[str] = None,
    save: Optional[Union[str, Path]] = None,
    highlight: Optional[Sequence[str]] = None,
):
    """Spatial map colored by cell type (dark background default).

    ``highlight`` (extra) dims every other type to grey.
    """
    coords = _coords(adata, spatial_key)
    labels = adata.obs[label_column].astype(str)
    types = sorted(labels.unique())
    palette = generate_celltype_palette(types, custom_colors=colors)
    fig, axes = _grid(figsize=figsize)
    ax = axes[0, 0]
    if dark_background:
        _dark(fig, ax)
    for ct in types:
        m = (labels == ct).to_numpy()
        dim = highlight is not None and ct not in highlight
        ax.scatter(coords[m, 0], coords[m, 1], s=point_size, alpha=alpha,
                   c="#333333" if dim else palette[ct],
                   label=None if dim else ct, rasterized=True, linewidths=0)
    ax.set_aspect("equal")
    leg = None
    if legend_loc == "right margin":
        leg = ax.legend(markerscale=6, fontsize=7, loc="center left",
                        bbox_to_anchor=(1.0, 0.5), frameon=False)
    elif legend_loc not in (None, "none"):
        leg = ax.legend(markerscale=6, fontsize=7, loc=legend_loc,
                        frameon=False)
    if dark_background and leg:
        for text in leg.get_texts():
            text.set_color("white")
    _apply_lims(ax, xlim, ylim)
    ax.set_title(title or label_column,
                 color="white" if dark_background else "black")
    if save:
        return save_figure(fig, save)
    return fig


@param_aliases(path="save")
def plot_spatial_confidence(
    adata,
    confidence_column: str = "cell_type_confidence",
    spatial_key: str = "spatial",
    cmap: str = "viridis",
    point_size: float = 1.5,
    alpha: float = 0.8,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    figsize: tuple = (10, 10),
    dark_background: bool = False,
    colorbar: bool = True,
    xlim: Optional[Tuple[float, float]] = None,
    ylim: Optional[Tuple[float, float]] = None,
    title: Optional[str] = None,
    save: Optional[Union[str, Path]] = None,
):
    """Spatial map colored by annotation confidence."""
    coords = _coords(adata, spatial_key)
    conf = adata.obs[confidence_column].to_numpy(float)
    fig, axes = _grid(figsize=figsize)
    ax = axes[0, 0]
    if dark_background:
        _dark(fig, ax)
    scp = ax.scatter(
        coords[:, 0], coords[:, 1], s=point_size, c=conf, cmap=cmap,
        alpha=alpha, rasterized=True, linewidths=0,
        vmin=np.nanmin(conf) if vmin is None else vmin,
        vmax=np.nanmax(conf) if vmax is None else vmax)
    if colorbar:
        fig.colorbar(scp, ax=ax, label=confidence_column)
    ax.set_aspect("equal")
    _apply_lims(ax, xlim, ylim)
    if title:
        ax.set_title(title, color="white" if dark_background else "black")
    if save:
        return save_figure(fig, save)
    return fig


def _gene_vector(adata, gene, layer: Optional[str] = None):
    if gene not in adata.var_names:
        raise ValueError(f"Gene '{gene}' not in var_names")
    mat = adata.layers[layer] if layer else adata.X
    x = mat[:, adata.var_names.get_loc(gene)]
    if sp.issparse(x):
        x = np.asarray(x.todense()).ravel()
    return to_host(x).astype(float).ravel()


@param_aliases(path="save")
def plot_spatial_gene(
    adata,
    gene: str,
    spatial_key: str = "spatial",
    layer: Optional[str] = None,
    cmap: str = "magma",
    point_size: float = 1.5,
    alpha: float = 0.8,
    vmin: Optional[float] = None,
    vmax: Optional[float] = None,
    figsize: tuple = (10, 10),
    dark_background: bool = False,
    colorbar: bool = True,
    title: Optional[str] = None,
    save: Optional[Union[str, Path]] = None,
    quantile_clip: float = 0.99,
):
    """Spatial expression map for one gene.

    ``vmax`` defaults to the ``quantile_clip`` upper quantile (extra —
    single bright cells otherwise wash out the map).
    """
    coords = _coords(adata, spatial_key)
    x = _gene_vector(adata, gene, layer)
    if vmax is None:
        vmax = np.quantile(x, quantile_clip) if x.max() > 0 else 1.0
    fig, axes = _grid(figsize=figsize)
    ax = axes[0, 0]
    if dark_background:
        _dark(fig, ax)
    scp = ax.scatter(coords[:, 0], coords[:, 1], s=point_size, c=x,
                     cmap=cmap, vmin=0 if vmin is None else vmin,
                     vmax=max(vmax, 1e-9), alpha=alpha,
                     rasterized=True, linewidths=0)
    if colorbar:
        fig.colorbar(scp, ax=ax, label=gene)
    ax.set_aspect("equal")
    ax.set_title(title or gene,
                 color="white" if dark_background else "black")
    if save:
        return save_figure(fig, save)
    return fig


def plot_spatial_hotspots(
    adata,
    gene: str,
    key: str = "getis_ord",
    spatial_key: str = "spatial",
    point_size: float = 1.5,
    path: Optional[Union[str, Path]] = None,
):
    """Getis-Ord hot/cold-spot map for one gene.

    Background cells grey, significant hot spots red, cold spots blue
    (``obsm[f"{key}_hotspot"]`` from :func:`spatial.getis_ord_gi`).
    """
    coords = _coords(adata, spatial_key)
    params = adata.uns.get(f"{key}_params")
    if params is None or f"{key}_hotspot" not in adata.obsm:
        raise ValueError(
            f"No '{key}' results found — run spatial.getis_ord_gi first")
    genes = list(params["genes"])
    if gene not in genes:
        raise ValueError(f"'{gene}' not in {key} results ({len(genes)} genes)")
    hs = to_host(adata.obsm[f"{key}_hotspot"])[:, genes.index(gene)]
    fig, axes = _grid(ax_width=8, ax_height=7)
    ax = axes[0, 0]
    for val, color, label in ((0, "0.85", "NS"),
                              (-1, "#3b6fb6", "cold spot"),
                              (1, "#c23b3b", "hot spot")):
        m = hs == val
        if m.any():
            ax.scatter(coords[m, 0], coords[m, 1], s=point_size, c=color,
                       label=f"{label} ({int(m.sum()):,})",
                       rasterized=True, linewidths=0)
    ax.legend(markerscale=6, frameon=False, loc="upper right")
    ax.set_aspect("equal")
    ax.set_title(f"{gene} — Getis-Ord {'Gi*' if params.get('star', True) else 'Gi'}")
    if path:
        return save_figure(fig, path)
    return fig


def plot_moran_scatter(
    adata,
    gene: str,
    key: str = "local_morans",
    point_size: float = 4.0,
    path: Optional[Union[str, Path]] = None,
):
    """GeoDa-style Moran scatterplot: z vs spatial lag, quadrant-colored.

    Needs :func:`spatial.local_morans_i` results (``obsm[f"{key}_z"]``,
    ``_lag``, ``_quadrant``). The regression slope through the origin is
    the gene's global Moran's I (annotated in the title).
    """
    params = adata.uns.get(f"{key}_params")
    if params is None or f"{key}_z" not in adata.obsm:
        raise ValueError(
            f"No '{key}' results found — run spatial.local_morans_i first")
    genes = list(params["genes"])
    if gene not in genes:
        raise ValueError(f"'{gene}' not in {key} results ({len(genes)} genes)")
    gi = genes.index(gene)
    z = to_host(adata.obsm[f"{key}_z"])[:, gi]
    lag = to_host(adata.obsm[f"{key}_lag"])[:, gi]
    quad = to_host(adata.obsm[f"{key}_quadrant"])[:, gi]
    slope = float(z @ lag / max(z @ z, 1e-12))
    fig, axes = _grid(ax_width=7, ax_height=7)
    ax = axes[0, 0]
    colors = {0: "0.8", 1: "#c23b3b", 2: "#3b6fb6",
              3: "#d99036", 4: "#7fae7f"}
    names = {0: "NS", 1: "HH", 2: "LL", 3: "HL", 4: "LH"}
    for q in (0, 1, 2, 3, 4):
        m = quad == q
        if m.any():
            ax.scatter(z[m], lag[m], s=point_size, c=colors[q],
                       label=f"{names[q]} ({int(m.sum()):,})",
                       rasterized=True, linewidths=0)
    xs = np.linspace(z.min(), z.max(), 2)
    ax.plot(xs, slope * xs, "k-", lw=1)
    ax.axhline(0, color="0.6", lw=0.6)
    ax.axvline(0, color="0.6", lw=0.6)
    ax.set_xlabel(f"{gene} (z)")
    ax.set_ylabel("spatial lag")
    ax.set_title(f"{gene} — Moran scatter (I = {slope:.3f})")
    ax.legend(markerscale=2, frameon=False, loc="best", fontsize=8)
    if path:
        return save_figure(fig, path)
    return fig


def plot_correlogram(
    adata,
    genes=None,
    key: str = "moran_correlogram",
    alpha: float = 0.05,
    path: Optional[Union[str, Path]] = None,
):
    """Moran correlogram curves: I vs band distance, one line per gene.

    Significant bands (p < ``alpha``; permutation p when present) draw as
    filled markers, non-significant hollow. Needs
    :func:`spatial.moran_correlogram` results in ``uns[key]``.
    """
    df = adata.uns.get(key)
    if df is None:
        raise ValueError(f"No '{key}' results — run spatial.moran_correlogram")
    all_genes = list(dict.fromkeys(df["gene"]))
    genes = all_genes if genes is None else \
        ([genes] if isinstance(genes, str) else list(genes))
    missing = [g for g in genes if g not in all_genes]
    if missing:
        raise ValueError(f"Genes not in correlogram results: {missing[:5]}")
    pcol = "p_sim" if "p_sim" in df.columns else "p_value"
    fig, axes = _grid(ax_width=8, ax_height=5)
    ax = axes[0, 0]
    for g in genes:
        sub = df[df["gene"] == g].sort_values("band_lo")
        mid = (sub["band_lo"] + sub["band_hi"]) / 2
        line, = ax.plot(mid, sub["I"], "-", label=g, alpha=0.85)
        sig = sub[pcol] < alpha
        ax.plot(mid[sig], sub["I"][sig], "o", color=line.get_color(),
                markersize=5)
        ax.plot(mid[~sig], sub["I"][~sig], "o", color=line.get_color(),
                markersize=5, markerfacecolor="white")
    ax.axhline(0, color="0.6", lw=0.7)
    ax.set_xlabel("distance (band midpoint)")
    ax.set_ylabel("Moran's I")
    ax.set_title("Moran correlogram")
    if len(genes) <= 12:
        ax.legend(frameon=False, fontsize=8)
    despine(ax)
    if path:
        return save_figure(fig, path)
    return fig


def plot_co_occurrence(
    adata,
    anchor_type: str,
    key: str = "co_occurrence",
    types=None,
    path: Optional[Union[str, Path]] = None,
):
    """Squidpy-style co-occurrence curves around one anchor type.

    Plots ``P(type b | within shell of an anchor cell) / P(b)`` vs shell
    midpoint for every (or selected) ``b``. Needs
    :func:`spatial.co_occurrence` results in ``uns[key]``.
    """
    res = adata.uns.get(key)
    all_types = adata.uns.get(f"{key}_types")
    if res is None or all_types is None:
        raise ValueError(f"No '{key}' results — run spatial.co_occurrence")
    all_types = list(all_types)
    if anchor_type not in all_types:
        raise ValueError(f"'{anchor_type}' not in {key} types {all_types}")
    score = to_host(res["score"])
    edges = to_host(res["interval"])
    mid = (edges[:-1] + edges[1:]) / 2 if len(edges) == score.shape[0] + 1 \
        else edges[: score.shape[0]]
    ai = all_types.index(anchor_type)
    plot_types = all_types if types is None else \
        ([types] if isinstance(types, str) else list(types))
    missing = [t for t in plot_types if t not in all_types]
    if missing:
        raise ValueError(f"Types not in results: {missing[:5]}")
    fig, axes = _grid(ax_width=8, ax_height=5)
    ax = axes[0, 0]
    palette = generate_celltype_palette(all_types)
    for t in plot_types:
        ax.plot(mid, score[:, ai, all_types.index(t)], "-o", ms=3,
                color=palette[t], label=t, alpha=0.85)
    ax.axhline(1.0, color="0.6", lw=0.7, ls="--")
    ax.set_xlabel("distance")
    ax.set_ylabel(f"P(type | near {anchor_type}) / P(type)")
    ax.set_title(f"co-occurrence around {anchor_type}")
    if len(plot_types) <= 12:
        ax.legend(frameon=False, fontsize=8)
    despine(ax)
    if path:
        return save_figure(fig, path)
    return fig


@param_aliases(path="save")
def plot_spatial_multi_gene(
    adata,
    genes: List[str],
    spatial_key: str = "spatial",
    layer: Optional[str] = None,
    cmap: str = "magma",
    point_size: float = 1.0,
    ncols: int = 3,
    figsize_per_panel: Tuple[float, float] = (4, 4),
    dark_background: bool = False,
    save: Optional[Union[str, Path]] = None,
    quantile_clip: float = 0.99,
):
    """Grid of spatial expression maps for several genes
    (ref plotting/spatial.py:404)."""
    coords = _coords(adata, spatial_key)
    ncols = min(ncols, len(genes))
    nrows = -(-len(genes) // ncols)
    fig, axes = _grid(ncols=ncols, nrows=nrows,
                      ax_width=figsize_per_panel[0],
                      ax_height=figsize_per_panel[1],
                      dark_background=dark_background)
    if dark_background:
        fig.patch.set_facecolor("#111111")
    for i, gene in enumerate(genes):
        ax = axes[i // ncols, i % ncols]
        if dark_background:
            _dark(fig, ax)
        x = _gene_vector(adata, gene, layer)
        vmax = np.quantile(x, quantile_clip) if x.max() > 0 else 1.0
        scp = ax.scatter(coords[:, 0], coords[:, 1], s=point_size, c=x,
                         cmap=cmap, vmin=0, vmax=max(vmax, 1e-9),
                         rasterized=True, linewidths=0)
        fig.colorbar(scp, ax=ax, shrink=0.8)
        ax.set_title(gene, fontsize=9,
                     color="white" if dark_background else "black")
        ax.set_aspect("equal")
        ax.set_xticks([])
        ax.set_yticks([])
    for j in range(len(genes), nrows * ncols):
        axes[j // ncols, j % ncols].axis("off")
    if save:
        return save_figure(fig, save)
    return fig


def plot_spatial_genes(adata, genes: List[str],
                       spatial_key: str = "spatial", ncols: int = 3,
                       cmap: str = "magma", point_size: float = 1.0,
                       quantile_clip: float = 0.99,
                       path: Optional[Union[str, Path]] = None):
    """Light-background multi-gene grid (this package's original name)."""
    return plot_spatial_multi_gene(
        adata, genes, spatial_key=spatial_key, ncols=ncols, cmap=cmap,
        point_size=point_size, quantile_clip=quantile_clip,
        dark_background=False, save=path)


@param_aliases(path="save")
def plot_domain_distances(
    adata,
    source_domain_column: str,
    target_domain_column: Optional[str] = None,
    spatial_key: str = "spatial",
    distance_key: str = "domain_distances",
    top_n_connections: int = 1,
    line_cmap: str = "coolwarm_r",
    line_width: float = 2.0,
    point_size: float = 0.5,
    point_alpha: float = 0.3,
    domain_point_size: float = 3.0,
    domain_point_alpha: float = 0.7,
    figsize: Tuple[float, float] = (14, 12),
    title: Optional[str] = None,
    save: Optional[Union[str, Path]] = None,
):
    """Domain map with centroid-to-centroid distance connections.

    Background (non-domain) cells grey; domain cells colored per domain;
    lines join each source-domain centroid to its ``top_n_connections``
    nearest targets, colored by distance via ``line_cmap`` (blue=near,
    red=far with the default). Needs the ``uns[distance_key]`` matrix
    from :func:`spatial.calculate_domain_distances`
    (ref plotting/spatial.py:510).
    """
    import matplotlib.pyplot as plt
    import pandas as pd

    if target_domain_column is None:
        target_domain_column = source_domain_column
    coords = _coords(adata, spatial_key)
    for col in (source_domain_column, target_domain_column):
        if col not in adata.obs.columns:
            raise ValueError(f"Domain column '{col}' not found in obs")
    if distance_key not in adata.uns:
        raise KeyError(
            f"'{distance_key}' not in uns — run calculate_domain_distances")
    dist_data = adata.uns[distance_key]
    if "distance_matrix" not in dist_data:
        raise KeyError(f"'distance_matrix' missing in uns['{distance_key}']")
    dmat = pd.DataFrame(dist_data["distance_matrix"]).T

    src = adata.obs[source_domain_column]
    tgt = adata.obs[target_domain_column]
    domains = sorted(set(src.dropna().unique()) | set(tgt.dropna().unique()),
                     key=str)
    centroids = {}
    for d in domains:
        m = ((src == d) | (tgt == d)).to_numpy()
        if m.any():
            centroids[d] = coords[m].mean(axis=0)

    fig, axes = _grid(figsize=figsize)
    ax = axes[0, 0]
    bg = (src.isna() & tgt.isna()).to_numpy()
    if bg.any():
        ax.scatter(coords[bg, 0], coords[bg, 1], c="lightgrey",
                   s=point_size, alpha=point_alpha, rasterized=True,
                   linewidths=0, zorder=0)
    palette = generate_celltype_palette(domains)
    for d in domains:
        m = ((src == d) | (tgt == d)).to_numpy()
        if m.any():
            ax.scatter(coords[m, 0], coords[m, 1], c=palette[str(d)],
                       s=domain_point_size, alpha=domain_point_alpha,
                       rasterized=True, linewidths=0, zorder=1,
                       label=str(d))

    # connection segments: top-n nearest targets per source domain
    segments, dists = [], []
    for s in dmat.index:
        if s not in centroids:
            continue
        row = dmat.loc[s].drop(s, errors="ignore").dropna()
        if row.empty:
            continue
        sel = row.nsmallest(top_n_connections) if top_n_connections else row
        for t, dist in sel.items():
            if t in centroids:
                segments.append((centroids[s], centroids[t]))
                dists.append(float(dist))
    if segments:
        cmap_obj = plt.get_cmap(line_cmap)
        lo, hi = min(dists), max(dists)
        for (p0, p1), dist in zip(segments, dists):
            frac = 0.5 if hi <= lo else (dist - lo) / (hi - lo)
            ax.plot([p0[0], p1[0]], [p0[1], p1[1]], "-",
                    color=cmap_obj(frac), lw=line_width, zorder=2)
    ax.set_aspect("equal")
    if len(domains) <= 20:
        ax.legend(markerscale=4, fontsize=7, loc="center left",
                  bbox_to_anchor=(1.0, 0.5), frameon=False)
    ax.set_title(title or f"{source_domain_column} → "
                 f"{target_domain_column} distances")
    if save:
        return save_figure(fig, save)
    return fig


def plot_distance_map(
    adata,
    distance_column: str = "distance_to_target",
    nearest_column: str = "nearest_target_domain",
    spatial_key: str = "spatial",
    domain_column: Optional[str] = None,
    boundaries_key: Optional[str] = None,
    cmap: str = "viridis",
    point_size: float = 2.0,
    path: Optional[Union[str, Path]] = None,
):
    """Per-cell distance-to-target map (this package's extra), with
    optional domain boundary overlays from ``make_spatial_domains``."""
    coords = _coords(adata, spatial_key)
    d = adata.obs[distance_column].to_numpy(float)
    has = np.isfinite(d)
    fig, axes = _grid(ax_width=9, ax_height=8)
    ax = axes[0, 0]
    ax.scatter(coords[~has, 0], coords[~has, 1], s=point_size * 0.5,
               c="#dddddd", rasterized=True, linewidths=0)
    scp = ax.scatter(coords[has, 0], coords[has, 1], s=point_size, c=d[has],
                     cmap=cmap, rasterized=True, linewidths=0)
    fig.colorbar(scp, ax=ax, label=distance_column)
    if boundaries_key and boundaries_key in adata.uns:
        for name, pts in adata.uns[boundaries_key].items():
            pts = to_host(pts)
            ax.scatter(pts[:, 0], pts[:, 1], s=0.5, c="#d62728",
                       rasterized=True, linewidths=0)
    ax.set_aspect("equal")
    ax.set_title(distance_column)
    if path:
        return save_figure(fig, path)
    return fig
