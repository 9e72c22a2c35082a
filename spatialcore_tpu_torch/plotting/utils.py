"""Shared plotting utilities: palettes, figure setup/save, despining.

Port of ``spatialcore_tpu/plotting/utils.py``, after the original
spatialcore's plotting/utils.py — same public signatures (``generate_celltype_palette:67``, ``setup_figure:178``,
``setup_multi_figure:227``, ``save_figure:277``, ``format_axis_labels:352``,
``despine:389``) built independently on matplotlib/seaborn with
deterministic color assignment (sorted labels, cycled palette — not dict
iteration order).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.compat import param_aliases

# 20 visually distinct colors for categorical cell-type maps.
DEFAULT_PALETTE: List[str] = [
    "#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
    "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf",
    "#aec7e8", "#ffbb78", "#98df8a", "#ff9896", "#c5b0d5",
    "#c49c94", "#f7b6d2", "#c7c7c7", "#dbdb8d", "#9edae5",
]

# Wong (2011) colorblind-safe palette + extensions.
COLORBLIND_PALETTE: List[str] = [
    "#000000", "#E69F00", "#56B4E9", "#009E73", "#F0E442",
    "#0072B2", "#D55E00", "#CC79A7", "#999999", "#44AA99",
    "#117733", "#882255", "#661100", "#88CCEE", "#DDCC77",
]

_NAMED_PALETTES: Dict[str, List[str]] = {
    "default": DEFAULT_PALETTE,
    "colorblind": COLORBLIND_PALETTE,
}


def to_host(x) -> np.ndarray:
    """A tensor on any device, or anything array-like, as host numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@param_aliases(celltypes="cell_types")
def generate_celltype_palette(
    cell_types: Sequence[str],
    palette: Union[str, Sequence[str], None] = "default",
    custom_colors: Optional[Dict[str, str]] = None,
    colorblind: bool = False,
) -> Dict[str, str]:
    """Deterministic label→hex mapping: sorted labels, cycled palette.

    ``palette`` is a named palette ("default"/"colorblind") or an explicit
    color sequence; ``custom_colors`` pins specific labels to fixed hex
    values (reference plotting/utils.py:67).
    """
    if palette is None:
        palette = "colorblind" if colorblind else "default"
    if isinstance(palette, str):
        if palette not in _NAMED_PALETTES:
            raise ValueError(f"Unknown palette '{palette}'. "
                             f"Available: {sorted(_NAMED_PALETTES)}")
        base = _NAMED_PALETTES["colorblind" if colorblind else palette]
    else:
        base = list(palette)
    labels = sorted(set(str(c) for c in cell_types))
    out = {lab: base[i % len(base)] for i, lab in enumerate(labels)}
    if custom_colors:
        for lab, col in custom_colors.items():
            out[str(lab)] = col
    return out


@param_aliases(palette="colors")
def save_palette(colors: Dict[str, str], path: Union[str, Path]) -> Path:
    """Persist a label→hex palette as JSON (stable across runs/figures)."""
    import json

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(colors, f, indent=2, sort_keys=True)
    return path


def load_palette(path: Union[str, Path]) -> Dict[str, str]:
    """Load a label→hex palette saved by :func:`save_palette`."""
    import json

    with open(path) as f:
        data = json.load(f)
    return {str(k): str(v) for k, v in data.items()}


def setup_figure(
    figsize: Tuple[float, float] = (8, 6),
    dpi: int = 150,
    style: str = "ticks",
    context: str = "notebook",
    dark_background: bool = False,
):
    """Create a styled single-panel ``(fig, ax)`` (ref plotting/utils.py:178).

    ``style``/``context`` apply seaborn styling when seaborn is present;
    ``dark_background`` switches to matplotlib's dark style (the spatial-
    map default).
    """
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    try:
        import seaborn as sns

        sns.set_style(style)
        sns.set_context(context)
    except ImportError:
        pass
    if dark_background:
        plt.style.use("dark_background")
    fig, ax = plt.subplots(figsize=figsize, dpi=dpi)
    return fig, ax


def setup_multi_figure(nrows: int = 1, ncols: int = 1,
                       figsize: Optional[Tuple[float, float]] = None,
                       dpi: int = 150, sharex: bool = False,
                       sharey: bool = False):
    """Multi-panel figure; auto-sizes 4×4 inches per panel (ref
    plotting/utils.py:227). Axes come back as a 2-D array."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if figsize is None:
        figsize = (4 * ncols, 4 * nrows)
    fig, axes = plt.subplots(nrows, ncols, figsize=figsize, dpi=dpi,
                             sharex=sharex, sharey=sharey, squeeze=False)
    return fig, axes


def _grid(ncols: int = 1, nrows: int = 1, ax_width: float = 5.0,
          ax_height: float = 4.5, dpi: int = 100, figsize=None,
          dark_background: bool = False, **kwargs):
    """Internal per-panel-sized grid used by this package's figures.

    ``figsize`` (whole-figure) overrides the per-panel sizing so public
    plot functions can forward the reference's ``figsize`` kwarg.
    """
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if figsize is None:
        figsize = (ax_width * ncols, ax_height * nrows)
    if dark_background:
        ctx = plt.style.context("dark_background")
        ctx.__enter__()
        try:
            fig, axes = plt.subplots(nrows, ncols, figsize=figsize, dpi=dpi,
                                     squeeze=False, **kwargs)
        finally:
            ctx.__exit__(None, None, None)
    else:
        fig, axes = plt.subplots(nrows, ncols, figsize=figsize, dpi=dpi,
                                 squeeze=False, **kwargs)
    return fig, axes


@param_aliases(save="path")
def save_figure(fig, path: Union[str, Path], formats: Optional[List[str]] = None,
                dpi: int = 150, bbox_inches: str = "tight",
                transparent: bool = False, close: bool = True) -> Path:
    """Save (optionally in several formats); creates parent dirs.

    ``formats=["png", "pdf"]`` writes ``<stem>.png`` and ``<stem>.pdf``
    next to each other (ref plotting/utils.py:277). Returns the primary
    path (first format, or ``path`` itself when ``formats`` is None).
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if formats:
        paths = [path.with_suffix(f".{f.lstrip('.')}") for f in formats]
    else:
        paths = [path]
    for p in paths:
        fig.savefig(p, dpi=dpi, bbox_inches=bbox_inches,
                    transparent=transparent)
    if close:
        import matplotlib.pyplot as plt

        plt.close(fig)
    return paths[0]


def despine(ax, top: bool = True, right: bool = True, left: bool = False,
            bottom: bool = False) -> None:
    """Hide the requested axis spines."""
    for side, off in (("top", top), ("right", right), ("left", left),
                      ("bottom", bottom)):
        if off:
            ax.spines[side].set_visible(False)


def close_figure(fig) -> None:
    """Close a matplotlib figure (frees memory in long loops)."""
    import matplotlib.pyplot as plt

    plt.close(fig)


def format_axis_labels(ax, xlabel: Optional[str] = None,
                       ylabel: Optional[str] = None,
                       title: Optional[str] = None,
                       fontsize: int = 12,
                       rotation: Optional[int] = None) -> None:
    """Set axis labels/title with consistent font sizing (ref
    plotting/utils.py:352); ``rotation`` additionally rotates x tick
    labels (this package's QC-figure styling extra)."""
    if xlabel is not None:
        ax.set_xlabel(xlabel, fontsize=fontsize)
    if ylabel is not None:
        ax.set_ylabel(ylabel, fontsize=fontsize)
    if title is not None:
        ax.set_title(title, fontsize=fontsize + 2)
    if rotation is not None:
        for lab in ax.get_xticklabels():
            lab.set_rotation(rotation)
            lab.set_ha("right")


# Reference-spelled aliases (ref plotting/utils.py:126,151)
save_celltype_palette = save_palette
load_celltype_palette = load_palette
