"""Spatial domain extraction: Buffer-Union-Shrink on a raster, on the card.

Port of ``spatialcore_tpu/spatial/domains.py``: rasterize the cells that
match a filter → disk-dilate by ``cell_dist`` → disk-erode by ``cell_dist −
shrink_margin`` → pointer-jumping connected components → per-cell grid
lookup (``ops.geometry``, torch ops on ``device``; a warning when the
component loop stops at its cap with labels still changing). Domain reduction (merge
small domains into adjacent ones, drop isolated ones), renumbering by size
(largest = ``<prefix>_1``), the expansion-ratio warning and the boundary
exports run on the host, as in the reference. The grid's H and W snap up
to multiples of 128 as the reference's do, so component ids — minimum flat
indices, which depend on W — and hence the domain names are equal.
"""

from __future__ import annotations

import re
import time
from typing import Literal, Optional, Union

import numpy as np
import pandas as pd
import torch

from ..core.compat import param_aliases
from ..core.logging import get_logger
from ..core.metadata import update_metadata
from ..ops import geometry
from ..ops.geometry import (_BG, _buffer_union_shrink, extract_boundaries,
                            extract_boundary_polygons, label_adjacency)

logger = get_logger("spatial.domains")

Device = Union[str, torch.device]

PLATFORM_CELL_DIST = {"cosmx": 400.0, "xenium": 50.0, "visium": 200.0}


def detect_platform(coords: np.ndarray) -> str:
    """Heuristic platform detection from the coordinate range.

    CosMx pixel coords run past 50k; Xenium micron coords stay ≤15k; Visium
    array units sit between.
    """
    max_coord = float(np.abs(coords).max())
    if max_coord > 50_000:
        return "cosmx"
    if max_coord <= 15_000:
        return "xenium"
    return "visium"


def _evaluate_filter_expression(filter_expression: str, adata) -> pd.Series:
    """Boolean mask from ontology IDs / column equality / boolean columns.

    Branch order: column equality → ontology-ID expressions → boolean
    column → pandas ``obs.eval``.
    """
    expr = filter_expression.strip()
    # column equality FIRST: "term_id_col == 'CL:0000084'" contains a
    # CURIE but is documented equality syntax — routing it to the
    # ontology parser crashed on the '=' token
    m = re.match(r"^(\w+)\s*==\s*['\"]?(.+?)['\"]?$", expr)
    if not m and re.search(r"[A-Z]+:[0-9A-Z]+", expr):
        from ..annotation.expression import evaluate_ontology_expression

        return evaluate_ontology_expression(expr, adata)

    if m:
        col, value = m.group(1), m.group(2)
        if col not in adata.obs.columns:
            raise ValueError(
                f"Column '{col}' not found in adata.obs. Available: "
                f"{list(adata.obs.columns)[:10]}...")
        series = adata.obs[col]
        mask = series.astype(str) == value
        return mask

    if expr in adata.obs.columns:
        col = adata.obs[expr]
        uniq = set(col.dropna().unique())
        if col.dtype == bool or uniq.issubset({True, False, "True", "False"}):
            if uniq & {"True", "False"}:
                # map string spellings for object AND categorical dtypes:
                # numpy string truthiness turns 'False' into True, which
                # silently selected EVERY cell for categorical columns
                col = col.astype(object).map(
                    {"True": True, "False": False, True: True, False: False})
            return col.fillna(False).astype(bool)
        raise ValueError(
            f"Column '{expr}' exists but is not boolean. Use equality "
            f"syntax like \"{expr} == 'value'\".")

    try:
        return adata.obs.eval(expr).astype(bool)
    except Exception as e:
        raise ValueError(
            f"Could not evaluate filter expression '{filter_expression}': {e}"
        ) from e


def _auto_prefix(filter_expression: str) -> str:
    s = re.sub(r"[^0-9A-Za-z]+", "_", filter_expression).strip("_")
    return s[:40] if s else "domain"


def raster_grid(coords: np.ndarray, cell_dist_um: float,
                shrink_margin_um: float, grid_max_dim: int,
                pixels_per_dist: int):
    """The raster's origin, pixel size, (H, W) and the dilation and erosion
    radii in pixels, as the reference sets them up.

    The pixel is ``cell_dist / pixels_per_dist``, coarsened so the padded
    extent fits ``grid_max_dim``; H and W snap up to multiples of 128 (the
    extra rows and columns hold no points).
    """
    pad = cell_dist_um * 1.5
    lo = coords.min(axis=0) - pad
    hi = coords.max(axis=0) + pad
    extent = hi - lo
    pixel = cell_dist_um / pixels_per_dist
    pixel = max(pixel, float(extent.max()) / grid_max_dim)
    W = -(-(int(np.ceil(extent[0] / pixel)) + 1) // 128) * 128
    H = -(-(int(np.ceil(extent[1] / pixel)) + 1) // 128) * 128
    r_buffer = max(int(round(cell_dist_um / pixel)), 1)
    r_shrink = max(int(round((cell_dist_um - shrink_margin_um) / pixel)), 0)
    return lo, pixel, (H, W), r_buffer, r_shrink


def to_pixels(c: np.ndarray, lo: np.ndarray, pixel: float, shape) -> np.ndarray:
    """int32 [N, 2] (y, x) pixel of each point, clipped to the grid."""
    H, W = shape
    xs = np.clip(((c[:, 0] - lo[0]) / pixel).astype(np.int32), 0, W - 1)
    ys = np.clip(((c[:, 1] - lo[1]) / pixel).astype(np.int32), 0, H - 1)
    return np.column_stack([ys, xs]).astype(np.int32)


def make_spatial_domains(
    adata,
    filter_expression: Optional[str] = None,
    cell_dist_um: Optional[float] = None,
    shrink_margin_um: float = 25.0,
    domain_prefix: Optional[str] = None,
    min_target_cells_domain: int = 10,
    min_total_cells_domain: Optional[int] = None,
    output_column: str = "spatial_domain",
    assign_all_cells: bool = True,
    domain_expansion_warn_ratio: float = 10.0,
    r_functions_path=None,
    copy: bool = False,
    platform: Optional[Literal["cosmx", "xenium", "visium"]] = None,
    spatial_key: str = "spatial",
    grid_max_dim: int = 2048,
    pixels_per_dist: int = 8,
    store_boundaries: bool = True,
    device: Device = "cuda",
):
    """Create named spatial domains around cells matching a filter.

    Output: ``obs[output_column]`` categorical ``<prefix>_1..k`` (NaN for
    unassigned cells, largest domain = 1), ``uns[f"{output_column}_params"]``
    summary, and (optionally) ``uns[f"{output_column}_boundaries"]`` raster
    boundary coordinates per domain. ``pixels_per_dist`` sets raster pixels
    per ``cell_dist_um`` (fidelity knob); ``grid_max_dim`` caps grid size.
    ``r_functions_path`` is accepted for reference-signature compatibility
    and ignored: the raster pipeline replaces the R Buffer-Union-Shrink
    pass. The raster pipeline runs on ``device``.
    """
    start = time.time()
    if r_functions_path is not None:
        logger.info("make_spatial_domains: r_functions_path ignored — the "
                    "raster geometry pass replaces R")
    if copy:
        adata = adata.copy()
    if spatial_key not in adata.obsm:
        raise ValueError(
            f"adata.obsm['{spatial_key}'] not found; spatial coordinates "
            "are required.")
    if filter_expression is None:
        raise ValueError("filter_expression is required.")

    xy = adata.obsm[spatial_key]
    if isinstance(xy, torch.Tensor):
        xy = xy.cpu().numpy()
    coords = np.asarray(xy, dtype=np.float64)[:, :2]
    if platform is None:
        platform = detect_platform(coords)
        logger.info(f"Auto-detected platform: {platform}")
    elif platform not in PLATFORM_CELL_DIST:
        raise ValueError(f"Unknown platform '{platform}'")
    if cell_dist_um is None:
        cell_dist_um = PLATFORM_CELL_DIST[platform]
        logger.info(f"Using {platform} default cell_dist={cell_dist_um}")
    if shrink_margin_um >= cell_dist_um:
        raise ValueError(
            f"shrink_margin_um={shrink_margin_um} must be < "
            f"cell_dist_um={cell_dist_um}")

    mask = _evaluate_filter_expression(filter_expression, adata).to_numpy()
    n_target = int(mask.sum())
    if n_target == 0:
        raise ValueError(
            f"No cells match filter_expression '{filter_expression}'.")
    logger.info(f"{n_target:,}/{adata.n_obs:,} cells match filter")

    prefix = domain_prefix or _auto_prefix(filter_expression)

    lo, pixel, (H, W), r_buffer, r_shrink = raster_grid(
        coords, cell_dist_um, shrink_margin_um, grid_max_dim, pixels_per_dist)
    logger.info(f"Raster grid {H}x{W}, pixel={pixel:.2f}, "
                f"r_buffer={r_buffer}px, r_shrink={r_shrink}px")

    target_pix = to_pixels(coords[mask], lo, pixel, (H, W))
    assign_coords = coords if assign_all_cells else coords[mask]
    assign_pix = to_pixels(assign_coords, lo, pixel, (H, W))

    max_iter = geometry.CC_MAX_ITER
    res, _, capped = _buffer_union_shrink(target_pix, assign_pix, (H, W),
                                          r_buffer, r_shrink, device, max_iter)
    if capped:
        # the reference's loop stops here too, and its labels are kept
        logger.warning(
            f"make_spatial_domains: the connected-components loop stopped "
            f"at its cap of {max_iter} iterations on the {H}x{W} raster with "
            "labels still changing, so a long or winding domain may be "
            "reported as several domains")
    labels_np = res.labels.cpu().numpy()
    cell_label = res.cell_label.cpu().numpy()

    # map back to all cells
    full_label = np.full(adata.n_obs, int(_BG), np.int64)
    if assign_all_cells:
        full_label[:] = cell_label
    else:
        full_label[mask] = cell_label

    # --- reduction: merge small domains into adjacent, drop isolated ----
    bg = int(_BG)
    assigned = full_label != bg
    raw_ids = np.unique(full_label[assigned])
    if raw_ids.size == 0:
        raise ValueError(
            "No domains created. Try a larger cell_dist_um or check the "
            "filter expression.")

    target_counts = pd.Series(full_label[assigned & mask]).value_counts()
    total_counts = pd.Series(full_label[assigned]).value_counts()
    adjacency = label_adjacency(labels_np, reach_px=2)
    neighbors: dict = {}
    for u, v in adjacency:
        neighbors.setdefault(u, set()).add(v)
        neighbors.setdefault(v, set()).add(u)

    alive = {int(i) for i in raw_ids}
    remap: dict = {}

    def resolve(d):
        while d in remap:
            d = remap[d]
        return d

    small = [d for d in sorted(alive)
             if int(target_counts.get(d, 0)) <= min_target_cells_domain
             or (min_total_cells_domain is not None
                 and int(total_counts.get(d, 0)) <= min_total_cells_domain)]
    n_merged = n_dropped = 0
    for d in small:
        # sorted: neighbors is a set, and set iteration order made the
        # merge target (hence final domain names/sizes) vary across
        # Python builds; merge into the largest surviving neighbor,
        # ties by id (deterministic and matches the "absorb into the
        # dominant adjacent domain" intent)
        cands = sorted({resolve(x) for x in neighbors.get(d, ())})
        cands = [x for x in cands if x in alive and x != d and x not in small]
        if cands:
            tgt = max(cands, key=lambda x: (int(target_counts.get(x, 0)), -x))
            remap[d] = tgt
            alive.discard(d)
            n_merged += 1
        else:
            alive.discard(d)
            remap[d] = bg
            n_dropped += 1
    if small:
        logger.info(f"Reduced {len(small)} small domains: "
                    f"{n_merged} merged, {n_dropped} dropped")

    # vectorized id remap: a per-cell Python resolve() loop cost seconds
    # at 1M cells for a mapping with only len(raw_ids) distinct keys
    uniq_ids, inverse = np.unique(full_label, return_inverse=True)
    lut = np.array([resolve(int(u)) if u != bg else bg for u in uniq_ids],
                   np.int64)
    resolved = lut[inverse]
    assigned = resolved != bg

    if not assigned.any():
        raise ValueError(
            "All domains fell below the size thresholds; nothing to assign.")

    # --- renumber by size desc (largest = prefix_1) ----------------------
    final_counts = pd.Series(resolved[assigned]).value_counts()
    order = final_counts.index.to_list()  # value_counts sorts desc
    id_to_name = {int(d): f"{prefix}_{i + 1}" for i, d in enumerate(order)}
    name_lut = np.array([id_to_name.get(int(u), None)
                         if u != bg else None for u in lut], object)
    names = name_lut[inverse]
    categories = [f"{prefix}_{i + 1}" for i in range(len(order))]
    adata.obs[output_column] = pd.Categorical(names, categories=categories)

    n_assigned = int(assigned.sum())
    ratio = n_assigned / n_target
    if ratio > domain_expansion_warn_ratio:
        logger.warning(
            f"Domains contain {n_assigned:,} cells — {ratio:.1f}x the "
            f"{n_target:,} target cells (warn ratio "
            f"{domain_expansion_warn_ratio}). Check cell_dist_um.")

    summary = {
        "n_domains": len(order),
        "n_target_cells": n_target,
        "n_assigned_cells": n_assigned,
        "expansion_ratio": float(ratio),
        "platform": platform,
        "cell_dist_um": float(cell_dist_um),
        "shrink_margin_um": float(shrink_margin_um),
        "pixel_size": float(pixel),
        "domain_sizes": {id_to_name[int(d)]: int(final_counts[d])
                         for d in order},
    }
    adata.uns[f"{output_column}_params"] = summary

    if store_boundaries:
        bounds = extract_boundaries(labels_np, origin=lo, pixel_size=pixel)
        named = {}
        for raw_id, pts in bounds.items():
            rid = resolve(int(raw_id))
            if rid == bg or rid not in id_to_name:
                continue
            name = id_to_name[rid]
            named[name] = (np.vstack([named[name], pts])
                           if name in named else pts)
        adata.uns[f"{output_column}_boundaries"] = named

        # GIS-style ordered polygon chains (marching squares): per domain,
        # one [M, 2] array of closed vertex loops joined by NaN rows (the
        # matplotlib line-break convention; h5ad-serializable)
        polys = extract_boundary_polygons(labels_np, origin=lo,
                                          pixel_size=pixel)
        named_polys = {}
        nan_row = np.full((1, 2), np.nan, np.float32)
        for raw_id, loops in polys.items():
            rid = resolve(int(raw_id))
            if rid == bg or rid not in id_to_name or not loops:
                continue
            name = id_to_name[rid]
            joined = []
            for lp in loops:
                joined.extend([lp, nan_row])
            arr = np.vstack(joined[:-1])
            named_polys[name] = (
                np.vstack([named_polys[name], nan_row, arr])
                if name in named_polys else arr)
        adata.uns[f"{output_column}_polygons"] = named_polys

    elapsed = time.time() - start
    logger.info(f"Created {len(order)} domains in obs['{output_column}'] "
                f"({n_assigned:,} cells, {elapsed:.1f}s)")

    update_metadata(
        adata, "make_spatial_domains",
        parameters={"filter_expression": filter_expression,
                    "cell_dist_um": float(cell_dist_um),
                    "shrink_margin_um": float(shrink_margin_um),
                    "platform": platform,
                    "min_target_cells_domain": min_target_cells_domain,
                    "min_total_cells_domain": min_total_cells_domain,
                    "assign_all_cells": assign_all_cells},
        outputs={"obs": output_column,
                 "uns": f"{output_column}_params"})
    return adata


@param_aliases(domain_column="output_column")
def get_domain_summary(adata, output_column: str = "spatial_domain") -> pd.DataFrame:
    """Per-domain size table from a ``make_spatial_domains`` result."""
    key = f"{output_column}_params"
    if key not in adata.uns:
        raise KeyError(
            f"'{key}' not found in adata.uns; run make_spatial_domains "
            "first.")
    sizes = adata.uns[key]["domain_sizes"]
    df = pd.DataFrame({"domain": list(sizes), "n_cells": list(sizes.values())})
    return df.sort_values("n_cells", ascending=False).reset_index(drop=True)
