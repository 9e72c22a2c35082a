"""Domain-to-domain and cell-to-domain spatial distances.

Port of ``spatialcore_tpu/spatial/distance.py``. For every source cell, the
min and the sum of Euclidean distances to each target domain come from
one tiled pass on ``device``: source tiles × group-sorted target tiles,
padded to ``tile_s`` / ``tile_t`` with far-away points as in the reference
(:func:`_dists_to_groups`). The ``minimum`` / ``mean`` matrices and the
per-cell nearest-domain annotation fall out of that [n_src, n_domains]
result; ``centroid`` is a host computation.

``minimum`` is bitwise the reference's CPU run: d² rounds as its fused
loop does (``round(dx²)``, then one fused multiply-add of ``dy²``;
``core/rng._fma32``), the root is correctly rounded (``core/rng._sqrt32``),
and a minimum does not depend on order. The ``mean`` metric's per-group
sums are one-hot matrix products in float64 (the card's and the CPU's
orders differ far below a float32 ulp), where the reference adds in
float32, so it agrees within float32 rounding (rtol 1e-5).
"""

from __future__ import annotations

import time
from typing import List, Optional, Union

import numpy as np
import pandas as pd
import torch

from ..core.logging import get_logger
from ..core.metadata import update_metadata
from ..core.rng import _fma32, _sqrt32

logger = get_logger("spatial.distance")

Device = Union[str, torch.device]


def _pad_to(x, multiple, value):
    n = x.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return x
    return np.concatenate(
        [x, np.full((pad,) + x.shape[1:], value, x.dtype)], axis=0)


def _dists_to_groups(src: torch.Tensor, tgt: torch.Tensor,
                     tgt_gid: torch.Tensor, n_groups: int,
                     tile_s: int = 4096, tile_t: int = 2048):
    """Per source cell: (min, sum) of Euclidean distances to each group.

    ``src`` f32 [Ns, 2] and ``tgt`` f32 [Nt, 2] padded to multiples of the
    tiles with far-away points; ``tgt_gid`` int64 [Nt] group ids
    (``n_groups`` for padding), targets sorted by group. Returns two f32
    [Ns, n_groups] tensors on the inputs' device.
    """
    ns, nt = src.shape[0], tgt.shape[0]
    dev = src.device
    mins = torch.full((ns, n_groups + 1), float("inf"), dtype=torch.float32,
                      device=dev)
    sums = torch.zeros((ns, n_groups), dtype=torch.float64, device=dev)
    for t0 in range(0, nt, tile_t):
        t = tgt[t0:t0 + tile_t]
        g = tgt_gid[t0:t0 + tile_t]
        onehot = torch.nn.functional.one_hot(g, n_groups + 1)[:, :n_groups]
        onehot = onehot.to(torch.float64)
        for s0 in range(0, ns, tile_s):
            s = src[s0:s0 + tile_s]
            dx = s[:, None, 0] - t[None, :, 0]
            dy = s[:, None, 1] - t[None, :, 1]
            d = _sqrt32(_fma32(dy, dy, dx * dx))             # [Ts, Tt]
            mins[s0:s0 + tile_s].scatter_reduce_(
                1, g[None, :].expand_as(d), d, reduce="amin")
            sums[s0:s0 + tile_s] += d.to(torch.float64) @ onehot
    return mins[:, :n_groups], sums.to(torch.float32)


def calculate_domain_distances(
    adata,
    source_domain_column: str,
    target_domain_column: str,
    source_domain_subset: Optional[List[str]] = None,
    target_domain_subset: Optional[List[str]] = None,
    distance_metric: str = "minimum",
    output_mode: str = "both",
    output_distance_column: str = "distance_to_target",
    output_nearest_column: str = "nearest_target_domain",
    spatial_key: str = "spatial",
    copy: bool = False,
    device: Device = "cuda",
):
    """Distances from source-domain cells to target domains.

    Outputs (per ``output_mode``): ``obs[output_distance_column]`` /
    ``obs[output_nearest_column]`` for source cells, and
    ``uns['domain_distances']`` with the nested ``distance_matrix`` and a
    summary. Metrics: ``minimum`` (closest cell pair), ``centroid``,
    ``mean`` (average over all cell pairs). The pairwise pass runs on
    ``device``.
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    if spatial_key not in adata.obsm:
        raise ValueError(f"adata.obsm['{spatial_key}'] not found.")
    for col in (source_domain_column, target_domain_column):
        if col not in adata.obs.columns:
            raise ValueError(f"Column '{col}' not found in adata.obs.")
    if distance_metric not in ("minimum", "centroid", "mean"):
        raise ValueError(
            f"distance_metric must be minimum/centroid/mean, got "
            f"'{distance_metric}'")
    if output_mode not in ("cell", "matrix", "both"):
        raise ValueError(
            f"output_mode must be cell/matrix/both, got '{output_mode}'")

    xy = adata.obsm[spatial_key]
    if isinstance(xy, torch.Tensor):
        xy = xy.cpu().numpy()
    coords = np.asarray(xy, dtype=np.float32)[:, :2]
    src_series = adata.obs[source_domain_column]
    tgt_series = adata.obs[target_domain_column]

    source_domains = (list(source_domain_subset) if source_domain_subset
                      else sorted(src_series.dropna().unique().tolist()))
    target_domains = (list(target_domain_subset) if target_domain_subset
                      else sorted(tgt_series.dropna().unique().tolist()))
    missing = [d for d in source_domains
               if d not in set(src_series.dropna().unique())]
    missing += [d for d in target_domains
                if d not in set(tgt_series.dropna().unique())]
    if missing:
        raise ValueError(f"Domains not present: {missing}")
    if not source_domains or not target_domains:
        raise ValueError("No source or target domains found.")

    src_mask = src_series.isin(source_domains).to_numpy()
    tgt_mask = tgt_series.isin(target_domains).to_numpy()
    src_idx = np.nonzero(src_mask)[0]
    tgt_idx = np.nonzero(tgt_mask)[0]
    G = len(target_domains)
    tgt_name_to_g = {d: i for i, d in enumerate(target_domains)}
    tgt_gid = np.array([tgt_name_to_g[d]
                        for d in tgt_series.iloc[tgt_idx]], np.int32)

    logger.info(
        f"Distances: {len(src_idx):,} source cells "
        f"({len(source_domains)} domains) → {len(tgt_idx):,} target cells "
        f"({G} domains), metric={distance_metric}")

    if distance_metric == "centroid":
        mins = sums = None
    else:
        order = np.argsort(tgt_gid, kind="stable")
        tile_t = 2048 if len(tgt_idx) > 2048 else max(
            64, 1 << int(np.ceil(np.log2(max(len(tgt_idx), 1)))))
        tile_s = 4096 if len(src_idx) > 4096 else max(
            64, 1 << int(np.ceil(np.log2(max(len(src_idx), 1)))))
        big = np.float32(1e18)
        src_pad = _pad_to(coords[src_idx], tile_s, big)
        tgt_pad = _pad_to(coords[tgt_idx][order], tile_t, big)
        gid_pad = _pad_to(tgt_gid[order], tile_t, np.int32(G))
        mins_t, sums_t = _dists_to_groups(
            torch.as_tensor(src_pad, device=device),
            torch.as_tensor(tgt_pad, device=device),
            torch.as_tensor(gid_pad.astype(np.int64), device=device),
            n_groups=G, tile_s=tile_s, tile_t=tile_t)
        mins = mins_t[:len(src_idx)].cpu().numpy()
        sums = sums_t[:len(src_idx)].cpu().numpy()

    # --- per-cell annotation --------------------------------------------
    if output_mode in ("cell", "both"):
        if distance_metric == "centroid":
            cent = np.stack([coords[tgt_idx][tgt_gid == g].mean(axis=0)
                             for g in range(G)])
            d_cell = np.sqrt(((coords[src_idx][:, None, :]
                               - cent[None, :, :]) ** 2).sum(-1))
        else:
            d_cell = mins
        nearest_g = d_cell.argmin(axis=1)
        dist_col = np.full(adata.n_obs, np.nan, np.float64)
        near_col = np.full(adata.n_obs, None, object)
        dist_col[src_idx] = d_cell[np.arange(len(src_idx)), nearest_g]
        near_col[src_idx] = [target_domains[g] for g in nearest_g]
        adata.obs[output_distance_column] = dist_col
        adata.obs[output_nearest_column] = pd.Categorical(
            near_col, categories=target_domains)

    # --- domain matrix ----------------------------------------------------
    if output_mode in ("matrix", "both"):
        src_gid = np.array(
            [source_domains.index(d) for d in src_series.iloc[src_idx]])
        matrix: dict = {}
        tgt_counts = np.bincount(tgt_gid, minlength=G)
        for si, sname in enumerate(source_domains):
            rows = src_gid == si
            matrix[sname] = {}
            for ti, tname in enumerate(target_domains):
                if distance_metric == "minimum":
                    val = float(mins[rows, ti].min())
                elif distance_metric == "mean":
                    val = float(sums[rows, ti].sum()
                                / (rows.sum() * tgt_counts[ti]))
                else:
                    src_cent = coords[src_idx][rows].mean(axis=0)
                    tgt_cent = coords[tgt_idx][tgt_gid == ti].mean(axis=0)
                    val = float(np.linalg.norm(src_cent - tgt_cent))
                matrix[sname][tname] = val
        adata.uns["domain_distances"] = {
            "distance_matrix": matrix,
            "metric": distance_metric,
            "source_column": source_domain_column,
            "target_column": target_domain_column,
            "source_domains": source_domains,
            "target_domains": target_domains,
        }

    logger.info(f"Domain distances done ({time.time() - start:.1f}s)")
    update_metadata(
        adata, "calculate_domain_distances",
        parameters={"source_domain_column": source_domain_column,
                    "target_domain_column": target_domain_column,
                    "distance_metric": distance_metric,
                    "output_mode": output_mode},
        outputs={"obs": [output_distance_column, output_nearest_column]
                 if output_mode in ("cell", "both") else [],
                 "uns": "domain_distances"
                 if output_mode in ("matrix", "both") else None})
    return adata


def get_distance_matrix(adata, key: str = "domain_distances") -> pd.DataFrame:
    """The stored domain distance matrix as a DataFrame (src rows, tgt cols)."""
    if key not in adata.uns:
        raise KeyError(
            f"'{key}' not found in adata.uns. Run calculate_domain_distances "
            "with output_mode='matrix' or 'both' first.")
    data = adata.uns[key]
    if "distance_matrix" not in data:
        raise KeyError(f"'distance_matrix' not found in adata.uns['{key}']")
    return pd.DataFrame(data["distance_matrix"]).T
