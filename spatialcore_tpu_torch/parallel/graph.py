"""kNN graph construction with the query tiles split over a mesh's ranks.

Port of ``spatialcore_tpu/parallel/graph.py``. The bucket-grid kNN
(``ops.graph.knn_grid``) searches query tiles against a bucket table that
every rank holds whole, so the tiles split over the ranks with no
communication until one all-gather of the results. The exactness check and
the (rare) wider-window fallback stay the single-device path's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.logging import get_logger
from ..ops.graph import SpatialGraph, _bucket_knn_round
from .stats import all_gather

logger = get_logger("parallel.graph")


def _bucket_table(coords_np: np.ndarray, bucket_target: int):
    """The host bucket table, as the reference builds it: (bx, by, table
    int64 [nbx·nby, C] with −1 padding, nbx, nby, h)."""
    n = coords_np.shape[0]
    mins = coords_np.min(axis=0)
    span = np.maximum(coords_np.max(axis=0) - mins, 1e-9)
    n_buckets_total = max(1, int(n / bucket_target))
    aspect = span[0] / span[1]
    nbx = max(1, int(np.sqrt(n_buckets_total * aspect)))
    nby = max(1, n_buckets_total // max(nbx, 1))
    h = span / np.array([nbx, nby])
    bx = np.minimum((coords_np[:, 0] - mins[0]) // h[0], nbx - 1).astype(np.int64)
    by = np.minimum((coords_np[:, 1] - mins[1]) // h[1], nby - 1).astype(np.int64)
    bucket = bx * nby + by
    order = np.argsort(bucket, kind="stable")
    counts = np.bincount(bucket[order], minlength=nbx * nby)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    C = max(int(counts.max()), 1)
    table = np.full((nbx * nby, C), -1, np.int64)
    pos = np.arange(n) - offsets[bucket[order]]
    table[bucket[order], pos] = order
    return bx, by, table, nbx, nby, h


def _r_knn_tiles(rank: int, world: int, coords: torch.Tensor, bx, by, table,
                 nbx: int, nby: int, k: int, include_self: bool, tile: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's block of query tiles (tiles split evenly over ``world``
    ranks), padded to the block's full length: (ids int64 −1, squared
    distances inf on the padding)."""
    n = coords.shape[0]
    per = -(-(-(-n // tile)) // world) * tile          # rows a rank
    q0, q1 = min(rank * per, n), min((rank + 1) * per, n)
    tcoords = torch.where((table >= 0)[:, :, None], coords[table.clamp_min(0)],
                          torch.full((), 1e18, device=coords.device))
    ids = torch.arange(q0, q1, device=coords.device)
    if q1 > q0:
        bi, bd = _bucket_knn_round(coords[q0:q1], ids, bx[q0:q1], by[q0:q1],
                                   table, tcoords, nbx, nby, k, 1,
                                   include_self, tile)
    else:                                  # more ranks than tiles
        bi = ids.new_empty((0, k))
        bd = coords.new_empty((0, k))
    pad = per - (q1 - q0)
    if pad:
        bi = torch.cat([bi, torch.full((pad, k), -1, dtype=bi.dtype,
                                       device=bi.device)])
        bd = torch.cat([bd, torch.full((pad, k), float("inf"),
                                       device=bd.device)])
    return bi, bd


def _all_gather(t: torch.Tensor, mesh) -> torch.Tensor:
    """Concatenate every rank's ``t`` in flat mesh order (cells-major):
    across ``genes``, then across ``cells``."""
    for axis in ("genes", "cells"):
        size = mesh.size(mesh.mesh_dim_names.index(axis))
        if size > 1:
            out = torch.empty((size * t.shape[0],) + t.shape[1:],
                              dtype=t.dtype, device=t.device)
            all_gather(out, t, mesh.get_group(axis))
            t = out
    return t


def sharded_knn(coords_np, k: int, mesh, include_self: bool = False,
                bucket_target: int = 32, tile: int = 8192):
    """Exact kNN with the query tiles split over every rank of the mesh.

    Returns ``(indices int64 [N, k], distances f32 [N, k])`` whole on every
    rank, on the mesh's device, sorted by (distance, id): equal to
    ``ops.graph.knn_grid``. A query whose kth distance exceeds the 3×3
    window's guaranteed radius sends every rank to the single-device
    ``knn_grid`` for the whole result, as the reference does.
    """
    from ..ops.graph import knn_grid

    coords_np = np.asarray(coords_np, np.float32)
    n = coords_np.shape[0]
    if coords_np.shape[1] != 2:
        raise ValueError("sharded_knn supports 2D coordinates")
    if k >= n:
        raise ValueError(f"k={k} must be < n_cells={n}")
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    bx, by, table, nbx, nby, h = _bucket_table(coords_np, bucket_target)
    coords = torch.as_tensor(coords_np, device=device)
    dev = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    world = int(np.prod(mesh.shape))
    rank = int(mesh.get_coordinate()[0]) * mesh.size(1) + int(
        mesh.get_coordinate()[1])
    bi, bd = _r_knn_tiles(rank, world, coords, dev(bx), dev(by), dev(table),
                          nbx, nby, k, include_self, tile)
    bi, bd = _all_gather(bi, mesh)[:n], _all_gather(bd, mesh)[:n]
    guaranteed = float(min(h[0], h[1]))
    ok = bd[:, k - 1].cpu().numpy() <= guaranteed ** 2
    if not ok.all():
        logger.info(f"sharded_knn: {int((~ok).sum()):,} cells re-resolved "
                    "with the single-device wide-window path")
        return knn_grid(coords, k, include_self=include_self)
    return bi, torch.sqrt(bd)


def sharded_build_graph(coords, mesh, n_neighbors: int = 6,
                        include_self: bool = False) -> SpatialGraph:
    """Row-normalized fixed-degree graph built with the rank-split search."""
    k = n_neighbors + (1 if include_self else 0)
    if isinstance(coords, torch.Tensor):
        coords = coords.cpu().numpy()
    idx, dist = sharded_knn(np.asarray(coords, np.float32), k, mesh,
                            include_self=include_self)
    return SpatialGraph(
        neighbor_idx=idx,
        neighbor_w=torch.full(idx.shape, 1.0 / idx.shape[1],
                              dtype=torch.float32, device=idx.device),
        valid=torch.ones(idx.shape, dtype=torch.bool, device=idx.device),
        distances=dist)
