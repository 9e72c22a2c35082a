"""Exact k nearest neighbours in plain PyTorch.

The graph a configuration states: for every point its k nearest other
points by squared distance computed in float32 from the float32
coordinates (each difference, each square and their sum a float32
operation), ties to the lower index. A uniform bucket grid (about k
points a bucket) gives each query the points of the (2R+1)² buckets
around its own; a query whose k-th distance reaches past what those
buckets cover is searched again with R doubled, and after a few rounds
against every point.
"""

from __future__ import annotations

import math

import torch

_ROUNDS = (1, 2, 4, 8)


def _d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).sum(-1)


def _ranked(cand: torch.Tensor, d2: torch.Tensor, k: int):
    """The k best of each row by (d2, index): sort by index, then a stable
    sort by distance."""
    cand, j = torch.sort(cand, dim=1)
    d2 = torch.gather(d2, 1, j)
    d, j = torch.sort(d2, dim=1, stable=True)
    return torch.gather(cand, 1, j[:, :k]), d[:, :k]


def _brute(xy: torch.Tensor, q: torch.Tensor, k: int):
    n = xy.shape[0]
    chunk = max(1, (1 << 27) // n)
    ids, d2s = [], []
    for s in range(0, q.numel(), chunk):
        qq = q[s:s + chunk]
        d2 = _d2(xy[qq, None, :], xy[None, :, :])
        d2[torch.arange(qq.numel(), device=xy.device), qq] = float("inf")
        cand = torch.arange(n, device=xy.device).expand(qq.numel(), n)
        i, d = _ranked(cand, d2, k)
        ids.append(i)
        d2s.append(d)
    return torch.cat(ids), torch.cat(d2s)


def knn(coords: torch.Tensor, k: int):
    """(idx int64 [N, k], float32 d2 [N, k]) of every point's k nearest
    other points, nearest first."""
    xy = coords.to(torch.float32)
    n = xy.shape[0]
    dev = xy.device
    x64 = xy.to(torch.float64)
    lo = x64.min(dim=0).values
    span = torch.clamp_min(x64.max(dim=0).values - lo, 1e-30)
    h = math.sqrt(k * float(span[0]) * float(span[1]) / n) or 1.0
    nx = int(float(span[0]) // h) + 1
    ny = int(float(span[1]) // h) + 1
    b = torch.floor((x64 - lo) / h).to(torch.int64)
    bx, by = b[:, 0].clamp(0, nx - 1), b[:, 1].clamp(0, ny - 1)
    bid = bx * ny + by
    order = torch.argsort(bid, stable=True)
    counts = torch.bincount(bid, minlength=nx * ny)
    starts = torch.cumsum(counts, 0) - counts
    M = int(counts.max())
    lane = torch.arange(M, device=dev)
    idx_out = torch.empty((n, k), dtype=torch.int64, device=dev)
    d2_out = torch.empty((n, k), dtype=torch.float32, device=dev)
    todo = torch.arange(n, device=dev)
    for R in _ROUNDS:
        if todo.numel() == 0:
            break
        offs = [(dx, dy) for dx in range(-R, R + 1) for dy in range(-R, R + 1)]
        chunk = max(256, (1 << 25) // (len(offs) * M))
        short_all = []
        for s in range(0, todo.numel(), chunk):
            q = todo[s:s + chunk]
            qx, qy = bx[q], by[q]
            cands = []
            for dx, dy in offs:
                cx, cy = qx + dx, qy + dy
                ok = (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
                cb = torch.where(ok, cx * ny + cy, torch.zeros_like(cx))
                cnt = torch.where(ok, counts[cb], torch.zeros_like(cx))
                pos = starts[cb][:, None] + lane[None, :]
                live = lane[None, :] < cnt[:, None]
                cands.append(torch.where(live, order[pos.clamp_max(n - 1)],
                                         torch.full_like(pos, -1)))
            cand = torch.cat(cands, dim=1)
            d2 = _d2(xy[cand.clamp_min(0)], xy[q][:, None, :])
            d2 = torch.where((cand < 0) | (cand == q[:, None]),
                             torch.full_like(d2, float("inf")), d2)
            cand = torch.where(cand < 0, torch.full_like(cand, n), cand)
            i, d = _ranked(cand, d2, k)
            idx_out[q], d2_out[q] = i, d
            # what the block covers: the distance to its nearest side that
            # has buckets beyond it (a margin for the float32 distances)
            inf = torch.full_like(x64[q, 0], float("inf"))
            px, py = x64[q, 0] - lo[0], x64[q, 1] - lo[1]
            reach = torch.minimum(
                torch.minimum(torch.where(qx - R > 0, px - (qx - R) * h, inf),
                              torch.where(qx + R + 1 < nx,
                                          (qx + R + 1) * h - px, inf)),
                torch.minimum(torch.where(qy - R > 0, py - (qy - R) * h, inf),
                              torch.where(qy + R + 1 < ny,
                                          (qy + R + 1) * h - py, inf)))
            short = ~(d[:, k - 1].to(torch.float64) < reach * reach
                      * (1 - 1e-5))
            short_all.append(q[short])
        todo = torch.cat(short_all)
    if todo.numel():
        i, d = _brute(xy, todo, k)
        idx_out[todo], d2_out[todo] = i, d
    return idx_out, d2_out


def point_d2(coords: torch.Tensor, rows: torch.Tensor, nbr: torch.Tensor):
    """float64 squared distances from cells ``rows`` to their listed
    neighbours ``nbr`` [len(rows), k]."""
    xy = coords.to(torch.float64)
    return ((xy[nbr] - xy[rows][:, None, :]) ** 2).sum(-1)
