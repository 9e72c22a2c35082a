"""Fixed-degree spatial neighbour graphs — the weights matrix as tensors.

Port of ``spatialcore_tpu/ops/graph.py``. W is a fixed-degree structure:

    neighbor_idx : int64[N, k]  — column indices per row (torch's index type;
                                  the reference stores int32)
    neighbor_w   : f32[N, k]    — row-normalized weights (0 where invalid)
    valid        : bool[N, k]
    distances    : f32[N, k]

kNN search is an exact tiled all-pairs scan in torch ops (:func:`knn_exact`),
a uniform-grid bucket search with an exactness check and widening rounds
(:func:`knn_grid`), or the exact all-pairs scan of the hand-written kernel
that replaces the Pallas kNN K9 (``ops/knn_kernel.pallas_knn``). All return
neighbours sorted by (distance, id), so ties break by the lower cell id.
Radius graphs (:func:`radius_neighbors`) cap the degree at ``k_max`` with a
validity mask on top of the same searches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..core.logging import get_logger
from ..utils.profiling import set_count, traced

logger = get_logger("ops.graph")

_M32 = 0xFFFFFFFF
_NO_CANDIDATE = torch.iinfo(torch.int64).max


class SpatialGraph(NamedTuple):
    """Fixed-degree row-normalized spatial weights."""

    neighbor_idx: torch.Tensor  # int64 [N, k]
    neighbor_w: torch.Tensor    # float32 [N, k], rows sum to 1
    valid: torch.Tensor         # bool [N, k]
    distances: torch.Tensor     # float32 [N, k], +inf where invalid

    @property
    def n_cells(self) -> int:
        return self.neighbor_idx.shape[0]

    @property
    def degree(self) -> int:
        return self.neighbor_idx.shape[1]

    def to_csr(self):
        """Export to scipy CSR (host-side), matching the reference's W."""
        import scipy.sparse as sp

        idx = self.neighbor_idx.cpu().numpy()
        w = self.neighbor_w.cpu().numpy()
        valid = self.valid.cpu().numpy()
        n, k = idx.shape
        rows = np.repeat(np.arange(n), k)[valid.ravel()]
        cols = idx.ravel()[valid.ravel()]
        data = w.ravel()[valid.ravel()]
        return sp.csr_matrix((data, (rows, cols)), shape=(n, n))


def graph_from_numpy(g, device: Union[str, torch.device] = "cuda") -> SpatialGraph:
    """Build a port graph from a reference graph's arrays.

    ``g`` is either the ``uns["spatial_graph"]`` dict that
    ``build_spatial_weights`` stores, or any object with the four
    ``SpatialGraph`` fields (such as the JAX package's graph); each field
    is copied to a new host array first.
    """
    get = g.__getitem__ if isinstance(g, dict) else (lambda f: getattr(g, f))
    return SpatialGraph(
        neighbor_idx=torch.as_tensor(np.array(get("neighbor_idx"), np.int64),
                                     device=device),
        neighbor_w=torch.as_tensor(np.array(get("neighbor_w"), np.float32),
                                   device=device),
        valid=torch.as_tensor(np.array(get("valid"), bool), device=device),
        distances=torch.as_tensor(np.array(get("distances"), np.float32),
                                  device=device),
    )


# ---------------------------------------------------------------------------
# Top-k by (distance, id)
# ---------------------------------------------------------------------------


def _dist_id_key(d2: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 sort key ordering candidates by (squared distance, id).

    Non-negative float32 values order like their bit patterns, so the
    distance bits in the high word and the id in the low word give one
    key whose ascending order is distance first, ties by the lower id.
    Invalid candidates (``ids < 0`` or infinite distance) sort last.
    """
    bits = d2.contiguous().view(torch.int32).to(torch.int64)
    key = (bits << 32) | (ids.to(torch.int64) & _M32)
    bad = (ids < 0) | torch.isinf(d2)
    return torch.where(bad, torch.full_like(key, _NO_CANDIDATE), key)


def _topk_by_key(key: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """k smallest keys per row → (ids int64 (-1 if none), squared dist f32)."""
    best = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    none = best == _NO_CANDIDATE
    ids = torch.where(none, torch.full_like(best, -1), best & _M32)
    d2 = (best >> 32).to(torch.int32).view(torch.float32)
    d2 = torch.where(none, torch.full_like(d2, float("inf")), d2)
    return ids, d2


# ---------------------------------------------------------------------------
# Exact tiled kNN
# ---------------------------------------------------------------------------


def knn_scan(c: torch.Tensor, k: int, include_self: bool = False,
             queries: Optional[torch.Tensor] = None, tile_elems: int = 1 << 24
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest points of ``c`` [N, D] (float32) to every point, or to
    the points ``queries`` (int64 ids), by all-pairs squared distances
    over query tiles of about ``tile_elems`` distances.

    Returns ``(ids int64[q, k], d2 f32[q, k])`` sorted ascending by
    (d2, id); a query's own point is left out unless ``include_self``.
    Each coordinate difference, each square and the sum are separate
    float32 operations.
    """
    n = c.shape[0]
    ids = torch.arange(n, device=c.device)
    q_ids = ids if queries is None else queries
    tile = max(1, tile_elems // max(n, 1))
    out_i, out_d = [], []
    for q0 in range(0, q_ids.shape[0], tile):
        qi = q_ids[q0:q0 + tile]
        d2 = ((c[qi][:, None, :] - c[None, :, :]) ** 2).sum(-1)
        if not include_self:
            d2[torch.arange(qi.shape[0], device=c.device), qi] = float("inf")
        bi, bd = _topk_by_key(_dist_id_key(d2, ids.expand_as(d2)), k)
        out_i.append(bi)
        out_d.append(bd)
    return torch.cat(out_i), torch.cat(out_d)


def knn_exact(coords: torch.Tensor, k: int, include_self: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN by tiled all-pairs squared distances (:func:`knn_scan`).

    Returns ``(indices int64[N, k], distances f32[N, k])`` sorted ascending
    by (distance, id). Self is excluded unless ``include_self``. Coordinates
    are centred first, as the reference does for float32 conditioning
    (spatialcore_tpu/ops/graph.py:91-153).
    """
    n = coords.shape[0]
    if k >= n:
        raise ValueError(f"k={k} must be < n_cells={n}")
    c = coords.to(torch.float32)
    idx, d2 = knn_scan(c - c.mean(dim=0, keepdim=True), k, include_self)
    return idx, torch.sqrt(d2)


# ---------------------------------------------------------------------------
# Grid-bucketed kNN for large N (exact, adaptive window)
# ---------------------------------------------------------------------------


def _bucket_knn_round(q_coords, q_ids, qbx, qby, table, tcoords,
                      nbx: int, nby: int, k: int, r: int,
                      include_self: bool, tile: int):
    """k best candidates from the (2r+1)² bucket window of each query.

    Candidates of all window buckets are scored together and the k
    smallest by (distance, id) are kept. Queries run in tiles of ``tile``.
    """
    out_i, out_d = [], []
    offs = [(dx, dy) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    for t0 in range(0, q_coords.shape[0], tile):
        qc = q_coords[t0:t0 + tile]
        qi = q_ids[t0:t0 + tile]
        bx_t = qbx[t0:t0 + tile]
        by_t = qby[t0:t0 + tile]
        keys = []
        for dx, dy in offs:
            gx = bx_t + dx
            gy = by_t + dy
            ok = (gx >= 0) & (gx < nbx) & (gy >= 0) & (gy < nby)
            b = torch.where(ok, gx * nby + gy, torch.zeros_like(gx))
            cand = table[b]                                  # [T, C]
            valid = (cand >= 0) & ok[:, None]
            if not include_self:
                valid &= cand != qi[:, None]
            cc = tcoords[b]                                  # [T, C, 2]
            d2 = ((qc[:, None, :] - cc) ** 2).sum(-1)
            d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
            keys.append(_dist_id_key(d2, torch.where(valid, cand,
                                                     torch.full_like(cand, -1))))
        bi, bd = _topk_by_key(torch.cat(keys, dim=1), k)
        out_i.append(bi)
        out_d.append(bd)
    return torch.cat(out_i), torch.cat(out_d)


def knn_grid(coords, k: int, include_self: bool = False,
             bucket_target: int = 32, tile: int = 8192, max_rounds: int = 6,
             fallback_chunk: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN via uniform-grid buckets, on ``coords``' device.

    Port of ``spatialcore_tpu/ops/graph.py:279-437``. Each cell searches a
    3×3 bucket window; a cell whose kth-neighbour distance exceeds the
    window's guaranteed-covered radius is searched again with a window of
    radius 2, 4, ... buckets, and cells still unresolved after
    ``max_rounds`` fall back to an exact host scan. Results equal the
    all-pairs scan, sorted by (distance, id).
    """
    c = coords.to(torch.float32)
    dev = c.device
    n, d = c.shape
    if d != 2:
        raise ValueError("knn_grid currently supports 2D coordinates")
    if k >= n:
        raise ValueError(f"k={k} must be < n_cells={n}")
    # buckets must hold ~2(k+1) cells or every query pays widening rounds
    bucket_target = max(bucket_target, 2 * (k + 1))
    cap = 1 << max(int(np.ceil(np.log2(max(1, n // bucket_target)))), 0)
    mins = c.min(dim=0).values
    span = torch.clamp_min(c.max(dim=0).values - mins, 1e-9)
    nbt = max(1, n // bucket_target)
    nbx_t = torch.floor(torch.sqrt(nbt * (span[0] / span[1]))).to(torch.int64)
    nbx = int(min(max(int(nbx_t), 1), cap))
    nby = int(min(max(nbt // nbx, 1), max(cap // nbx, 1)))
    h = span / torch.tensor([nbx, nby], dtype=torch.float32, device=dev)
    bx = torch.clamp(torch.floor((c[:, 0] - mins[0]) / h[0]).to(torch.int64),
                     0, nbx - 1)
    by = torch.clamp(torch.floor((c[:, 1] - mins[1]) / h[1]).to(torch.int64),
                     0, nby - 1)
    bucket = bx * nby + by
    counts = torch.bincount(bucket, minlength=cap)
    h_np = h.cpu().numpy()
    maxc = int(counts.max())
    C = max(-(-maxc // 16) * 16, 16)
    order = torch.argsort(bucket, stable=True)
    sb = bucket[order]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=dev) - starts[sb]
    table = torch.full((cap, C), -1, dtype=torch.int64, device=dev)
    table[sb, pos] = order
    tcoords = torch.where((table >= 0)[:, :, None], c[table.clamp_min(0)],
                          torch.full((), 1e18, device=dev))

    t = min(tile, 1 << max(int(np.ceil(np.log2(max(n, 1)))), 6))
    ids = torch.arange(n, device=dev)
    bi, bd = _bucket_knn_round(c, ids, bx, by, table, tcoords, nbx, nby,
                               k, 1, include_self, t)
    hmin = np.float32(min(h_np[0], h_np[1]))
    whole_grid = 3 >= 2 * max(nbx, nby) + 1
    if whole_grid:
        return bi, torch.sqrt(bd)
    ok = bd[:, k - 1] <= float(hmin * hmin)
    if bool(ok.all()):
        return bi, torch.sqrt(bd)

    out_idx = torch.where(ok[:, None], bi, torch.full_like(bi, -1))
    out_d2 = torch.where(ok[:, None], bd, torch.full_like(bd, float("inf")))
    unresolved = torch.nonzero(~ok).flatten()
    r = 2
    for _ in range(1, max_rounds):
        if unresolved.numel() == 0:
            break
        nq = unresolved.numel()
        t = min(tile, 1 << max(int(np.ceil(np.log2(max(nq, 1)))), 6))
        bi, bd = _bucket_knn_round(c[unresolved], unresolved, bx[unresolved],
                                   by[unresolved], table, tcoords, nbx, nby,
                                   k, r, include_self, t)
        guaranteed = np.float32(r) * hmin
        if 2 * r + 1 >= 2 * max(nbx, nby) + 1:
            ok = torch.ones(nq, dtype=torch.bool, device=dev)
        else:
            ok = bd[:, k - 1] <= float(guaranteed * guaranteed)
        done = unresolved[ok]
        out_idx[done] = bi[ok]
        out_d2[done] = bd[ok]
        unresolved = unresolved[~ok]
        r *= 2
    if unresolved.numel():
        # pathological remainder: exact host scan for those queries only,
        # chunked so the dense [chunk, N] distance block stays bounded
        coords_host = c.cpu().numpy()
        urc_all = unresolved.cpu().numpy()
        chunk = fallback_chunk or max(1, (1 << 28) // n)
        all_ids = np.arange(n, dtype=np.int64)
        for c0 in range(0, urc_all.size, chunk):
            urc = urc_all[c0:c0 + chunk]
            dd = ((coords_host[urc][:, None, :]
                   - coords_host[None, :, :]) ** 2).sum(-1).astype(np.float32)
            if not include_self:
                dd[np.arange(urc.size), urc] = np.inf
            key = (dd.view(np.int32).astype(np.int64) << 32) | all_ids[None, :]
            part = np.sort(np.partition(key, k - 1, axis=1)[:, :k], axis=1)
            out_idx[torch.as_tensor(urc, device=dev)] = torch.as_tensor(
                part & _M32, device=dev)
            out_d2[torch.as_tensor(urc, device=dev)] = torch.as_tensor(
                (part >> 32).astype(np.int32).view(np.float32), device=dev)
    return out_idx, torch.sqrt(out_d2)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


@traced("ops.graph.radius_neighbors")
def radius_neighbors(coords, radius: float, k_max: int,
                     include_self: bool = False, grid_threshold: int = 20_000,
                     device: Union[str, torch.device] = "cuda"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Neighbours within ``radius``, at most ``k_max`` per cell (reference
    ``radius_neighbors``, spatialcore_tpu/ops/graph.py:444-493).

    Returns ``(indices int64, distances f32, valid bool)``, [N, k_max]
    (``n − 1`` columns when ``k_max ≥ n − 1``), sorted by (distance, id);
    invalid slots hold index −1 and distance inf. ``k_max + 1`` neighbours
    are searched, so a cell with exactly ``k_max`` in radius is complete and
    one with more raises: the cap is checked, never silently truncated.
    2D inputs above ``grid_threshold`` cells take the bucket-grid search
    (:func:`knn_grid`), others the exact scan (:func:`knn_exact`). A tensor
    ``coords`` stays on its device; others go to ``device``. The cells with
    no neighbour in radius are counted in ``graph.radius_isolated``.
    """
    c = (coords if isinstance(coords, torch.Tensor) else torch.as_tensor(
        np.asarray(coords, dtype=np.float32), device=device))
    c = c.to(torch.float32)
    n = c.shape[0]
    if min(k_max, n - 1) < 1:
        raise ValueError(f"radius_neighbors needs >= 2 cells, got {n}")
    k_search = min(k_max + 1, n - 1)
    if n > grid_threshold and c.shape[1] == 2:
        idx, dist = knn_grid(c, k_search, include_self=include_self)
    else:
        idx, dist = knn_exact(c, k_search, include_self=include_self)
    # the reference compares float32 distances with the radius as float32
    r32 = torch.tensor(radius, dtype=torch.float32, device=c.device)
    if k_search > min(k_max, n - 1):
        overflow = dist[:, k_max] <= r32
        if bool(overflow.any()):
            n_over = int(overflow.sum())
            raise ValueError(
                f"{n_over} cells have more than k_max={k_max} neighbors "
                f"within radius={radius}. Increase k_max (or reduce "
                f"radius).")
        idx, dist = idx[:, :k_max], dist[:, :k_max]
    valid = dist <= r32
    set_count("graph.radius_isolated", int((~valid.any(dim=1)).sum()))
    idx = torch.where(valid, idx, torch.full_like(idx, -1))
    dist = torch.where(valid, dist, torch.full_like(dist, float("inf")))
    return idx, dist, valid


@traced("ops.graph.build_graph")
def build_graph(coords, n_neighbors: int = 6, include_self: bool = False,
                radius: Optional[float] = None, k_max: Optional[int] = None,
                method: str = "auto", grid_threshold: int = 20_000,
                device: Union[str, torch.device] = "cuda") -> SpatialGraph:
    """Build a row-normalized fixed-degree weights graph on ``device``.

    kNN mode reproduces the reference's ``build_graph``: binary adjacency
    over the k nearest neighbours (self excluded unless ``include_self``,
    which adds self as an extra neighbour), rows normalized to sum to 1.
    ``method``: "auto" (grid search above ``grid_threshold`` 2D cells,
    else the exact scan), "grid", "exact", or "pallas": the exact all-pairs
    kNN kernel (``ops/knn_kernel.pallas_knn``; the hand-written Hopper
    kernel on the card, its plain version on the CPU), 2D only, with the
    coordinates centred by their numpy float32 mean as the reference's
    ``pallas_knn`` centres them.

    Radius mode (``radius`` with its ``k_max`` cap; :func:`radius_neighbors`
    at its default grid threshold, as the reference) weights each valid
    slot 1/count in float32; invalid slots hold index 0 and weight 0, and
    a cell with no neighbour in radius has an all-zero row.
    """
    if method not in ("auto", "grid", "exact", "pallas"):
        raise ValueError(f"unknown kNN method {method!r}")
    c = torch.as_tensor(coords).to(device=device, dtype=torch.float32)
    n = c.shape[0]
    if radius is not None:
        if k_max is None:
            raise ValueError("radius mode requires k_max")
        idx, dist, valid = radius_neighbors(c, radius, k_max, include_self)
        counts = valid.sum(dim=1, dtype=torch.int32).clamp_min(1)
        w = valid.to(torch.float32) / counts[:, None].to(torch.float32)
        return SpatialGraph(
            neighbor_idx=torch.where(valid, idx, torch.zeros_like(idx)),
            neighbor_w=w, valid=valid, distances=dist)
    k_eff = n_neighbors + (1 if include_self else 0)
    use_grid = method == "grid" or (
        method == "auto" and n > grid_threshold and c.shape[1] == 2)
    if method == "pallas":
        from .knn_kernel import pallas_knn   # kernels.knn imports this module

        idx, dist = pallas_knn(c, k_eff, include_self=include_self,
                               device=c.device)
    elif use_grid:
        idx, dist = knn_grid(c, k_eff, include_self=include_self)
    else:
        idx, dist = knn_exact(c, k_eff, include_self=include_self)
    return SpatialGraph(
        neighbor_idx=idx,
        neighbor_w=torch.full(idx.shape, 1.0 / k_eff, dtype=torch.float32,
                              device=c.device),
        valid=torch.ones(idx.shape, dtype=torch.bool, device=c.device),
        distances=dist)


# ---------------------------------------------------------------------------
# SpMV: lag = W @ Z (k gathers + weighted sum)
# ---------------------------------------------------------------------------


def spatial_lag(graph: SpatialGraph, Z: torch.Tensor,
                perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``W @ Z`` for Z of shape [N] or [N, G]: k row gathers, weighted sum.

    One row a graph row: a graph of a row range (:func:`graph_rows`) gives
    those rows' lags of the whole ``Z``. With ``perm`` the lag is that of
    ``Z[perm]``, gathered through the composite index ``perm[idx]``."""
    squeeze = Z.ndim == 1
    if squeeze:
        Z = Z[:, None]
    lag = torch.zeros((graph.neighbor_idx.shape[0],) + Z.shape[1:],
                      dtype=Z.dtype, device=Z.device)
    for j in range(graph.neighbor_idx.shape[1]):
        idx = graph.neighbor_idx[:, j]
        lag += graph.neighbor_w[:, j:j + 1] * Z[idx if perm is None else perm[idx]]
    return lag[:, 0] if squeeze else lag


def graph_rows(graph: SpatialGraph, rows: Optional[Tuple[int, int]]
               ) -> SpatialGraph:
    """The graph's rows [r0, r1) (its neighbour indices still address all
    N cells); the whole graph for ``rows=None``."""
    if rows is None:
        return graph
    r0, r1 = rows
    return SpatialGraph(*(f[r0:r1] for f in graph))


def graph_moments(graph: SpatialGraph) -> dict:
    """S0, S1, S2 — the Cliff-Ord weight sums used by analytic variances.

    S0 = ΣΣ w_ij ;  S1 = ½ ΣΣ (w_ij + w_ji)² ;  S2 = Σ_i (w_i· + w_·i)².
    Computed host-side in float64 from the CSR export, as the reference.
    """
    W = graph.to_csr().astype(np.float64)
    Wt = W.T.tocsr()
    S0 = float(W.sum())
    sym = W + Wt
    S1 = 0.5 * float(sym.multiply(sym).sum())
    row = np.asarray(W.sum(axis=1)).ravel()
    col = np.asarray(W.sum(axis=0)).ravel()
    S2 = float(((row + col) ** 2).sum())
    return {"S0": S0, "S1": S1, "S2": S2, "n": W.shape[0]}
