"""Ripley's K / L, cross-type K and co-occurrence counts with permutation
envelopes: pair counts over a uniform bucket grid.

Port of ``spatialcore_tpu/ops/ripley.py``. A bucket grid whose edge is at
least r_max / ``window`` bounds the O(N²) pair sum to the (2w+1)² bucket
window around each cell. A chunk of queries expands all its window
buckets at once into the flat list of the points they hold (no Python loop
over window offsets), scores the candidates and bins each squared
distance by the sorted radii, so one histogram gives the counts at every
radius (and, with cell types, at every type pair). Counts are exact
integers (int64).

A pair on the boundary of a radius counts as in the reference's CPU run,
whose squared distance is ``fma(dy, dy, dx·dx)`` with one rounding
(``core.rng._fma32`` decides wherever the float32 sum lies that close to
a radius); the CSR envelope's uniform points likewise are
``fma(u, span, mins)``.

Envelopes:

- univariate K: CSR simulations, uniform points in the bounding box, draw
  s keyed ``fold_in(key_for(seed, "ripley_csr"), s)``; each draw is one
  binning and one counting pass on the device;
- cross-type K: random labelling, the codes permuted by
  ``permutation(fold_in(key_for(seed, "ripley_labelperm"), s), n)`` with
  positions (and the bucket table) fixed.

The reference runs its draws in 64-draw device scans to stay under a TPU
RPC deadline; here each draw is one pass, with the same keys.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..core.rng import _fma32, fold_in, key_for, permutation, uniform

Device = Union[str, torch.device]

#: candidate pairs scored at once (their int64 and float32 temporaries
#: stay under a GB)
_TILE_CANDIDATES = 1 << 24


class GridSpec(NamedTuple):
    """Static bucket-grid geometry, shared by every pass of one analysis."""

    mins: np.ndarray      # f32 [2]
    span: np.ndarray      # f32 [2]
    nbx: int
    nby: int
    window: int           # bucket-window radius covering r_max
    capacity: int         # padded per-bucket capacity


def make_grid_spec(coords_np: np.ndarray, r_max: float, target_window: int = 2,
                   bbox=None, capacity_slack: float = 1.0) -> GridSpec:
    """Grid geometry so a (2w+1)² window covers every pair ≤ r_max.

    ``nbx = floor(span/edge)`` keeps the bucket edge ≥ r_max/target_window,
    so the window is ``target_window``. The capacity is the observed largest
    bucket occupancy (binned in the same float32 arithmetic as
    :func:`_bin_points`) times ``capacity_slack``, rounded up to a power of
    two above it.
    """
    coords_np = np.asarray(coords_np, np.float32)
    if bbox is None:
        mins = coords_np.min(axis=0)
        maxs = coords_np.max(axis=0)
    else:
        mins, maxs = (np.asarray(b, np.float32) for b in bbox)
    span = np.maximum(maxs - mins, 1e-9).astype(np.float32)
    edge = r_max / max(target_window, 1)
    nbx = int(max(1, min(span[0] / edge, 4096)))
    nby = int(max(1, min(span[1] / edge, 4096)))
    h = (span / np.array([nbx, nby], np.float32)).astype(np.float32)
    window = int(np.ceil(r_max / min(h[0], h[1]) - 1e-6))
    bx = np.clip(np.floor((coords_np[:, 0] - mins[0]) / h[0]),
                 0, nbx - 1).astype(np.int64)
    by = np.clip(np.floor((coords_np[:, 1] - mins[1]) / h[1]),
                 0, nby - 1).astype(np.int64)
    max_count = int(np.bincount(bx * nby + by, minlength=nbx * nby).max())
    C = 1 << int(np.ceil(np.log2(
        max(max_count, 1) * max(capacity_slack, 1.0) + 1.0)))
    return GridSpec(mins=mins, span=span, nbx=nbx, nby=nby, window=window,
                    capacity=int(C))


def _bin_points(coords: torch.Tensor, mins: torch.Tensor, span: torch.Tensor,
                nbx: int, nby: int, C: int):
    """Bucket table on ``coords``' device: sort by bucket id, scatter
    positions.

    Returns ``(table int64 [nbx·nby, C] (−1 pad), bx, by, max occupancy)``
    with the occupancy a 0-dim tensor; a bucket's points beyond C land in a
    discarded column, so callers must check occupancy ≤ C.
    """
    n = coords.shape[0]
    h = span / torch.tensor([nbx, nby], dtype=torch.float32,
                            device=coords.device)
    bx = torch.clamp(torch.floor((coords[:, 0] - mins[0]) / h[0]).to(torch.int64),
                     0, nbx - 1)
    by = torch.clamp(torch.floor((coords[:, 1] - mins[1]) / h[1]).to(torch.int64),
                     0, nby - 1)
    bucket = bx * nby + by
    order = torch.argsort(bucket, stable=True)
    sb = bucket[order]
    pos = torch.arange(n, device=coords.device) - torch.searchsorted(sb, sb)
    table = torch.full((nbx * nby, C + 1), -1, dtype=torch.int64,
                       device=coords.device)
    table[sb, torch.clamp_max(pos, C)] = order
    return table[:, :C], bx, by, pos.max() + 1


def _window_pieces(counts: np.ndarray, limit: int):
    """Split consecutive queries into pieces of at most ``limit`` candidates
    (a query with more is a piece of its own): ``[(first, end, total)]``."""
    cum = np.cumsum(counts)
    pieces, a = [], 0
    while a < counts.size:
        base = cum[a - 1] if a else 0
        e = max(int(np.searchsorted(cum, base + limit, side="right")), a + 1)
        pieces.append((a, e, int(cum[e - 1] - base)))
        a = e
    return pieces


def _pair_counts(coords: torch.Tensor, table: torch.Tensor, bx: torch.Tensor,
                 by: torch.Tensor, radii_sq: torch.Tensor,
                 type_codes: Optional[torch.Tensor], nbx: int, nby: int,
                 window: int, n_types: int = 1):
    """Ordered pairs i ≠ j with d_ij² ≤ r² per radius: ``(counts int64 [R],
    type-pair counts int64 [R, T, T] or None)``.

    Queries go in chunks; each chunk's (2w+1)² window buckets are expanded
    into the flat list of the points they hold (only occupied table slots),
    cut into pieces of at most ``_TILE_CANDIDATES`` candidates. Each
    candidate's d² (``dx² + dy²`` in float32) finds its first radius by a
    search of the sorted r²; where it lies within 2⁻²⁰ of a neighbouring
    r², the reference's single rounding ``fma(dy, dy, dx²)`` (:func:`_fma32`,
    at most 2⁻²² away) decides. One histogram over (radius, query type,
    candidate type) and a cumulative sum over the radii give the counts,
    exact in any order.
    """
    dev = coords.device
    R = radii_sq.shape[0]
    C = table.shape[1]
    n = coords.shape[0]
    rs, rorder = torch.sort(radii_sq)
    occ = (table >= 0).sum(dim=1)
    flat = table.reshape(-1)
    safe = flat.clamp_min(0)
    tx, ty = coords[safe, 0], coords[safe, 1]
    ttype = type_codes[safe] if n_types > 1 else None
    r = torch.arange(-window, window + 1, device=dev)
    ox, oy = (o.reshape(-1) for o in torch.meshgrid(r, r, indexing="ij"))
    W = ox.shape[0]
    T2 = n_types * n_types if n_types > 1 else 1
    hist = torch.zeros((R + 1) * T2, dtype=torch.int64, device=dev)
    q_chunk = 1 << 16
    for q0 in range(0, n, q_chunk):
        q = torch.arange(q0, min(q0 + q_chunk, n), device=dev)
        gx = bx[q, None] + ox
        gy = by[q, None] + oy
        ok = (gx >= 0) & (gx < nbx) & (gy >= 0) & (gy < nby)
        b = torch.where(ok, gx * nby + gy, torch.zeros_like(gx))
        cnt = torch.where(ok, occ[b], torch.zeros_like(b))        # [Q, W]
        for a, e, total in _window_pieces(cnt.sum(dim=1).cpu().numpy(),
                                          _TILE_CANDIDATES):
            if total == 0:
                continue
            c = cnt[a:e].reshape(-1)
            grp = torch.repeat_interleave(
                torch.arange(c.shape[0], device=dev), c, output_size=total)
            start = torch.cumsum(c, 0) - c
            slot = b[a:e].reshape(-1)[grp] * C + (
                torch.arange(total, device=dev) - start[grp])
            qi = q[a + grp // W]
            del grp, start
            dx = coords[qi, 0] - tx[slot]
            dy = coords[qi, 1] - ty[slot]
            dxx = dx * dx
            d2 = dxx + dy * dy
            pos = torch.searchsorted(rs, d2)
            above = rs[pos.clamp_max(R - 1)]
            below = rs[(pos - 1).clamp_min(0)]
            near = torch.nonzero(((above - d2).abs() <= above * 2.0 ** -20)
                                 | ((d2 - below).abs() <= below * 2.0 ** -20)
                                 ).flatten()
            if near.numel():
                pos[near] = torch.searchsorted(
                    rs, _fma32(dy[near], dy[near], dxx[near]))
            del dx, dy, dxx, d2, above, below, near
            pos = torch.where(flat[slot] == qi, torch.full_like(pos, R), pos)
            if n_types > 1:
                pos = (pos * n_types + type_codes[qi]) * n_types + ttype[slot]
            hist += torch.bincount(pos, minlength=hist.shape[0])
            del pos, slot, qi
    hist = hist.reshape(R + 1, T2)[:R]
    cum = torch.cumsum(hist, dim=0)                          # sorted radii
    out = torch.empty_like(cum)
    out[rorder] = cum
    if n_types > 1:
        out_t = out.reshape(R, n_types, n_types)
        return out_t.sum(dim=(1, 2)), out_t
    return out[:, 0], None


class BucketGrid(NamedTuple):
    """A bucket grid built on the host's request (tests and callers outside
    the hot paths)."""

    table: torch.Tensor
    bx: torch.Tensor
    by: torch.Tensor
    nbx: int
    nby: int
    window: int


def build_bucket_grid(coords_np: np.ndarray, r_max: float,
                      target_window: int = 2, bbox=None, min_capacity: int = 0,
                      device: Device = "cuda") -> BucketGrid:
    """Bucket cells on ``device`` so a (2w+1)² window covers pairs within
    r_max."""
    coords_np = np.asarray(coords_np, np.float32)
    spec = make_grid_spec(coords_np, r_max, target_window=target_window,
                          bbox=bbox)
    C = max(spec.capacity, min_capacity)
    table, bx, by, mc = _bin_points(
        torch.as_tensor(coords_np, device=device),
        torch.as_tensor(spec.mins, device=device),
        torch.as_tensor(spec.span, device=device), spec.nbx, spec.nby, C)
    if int(mc) > C:
        raise ValueError(
            f"bucket capacity overflow: max occupancy {int(mc)} > {C}")
    return BucketGrid(table, bx, by, spec.nbx, spec.nby, spec.window)


def _counts_pass(coords: torch.Tensor, spec: GridSpec, radii_sq: torch.Tensor,
                 codes: Optional[torch.Tensor], n_types: int,
                 mins: torch.Tensor, span: torch.Tensor):
    """One full pass, binning and pair counts: ``(counts [R], type-pair
    counts [R, T, T] or None, max occupancy)``, all on the device."""
    table, bx, by, mc = _bin_points(coords, mins, span, spec.nbx, spec.nby,
                                    spec.capacity)
    c, ct = _pair_counts(coords, table, bx, by, radii_sq, codes, spec.nbx,
                         spec.nby, spec.window, n_types)
    return c, ct, mc


def _as_f32_counts(c: torch.Tensor) -> np.ndarray:
    """Exact integer counts as float32 (one rounding each), on the host."""
    return c.cpu().numpy().astype(np.float32)


def csr_points(base_key: torch.Tensor, s: int, mins: torch.Tensor,
               span: torch.Tensor, n: int) -> torch.Tensor:
    """CSR draw ``s``: ``n`` uniform points in the box, ``fma(u, span,
    mins)`` with ``u = uniform(fold_in(base_key, s), (n, 2))``, on the
    device of ``mins``."""
    u = uniform(fold_in(base_key, s), (n, 2), device=mins.device)
    return _fma32(u, span.expand_as(u), mins.expand_as(u))


def ripley_k(coords: np.ndarray, radii: np.ndarray, n_simulations: int = 0,
             seed: int = 0, area: Optional[float] = None,
             device: Device = "cuda") -> dict:
    """Univariate Ripley's K(r) (no edge correction) with CSR envelopes
    (reference ``ripley_k``, spatialcore_tpu/ops/ripley.py:319).

    K̂(r) = A·Σ_{i≠j} 1[d_ij ≤ r] / (n(n−1));  L(r) = sqrt(K/π).
    ``n_simulations`` uniform point sets in the bounding box give the 2.5%
    and 97.5% envelopes; every draw (uniform sample, binning, pair counts)
    runs on ``device``. Returns host numpy arrays, as the reference.
    """
    coords = np.asarray(coords, np.float32)
    if coords.shape[0] < 2:
        raise ValueError(
            f"Ripley's K needs >= 2 points, got {coords.shape[0]}")
    n = coords.shape[0]
    radii = np.asarray(radii, np.float32)
    r_max = float(radii.max())
    mins, maxs = coords.min(axis=0), coords.max(axis=0)
    if area is None:
        area = float(np.prod(np.maximum(maxs - mins, 1e-9)))
    # capacity slack 2× the observed largest bucket covers the CSR draws
    spec = make_grid_spec(coords, r_max, bbox=(mins, maxs), capacity_slack=2.0)
    mins_t = torch.as_tensor(spec.mins, device=device)
    span_t = torch.as_tensor(spec.span, device=device)
    radii_sq = torch.as_tensor(radii ** 2, device=device)
    norm = area / (n * (n - 1))

    c, _, mc = _counts_pass(torch.as_tensor(coords, device=device), spec,
                            radii_sq, None, 1, mins_t, span_t)
    if int(mc) > spec.capacity:
        raise ValueError(
            f"bucket capacity overflow: {int(mc)} > {spec.capacity}")
    k_obs = norm * _as_f32_counts(c)
    out = {"radii": radii, "K": k_obs,
           "L": np.sqrt(np.maximum(k_obs, 0) / np.pi)}

    if n_simulations > 0:
        span_full = torch.as_tensor((maxs - mins).astype(np.float32),
                                    device=device)
        mins_full = torch.as_tensor(mins, device=device)
        base_key = key_for(seed, "ripley_csr")
        counts, worst = [], torch.zeros((), dtype=torch.int64, device=device)
        for s in range(n_simulations):
            sim = csr_points(base_key, s, mins_full, span_full, n)
            cs, _, mcs = _counts_pass(sim, spec, radii_sq, None, 1, mins_t,
                                      span_t)
            counts.append(cs)
            worst = torch.maximum(worst, mcs)
            del sim
        if int(worst) > spec.capacity:
            raise ValueError(
                f"CSR simulation bucket overflow: {int(worst)} > "
                f"{spec.capacity}; re-run with a larger capacity_slack")
        sims = norm * _as_f32_counts(torch.stack(counts))
        out["K_env_lo"] = np.quantile(sims, 0.025, axis=0)
        out["K_env_hi"] = np.quantile(sims, 0.975, axis=0)
        out["L_env_lo"] = np.sqrt(np.maximum(out["K_env_lo"], 0) / np.pi)
        out["L_env_hi"] = np.sqrt(np.maximum(out["K_env_hi"], 0) / np.pi)
        out["n_simulations"] = n_simulations
    return out


def co_occurrence_counts(coords: np.ndarray, type_codes: np.ndarray,
                         n_types: int, radii: np.ndarray,
                         device: Device = "cuda") -> np.ndarray:
    """Cumulative ordered pair counts per (radius, type a, type b), float32
    [R, T, T] on the host (reference ``co_occurrence_counts``); callers
    turn them into conditional co-occurrence ratios or K estimates."""
    coords = np.asarray(coords, np.float32)
    radii = np.asarray(radii, np.float32)
    spec = make_grid_spec(coords, float(radii.max()))
    _, ct, mc = _counts_pass(
        torch.as_tensor(coords, device=device), spec,
        torch.as_tensor(radii ** 2, device=device),
        torch.as_tensor(np.asarray(type_codes, np.int64), device=device),
        n_types, torch.as_tensor(spec.mins, device=device),
        torch.as_tensor(spec.span, device=device))
    if int(mc) > spec.capacity:
        raise ValueError(
            f"bucket capacity overflow: {int(mc)} > {spec.capacity}")
    return _as_f32_counts(ct)


def cross_type_k(coords: np.ndarray, type_codes: np.ndarray, n_types: int,
                 radii: np.ndarray, n_permutations: int = 0, seed: int = 0,
                 area: Optional[float] = None, device: Device = "cuda") -> dict:
    """Cross-type K_AB(r) for all type pairs with random-labelling
    envelopes (reference ``cross_type_k``).

    K̂_AB(r) = A·Σ_{i∈A, j∈B, i≠j} 1[d_ij ≤ r] / (n_A·n_B) (n_A(n_A − 1)
    on the diagonal). The positions are binned once; each envelope draw
    permutes the labels on ``device`` and counts again.
    """
    coords = np.asarray(coords, np.float32)
    type_codes = np.asarray(type_codes, np.int32)
    radii = np.asarray(radii, np.float32)
    n = coords.shape[0]
    r_max = float(radii.max())
    mins, maxs = coords.min(axis=0), coords.max(axis=0)
    if area is None:
        area = float(np.prod(np.maximum(maxs - mins, 1e-9)))
    n_per_type = np.bincount(type_codes, minlength=n_types).astype(np.float64)
    denom = np.outer(n_per_type, n_per_type)
    np.fill_diagonal(denom, n_per_type * (n_per_type - 1))
    denom = np.maximum(denom, 1.0)

    spec = make_grid_spec(coords, r_max, bbox=(mins, maxs))
    coords_t = torch.as_tensor(coords, device=device)
    radii_sq = torch.as_tensor(radii ** 2, device=device)
    codes = torch.as_tensor(type_codes.astype(np.int64), device=device)
    # positions are fixed: bin once, count many
    table, bx, by, mc = _bin_points(
        coords_t, torch.as_tensor(spec.mins, device=device),
        torch.as_tensor(spec.span, device=device), spec.nbx, spec.nby,
        spec.capacity)
    if int(mc) > spec.capacity:
        raise ValueError(
            f"bucket capacity overflow: {int(mc)} > {spec.capacity}")

    def counts_for(cd):
        return _pair_counts(coords_t, table, bx, by, radii_sq, cd, spec.nbx,
                            spec.nby, spec.window, n_types)[1]

    k_obs = area * _as_f32_counts(counts_for(codes)) / denom[None]
    out = {"radii": radii, "K_cross": k_obs}
    if n_permutations > 0:
        base_key = key_for(seed, "ripley_labelperm")
        cts = [counts_for(codes[permutation(fold_in(base_key, s), n,
                                            device=device)])
               for s in range(n_permutations)]
        sims = area * _as_f32_counts(torch.stack(cts)) / denom[None, None]
        out["K_cross_env_lo"] = np.quantile(sims, 0.025, axis=0)
        out["K_cross_env_hi"] = np.quantile(sims, 0.975, axis=0)
        out["n_permutations"] = n_permutations
    return out
