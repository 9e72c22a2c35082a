"""Multiple-testing corrections: Benjamini-Hochberg and Bonferroni.

Port of ``spatialcore_tpu/ops/fdr.py``. Inputs may be torch tensors (on any
device) or anything ``torch.as_tensor`` takes; outputs are float32 tensors
on the input's device.
"""

from __future__ import annotations

import warnings

import torch

#: elements of one [m, columns] chunk of the discrete BH's int32 temps
_CHUNK_ELEMS = 1 << 27


def _f32(p) -> torch.Tensor:
    return torch.as_tensor(p).to(torch.float32)


def benjamini_hochberg(p_values, axis: int = 0) -> torch.Tensor:
    """BH-adjusted p-values along ``axis`` (vectorized over other axes).

    Sort, ``p·m/rank`` in float32, reversed cumulative minimum, unsort —
    the reference's expression, so the values are bitwise equal.
    """
    p = torch.movedim(_f32(p_values), axis, -1)
    m = p.shape[-1]
    order = torch.argsort(p, dim=-1, stable=True)
    p_sorted = torch.gather(p, -1, order)
    ranks = torch.arange(1, m + 1, dtype=torch.float32, device=p.device)
    scaled = p_sorted * m / ranks
    adj = torch.flip(torch.cummin(torch.flip(scaled, [-1]), dim=-1).values, [-1])
    adj = torch.clamp_max(adj, 1.0)
    out = torch.empty_like(adj).scatter_(-1, order, adj)
    return torch.movedim(out, -1, axis)


def benjamini_hochberg_discrete(p_values, n_levels: int,
                                axis: int = 0) -> torch.Tensor:
    """BH for p-values on the grid ``{(c+1)/n_levels : c = 0..n_levels-1}``.

    Permutation p-values are exactly this grid ((count+1)/(P+1)), so ranks
    follow from per-level counts: per column, one scatter histogram (the
    level's count and its smallest stored value), the cumulative count as
    the rank, the candidate ``rep·m/rank`` in float32, a suffix minimum over
    levels, and a gather back. Bitwise equal to :func:`benjamini_hochberg`
    on grid inputs (the reference's docstring gives the argument: the
    candidate at a level is the value the reversed cummin keeps for its tie
    block; the representative is the stored f32 value, so grids produced
    1 ulp off the direct division stay exact; an empty level's +inf is
    inert).

    Index temps are int32, and columns are processed in chunks so that no
    [m, all columns] temp beyond the output exists.
    """
    p = torch.movedim(_f32(p_values), axis, 0)
    m = p.shape[0]
    rest = p.shape[1:]
    pmf = p.reshape(m, -1)
    R = pmf.shape[1]
    out = torch.empty_like(pmf)
    dev = p.device
    width = max(1, min(_CHUNK_ELEMS // max(m, 1), (2**31 - 1) // n_levels))
    for c0 in range(0, R, width):
        c1 = min(c0 + width, R)
        w = c1 - c0
        pc = pmf[:, c0:c1]
        lev = torch.clamp(torch.round(pc * n_levels).to(torch.int32) - 1,
                          0, n_levels - 1)
        flat = (lev + torch.arange(w, dtype=torch.int32, device=dev)
                * n_levels).reshape(-1)
        cnt = torch.zeros(w * n_levels, dtype=torch.int32, device=dev)
        cnt.index_add_(0, flat, torch.ones_like(flat))
        rep = torch.full((w * n_levels,), float("inf"), dtype=torch.float32,
                         device=dev)
        with warnings.catch_warnings():     # "index_reduce() is in beta"
            warnings.simplefilter("ignore", UserWarning)
            rep.index_reduce_(0, flat, pc.reshape(-1), "amin")
        ranks = torch.cumsum(cnt.reshape(w, n_levels), dim=1,
                             dtype=torch.int32).to(torch.float32)
        cand = rep.reshape(w, n_levels) * m / ranks    # empty level: +inf
        adj = torch.clamp_max(torch.flip(torch.cummin(
            torch.flip(cand, [1]), dim=1).values, [1]), 1.0)
        out[:, c0:c1] = adj.reshape(-1).index_select(0, flat).reshape(m, w)
    return torch.movedim(out.reshape((m,) + tuple(rest)), 0, axis)


def bonferroni(p_values, axis: int = 0) -> torch.Tensor:
    p = _f32(p_values)
    return torch.clamp_max(p * p.shape[axis], 1.0)


def apply_fdr(p_values, method: str = "fdr_bh", axis: int = 0,
              n_levels: int = 0) -> torch.Tensor:
    """Dispatch: 'fdr_bh' | 'bonferroni' | 'none'.

    ``n_levels > 0`` asserts the p-values lie on the discrete grid
    ``(c+1)/n_levels`` (true for every permutation p in this package) and
    routes BH through the sort-free :func:`benjamini_hochberg_discrete`.
    """
    if method in ("fdr_bh", "bh"):
        if n_levels:
            return benjamini_hochberg_discrete(p_values, n_levels, axis=axis)
        return benjamini_hochberg(p_values, axis=axis)
    if method == "bonferroni":
        return bonferroni(p_values, axis=axis)
    if method in ("none", None):
        return _f32(p_values)
    raise ValueError(f"Unknown FDR method '{method}' "
                     "(expected 'fdr_bh', 'bonferroni', or 'none')")
