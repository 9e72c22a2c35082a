"""Reference of the ``lees_l_local``: local Lee's L of gene pairs: the kNN
graph, the observed L = z_x · lag(z_y) and lag(z_y), the int8 null that
permutes y alone (two-sided, |L|) and its p per cell, and the post-pass
(Benjamini-Hochberg over the cells of each pair, Lee's quadrants of z_x
against lag(z_y)).

The traffic's ``pairs`` are panel indices ``[x, y]``; a column of the call
is a pair. The null counts exact integers: per cell and draw
Lq = x_code · Σ_slots w_code · y_code[π], against the identity placement's
|Lq| (codes: ``stats.codes`` per column, ``stats.weight_codes`` per row;
draws: ``draws.permutations(seed, "perm_feistel_lee", ...)``), so it has
no tie band. ``lower=True`` computes the control, every stage one
precision step below the traffic's (``stats.LOWER``).
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import common, stats
from portbench.reference import draws as draws_mod
from portbench.reference import knn as knn_mod

F64 = torch.float64
I64 = torch.int64
STREAM = "perm_feistel_lee"

sample = common.sample


def pair_columns(section: dict, traffic: dict, cols):
    """float64 [N, len(cols)] x and y expression of the pairs ``cols``."""
    X = section["X"]
    pairs = torch.as_tensor(traffic["pairs"], dtype=I64, device=X.device)
    p = pairs[torch.as_tensor(cols, dtype=I64, device=X.device)]
    return (X.index_select(1, p[:, 0]).to(F64),
            X.index_select(1, p[:, 1]).to(F64))


def _observed(Zx, Zy, idx, w, precision: str, control: bool):
    """(L, z_x, lag(z_y)): exact, L delivered at ``precision``; the control
    computes every value from the codes of ``precision``, an integer one
    (one step below the bf16 L a compact output stores)."""
    if control:
        (vx, sx), (vy, sy) = stats.codes(Zx, precision), stats.codes(Zy, precision)
        W, sw = stats.weight_codes(w)
        zx = vx.to(F64) * sx
        lag_y = stats.lag(idx, W.to(F64) * sw[:, None], vy.to(F64) * sy)
        return zx * lag_y, zx, lag_y
    lag_y = stats.lag(idx, w.to(F64), Zy)
    return stats.rounded(Zx * lag_y, precision), Zx, lag_y


def local_lee(Zx: torch.Tensor, Zy: torch.Tensor, idx: torch.Tensor,
              w: torch.Tensor, *, obs_precision: str, null_precision: str,
              seed: int, n_permutations: int, control: bool = False,
              draw_batch: int = 8) -> Dict[str, torch.Tensor]:
    """Local Lee's L per cell and pair column and its integer null: p,
    with ``count_lo`` = ``count_hi`` the draws at or beyond the identity
    placement's |Lq|."""
    if null_precision not in stats.QMAX:
        raise ValueError(f"the Lee reference runs an integer null, got "
                         f"{null_precision!r}")
    L, zx, lag_y = _observed(Zx, Zy, idx, w, obs_precision, control)
    vx = stats.codes(Zx, null_precision)[0].to(I64)
    vy = stats.codes(Zy, null_precision)[0].to(I64)
    W = stats.weight_codes(w)[0].to(I64)
    target = (vx * stats.lag(idx, W, vy)).abs()
    count = torch.zeros(target.shape, dtype=I64, device=Zx.device)
    n = Zx.shape[0]
    for d0 in range(0, n_permutations, draw_batch):
        ds = range(d0, min(d0 + draw_batch, n_permutations))
        for perm in draws_mod.permutations(seed, STREAM, ds, n, Zx.device):
            count += (vx * stats.lag(idx, W, vy[perm])).abs() >= target
    return {"L": L, "z": zx, "lag": lag_y, "count_lo": count,
            "count_hi": count,
            "p": (count.to(F64) + 1.0) / (n_permutations + 1.0)}


def expected(section: dict, traffic: dict, seed: int, smp: dict,
             lower: bool = False) -> dict:
    """The reference's answers (or the control's, ``lower``) on the
    sampled pair columns and cells."""
    prec = common.precisions(traffic, lower)
    coords = section["coords"]
    idx, w = common.graph(coords, int(section["k"]), prec["graph"])
    cells = torch.as_tensor(smp["cells"], device=coords.device)
    X, Y = pair_columns(section, traffic, smp["genes"])
    r = local_lee(stats.standardize(X), stats.standardize(Y), idx, w,
                  obs_precision=prec["obs"], null_precision=prec["null"],
                  seed=int(section["null_seed"]),
                  n_permutations=int(traffic["n_permutations"]),
                  control=lower)
    p_adj = stats.bh(r["p"], prec["post"])
    out = {"nbr": idx[cells], "w": w[cells], "p_adj": p_adj,
           "quadrant": stats.quadrants(r["z"], r["lag"], p_adj,
                                       float(traffic["alpha"])), **r}
    if not lower:
        out["d2"] = torch.sort(knn_mod.point_d2(coords, cells, idx[cells]),
                               dim=1).values
    return out


def readings(out, ref, section, smp, traffic):
    """``graph_gap``, ``obs_gap`` (|L − L_ref| / (1 + |L_ref|)),
    ``p_flip_share``, ``p_adj_gap`` and ``quadrant_gap``, as the local
    Moran cells read them."""
    return common.readings(dict(out, I=out["L"]), dict(ref, I=ref["L"]),
                           section, smp, traffic, local=True)
