"""Reference of ``local_gearys_c`` with the total null: local Geary's C
(Anselin 1995) c_i = Σ_j w_ij (z_i − z_j)² per cell and gene on the
standardized expression: the kNN graph, the observed C, the total-
permutation null's one-sided p (the low tail) per cell, and
Benjamini-Hochberg over the cells of each gene.

The null counts exact integers, as the int8 null states its precision:
per draw c = Σ_slots w_code·(v[π(i)] − v[π(j)])² over the per-gene z codes
v (``stats.codes``) and the per-row weight codes (``stats.weight_codes``),
against the identity placement's value; a draw counts where c ≤ c_o
(k ≤ 256 keeps every sum inside int32: k·127·254² < 2³¹). Draws:
``draws.permutations(seed, "perm_feistel_local_geary", ...)``.
``lower=True`` computes the control, every stage one precision step below
the traffic's (``stats.LOWER``).
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import common, stats
from portbench.reference import draws as draws_mod
from portbench.reference import knn as knn_mod

F64 = torch.float64
STREAM = "perm_feistel_local_geary"

sample = common.sample


def geary(idx: torch.Tensor, w: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Σ over the k slots of w·(V_i − V[neighbour])², in V's dtype."""
    out = torch.zeros_like(V)
    for s in range(idx.shape[1]):
        d = V - V[idx[:, s]]
        out += w[:, s:s + 1] * d * d
    return out


def observed(Z: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
             precision: str, control: bool) -> torch.Tensor:
    """C, exact and delivered at ``precision``; the control computes it from
    the codes of an integer ``precision`` and the weight codes."""
    if control:
        V, s = stats.codes(Z, precision)
        Wc, sw = stats.weight_codes(w)
        return geary(idx, Wc.to(F64) * sw[:, None], V.to(F64) * s)
    return stats.rounded(geary(idx, w.to(F64), Z), precision)


def null_counts(Z: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, *,
                precision: str, seed: int, n_permutations: int,
                draw_batch: int = 8) -> torch.Tensor:
    """int32 [N, G]: the draws whose code value is at most the identity
    placement's, in exact integer arithmetic."""
    V = stats.codes(Z, precision)[0]
    Wc = stats.weight_codes(w)[0]
    target = geary(idx, Wc, V)
    count = torch.zeros(target.shape, dtype=torch.int32, device=Z.device)
    n = Z.shape[0]
    for d0 in range(0, n_permutations, draw_batch):
        ds = range(d0, min(d0 + draw_batch, n_permutations))
        for perm in draws_mod.permutations(seed, STREAM, ds, n, Z.device):
            count += geary(idx, Wc, V[perm]) <= target
    return count


def expected(section: dict, traffic: dict, seed: int, smp: dict,
             lower: bool = False) -> dict:
    """The reference's answers (or the control's, ``lower``) on the sampled
    genes and cells."""
    prec = common.precisions(traffic, lower)
    coords = section["coords"]
    idx, w = common.graph(coords, int(section["k"]), prec["graph"])
    cells = torch.as_tensor(smp["cells"], device=coords.device)
    Z = stats.standardize(common._columns(section, smp["genes"]))
    P = int(traffic["n_permutations"])
    count = null_counts(Z, idx, w, precision=prec["null"],
                        seed=int(section["null_seed"]), n_permutations=P)
    p = (count.to(F64) + 1.0) / (P + 1.0)
    out = {"nbr": idx[cells], "w": w[cells],
           "C": observed(Z, idx, w, prec["obs"], lower), "p": p,
           "p_adj": stats.bh(p, prec["post"]), "count_lo": count,
           "count_hi": count}
    if not lower:
        out["d2"] = torch.sort(knn_mod.point_d2(coords, cells, idx[cells]),
                               dim=1).values
    return out


def readings(out, ref, section, smp, traffic) -> Dict[str, float]:
    """``graph_gap``, ``obs_gap`` (|C − C_ref| / (1 + |C_ref|)),
    ``p_flip_share`` (the share of cells and genes whose count is not the
    reference's) and ``p_adj_gap`` (the largest gap of the answer's
    adjusted p from BH over its own p)."""
    P = int(traffic["n_permutations"])
    dev = ref["p"].device
    o = {k: v.to(dev) for k, v in out.items() if isinstance(v, torch.Tensor)}
    C_ref = ref["C"]
    count = common._counts(o["p"], P)
    return {
        "graph_gap": common.graph_gap(o, ref, section["coords"], smp["cells"]),
        "obs_gap": float(((o["C"].to(F64) - C_ref).abs()
                          / (1.0 + C_ref.abs())).max()),
        "p_flip_share": float((common._outside(count, ref) > 0).to(F64).mean()),
        "p_adj_gap": float((o["p_adj"].to(F64) - stats.bh(o["p"])).abs().max()),
    }
