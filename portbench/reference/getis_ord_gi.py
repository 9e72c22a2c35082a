"""Reference of ``getis_ord_gi``: Getis-Ord Gi* on raw counts (Getis & Ord
1992; Ord & Getis 1995), binary kNN weights with the cell itself included
(W = k + 1, m = n): the kNN graph, the observed G and z and the analytic
p, the 999-draw total null's p_sim per cell, and the post-pass
(Benjamini-Hochberg over the cells of each gene, hot and cold classes by
the sign of z where the adjusted p is below alpha).

Gi* of cell i and gene g, x the raw counts:

    A_i = Σ_{j ∈ N(i)} x_j + x_i,   G_i = A_i / Σ_j x_j,
    z_i = (A_i − x̄·W) / (s·√[(n·W − W²)/(n − 1)]),
    x̄, s² the mean and population variance of the gene over all n cells.

The null counts exact integers: per gene the int8 codes of the raw values
(``raw_codes``: s = max|x|/127), per draw A = Σ_{N(i)} v[π(j)] + v[π(i)]
against the identity placement's A_o; two-sided, a draw is extreme where
(A − A_o)·(A + A_o − 2·c2) ≥ 0 with c2 = f32(tot/m)·(W + 1), tot the codes'
column sum (the stated precision of the centre; every other term exact).
Draws: ``draws.permutations(seed, "perm_feistel_getis", ...)``. The
observed pass and the null refuse values that are not whole numbers
(``whole``); the section's log1p X is turned back into its counts unless
an entry already did so in place (``section["raw_counts"]``). ``lower=True`` computes the control, every
stage one precision step below the traffic's (``stats.LOWER``).
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import common, stats
from portbench.reference import draws as draws_mod
from portbench.reference import knn as knn_mod

F64 = torch.float64
I64 = torch.int64
STREAM = "perm_feistel_getis"

sample = common.sample


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded once to float32, back in float64."""
    return t.to(torch.float32).to(F64)


def whole(X: torch.Tensor) -> torch.Tensor:
    """``X`` itself, after checking that every value is a whole number."""
    if not bool((X == torch.round(X)).all()):
        raise ValueError("Gi* reads raw counts: the values given are not "
                         "whole numbers")
    return X


def raw_columns(section: dict, genes) -> torch.Tensor:
    """float64 raw counts [N, len(genes)] of the compared genes."""
    X = common._columns(section, genes)
    return X if section.get("raw_counts") else torch.round(torch.expm1(X))


def raw_codes(X: torch.Tensor, precision: str):
    """(int32 codes, float64 per-gene scale) of raw values at an integer
    precision: s = f32(max|x|/q), code = round(f32(x/s)), half to even,
    within [−q, q]. Each quotient of two float32 values is formed in
    float64 and rounded once to float32, which is its float32 quotient."""
    q = stats.QMAX[precision]
    s = _f32(_f32(X.abs().max(dim=0).values) / q)
    s = torch.where(s > 0, s, torch.ones_like(s))
    return torch.clamp(torch.round(_f32(X / s)), -q, q).to(torch.int32), s


def binary_lag(idx: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Σ over the k neighbour slots of V[neighbour], in V's dtype."""
    out = torch.zeros((idx.shape[0], V.shape[1]), dtype=V.dtype, device=V.device)
    for s in range(idx.shape[1]):
        out += V[idx[:, s]]
    return out


def observed(X: torch.Tensor, idx: torch.Tensor, precision: str,
             control: bool) -> dict:
    """G, z (delivered at ``precision``; the control computes them from the
    codes of an integer ``precision``), the two-sided analytic p and the
    exact column totals."""
    n, k = idx.shape
    xv = whole(X)
    if control:
        V, s = raw_codes(X, precision)
        xv = V.to(F64) * s
    A = binary_lag(idx, xv) + xv
    W = float(k + 1)
    tot = xv.sum(dim=0)
    xbar = tot / n
    s2 = torch.clamp_min((xv * xv).sum(dim=0) / n - xbar * xbar, 0.0)
    sd = torch.sqrt(torch.where(s2 > 0, s2, torch.ones_like(s2)))
    z = (A - xbar * W) / (sd * ((n * W - W * W) / (n - 1)) ** 0.5)
    G = A / torch.where(tot != 0, tot, torch.ones_like(tot))
    p = 2.0 * torch.special.ndtr(-z.abs())
    if not control:
        G, z = stats.rounded(G, precision), stats.rounded(z, precision)
    return {"G": G, "z": z, "p": p, "tot": X.sum(dim=0)}


def null_counts(X: torch.Tensor, idx: torch.Tensor, *, precision: str,
                seed: int, n_permutations: int,
                draw_batch: int = 8) -> torch.Tensor:
    """int32 [N, G]: the draws at least as extreme as the identity
    placement (two-sided), in exact integer code arithmetic."""
    n, k = idx.shape
    V = raw_codes(whole(X), precision)[0]
    A_o = binary_lag(idx, V) + V
    tm = _f32(_f32(V.to(I64).sum(dim=0).to(F64)) * _f32(torch.tensor(
        1.0 / n, dtype=F64)))
    two_c2 = 2.0 * _f32(tm * (k + 1))                 # [G]
    count = torch.zeros(A_o.shape, dtype=torch.int32, device=X.device)
    for d0 in range(0, n_permutations, draw_batch):
        ds = range(d0, min(d0 + draw_batch, n_permutations))
        for perm in draws_mod.permutations(seed, STREAM, ds, n, X.device):
            Vp = V[perm]
            A = binary_lag(idx, Vp) + Vp
            count += ((A - A_o).to(F64) * ((A + A_o).to(F64) - two_c2)) >= 0
            del Vp, A
    return count


def hotspots(z: torch.Tensor, p_adj: torch.Tensor, alpha: float) -> torch.Tensor:
    """int8 classes: 1 hot, −1 cold where ``p_adj`` < alpha, else 0."""
    return torch.where(p_adj < alpha, torch.sign(z),
                       torch.zeros_like(z)).to(torch.int8)


def expected(section: dict, traffic: dict, seed: int, smp: dict,
             lower: bool = False) -> dict:
    """The reference's answers (or the control's, ``lower``) on the sampled
    genes and cells."""
    prec = common.precisions(traffic, lower)
    args = traffic.get("args", {})
    if args.get("star", True) is not True or args.get(
            "alternative", "two-sided") != "two-sided":
        raise ValueError("the Gi* reference holds the two-sided Gi* only")
    coords = section["coords"]
    idx, w = common.graph(coords, int(section["k"]), prec["graph"])
    cells = torch.as_tensor(smp["cells"], device=coords.device)
    X = raw_columns(section, smp["genes"])
    obs = observed(X, idx, prec["obs"], lower)
    P = int(traffic["n_permutations"])
    count = null_counts(X, idx, precision=prec["null"],
                        seed=int(section["null_seed"]), n_permutations=P)
    p_sim = (count.to(F64) + 1.0) / (P + 1.0)
    p_adj = stats.bh(p_sim, prec["post"])
    alpha = float(args.get("alpha", traffic.get("alpha", 0.05)))
    out = {"nbr": idx[cells], "w": w[cells], "G": obs["G"], "z": obs["z"],
           "p": obs["p"], "p_sim": p_sim, "p_adj": p_adj,
           "hotspot": hotspots(obs["z"], p_adj, alpha),
           "count_lo": count, "count_hi": count, "tot": obs["tot"]}
    if not lower:
        out["d2"] = torch.sort(knn_mod.point_d2(coords, cells, idx[cells]),
                               dim=1).values
    return out


def readings(out, ref, section, smp, traffic) -> Dict[str, float]:
    """``graph_gap``; ``obs_gap.G``: |G − G_ref| / (|G_ref| + 1/tot), a
    relative gap floored at one count's share of the gene's total;
    ``obs_gap.z``: |z − z_ref| / (1 + |z_ref|); ``p_flip_share``: the share
    of cells and genes whose p_sim count is not the reference's;
    ``p_adj_gap``: the largest gap of the answer's adjusted p from BH over
    its own p_sim; ``hotspot_gap``: the share of cells and genes whose
    class is not the reference's; ``hot_share``: the share the reference
    classes hot or cold (what ``hotspot_gap`` can see)."""
    P = int(traffic["n_permutations"])
    dev = ref["p_sim"].device
    o = {k: v.to(dev) for k, v in out.items() if isinstance(v, torch.Tensor)}
    floor = 1.0 / ref["tot"].clamp_min(1.0)
    G_ref, z_ref = ref["G"], ref["z"]
    count = common._counts(o["p_sim"], P)
    return {
        "graph_gap": common.graph_gap(o, ref, section["coords"], smp["cells"]),
        "obs_gap.G": float(((o["G"].to(F64) - G_ref).abs()
                            / (G_ref.abs() + floor)).max()),
        "obs_gap.z": float(((o["z"].to(F64) - z_ref).abs()
                            / (1.0 + z_ref.abs())).max()),
        "p_flip_share": float((common._outside(count, ref) > 0).to(F64).mean()),
        "p_adj_gap": float((o["p_adj"].to(F64) - stats.bh(o["p_sim"])).abs()
                           .max()),
        "hotspot_gap": float((o["hotspot"].to(torch.int8) != ref["hotspot"])
                             .to(F64).mean()),
        "hot_share": float((ref["hotspot"] != 0).to(F64).mean()),
    }
