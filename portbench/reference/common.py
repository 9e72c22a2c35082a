"""What the reference expects of a cell, and the numbers that judge an answer.

``expected`` works the answers out from the inputs the harness made (the
section's coordinates and expression): the kNN graph, the standardized
values, Moran's I and its nulls, the post-pass. ``lower=True`` computes
the control instead: the same reference one precision step below what the
traffic states at every stage (``stats.LOWER``), its answers in the
program's format.

``readings`` holds an answer (the program's, or the control's) against
the reference's and returns the numbers compared with the cell's limits.
The program's outputs are read only to be judged: the adjusted p-values
are judged on the p-values the answer itself carries.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import knn as knn_mod
from . import stats

F64 = torch.float64


def sample(n_cells: int, n_genes: int, seed: int, traffic: dict) -> dict:
    """The genes (columns of the call) and the cells whose neighbour lists
    are compared, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 0x5EED])
    g = min(int(traffic["compare_genes"]), n_genes)
    c = min(int(traffic["compare_cells"]), n_cells)
    return {"genes": np.sort(rng.choice(n_genes, g, replace=False)),
            "cells": np.sort(rng.choice(n_cells, c, replace=False))}


def precisions(traffic: dict, lower: bool) -> Dict[str, str]:
    p = dict(traffic["precision"])
    return {k: stats.LOWER[v] for k, v in p.items()} if lower else p


def graph(coords: torch.Tensor, k: int, precision: str):
    """(idx [N, k], w float64 [N, k]) of the row-normalized kNN graph on
    the coordinates as ``precision`` stores them (``knn``: float32
    distances, ties to the lower index)."""
    idx, _ = knn_mod.knn(stats.rounded(coords.to(F64), precision), k)
    w = stats.rounded(torch.full(idx.shape, 1.0 / k, dtype=F64,
                                 device=idx.device), precision)
    return idx, w


def _columns(section: dict, genes) -> torch.Tensor:
    X = section["X"]
    cols = torch.as_tensor(np.asarray(section["genes"])[genes], device=X.device)
    return X.index_select(1, cols).to(F64)


def expected(section: dict, traffic: dict, seed: int, smp: dict, *,
             local: bool, lower: bool = False) -> dict:
    """The reference's answers (or the control's, ``lower``) on the
    sampled genes and cells."""
    prec = precisions(traffic, lower)
    coords = section["coords"]
    k = int(section["k"])
    idx, w = graph(coords, k, prec["graph"])
    cells = torch.as_tensor(smp["cells"], device=coords.device)
    Z = stats.standardize(_columns(section, smp["genes"]))
    P = int(traffic["n_permutations"])
    seed_null = int(section["null_seed"])
    out = {"nbr": idx[cells], "w": w[cells]}
    if not local:
        r = stats.global_moran(Z, idx, w, obs_precision=prec["obs"],
                               null_precision=prec["null"], seed=seed_null,
                               n_permutations=P, control=lower)
        out.update(I=r["I"], p=r["p"], null_mean=r["null_mean"],
                   null_std=r["null_std"], count_lo=r["count_lo"],
                   count_hi=r["count_hi"])
    else:
        r = stats.local_moran(Z, idx, w, obs_precision=prec["obs"],
                              null_precision=prec["null"], seed=seed_null,
                              n_permutations=P, control=lower)
        p_adj = stats.bh(r["p"], prec["post"])
        out.update(I=r["I"], z=r["z"], lag=r["lag"], p=r["p"], p_adj=p_adj,
                   count_lo=r["count_lo"], count_hi=r["count_hi"],
                   quadrant=stats.quadrants(r["z"], r["lag"], p_adj,
                                            float(traffic["alpha"])))
    if not lower:
        out["d2"] = torch.sort(knn_mod.point_d2(coords, cells, idx[cells]),
                               dim=1).values
    return out


def _counts(p: torch.Tensor, P: int) -> torch.Tensor:
    return torch.round(p.to(F64) * (P + 1)).to(torch.int64) - 1


def _outside(count: torch.Tensor, ref: dict) -> torch.Tensor:
    """How many draws an answer's count lies outside the reference's
    [count_lo, count_hi] (0 inside: the ties rounding may decide)."""
    lo, hi = ref["count_lo"].to(torch.int64), ref["count_hi"].to(torch.int64)
    return torch.clamp_min(lo - count, 0) + torch.clamp_min(count - hi, 0)


def graph_gap(out: dict, ref: dict, coords: torch.Tensor, cells) -> float:
    """Largest gap between the sorted distances of an answer's neighbours
    and the true k nearest, as a share of the k-th distance; or the
    largest gap of a weight from 1/k, as a share of 1/k."""
    rows = torch.as_tensor(cells, device=coords.device)
    d_out = torch.sort(knn_mod.point_d2(coords, rows, out["nbr"].to(
        coords.device)).sqrt(), dim=1).values
    d_ref = ref["d2"].sqrt()
    k = d_ref.shape[1]
    dist = ((d_out - d_ref).abs() / d_ref[:, k - 1:k].clamp_min(1e-300)).max()
    wgap = ((out["w"].to(F64) - 1.0 / k).abs() * k).max()
    return float(torch.maximum(dist, wgap))


def readings(out: dict, ref: dict, section: dict, smp: dict, traffic: dict,
             *, local: bool) -> Dict[str, float]:
    P = int(traffic["n_permutations"])
    dev = ref["p"].device
    o = {k: v.to(dev) for k, v in out.items() if isinstance(v, torch.Tensor)}
    nums = {"graph_gap": graph_gap(o, ref, section["coords"], smp["cells"])}
    if not local:
        sd = ref["null_std"].clamp_min(1e-300)
        nums["obs_gap"] = float(((o["I"].to(F64) - ref["I"]).abs() / sd).max())
        nums["p_gap"] = float(_outside(_counts(o["p"], P), ref).to(F64).mean())
        if "null_mean" in o:
            nums["moment_gap"] = float(torch.maximum(
                (o["null_mean"].to(F64) - ref["null_mean"]).abs(),
                (o["null_std"].to(F64) - ref["null_std"]).abs()).div(sd).max())
        return nums
    I_ref = ref["I"]
    nums["obs_gap"] = float(((o["I"].to(F64) - I_ref).abs()
                             / (1.0 + I_ref.abs())).max())
    nums["p_flip_share"] = float((_outside(_counts(o["p"], P), ref) > 0)
                                 .to(F64).mean())
    adj = stats.bh(o["p"])
    nums["p_adj_gap"] = float((o["p_adj"].to(F64) - adj).abs().max())
    nums["quadrant_gap"] = float((o["quadrant"].to(torch.int8)
                                  != ref["quadrant"]).to(F64).mean())
    return nums
