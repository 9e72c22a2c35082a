"""Deterministic Xenium-like tissue simulator.

Port of ``spatialcore_tpu/utils/simulate.py`` (numpy only), returning this
package's ``SpatialData``; for one seed its data are bitwise the
reference's. It generates a real-shaped stand-in for a public section: a
panel-sized gene set with per-type marker modules, spatially organized
niches (follicle-like foci, a vessel tree, an epithelial band over a
stromal background), negative-binomial counts, and ground-truth labels.

Everything is keyed off one integer seed; re-running reproduces the
dataset bitwise (numpy Philox counter streams).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import pandas as pd
import scipy.sparse as sp

__all__ = ["simulate_xenium", "XENIUM_NICHES"]


def _choice_rows(rng: np.random.Generator, probs: np.ndarray) -> np.ndarray:
    """``[rng.choice(len(p), p=p) for p in probs]`` without the loop.

    ``Generator.choice`` with ``p`` and no size takes one ``random()``
    double and returns the number of entries of ``cumsum(p) / sum`` at or
    below it (``searchsorted(side="right")``); ``random(n)`` yields the
    same doubles in the same order, and a row's float64 ``cumsum`` adds in
    the same order, so the indices are bitwise the loop's."""
    cdf = np.cumsum(probs.astype(np.float64), axis=1)
    cdf /= cdf[:, -1:]
    u = rng.random(probs.shape[0])
    return (cdf <= u[:, None]).sum(axis=1)

#: niche archetypes: (name, cell-type mixture). Types are drawn from the
#: 12-type repertoire below; weights need not normalize.
XENIUM_NICHES: List[Tuple[str, Dict[str, float]]] = [
    ("lymphoid_follicle", {"B cell": 6.0, "T cell CD4": 2.0,
                           "Dendritic cell": 1.0}),
    ("t_zone", {"T cell CD4": 4.0, "T cell CD8": 3.0,
                "Dendritic cell": 1.0, "B cell": 0.5}),
    ("vessel", {"Endothelial": 5.0, "Smooth muscle": 2.5,
                "Pericyte": 1.5}),
    ("epithelial_band", {"Epithelial": 7.0, "Goblet": 2.0,
                         "T cell CD8": 0.5}),
    ("stroma", {"Fibroblast": 5.0, "Macrophage": 1.5,
                "Endothelial": 0.5, "Mast cell": 0.3}),
    ("inflamed_stroma", {"Fibroblast": 2.5, "Macrophage": 3.0,
                         "Neutrophil": 2.0, "T cell CD8": 1.0}),
]

_TYPES = ["B cell", "T cell CD4", "T cell CD8", "Dendritic cell",
          "Endothelial", "Smooth muscle", "Pericyte", "Epithelial",
          "Goblet", "Fibroblast", "Macrophage", "Neutrophil", "Mast cell"]

#: anchor markers per type — REAL symbols so the annotation/ontology
#: stages exercise their canonical tables; the rest of the panel is
#: filled with synthetic module genes
_ANCHORS = {
    "B cell": ["MS4A1", "CD79A", "CD19"],
    "T cell CD4": ["CD3D", "CD4", "IL7R"],
    "T cell CD8": ["CD3E", "CD8A", "GZMK"],
    "Dendritic cell": ["ITGAX", "CLEC9A"],
    "Endothelial": ["PECAM1", "VWF", "CLDN5"],
    "Smooth muscle": ["ACTA2", "MYH11"],
    "Pericyte": ["PDGFRB", "RGS5"],
    "Epithelial": ["EPCAM", "KRT8", "KRT18"],
    "Goblet": ["MUC2", "TFF3"],
    "Fibroblast": ["COL1A1", "LUM", "PDGFRA"],
    "Macrophage": ["CD68", "C1QA", "LYZ"],
    "Neutrophil": ["S100A8", "FCGR3B"],
    "Mast cell": ["TPSAB1", "CPA3"],
}


def simulate_xenium(
    n_cells: int = 40_000,
    n_genes: int = 256,
    seed: int = 0,
    extent: float = 5_000.0,
    markers_per_type: int = 8,
    n_gradient_genes: int = 4,
    mean_counts_per_cell: float = 120.0,
):
    """Generate a Xenium-like SpatialData world with ground truth.

    Layout: a Poisson field of cells over ``extent`` µm² with niche
    fields — 3 follicle foci (Gaussian), each wrapped by a t_zone
    annulus, a branching vessel polyline, an epithelial band along the
    top edge, and inflamed patches — softmax-combined into per-cell
    niche probabilities. Types draw from the niche's mixture; counts are
    Poisson-gamma (NB) with per-type marker modules (anchor symbols from
    the canonical tables + synthetic ``M{type}_{i}`` fillers), shared
    housekeeping genes, and ``n_gradient_genes`` smooth spatial-gradient
    genes named ``GRAD{i}`` (positive Moran targets). Remaining slots are
    i.i.d. ``NOISE{i}`` genes (null Moran targets).

    Returns ``(adata, truth)`` where ``truth`` has ``markers`` (type →
    panel marker list), ``niche_names``, and per-cell ground-truth
    columns live in ``adata.obs['true_type'/'true_niche']``.
    """
    rng = np.random.default_rng(np.random.Philox(seed))
    coords = rng.uniform(0, extent, (n_cells, 2)).astype(np.float32)

    # --- niche fields -----------------------------------------------------
    fields = np.zeros((n_cells, len(XENIUM_NICHES)), np.float32)
    names = [n for n, _ in XENIUM_NICHES]
    foci = rng.uniform(0.2 * extent, 0.8 * extent, (3, 2))
    d_foci = np.linalg.norm(coords[:, None] - foci[None], axis=2)
    fields[:, names.index("lymphoid_follicle")] = np.exp(
        -(d_foci / (0.045 * extent)) ** 2).sum(1)
    fields[:, names.index("t_zone")] = np.exp(
        -((d_foci - 0.075 * extent) / (0.03 * extent)) ** 2).sum(1)
    # vessel: piecewise-linear tree across the tissue
    verts = np.stack([np.linspace(0, extent, 24),
                      extent * (0.5 + 0.25 * np.sin(
                          np.linspace(0, 3 * np.pi, 24)))], 1)
    seg_d = np.full(n_cells, np.inf, np.float32)
    for a, b in zip(verts[:-1], verts[1:]):
        ab = b - a
        t = np.clip(((coords - a) @ ab) / (ab @ ab), 0, 1)
        proj = a + t[:, None] * ab
        seg_d = np.minimum(seg_d, np.linalg.norm(coords - proj, axis=1))
    fields[:, names.index("vessel")] = np.exp(
        -(seg_d / (0.012 * extent)) ** 2)
    fields[:, names.index("epithelial_band")] = np.exp(
        -((extent - coords[:, 1]) / (0.06 * extent)) ** 2)
    patches = rng.uniform(0, extent, (4, 2))
    d_p = np.linalg.norm(coords[:, None] - patches[None], axis=2)
    fields[:, names.index("inflamed_stroma")] = 0.7 * np.exp(
        -(d_p / (0.05 * extent)) ** 2).sum(1)
    fields[:, names.index("stroma")] = 0.25          # background

    # squared sharpening: the raw softmax mixes heavily at structure
    # boundaries (background stroma reaches everywhere), which caps any
    # composition-clustering recovery well below the visible anatomy
    f2 = fields * fields
    probs = f2 / f2.sum(1, keepdims=True)
    niche_idx = _choice_rows(rng, probs)

    # --- cell types from the niche mixture --------------------------------
    mix = np.zeros((len(names), len(_TYPES)), np.float64)
    for ni, (_, m) in enumerate(XENIUM_NICHES):
        for t, w in m.items():
            mix[ni, _TYPES.index(t)] = w
    mix /= mix.sum(1, keepdims=True)
    types = _choice_rows(rng, mix[niche_idx])

    # --- panel -------------------------------------------------------------
    genes: List[str] = []
    markers: Dict[str, List[str]] = {}
    for t in _TYPES:
        mk = list(_ANCHORS[t][:markers_per_type])
        i = 0
        while len(mk) < markers_per_type:
            mk.append(f"M{_TYPES.index(t)}_{i}")
            i += 1
        markers[t] = mk
        genes += mk
    grads = [f"GRAD{i}" for i in range(n_gradient_genes)]
    genes += grads
    n_hk = max(0, min(16, n_genes - len(genes)))
    genes += [f"HK{i}" for i in range(n_hk)]
    if len(genes) > n_genes:
        raise ValueError(
            f"panel needs >= {len(genes)} genes "
            f"({markers_per_type}/type + {n_gradient_genes} gradients); "
            f"got n_genes={n_genes}")
    genes += [f"NOISE{i}" for i in range(n_genes - len(genes))]
    gi = {g: i for i, g in enumerate(genes)}

    # --- counts: Poisson-gamma with marker modules -------------------------
    base = rng.gamma(2.0, 0.05, (n_cells, n_genes)).astype(np.float32)
    for ti, t in enumerate(_TYPES):
        rows = types == ti
        for g in markers[t]:
            base[rows, gi[g]] += rng.gamma(4.0, 1.6, rows.sum())
    for i, g in enumerate(grads):
        ax = coords[:, i % 2] / extent
        base[:, gi[g]] += 1.8 * (1 + np.sin(2 * np.pi * (ax * (i + 1))))
    for i in range(n_hk):
        base[:, gi[f"HK{i}"]] += rng.gamma(3.0, 0.5, n_cells)
    scale = mean_counts_per_cell / max(base.sum(1).mean(), 1e-9)
    counts = rng.poisson(base * scale).astype(np.float32)

    from ..core import SpatialData

    X = sp.csr_matrix(counts)
    adata = SpatialData(
        X=X,
        obs=pd.DataFrame(
            {"true_type": np.array(_TYPES, object)[types],
             "true_niche": np.array(names, object)[niche_idx]},
            index=[f"cell_{i}" for i in range(n_cells)]),
        var=pd.DataFrame(index=pd.Index(genes, name=None)))
    adata.layers["counts"] = X.copy()
    adata.obsm["spatial"] = coords
    truth = {"markers": markers, "niche_names": names,
             "gradient_genes": grads,
             "noise_genes": [g for g in genes if g.startswith("NOISE")]}
    return adata, truth
