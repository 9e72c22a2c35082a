"""Neighborhood enrichment: cell-type adjacency z-scores on the graph.

Port of ``spatialcore_tpu/spatial/nhood.py`` (squidpy's
``gr.nhood_enrichment``), in torch ops on the card. The type-pair counts
over the graph's valid slots are exact integers: one int64 ``bincount`` of
``code_i·T + code_j``, cast once to float32, which equals the reference's
float32 one-hot products while a pair's count stays below 2²⁴. The null
shuffles the labels with ``permutation(fold_in(key_for(seed, "nhood_perm",
0), p), n)``, bitwise the reference's, and sums the draws' counts and
squared counts in float32 in draw order, as its ``scan`` does.

The reference's CPU run rounds its float32 steps in a way the port
reproduces, so counts, z and the null moments are bitwise equal: the
divisions by the static ``n_permutations`` are multiplies by its float32
reciprocal ``inv``, and the compiler fuses three multiply-adds:
``s2 + c·c``, ``s2·inv − mean²`` (``mean²`` rounded first) and the z
numerator ``obs − s1·inv``; ``z`` then divides by the std, a correctly rounded
root (``core/rng._sqrt32``).
"""

from __future__ import annotations

import time
from typing import Optional, Union

import numpy as np
import torch

from ..core.logging import get_logger
from ..core.metadata import update_metadata
from ..core.rng import _fma32, _sqrt32, fold_in, key_for, permutation

logger = get_logger("spatial.nhood")

Device = Union[str, torch.device]


def pair_counts(neighbor_idx: torch.Tensor, valid: torch.Tensor,
                codes: torch.Tensor, n_types: int) -> torch.Tensor:
    """[T, T] float32 counts of valid edges i → j by (code_i, code_j)."""
    keys = codes[:, None] * n_types + codes[neighbor_idx]
    c = torch.bincount(keys[valid], minlength=n_types * n_types)
    return c.reshape(n_types, n_types).to(torch.float32)


def null_moments(neighbor_idx, valid, codes, n_types: int, seed: int,
                 n_permutations: int):
    """Observed counts and the label-permutation null's float32 draw sums
    ``s1 = Σ c``, ``s2 = Σ c²`` (``s2 + c·c`` fused), in draw order."""
    observed = pair_counts(neighbor_idx, valid, codes, n_types)
    s1 = torch.zeros_like(observed)
    s2 = torch.zeros_like(observed)
    base = key_for(seed, "nhood_perm", 0)
    n = codes.shape[0]
    for p in range(n_permutations):
        perm = permutation(fold_in(base, p), n, device=codes.device)
        c = pair_counts(neighbor_idx, valid, codes[perm], n_types)
        s1 = s1 + c
        s2 = _fma32(c, c, s2)
    return observed, s1, s2


def enrichment_z(observed, s1, s2, n_permutations: int):
    """(z, null mean, null std) from the draw sums, rounded as the
    reference's CPU run rounds them (module docstring)."""
    if n_permutations == 0:
        return torch.zeros_like(observed), observed, torch.zeros_like(observed)
    inv = torch.tensor(1.0, dtype=torch.float32) / n_permutations
    inv = inv.to(observed.device).expand_as(s1)
    mean = s1 * inv
    std = _sqrt32(torch.clamp_min(_fma32(s2, inv, -(mean * mean)), 1e-12))
    return _fma32(-s1, inv, observed) / std, mean, std


def neighborhood_enrichment(
    adata,
    cluster_key: str,
    n_permutations: int = 1000,
    seed: int = 0,
    n_neighbors: int = 6,
    spatial_key: str = "spatial",
    key_added: Optional[str] = None,
    copy: bool = False,
    device: Device = "cuda",
):
    """Type-pair adjacency enrichment over the spatial graph, on ``device``.

    ``uns[key_added]`` gets ``zscore`` / ``count`` / ``null_mean`` /
    ``null_std`` [T, T] arrays and the type order. Positive z = the two
    types neighbor each other more often than the random-labeling null.
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    if cluster_key not in adata.obs.columns:
        raise ValueError(f"adata.obs['{cluster_key}'] not found")
    from .autocorrelation import _get_graph

    graph = _get_graph(adata, n_neighbors, spatial_key,
                       use_existing_graph=True, device=device)
    labels = adata.obs[cluster_key]
    if labels.isna().any():
        raise ValueError(
            f"adata.obs['{cluster_key}'] contains null labels; drop or "
            "fill them first.")
    labels = labels.astype(str)
    types = sorted(labels.unique())
    if len(types) < 2:
        raise ValueError("neighborhood_enrichment needs ≥2 types")
    codes = torch.tensor(
        labels.map({t: i for i, t in enumerate(types)}).to_numpy(np.int64),
        device=graph.neighbor_idx.device)

    observed, s1, s2 = null_moments(graph.neighbor_idx, graph.valid, codes,
                                    len(types), seed, n_permutations)
    z, mean, std = enrichment_z(observed, s1, s2, n_permutations)

    key_added = key_added or f"{cluster_key}_nhood_enrichment"
    adata.uns[key_added] = {
        "zscore": z.cpu().numpy(),
        "count": observed.cpu().numpy(),
        "null_mean": mean.cpu().numpy(),
        "null_std": std.cpu().numpy(),
        "types": types,
        "n_permutations": n_permutations,
        "seed": seed,
    }
    logger.info(f"neighborhood_enrichment: {len(types)} types, "
                f"{n_permutations} permutations "
                f"({time.time() - start:.1f}s)")
    update_metadata(adata, "neighborhood_enrichment",
                    parameters={"cluster_key": cluster_key,
                                "n_permutations": n_permutations,
                                "seed": seed},
                    outputs={"uns": key_added})
    return adata
