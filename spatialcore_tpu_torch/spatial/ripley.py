"""Public point-pattern statistics on the SpatialData container: Ripley's
K / L with CSR envelopes, cross-type K with random-labelling envelopes,
the conditional co-occurrence score and the Clark-Evans index.

Port of ``spatialcore_tpu/spatial/ripley.py``: the same parameters and
``uns`` entries, plus ``device`` (the pair counts, their envelopes and
Clark-Evans' nearest-neighbour search run there; ``ops/ripley.py``,
``ops/graph.py``).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..core.logging import get_logger
from ..core.metadata import update_metadata
from ..ops.ripley import co_occurrence_counts, cross_type_k, ripley_k

logger = get_logger("spatial.ripley")

Device = Union[str, torch.device]


def _default_radii(coords: np.ndarray, n_radii: int) -> np.ndarray:
    span = coords.max(axis=0) - coords.min(axis=0)
    r_max = 0.25 * float(min(span[0], span[1]))
    return np.linspace(r_max / n_radii, r_max, n_radii).astype(np.float32)


def _coords(adata, spatial_key: str) -> np.ndarray:
    if spatial_key not in adata.obsm:
        raise ValueError(f"adata.obsm['{spatial_key}'] not found")
    c = adata.obsm[spatial_key]
    if isinstance(c, torch.Tensor):                # coordinates on the card
        c = c.cpu().numpy()
    return np.asarray(c, np.float32)[:, :2]


def _type_codes(adata, cluster_key: str, name: str):
    """Sorted type names and int32 codes of ``obs[cluster_key]``."""
    if cluster_key not in adata.obs.columns:
        raise ValueError(f"adata.obs['{cluster_key}'] not found")
    labels = adata.obs[cluster_key]
    if labels.isna().any():
        raise ValueError(
            f"adata.obs['{cluster_key}'] contains null labels; drop or "
            "fill them first.")
    labels = labels.astype(str)
    types = sorted(labels.unique())
    if len(types) < 2:
        raise ValueError(f"{name} needs ≥2 types")
    codes = labels.map({t: i for i, t in enumerate(types)}).to_numpy(np.int32)
    return types, codes


def _radii(coords, radii, n_radii: int) -> np.ndarray:
    if radii is None:
        radii = _default_radii(coords, n_radii)
    return np.asarray(sorted(radii), np.float32)


def _listed(res: dict) -> dict:
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in res.items()}


def ripleys_k(
    adata,
    radii: Optional[Sequence[float]] = None,
    n_radii: int = 20,
    n_simulations: int = 99,
    seed: int = 0,
    spatial_key: str = "spatial",
    key_added: str = "ripley_k",
    copy: bool = False,
    device: Device = "cuda",
):
    """Univariate Ripley's K / L with CSR envelopes → ``uns[key_added]``
    (radii, K, L, the 2.5% / 97.5% envelopes, n_simulations and the wall
    time). Default radii: ``n_radii`` up to a quarter of the shorter side
    of the bounding box."""
    start = time.time()
    if copy:
        adata = adata.copy()
    coords = _coords(adata, spatial_key)
    radii = _radii(coords, radii, n_radii)
    if radii.min() <= 0:
        raise ValueError("All radii must be > 0")
    logger.info(f"Ripley's K: {adata.n_obs:,} cells, {len(radii)} radii, "
                f"{n_simulations} CSR simulations")
    res = _listed(ripley_k(coords, radii, n_simulations=n_simulations,
                           seed=seed, device=device))
    res["computation_time_seconds"] = round(time.time() - start, 2)
    adata.uns[key_added] = res
    update_metadata(adata, "ripleys_k",
                    parameters={"n_radii": len(radii),
                                "n_simulations": n_simulations, "seed": seed,
                                "backend": "spatialcore_tpu_torch",
                                "device": str(device)},
                    outputs={"uns": key_added})
    return adata


def co_occurrence(
    adata,
    cluster_key: str,
    radii: Optional[Sequence[float]] = None,
    n_radii: int = 20,
    spatial_key: str = "spatial",
    key_added: str = "co_occurrence",
    copy: bool = False,
    device: Device = "cuda",
):
    """Conditional co-occurrence score per distance shell (squidpy-style).

    ``score[r, a, b] = P(type b | within shell r of an a-cell) / P(type b)``
    over the shells between consecutive radii; > 1: b is enriched around a
    at that range. Output: ``uns[key_added]`` with ``score`` [R, T, T] and
    the ``interval`` edges, and the type order in
    ``uns[f"{key_added}_types"]``.
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    coords = _coords(adata, spatial_key)
    types, codes = _type_codes(adata, cluster_key, "co_occurrence")
    radii = _radii(coords, radii, n_radii)
    logger.info(f"co_occurrence: {adata.n_obs:,} cells, {len(types)} types, "
                f"{len(radii)} distance shells")
    cum = co_occurrence_counts(coords, codes, len(types), radii, device=device)
    shells = np.diff(np.concatenate([np.zeros((1,) + cum.shape[1:]), cum],
                                    axis=0), axis=0)
    totals = shells.sum(axis=2, keepdims=True)
    cond = shells / np.maximum(totals, 1.0)
    frac = (np.bincount(codes, minlength=len(types))
            / len(codes))[None, None, :]
    score = np.where(totals > 0, cond / frac, np.nan)
    adata.uns[key_added] = {
        "score": score.astype(np.float32),
        "interval": radii.tolist(),
        "computation_time_seconds": round(time.time() - start, 2),
    }
    adata.uns[f"{key_added}_types"] = types
    update_metadata(adata, "co_occurrence",
                    parameters={"cluster_key": cluster_key,
                                "n_radii": len(radii),
                                "backend": "spatialcore_tpu_torch",
                                "device": str(device)},
                    outputs={"uns": [key_added, f"{key_added}_types"]})
    return adata


def cross_type_ripleys_k(
    adata,
    cluster_key: str,
    radii: Optional[Sequence[float]] = None,
    n_radii: int = 20,
    n_permutations: int = 99,
    seed: int = 0,
    spatial_key: str = "spatial",
    key_added: str = "ripley_k_cross",
    copy: bool = False,
    device: Device = "cuda",
):
    """Cross-type K for all type pairs with random-labelling envelopes:
    ``uns[key_added]`` holds K_cross [R, T, T] (and the envelopes), the type
    order is ``uns[f"{key_added}_types"]``."""
    start = time.time()
    if copy:
        adata = adata.copy()
    coords = _coords(adata, spatial_key)
    types, codes = _type_codes(adata, cluster_key, "cross_type_ripleys_k")
    radii = _radii(coords, radii, n_radii)
    logger.info(f"Cross-type K: {adata.n_obs:,} cells, {len(types)} types, "
                f"{len(radii)} radii, {n_permutations} label permutations")
    res = _listed(cross_type_k(coords, codes, len(types), radii,
                               n_permutations=n_permutations, seed=seed,
                               device=device))
    res["computation_time_seconds"] = round(time.time() - start, 2)
    adata.uns[key_added] = res
    adata.uns[f"{key_added}_types"] = types
    update_metadata(adata, "cross_type_ripleys_k",
                    parameters={"cluster_key": cluster_key,
                                "n_radii": len(radii),
                                "n_permutations": n_permutations, "seed": seed,
                                "backend": "spatialcore_tpu_torch",
                                "device": str(device)},
                    outputs={"uns": [key_added, f"{key_added}_types"]})
    return adata


def clark_evans(
    adata,
    spatial_key: str = "spatial",
    area: Optional[float] = None,
    copy: bool = False,
    device: Device = "cuda",
):
    """Clark-Evans nearest-neighbour aggregation index with its z-test.

    R = observed mean NN distance / its CSR expectation 0.5/√λ: R < 1
    clustered, ≈ 1 random, > 1 dispersed. The z-test uses Clark & Evans
    (1954), SE = 0.26136/√(nλ); no edge correction. The nearest neighbours
    come from the grid search above 50,000 cells, else the exact scan, on
    ``device``. Writes ``uns["clark_evans"]`` (R, z, p_value,
    mean_nn_distance, expected_nn_distance, n_cells, area, wall time).
    """
    from scipy.stats import norm as _norm

    from ..ops.graph import knn_exact, knn_grid

    start = time.time()
    if copy:
        adata = adata.copy()
    coords = _coords(adata, spatial_key)
    n = len(coords)
    if n < 3:
        raise ValueError(f"clark_evans needs >= 3 cells, got {n}")
    c = torch.as_tensor(coords, device=device)
    _, dist = (knn_grid if n > 50_000 else knn_exact)(c, 1)
    mean_nn = float(dist.cpu().numpy().ravel().mean())
    if area is None:
        lo, hi = coords.min(0), coords.max(0)
        area = float((hi[0] - lo[0]) * (hi[1] - lo[1]))
    lam = n / max(area, 1e-12)
    expected = 0.5 / np.sqrt(lam)
    R = mean_nn / expected
    se = 0.26136 / np.sqrt(n * lam)
    z = (mean_nn - expected) / se
    p = 2.0 * float(_norm.sf(abs(z)))
    adata.uns["clark_evans"] = {
        "R": R, "z": z, "p_value": p, "mean_nn_distance": mean_nn,
        "expected_nn_distance": expected, "n_cells": n, "area": area,
        "computation_time_seconds": time.time() - start,
    }
    update_metadata(adata, "clark_evans", parameters={
        "n_cells": n, "area": area, "backend": "spatialcore_tpu_torch",
        "device": str(device)}, outputs={"uns": "clark_evans"})
    logger.info(f"Clark-Evans R={R:.3f} (z={z:.1f}) — "
                f"{'clustered' if R < 1 else 'dispersed' if R > 1 else 'random'}")
    return adata
