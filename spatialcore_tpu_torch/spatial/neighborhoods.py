"""Neighborhood composition profiles and niche identification.

Port of ``spatialcore_tpu/spatial/neighborhoods.py``:
``compute_neighborhood_profile`` builds per-cell cell-type composition
vectors over kNN or radius neighborhoods (empty neighborhoods are hard
errors); ``identify_niches`` clusters them with K-Means into 1-indexed
categorical niches; ``niche_stability`` scores the clustering's
reproducibility across k by the adjusted Rand index. The graph is the
port's ``build_graph``, the profile an exact count (one int64
``bincount``), the clustering ``ops.kmeans`` on ``device``. The adjusted
Rand index is computed here from the contingency table
(:func:`adjusted_rand_score`, sklearn's pair-confusion formula), since
sklearn is not a dependency of the port.
"""

from __future__ import annotations

import time
from typing import Literal, Optional, Union

import numpy as np
import pandas as pd
import torch

from ..core.logging import get_logger
from ..core.metadata import update_metadata
from ..core.rng import np_rng
from ..ops.graph import build_graph
from ..ops.kmeans import kmeans, minibatch_kmeans

logger = get_logger("spatial.neighborhoods")

Device = Union[str, torch.device]


def _profile_from_graph(neighbor_idx: torch.Tensor, valid: torch.Tensor,
                        codes: torch.Tensor, n_types: int) -> torch.Tensor:
    """[N, n_types] float32 counts of each type among a cell's valid slots."""
    n = neighbor_idx.shape[0]
    rows = torch.arange(n, device=neighbor_idx.device)[:, None]
    keys = (rows * n_types + codes[neighbor_idx])[valid]
    c = torch.bincount(keys, minlength=n * n_types)
    return c.reshape(n, n_types).to(torch.float32)


def adjusted_rand_score(labels_true, labels_pred) -> float:
    """Adjusted Rand index of two labelings, as
    ``sklearn.metrics.adjusted_rand_score`` computes it: the pair confusion
    matrix from the contingency table in integers, then
    ``2·(tp·tn − fn·fp) / ((tp + fn)(fn + tn) + (tp + fp)(fp + tn))``, 1.0
    where the labelings agree on every pair."""
    a = np.asarray(labels_true).ravel()
    b = np.asarray(labels_pred).ravel()
    if a.shape != b.shape:
        raise ValueError(f"labelings differ in length: {a.shape} vs {b.shape}")
    n = int(a.shape[0])
    if n == 0:
        return 1.0
    _, ia = np.unique(a, return_inverse=True)
    _, ib = np.unique(b, return_inverse=True)
    cont = np.bincount(ia.astype(np.int64) * (int(ib.max()) + 1) + ib)
    sum_squares = int((cont.astype(np.int64) ** 2).sum())
    n_c = np.bincount(ia).astype(np.int64)      # cluster sizes of a
    n_k = np.bincount(ib).astype(np.int64)      # and of b
    tp = sum_squares - n
    fp = int((n_k ** 2).sum()) - sum_squares
    fn = int((n_c ** 2).sum()) - sum_squares
    tn = n * n - fp - fn - sum_squares
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))


def compute_neighborhood_profile(
    adata,
    celltype_column: str,
    method: Literal["knn", "radius"] = "knn",
    k: int = 15,
    radius: Optional[float] = None,
    normalize: bool = True,
    spatial_key: str = "spatial",
    key_added: str = "neighborhood_profile",
    copy: bool = False,
    k_max: int = 256,
    device: Device = "cuda",
):
    """Per-cell cell-type composition over the spatial neighborhood.

    Output: ``obsm[key_added]`` (n_cells, n_celltypes) counts or proportions
    (numpy float32, as the reference) and ``uns[f"{key_added}_celltypes"]``
    (sorted unique type order). Empty neighborhoods raise. ``k_max`` caps
    radius-mode degree; overflow raises. The graph and the counts run on
    ``device``.
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    if spatial_key not in adata.obsm:
        raise ValueError(
            f"adata.obsm['{spatial_key}'] not found. Spatial coordinates are required.")
    if celltype_column not in adata.obs.columns:
        raise ValueError(f"adata.obs['{celltype_column}'] not found.")
    if method not in ("knn", "radius"):
        raise ValueError(f"method must be 'knn' or 'radius', got '{method}'")
    if method == "knn":
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if k >= adata.n_obs:
            raise ValueError(f"k={k} must be < n_cells={adata.n_obs}")
    else:
        if radius is None:
            raise ValueError("radius must be provided for method='radius'")
        if radius <= 0:
            raise ValueError(f"radius must be > 0, got {radius}")

    celltype_series = adata.obs[celltype_column]
    if celltype_series.isna().any():
        raise ValueError(
            f"Column '{celltype_column}' contains null values; clean before profiling.")
    unique_celltypes = sorted(pd.unique(celltype_series.astype(str)))
    n_types = len(unique_celltypes)
    if n_types < 2:
        raise ValueError(
            f"At least 2 unique cell types required, found {n_types}. "
            f"Check column '{celltype_column}'.")
    type_to_idx = {ct: i for i, ct in enumerate(unique_celltypes)}
    codes = celltype_series.astype(str).map(type_to_idx).to_numpy(dtype=np.int64)

    coords = torch.as_tensor(adata.obsm[spatial_key]).to(device=device,
                                                        dtype=torch.float32)
    logger.info(f"Neighborhood profiles: {adata.n_obs:,} cells, "
                f"{n_types} cell types, method={method}")

    if method == "knn":
        graph = build_graph(coords, n_neighbors=k, device=device)
    else:
        graph = build_graph(coords, radius=float(radius), k_max=k_max,
                            device=device)

    prof = _profile_from_graph(graph.neighbor_idx, graph.valid,
                               torch.tensor(codes, device=coords.device),
                               n_types)
    row_sums = prof.sum(dim=1)
    n_empty = int((row_sums == 0).sum())
    if n_empty > 0:
        raise ValueError(
            f"{n_empty} cells have empty neighborhood profiles. Increase "
            "radius, switch to knn, or pre-filter isolated cells before profiling.")
    if normalize:
        prof = prof / row_sums[:, None]

    adata.obsm[key_added] = prof.cpu().numpy()
    adata.uns[f"{key_added}_celltypes"] = list(unique_celltypes)
    elapsed = time.time() - start
    logger.info(f"Stored profiles in obsm['{key_added}'] ({elapsed:.1f}s)")

    update_metadata(
        adata, "compute_neighborhood_profile",
        parameters={"celltype_column": celltype_column, "method": method,
                    "k": k, "radius": radius, "normalize": normalize},
        outputs={"obsm": key_added, "uns": f"{key_added}_celltypes"})
    return adata


def _profiles(adata, neighborhood_key: str, device: Device) -> torch.Tensor:
    if neighborhood_key not in adata.obsm:
        raise ValueError(
            f"adata.obsm['{neighborhood_key}'] not found. "
            "Run compute_neighborhood_profile() first.")
    return torch.as_tensor(adata.obsm[neighborhood_key]).to(
        device=device, dtype=torch.float32)


def niche_stability(
    adata,
    n_niches_range=None,
    neighborhood_key: str = "neighborhood_profile",
    n_restarts: int = 5,
    subsample: float = 0.8,
    seed: int = 0,
    key_added: str = "niche_stability",
    max_iter: int = 100,
    device: Device = "cuda",
):
    """Bootstrap stability of the niche clustering across k.

    For each candidate ``n_niches``: run k-means on ``n_restarts`` seeded
    subsamples (``np_rng(seed, "niche_stability", k, r)``), score all-pairs
    ARI between runs on the common cells, and record mean inertia per cell.
    High mean ARI = the niche structure is reproducible at that k. Results
    in ``uns[key_added]`` (per-k mean/std ARI + inertia).
    """
    profiles = _profiles(adata, neighborhood_key, device)
    n_cells = profiles.shape[0]
    if n_niches_range is None:
        n_niches_range = range(3, 11)
    rows = []
    for k_niche in n_niches_range:
        labels_runs, masks, inertias = [], [], []
        for r in range(n_restarts):
            rng = np_rng(seed, "niche_stability", k_niche, r)
            idx = np.sort(rng.choice(n_cells, int(subsample * n_cells),
                                     replace=False))
            res = kmeans(profiles[torch.as_tensor(idx, device=profiles.device)],
                         k_niche, seed=seed * 1000 + r, n_init=3,
                         max_iter=max_iter, device=device)
            lab = np.full(n_cells, -1, np.int32)
            lab[idx] = res.labels.cpu().numpy()
            labels_runs.append(lab)
            masks.append(idx)
            inertias.append(float(res.inertia) / idx.size)
        aris = []
        for i in range(n_restarts):
            for j in range(i + 1, n_restarts):
                common = np.intersect1d(masks[i], masks[j])
                aris.append(adjusted_rand_score(labels_runs[i][common],
                                                labels_runs[j][common]))
        rows.append({"n_niches": int(k_niche),
                     "ari_mean": float(np.mean(aris)),
                     "ari_std": float(np.std(aris)),
                     "inertia_per_cell": float(np.mean(inertias))})
        logger.info(f"  k={k_niche}: ARI {rows[-1]['ari_mean']:.3f} ± "
                    f"{rows[-1]['ari_std']:.3f}")
    adata.uns[key_added] = rows
    update_metadata(adata, "niche_stability",
                    parameters={"n_restarts": n_restarts,
                                "subsample": subsample, "seed": seed},
                    outputs={"uns": key_added})
    return adata


def identify_niches(
    adata,
    n_niches: int,
    method: Literal["kmeans", "minibatch_kmeans", "auto"] = "auto",
    neighborhood_key: str = "neighborhood_profile",
    key_added: str = "niche",
    random_state: int = 0,
    n_init: int = 10,
    max_iter: int = 300,
    copy: bool = False,
    device: Device = "cuda",
):
    """Cluster neighborhood profiles into niches (1-indexed categoricals).

    ``method='auto'`` uses full K-Means up to 100k cells and mini-batch
    above. Outputs: ``obs[key_added]`` categorical ``niche_1..niche_n``,
    ``uns['niche_centroids']``, ``uns['niche_params']`` (incl. inertia).
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    profiles = _profiles(adata, neighborhood_key, device)
    if n_niches < 2:
        raise ValueError(f"n_niches must be >= 2, got {n_niches}")
    n_cells = profiles.shape[0]
    if n_niches > n_cells:
        raise ValueError(f"n_niches={n_niches} exceeds n_cells={n_cells}")
    if not bool(torch.isfinite(profiles).all()):
        raise ValueError("Neighborhood profiles contain NaN/Inf values.")

    if method == "auto":
        method = "kmeans" if n_cells <= 100_000 else "minibatch_kmeans"
    if method == "kmeans":
        logger.info(f"K-Means: {n_cells:,} cells → {n_niches} niches "
                    f"(n_init={n_init})")
        res = kmeans(profiles, n_niches, seed=random_state, n_init=n_init,
                     max_iter=max_iter, device=device)
    elif method == "minibatch_kmeans":
        batch_size = min(1024, n_cells)
        logger.info(f"MiniBatch K-Means: {n_cells:,} cells → {n_niches} niches")
        res = minibatch_kmeans(profiles, n_niches, seed=random_state,
                               batch_size=batch_size, n_steps=max_iter,
                               n_init=max(1, n_init // 3), device=device)
    else:
        raise ValueError(f"Unknown method '{method}'")

    labels = res.labels.cpu().numpy()
    niche_names = [f"niche_{i + 1}" for i in range(n_niches)]
    adata.obs[key_added] = pd.Categorical.from_codes(labels, categories=niche_names)
    adata.uns["niche_centroids"] = res.centroids.cpu().numpy()
    adata.uns["niche_params"] = {
        "n_niches": n_niches, "method": method,
        "neighborhood_key": neighborhood_key, "random_state": random_state,
        "n_init": n_init, "max_iter": max_iter,
        "inertia": float(res.inertia),
    }
    elapsed = time.time() - start
    logger.info(f"Niches stored in obs['{key_added}'] ({elapsed:.1f}s, "
                f"inertia={float(res.inertia):.3f})")

    update_metadata(
        adata, "identify_niches",
        parameters={"n_niches": n_niches, "method": method,
                    "random_state": random_state, "n_init": n_init},
        outputs={"obs": key_added, "uns": "niche_centroids"})
    return adata
