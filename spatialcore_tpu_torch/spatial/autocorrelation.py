"""Public global spatial autocorrelation: Moran's I and Geary's C.

Port of the global part of ``spatialcore_tpu/spatial/autocorrelation.py``
(``build_spatial_weights``, ``morans_i``, ``gearys_c`` and their helpers).
Same parameters, same ``uns`` output DataFrames (``gene, I|C,
expected_I|expected_C, z_score, p_value``), plus an explicit ``device``.

Permutation p-values come from the banded null (``ops/banded.py``). Not
ported yet, and refused loudly: the slot null (``null_method="slots"``, and
"auto" where it resolves to it; ROADMAP Queue 1 item 4) and gene sharding
over a ``mesh`` (Queue 1 item 15). Unknown ``null_method`` strings raise
``ValueError`` (the reference runs the slot null for them, ROADMAP Queue 3).
"""

from __future__ import annotations

import time
from typing import List, Literal, Optional, Union

import numpy as np
import pandas as pd
import scipy.sparse as sp
import torch

from ..core.logging import get_logger
from ..core.metadata import update_metadata
from ..ops.banded import banded_permutation_test, build_null_plan
from ..ops.graph import SpatialGraph, build_graph, graph_from_numpy, graph_moments
from ..ops.moran import (geary_analytic_moments, geary_observed,
                         moran_analytic_moments, moran_observed, p_from_z,
                         standardize)

logger = get_logger("spatial.autocorrelation")

GRAPH_UNS_KEY = "spatial_graph"
NULL_METHODS = ("auto", "banded", "banded_int8", "slots")

Device = Union[str, torch.device]


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def build_spatial_weights(adata, n_neighbors: int = 6,
                          spatial_key: str = "spatial",
                          include_self: bool = False, store: bool = True,
                          radius: Optional[float] = None,
                          k_max: Optional[int] = None,
                          device: Device = "cuda") -> SpatialGraph:
    """Build the row-normalized kNN weights graph on ``device``.

    When ``store`` is set the graph arrays are cached (as numpy) in
    ``adata.uns['spatial_graph']`` for ``use_existing_graph``, as the
    reference does.
    """
    if spatial_key not in adata.obsm:
        raise ValueError(f"adata.obsm['{spatial_key}'] not found. "
                         "Spatial coordinates are required.")
    graph = build_graph(adata.obsm[spatial_key], n_neighbors=n_neighbors,
                        include_self=include_self, radius=radius,
                        k_max=k_max, device=device)
    if store:
        adata.uns[GRAPH_UNS_KEY] = {
            "neighbor_idx": graph.neighbor_idx.cpu().numpy(),
            "neighbor_w": graph.neighbor_w.cpu().numpy(),
            "valid": graph.valid.cpu().numpy(),
            "distances": graph.distances.cpu().numpy(),
            "params": {"n_neighbors": n_neighbors, "include_self": include_self,
                       "spatial_key": spatial_key, "radius": radius,
                       "k_max": k_max},
        }
    return graph


def _cached(adata, attr: str, key, make):
    """Per-object cache (not in uns, so nothing leaks into saved files)."""
    cache = getattr(adata, attr, None)
    if cache is not None and cache.get("key") == key:
        return cache["value"]
    value = make()
    setattr(adata, attr, {"key": key, "value": value})
    return value


def _load_stored_graph(adata, device: Device) -> Optional[SpatialGraph]:
    g = adata.uns.get(GRAPH_UNS_KEY)
    if not isinstance(g, dict) or "neighbor_idx" not in g:
        return None
    return _cached(adata, "_device_graph_cache", (id(g), str(device)),
                   lambda: graph_from_numpy(g, device=device))


def _get_graph_moments(adata, graph: SpatialGraph) -> dict:
    """Cliff-Ord S0/S1/S2 for this adata's graph, cached per stored graph."""
    uns_entry = adata.uns.get(GRAPH_UNS_KEY)
    if uns_entry is None:
        return graph_moments(graph)
    return _cached(adata, "_graph_moments_cache",
                   (id(uns_entry), tuple(graph.neighbor_idx.shape)),
                   lambda: graph_moments(graph))


def _get_graph(adata, n_neighbors, spatial_key, use_existing_graph,
               device: Device) -> SpatialGraph:
    if use_existing_graph:
        g = _load_stored_graph(adata, device)
        if g is not None:
            params = (adata.uns.get(GRAPH_UNS_KEY) or {}).get("params") or {}
            is_radius = params.get("radius") is not None
            mismatch = bool(params) and (
                params.get("spatial_key", spatial_key) != spatial_key
                or params.get("include_self", False)
                or (not is_radius and params.get("n_neighbors") is not None
                    and params["n_neighbors"] != n_neighbors))
            if mismatch:
                logger.warning(
                    f"Stored spatial graph (n_neighbors="
                    f"{params.get('n_neighbors')}, spatial_key="
                    f"'{params.get('spatial_key')}') does not match the "
                    f"request (n_neighbors={n_neighbors}, spatial_key="
                    f"'{spatial_key}'); rebuilding.")
            else:
                logger.info("Using existing spatial graph "
                            "(use_existing_graph=True)")
                return g
        else:
            logger.warning(
                "use_existing_graph=True but no stored graph; rebuilding")
    return build_spatial_weights(adata, n_neighbors=n_neighbors,
                                 spatial_key=spatial_key, device=device)


def _get_null_plan(adata, graph: SpatialGraph, spatial_key: str):
    """Build (or reuse) the NullPlan for this adata's graph, on the graph's
    device (device-path Hilbert relabel, as the reference)."""
    key = (id(adata.uns.get(GRAPH_UNS_KEY)), tuple(graph.neighbor_idx.shape),
           spatial_key, str(graph.neighbor_idx.device))
    coords = torch.as_tensor(adata.obsm[spatial_key]).to(
        device=graph.neighbor_idx.device, dtype=torch.float32)
    return _cached(adata, "_null_plan_cache", key,
                   lambda: build_null_plan(graph, coords))


# ---------------------------------------------------------------------------
# Expression extraction
# ---------------------------------------------------------------------------


def _resolve_genes(adata, genes) -> List[str]:
    if genes is None:
        return list(adata.var_names)
    if isinstance(genes, str):
        genes = [genes]
    missing = [g for g in genes if g not in adata.var_names]
    if missing:
        raise ValueError(f"Genes not found in adata.var_names: {missing[:10]}")
    return list(genes)


def _dense_expression(adata, gene_names: List[str], layer: Optional[str],
                      device: Device) -> torch.Tensor:
    """float32 [N, len(gene_names)] on ``device``.

    A torch ``X`` (on any device) is sliced where it lies and moved once;
    numpy and scipy-sparse ``X`` are densified on the host for the batch.
    """
    X = adata.get_matrix(layer)
    idx = adata.var_names.get_indexer(gene_names)
    if isinstance(X, torch.Tensor):
        sub = X.index_select(1, torch.as_tensor(idx, device=X.device))
        return sub.to(device=device, dtype=torch.float32)
    sub = X[:, idx]
    if sp.issparse(sub):
        sub = sub.toarray()
    return torch.as_tensor(np.asarray(sub, dtype=np.float32), device=device)


# ---------------------------------------------------------------------------
# Global Moran's I / Geary's C
# ---------------------------------------------------------------------------


def _auto_null_method(n_cells: int, n_genes: int, n_permutations: int) -> str:
    """Resolve null_method='auto' exactly as the reference: the banded null
    at >=100k cells when genes × permutations >= 16,384, else the slot null.
    The choice depends on sizes only, never on data values."""
    return ("banded" if n_permutations > 0 and n_cells >= 100_000
            and n_genes * n_permutations >= 16_384 else "slots")


def _global_autocorr(adata, stat: Literal["moran", "geary"], genes, layer,
                     spatial_key, n_neighbors, n_permutations, seed,
                     key_added, copy, use_existing_graph, assumption: str,
                     alternative: Optional[str], gene_batch_size: int,
                     mesh=None, null_method: str = "auto",
                     device: Device = "cuda"):
    start = time.time()
    if null_method not in NULL_METHODS:
        raise ValueError(f"null_method must be one of {NULL_METHODS}, "
                         f"got {null_method!r}")
    if mesh is not None:
        raise NotImplementedError(
            "gene sharding over a mesh is not ported yet (ROADMAP Queue 1 "
            "item 15, parallel/)")
    if copy:
        adata = adata.copy()
    if spatial_key not in adata.obsm:
        raise ValueError(f"adata.obsm['{spatial_key}'] not found. "
                         "Spatial coordinates are required.")
    gene_names = _resolve_genes(adata, genes)
    if alternative is None:
        alternative = "greater" if stat == "moran" else "less"
    if null_method == "auto":
        null_method = _auto_null_method(adata.n_obs, len(gene_names),
                                        n_permutations)
    if null_method == "slots" and n_permutations > 0:
        raise NotImplementedError(
            "the slot permutation null (permutation_test_global) is not "
            "ported yet (ROADMAP Queue 1 item 4); pass null_method='banded' "
            "or 'banded_int8'")

    graph = _get_graph(adata, n_neighbors, spatial_key, use_existing_graph,
                       device)
    moments = _get_graph_moments(adata, graph)
    S0, S1, S2 = moments["S0"], moments["S1"], moments["S2"]
    null_precision = "int8" if null_method == "banded_int8" else "bf16"
    plan = (_get_null_plan(adata, graph, spatial_key)
            if n_permutations > 0 else None)

    rows = []
    for batch_start in range(0, len(gene_names), gene_batch_size):
        batch = gene_names[batch_start:batch_start + gene_batch_size]
        Z, zero_var = standardize(_dense_expression(adata, batch, layer, device))
        if stat == "moran":
            observed = moran_observed(graph, Z, S0)
            expected, var = moran_analytic_moments(Z, S0, S1, S2, assumption)
        else:
            observed = geary_observed(graph, Z, S0)
            expected, var = geary_analytic_moments(Z, S0, S1, S2, assumption)
        z_score = (observed - expected) / torch.sqrt(torch.clamp_min(var, 1e-30))
        if n_permutations > 0:
            p_val, _, _ = banded_permutation_test(
                plan, Z, S0, observed, seed, n_permutations, stat=stat,
                alternative=alternative, precision=null_precision)
        else:
            p_val = p_from_z(z_score, alternative)
        observed = observed.cpu().numpy()
        z_score = z_score.cpu().numpy()
        p_val = p_val.cpu().numpy()
        zero_var = zero_var.cpu().numpy()
        for i, g in enumerate(batch):
            rows.append({
                "gene": g,
                ("I" if stat == "moran" else "C"): float(observed[i]),
                ("expected_I" if stat == "moran" else "expected_C"):
                    float(expected),
                "z_score": 0.0 if zero_var[i] else float(z_score[i]),
                "p_value": 1.0 if zero_var[i] else float(p_val[i]),
            })

    adata.uns[key_added] = pd.DataFrame(rows)
    logger.info(f"Global {'Moran I' if stat == 'moran' else 'Geary C'} "
                f"completed in {time.time() - start:.1f}s")
    update_metadata(
        adata,
        function_name="morans_i" if stat == "moran" else "gearys_c",
        parameters={
            "genes": gene_names[:10], "n_genes": len(gene_names),
            "n_neighbors": n_neighbors, "n_permutations": n_permutations,
            "use_existing_graph": use_existing_graph, "seed": seed,
            "assumption": assumption, "alternative": alternative,
            "null_method": null_method if n_permutations > 0 else "analytic",
            "backend": "spatialcore_tpu_torch",
            "device": str(device),
        },
        outputs={"uns": key_added},
    )
    return adata


def morans_i(adata, genes: Optional[Union[str, List[str]]] = None,
             layer: Optional[str] = None, spatial_key: str = "spatial",
             n_neighbors: int = 6, n_permutations: int = 10, seed: int = 0,
             key_added: str = "morans_i", copy: bool = False,
             use_existing_graph: bool = False,
             assumption: Literal["normality", "randomization"] = "normality",
             alternative: Optional[Literal["greater", "less", "two-sided"]] = None,
             gene_batch_size: int = 512, mesh=None, null_method: str = "auto",
             device: Device = "cuda"):
    """Global Moran's I per gene.

    Results land in ``adata.uns[key_added]`` as a DataFrame with columns
    ``gene, I, expected_I, z_score, p_value``. ``p_value`` is the seeded
    permutation p-value when ``n_permutations > 0``, else the analytic tail
    probability under ``assumption``; ``z_score`` uses the analytic
    variance. ``null_method``: "banded" (bf16 null) or "banded_int8"
    (per-gene int8 null); "auto" picks "banded" at >=100k cells when
    genes × permutations >= 16,384 and otherwise the slot null, which is
    not ported yet (NotImplementedError).
    """
    return _global_autocorr(
        adata, "moran", genes, layer, spatial_key, n_neighbors, n_permutations,
        seed, key_added, copy, use_existing_graph, assumption, alternative,
        gene_batch_size, mesh=mesh, null_method=null_method, device=device)


def gearys_c(adata, genes: Optional[Union[str, List[str]]] = None,
             layer: Optional[str] = None, spatial_key: str = "spatial",
             n_neighbors: int = 6, n_permutations: int = 10, seed: int = 0,
             key_added: str = "gearys_c", copy: bool = False,
             use_existing_graph: bool = False,
             assumption: Literal["normality", "randomization"] = "normality",
             alternative: Optional[Literal["greater", "less", "two-sided"]] = None,
             gene_batch_size: int = 512, mesh=None, null_method: str = "auto",
             device: Device = "cuda"):
    """Global Geary's C per gene: columns ``gene, C, expected_C, z_score,
    p_value``; default ``alternative='less'``. Otherwise as :func:`morans_i`.
    """
    return _global_autocorr(
        adata, "geary", genes, layer, spatial_key, n_neighbors, n_permutations,
        seed, key_added, copy, use_existing_graph, assumption, alternative,
        gene_batch_size, mesh=mesh, null_method=null_method, device=device)
