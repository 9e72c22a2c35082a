"""Public spatial autocorrelation: global Moran's I and Geary's C (apart
or fused), local Moran's I (LISA), local Geary's C (and its multivariate
form), Getis-Ord Gi* / Gi, Lee's L and join counts (global and local).

Port of ``build_spatial_weights`` (kNN and radius graphs), ``morans_i``,
``gearys_c``, ``global_autocorrelation``, ``local_morans_i``,
``local_gearys_c``, ``local_gearys_c_multivariate``, ``getis_ord_gi``,
``lees_l``, ``lees_l_local``, ``join_count_statistics``,
``local_join_counts`` and ``moran_correlogram`` of
``spatialcore_tpu/spatial/autocorrelation.py`` and their helpers. Same
parameters and outputs (the global ``uns`` DataFrames
``gene, I|C, expected_I|expected_C, z_score, p_value``; the local ``obsm``
planes and ``uns[f"{key}_params"]``; the per-cell ``obs`` columns of Lee's
L, the local join counts and the multivariate Geary), plus an explicit
``device``. "Device mode" of the local functions — outputs kept on the
card — is "X is a CUDA tensor".

Permutation p-values come from the banded nulls (``ops/banded.py``) or
the slot nulls (``ops/moran.py``, ``ops/getis.py``; Lee's L: its direct
null in ``ops/lee.py``), chosen by ``null_method`` as in the reference.
The global functions take a ``mesh`` (``parallel.auto_mesh``) and shard
each gene batch over its ``genes`` axis. Unknown ``null_method`` strings raise
``ValueError`` (the reference's global path runs the slot null for them,
ROADMAP Queue 3).
"""

from __future__ import annotations

import time
from itertools import combinations
from typing import List, Literal, Optional, Sequence, Tuple, Union

import numpy as np
import pandas as pd
import scipy.sparse as sp
import torch

from ..core.logging import get_logger
from ..core.metadata import update_metadata
from ..ops.banded import (banded_getis, banded_lees_l, banded_local_geary,
                          banded_local_moran, banded_permutation_test,
                          build_null_plan)
from ..ops.fdr import apply_fdr
from ..ops.graph import SpatialGraph, build_graph, graph_from_numpy, graph_moments
from ..ops.getis import getis_ord
from ..ops.lee import lees_l_pairs
from ..ops.moran import (QUADRANT_LABELS, classify_quadrants,
                         geary_analytic_moments, geary_observed, join_counts,
                         local_geary, local_geary_multivariate,
                         local_join_counts as _local_join_counts, local_moran,
                         moran_analytic_moments, moran_observed, p_from_z,
                         permutation_test_global, standardize)
from ..ops.streaming import (device_local_sink, host_local_sink,
                             streaming_local_null)
from ..utils import profiling
from ..utils.profiling import read_back, span, traced

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
    """Build the row-normalized kNN weights graph on ``device``; with
    ``radius`` (and its ``k_max`` degree cap) a radius graph instead, whose
    rows weight each neighbour in radius 1/count (``ops.graph.build_graph``;
    a cell with more than ``k_max`` neighbours in radius raises).

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


class _GeneShard:
    """One rank's share of a gene batch of width G under ``mesh``: the
    batch padded to a multiple of the gene shard count gs, block ``genes``
    of it (``parallel.stats.span``), and the gather back. The gene pad
    columns have zero variance and are trimmed after the gather. Every sum
    over the cells runs in one fixed order whatever the width
    (``ops.moran._column_sums``), so a rank's genes keep the bits of the
    call without a mesh."""

    def __init__(self, mesh, Xb: torch.Tensor):
        from ..parallel.stats import _where, span

        self.mesh = mesh
        coord, shape = _where(mesh)
        self.G, self.gs = Xb.shape[1], shape[1]
        self.pad = (-self.G) % self.gs
        self.c0, self.c1 = span(self.G + self.pad, self.gs, coord[1])

    def columns(self, Xb: torch.Tensor) -> torch.Tensor:
        if self.pad:
            Xb = torch.nn.functional.pad(Xb, (0, self.pad))
        return Xb[:, self.c0:self.c1]

    def gather(self, parts: list) -> list:
        """Each rank's [g] results in gene order, trimmed to G: one
        all-gather over ``genes`` for all of them."""
        from ..parallel.stats import all_gather

        if self.gs == 1:
            return parts
        local = torch.stack([p.to(torch.float64) for p in parts])
        out = torch.empty((self.gs * local.shape[0], local.shape[1]),
                          dtype=local.dtype, device=local.device)
        all_gather(out, local, self.mesh.get_group("genes"))
        whole = out.reshape((self.gs,) + local.shape).permute(1, 0, 2)
        whole = whole.reshape(len(parts), -1)[:, :self.G]
        return [whole[i].to(p.dtype) for i, p in enumerate(parts)]


def _auto_null_method(n_cells: int, n_genes: int, n_permutations: int) -> str:
    """Resolve null_method='auto' exactly as the reference: the banded null
    at >=100k cells when genes × permutations >= 16,384, else the slot null.
    The choice depends on sizes only, never on data values."""
    return ("banded" if n_permutations > 0 and n_cells >= 100_000
            and n_genes * n_permutations >= 16_384 else "slots")


#: per statistic: (column, observed, analytic moments, default alternative)
_GLOBAL_STATS = {"moran": ("I", moran_observed, moran_analytic_moments, "greater"),
                 "geary": ("C", geary_observed, geary_analytic_moments, "less")}


def _global_autocorr(adata, stats: Tuple[str, ...], genes, layer, spatial_key,
                     n_neighbors, n_permutations, seed, keys_added: Tuple[str, ...],
                     copy, use_existing_graph, assumption: str, alternatives,
                     gene_batch_size: int, mesh=None, null_method: str = "auto",
                     device: Device = "cuda",
                     function_name: Optional[str] = None):
    """Global Moran's I and/or Geary's C (``stats``), one uns DataFrame per
    statistic under ``keys_added``. With both statistics the banded null
    runs its fused pass (``stat="moran_geary"``: one gather and one cross
    per draw); the slot null runs once per statistic."""
    start = time.time()
    if null_method not in NULL_METHODS:
        raise ValueError(f"null_method must be one of {NULL_METHODS}, "
                         f"got {null_method!r}")
    if copy:
        adata = adata.copy()
    if spatial_key not in adata.obsm:
        raise ValueError(f"adata.obsm['{spatial_key}'] not found. "
                         "Spatial coordinates are required.")
    gene_names = _resolve_genes(adata, genes)
    alts = tuple(a or _GLOBAL_STATS[s][3] for s, a in zip(stats, alternatives))
    if null_method == "auto":
        null_method = _auto_null_method(adata.n_obs, len(gene_names),
                                        n_permutations)

    graph = _get_graph(adata, n_neighbors, spatial_key, use_existing_graph,
                       device)
    moments = _get_graph_moments(adata, graph)
    S0, S1, S2 = moments["S0"], moments["S1"], moments["S2"]
    null_precision = "int8" if null_method == "banded_int8" else "bf16"
    plan = (_get_null_plan(adata, graph, spatial_key)
            if n_permutations > 0 and null_method != "slots" else None)
    fused = len(stats) == 2

    rows = {s: [] for s in stats}
    for batch_start in range(0, len(gene_names), gene_batch_size):
        batch = gene_names[batch_start:batch_start + gene_batch_size]
        with span("prep"):
            Xb = _dense_expression(adata, batch, layer, device)
            shard = _GeneShard(mesh, Xb) if mesh is not None else None
            if shard is not None:
                Xb = shard.columns(Xb)
            Z, zero_var = standardize(Xb)
            obs, expected, z_score = {}, {}, {}
            for s in stats:
                _, obs_fn, moments_fn, _ = _GLOBAL_STATS[s]
                obs[s] = obs_fn(graph, Z, S0)
                expected[s], var = moments_fn(Z, S0, S1, S2, assumption)
                z_score[s] = (obs[s] - expected[s]) / torch.sqrt(
                    torch.clamp_min(var, 1e-30))
        if plan is not None:
            p_val, _, _ = banded_permutation_test(
                plan, Z, S0, torch.stack([obs[s] for s in stats]) if fused
                else obs[stats[0]], seed, n_permutations,
                stat="moran_geary" if fused else stats[0],
                alternative=alts if fused else alts[0], precision=null_precision,
                launch_genes=None if shard is None else shard.G)
            p_val = dict(zip(stats, p_val if fused else [p_val]))
        elif n_permutations > 0:
            p_val = {s: permutation_test_global(
                graph, Z, S0, obs[s], seed, n_permutations, stat=s,
                alternative=a)[0] for s, a in zip(stats, alts)}
        else:
            p_val = {s: p_from_z(z_score[s], a) for s, a in zip(stats, alts)}
        if shard is not None:
            parts = shard.gather([t for s in stats
                                  for t in (obs[s], z_score[s], p_val[s])]
                                 + [zero_var.to(torch.float32)])
            for i, s in enumerate(stats):
                obs[s], z_score[s], p_val[s] = parts[3 * i:3 * i + 3]
            zero_var = parts[-1] > 0
        zv = read_back(zero_var).numpy()
        for s in stats:
            col = _GLOBAL_STATS[s][0]
            o, z, p = (read_back(t).numpy()
                       for t in (obs[s], z_score[s], p_val[s]))
            rows[s].extend({
                "gene": g, col: float(o[i]),
                f"expected_{col}": float(expected[s]),
                "z_score": 0.0 if zv[i] else float(z[i]),
                "p_value": 1.0 if zv[i] else float(p[i]),
            } for i, g in enumerate(batch))

    for s, key in zip(stats, keys_added):
        adata.uns[key] = pd.DataFrame(rows[s])
    names = " + ".join("Moran I" if s == "moran" else "Geary C" for s in stats)
    logger.info(f"Global {names} completed in {time.time() - start:.1f}s")
    update_metadata(
        adata,
        function_name=function_name or ("morans_i" if stats[0] == "moran"
                                        else "gearys_c"),
        parameters={
            "genes": gene_names[:10], "n_genes": len(gene_names),
            "n_neighbors": n_neighbors, "n_permutations": n_permutations,
            "use_existing_graph": use_existing_graph, "seed": seed,
            "assumption": assumption,
            **({"alternatives": list(alts)} if fused
               else {"alternative": alts[0]}),
            "null_method": null_method if n_permutations > 0 else "analytic",
            "backend": "spatialcore_tpu_torch",
            "device": str(device),
        },
        outputs={"uns": list(keys_added) if fused else keys_added[0]},
    )
    return adata


@traced("spatial.morans_i")
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
    variance. ``null_method``: "banded" (bf16 null), "banded_int8"
    (per-gene int8 null) or "slots" (the slot null,
    ``ops.moran.permutation_test_global``: ``jax.random.permutation``'s
    draws); "auto" picks "banded" at >=100k cells when genes ×
    permutations >= 16,384 and otherwise the slot null.

    ``mesh`` (a ``parallel.auto_mesh`` ``DeviceMesh``; every rank calls
    with the same arguments): each gene batch is padded to a multiple of
    the ``genes`` shard count, each rank runs its block of columns through
    standardize, the observed value, the moments and the null, and one
    all-gather a batch brings the columns back. The table is bitwise the
    mesh-less call's: each gene's values and draws do not depend on its
    neighbours in the batch, every sum over the cells runs in one fixed
    order whatever the width, and the band null launches at the batch's
    shape. (Geary's C under the band nulls sums its Σz² term at the
    shard's width: its p can differ only where a draw ties the observed
    value within float32 rounding.)
    """
    return _global_autocorr(
        adata, ("moran",), genes, layer, spatial_key, n_neighbors,
        n_permutations, seed, (key_added,), copy, use_existing_graph,
        assumption, (alternative,), gene_batch_size, mesh=mesh,
        null_method=null_method, device=device)


@traced("spatial.gearys_c")
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
        adata, ("geary",), genes, layer, spatial_key, n_neighbors,
        n_permutations, seed, (key_added,), copy, use_existing_graph,
        assumption, (alternative,), gene_batch_size, mesh=mesh,
        null_method=null_method, device=device)


@traced("spatial.global_autocorrelation")
def global_autocorrelation(
        adata, genes: Optional[Union[str, List[str]]] = None,
        layer: Optional[str] = None, spatial_key: str = "spatial",
        n_neighbors: int = 6, n_permutations: int = 10, seed: int = 0,
        keys_added: Tuple[str, str] = ("morans_i", "gearys_c"),
        copy: bool = False, use_existing_graph: bool = False,
        assumption: Literal["normality", "randomization"] = "normality",
        alternatives: Tuple[Optional[str], Optional[str]] = (None, None),
        gene_batch_size: int = 512, mesh=None, null_method: str = "auto",
        device: Device = "cuda"):
    """Global Moran's I AND Geary's C per gene in one permutation pass.

    Both statistics are linear in the same band cross Σ w_ij z_i z_j, so
    the banded null's fused pass (``stat="moran_geary"``) makes one row
    gather and one band cross per draw for both and counts extremes for
    each; the p-values are bitwise those of separate :func:`morans_i` and
    :func:`gearys_c` calls with the same seed (the draw streams coincide).
    Below the banded size threshold ("auto" → "slots") the slot null runs
    once per statistic on the shared standardize and graph pass.

    Writes the two uns DataFrames the separate calls write (``gene, I|C,
    expected_I|expected_C, z_score, p_value``) under ``keys_added``.
    ``alternatives`` defaults to ("greater", "less"). ``null_method`` as in
    :func:`morans_i`.
    """
    return _global_autocorr(
        adata, ("moran", "geary"), genes, layer, spatial_key, n_neighbors,
        n_permutations, seed, tuple(keys_added), copy, use_existing_graph,
        assumption, tuple(alternatives), gene_batch_size, mesh=mesh,
        null_method=null_method, device=device,
        function_name="global_autocorrelation")


# ---------------------------------------------------------------------------
# Local Moran's I
# ---------------------------------------------------------------------------

LOCAL_KEYS = ("I", "z", "lag", "p", "p_adj", "quadrant")
COMPACT_KEYS = ("I", "p", "p_adj", "quadrant")


def _concat_device_batches(batches: list) -> tuple:
    """Concatenate per-batch output tuples along the gene axis (axis 0 for
    1-D fields), freeing each field's sources as it is consumed so the
    peak stays near the final output set rather than twice it."""
    cols = [list(t) for t in zip(*batches)]
    batches.clear()
    outs = []
    for i, col in enumerate(cols):
        outs.append(col[0] if len(col) == 1 else
                    torch.cat(col, dim=1 if col[0].ndim > 1 else 0))
        cols[i] = None
    return tuple(outs)


def _x_is_device(adata, layer) -> bool:
    X = (adata.layers[layer] if layer and layer in getattr(adata, "layers", {})
         else getattr(adata, "X", None))
    return isinstance(X, torch.Tensor) and X.is_cuda


def _check_output_mode(output_mode: str) -> None:
    if output_mode not in ("auto", "full", "compact"):
        raise ValueError(f"output_mode must be 'auto', 'full' or "
                         f"'compact', got {output_mode!r}")


def _resolve_output_mode(output_mode: str, plan, X_is_device: bool, n_cells,
                         n_genes, bytes_per_value: int, n_permutations: int,
                         hint: str) -> str:
    """"auto" streams (compact) when the full planes of a CUDA ``X`` would
    exceed ~8 GB on the banded path; "compact" needs that path."""
    if output_mode == "auto":
        output_mode = ("compact" if plan is not None and X_is_device
                       and n_cells * n_genes * bytes_per_value > 8e9 else "full")
    if output_mode == "compact" and (plan is None or n_permutations <= 0):
        raise ValueError("output_mode='compact' streams through the banded "
                         f"null path — use {hint} and n_permutations > 0")
    return output_mode


def _run_compact_stream(adata, stat: str, names, layer, graph, plan,
                        n_permutations, fdr, alpha, seed, tile, precision,
                        X_is_device, device_keys, device: Device, star=True,
                        alternative="two-sided", pair_names=None):
    """Shared memory-bounded local-statistic runner: stream gene (Lee: gene
    pair) tiles through ``ops.streaming.streaming_local_null`` and return
    the output planes. A CUDA ``X`` keeps compact planes on the card
    (``device_keys`` only, through the lean post-pass that computes just
    those); any other ``X`` flushes float32 host arrays per tile. Serves
    the ``output_mode="compact"`` paths of ``local_morans_i``,
    ``local_gearys_c``, ``getis_ord_gi`` and ``lees_l_local`` (whose
    ``pair_names`` are the pairs' x and y gene lists)."""
    if stat == "lee":
        gx, gy = pair_names
        n_items = len(gx)

        def get_tile(s, w):
            _count_pair_columns(gx[s:s + w], gy[s:s + w])
            return (_dense_expression(adata, gx[s:s + w], layer, device),
                    _dense_expression(adata, gy[s:s + w], layer, device))
    else:
        n_items = len(names)

        def get_tile(s, w):
            return _dense_expression(adata, names[s:s + w], layer, device)

    if X_is_device:
        sink, finalize = device_local_sink(n_items, keys=device_keys)
        stream_keys = device_keys
    else:
        sink, store = host_local_sink(adata.n_obs, n_items)
        stream_keys = None
    streaming_local_null(
        graph, plan, get_tile, n_items, sink, stat=stat, seed=seed,
        n_permutations=n_permutations, tile=tile, fdr=fdr, alpha=alpha,
        star=star, alternative=alternative, precision=precision,
        keys=stream_keys, device=device)
    return finalize() if X_is_device else store


def _local_morans_compact(adata, gene_names, layer, graph, plan, n_neighbors,
                          n_permutations, fdr_correction, alpha, seed, tile,
                          key_added, null_precision, X_is_device, start,
                          device: Device):
    """Memory-bounded LISA (:func:`_run_compact_stream`): a CUDA ``X``
    keeps I (bf16), p/p_adj (f16) and quadrant (int8) on the card, 7 bytes
    per cell and gene (~7 GB at 1M × 1,024 against 24 GB of float32
    planes)."""
    n_genes = len(gene_names)
    out = _run_compact_stream(
        adata, "moran", gene_names, layer, graph, plan, n_permutations,
        fdr_correction, alpha, seed, tile, null_precision, X_is_device,
        COMPACT_KEYS, device)
    for k in COMPACT_KEYS:
        adata.obsm[f"{key_added}_{k}"] = out[k]
    elapsed = time.time() - start
    adata.uns[f"{key_added}_params"] = {
        "genes": gene_names,
        "n_neighbors": n_neighbors,
        "n_permutations": n_permutations,
        "fdr_correction": fdr_correction,
        "alpha": alpha,
        "seed": seed,
        "null": "total",
        "null_method": ("banded_int8" if null_precision == "int8"
                        else "banded"),
        "null_precision": null_precision,
        "output_mode": "compact",
        "tile": tile,
        "quadrant_labels": dict(QUADRANT_LABELS),
        "computation_time_seconds": elapsed,
    }
    logger.info(f"Local Moran's I (compact streaming) completed in "
                f"{elapsed:.1f}s")
    update_metadata(
        adata, "local_morans_i",
        parameters={"genes": gene_names[:10], "n_genes": n_genes,
                    "n_neighbors": n_neighbors,
                    "n_permutations": n_permutations,
                    "fdr_correction": fdr_correction, "alpha": alpha,
                    "seed": seed, "output_mode": "compact",
                    "backend": "spatialcore_tpu_torch",
                    "device": str(device)},
        outputs={f"obsm_{s}": f"{key_added}_{s}" for s in COMPACT_KEYS}
        | {"uns_params": f"{key_added}_params"},
    )
    return adata


@traced("spatial.local_morans_i")
def local_morans_i(
    adata,
    genes: Optional[Union[str, List[str]]] = None,
    layer: Optional[str] = None,
    spatial_key: str = "spatial",
    n_neighbors: int = 6,
    n_permutations: int = 10,
    fdr_correction: Literal["bonferroni", "fdr_bh", "none"] = "fdr_bh",
    alpha: float = 0.05,
    seed: int = 0,
    batch_size: int = 100,
    key_added: str = "local_morans",
    copy: bool = False,
    use_existing_graph: bool = False,
    null_method: str = "auto",
    null: str = "total",
    output_mode: str = "auto",
    device: Device = "cuda",
):
    """Local Moran's I (LISA) with permutation p-values.

    Writes six ``obsm`` planes, ``{key}_I, {key}_z, {key}_lag, {key}_p,
    {key}_p_adj, {key}_quadrant`` (quadrant codes int8 0=NS, 1=HH, 2=LL,
    3=HL, 4=LH after FDR at ``alpha``) and ``uns[f"{key}_params"]``. When
    ``X`` (or ``layer``) is a CUDA tensor the planes stay CUDA tensors;
    otherwise they are host numpy arrays. The observed I/z/lag come from
    one exact lag pass.

    ``null``: "total" (the reference's default) permutes whole columns;
    "conditional" (GeoDa/esda) keeps each cell's own value and draws its
    neighbours without replacement from the other cells.

    ``null_method``: "slots" (the slot null, ``ops.moran.local_moran``;
    torch ops, one draw at a time), "banded" (bf16 null) or "banded_int8"
    (the per-gene int8 null: exact integer draw steps in the Hopper
    kernel, int8 counters for P ≤ 127; pair it with a large
    ``batch_size``). "auto" resolves as the reference: the banded f32 null
    on graphs with k ≥ 16 at ≥ 100k cells with the total null, else the
    slot null. The banded methods with ``null="conditional"`` warn and run
    the slot null. Each gene batch draws the same permutations.

    ``output_mode``: "full" keeps the six float32 planes; "compact"
    streams gene tiles of ``max(batch_size, 256)`` through
    ``ops.streaming.streaming_local_null`` and keeps I (bf16), p and p_adj
    (f16) and quadrant (int8) on the card for a CUDA ``X`` (float32 host
    arrays otherwise); "auto" picks "compact" when the six planes of a
    CUDA ``X`` would exceed ~8 GB on the banded path.
    """
    start = time.time()
    if null_method not in NULL_METHODS:
        raise ValueError(f"null_method must be one of {NULL_METHODS}, "
                         f"got {null_method!r}")
    if null not in ("total", "conditional"):
        raise ValueError(f"null must be 'total' or 'conditional', got {null!r}")
    _check_output_mode(output_mode)
    if copy:
        adata = adata.copy()
    if spatial_key not in adata.obsm:
        raise ValueError(f"adata.obsm['{spatial_key}'] not found. "
                         "Spatial coordinates are required.")
    gene_names = _resolve_genes(adata, genes)
    n_cells, n_genes = adata.n_obs, len(gene_names)
    logger.info(f"Local Moran's I: {n_cells:,} cells × {n_genes} genes, "
                f"k={n_neighbors}, P={n_permutations}")

    graph = _get_graph(adata, n_neighbors, spatial_key, use_existing_graph,
                       device)

    null_precision = "bf16"
    if null_method == "auto":
        k_eff = int(graph.neighbor_idx.shape[1])
        if (n_permutations > 0 and null == "total"
                and n_cells >= 100_000 and k_eff >= 16):
            null_method, null_precision = "banded", "f32"
        else:
            null_method = "slots"
    if null_method == "banded_int8":
        null_method, null_precision = "banded", "int8"
    plan = None
    if null_method == "banded" and n_permutations > 0:
        if null == "conditional":
            logger.warning("null='conditional' is not supported by the "
                           "banded path; using the direct kernel")
            null_method, null_precision = "slots", "bf16"
        else:
            plan = _get_null_plan(adata, graph, spatial_key)

    X_is_device = _x_is_device(adata, layer)
    output_mode = _resolve_output_mode(
        output_mode, plan, X_is_device, n_cells, n_genes, 24, n_permutations,
        "null_method='banded'/'banded_int8'")
    if output_mode == "compact":
        return _local_morans_compact(
            adata, gene_names, layer, graph, plan, n_neighbors,
            n_permutations, fdr_correction, alpha, seed,
            max(batch_size, 256), key_added, null_precision, X_is_device,
            start, device)

    batches = []    # device mode: per-batch (I, z, lag, p, zero_var)
    planes = None   # host mode: six numpy planes
    zero_var_all = np.zeros(n_genes, bool)
    for bs in range(0, n_genes, batch_size):
        batch = gene_names[bs:bs + batch_size]
        with span("prep"):
            Z, zero_var = standardize(_dense_expression(adata, batch, layer,
                                                        device))
        if plan is not None:
            res = banded_local_moran(plan, graph, Z, seed=seed,
                                     n_permutations=n_permutations,
                                     precision=null_precision)
        else:
            res = local_moran(graph, Z, seed, n_permutations, null=null)
        del Z
        if X_is_device:
            batches.append((res.local_I, res.z, res.lag, res.p_value,
                            zero_var))
            continue
        if planes is None:
            planes = [np.zeros((n_cells, n_genes), np.float32)
                      for _ in range(3)] + [np.ones((n_cells, n_genes),
                                                    np.float32)]
        sl = slice(bs, bs + len(batch))
        for plane, t in zip(planes, res):
            plane[:, sl] = read_back(t).numpy()
        zero_var_all[sl] = read_back(zero_var).numpy()

    if X_is_device and batches:
        I_all, z_all, lag_all, p_all, zv = _concat_device_batches(batches)
        zv2 = zv[None, :]
        I_all = torch.where(zv2, 0.0, I_all)
        z_all = torch.where(zv2, 0.0, z_all)
        lag_all = torch.where(zv2, 0.0, lag_all)
        p_all = torch.where(zv2, 1.0, p_all)
        zero_var_all = read_back(zv).numpy()
    else:
        X_is_device = False      # no genes: documented [N, 0] host planes
        if planes is None:
            planes = [np.zeros((n_cells, n_genes), np.float32)
                      for _ in range(3)] + [np.ones((n_cells, n_genes),
                                                    np.float32)]
        I_all, z_all, lag_all, p_all = planes
    if zero_var_all.any():
        logger.warning(f"{int(zero_var_all.sum())} zero-variance genes set "
                       "to 0/NS")
        if not X_is_device:
            for plane in (I_all, z_all, lag_all):
                plane[:, zero_var_all] = 0.0
            p_all[:, zero_var_all] = 1.0

    def dev(a):
        return a if X_is_device else torch.as_tensor(a, device=device)

    def out(t):
        return t if X_is_device else read_back(t).numpy()

    if n_permutations > 0:
        p_adj_t = apply_fdr(dev(p_all), fdr_correction, axis=0,
                            n_levels=n_permutations + 1)
        quadrants = out(classify_quadrants(dev(z_all), dev(lag_all), p_adj_t,
                                           alpha))
        p_adj = out(p_adj_t)
        del p_adj_t
    else:
        logger.warning(
            "n_permutations=0: quadrants classified by z/lag signs only, "
            "without significance filtering.")
        p_adj = p_all
        quadrants = out(classify_quadrants(dev(z_all), dev(lag_all), None,
                                           alpha))

    adata.obsm[f"{key_added}_I"] = I_all
    adata.obsm[f"{key_added}_z"] = z_all
    adata.obsm[f"{key_added}_lag"] = lag_all
    adata.obsm[f"{key_added}_p"] = p_all
    adata.obsm[f"{key_added}_p_adj"] = p_adj
    adata.obsm[f"{key_added}_quadrant"] = quadrants

    elapsed = time.time() - start
    adata.uns[f"{key_added}_params"] = {
        "genes": gene_names,
        "n_neighbors": n_neighbors,
        "n_permutations": n_permutations,
        "fdr_correction": fdr_correction,
        "alpha": alpha,
        "seed": seed,
        "null": null,
        "null_method": ("banded_int8" if null_precision == "int8"
                        else null_method),
        "null_precision": null_precision if null_method == "banded" else "f32",
        "quadrant_labels": dict(QUADRANT_LABELS),
        "computation_time_seconds": elapsed,
    }
    logger.info(f"Local Moran's I completed in {elapsed:.1f}s")
    update_metadata(
        adata, "local_morans_i",
        parameters={"genes": gene_names[:10], "n_genes": n_genes,
                    "n_neighbors": n_neighbors,
                    "n_permutations": n_permutations,
                    "fdr_correction": fdr_correction, "alpha": alpha,
                    "seed": seed, "backend": "spatialcore_tpu_torch",
                    "device": str(device)},
        outputs={f"obsm_{s}": f"{key_added}_{s}" for s in LOCAL_KEYS}
        | {"uns_params": f"{key_added}_params"},
    )
    return adata


# ---------------------------------------------------------------------------
# Local Geary's C and Getis-Ord Gi* / Gi
# ---------------------------------------------------------------------------

LOCAL_NULL_METHODS = ("auto", "banded", "banded_int8", "direct")


def _check_local_null_method(null_method: str) -> None:
    if null_method not in LOCAL_NULL_METHODS:
        raise ValueError("null_method must be 'auto', 'banded', "
                         f"'banded_int8' or 'direct', got {null_method!r}")


def _local_null(null_method: str, n_cells: int, k_eff: int, n_permutations: int,
                total_null: bool = True):
    """Resolve a local statistic's ``null_method`` as the reference does:
    ``(use_banded, precision)``. The banded null needs permutations and the
    total null; "auto" takes it (float32) at ≥ 100k cells on k ≥ 16
    graphs."""
    precision = "int8" if null_method == "banded_int8" else "f32"
    banded = null_method in ("banded", "banded_int8")
    use = (total_null and n_permutations > 0 and null_method != "direct"
           and (banded or (n_cells >= 100_000 and k_eff >= 16)))
    return use, precision


@traced("spatial.local_gearys_c")
def local_gearys_c(
    adata,
    genes: Optional[Union[str, List[str]]] = None,
    layer: Optional[str] = None,
    spatial_key: str = "spatial",
    n_neighbors: int = 6,
    n_permutations: int = 99,
    fdr_correction: Literal["bonferroni", "fdr_bh", "none"] = "fdr_bh",
    seed: int = 0,
    batch_size: int = 100,
    key_added: str = "local_geary",
    use_existing_graph: bool = False,
    null: str = "conditional",
    copy: bool = False,
    null_method: str = "auto",
    output_mode: str = "auto",
    device: Device = "cuda",
):
    """Local Geary's C per cell × gene: c_i = Σ_j w_ij (z_i − z_j)².

    Small C with small p: the cell sits in a coherent neighbourhood for
    that gene. Writes ``obsm[f"{key}_C"]``, ``obsm[f"{key}_p"]`` (one-sided,
    low tail), ``obsm[f"{key}_p_adj"]`` and ``uns[f"{key}_params"]``; CUDA
    tensors when ``X`` (or ``layer``) is a CUDA tensor, host numpy arrays
    otherwise. The observed C comes from one exact pass.

    ``null``: "total" (whole-column shuffle) or "conditional" (the
    reference's default, GeoDa's convention). ``null_method``: with
    ``null="total"``, "banded" (float32 banded null, torch ops) or
    "banded_int8" (the fully integer null, k ≤ 256: the Hopper kernel's
    geary tail on the card); "auto" takes the float32 banded null at
    ≥ 100k cells on k ≥ 16 graphs. The conditional null, "direct" and
    "auto" below that run the slot null (``ops.moran.local_geary``, torch
    ops); the banded methods with the conditional null warn and run it
    too. Each gene batch draws the same permutations.

    ``output_mode``: "full" keeps three float32 [N, G] planes; "compact"
    streams gene tiles of ``max(batch_size, 256)`` through
    ``ops.streaming.streaming_local_null`` (banded path only) and keeps C
    (bf16) and p/p_adj (f16) on the card for a CUDA ``X``; "auto" picks
    "compact" when the full planes of a CUDA ``X`` would exceed ~8 GB.
    """
    _check_local_null_method(null_method)
    _check_output_mode(output_mode)
    start = time.time()
    if copy:
        adata = adata.copy()
    if spatial_key not in adata.obsm:
        raise ValueError(f"adata.obsm['{spatial_key}'] not found. "
                         "Spatial coordinates are required.")
    gene_names = _resolve_genes(adata, genes)
    n_cells, n_genes = adata.n_obs, len(gene_names)
    graph = _get_graph(adata, n_neighbors, spatial_key, use_existing_graph,
                       device)
    use_banded, band_prec = _local_null(
        null_method, n_cells, int(graph.neighbor_idx.shape[1]), n_permutations,
        total_null=null == "total")
    if null_method in ("banded", "banded_int8") and null != "total":
        logger.warning("null='conditional' is not supported by the banded "
                       "path; using the direct kernel")
    plan = _get_null_plan(adata, graph, spatial_key) if use_banded else None
    X_is_device = _x_is_device(adata, layer)
    output_mode = _resolve_output_mode(
        output_mode, plan, X_is_device, n_cells, n_genes, 12, n_permutations,
        "null='total' with null_method='banded'/'banded_int8'")
    method_name = ("banded_int8" if band_prec == "int8" else "banded")
    keys = ("C", "p", "p_adj")
    if output_mode == "compact":
        out = _run_compact_stream(
            adata, "geary", gene_names, layer, graph, plan, n_permutations,
            fdr_correction, 0.05, seed, max(batch_size, 256), band_prec,
            X_is_device, keys, device)
        for k in keys:
            adata.obsm[f"{key_added}_{k}"] = out[k]
        adata.uns[f"{key_added}_params"] = {
            "genes": gene_names, "n_neighbors": n_neighbors,
            "n_permutations": n_permutations, "seed": seed,
            "fdr_correction": fdr_correction, "null": null,
            "null_method": method_name, "output_mode": "compact",
            "computation_time_seconds": round(time.time() - start, 2),
        }
        logger.info(f"Local Geary's C (compact streaming): {n_cells:,} cells "
                    f"× {n_genes} genes ({time.time() - start:.1f}s)")
        update_metadata(adata, "local_gearys_c",
                        parameters={"n_genes": n_genes,
                                    "n_permutations": n_permutations,
                                    "seed": seed, "output_mode": "compact",
                                    "backend": "spatialcore_tpu_torch",
                                    "device": str(device)},
                        outputs={"obsm": [f"{key_added}_{k}" for k in keys],
                                 "uns": f"{key_added}_params"})
        return adata

    batches = []
    for bs in range(0, n_genes, batch_size):
        batch = gene_names[bs:bs + batch_size]
        Z, zero_var = standardize(_dense_expression(adata, batch, layer, device))
        if plan is not None:
            C = local_geary(graph, Z, seed, 0, null=null).local_C
            p = banded_local_geary(plan, Z, seed, n_permutations,
                                   precision=band_prec)[1]
        else:
            C, p = local_geary(graph, Z, seed, n_permutations, null=null)
        del Z
        zv = zero_var[None, :]
        batches.append((torch.where(zv, 0.0, C), torch.where(zv, 1.0, p)))
        del C, p
    if batches:
        C_all, p_all = _concat_device_batches(batches)
    else:
        C_all = torch.zeros((n_cells, 0), device=device)
        p_all = torch.ones((n_cells, 0), device=device)
    p_adj = (apply_fdr(p_all, fdr_correction, axis=0,
                       n_levels=n_permutations + 1)
             if n_permutations > 0 else p_all)
    out = (lambda t: t) if X_is_device else (lambda t: t.cpu().numpy())
    adata.obsm[f"{key_added}_C"] = out(C_all)
    adata.obsm[f"{key_added}_p"] = out(p_all)
    adata.obsm[f"{key_added}_p_adj"] = out(p_adj)
    adata.uns[f"{key_added}_params"] = {
        "genes": gene_names, "n_neighbors": n_neighbors,
        "n_permutations": n_permutations, "seed": seed,
        "fdr_correction": fdr_correction, "null": null,
        "null_method": method_name if plan is not None else "direct",
        "computation_time_seconds": round(time.time() - start, 2),
    }
    logger.info(f"Local Geary's C: {n_cells:,} cells × {n_genes} genes "
                f"({time.time() - start:.1f}s)")
    update_metadata(adata, "local_gearys_c",
                    parameters={"n_genes": n_genes,
                                "n_permutations": n_permutations,
                                "seed": seed,
                                "backend": "spatialcore_tpu_torch",
                                "device": str(device)},
                    outputs={"obsm": [f"{key_added}_{k}" for k in keys],
                             "uns": f"{key_added}_params"})
    return adata


@traced("spatial.getis_ord_gi")
def getis_ord_gi(
    adata,
    genes: Optional[Union[str, List[str]]] = None,
    layer: Optional[str] = None,
    spatial_key: str = "spatial",
    n_neighbors: int = 6,
    star: bool = True,
    alternative: Literal["two-sided", "greater", "less"] = "two-sided",
    n_permutations: int = 0,
    fdr_correction: Literal["bonferroni", "fdr_bh", "none"] = "fdr_bh",
    alpha: float = 0.05,
    seed: int = 0,
    batch_size: int = 100,
    key_added: str = "getis_ord",
    copy: bool = False,
    use_existing_graph: bool = False,
    null_method: str = "auto",
    output_mode: str = "auto",
    device: Device = "cuda",
):
    """Getis-Ord Gi* (``star``) / Gi hot-spot z-scores per cell × gene, on
    RAW expression (binary kNN adjacency).

    Writes ``obsm[f"{key}_G" / "_z" / "_p" / "_p_adj" / "_hotspot"]`` (and
    ``_p_sim`` with permutations; hotspot int8: 1 hot, −1 cold, 0 NS after
    FDR at ``alpha``) and ``uns[f"{key}_params"]``; CUDA tensors when ``X``
    is a CUDA tensor, host numpy arrays otherwise. G, z and the analytic p
    come from one exact pass. The default ``n_permutations=0`` is the
    analytic path alone (BH over the analytic p, no kernel).

    With permutations, ``null_method`` "banded" (float32 banded null,
    torch ops) or "banded_int8" (per-gene int8 codes against the exact
    binary adjacency: the Hopper kernel's getis_star / getis_g tail on the
    card) gives p_sim, and BH runs over p_sim; "auto" takes the float32
    banded null at ≥ 100k cells on k ≥ 16 graphs. "direct" (and "auto"
    below that) is the slot null (``ops.getis.getis_ord``, torch ops),
    whose gene batches each draw the same permutations.

    ``output_mode``: "full" keeps float32 planes; "compact" streams gene
    tiles through ``ops.streaming.streaming_local_null`` (banded path
    only), keeping G / z (bf16), p / p_sim / p_adj (f16) and hotspot
    (int8) on the card for a CUDA ``X``; "auto" picks "compact" when the
    full planes of a CUDA ``X`` would exceed ~8 GB.
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    if spatial_key not in adata.obsm:
        raise ValueError(f"adata.obsm['{spatial_key}'] not found. Spatial "
                         "coordinates are required.")
    if alternative not in ("two-sided", "greater", "less"):
        raise ValueError("alternative must be 'two-sided', 'greater' or "
                         f"'less', got {alternative!r}")
    _check_local_null_method(null_method)
    _check_output_mode(output_mode)
    gene_names = _resolve_genes(adata, genes)
    n_cells, n_genes = adata.n_obs, len(gene_names)
    logger.info(f"Getis-Ord {'Gi*' if star else 'Gi'}: {n_cells:,} cells × "
                f"{n_genes} genes, k={n_neighbors}, P={n_permutations}")
    graph = _get_graph(adata, n_neighbors, spatial_key, use_existing_graph,
                       device)
    use_banded, band_prec = _local_null(
        null_method, n_cells, int(graph.neighbor_idx.shape[1]), n_permutations)
    plan = _get_null_plan(adata, graph, spatial_key) if use_banded else None
    X_is_device = _x_is_device(adata, layer)
    output_mode = _resolve_output_mode(
        output_mode, plan, X_is_device, n_cells, n_genes, 24, n_permutations,
        "null_method='banded'/'banded_int8'")
    method_name = ("banded_int8" if band_prec == "int8" else "banded")
    suffix = {"G": "G", "z_score": "z", "p": "p", "p_sim": "p_sim",
              "p_adj": "p_adj", "hotspot": "hotspot"}
    if output_mode == "compact":
        out = _run_compact_stream(
            adata, "getis", gene_names, layer, graph, plan, n_permutations,
            fdr_correction, alpha, seed, max(batch_size, 256), band_prec,
            X_is_device, tuple(suffix), device, star=star,
            alternative=alternative)
        for k, sfx in suffix.items():
            adata.obsm[f"{key_added}_{sfx}"] = out[k]
        elapsed = time.time() - start
        adata.uns[f"{key_added}_params"] = {
            "genes": gene_names, "n_neighbors": n_neighbors, "star": star,
            "alternative": alternative, "n_permutations": n_permutations,
            "fdr_correction": fdr_correction, "alpha": alpha, "seed": seed,
            "null_method": method_name, "output_mode": "compact",
            "computation_time_seconds": elapsed,
        }
        update_metadata(
            adata, "getis_ord_gi",
            parameters={"genes": gene_names[:10], "n_genes": n_genes,
                        "n_neighbors": n_neighbors, "star": star,
                        "n_permutations": n_permutations, "alpha": alpha,
                        "seed": seed, "output_mode": "compact",
                        "backend": "spatialcore_tpu_torch",
                        "device": str(device)},
            outputs={f"obsm_{s}": f"{key_added}_{s}" for s in suffix.values()}
            | {"uns_params": f"{key_added}_params"})
        logger.info(f"Getis-Ord (compact streaming) completed in "
                    f"{elapsed:.1f}s")
        return adata

    batches = []
    for bs in range(0, n_genes, batch_size):
        X = _dense_expression(adata, gene_names[bs:bs + batch_size], layer,
                              device)
        res = getis_ord(graph, X, star=star, alternative=alternative,
                        seed=seed,
                        n_permutations=0 if plan is not None else n_permutations)
        p_sim = (banded_getis(plan, X, seed, n_permutations, star=star,
                              alternative=alternative, precision=band_prec)
                 if plan is not None else res.p_sim)
        del X
        batches.append((res.G, res.z_score, res.p_value, p_sim))
        del res, p_sim
    if batches:
        G_all, z_all, p_all, psim_all = _concat_device_batches(batches)
    else:
        G_all = torch.zeros((n_cells, 0), device=device)
        z_all = torch.zeros_like(G_all)
        p_all = torch.ones_like(G_all)
        psim_all = torch.ones_like(G_all)
    # p_sim lies on the (c+1)/(P+1) grid -> the sort-free discrete BH; the
    # analytic p is continuous and keeps the sort path
    p_adj = apply_fdr(psim_all if n_permutations > 0 else p_all,
                      fdr_correction, axis=0,
                      n_levels=n_permutations + 1 if n_permutations > 0 else 0)
    hotspot = torch.where(p_adj < alpha, torch.sign(z_all).to(torch.int8),
                          torch.zeros((), dtype=torch.int8, device=z_all.device))
    out = (lambda t: t) if X_is_device else (lambda t: t.cpu().numpy())
    adata.obsm[f"{key_added}_G"] = out(G_all)
    adata.obsm[f"{key_added}_z"] = out(z_all)
    adata.obsm[f"{key_added}_p"] = out(p_all)
    if n_permutations > 0:
        adata.obsm[f"{key_added}_p_sim"] = out(psim_all)
    adata.obsm[f"{key_added}_p_adj"] = out(p_adj)
    adata.obsm[f"{key_added}_hotspot"] = out(hotspot)
    elapsed = time.time() - start
    adata.uns[f"{key_added}_params"] = {
        "genes": gene_names, "n_neighbors": n_neighbors, "star": star,
        "alternative": alternative, "n_permutations": n_permutations,
        "fdr_correction": fdr_correction, "alpha": alpha, "seed": seed,
        "null_method": method_name if plan is not None else "direct",
        "computation_time_seconds": elapsed,
    }
    update_metadata(
        adata, "getis_ord_gi",
        parameters={"genes": gene_names[:10], "n_genes": n_genes,
                    "n_neighbors": n_neighbors, "star": star,
                    "n_permutations": n_permutations, "alpha": alpha,
                    "seed": seed, "backend": "spatialcore_tpu_torch",
                    "device": str(device)},
        outputs={f"obsm_{s}": f"{key_added}_{s}"
                 for s in ("G", "z", "p", "p_adj", "hotspot")}
        | {"uns_params": f"{key_added}_params"})
    logger.info(f"Getis-Ord completed in {elapsed:.1f}s")
    return adata


# ---------------------------------------------------------------------------
# Lee's L
# ---------------------------------------------------------------------------

#: Lee's quadrant categories, in the code order of ``QUADRANT_LABELS``
LEE_QUADRANTS = list(QUADRANT_LABELS.values())


def _lees_use_banded(null_method: str, n_cells: int,
                     n_permutations: int) -> Tuple[bool, str]:
    """``(use_banded, precision)`` as the reference resolves it; validates
    ``null_method`` first, so a typo fails even at ``n_permutations=0``.
    "auto" takes the float32 banded null at ≥ 100k cells and the direct
    null below; "banded" is bf16, "banded_int8" the int8 null."""
    if null_method not in LOCAL_NULL_METHODS:
        raise ValueError("null_method must be 'auto', 'banded', "
                         f"'banded_int8' or 'direct', got {null_method!r}")
    if n_permutations <= 0 or null_method == "direct":
        return False, "f32"
    if null_method == "banded":
        return True, "bf16"
    if null_method == "banded_int8":
        return True, "int8"
    return n_cells >= 100_000, "f32"


def _normalize_pairs(gene_pairs) -> Tuple[List[Tuple[str, str]], bool]:
    if isinstance(gene_pairs, tuple) and len(gene_pairs) == 2 \
            and isinstance(gene_pairs[0], str):
        return [gene_pairs], True
    return list(gene_pairs), False


def _count_pair_columns(gx: List[str], gy: List[str]) -> None:
    """Add one set of pair columns to the ``lee.pairs``, ``lee.x_genes`` and
    ``lee.y_genes`` counters: the columns built and the distinct x and y
    genes among them (host-side counts of names)."""
    profiling.count("lee.pairs", len(gx))
    profiling.count("lee.x_genes", len(set(gx)))
    profiling.count("lee.y_genes", len(set(gy)))


def _lees_columns(adata, pairs, layer, device: Device):
    """Standardized x and y columns of the pairs whose genes both vary:
    ``(ok_pairs, Zx, Zy)`` ([N, len(ok_pairs)] each, on ``device``)."""
    all_genes = sorted({g for p in pairs for g in p})
    Z, zero_var = standardize(_dense_expression(adata, all_genes, layer,
                                                device))
    zero_var = zero_var.cpu().numpy()
    gi = {g: i for i, g in enumerate(all_genes)}
    ok = [(gx, gy) for gx, gy in pairs
          if not (zero_var[gi[gx]] or zero_var[gi[gy]])]
    _count_pair_columns([gx for gx, _ in ok], [gy for _, gy in ok])
    ix = torch.as_tensor([gi[gx] for gx, _ in ok], dtype=torch.int64,
                         device=Z.device)
    iy = torch.as_tensor([gi[gy] for _, gy in ok], dtype=torch.int64,
                         device=Z.device)
    return ok, Z.index_select(1, ix), Z.index_select(1, iy)


def _check_pair_genes(adata, pairs) -> None:
    all_genes = sorted({g for p in pairs for g in p})
    missing = [g for g in all_genes if g not in adata.var_names]
    if missing:
        raise ValueError(f"Genes not found in adata.var_names: {missing}")


@traced("spatial.lees_l")
def lees_l(adata, gene_pairs: Union[Tuple[str, str], List[Tuple[str, str]]],
           layer: Optional[str] = None, spatial_key: str = "spatial",
           n_neighbors: int = 6, n_permutations: int = 199, seed: int = 0,
           use_existing_graph: bool = False, null_method: str = "auto",
           device: Device = "cuda") -> Union[dict, List[dict]]:
    """Global Lee's L for gene pair(s); returns dict(s) ``gene_x, gene_y,
    L, p_value`` and does not write ``adata``.

    L = Σ_i z_x,i · lag(z_y)_i with a two-tailed permutation p. Pairs with a
    zero-variance gene get L = 0, p = 1 with a warning. ``null_method``:
    "auto" takes the float32 banded null at ≥ 100k cells and the direct
    null below (``ops.lee.lees_l_pairs``: ``jax.random.permutation``'s
    draws, bitwise); "direct", "banded" (bf16) and "banded_int8" (the int8
    null, k ≤ 1000: the Hopper kernel's lee tail on the card) force one.
    The observed L always comes from the exact direct pass.
    """
    start = time.time()
    if spatial_key not in adata.obsm:
        raise ValueError(f"adata.obsm['{spatial_key}'] not found. "
                         "Spatial coordinates are required.")
    if n_neighbors < 1:
        raise ValueError(f"n_neighbors must be >= 1, got {n_neighbors}")
    if n_permutations < 0:
        raise ValueError(f"n_permutations must be >= 0, got {n_permutations}")
    pairs, single = _normalize_pairs(gene_pairs)
    _check_pair_genes(adata, pairs)
    graph = _get_graph(adata, n_neighbors, spatial_key, use_existing_graph,
                       device)
    ok_pairs, Zx, Zy = _lees_columns(adata, pairs, layer, device)
    use_banded, band_prec = _lees_use_banded(null_method, adata.n_obs,
                                             n_permutations)
    results_map = {}
    if ok_pairs:
        if use_banded:
            res = lees_l_pairs(graph, Zx, Zy, seed, 0)    # exact observed
            plan = _get_null_plan(adata, graph, spatial_key)
            pg = banded_lees_l(plan, Zx, Zy, seed, n_permutations,
                               precision=band_prec)[0]
        else:
            res = lees_l_pairs(graph, Zx, Zy, seed, n_permutations)
            pg = res.p_global
        Lg, pg = res.L_global.cpu().numpy(), pg.cpu().numpy()
        for i, (gx, gy) in enumerate(ok_pairs):
            results_map[(gx, gy)] = {"gene_x": gx, "gene_y": gy,
                                     "L": float(Lg[i]), "p_value": float(pg[i])}
    results = []
    for gx, gy in pairs:
        if (gx, gy) in results_map:
            results.append(results_map[(gx, gy)])
        else:
            logger.warning(f"Gene pair ({gx}, {gy}) has zero-variance gene — "
                           "L set to 0")
            results.append({"gene_x": gx, "gene_y": gy, "L": 0.0,
                            "p_value": 1.0})
    logger.info(f"Global Lee's L completed in {time.time() - start:.1f}s")
    return results[0] if single else results


@traced("spatial.lees_l_local")
def lees_l_local(
    adata,
    gene_pairs: Optional[Union[Tuple[str, str], List[Tuple[str, str]]]] = None,
    genes: Optional[List[str]] = None,
    layer: Optional[str] = None,
    spatial_key: str = "spatial",
    n_neighbors: int = 6,
    n_permutations: int = 199,
    compute_cell_pvalues: bool = False,
    significance_filter: bool = False,
    alpha: float = 0.05,
    seed: int = 0,
    copy: bool = False,
    use_existing_graph: bool = False,
    null_method: str = "auto",
    output_mode: str = "auto",
    key_added: str = "lees_local",
    fdr_correction: Literal["bonferroni", "fdr_bh", "none"] = "fdr_bh",
    device: Device = "cuda",
):
    """Local Lee's L per cell for gene pair(s) (``genes``: all pairs of
    them).

    ``output_mode="full"`` writes, per pair ``{gx}_{gy}``,
    ``obs[f"{key}_lees_l"]``, the categorical ``obs[f"{key}_quadrant"]``
    (NS/HH/LL/HL/LH of z_x against lag(z_y); with ``significance_filter``
    cells with p ≥ ``alpha`` are NS), ``obs[f"{key}_pvalue"]`` with
    ``compute_cell_pvalues``, and ``uns[f"{key}_lees_l_params"]`` with the
    global L and p and the quadrant counts; zero-variance pairs get zeros.
    "compact" streams pair tiles through ``ops.streaming.
    streaming_local_null(stat="lee")`` (the banded path with
    ``n_permutations > 0``; cell p-values always computed, ``p_adj`` by
    ``fdr_correction`` per pair) and writes [N, n_pairs] ``obsm`` planes
    ``{key_added}_L / _p / _p_adj / _quadrant`` — on the card in bf16 /
    f16 / f16 / int8 for a CUDA ``X`` — and ``uns[f"{key_added}_params"]``.
    "auto" picks "compact" for a CUDA ``X`` on the banded path with
    ``compute_cell_pvalues`` when the full planes would pass ~8 GB.
    ``null_method`` as :func:`lees_l`.
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    if spatial_key not in adata.obsm:
        raise ValueError(f"adata.obsm['{spatial_key}'] not found. "
                         "Spatial coordinates are required.")
    if n_permutations < 0:
        raise ValueError(f"n_permutations must be >= 0, got {n_permutations}")
    if significance_filter and not compute_cell_pvalues:
        raise ValueError("significance_filter=True requires "
                         "compute_cell_pvalues=True")
    if genes is not None:
        logger.warning(f"All-pairs mode: {len(genes)} genes = "
                       f"{len(genes) * (len(genes) - 1) // 2} pairs. Consider "
                       "explicit gene_pairs for better performance.")
        pairs = list(combinations(genes, 2))
    else:
        if gene_pairs is None:
            raise ValueError("Provide gene_pairs or genes")
        pairs, _ = _normalize_pairs(gene_pairs)
    _check_pair_genes(adata, pairs)
    graph = _get_graph(adata, n_neighbors, spatial_key, use_existing_graph,
                       device)
    _check_output_mode(output_mode)
    use_banded, band_prec = _lees_use_banded(null_method, adata.n_obs,
                                             n_permutations)
    X_is_device = _x_is_device(adata, layer)
    if output_mode == "auto":
        output_mode = ("compact" if use_banded and X_is_device
                       and compute_cell_pvalues
                       and adata.n_obs * len(pairs) * 16 > 8e9 else "full")
    if output_mode == "compact":
        if not use_banded or n_permutations <= 0:
            raise ValueError(
                "output_mode='compact' streams through the banded null "
                "path — use null_method='auto'/'banded'/'banded_int8' "
                "with n_permutations > 0 (and >= 100k cells for 'auto')")
        plan = _get_null_plan(adata, graph, spatial_key)
        keys = ("L", "p", "p_adj", "quadrant")
        out = _run_compact_stream(
            adata, "lee", None, layer, graph, plan, n_permutations,
            fdr_correction, alpha, seed, min(256, max(len(pairs), 1)),
            band_prec, X_is_device, keys, device,
            pair_names=([p[0] for p in pairs], [p[1] for p in pairs]))
        for k in keys:
            adata.obsm[f"{key_added}_{k}"] = out[k]
        elapsed = time.time() - start
        adata.uns[f"{key_added}_params"] = {
            "pairs": [list(p) for p in pairs],
            "n_pairs": len(pairs), "n_neighbors": n_neighbors,
            "n_permutations": n_permutations, "seed": seed,
            "alpha": alpha, "fdr_correction": fdr_correction,
            "null_method": ("banded_int8" if band_prec == "int8"
                            else "banded"),
            "output_mode": "compact",
            "quadrant_labels": dict(QUADRANT_LABELS),
            "computation_time_seconds": elapsed,
        }
        logger.info(f"Local Lee's L (compact streaming) completed in "
                    f"{elapsed:.1f}s for {len(pairs)} pair(s)")
        update_metadata(
            adata, "lees_l_local",
            parameters={"gene_pairs": [list(p) for p in pairs[:10]],
                        "n_pairs": len(pairs), "n_neighbors": n_neighbors,
                        "n_permutations": n_permutations, "alpha": alpha,
                        "seed": seed, "output_mode": "compact",
                        "backend": "spatialcore_tpu_torch",
                        "device": str(device)},
            outputs={f"obsm_{s}": f"{key_added}_{s}" for s in keys}
            | {"uns_params": f"{key_added}_params"})
        return adata

    n_cells = adata.n_obs
    ok_pairs, Zx, Zy = _lees_columns(adata, pairs, layer, device)
    if ok_pairs:
        if use_banded:
            res = lees_l_pairs(graph, Zx, Zy, seed, 0)    # exact observed
            plan = _get_null_plan(adata, graph, spatial_key)
            p_global, p_local = banded_lees_l(
                plan, Zx, Zy, seed, n_permutations, precision=band_prec,
                compute_cell_pvalues=compute_cell_pvalues)
        else:
            res = lees_l_pairs(graph, Zx, Zy, seed, n_permutations,
                               compute_cell_pvalues=compute_cell_pvalues)
            p_global, p_local = res.p_global, res.p_local
        quads = classify_quadrants(
            Zx, res.lag_zy, p_local if significance_filter else None,
            alpha).cpu().numpy().astype(np.int64)
        L_local = res.L_local.cpu().numpy()
        L_global = res.L_global.cpu().numpy()
        p_global = p_global.cpu().numpy()
        p_local = p_local.cpu().numpy() if compute_cell_pvalues else None
    pair_col = {p: i for i, p in enumerate(ok_pairs)}
    cols = {}            # new obs columns, joined to obs once (not 3 per pair)
    for gx, gy in pairs:
        key = f"{gx}_{gy}"
        if (gx, gy) not in pair_col:
            logger.warning(f"Pair ({gx}, {gy}): zero-variance gene — writing "
                           "zeros")
            cols[f"{key}_lees_l"] = np.zeros(n_cells, np.float32)
            cols[f"{key}_quadrant"] = pd.Categorical(
                ["NS"] * n_cells, categories=LEE_QUADRANTS)
            adata.uns[f"{key}_lees_l_params"] = {
                "gene_x": gx, "gene_y": gy, "global_L": 0.0,
                "global_pvalue": 1.0, "n_neighbors": n_neighbors,
                "n_permutations": n_permutations, "zero_variance": True,
            }
            continue
        i = pair_col[(gx, gy)]
        cols[f"{key}_lees_l"] = L_local[:, i].astype(np.float32)
        cols[f"{key}_quadrant"] = pd.Categorical.from_codes(
            quads[:, i], categories=LEE_QUADRANTS)
        if compute_cell_pvalues:
            cols[f"{key}_pvalue"] = p_local[:, i].astype(np.float32)
        bc = np.bincount(quads[:, i], minlength=len(LEE_QUADRANTS))
        adata.uns[f"{key}_lees_l_params"] = {
            "gene_x": gx, "gene_y": gy,
            "global_L": float(L_global[i]),
            "global_pvalue": float(p_global[i]),
            "n_neighbors": n_neighbors, "n_permutations": n_permutations,
            "compute_cell_pvalues": compute_cell_pvalues,
            "significance_filter": significance_filter, "alpha": alpha,
            "quadrant_counts": {c: int(bc[j])
                                for j, c in enumerate(LEE_QUADRANTS)},
        }
    if cols:
        new = pd.DataFrame(cols, index=adata.obs.index)
        adata.obs = pd.concat([adata.obs.drop(columns=[
            c for c in new.columns if c in adata.obs.columns]), new], axis=1)
    elapsed = time.time() - start
    logger.info(f"Local Lee's L completed in {elapsed:.1f}s for {len(pairs)} "
                "pair(s)")
    update_metadata(
        adata, "lees_l_local",
        parameters={"gene_pairs": [list(p) for p in pairs[:10]],
                    "n_pairs": len(pairs), "n_neighbors": n_neighbors,
                    "n_permutations": n_permutations,
                    "compute_cell_pvalues": compute_cell_pvalues,
                    "significance_filter": significance_filter,
                    "alpha": alpha, "seed": seed,
                    "backend": "spatialcore_tpu_torch", "device": str(device)},
        outputs={"obs_keys": [f"{gx}_{gy}_lees_l" for gx, gy in pairs[:5]],
                 "uns_keys": [f"{gx}_{gy}_lees_l_params"
                              for gx, gy in pairs[:5]]})
    return adata


# ---------------------------------------------------------------------------
# Join counts and the multivariate local Geary
# ---------------------------------------------------------------------------


def _binarize_obs_column(adata, column: str, category=None) -> np.ndarray:
    """The 0/1 encoding shared by the global and local join counts: a bool
    column, {True, False} values, numeric > 0, or ``category=`` naming the
    positive label."""
    if column not in adata.obs.columns:
        raise ValueError(f"adata.obs['{column}'] not found")
    series = adata.obs[column]
    if category is not None:
        return (series.astype(str) == str(category)).to_numpy()
    uniq = set(series.dropna().unique())
    if series.dtype == bool or uniq.issubset({True, False}):
        return series.fillna(False).astype(bool).to_numpy()
    try:
        return (series.astype(float) > 0).to_numpy()
    except (ValueError, TypeError):
        raise ValueError(
            f"Column '{column}' is not boolean or numeric; pass "
            "category=<label> to binarize.") from None


def join_count_statistics(
    adata,
    column: str,
    category=None,
    spatial_key: str = "spatial",
    n_neighbors: int = 6,
    n_permutations: int = 999,
    seed: int = 0,
    key_added: str = "join_counts",
    use_existing_graph: bool = False,
    copy: bool = False,
    device: Device = "cuda",
):
    """Join-count autocorrelation of a binary label (BB / WW / BW joins).

    ``column`` must be boolean or numeric (> 0 is positive), or
    categorical with ``category`` naming the positive class. Clustering of
    the class shows as a small ``p_BB``. The label permutations run on
    ``device`` (``ops.moran.join_counts``). Results land in
    ``uns[key_added]``.
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    x = _binarize_obs_column(adata, column, category)
    frac = float(x.mean())
    if frac in (0.0, 1.0):
        raise ValueError(
            f"Column '{column}' is constant ({frac:.0%} positive); join "
            "counts need both classes present.")
    graph = _get_graph(adata, n_neighbors, spatial_key, use_existing_graph,
                       device)
    res = join_counts(graph, torch.as_tensor(x.astype(np.float32)), seed=seed,
                      n_permutations=n_permutations)
    out = {k: float(v) for k, v in res.items()}
    out.update({"n_positive": int(x.sum()), "fraction_positive": frac,
                "n_permutations": n_permutations, "seed": seed,
                "computation_time_seconds": round(time.time() - start, 2)})
    adata.uns[key_added] = out
    logger.info(f"join counts: BB={out['BB']:.0f} (p={out['p_BB']:.4f}), "
                f"BW={out['BW']:.0f} (p={out['p_BW']:.4f})")
    update_metadata(adata, "join_count_statistics",
                    parameters={"column": column, "category": category,
                                "n_permutations": n_permutations, "seed": seed,
                                "backend": "spatialcore_tpu_torch",
                                "device": str(device)},
                    outputs={"uns": key_added})
    return adata


def local_join_counts(
    adata,
    column: str,
    category=None,
    spatial_key: str = "spatial",
    n_neighbors: int = 6,
    n_permutations: int = 999,
    seed: int = 0,
    key_added: Optional[str] = None,
    use_existing_graph: bool = False,
    copy: bool = False,
    device: Device = "cuda",
):
    """Local join counts of a binary obs column (Anselin & Li 2019).

    BB_i counts the 1-1 neighbour joins at each positive cell; the
    conditional-permutation p (``ops.moran.local_join_counts``, on
    ``device``) flags significant local clustering. ``column`` follows the
    contract of :func:`join_count_statistics`. Writes
    ``obs[f"{key}_BB"]`` and ``obs[f"{key}_p"]`` (p = 1 where the cell is
    0), ``key`` defaulting to ``f"{column}_local_jc"``.
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    x = _binarize_obs_column(adata, column, category).astype(np.float32)
    if x.sum() == 0 or x.sum() == len(x):
        raise ValueError(
            f"obs['{column}'] must contain both 0/False and 1/True values")
    graph = _get_graph(adata, n_neighbors, spatial_key, use_existing_graph,
                       device)
    bb, p = _local_join_counts(graph, torch.as_tensor(x), seed=seed,
                               n_permutations=n_permutations)
    key = key_added or f"{column}_local_jc"
    adata.obs[f"{key}_BB"] = bb.cpu().numpy()
    adata.obs[f"{key}_p"] = p.cpu().numpy()
    update_metadata(adata, "local_join_counts", parameters={
        "column": column, "category": category, "n_neighbors": n_neighbors,
        "n_permutations": n_permutations, "seed": seed,
        "computation_time_seconds": round(time.time() - start, 2),
        "backend": "spatialcore_tpu_torch", "device": str(device)})
    logger.info(f"Local join counts for '{column}' "
                f"({int(x.sum()):,} positive cells)")
    return adata


def local_gearys_c_multivariate(
    adata,
    genes: Optional[Union[str, List[str]]] = None,
    layer: Optional[str] = None,
    spatial_key: str = "spatial",
    n_neighbors: int = 6,
    n_permutations: int = 999,
    seed: int = 0,
    key_added: str = "local_geary_mv",
    use_existing_graph: bool = False,
    copy: bool = False,
    device: Device = "cuda",
):
    """Multivariate local Geary (Anselin 2019): one coherence statistic per
    cell over a gene set; small c with small p marks cells whose whole
    profile resembles their neighbourhood's.

    Writes ``obs[key_added]`` (c_i) and ``obs[f"{key_added}_p"]``
    (one-sided conditional-permutation p, ``ops.moran.
    local_geary_multivariate`` on ``device``) and
    ``uns[f"{key_added}_params"]``.
    """
    start = time.time()
    if copy:
        adata = adata.copy()
    gene_names = _resolve_genes(adata, genes)
    Z, _ = standardize(_dense_expression(adata, gene_names, layer, device))
    graph = _get_graph(adata, n_neighbors, spatial_key, use_existing_graph,
                       device)
    c, p = local_geary_multivariate(graph, Z, seed=seed,
                                    n_permutations=n_permutations)
    del Z
    adata.obs[key_added] = c.cpu().numpy()
    adata.obs[f"{key_added}_p"] = p.cpu().numpy()
    adata.uns[f"{key_added}_params"] = {
        "genes": gene_names, "n_neighbors": n_neighbors,
        "n_permutations": n_permutations, "seed": seed,
        "computation_time_seconds": round(time.time() - start, 2)}
    update_metadata(adata, "local_gearys_c_multivariate", parameters={
        "n_genes": len(gene_names), "n_neighbors": n_neighbors,
        "n_permutations": n_permutations, "seed": seed,
        "backend": "spatialcore_tpu_torch", "device": str(device)})
    logger.info(f"Multivariate local Geary over {len(gene_names)} genes")
    return adata


# ---------------------------------------------------------------------------
# Moran correlogram (distance-band profile)
# ---------------------------------------------------------------------------


def moran_correlogram(
    adata,
    genes: Optional[Union[str, List[str]]] = None,
    layer: Optional[str] = None,
    spatial_key: str = "spatial",
    bands: Optional[Sequence[float]] = None,
    n_bands: int = 5,
    k_max: int = 128,
    n_permutations: int = 0,
    seed: int = 0,
    key_added: str = "moran_correlogram",
    copy: bool = False,
    device: Device = "cuda",
):
    """Global Moran's I per distance band: the spatial correlogram.

    For each band [lo, hi) a binary row-normalized weights matrix links
    cells to the neighbours at that distance, all built from one capped
    radius search at max(bands) (``ops.graph.radius_neighbors``, ``k_max``
    slots a cell, raising on overflow); I(d) shows how far spatial
    autocorrelation reaches. ``bands``: the band edges (length B+1);
    default ``n_bands`` equal-width bands up to 3× the mean 6-NN distance.
    Every band's statistic, Cliff-Ord moments and permutation draws come
    from one pass (``ops.moran.correlogram_kernel`` on ``device``); the
    permutations (optional) share one shuffle a draw across the bands.

    Output: ``uns[key_added]`` DataFrame (band_lo, band_hi, gene, I,
    z_score, p_value[, p_sim]); a band with no pairs is skipped with a
    warning, and zero-variance genes get I = z = 0, p = 1. Parameters in
    ``uns[f"{key_added}_params"]``.
    """
    from ..ops.graph import radius_neighbors
    from ..ops.moran import correlogram_kernel

    start = time.time()
    if copy:
        adata = adata.copy()
    if spatial_key not in adata.obsm:
        raise ValueError(
            f"adata.obsm['{spatial_key}'] not found. Spatial coordinates "
            "are required.")
    coords = torch.as_tensor(adata.obsm[spatial_key])[:, :2].to(
        device=device, dtype=torch.float32)
    n = coords.shape[0]
    gene_names = _resolve_genes(adata, genes)

    if bands is None:
        g6 = build_graph(coords, n_neighbors=6, device=device)
        d6 = torch.where(g6.valid, g6.distances, 0.0).cpu().numpy()
        mean_nn = float(d6.sum() / max(float(g6.valid.sum()), 1.0))
        bands = np.linspace(0.0, 3.0 * mean_nn, n_bands + 1)
    bands = np.asarray(bands, np.float64)
    if bands.ndim != 1 or len(bands) < 2 or np.any(np.diff(bands) <= 0):
        raise ValueError("bands must be increasing edges of length >= 2")

    logger.info(f"Moran correlogram: {n:,} cells × {len(gene_names)} genes, "
                f"{len(bands) - 1} bands up to {bands[-1]:.1f}")
    idx, dist, valid = radius_neighbors(coords, float(bands[-1]), k_max)
    Z, zero_var = standardize(_dense_expression(adata, gene_names, layer,
                                                device))
    outs = correlogram_kernel(
        idx, dist, valid, Z, torch.as_tensor(bands.astype(np.float32),
                                             device=coords.device),
        seed, n_permutations=n_permutations)
    del Z, idx, dist, valid
    I_np, z_np, p_np, ps_np, S0_np = (t.cpu().numpy() for t in outs)
    zv_np = zero_var.cpu().numpy()

    rows = []
    for b in range(len(bands) - 1):
        lo, hi = float(bands[b]), float(bands[b + 1])
        if S0_np[b] <= 0:
            logger.warning(f"band [{lo:.1f}, {hi:.1f}) has no pairs; skipped")
            continue
        for gi, gname in enumerate(gene_names):
            row = {"band_lo": lo, "band_hi": hi, "gene": gname,
                   "I": float(I_np[b, gi]), "z_score": float(z_np[b, gi]),
                   "p_value": float(p_np[b, gi])}
            if n_permutations > 0:
                row["p_sim"] = float(ps_np[b, gi])
            if bool(zv_np[gi]):
                row.update(I=0.0, z_score=0.0, p_value=1.0)
            rows.append(row)

    adata.uns[key_added] = pd.DataFrame(rows)
    elapsed = time.time() - start
    adata.uns[f"{key_added}_params"] = {
        "genes": gene_names, "bands": [float(x) for x in bands],
        "k_max": k_max, "n_permutations": n_permutations, "seed": seed,
        "computation_time_seconds": elapsed,
    }
    update_metadata(
        adata, "moran_correlogram",
        parameters={"n_genes": len(gene_names), "n_bands": len(bands) - 1,
                    "k_max": k_max, "n_permutations": n_permutations,
                    "seed": seed, "backend": "spatialcore_tpu_torch",
                    "device": str(device)},
        outputs={"uns": key_added, "uns_params": f"{key_added}_params"})
    logger.info(f"Moran correlogram completed in {elapsed:.1f}s")
    return adata
