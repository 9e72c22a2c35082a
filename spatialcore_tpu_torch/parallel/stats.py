"""Sharded spatial statistics: the multi-device entry points.

Port of ``spatialcore_tpu/parallel/stats.py``. Every rank of the mesh
calls a function with the same whole inputs, as a JAX program does. Each
rank takes its block by its mesh coordinate and runs the single-device
function of ``ops`` on it; the results come back as DTensors laid out as
the reference's shardings say, and ``.full_tensor()`` gives the whole
result.

Gene-sharded forms: the rank's genes are block ``genes`` of the gene axis
(``torch.chunk``'s split, as ``Shard`` lays it out), the graph and plan
stay whole, and ranks that differ only in their ``cells`` coordinate do
the same work. Draws are keyed by (seed, draw) only, so a shard's draws
are those of the single run and every count is bitwise that run's; no
collective is issued at all.

Cells × genes forms (``*_2d``): a rank holds only its [N/cs, G/gs] tiles
of the outputs. It takes its [N, G/gs] gene slab once per call (from a
DTensor input: one gather across ``cells``) and computes its own rows
through the row-range form (``rows=``) of the single-device function, in
which each draw still permutes all N cells.

Each function's per-rank work is a private function of (coordinate, mesh
shape, inputs) with no collective inside, so :func:`_pretend` and
:func:`_pretend_2d` can run every rank of a mesh in turn on one device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.getis import GetisOrdResult, getis_ord
from ..ops.graph import SpatialGraph
from ..ops.lee import LeesLResult, lees_global_p, lees_l_pairs
from ..ops.moran import (geary_observed, local_geary, local_moran,
                         moran_observed, permutation_test_global, standardize)
from .mesh import AXES

Coord = Tuple[int, int]


def span(n: int, parts: int, i: int) -> Tuple[int, int]:
    """Block i of ``parts`` of a length-n axis, as ``Shard`` splits it:
    blocks of ceil(n / parts), the last ones short or empty."""
    b = -(-n // parts)
    return min(i * b, n), min((i + 1) * b, n)


def _where(mesh) -> Tuple[Coord, Coord]:
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if names != AXES:
        raise ValueError(f"the mesh's axes must be {AXES}, got {names} "
                         "(make the mesh with parallel.auto_mesh)")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return (coord[0], coord[1]), (mesh.size(0), mesh.size(1))


def _cols(t, coord: Coord, shape: Coord):
    """The rank's gene block of ``t``'s last axis (None stays None)."""
    if t is None:
        return None
    g0, g1 = span(t.shape[-1], shape[1], coord[1])
    return t[..., g0:g1]


def all_gather(out: torch.Tensor, t: torch.Tensor, group) -> None:
    """``out`` [size·d0, ...] ← every rank's ``t`` [d0, ...] of ``group``."""
    import torch.distributed as dist

    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, t.contiguous(), group=group)


def _check_genes(G: int, shape: Coord) -> None:
    if G < shape[1]:
        raise ValueError(f"{G} genes cannot fill {shape[1]} gene shards")


def _dtensor(t, mesh, G: int, N: Optional[int]):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if N is not None and t.ndim == 2:
        place, shape = (Shard(0), Shard(1)), (N, G)
    else:
        place, shape = (Replicate(), Shard(t.ndim - 1)), tuple(t.shape[:-1]) + (G,)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(t.contiguous(), mesh, place, run_check=False,
                              shape=shape, stride=tuple(stride))


def _wrap(out, mesh, G: int, N: Optional[int] = None):
    """``out`` (a tensor, or a tuple / NamedTuple of them) as DTensors:
    [..., G] tensors gene-sharded; with ``N``, [N, G] ones tiled over
    (cells, genes)."""
    if isinstance(out, torch.Tensor):
        return _dtensor(out, mesh, G, N)
    parts = [_wrap(t, mesh, G, N) for t in out]
    return type(out)(*parts) if hasattr(out, "_fields") else type(out)(parts)


def _cat(parts, dim: int):
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts, dim=dim)
    cols = [_cat([p[i] for p in parts], dim) for i in range(len(first))]
    return type(first)(*cols) if hasattr(first, "_fields") else type(first)(cols)


def _pretend(rank_fn, shape: Coord, *args, **kw):
    """Every gene shard of a ``shape`` mesh in turn on this process,
    assembled along the gene axis: what ``.full_tensor()`` gives for a
    gene-sharded function (its cell coordinate changes nothing)."""
    return _cat([rank_fn((0, g), shape, *args, **kw)
                 for g in range(shape[1])], -1)


def _pretend_2d(rank_fn, shape: Coord, graph, Z, *args, **kw):
    """Every rank of a cells × genes mesh in turn on this process, each on
    its gene slab of ``Z``, the tiles assembled as ``.full_tensor()``
    does."""
    cols = []
    for g in range(shape[1]):
        slab = _cols(Z, (0, g), shape)
        cols.append(_cat([rank_fn((c, g), shape, graph, slab, *args, **kw)
                          for c in range(shape[0])], 0))
    return _cat(cols, 1)


# ---------------------------------------------------------------------------
# Gene-sharded: the slot nulls and the direct statistics
# ---------------------------------------------------------------------------


def _r_moran(coord, shape, graph, X, S0):
    Z, _ = standardize(_cols(X, coord, shape))
    return moran_observed(graph, Z, S0)


def sharded_moran(graph: SpatialGraph, X: torch.Tensor, S0: float, mesh
                  ) -> torch.Tensor:
    """Global Moran's I per gene [G], gene-sharded over the mesh; bitwise
    the single-device ``standardize`` + ``moran_observed`` (both sum each
    gene over the cells in one fixed order, whatever the width)."""
    coord, shape = _where(mesh)
    _check_genes(X.shape[1], shape)
    return _wrap(_r_moran(coord, shape, graph, X, S0), mesh, X.shape[1])


def _r_permutation_test(coord, shape, graph, X, S0, seed, n_permutations,
                        stat, alternative):
    Z, _ = standardize(_cols(X, coord, shape))
    obs = (geary_observed if stat == "geary" else moran_observed)(graph, Z, S0)
    return permutation_test_global(graph, Z, S0, obs, seed=seed,
                                   n_permutations=n_permutations, stat=stat,
                                   alternative=alternative)


def sharded_permutation_test(graph: SpatialGraph, X: torch.Tensor, S0: float,
                             seed: int, n_permutations: int, mesh,
                             stat: str = "moran",
                             alternative: str = "greater"):
    """(p, null_mean, null_std) per gene [G] of the slot null, gene-sharded.

    Bitwise the single-device ``permutation_test_global`` on the
    standardized X: the shuffle of draw d is keyed by (seed, d) only, so
    every shard applies it to its own columns. The observed value is that
    of ``stat`` (the reference passes Moran's I for either)."""
    coord, shape = _where(mesh)
    _check_genes(X.shape[1], shape)
    return _wrap(_r_permutation_test(coord, shape, graph, X, S0, seed,
                                     n_permutations, stat, alternative),
                 mesh, X.shape[1])


def _r_local_moran(coord, shape, graph, X, seed, n_permutations):
    Z, _ = standardize(_cols(X, coord, shape))
    return local_moran(graph, Z, seed=seed, n_permutations=n_permutations)


def sharded_local_moran(graph: SpatialGraph, X: torch.Tensor, seed: int,
                        n_permutations: int, mesh):
    """LISA with permutation p-values on standardized X, gene-sharded; the
    four [N, G] outputs keep the gene axis sharded."""
    coord, shape = _where(mesh)
    _check_genes(X.shape[1], shape)
    return _wrap(_r_local_moran(coord, shape, graph, X, seed, n_permutations),
                 mesh, X.shape[1])


def _r_lees_l(coord, shape, graph, Zx, Zy, seed, n_permutations,
              compute_cell_pvalues):
    return lees_l_pairs(graph, _cols(Zx, coord, shape), _cols(Zy, coord, shape),
                        seed=seed, n_permutations=n_permutations,
                        compute_cell_pvalues=compute_cell_pvalues)


def sharded_lees_l(graph: SpatialGraph, Zx: torch.Tensor, Zy: torch.Tensor,
                   seed: int, n_permutations: int, mesh,
                   compute_cell_pvalues: bool = False) -> LeesLResult:
    """Lee's L for many gene pairs, the pair axis (``Zx`` / ``Zy`` [N, P]
    standardized columns) sharded over ``genes``."""
    coord, shape = _where(mesh)
    _check_genes(Zx.shape[1], shape)
    return _wrap(_r_lees_l(coord, shape, graph, Zx, Zy, seed, n_permutations,
                           compute_cell_pvalues), mesh, Zx.shape[1])


def _r_getis_ord(coord, shape, graph, X, star, alternative, seed,
                 n_permutations):
    return getis_ord(graph, _cols(X, coord, shape), star=star,
                     alternative=alternative, seed=seed,
                     n_permutations=n_permutations)


def sharded_getis_ord(graph: SpatialGraph, X: torch.Tensor, mesh,
                      star: bool = True, alternative: str = "two-sided",
                      seed: int = 0, n_permutations: int = 0) -> GetisOrdResult:
    """Getis-Ord Gi*/Gi on raw X, gene-sharded: every part acts per gene,
    so p_sim is bitwise the single-device run's; G / z agree to float32
    rounding (the float64 column sums round to the same float32 but at an
    exact tie, and exactly on integer counts)."""
    X = torch.as_tensor(X)
    coord, shape = _where(mesh)
    _check_genes(X.shape[-1], shape)
    return _wrap(_r_getis_ord(coord, shape, graph, X, star, alternative, seed,
                              n_permutations), mesh, X.shape[-1])


# ---------------------------------------------------------------------------
# Gene-sharded: the banded nulls
# ---------------------------------------------------------------------------


def _r_banded_permutation_test(coord, shape, plan, Z, S0, observed, seed,
                               n_permutations, den, stat, alternative,
                               band_impl, precision, sz, draw_offset):
    from ..ops.banded import banded_permutation_test

    return banded_permutation_test(
        plan, _cols(Z, coord, shape), S0, _cols(observed, coord, shape),
        seed=seed, n_permutations=n_permutations, stat=stat,
        alternative=alternative, band_impl=band_impl,
        den=_cols(den, coord, shape), precision=precision,
        sz=_cols(sz, coord, shape), draw_offset=draw_offset,
        launch_genes=Z.shape[1])


def sharded_banded_permutation_test(
    plan, Z: torch.Tensor, S0: float, observed: torch.Tensor, seed: int,
    n_permutations: int, mesh, den: Optional[torch.Tensor] = None,
    stat: str = "moran", alternative: str = "greater",
    band_impl: str = "auto", precision: str = "bf16",
    sz: Optional[torch.Tensor] = None, draw_offset: int = 0,
):
    """Banded permutation null (``ops.banded``), gene-sharded over the mesh.

    The NullPlan (a function of the graph only) stays whole on every rank;
    ``Z`` [N, G], ``observed`` ([G], or [2, G] for ``stat="moran_geary"``),
    ``den`` and ``sz`` are cut on the gene axis. Every step of a draw —
    the Feistel permutation, the row gather, the band cross (the card's
    kernel for each rank's columns), the far edges, the per-gene
    reductions — acts per gene, so the ranks never communicate. Each rank
    launches at the whole table's launch shape (``launch_genes``), and
    every sum over cells runs in one order whatever the width, so its
    genes' Moran values, moments and counts are bitwise the single-device
    run's (Geary's Σz² term is a float product whose order depends on the
    width: its values agree to float32 rounding). ``Z`` is a float table (a pre-packed int4 table's columns
    are not genes).
    """
    if precision == "int4" and Z.dtype == torch.int8:
        raise ValueError("shard a float Z; pre-packed int4 columns are "
                         "not genes")
    observed = torch.as_tensor(observed, device=Z.device)
    coord, shape = _where(mesh)
    _check_genes(Z.shape[1], shape)
    return _wrap(_r_banded_permutation_test(
        coord, shape, plan, Z, S0, observed, seed, n_permutations, den, stat,
        alternative, band_impl, precision, sz, draw_offset), mesh, Z.shape[1])


def _r_banded_local_moran(coord, shape, plan, graph, Z, seed, n_permutations,
                          precision, perm_method):
    from ..ops.banded import banded_local_moran

    return banded_local_moran(plan, graph, _cols(Z, coord, shape), seed=seed,
                              n_permutations=n_permutations,
                              precision=precision, perm_method=perm_method)


def sharded_banded_local_moran(plan, graph: SpatialGraph, Z: torch.Tensor,
                               seed: int, n_permutations: int, mesh,
                               precision: str = "int8",
                               perm_method: str = "feistel"):
    """Banded LISA nulls (default the integer int8 null), gene-sharded: the
    plan and graph whole, ``Z`` and the four [N, G] outputs on the gene
    axis. Each rank runs its columns through the default route — the
    card's local draw-step kernel (K7) for int8 — where the reference
    forces its XLA body because a ``pallas_call`` does not partition; the
    counts are bitwise the single-device run's either way."""
    coord, shape = _where(mesh)
    _check_genes(Z.shape[1], shape)
    return _wrap(_r_banded_local_moran(coord, shape, plan, graph, Z, seed,
                                       n_permutations, precision, perm_method),
                 mesh, Z.shape[1])


def _r_banded_local_geary(coord, shape, plan, Z, seed, n_permutations,
                          precision):
    from ..ops.banded import banded_local_geary

    return banded_local_geary(plan, _cols(Z, coord, shape), seed,
                              n_permutations, precision=precision)


def sharded_banded_local_geary(plan, graph: SpatialGraph, Z: torch.Tensor,
                               seed: int, n_permutations: int, mesh,
                               precision: str = "f32"):
    """Banded local-Geary total nulls ``(c_obs_operator, p)`` [N, G],
    gene-sharded as :func:`sharded_banded_local_moran`."""
    del graph
    coord, shape = _where(mesh)
    _check_genes(Z.shape[1], shape)
    return _wrap(_r_banded_local_geary(coord, shape, plan, Z, seed,
                                       n_permutations, precision),
                 mesh, Z.shape[1])


def _r_banded_getis(coord, shape, plan, X, seed, n_permutations, star,
                    alternative, precision):
    from ..ops.banded import banded_getis

    return banded_getis(plan, _cols(X, coord, shape), seed, n_permutations,
                        star=star, alternative=alternative,
                        precision=precision)


def sharded_banded_getis(plan, graph: SpatialGraph, X: torch.Tensor,
                         seed: int, n_permutations: int, mesh,
                         star: bool = True, alternative: str = "two-sided",
                         precision: str = "f32"):
    """Banded Getis-Ord p_sim [N, G], gene-sharded: the column statistics,
    gather, band cross and counters all act per gene."""
    del graph
    coord, shape = _where(mesh)
    _check_genes(X.shape[1], shape)
    return _wrap(_r_banded_getis(coord, shape, plan, X, seed, n_permutations,
                                 star, alternative, precision),
                 mesh, X.shape[1])


def _r_banded_lees_l(coord, shape, plan, Zx, Zy, seed, n_permutations,
                     precision, compute_cell_pvalues):
    from ..ops.banded import banded_lees_l

    return banded_lees_l(plan, _cols(Zx, coord, shape), _cols(Zy, coord, shape),
                         seed, n_permutations, precision=precision,
                         compute_cell_pvalues=compute_cell_pvalues)


def sharded_banded_lees_l(plan, graph: SpatialGraph, Zx: torch.Tensor,
                          Zy: torch.Tensor, seed: int, n_permutations: int,
                          mesh, precision: str = "bf16",
                          compute_cell_pvalues: bool = False):
    """Banded Lee's L nulls ``(p_global [P], p_local [N, P])`` with the
    pair axis sharded over ``genes``."""
    del graph
    coord, shape = _where(mesh)
    _check_genes(Zx.shape[1], shape)
    return _wrap(_r_banded_lees_l(coord, shape, plan, Zx, Zy, seed,
                                  n_permutations, precision,
                                  compute_cell_pvalues), mesh, Zx.shape[1])


# ---------------------------------------------------------------------------
# Cells × genes
# ---------------------------------------------------------------------------


def _slab(Z, mesh, coord: Coord, shape: Coord) -> torch.Tensor:
    """The rank's [N, G/gs] gene slab: a DTensor is redistributed to
    (Replicate, Shard(1)) — one gather across ``cells`` — and a whole
    tensor is cut."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if isinstance(Z, DTensor):
        return Z.redistribute(mesh, (Replicate(), Shard(1))).to_local()
    return _cols(torch.as_tensor(Z), coord, shape)


def _rows(graph: SpatialGraph, coord: Coord, shape: Coord) -> Tuple[int, int]:
    return span(graph.neighbor_idx.shape[0], shape[0], coord[0])


def _r_local_moran_2d(coord, shape, graph, Z, seed, n_permutations):
    return local_moran(graph, Z, seed=seed, n_permutations=n_permutations,
                       rows=_rows(graph, coord, shape))


def sharded_local_moran_2d(graph: SpatialGraph, Z, seed: int,
                           n_permutations: int, mesh):
    """LISA with both axes sharded: each rank holds only its
    [N/cs, G/gs] tiles of the four [N, G] outputs (for fields larger than
    one device: 1M × 5k float32 planes are 20 GB each).

    ``Z`` [N, G] is pre-standardized, whole or a DTensor. The rank gathers
    its [N, G/gs] gene slab across ``cells`` once per call (the transient
    the gene axis bounds) and computes its own rows; gathers, per-row slot
    sums and comparisons are order-free, so the tiles are bitwise the
    single-device outputs."""
    coord, shape = _where(mesh)
    G = Z.shape[1]
    _check_genes(G, shape)
    out = _r_local_moran_2d(coord, shape, graph, _slab(Z, mesh, coord, shape),
                            seed, n_permutations)
    return _wrap(out, mesh, G, Z.shape[0])


def _r_local_geary_2d(coord, shape, graph, Z, seed, n_permutations, null):
    return local_geary(graph, Z, seed=seed, n_permutations=n_permutations,
                       null=null, rows=_rows(graph, coord, shape))


def sharded_local_geary_2d(graph: SpatialGraph, Z, seed: int,
                           n_permutations: int, mesh,
                           null: str = "conditional"):
    """Local Geary's C with both axes sharded, laid out as
    :func:`sharded_local_moran_2d`; bitwise the single-device outputs."""
    coord, shape = _where(mesh)
    G = Z.shape[1]
    _check_genes(G, shape)
    out = _r_local_geary_2d(coord, shape, graph, _slab(Z, mesh, coord, shape),
                            seed, n_permutations, null)
    return _wrap(out, mesh, G, Z.shape[0])


def _r_lees_l_2d(coord, shape, graph, Zx, Zy, seed, n_permutations,
                 compute_cell_pvalues):
    return lees_l_pairs(graph, Zx, Zy, seed=seed,
                        n_permutations=n_permutations,
                        compute_cell_pvalues=compute_cell_pvalues,
                        rows=_rows(graph, coord, shape))


def sharded_lees_l_2d(graph: SpatialGraph, Zx, Zy, seed: int,
                      n_permutations: int, mesh,
                      compute_cell_pvalues: bool = False) -> LeesLResult:
    """Lee's L with cells × pairs sharded over the whole mesh.

    The per-cell L, lag and cell p-values are (cells, genes) tiles,
    bitwise the single-device outputs. The global L and each draw's
    global sum are the rank's float32 parts, added across ``cells`` in one
    all-reduce after the draw loop (no collective per draw); they agree
    with the single-device sums to float32 reduction tolerance."""
    import torch.distributed as dist

    coord, shape = _where(mesh)
    N, P = Zx.shape
    _check_genes(P, shape)
    r = _r_lees_l_2d(coord, shape, graph, _slab(Zx, mesh, coord, shape),
                     _slab(Zy, mesh, coord, shape), seed, n_permutations,
                     compute_cell_pvalues)
    sums = torch.cat([r.L_part[None], r.draw_part])
    if shape[0] > 1:
        dist.all_reduce(sums, group=mesh.get_group("cells"))
    L_global = sums[0]
    p_global = (lees_global_p(L_global, sums[1:]) if n_permutations
                else torch.ones_like(L_global))
    out = LeesLResult(r.L_local, L_global, r.lag_zy, p_global, r.p_local)
    return _wrap(out, mesh, P, N)


def _r_getis_ord_2d(coord, shape, graph, X, star, alternative, seed,
                    n_permutations):
    return getis_ord(graph, X, star=star, alternative=alternative, seed=seed,
                     n_permutations=n_permutations,
                     rows=_rows(graph, coord, shape))


def sharded_getis_ord_2d(graph: SpatialGraph, X, mesh, star: bool = True,
                         alternative: str = "two-sided", seed: int = 0,
                         n_permutations: int = 0) -> GetisOrdResult:
    """Getis-Ord Gi*/Gi with cells × genes sharded over the whole mesh.

    The column moments come from the rank's gathered [N, G/gs] slab, all
    N rows, so no cross-shard reduction is needed: G / z are those of the
    gene-sharded form (float32 rounding of float64 sums; bitwise on
    integer counts) and p_sim is bitwise the single-device run's."""
    coord, shape = _where(mesh)
    N, G = X.shape
    _check_genes(G, shape)
    out = _r_getis_ord_2d(coord, shape, graph, _slab(X, mesh, coord, shape),
                          star, alternative, seed, n_permutations)
    return _wrap(out, mesh, G, N)

