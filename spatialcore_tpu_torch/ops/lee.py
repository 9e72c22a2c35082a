"""Lee's L bivariate spatial association: observed values and the direct
permutation null.

Port of ``spatialcore_tpu/ops/lee.py``. Estimator conventions:

    lag   = W @ z_y            (z population-standardized)
    L_i   = z_{x,i} · lag_i
    L     = Σ_i L_i            (the un-normalized global sum)
    p     : shuffle z_y only; two-tailed (#{|L_perm| ≥ |L|} + 1)/(P + 1)

Draw p shuffles the cells by ``jax.random.permutation`` of the key
``fold_in(key_for(seed, "perm_lee", 0), p)``, reproduced bitwise by
``core.rng.permutation``, so the draws are the reference's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.rng import fold_in, key_for, permutation
from ..utils.profiling import traced
from .banded import _p_from_counts
from .graph import SpatialGraph, graph_rows, spatial_lag


class LeesLResult(NamedTuple):
    L_local: torch.Tensor    # [N, P] local values
    L_global: torch.Tensor   # [P]
    lag_zy: torch.Tensor     # [N, P]
    p_global: torch.Tensor   # [P]
    p_local: torch.Tensor    # [N, P], ones unless requested


class LeesLRows(NamedTuple):
    """:func:`lees_l_pairs` over a row range: the rows' per-cell outputs
    and their parts of the global sums, which add over the row blocks."""
    L_local: torch.Tensor    # [rows, P]
    lag_zy: torch.Tensor     # [rows, P]
    p_local: torch.Tensor    # [rows, P], ones unless requested
    L_part: torch.Tensor     # [P]  Σ over the rows of L_local
    draw_part: torch.Tensor  # [n_permutations, P]  the same for each draw


def lees_global_p(L_global: torch.Tensor, draw_sums: torch.Tensor
                  ) -> torch.Tensor:
    """Two-tailed global p from the observed L and each draw's [P] sum."""
    count = (draw_sums.abs() >= L_global.abs()).sum(dim=0, dtype=torch.int32)
    return _p_from_counts(count, draw_sums.shape[0])


@traced("ops.lee.lees_l_pairs")
def lees_l_pairs(graph: SpatialGraph, Zx: torch.Tensor, Zy: torch.Tensor,
                 seed: int, n_permutations: int = 0,
                 compute_cell_pvalues: bool = False,
                 chunk: int = 16, rows: Optional[Tuple[int, int]] = None):
    """Lee's L for P gene pairs at once (columns of ``Zx`` and ``Zy``).

    Each draw permutes the rows of ``Zy`` on its device, takes one
    ``spatial_lag`` and compares |L| globally and, with
    ``compute_cell_pvalues``, per cell. ``chunk`` is accepted for API
    compatibility and ignored, as in the reference.

    ``rows=(r0, r1)`` returns a :class:`LeesLRows` for cells [r0, r1):
    their per-cell outputs, bitwise those rows of the whole call, and
    their float32 parts of the observed and of each draw's global sum;
    the caller adds the parts of all row blocks and counts with
    :func:`lees_global_p`. Each draw still permutes all N cells.
    """
    del chunk
    n = Zx.shape[0]
    r0, r1 = (0, n) if rows is None else rows
    graph = graph_rows(graph, rows)
    Zxr = Zx[r0:r1]
    lag = spatial_lag(graph, Zy)
    L_local = Zxr * lag
    L_global = L_local.sum(dim=0)
    P = n_permutations
    if rows is not None:
        draws = torch.zeros((P, L_global.shape[0]), dtype=L_global.dtype,
                            device=Zx.device)
    if P == 0 and rows is None:
        return LeesLResult(L_local, L_global, lag, torch.ones_like(L_global),
                           torch.ones_like(L_local))
    abs_g, abs_l = L_global.abs(), L_local.abs()
    base = key_for(seed, "perm_lee", 0)
    count_g = torch.zeros(L_global.shape, dtype=torch.int32, device=Zx.device)
    count_l = (torch.zeros(L_local.shape, dtype=torch.int32, device=Zx.device)
               if compute_cell_pvalues else None)
    for p in range(P):
        perm = permutation(fold_in(base, p), n, device=Zx.device)
        Lp_local = Zxr * spatial_lag(graph, Zy, perm)
        if rows is None:
            count_g += (Lp_local.sum(dim=0).abs() >= abs_g).to(torch.int32)
        else:
            draws[p] = Lp_local.sum(dim=0)
        if compute_cell_pvalues:
            count_l += (Lp_local.abs() >= abs_l).to(torch.int32)
    p_l = (_p_from_counts(count_l, P) if compute_cell_pvalues and P
           else torch.ones_like(L_local))
    if rows is not None:
        return LeesLRows(L_local, lag, p_l, L_global, draws)
    return LeesLResult(L_local, L_global, lag, _p_from_counts(count_g, P), p_l)
