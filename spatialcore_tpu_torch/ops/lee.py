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

from typing import NamedTuple

import torch

from ..core.rng import fold_in, key_for, permutation
from .banded import _p_from_counts
from .graph import SpatialGraph, spatial_lag


class LeesLResult(NamedTuple):
    L_local: torch.Tensor    # [N, P] local values
    L_global: torch.Tensor   # [P]
    lag_zy: torch.Tensor     # [N, P]
    p_global: torch.Tensor   # [P]
    p_local: torch.Tensor    # [N, P], ones unless requested


def lees_l_pairs(graph: SpatialGraph, Zx: torch.Tensor, Zy: torch.Tensor,
                 seed: int, n_permutations: int = 0,
                 compute_cell_pvalues: bool = False,
                 chunk: int = 16) -> LeesLResult:
    """Lee's L for P gene pairs at once (columns of ``Zx`` and ``Zy``).

    Each draw permutes the rows of ``Zy`` on its device, takes one
    ``spatial_lag`` and compares |L| globally and, with
    ``compute_cell_pvalues``, per cell. ``chunk`` is accepted for API
    compatibility and ignored, as in the reference.
    """
    del chunk
    lag = spatial_lag(graph, Zy)
    L_local = Zx * lag
    L_global = L_local.sum(dim=0)
    if n_permutations == 0:
        return LeesLResult(L_local, L_global, lag, torch.ones_like(L_global),
                           torch.ones_like(L_local))
    n = Zx.shape[0]
    abs_g, abs_l = L_global.abs(), L_local.abs()
    base = key_for(seed, "perm_lee", 0)
    count_g = torch.zeros(L_global.shape, dtype=torch.int32, device=Zx.device)
    count_l = (torch.zeros(L_local.shape, dtype=torch.int32, device=Zx.device)
               if compute_cell_pvalues else None)
    for p in range(n_permutations):
        perm = permutation(fold_in(base, p), n, device=Zx.device)
        Lp_local = Zx * spatial_lag(graph, Zy[perm])
        count_g += (Lp_local.sum(dim=0).abs() >= abs_g).to(torch.int32)
        if compute_cell_pvalues:
            count_l += (Lp_local.abs() >= abs_l).to(torch.int32)
    p_l = (_p_from_counts(count_l, n_permutations) if compute_cell_pvalues
           else torch.ones_like(L_local))
    return LeesLResult(L_local, L_global, lag,
                       _p_from_counts(count_g, n_permutations), p_l)
