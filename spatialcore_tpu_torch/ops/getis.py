"""Getis-Ord Gi/Gi* hot-spot statistics (Ord & Getis 1995).

Port of ``spatialcore_tpu/ops/getis.py``. Binary weights over the k
nearest neighbours (the graph's valid slots):

    Gi*_i: self included with weight 1
        z_i = (Σ_j w_ij x_j − x̄ W_i) / (s √[(n S1_i − W_i²)/(n−1)])
    with x̄, s over all n observations, W_i = Σ_j w_ij, S1_i = Σ_j w_ij².

    Gi (self excluded): the same form with x̄_(i), s_(i) over the n−1
    observations j ≠ i and n replaced by n−1.

The analytic normal p-values are the default. The slot permutation null
(``n_permutations > 0``) shuffles with ``jax.random.permutation`` and is
not ported yet; ``ops.banded.banded_getis`` serves the permutation p_sim.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .graph import SpatialGraph


class GetisOrdResult(NamedTuple):
    G: torch.Tensor        # [N, G] raw Gi(*) ratio statistic
    z_score: torch.Tensor  # [N, G] analytic z under randomization
    p_value: torch.Tensor  # [N, G] analytic normal p (per ``alternative``)
    p_sim: torch.Tensor    # [N, G] permutation p; ones if P=0


def _binary_lag(graph: SpatialGraph, X: torch.Tensor) -> torch.Tensor:
    """Σ_{j∈N(i)} x_j — unweighted neighbour sum over the valid slots."""
    lag = torch.zeros_like(X)
    for j in range(graph.neighbor_idx.shape[1]):
        lag = lag + torch.where(graph.valid[:, j:j + 1],
                                X[graph.neighbor_idx[:, j]], 0.0)
    return lag


def _column_sums(X: torch.Tensor):
    """Σ_i x_ig and Σ_i x_ig² as [1, G] in X's dtype, accumulated in
    float64: a float32 reduction's order on the card depends on the
    tensor's width and strides, so a column block would get other bits
    than the whole matrix; the float64 sums round to the same value
    either way (exactly so for integer counts)."""
    return (X.sum(dim=0, keepdim=True, dtype=torch.float64).to(X.dtype),
            (X * X).sum(dim=0, keepdim=True, dtype=torch.float64).to(X.dtype))


def getis_ord(graph: SpatialGraph, X: torch.Tensor, star: bool = True,
              alternative: str = "two-sided", seed: int = 0,
              n_permutations: int = 0) -> GetisOrdResult:
    """Gi*/Gi per cell × gene on RAW values ``X`` [N, G] (not z-scored)."""
    del seed
    if alternative not in ("two-sided", "greater", "less"):
        raise ValueError("alternative must be 'two-sided', 'greater' or "
                         f"'less', got {alternative!r}")
    if n_permutations > 0:
        raise NotImplementedError(
            "the slot Getis-Ord null (getis_ord with n_permutations > 0) "
            "draws with jax.random.permutation, which is not ported yet "
            "(ROADMAP Queue 1 item 4); use ops.banded.banded_getis")
    X = torch.as_tensor(X)
    if X.ndim == 1:
        X = X[:, None]
    if X.dtype not in (torch.float32, torch.float64):
        X = X.to(torch.float32)
    n = X.shape[0]
    deg = graph.valid.sum(dim=1).to(X.dtype)                  # [N]
    lag = _binary_lag(graph, X)
    tot, sq = _column_sums(X)                                 # [1, G] each
    if star:
        lag_s = lag + X
        W = deg + 1.0
        m = n
        xbar = tot / n                                        # [1, G]
        s2 = sq / n - xbar ** 2
    else:
        lag_s = lag
        W = deg
        m = n - 1
        xbar = (tot - X) / m                                  # [N, G] x̄_(i)
        s2 = (sq - X * X) / m - xbar ** 2
    del lag
    s2 = torch.clamp_min(s2, 0.0)
    s = torch.sqrt(torch.where(s2 > 0, s2, torch.ones_like(s2)))
    del s2
    S1 = W                                                    # binary: Σw² = W
    denom_i = torch.sqrt(torch.clamp_min(
        (m * S1 - W ** 2) / max(m - 1.0, 1.0), 0.0))
    z = (lag_s - xbar * W[:, None]) / (s * denom_i[:, None])
    del xbar, s
    # raw G ratio: Σ_j w_ij x_j / Σ_j x_j (star: totals include i)
    gden = tot if star else tot - X
    G = lag_s / torch.where(gden != 0, gden, torch.ones_like(gden))
    del lag_s, gden
    if alternative == "two-sided":
        p = 2.0 * torch.special.ndtr(-z.abs())
    elif alternative == "greater":
        p = torch.special.ndtr(-z)
    else:
        p = torch.special.ndtr(z)
    return GetisOrdResult(G, z, p, torch.ones_like(p))
