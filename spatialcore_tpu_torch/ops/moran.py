"""Global Moran's I and Geary's C: standardization, observed statistics,
analytic moments and normal-tail p-values.

Port of the global part of ``spatialcore_tpu/ops/moran.py``. Estimator
conventions (squidpy/esda):

    I   = (n / S0) · zᵀ W z / zᵀz,               E[I] = −1/(n−1)
    C   = (n−1) Σ_ij w_ij (z_i−z_j)² / (2 S0 Σ z²), E[C] = 1
    VarN / VarR : Cliff & Ord (1981) normality / randomization formulas.

The slot permutation null ``permutation_test_global`` is not ported yet
(ROADMAP Queue 1 item 4); the banded null in ``ops/banded.py`` serves the
permutation p-values.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .graph import SpatialGraph, spatial_lag


def standardize(X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column z-scores with population std; returns (Z, zero_var mask).

    Shifted two-pass variance (the one-pass E[X²]−mean² form cancels in
    float32 for high-mean, low-variance genes). Zero-variance columns get
    std 1, so their z is all zeros. float64 input stays float64.
    """
    if X.dtype not in (torch.float32, torch.float64):
        X = X.to(torch.float32)
    Xc = X - X.mean(dim=0, keepdim=True)
    var = (Xc * Xc).mean(dim=0, keepdim=True)
    zero = var[0] <= 0
    std = torch.sqrt(torch.where(var > 0, var, torch.ones_like(var)))
    return Xc / std, zero


def moran_observed(graph: SpatialGraph, Z: torch.Tensor, S0: float) -> torch.Tensor:
    """Global Moran's I per gene for standardized Z [N, G]."""
    n = Z.shape[0]
    num = (Z * spatial_lag(graph, Z)).sum(dim=0)
    den = (Z * Z).sum(dim=0)
    den = torch.where(den > 0, den, torch.ones_like(den))
    return (n / S0) * num / den


def geary_observed(graph: SpatialGraph, Z: torch.Tensor, S0: float) -> torch.Tensor:
    """Global Geary's C per gene for standardized Z [N, G]."""
    n = Z.shape[0]
    num = torch.zeros(Z.shape[1], dtype=Z.dtype, device=Z.device)
    for j in range(graph.neighbor_idx.shape[1]):
        diff = Z - Z[graph.neighbor_idx[:, j]]
        num += (graph.neighbor_w[:, j:j + 1] * diff * diff).sum(dim=0)
    den = (Z * Z).sum(dim=0)
    den = torch.where(den > 0, den, torch.ones_like(den))
    return (n - 1) * num / (2.0 * S0 * den)


def _kurtosis(Z: torch.Tensor) -> torch.Tensor:
    n = Z.shape[0]
    z2 = (Z * Z).sum(dim=0)
    z4 = (Z ** 4).sum(dim=0)
    return n * z4 / torch.where(z2 > 0, z2 * z2, torch.ones_like(z2))


def moran_analytic_moments(Z: torch.Tensor, S0: float, S1: float, S2: float,
                           assumption: str = "randomization"):
    """(E[I], Var[I]) per gene under normality or randomization."""
    n = Z.shape[0]
    EI = -1.0 / (n - 1)
    if assumption == "normality":
        var = (n * n * S1 - n * S2 + 3 * S0 * S0) / (S0 * S0 * (n * n - 1)) - EI ** 2
        return EI, torch.full((Z.shape[1],), var, dtype=torch.float32,
                              device=Z.device)
    b2 = _kurtosis(Z)
    num = (n * ((n * n - 3 * n + 3) * S1 - n * S2 + 3 * S0 * S0)
           - b2 * ((n * n - n) * S1 - 2 * n * S2 + 6 * S0 * S0))
    den = (n - 1) * (n - 2) * (n - 3) * S0 * S0
    return EI, num / den - EI ** 2


def geary_analytic_moments(Z: torch.Tensor, S0: float, S1: float, S2: float,
                           assumption: str = "randomization"):
    """(E[C]=1, Var[C]) per gene under normality or randomization."""
    n = Z.shape[0]
    if assumption == "normality":
        var = ((2 * S1 + S2) * (n - 1) - 4 * S0 * S0) / (2 * (n + 1) * S0 * S0)
        return 1.0, torch.full((Z.shape[1],), var, dtype=torch.float32,
                               device=Z.device)
    b2 = _kurtosis(Z)
    nd = n * (n - 2) * (n - 3) * S0 * S0
    t1 = (n - 1) * S1 * (n * n - 3 * n + 3 - (n - 1) * b2)
    t2 = -0.25 * (n - 1) * S2 * (n * n + 3 * n - 6 - (n * n - n + 2) * b2)
    t3 = S0 * S0 * (n * n - 3 - (n - 1) ** 2 * b2)
    return 1.0, (t1 + t2 + t3) / nd


def p_from_z(z: torch.Tensor, alternative: str = "greater") -> torch.Tensor:
    """Normal-tail p-value from a z-score."""
    if alternative == "greater":
        return 1.0 - torch.special.ndtr(z)
    if alternative == "less":
        return torch.special.ndtr(z)
    return 2.0 * (1.0 - torch.special.ndtr(torch.abs(z)))
