"""Moran's I and Geary's C: standardization, observed statistics, analytic
moments, normal-tail p-values, and the observed parts of local Moran (LISA)
and local Geary.

Port of the global part and of ``local_moran`` / ``classify_quadrants`` /
``local_geary`` of ``spatialcore_tpu/ops/moran.py``. Estimator conventions (squidpy/esda):

    I   = (n / S0) · zᵀ W z / zᵀz,               E[I] = −1/(n−1)
    C   = (n−1) Σ_ij w_ij (z_i−z_j)² / (2 S0 Σ z²), E[C] = 1
    VarN / VarR : Cliff & Ord (1981) normality / randomization formulas.

The slot permutation nulls (``permutation_test_global``, and
``local_moran`` / ``local_geary`` with ``n_permutations > 0``) draw with
``jax.random.permutation`` and are not ported yet (ROADMAP Queue 1 item 4);
the banded nulls in ``ops/banded.py`` serve the permutation p-values.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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


# ---------------------------------------------------------------------------
# Local Moran's I
# ---------------------------------------------------------------------------


class LocalMoranResult(NamedTuple):
    local_I: torch.Tensor   # [N, G]
    z: torch.Tensor         # [N, G]
    lag: torch.Tensor       # [N, G]
    p_value: torch.Tensor   # [N, G] permutation two-tailed (ones if P=0)


def local_moran(graph: SpatialGraph, Z: torch.Tensor, seed: int,
                n_permutations: int = 0, chunk: int = 8,
                null: str = "total") -> LocalMoranResult:
    """Local Moran's I: I_i = z_i · (Wz)_i, one exact ``spatial_lag`` pass.

    With ``n_permutations=0`` (the observed statistics; p is all ones) as
    the reference. Its slot permutation null draws with
    ``jax.random.permutation`` and is not ported yet: ``n_permutations > 0``
    raises ``NotImplementedError``; ``ops.banded.banded_local_moran`` serves
    the permutation p-values. ``chunk`` and ``seed`` are accepted for API
    compatibility.
    """
    del chunk, seed
    if null not in ("total", "conditional"):
        raise ValueError(
            f"null must be 'total' or 'conditional', got {null!r}")
    if n_permutations > 0:
        raise NotImplementedError(
            "the slot LISA null (local_moran with n_permutations > 0) draws "
            "with jax.random.permutation, which is not ported yet (ROADMAP "
            "Queue 1 item 4); use ops.banded.banded_local_moran")
    lag = spatial_lag(graph, Z)
    I_obs = Z * lag
    return LocalMoranResult(I_obs, Z, lag, torch.ones_like(I_obs))


# ---------------------------------------------------------------------------
# Local Geary's C
# ---------------------------------------------------------------------------


class LocalGearyResult(NamedTuple):
    local_C: torch.Tensor   # [N, G]
    p_value: torch.Tensor   # [N, G] one-sided (low C = positive autocorr)


def local_geary(graph: SpatialGraph, Z: torch.Tensor, seed: int = 0,
                n_permutations: int = 0, null: str = "conditional"
                ) -> LocalGearyResult:
    """Local Geary's C (Anselin 1995): c_i = Σ_j w_ij (z_i − z_j)², one
    pass over the k neighbour slots in slot order (the reference's).

    Small c_i: the cell resembles its neighbours. With
    ``n_permutations=0`` p is all ones, as in the reference. Its slot nulls
    ("conditional" and "total") draw with ``jax.random.permutation`` and
    are not ported yet: ``n_permutations > 0`` raises
    ``NotImplementedError``; ``ops.banded.banded_local_geary`` serves the
    total-null p-values.
    """
    del seed
    if null not in ("total", "conditional"):
        raise ValueError(
            f"null must be 'total' or 'conditional', got {null!r}")
    if n_permutations > 0:
        raise NotImplementedError(
            "the slot local-Geary null (local_geary with n_permutations > 0) "
            "draws with jax.random.permutation, which is not ported yet "
            "(ROADMAP Queue 1 item 4); use ops.banded.banded_local_geary")
    c = torch.zeros_like(Z)
    for j in range(graph.neighbor_idx.shape[1]):
        d = Z - Z[graph.neighbor_idx[:, j]]
        c = c + graph.neighbor_w[:, j:j + 1] * d * d
    return LocalGearyResult(c, torch.ones_like(c))


# ---------------------------------------------------------------------------
# Quadrants
# ---------------------------------------------------------------------------

QUADRANT_LABELS = {0: "NS", 1: "HH", 2: "LL", 3: "HL", 4: "LH"}


def classify_quadrants(z: torch.Tensor, lag: torch.Tensor,
                       p_values: Optional[torch.Tensor] = None,
                       alpha: float = 0.05) -> torch.Tensor:
    """LISA quadrant codes (int8): 0=NS, 1=HH, 2=LL, 3=HL, 4=LH.

    sign(z) × sign(lag) picks the quadrant; cells with p ≥ alpha are forced
    to NS. Exact zeros in z or lag are NS.
    """
    zp, zn, lp, ln = z > 0, z < 0, lag > 0, lag < 0
    q = (zp & lp).to(torch.int8)
    q += (zn & ln).to(torch.int8) * 2
    q += (zp & ln).to(torch.int8) * 3
    q += (zn & lp).to(torch.int8) * 4
    if p_values is not None:
        q = torch.where(p_values >= alpha, torch.zeros_like(q), q)
    return q
