"""Moran's I and Geary's C: standardization, observed statistics, analytic
moments, normal-tail p-values, the global and local slot permutation
nulls, join counts and the multivariate local Geary.

Port of ``spatialcore_tpu/ops/moran.py`` but for ``correlogram_kernel``.
Estimator conventions (squidpy/esda):

    I   = (n / S0) · zᵀ W z / zᵀz,               E[I] = −1/(n−1)
    C   = (n−1) Σ_ij w_ij (z_i−z_j)² / (2 S0 Σ z²), E[C] = 1
    VarN / VarR : Cliff & Ord (1981) normality / randomization formulas.

Every slot null draws ``jax.random.permutation``'s stream bitwise
(``core.rng.permutation``), keyed ``fold_in(key_for(seed, stream, 0), d)``
for draw d, and runs one draw at a time, so its temps stay at a few
[N, G] planes at any draw count. The local nulls' conditional draws
(:func:`_conditional_draw_indices`) are shared by local Moran, local Geary,
local join counts and the multivariate local Geary, as in the reference.
The k neighbour slots add in slot order in float32 (the reference's order;
no matmul).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.rng import _choice, fold_in, key_for, permutation
from .banded import _p_from_counts
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
# Permutation null (global, slot form)
# ---------------------------------------------------------------------------


def _perm_stat_global(graph: SpatialGraph, Z: torch.Tensor, S0: float,
                      perm: torch.Tensor, stat: str, den: torch.Tensor):
    """Null statistic [G] of one permutation, reduced per neighbour slot.

    No [N, G] lag is kept: each slot gathers, multiplies and reduces
    straight to [G], in slot order. ``den`` = Σz² (permutation-invariant)
    comes precomputed. Products promote to float32 (float64 for float64
    ``Z``), as in the reference: a bf16 table's gathers stay bf16.
    """
    n = Z.shape[0]
    Zp = Z[perm]
    num = torch.zeros(Z.shape[1], dtype=torch.float32, device=Z.device)
    for j in range(graph.neighbor_idx.shape[1]):
        Zn = Z[perm[graph.neighbor_idx[:, j]]]          # composite index [N]
        w = graph.neighbor_w[:, j:j + 1]
        if stat == "moran":
            num = num + (w * Zp * Zn).sum(dim=0)
        else:
            diff = Zp - Zn
            num = num + (w * diff * diff).sum(dim=0)
    if stat == "moran":
        return (n / S0) * num / den
    return (n - 1) * num / (2.0 * S0 * den)


def permutation_test_global(graph: SpatialGraph, Z: torch.Tensor, S0: float,
                            observed: torch.Tensor, seed: int,
                            n_permutations: int, stat: str = "moran",
                            chunk: int = 1, alternative: str = "greater",
                            null_dtype: str = "float32"
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Monte-Carlo permutation p-values, null mean and null std of a global
    statistic ("moran" or "geary"), the slot form (reference
    ``permutation_test_global``, spatialcore_tpu/ops/moran.py:181).

    One shuffle per draw, shared by all genes: draw d permutes the cells
    by ``permutation(fold_in(key_for(seed, "perm_global", 0), d), n)``,
    ``jax.random.permutation``'s stream bitwise, so the result does not
    depend on how many draws the reference batches. One draw at a time,
    so the temps stay at a few [N, G] planes at any draw count.
    ``null_dtype="bfloat16"`` gathers a bf16 copy of Z (per-slot sums stay
    float32). Counts and moments accumulate in ``Z``'s float type (at
    least float32). ``chunk`` is accepted for API compatibility.
    """
    del chunk
    if stat not in ("moran", "geary"):
        raise ValueError(f"stat must be 'moran' or 'geary', got {stat!r}")
    n, G = Z.shape
    base = key_for(seed, "perm_global", 0)
    den = (Z * Z).sum(dim=0)
    den = torch.where(den > 0, den, torch.ones_like(den))
    Zg = Z.to(torch.bfloat16) if null_dtype == "bfloat16" else Z
    acc_dt = torch.promote_types(Z.dtype, torch.float32)
    count = torch.zeros(G, dtype=torch.int32, device=Z.device)
    s1 = torch.zeros(G, dtype=acc_dt, device=Z.device)
    s2 = torch.zeros(G, dtype=acc_dt, device=Z.device)
    for d in range(n_permutations):
        perm = permutation(fold_in(base, d), n, device=Z.device)
        v = _perm_stat_global(graph, Zg, S0, perm, stat, den)
        if alternative == "greater":
            extreme = v >= observed
        elif alternative == "less":
            extreme = v <= observed
        else:
            extreme = v.abs() >= observed.abs()
        count += extreme.to(torch.int32)
        s1 += v
        s2 += v * v
    P = n_permutations
    p = (count + 1.0) / (P + 1.0)
    mean = s1 / P
    var = torch.clamp_min(s2 / P - mean ** 2, 0.0)
    return p, mean, torch.sqrt(var)


# ---------------------------------------------------------------------------
# Local Moran's I
# ---------------------------------------------------------------------------


def _conditional_draw_indices(key: torch.Tensor, n: int, k: int,
                              device) -> list:
    """One draw's GeoDa conditional-permutation indices (reference
    ``_conditional_draw_indices``, spatialcore_tpu/ops/moran.py:264).

    ``out[j][i]`` is the cell whose value fills neighbour slot j of cell i:
    ``perm[(inv[i] + 1 + u[j]) mod n]`` with ``perm = permutation(key, n)``,
    ``inv`` its inverse and ``u`` k distinct offsets drawn from [0, n−1)
    (``choice(fold_in(key, 1), n − 1, (k,), replace=False)``). So slot j
    never draws cell i itself, the k slots of a cell draw distinct cells,
    and each is uniform over the other n − 1. The inverse comes from a
    scatter, not the reference's argsort: the same integers. One
    implementation for every local conditional null: the draw keys stay in
    lock-step across them.
    """
    perm = permutation(key, n, device)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n, dtype=perm.dtype, device=perm.device)
    u = _choice(fold_in(key, 1), n - 1, k, device)
    pos = inv + 1
    return [perm[(pos + u[j]) % n] for j in range(k)]


def _slot_sum(graph: SpatialGraph, values) -> torch.Tensor:
    """Σ_j w_j · values[j] in slot order, from the first slot's term."""
    acc = None
    for j, v in enumerate(values):
        term = graph.neighbor_w[:, j:j + 1] * v
        acc = term if acc is None else acc + term
    return acc


def _counter_dtype(n_permutations: int) -> torch.dtype:
    """int16 counters while they cannot overflow (half the bytes of the
    [N, G] count update), int32 above."""
    return torch.int16 if n_permutations <= 32767 else torch.int32


class LocalMoranResult(NamedTuple):
    local_I: torch.Tensor   # [N, G]
    z: torch.Tensor         # [N, G]
    lag: torch.Tensor       # [N, G]
    p_value: torch.Tensor   # [N, G] permutation two-tailed (ones if P=0)


def local_moran(graph: SpatialGraph, Z: torch.Tensor, seed: int,
                n_permutations: int = 0, chunk: int = 8,
                null: str = "total") -> LocalMoranResult:
    """Local Moran's I with the slot permutation null: I_i = z_i · (Wz)_i,
    two-tailed p = (#{|I_perm| ≥ |I_obs|} + 1)/(P + 1) per cell and gene.

    ``null="total"`` (the reference's default) permutes whole columns:
    draw d's ``Zp = Z[perm]`` and ``I_perm = Zp · spatial_lag(Zp)``.
    ``"conditional"`` (GeoDa/esda) keeps each cell's own z_i and fills its
    k slots from :func:`_conditional_draw_indices`. Draw d is keyed
    ``fold_in(key_for(seed, "perm_local", 0), d)``, the reference's stream
    bitwise; each draw's k slots add in slot order. ``chunk`` is accepted
    for API compatibility.
    """
    del chunk
    if null not in ("total", "conditional"):
        raise ValueError(
            f"null must be 'total' or 'conditional', got {null!r}")
    n = Z.shape[0]
    k = graph.neighbor_idx.shape[1]
    lag = spatial_lag(graph, Z)
    I_obs = Z * lag
    if n_permutations == 0:
        return LocalMoranResult(I_obs, Z, lag, torch.ones_like(I_obs))
    abs_obs = I_obs.abs()
    base = key_for(seed, "perm_local", 0)
    cdt = _counter_dtype(n_permutations)
    count = torch.zeros(Z.shape, dtype=cdt, device=Z.device)
    for d in range(n_permutations):
        key = fold_in(base, d)
        if null == "total":
            Zp = Z[permutation(key, n, Z.device)]
            Ip = Zp * spatial_lag(graph, Zp)
            del Zp
        else:
            draws = _conditional_draw_indices(key, n, k, Z.device)
            Ip = Z * _slot_sum(graph, (Z[idx] for idx in draws))
        count += (Ip.abs() >= abs_obs).to(cdt)
        del Ip
    return LocalMoranResult(I_obs, Z, lag, _p_from_counts(count, n_permutations))


# ---------------------------------------------------------------------------
# Local Geary's C
# ---------------------------------------------------------------------------


class LocalGearyResult(NamedTuple):
    local_C: torch.Tensor   # [N, G]
    p_value: torch.Tensor   # [N, G] one-sided (low C = positive autocorr)


def _local_c(graph: SpatialGraph, me: torch.Tensor, neighbours) -> torch.Tensor:
    """c_i = Σ_j w_ij (me_i − nb_j,i)², the slots in order."""
    c = None
    for j, nb in enumerate(neighbours):
        d = me - nb
        term = graph.neighbor_w[:, j:j + 1] * d * d
        c = term if c is None else c + term
    return c


def local_geary(graph: SpatialGraph, Z: torch.Tensor, seed: int = 0,
                n_permutations: int = 0, null: str = "conditional"
                ) -> LocalGearyResult:
    """Local Geary's C (Anselin 1995): c_i = Σ_j w_ij (z_i − z_j)², one
    pass over the k neighbour slots in slot order (the reference's).

    Small c_i: the cell resembles its neighbours. The slot null's p is
    one-sided on the low tail, (#{c_perm ≤ c_obs} + 1)/(P + 1).
    ``null="conditional"`` (the default; GeoDa/esda) keeps each cell's own
    z_i and draws its k slots from :func:`_conditional_draw_indices`;
    ``"total"`` permutes whole columns on both sides. Draw d is keyed
    ``fold_in(key_for(seed, "perm_local_geary", 0), d)``, bitwise the
    reference's. With ``n_permutations=0`` p is all ones.
    """
    if null not in ("total", "conditional"):
        raise ValueError(
            f"null must be 'total' or 'conditional', got {null!r}")
    n = Z.shape[0]
    k = graph.neighbor_idx.shape[1]
    idx = graph.neighbor_idx
    c_obs = _local_c(graph, Z, (Z[idx[:, j]] for j in range(k)))
    if n_permutations == 0:
        return LocalGearyResult(c_obs, torch.ones_like(c_obs))
    base = key_for(seed, "perm_local_geary", 0)
    cdt = _counter_dtype(n_permutations)
    count = torch.zeros(Z.shape, dtype=cdt, device=Z.device)
    for d in range(n_permutations):
        key = fold_in(base, d)
        if null == "total":
            perm = permutation(key, n, Z.device)
            cp = _local_c(graph, Z[perm], (Z[perm[idx[:, j]]] for j in range(k)))
        else:
            draws = _conditional_draw_indices(key, n, k, Z.device)
            cp = _local_c(graph, Z, (Z[i] for i in draws))
        count += (cp <= c_obs).to(cdt)
        del cp
    return LocalGearyResult(c_obs, _p_from_counts(count, n_permutations))


# ---------------------------------------------------------------------------
# Join counts (binary autocorrelation)
# ---------------------------------------------------------------------------


def _join_counts(adj: torch.Tensor, idx: torch.Tensor, x: torch.Tensor):
    """(BB, WW) joins of ``x`` [N] over the binary adjacency ``adj`` [N, k]:
    float32 products (exact for 0/1 labels) summed in float64, so the
    integer counts stay exact at any size."""
    bb = torch.zeros((), dtype=torch.float64, device=x.device)
    ww = torch.zeros_like(bb)
    for j in range(idx.shape[1]):
        xn = x[idx[:, j]]
        a = adj[:, j]
        bb = bb + (a * x * xn).sum(dtype=torch.float64)
        ww = ww + (a * (1 - x) * (1 - xn)).sum(dtype=torch.float64)
    return bb, ww


def join_counts(graph: SpatialGraph, x: torch.Tensor, seed: int = 0,
                n_permutations: int = 999) -> dict:
    """Join-count statistics of a binary variable over the graph
    (reference ``join_counts``, spatialcore_tpu/ops/moran.py:444).

    Directed joins on the binary adjacency (w > 0): BB = Σ ā_ij x_i x_j,
    WW = Σ ā_ij (1−x_i)(1−x_j), BW the rest. Draw d permutes the labels by
    ``permutation(fold_in(key_for(seed, "join_counts", 0), d), n)``;
    one-sided p = (#{BB_perm ≥ BB}+1)/(P+1), the same for WW, and
    #{BW_perm ≤ BW} for BW. The join counts sum in float64 (exact
    integers; the reference's float32 sums are exact below 2²⁴ joins) and
    return as float32 0-d tensors, with the p-values.
    """
    x = torch.as_tensor(x).to(device=graph.neighbor_idx.device,
                              dtype=torch.float32)
    n = x.shape[0]
    adj = (graph.neighbor_w > 0).to(torch.float32)
    idx = graph.neighbor_idx
    total = adj.sum(dtype=torch.float64)
    bb_obs, ww_obs = _join_counts(adj, idx, x)
    bw_obs = total - bb_obs - ww_obs
    base = key_for(seed, "join_counts", 0)
    c = torch.zeros(3, dtype=torch.int32, device=x.device)
    for d in range(n_permutations):
        bb, ww = _join_counts(adj, idx, x[permutation(fold_in(base, d), n,
                                                      x.device)])
        c += torch.stack([bb >= bb_obs, ww >= ww_obs,
                          total - bb - ww <= bw_obs]).to(torch.int32)
    p = _p_from_counts(c, n_permutations)
    f32 = torch.float32
    return {"BB": bb_obs.to(f32), "WW": ww_obs.to(f32), "BW": bw_obs.to(f32),
            "p_BB": p[0], "p_WW": p[1], "p_BW": p[2]}


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


# ---------------------------------------------------------------------------
# Local join counts / multivariate local Geary (Anselin & Li 2019)
# ---------------------------------------------------------------------------


def local_join_counts(graph: SpatialGraph, x: torch.Tensor, seed: int = 0,
                      n_permutations: int = 999):
    """Local join counts of a binary variable (reference
    ``local_join_counts``, spatialcore_tpu/ops/moran.py:534).

    BB_i = x_i · Σ_j ā_ij x_j over the binary adjacency: the 1-1 joins at
    cell i. The null is the conditional permutation
    (:func:`_conditional_draw_indices`, key ``perm_local_jc``); one-sided
    p = (#{BB_perm ≥ BB_obs}+1)/(P+1) where x_i = 1, 1 elsewhere. Every
    value is a small integer, exact in float32. Returns (BB [N] float32,
    p [N] float32).
    """
    x = torch.as_tensor(x).to(device=graph.neighbor_idx.device,
                              dtype=torch.float32)
    n = x.shape[0]
    k = graph.neighbor_idx.shape[1]
    adj = (graph.neighbor_w > 0).to(torch.float32)

    def bb(values):
        s = None
        for j, v in enumerate(values):
            term = adj[:, j] * v
            s = term if s is None else s + term
        return x * s

    obs = bb(x[graph.neighbor_idx[:, j]] for j in range(k))
    if n_permutations == 0:
        return obs, torch.ones_like(obs)
    base = key_for(seed, "perm_local_jc", 0)
    count = torch.zeros(n, dtype=torch.int32, device=x.device)
    for d in range(n_permutations):
        draws = _conditional_draw_indices(fold_in(base, d), n, k, x.device)
        count += (bb(x[i] for i in draws) >= obs).to(torch.int32)
    p = _p_from_counts(count, n_permutations)
    return obs, torch.where(x > 0, p, torch.ones_like(p))


def local_geary_multivariate(graph: SpatialGraph, Z: torch.Tensor,
                             seed: int = 0, n_permutations: int = 999):
    """Multivariate local Geary (Anselin 2019; reference
    ``local_geary_multivariate``, spatialcore_tpu/ops/moran.py:583):
    c_i = (1/G) Σ_j w_ij Σ_v (z_vi − z_vj)² over the G columns of ``Z``.

    One conditional-permutation null shared by every variable (key
    ``perm_local_geary_mv``); one-sided low-tail p. The slots add in slot
    order; the sum over variables is torch's row reduction, whose order
    may differ from XLA's. Returns (c [N], p [N]).
    """
    n, G = Z.shape
    k = graph.neighbor_idx.shape[1]

    def cstat(neighbours):
        c = None
        for j, nb in enumerate(neighbours):
            d = Z - nb
            term = graph.neighbor_w[:, j] * (d * d).sum(dim=1)
            c = term if c is None else c + term
        return c / G

    obs = cstat(Z[graph.neighbor_idx[:, j]] for j in range(k))
    if n_permutations == 0:
        return obs, torch.ones_like(obs)
    base = key_for(seed, "perm_local_geary_mv", 0)
    count = torch.zeros(n, dtype=torch.int32, device=Z.device)
    for d in range(n_permutations):
        draws = _conditional_draw_indices(fold_in(base, d), n, k, Z.device)
        count += (cstat(Z[i] for i in draws) <= obs).to(torch.int32)
    return obs, _p_from_counts(count, n_permutations)
