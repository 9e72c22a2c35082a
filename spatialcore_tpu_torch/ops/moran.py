"""Moran's I and Geary's C: standardization, observed statistics, analytic
moments, normal-tail p-values, the global and local slot permutation
nulls, join counts, the multivariate local Geary and the distance-band
correlogram.

Port of ``spatialcore_tpu/ops/moran.py``.
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
from ..kernels.band_cross import tree_sum
from ..kernels.lisa_float import counter_dtype
from ..utils.profiling import traced
from .banded import _p_from_counts
from .graph import SpatialGraph, graph_rows, spatial_lag


def _column_sums(X: torch.Tensor) -> torch.Tensor:
    """Σ over the rows of each column in one fixed pairwise order, 512
    columns at a time (``kern.tree_sum``): a column's sum is the same at
    any width, in any layout and on every device, so a gene's value does
    not depend on how many genes come with it."""
    return tree_sum(X, 512)


def _cell_sums(T: torch.Tensor) -> torch.Tensor:
    """Σ over the cells (rows) of each gene column in an order that does
    not depend on how many genes come with it: on the card
    :func:`_column_sums`; on the CPU torch's reduction of each column as
    one contiguous vector (the order that stays within the JAX package's
    float32 rounding on small values, which the pairwise tree does not).
    One column is summed beside a zero one: a reduction to one value
    splits its work over the CPU's threads, in another order."""
    if T.device.type != "cpu":
        return _column_sums(T)
    Tt = T.t().contiguous()
    if Tt.shape[0] == 1:
        Tt = torch.cat([Tt, torch.zeros_like(Tt)])
    return Tt.sum(dim=1)[:T.shape[1]]


def standardize(X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column z-scores with population std; returns (Z, zero_var mask).

    Shifted two-pass variance (the one-pass E[X²]−mean² form cancels in
    float32 for high-mean, low-variance genes). Zero-variance columns get
    std 1, so their z is all zeros. float64 input stays float64. The sums
    run in :func:`_column_sums`' fixed order, so a gene's z does not
    depend on how many genes are standardized with it.
    """
    if X.dtype not in (torch.float32, torch.float64):
        X = X.to(torch.float32)
    n = X.shape[0]
    Xc = X - (_column_sums(X) / n)[None, :]
    var = (_column_sums(Xc * Xc) / n)[None, :]
    zero = var[0] <= 0
    std = torch.sqrt(torch.where(var > 0, var, torch.ones_like(var)))
    return Xc / std, zero


def moran_observed(graph: SpatialGraph, Z: torch.Tensor, S0: float) -> torch.Tensor:
    """Global Moran's I per gene for standardized Z [N, G]."""
    n = Z.shape[0]
    num = _cell_sums(Z * spatial_lag(graph, Z))
    den = _cell_sums(Z * Z)
    den = torch.where(den > 0, den, torch.ones_like(den))
    return (n / S0) * num / den


def geary_observed(graph: SpatialGraph, Z: torch.Tensor, S0: float) -> torch.Tensor:
    """Global Geary's C per gene for standardized Z [N, G]."""
    n = Z.shape[0]
    num = torch.zeros(Z.shape[1], dtype=Z.dtype, device=Z.device)
    for j in range(graph.neighbor_idx.shape[1]):
        diff = Z - Z[graph.neighbor_idx[:, j]]
        num += _cell_sums(graph.neighbor_w[:, j:j + 1] * diff * diff)
    den = _cell_sums(Z * Z)
    den = torch.where(den > 0, den, torch.ones_like(den))
    return (n - 1) * num / (2.0 * S0 * den)


def _kurtosis(Z: torch.Tensor) -> torch.Tensor:
    n = Z.shape[0]
    z2 = _cell_sums(Z * Z)
    z4 = _cell_sums(Z ** 4)
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

    The slots' products add elementwise in slot order (one in-place
    multiply-add a slot, the memory traffic of one reduction a slot), then
    the rows in :func:`_column_sums`' fixed order, so a gene's value does
    not depend on how many genes come with it. ``den`` = Σz² (permutation-invariant)
    comes precomputed. Products promote to float32 (float64 for float64
    ``Z``), as in the reference: a bf16 table's gathers stay bf16.
    """
    n = Z.shape[0]
    Zp = Z[perm]
    acc = None
    for j in range(graph.neighbor_idx.shape[1]):
        Zn = Z[perm[graph.neighbor_idx[:, j]]]          # composite index [N]
        w = graph.neighbor_w[:, j:j + 1]
        if stat == "moran":
            a, b = w * Zp, Zn
        else:
            b = Zp - Zn
            a = w * b
        acc = a * b if acc is None else acc.addcmul_(a, b)
    num = _column_sums(acc).to(torch.promote_types(acc.dtype, torch.float32))
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
    den = _column_sums(Z * Z)           # width-independent, as each draw
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


class LocalMoranResult(NamedTuple):
    local_I: torch.Tensor   # [N, G]
    z: torch.Tensor         # [N, G]
    lag: torch.Tensor       # [N, G]
    p_value: torch.Tensor   # [N, G] permutation two-tailed (ones if P=0)


def local_moran(graph: SpatialGraph, Z: torch.Tensor, seed: int,
                n_permutations: int = 0, chunk: int = 8,
                null: str = "total",
                rows: Optional[Tuple[int, int]] = None) -> LocalMoranResult:
    """Local Moran's I with the slot permutation null: I_i = z_i · (Wz)_i,
    two-tailed p = (#{|I_perm| ≥ |I_obs|} + 1)/(P + 1) per cell and gene.

    ``null="total"`` (the reference's default) permutes whole columns:
    draw d's ``Zp = Z[perm]`` and ``I_perm = Zp · spatial_lag(Zp)``.
    ``"conditional"`` (GeoDa/esda) keeps each cell's own z_i and fills its
    k slots from :func:`_conditional_draw_indices`. Draw d is keyed
    ``fold_in(key_for(seed, "perm_local", 0), d)``, the reference's stream
    bitwise; each draw's k slots add in slot order. ``chunk`` is accepted
    for API compatibility.

    ``rows=(r0, r1)``: the outputs of cells [r0, r1) only, bitwise those
    rows of the whole call. The graph's rows are sliced; each draw still
    permutes all N cells, and only the rows' values are gathered.
    """
    del chunk
    if null not in ("total", "conditional"):
        raise ValueError(
            f"null must be 'total' or 'conditional', got {null!r}")
    n = Z.shape[0]
    r0, r1 = (0, n) if rows is None else rows
    graph = graph_rows(graph, rows)
    k = graph.neighbor_idx.shape[1]
    Zr = Z[r0:r1]
    lag = spatial_lag(graph, Z)
    I_obs = Zr * lag
    if n_permutations == 0:
        return LocalMoranResult(I_obs, Zr, lag, torch.ones_like(I_obs))
    abs_obs = I_obs.abs()
    base = key_for(seed, "perm_local", 0)
    cdt = counter_dtype(n_permutations)
    count = torch.zeros(I_obs.shape, dtype=cdt, device=Z.device)
    for d in range(n_permutations):
        key = fold_in(base, d)
        if null == "total":
            perm = permutation(key, n, Z.device)
            Ip = Z[perm[r0:r1]] * spatial_lag(graph, Z, perm)
        else:
            draws = _conditional_draw_indices(key, n, k, Z.device)
            Ip = Zr * _slot_sum(graph, (Z[idx[r0:r1]] for idx in draws))
        count += (Ip.abs() >= abs_obs).to(cdt)
        del Ip
    return LocalMoranResult(I_obs, Zr, lag, _p_from_counts(count, n_permutations))


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
                n_permutations: int = 0, null: str = "conditional",
                rows: Optional[Tuple[int, int]] = None) -> LocalGearyResult:
    """Local Geary's C (Anselin 1995): c_i = Σ_j w_ij (z_i − z_j)², one
    pass over the k neighbour slots in slot order (the reference's).

    Small c_i: the cell resembles its neighbours. The slot null's p is
    one-sided on the low tail, (#{c_perm ≤ c_obs} + 1)/(P + 1).
    ``null="conditional"`` (the default; GeoDa/esda) keeps each cell's own
    z_i and draws its k slots from :func:`_conditional_draw_indices`;
    ``"total"`` permutes whole columns on both sides. Draw d is keyed
    ``fold_in(key_for(seed, "perm_local_geary", 0), d)``, bitwise the
    reference's. With ``n_permutations=0`` p is all ones. ``rows`` as in
    :func:`local_moran`.
    """
    if null not in ("total", "conditional"):
        raise ValueError(
            f"null must be 'total' or 'conditional', got {null!r}")
    n = Z.shape[0]
    r0, r1 = (0, n) if rows is None else rows
    graph = graph_rows(graph, rows)
    k = graph.neighbor_idx.shape[1]
    idx = graph.neighbor_idx
    Zr = Z[r0:r1]
    c_obs = _local_c(graph, Zr, (Z[idx[:, j]] for j in range(k)))
    if n_permutations == 0:
        return LocalGearyResult(c_obs, torch.ones_like(c_obs))
    base = key_for(seed, "perm_local_geary", 0)
    cdt = counter_dtype(n_permutations)
    count = torch.zeros(c_obs.shape, dtype=cdt, device=Z.device)
    for d in range(n_permutations):
        key = fold_in(base, d)
        if null == "total":
            perm = permutation(key, n, Z.device)
            cp = _local_c(graph, Z[perm[r0:r1]],
                          (Z[perm[idx[:, j]]] for j in range(k)))
        else:
            draws = _conditional_draw_indices(key, n, k, Z.device)
            cp = _local_c(graph, Zr, (Z[i[r0:r1]] for i in draws))
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


@traced("post.quadrants")
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


# ---------------------------------------------------------------------------
# Distance-band correlogram: every band in one pass
# ---------------------------------------------------------------------------


class CorrelogramBands(NamedTuple):
    """Band structure of one radius search (:func:`correlogram_bands`)."""

    idx: torch.Tensor      # int64 [N, K'] neighbour ids (0 on dead slots)
    bid: torch.Tensor      # int64 [N, K'] band of each slot (B = none)
    wt: torch.Tensor       # f32 [N, K'] 1/deg_i of the slot's band (0: none)
    invdeg: torch.Tensor   # f32 [N, B] 1/deg_i per band (0 where none)
    S0: torch.Tensor       # f32 [B]
    S1: torch.Tensor       # f32 [B]
    S2: torch.Tensor       # f32 [B]


def _band_onehot(bid_col: torch.Tensor, n_bands: int) -> torch.Tensor:
    """float32 [N, B] one-hot of a slot's band; "none" (B) is all zero."""
    return torch.nn.functional.one_hot(bid_col, n_bands + 1)[:, :n_bands].to(
        torch.float32)


def correlogram_bands(idx: torch.Tensor, dist: torch.Tensor,
                      valid: torch.Tensor, edges: torch.Tensor
                      ) -> CorrelogramBands:
    """Band ids, per-band row weights and Cliff-Ord sums of a radius search
    (the first half of the reference's ``correlogram_kernel``).

    A slot's band is ``searchsorted(edges, dist, right) − 1``; slots that
    are dead, below ``edges[0]`` or at or past ``edges[-1]`` belong to no
    band. Row i's weight in band b is 1/deg_i(b). Band membership is
    symmetric, so w_ji = 1/deg_j is a gather of the neighbour's band
    degree: S0 = #rows with pairs, S1 = Σ_i 1/deg_i + Σ_edges
    1/(deg_i·deg_j), S2 = Σ_i (1 + Σ_{j∈b(i)} 1/deg_j)², one slot at a time
    (temporaries O(N·B)). Columns past the widest row's last live slot add
    exact zeros to every sum, so they are dropped first.
    """
    n_bands = edges.shape[0] - 1
    live = int(valid.sum(dim=1).max()) if valid.numel() else 0
    idx, dist, valid = idx[:, :live], dist[:, :live], valid[:, :live]
    n, K = idx.shape
    bid = torch.searchsorted(edges, dist.contiguous(), right=True) - 1
    in_band = valid & (bid >= 0) & (bid < n_bands) & (dist < edges[-1])
    bid = torch.where(in_band, bid, torch.full_like(bid, n_bands))
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    deg = torch.zeros((n, n_bands + 1), dtype=torch.int64,
                      device=idx.device).scatter_add_(
        1, bid, torch.ones_like(bid))[:, :n_bands].to(torch.float32)
    invdeg = torch.where(deg > 0, 1.0 / torch.clamp_min(deg, 1.0),
                         torch.zeros_like(deg))
    has = (deg > 0).to(torch.float32)
    wt = torch.gather(torch.nn.functional.pad(invdeg, (0, 1)), 1, bid)
    S0 = has.sum(dim=0)
    cross_inv = torch.zeros(n_bands, dtype=torch.float32, device=idx.device)
    col = torch.zeros((n, n_bands), dtype=torch.float32, device=idx.device)
    for k in range(K):
        inv_j = invdeg[idx[:, k]]
        sel = _band_onehot(bid[:, k], n_bands)
        cross_inv = cross_inv + (sel * invdeg * inv_j).sum(dim=0)
        col = col + sel * inv_j
    S1 = (invdeg * has).sum(dim=0) + cross_inv
    S2 = ((has + col) ** 2).sum(dim=0)
    return CorrelogramBands(idx=idx, bid=bid, wt=wt, invdeg=invdeg, S0=S0,
                            S1=S1, S2=S2)


def correlogram_band_num(bands: CorrelogramBands, Zrow: torch.Tensor,
                         nbr) -> torch.Tensor:
    """num[b, g] = Σ_i Σ_{k∈b} w_ik · zrow_ig · z_nbr(i,k),g for every band:
    one pass over the slots, each slot's [N, G] product summed into its
    band by one [B, N] × [N, G] product. ``nbr(ids)`` returns the neighbour
    rows of ``ids`` (the permuted table's rows in a draw)."""
    n_bands = bands.S0.shape[0]
    acc = torch.promote_types(Zrow.dtype, torch.float32)
    num = torch.zeros((n_bands, Zrow.shape[1]), dtype=acc, device=Zrow.device)
    for k in range(bands.idx.shape[1]):
        cross = Zrow * nbr(bands.idx[:, k]) * bands.wt[:, k:k + 1].to(Zrow.dtype)
        sel = _band_onehot(bands.bid[:, k], n_bands).to(cross.dtype)
        num = num + sel.T @ cross
    return num


def correlogram_kernel(idx: torch.Tensor, dist: torch.Tensor,
                       valid: torch.Tensor, Z: torch.Tensor,
                       edges: torch.Tensor, seed: int,
                       n_permutations: int = 0):
    """Moran's I over every distance band in one pass (reference
    ``correlogram_kernel``, spatialcore_tpu/ops/moran.py:629-765).

    ``(idx, dist, valid)`` is one radius search (:func:`ops.graph.
    radius_neighbors` at ``edges[-1]``), ``Z`` [N, G] the standardized
    values, ``edges`` [B+1] increasing band boundaries (float32). Band
    weights and moments come from :func:`correlogram_bands`; the observed
    I [B, G] from one slot loop (:func:`correlogram_band_num`) and the
    analytic randomization z / two-sided p with each band's moments and
    each gene's kurtosis. With ``n_permutations`` one permutation a draw
    (``permutation(fold_in(key_for(seed, "perm_global", 0), d), n)``, the
    slot null's stream) serves every band: |I_perm| ≥ |I_obs| counts, p =
    (count + 1)/(P + 1). Returns ``(I_obs, z, p_norm, p_sim, S0)``; a band
    with no pairs has S0 = 0, I = z = 0 and p = 1. Sums reduce in another
    order than XLA's, so I, z and p agree to float32 rounding and p_sim
    can differ only where a draw ties the observed value within it.
    """
    n, G = Z.shape
    bands = correlogram_bands(idx, dist, valid, edges.to(torch.float32))
    S0, S1, S2 = bands.S0, bands.S1, bands.S2
    den = (Z * Z).sum(dim=0)
    den = torch.where(den > 0, den, torch.ones_like(den))
    S0_safe = torch.where(S0 > 0, S0, torch.ones_like(S0))
    scale = (n / S0_safe)[:, None]
    I_obs = scale * correlogram_band_num(bands, Z, lambda ik: Z[ik]) / den[None, :]

    nf = float(n)
    z2 = (Z * Z).sum(dim=0)
    z4 = (Z ** 4).sum(dim=0)
    b2 = nf * z4 / torch.where(z2 > 0, z2 * z2, torch.ones_like(z2))
    EI = -1.0 / (nf - 1.0)
    S0b, S1b, S2b = S0_safe[:, None], S1[:, None], S2[:, None]
    numv = (nf * ((nf * nf - 3.0 * nf + 3.0) * S1b - nf * S2b
                  + 3.0 * S0b * S0b)
            - b2[None, :] * ((nf * nf - nf) * S1b - 2.0 * nf * S2b
                             + 6.0 * S0b * S0b))
    denv = (nf - 1.0) * (nf - 2.0) * (nf - 3.0) * S0b * S0b
    varI = torch.clamp_min(numv / denv - EI ** 2, 1e-30)
    z_sc = (I_obs - EI) / torch.sqrt(varI)
    p_norm = p_from_z(z_sc, "two-sided")

    empty = (S0 == 0)[:, None]
    I_obs = torch.where(empty, 0.0, I_obs)
    z_sc = torch.where(empty, 0.0, z_sc)
    p_norm = torch.where(empty, 1.0, p_norm)
    if n_permutations == 0:
        return I_obs, z_sc, p_norm, torch.ones_like(p_norm), S0

    base = key_for(seed, "perm_global", 0)
    abs_obs = I_obs.abs()
    count = torch.zeros(I_obs.shape, dtype=torch.int32, device=Z.device)
    for step in range(n_permutations):
        perm = permutation(fold_in(base, step), n, device=Z.device)
        num_p = correlogram_band_num(bands, Z[perm], lambda ik: Z[perm[ik]])
        I_p = scale * num_p / den[None, :]
        count += (I_p.abs() >= abs_obs).to(torch.int32)
    p_sim = torch.where(empty, 1.0, _p_from_counts(count, n_permutations))
    return I_obs, z_sc, p_norm, p_sim, S0
