"""Plain statistics of the reference: standardization, precisions, Moran's I
(global and local) and its permutation nulls, Benjamini-Hochberg and the
LISA quadrants.

Everything is float64 (or exact integers) unless a precision names a
rounding. A precision is what a configuration states for one stage:

- "f32": the exact value (this reference is float64 throughout);
- "bf16": every stored value rounded to bfloat16;
- "int8" / "int4" / "int2": per-gene symmetric codes in [-q, q],
  q = 127 / 7 / 1, scale min(max|z|, 8)/q, round half to even; weights
  as per-row int8 codes (the row's largest weight is 127).

The null of an integer precision compares every draw with the same
quantized statistic at the identity placement; a float precision compares
with the observed statistic.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import draws as draws_mod

F64 = torch.float64
#: one step below each precision a configuration can state: the control
LOWER = {"f32": "bf16", "bf16": "int8", "f16": "fp8", "int8": "int4",
         "int4": "int2"}
_FLOATS = {"bf16": torch.bfloat16, "f16": torch.float16,
           "fp8": torch.float8_e4m3fn}
QMAX = {"int8": 127, "int4": 7, "int2": 1}
CLIP = 8.0


def standardize(X: torch.Tensor) -> torch.Tensor:
    """Population z-scores per column; a constant column is all zeros."""
    X = X.to(F64)
    Xc = X - X.mean(dim=0, keepdim=True)
    sd = torch.sqrt((Xc * Xc).mean(dim=0, keepdim=True))
    return Xc / torch.where(sd > 0, sd, torch.ones_like(sd))


def rounded(v: torch.Tensor, precision: str) -> torch.Tensor:
    """``v`` as the float precision stores it, back in float64."""
    if precision in _FLOATS:
        return v.to(_FLOATS[precision]).to(F64)
    if precision in ("f32", "f64"):
        return v.to(F64)
    raise ValueError(f"not a float precision: {precision}")


def codes(Z: torch.Tensor, precision: str):
    """(int32 codes, float64 per-gene scale) of a standardized Z."""
    q = QMAX[precision]
    s = torch.clamp_max(Z.abs().max(dim=0).values, CLIP) / q
    s = torch.where(s > 0, s, torch.ones_like(s))
    return torch.clamp(torch.round(Z / s), -q, q).to(torch.int32), s


def weight_codes(w: torch.Tensor):
    """(int32 codes [N, k], float64 row scale [N]) of row weights."""
    w = w.to(F64)
    rmax = w.max(dim=1).values
    sw = torch.where(rmax > 0, rmax / 127.0, torch.ones_like(rmax))
    return torch.clamp(torch.round(w / sw[:, None]), 0, 127).to(torch.int32), sw


def lag(idx: torch.Tensor, w: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Σ over the k slots of w · V[neighbour]: [N, G] (w of V's dtype)."""
    out = torch.zeros((idx.shape[0], V.shape[1]), dtype=V.dtype,
                      device=V.device)
    for s in range(idx.shape[1]):
        out += w[:, s:s + 1] * V[idx[:, s]]
    return out


#: a draw's value and the value it is compared with are sums the program
#: forms in float32 (a global null's integer rows too); where they lie
#: closer than this share of the sums' magnitude (Σ |terms|) they are a tie
#: that rounding may decide either way. A local integer null compares
#: exact integers: no band.
TIE = 1e-5


class Operator:
    """One precision's values and weights of Moran's I on a graph."""

    def __init__(self, Z: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                 precision: str):
        self.precision = precision
        self.idx = idx
        self.integer = precision in QMAX
        if self.integer:
            self.V, self.s = codes(Z, precision)
            self.W, self.sw = weight_codes(w)
        else:
            self.V = rounded(Z, precision)
            self.W = rounded(w, precision)

    def rows(self, perm=None):
        """(v_c · Σ_d w_cd v_d, |v_c| · Σ_d w_cd |v_d|) of the placement
        ``perm`` (None: identity) per cell and gene: exact integers for the
        integer precisions."""
        V = self.V if perm is None else self.V[perm]
        r = V * lag(self.idx, self.W, V)
        A = V.abs()
        return r, A * lag(self.idx, self.W, A)

    def cross(self, perm=None):
        """(Σ_c v_c · Σ_d w_cd v_d, its magnitude) per gene, in z units:
        for the integer precisions the exact integer total times the row
        and gene scales."""
        r, mag = self.rows(perm)
        if not self.integer:
            return r.sum(dim=0), mag.sum(dim=0)
        f = self.s ** 2
        if bool((self.sw == self.sw[0]).all()):
            # one row scale: the integer totals are exact, then one product
            return (r.to(torch.int64).sum(dim=0).to(F64) * self.sw[0] * f,
                    mag.to(torch.int64).sum(dim=0).to(F64) * self.sw[0] * f)
        sw = self.sw[:, None]
        return ((r.to(F64) * sw).sum(dim=0) * f,
                (mag.to(F64) * sw).sum(dim=0) * f)


def _tally(v, v_mag, target, t_mag):
    """(strictly beyond the target, at or beyond it), a rounding band of
    TIE · (both magnitudes) counting as a tie."""
    band = TIE * (v_mag + t_mag)
    return (v > target + band), (v >= target - band)


def global_moran(Z: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, *,
                 obs_precision: str, null_precision: str, seed: int,
                 n_permutations: int, control: bool = False,
                 draw_batch: int = 16) -> Dict[str, torch.Tensor]:
    """Observed Moran's I and its permutation null ("greater") per column.

    ``w`` are the exact row weights. The observed value is exact and
    delivered at ``obs_precision`` (the control: computed at it from
    rounded values); the draws run at ``null_precision``. ``count_lo`` /
    ``count_hi`` bound the draws at or beyond the target: equal for the
    integer nulls, a rounding band apart for the float ones; ``p`` counts
    every draw at or beyond it."""
    n = Z.shape[0]
    S0 = float(w.to(F64).sum())
    den = (Z * Z).sum(dim=0)
    den = torch.where(den > 0, den, torch.ones_like(den))
    scale = (n / S0) / den
    obs_op = Operator(Z, idx, w, obs_precision if control else "f32")
    c, c_mag = obs_op.cross()
    obs, obs_mag = scale * c, scale * c_mag
    if obs_precision not in QMAX:
        obs = rounded(obs, obs_precision)
    op = Operator(Z, idx, w, null_precision)
    if op.integer:
        # the integer null compares with its own identity placement, in
        # the float32 sums the program forms from exact integer rows
        c, c_mag = op.cross()
        target, t_mag = scale * c, scale * c_mag
    else:
        target, t_mag = obs, obs_mag
    lo = torch.zeros_like(obs, dtype=torch.int64)
    hi = torch.zeros_like(lo)
    exact = torch.zeros_like(lo)
    s1 = torch.zeros_like(obs)
    s2 = torch.zeros_like(obs)
    for d0 in range(0, n_permutations, draw_batch):
        ds = range(d0, min(d0 + draw_batch, n_permutations))
        perms = draws_mod.permutations(seed, "perm_feistel", ds, n, Z.device)
        for perm in perms:
            c, c_mag = op.cross(perm)
            v = scale * c
            a, b = _tally(v, scale * c_mag, target, t_mag)
            lo += a
            hi += b
            exact += v >= target
            s1 += v
            s2 += v * v
    mean = s1 / n_permutations
    std = torch.sqrt(torch.clamp_min(s2 / n_permutations - mean * mean, 0.0))
    return {"I": obs, "count_lo": lo, "count_hi": hi,
            "p": (exact + 1.0) / (n_permutations + 1.0),
            "null_mean": mean, "null_std": std}


def local_moran(Z: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, *,
                obs_precision: str, null_precision: str, seed: int,
                n_permutations: int, control: bool = False,
                draw_batch: int = 8) -> Dict[str, torch.Tensor]:
    """Local Moran's I (I = z · lag) and its total-permutation null
    (two-sided, |I|) per cell and column, with ``count_lo`` / ``count_hi``
    as :func:`global_moran` has them. The observed I, z and lag are exact
    and I is delivered at ``obs_precision`` (the control: all computed at
    it)."""
    n = Z.shape[0]
    obs_op = Operator(Z, idx, w, obs_precision if control else "f32")
    if obs_op.integer:
        z_obs = obs_op.V.to(F64) * obs_op.s
        lag_obs = lag(idx, obs_op.W.to(F64) * obs_op.sw[:, None], z_obs)
        I = z_obs * lag_obs
    else:
        z_obs = obs_op.V
        lag_obs = lag(idx, obs_op.W, z_obs)
        if control:
            lag_obs = rounded(lag_obs, obs_precision)
        I = rounded(z_obs * lag_obs, obs_precision)
    op = Operator(Z, idx, w, null_precision)
    r, t_mag = op.rows()
    # the integer null compares exact integers with its identity placement
    target = r.abs() if op.integer else I.abs()
    lo = torch.zeros(I.shape, dtype=torch.int32, device=Z.device)
    hi = torch.zeros_like(lo)
    exact = torch.zeros_like(lo)
    for d0 in range(0, n_permutations, draw_batch):
        ds = range(d0, min(d0 + draw_batch, n_permutations))
        perms = draws_mod.permutations(seed, "perm_feistel_local", ds, n,
                                       Z.device)
        for perm in perms:
            r, mag = op.rows(perm)
            v = r.abs()
            if op.integer:
                a = v > target
                b = v >= target
            else:
                a, b = _tally(v, mag, target, t_mag)
            lo += a
            hi += b
            exact += v >= target
    return {"I": I, "z": z_obs, "lag": lag_obs, "count_lo": lo,
            "count_hi": hi, "p": (exact + 1.0) / (n_permutations + 1.0)}


def bh(p: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """Benjamini-Hochberg adjusted p per column (over the rows), at
    ``precision`` ("f32": float64 arithmetic; a float below it: each
    product and the result rounded to it)."""
    p = p.to(F64)
    m = p.shape[0]
    order = torch.argsort(p, dim=0, stable=True)
    ps = torch.gather(p, 0, order)
    ranks = torch.arange(1, m + 1, dtype=F64, device=p.device)[:, None]
    # adjusted values above 1 are 1: clamped first, so that no precision
    # overflows on m / rank
    scaled = rounded(torch.clamp_max(ps * m / ranks, 1.0), precision)
    adj = torch.flip(torch.cummin(torch.flip(scaled, [0]), dim=0).values, [0])
    adj = torch.clamp_max(adj, 1.0)
    return rounded(torch.empty_like(adj).scatter_(0, order, adj), precision)


def quadrants(z: torch.Tensor, lg: torch.Tensor, p_adj: torch.Tensor,
              alpha: float) -> torch.Tensor:
    """LISA quadrant codes: 0 NS, 1 HH, 2 LL, 3 HL, 4 LH; NS where
    p_adj >= alpha or z or the lag is 0."""
    q = torch.zeros(z.shape, dtype=torch.int8, device=z.device)
    q[(z > 0) & (lg > 0)] = 1
    q[(z < 0) & (lg < 0)] = 2
    q[(z > 0) & (lg < 0)] = 3
    q[(z < 0) & (lg > 0)] = 4
    q[p_adj >= alpha] = 0
    return q
