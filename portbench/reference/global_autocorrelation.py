"""Reference of the ``global_autocorrelation``: global Moran's I and Geary's
C on a radius graph, and their two permutation nulls from one stream of
draws.

Plain torch in float64 (or exact integers), with TF32 off; it imports
neither JAX nor either package nor any kernel.

- The graph: cell j is a neighbour of cell i when their distance,
  computed in float32 from the float32 coordinates (each difference, each
  square, their sum and the root a float32 operation), is at most the
  radius as float32, as the program compares them; the nearest
  ``k_max + 1`` are searched (``knn.knn``), and a cell with more than
  ``k_max`` in radius keeps its ``k_max`` nearest (the program raises
  there instead). Each neighbour weighs 1/degree; an isolated cell's row
  is empty.
- Moran's I = (n / S0) Σ_ij w_ij z_i z_j / Σ z², Geary's C =
  (n − 1) Σ_ij w_ij (z_i − z_j)² / (2 S0 Σ z²), S0 = Σ w_ij, on the
  population z-scores, exact.
- The nulls: draw d places the value of cell π_d(c) at cell c
  (``draws.py``, the global stream ``perm_feistel``), the same draws for
  both statistics. Moran's draw is I of the placement; Geary's is written
  as (n − 1)(Σ_i (r_i + c_i) z_πi² − 2 Σ_ij w_ij z_πi z_πj) / (2 S0 Σ z²),
  r_i and c_i the row and column sums of w, which equals the published
  form on every placement (a permutation leaves Σ z² unchanged).
- Precisions (``stats``): the null's values and its cross weights at the
  null's precision; the degree term's weights r_i + c_i stay exact (the
  program keeps them in float32), Σ z² stays exact. A float null compares
  every draw with the observed value, an integer null with its own
  identity placement. ``count_lo`` / ``count_hi`` bound the draws at or
  beyond it ("greater" for I, "less" for C), a band of ``stats.TIE`` of
  each sum's magnitude counting as a tie.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.reference import common
from portbench.reference import draws as draws_mod
from portbench.reference import knn as knn_mod
from portbench.reference import stats

F64 = torch.float64
sample = common.sample
#: a pair this close to the radius (a share of it) may fall either side
#: of it when the float32 distance is formed in another order
RADIUS_TIE = 1e-5


def radius_graph(coords: torch.Tensor, radius: float, k_max: int,
                 precision: str):
    """(idx int64 [N, D], w float64 [N, D], valid bool [N, D]) of the
    radius graph on the coordinates as ``precision`` stores them, D the
    largest degree (dead slots: index 0, weight 0)."""
    xy = stats.rounded(coords.to(F64), precision).to(torch.float32)
    n = xy.shape[0]
    idx, d2 = knn_mod.knn(xy, min(k_max + 1, n - 1))
    valid = torch.sqrt(d2) <= torch.tensor(radius, dtype=torch.float32)
    idx, valid = idx[:, :k_max], valid[:, :k_max]
    D = max(int(valid.sum(dim=1).max()), 1)
    idx, valid = idx[:, :D], valid[:, :D]
    deg = valid.sum(dim=1, keepdim=True).to(F64)
    w = torch.where(valid, 1.0 / deg.clamp_min(1.0), torch.zeros_like(deg))
    return torch.where(valid, idx, torch.zeros_like(idx)), w, valid


def _observed(Z, idx, w, precision: str, control: bool):
    """(I, its magnitude, C, its magnitude) per gene: exact (``control``:
    from the values and weights rounded to ``precision``, then the
    results rounded to it)."""
    n = Z.shape[0]
    V = stats.rounded(Z, precision) if control else Z
    W = stats.rounded(w, precision) if control else w
    S0 = float(w.sum())
    den = (Z * Z).sum(dim=0)
    den = torch.where(den > 0, den, torch.ones_like(den))
    lag = stats.lag(idx, W, V)
    A = V.abs()
    cross, c_mag = (V * lag).sum(dim=0), (A * stats.lag(idx, W, A)).sum(dim=0)
    sq = torch.zeros_like(cross)
    for s in range(idx.shape[1]):
        sq += (W[:, s:s + 1] * (V - V[idx[:, s]]) ** 2).sum(dim=0)
    I = (n / S0) * cross / den
    C = (n - 1) * sq / (2.0 * S0 * den)
    if control:
        I, C = stats.rounded(I, precision), stats.rounded(C, precision)
    # C's terms are all >= 0: it is its own magnitude
    return I, (n / S0) * c_mag / den, C, C


def degree_sums(idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """r_i + c_i: each cell's row and column sums of w (float64 [N])."""
    c = torch.zeros(idx.shape[0], dtype=F64, device=w.device)
    return w.sum(dim=1) + c.index_add_(0, idx.reshape(-1), w.reshape(-1))


def placement(op: stats.Operator, rc: torch.Tensor, den: torch.Tensor,
              S0: float, perm=None):
    """(I, |I| terms, C, |C| terms) per gene of one placement of ``op``'s
    values (None: the identity), C in its degree form."""
    n = op.V.shape[0]
    c, c_mag = op.cross(perm)
    V = (op.V if perm is None else op.V[perm]).to(F64)
    sq = (rc[:, None] * V * V).sum(dim=0)
    if op.integer:
        sq = sq * op.s * op.s
    g = (n - 1) / (2.0 * S0 * den)
    return ((n / S0) * c / den, (n / S0) * c_mag / den,
            g * (sq - 2.0 * c), g * (sq + 2.0 * c_mag))


def global_moran_geary(Z: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                       *, obs_precision: str, null_precision: str, seed: int,
                       n_permutations: int, control: bool = False,
                       draw_batch: int = 16) -> Dict[str, torch.Tensor]:
    """Observed I and C and their nulls per column: ``I``, ``C``, and per
    statistic ``count_lo``, ``count_hi``, ``p``, ``null_std``."""
    n = Z.shape[0]
    S0 = float(w.sum())
    den = (Z * Z).sum(dim=0)
    den = torch.where(den > 0, den, torch.ones_like(den))
    rc = degree_sums(idx, w)
    I, I_mag, C, C_mag = _observed(Z, idx, w, obs_precision, control)
    op = stats.Operator(Z, idx, w, null_precision)
    # a float null compares with the observed value, an integer one with
    # its own identity placement
    target = (placement(op, rc, den, S0) if op.integer
              else (I, I_mag, C, C_mag))
    out = {"I": I, "C": C}
    acc = {s: [torch.zeros_like(den, dtype=torch.int64) for _ in range(3)]
           + [torch.zeros_like(den), torch.zeros_like(den)]
           for s in ("moran", "geary")}
    for d0 in range(0, n_permutations, draw_batch):
        ds = range(d0, min(d0 + draw_batch, n_permutations))
        for perm in draws_mod.permutations(seed, "perm_feistel", ds, n,
                                           Z.device):
            v = placement(op, rc, den, S0, perm)
            for j, s in enumerate(("moran", "geary")):
                x, x_mag = v[2 * j], v[2 * j + 1]
                t, t_mag = target[2 * j], target[2 * j + 1]
                band = stats.TIE * (x_mag + t_mag)
                lo, hi, exact, s1, s2 = acc[s]
                if s == "moran":        # "greater"
                    lo += x > t + band
                    hi += x >= t - band
                    exact += x >= t
                else:                   # "less"
                    lo += x < t - band
                    hi += x <= t + band
                    exact += x <= t
                s1 += x
                s2 += x * x
    for s, (lo, hi, exact, s1, s2) in acc.items():
        mean = s1 / n_permutations
        out[s] = {"count_lo": lo, "count_hi": hi,
                  "p": (exact + 1.0) / (n_permutations + 1.0),
                  "null_std": torch.sqrt(torch.clamp_min(
                      s2 / n_permutations - mean * mean, 0.0))}
    return out


def expected(section, traffic, seed, smp, lower=False):
    """The reference's answers (``lower``: the control's, one precision
    step down at every stage) on the sampled genes and cells."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        prec = common.precisions(traffic, lower)
        coords = section["coords"]
        g = traffic["graph"]
        idx, w, valid = radius_graph(coords, float(g["radius_um"]),
                                     int(g["k_max"]), prec["graph"])
        Z = stats.standardize(common._columns(section, smp["genes"]))
        r = global_moran_geary(Z, idx, w, obs_precision=prec["obs"],
                               null_precision=prec["null"],
                               seed=int(section["null_seed"]),
                               n_permutations=int(traffic["n_permutations"]),
                               control=lower)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    cells = torch.as_tensor(smp["cells"], device=coords.device)
    return {"nbr": idx[cells], "w": w[cells], "valid": valid[cells],
            "I": r["I"], "C": r["C"], "p_moran": r["moran"]["p"],
            "p_geary": r["geary"]["p"], "moran": r["moran"],
            "geary": r["geary"]}


def graph_gap(out: dict, ref: dict, coords: torch.Tensor, cells,
              radius: float) -> float:
    """The larger of: the share of the sampled cells whose neighbour set
    differs from the reference's at a pair farther than ``RADIUS_TIE`` of
    the radius from it; and the largest gap of a weight from 1/degree (0
    on a dead slot) as a share of 1/degree."""
    dev = coords.device
    rows = torch.as_tensor(cells, device=dev)
    xy = coords.to(F64)

    def off_radius(nbr, keep):
        d = torch.sqrt(((xy[nbr] - xy[rows][:, None, :]) ** 2).sum(-1))
        return keep & ((d - radius).abs() > RADIUS_TIE * radius)

    o_nbr, o_ok = out["nbr"].to(dev), out["valid"].to(dev)
    r_nbr, r_ok = ref["nbr"].to(dev), ref["valid"].to(dev)
    o_in_r = ((o_nbr[:, :, None] == r_nbr[:, None, :])
              & r_ok[:, None, :]).any(-1)
    r_in_o = ((r_nbr[:, :, None] == o_nbr[:, None, :])
              & o_ok[:, None, :]).any(-1)
    differs = (off_radius(o_nbr, o_ok & ~o_in_r).any(1)
               | off_radius(r_nbr, r_ok & ~r_in_o).any(1))
    deg = o_ok.sum(dim=1, keepdim=True).to(F64).clamp_min(1.0)
    target = torch.where(o_ok, 1.0 / deg, torch.zeros_like(deg))
    wgap = ((out["w"].to(dev).to(F64) - target).abs() * deg).max()
    return float(torch.maximum(differs.to(F64).mean(), wgap))


def readings(out, ref, section, smp, traffic) -> Dict[str, float]:
    P = int(traffic["n_permutations"])
    dev = ref["I"].device
    o = {k: v.to(dev) for k, v in out.items() if isinstance(v, torch.Tensor)}
    nums = {"graph_gap": graph_gap(o, ref, section["coords"], smp["cells"],
                                   float(traffic["graph"]["radius_um"]))}
    for s, col in (("moran", "I"), ("geary", "C")):
        sd = ref[s]["null_std"].clamp_min(1e-300)
        nums[f"obs_gap.{s}"] = float(((o[col].to(F64) - ref[col]).abs()
                                      / sd).max())
        nums[f"p_gap.{s}"] = float(common._outside(
            common._counts(o[f"p_{s}"], P), ref[s]).to(F64).mean())
    return nums
