"""The distance-band Moran correlogram in the port against the JAX package,
on the CPU.

Tolerances, and why:
- S0 (rows with pairs, a count): bitwise; S1 / S2: rtol 1e-6 (float32
  sums over cells, reduced in another order than XLA's);
- I / z: rtol 1e-5; p_norm rtol 1e-5 plus 1e-6 absolute (a two-sided tail
  1 − Φ(|z|) loses its relative precision where it is small);
- p_sim: bitwise except on draws that tie the observed |I| within float32
  rounding, which the reference's docstring allows; the test counts such
  cells and requires none on continuous data;
- the public DataFrame: on integer lattices, where both packages see the
  same distances and the default band edges come out bitwise, every
  distance stays more than 1e-4 from a band edge (asserted), and the
  columns hold to the tolerances above.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import spatialcore_tpu.spatial as scts
from spatialcore_tpu import SpatialData as JSpatialData
from spatialcore_tpu.ops import graph as jg
from spatialcore_tpu.ops import moran as jm
import spatialcore_tpu_torch as sctt
import spatialcore_tpu_torch.spatial as sctts
from spatialcore_tpu_torch.core import get_operations
from spatialcore_tpu_torch.ops import moran as tm

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _values(coords, g, seed):
    rng = np.random.default_rng(seed)
    n = coords.shape[0]
    X = np.concatenate(
        [2 * np.sin(coords[:, :1] / (4.0 + j)) + rng.normal(0, 0.6, (n, 1))
         for j in range(g // 2)] + [rng.normal(0, 1, (n, g - g // 2))],
        axis=1).astype(np.float32)
    return X


def _edges_clear_of(d, targets, margin=1e-4, window=0.05):
    """Band edges near ``targets``, each at the middle of the widest gap
    between the sorted distances ``d`` within ``window`` of its target."""
    d = np.sort(d[np.isfinite(d)].astype(np.float64))
    edges = []
    for t in targets:
        sel = d[(d > t - window) & (d < t + window)]
        pts = np.concatenate([[t - window], sel, [t + window]])
        i = int(np.argmax(np.diff(pts)))
        edges.append(0.5 * (pts[i] + pts[i + 1]))
    edges = np.asarray(edges, np.float32)
    assert (np.abs(d[:, None] - edges[None, :].astype(np.float64))
            > margin).all()
    return edges


@pytest.fixture(scope="module")
def search():
    rng = np.random.default_rng(3)
    c = rng.uniform(0, 100, (1500, 2)).astype(np.float32)
    idx, dist, valid = jg.radius_neighbors(jnp.asarray(c), 8.5, 64)
    d = np.asarray(dist)
    edges = np.concatenate([[0.0], _edges_clear_of(d, [2.0, 3.5, 5.0, 6.5]),
                            _edges_clear_of(d, [8.2])]).astype(np.float32)
    assert (d[np.isfinite(d)] < 8.5).all()
    Zj, _ = jm.standardize(jnp.asarray(_values(c, 8, 1)))
    return dict(jax=(idx, dist, valid, Zj, jnp.asarray(edges)),
                torch=(torch.as_tensor(np.asarray(idx).astype(np.int64)),
                       torch.as_tensor(np.array(dist)),
                       torch.as_tensor(np.array(valid)),
                       torch.as_tensor(np.array(Zj)), torch.as_tensor(edges)))


def _tied_cells(got, want):
    return int((np.asarray(got) != np.asarray(want)).sum())


@pytest.mark.parametrize("P", [0, 19])
def test_correlogram_kernel_matches_reference(search, P):
    Ij, zj, pnj, psj, S0j = (np.asarray(a) for a in jm.correlogram_kernel(
        *search["jax"], jnp.uint32(4), n_permutations=P))
    It, zt, pnt, pst, S0t = (_np(a) for a in tm.correlogram_kernel(
        *search["torch"], 4, n_permutations=P))
    np.testing.assert_array_equal(S0t, S0j)
    assert (S0t > 0).all()
    np.testing.assert_allclose(It, Ij, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(zt, zj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pnt, pnj, rtol=1e-5, atol=1e-6)
    assert _tied_cells(pst, psj) == 0
    if P:
        assert (pst[:, :4][:2] <= 1.0 / (P + 1) + 1e-6).all()   # smooth genes


def test_correlogram_moments_match_reference(search):
    """S0/S1/S2 against the reference's (the kernel's last output is S0; S1
    and S2 come from the same sums the analytic variance uses: the reference
    is run on a one-gene Z, whose z-score pins them)."""
    idx, dist, valid, Z, edges = search["torch"]
    bands = tm.correlogram_bands(idx, dist, valid, edges)
    ij, dj, vj, Zj, ej = search["jax"]
    # the reference's sums, recomputed with numpy in float64 from its arrays
    idx_np, d_np, v_np = (np.asarray(a) for a in (ij, dj, vj))
    e = np.asarray(ej)
    bid = np.searchsorted(e, d_np, side="right") - 1
    inb = v_np & (bid >= 0) & (bid < len(e) - 1) & (d_np < e[-1])
    S1w, S2w = [], []
    for b in range(len(e) - 1):
        m = inb & (bid == b)
        deg = m.sum(1).astype(np.float64)
        inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
        j = np.where(m, idx_np, 0)
        S1w.append((inv * (deg > 0)).sum() + (m * inv[:, None] * inv[j]).sum())
        col = (m * inv[j]).sum(1)
        S2w.append((((deg > 0) + col) ** 2).sum())
    np.testing.assert_allclose(_np(bands.S1), S1w, rtol=1e-6)
    np.testing.assert_allclose(_np(bands.S2), S2w, rtol=1e-6)
    # dropping the all-dead columns past the widest row leaves the sums as
    # they are: the full-width search gives the same bits
    wide = tm.correlogram_bands(
        torch.nn.functional.pad(idx, (0, 9), value=-1),
        torch.nn.functional.pad(dist, (0, 9), value=float("inf")),
        torch.nn.functional.pad(valid, (0, 9)), edges)
    for f in ("S0", "S1", "S2"):
        assert torch.equal(getattr(wide, f), getattr(bands, f)), f


def _lattice_pair(side=40, g=6, seed=0):
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    c = np.stack([xs.ravel(), ys.ravel()], axis=1).astype(np.float32)
    X = _values(c, g, seed)
    X[:, 2] = 1.5                                   # zero variance
    var = pd.DataFrame(index=[f"G{j}" for j in range(g)])
    a = JSpatialData(X=X.copy(), var=var.copy())
    a.obsm["spatial"] = c
    b = sctt.SpatialData(X=X.copy(), var=var.copy())
    b.obsm["spatial"] = c.copy()
    return a, b, c


def _frames_close(da, db, P):
    assert list(db.columns) == list(da.columns)
    for col in ("band_lo", "band_hi", "gene"):
        assert list(db[col]) == list(da[col]), col
    np.testing.assert_allclose(db["I"], da["I"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(db["z_score"], da["z_score"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(db["p_value"], da["p_value"], rtol=1e-5,
                               atol=1e-6)
    if P:
        assert _tied_cells(db["p_sim"], da["p_sim"]) == 0


def _clear_of_edges(c, edges, margin=1e-4):
    d = np.sqrt(((c[:, None, :].astype(np.float64) - c[None]) ** 2).sum(-1))
    d = d[(d > 0) & (d <= edges[-1] + 1)]           # pairs, not self
    return (np.abs(d[:, None] - np.asarray(edges)[None, :]) > margin).all()


def test_moran_correlogram_default_bands_match_reference():
    a, b, c = _lattice_pair()
    scts.moran_correlogram(a)
    sctts.moran_correlogram(b, device="cpu")
    pa, pb = (dict(d.uns["moran_correlogram_params"]) for d in (a, b))
    for p in (pa, pb):
        p.pop("computation_time_seconds")
    assert pb == pa                                  # the same band edges
    assert _clear_of_edges(c, pa["bands"])
    _frames_close(a.uns["moran_correlogram"], b.uns["moran_correlogram"], 0)
    db = b.uns["moran_correlogram"]
    zero = db[db["gene"] == "G2"]
    assert (zero["I"] == 0).all() and (zero["p_value"] == 1).all()
    assert get_operations(b)[-1]["function"] == "moran_correlogram"


def test_moran_correlogram_bands_and_permutations_match_reference():
    """Explicit edges with an empty first band (no lattice distance is
    below 1): skipped with the reference's warning; 19 draws."""
    a, b, c = _lattice_pair(side=36, seed=1)
    bands = [0.0, 0.5, 1.2, 2.1, 3.3]
    assert _clear_of_edges(c, bands)
    kw = dict(bands=bands, n_permutations=19, seed=6, genes=["G0", "G1", "G4"])
    scts.moran_correlogram(a, **kw)
    seen = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: seen.append(record.getMessage())
    log = logging.getLogger("spatialcore_tpu_torch.spatial.autocorrelation")
    log.addHandler(handler)
    try:
        sctts.moran_correlogram(b, device="cpu", **kw)
    finally:
        log.removeHandler(handler)
    assert "band [0.0, 0.5) has no pairs; skipped" in seen
    da, db = a.uns["moran_correlogram"], b.uns["moran_correlogram"]
    assert sorted(set(db["band_lo"])) == [0.5, 1.2, 2.1]
    _frames_close(da, db, 19)


def test_moran_correlogram_refusals():
    _, b, _ = _lattice_pair(side=12, g=4)
    with pytest.raises(ValueError, match="increasing edges"):
        sctts.moran_correlogram(b, bands=[0.0, 2.0, 1.0], device="cpu")
    with pytest.raises(ValueError, match="more than k_max=4"):
        sctts.moran_correlogram(b, bands=[0.0, 1.5, 3.0], k_max=4, device="cpu")
    with pytest.raises(ValueError, match="not found"):
        sctts.moran_correlogram(b, spatial_key="xy", device="cpu")
