"""Radius graphs in the port against the JAX package, on the CPU: the
capped radius search, the radius branch of ``build_graph``, and the radius
route through the banded nulls and the public API.

Tolerances, and why:
- radius neighbours: indices and ``valid`` equal on coordinates where no
  distance lies within 1e-5 of the radius (both packages centre the
  coordinates by a float32 mean summed in another order, which moves a
  distance by up to 2 ulp of the coordinate scale, ROADMAP Queue 3);
  distances within those 2 ulp;
- ``build_graph(radius=...)``: index, weights and mask bitwise (the same
  neighbours; 1/count is one float32 division in both);
- the banded nulls on one plan carried across (``plan_from_numpy``), with
  isolated cells: the int8 local counts and p bitwise against the
  reference's XLA path and its K7 Pallas kernel in interpret mode; the
  global int8 p bitwise against the XLA path and its K2 / K3 Pallas
  kernels in interpret mode (the draws' integer lags are exact and the
  observed value comes from the same operator); bf16 p within 0.05 of
  the XLA path, as tests/test_torch_banded.py holds the kNN plan (the
  reference's XLA path rounds the lag to bf16, the port keeps float32),
  and within one draw of K4 in interpret mode;
- the public functions: Moran's I, E[I] and z rtol 1e-5 (Geary's z, whose
  C − 1 magnifies C's last bits: rtol 1e-4, atol 1e-5); p bitwise for
  ``banded_int8``; LISA planes as tests/test_torch_local_moran.py holds
  them (p within one draw for every entry, equal for >= 99.9%).
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import spatialcore_tpu.spatial as scts
from spatialcore_tpu import SpatialData as JSpatialData
from spatialcore_tpu.ops import banded as jb
from spatialcore_tpu.ops import graph as jg
from spatialcore_tpu.ops import moran as jm
import spatialcore_tpu_torch as sctt
from spatialcore_tpu_torch.ops import banded as tb
from spatialcore_tpu_torch.ops import graph as tg
from spatialcore_tpu_torch.ops import moran as tm

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

B = 64
N_ISOLATED = 5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _coords(n, seed, side=100.0):
    """``n`` uniform cells on [0, side]² plus ``N_ISOLATED`` cells far from
    every other (their radius rows are empty)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, side, (n, 2))
    lone = np.stack([side * 1.5 + 40.0 * np.arange(N_ISOLATED),
                     np.full(N_ISOLATED, side * 1.5)], axis=1)
    return np.concatenate([pts, lone]).astype(np.float32)


def _clear_radius(coords, radius, margin=1e-5):
    """No pairwise distance lies within ``margin`` of the radius."""
    d = np.sqrt(((coords[:, None, :].astype(np.float64)
                  - coords[None, :, :]) ** 2).sum(-1))
    return not (np.abs(d - radius) < margin).any()


def _ulp2(coords):
    return 2 * float(np.spacing(np.abs(coords).max()))


@pytest.mark.parametrize("include_self", [False, True])
@pytest.mark.parametrize("k_max", [32, 64])
def test_radius_neighbors_exact_path_matches_reference(k_max, include_self):
    c = _coords(1500, 1)
    radius = 5.5
    assert _clear_radius(c, radius)
    ij, dj, vj = jg.radius_neighbors(jnp.asarray(c), radius, k_max,
                                     include_self=include_self)
    it, dt, vt = tg.radius_neighbors(c, radius, k_max,
                                     include_self=include_self, device="cpu")
    assert it.dtype == torch.int64 and dt.dtype == torch.float32
    np.testing.assert_array_equal(_np(vt), np.asarray(vj))
    np.testing.assert_array_equal(_np(it), np.asarray(ij).astype(np.int64))
    np.testing.assert_allclose(_np(dt), np.asarray(dj), rtol=0,
                               atol=_ulp2(c))
    assert (_np(it)[~_np(vt)] == -1).all() and np.isinf(_np(dt)[~_np(vt)]).all()
    lone = slice(1500, 1500 + N_ISOLATED)
    assert _np(vt)[lone].sum() == (N_ISOLATED if include_self else 0)


def test_radius_neighbors_grid_path_matches_reference():
    """Above the grid threshold (2D) both packages take the bucket-grid
    search; the threshold is lowered so the case stays small, and the cells
    are uniform (far lone cells send the reference's grid search through
    widening rounds that each compile anew, minutes on the CPU)."""
    c = np.random.default_rng(2).uniform(0, 160, (4000, 2)).astype(np.float32)
    radius = 4.0
    ij, dj, vj = jg.radius_neighbors(c, radius, 24, grid_threshold=3000)
    it, dt, vt = tg.radius_neighbors(torch.as_tensor(c), radius, 24,
                                     grid_threshold=3000)
    near = np.abs(np.asarray(dj) - radius) < 1e-5
    assert not near.any()
    np.testing.assert_array_equal(_np(vt), np.asarray(vj))
    np.testing.assert_array_equal(_np(it), np.asarray(ij).astype(np.int64))
    np.testing.assert_allclose(_np(dt), np.asarray(dj), rtol=0, atol=_ulp2(c))


def test_radius_neighbors_cap_and_size_errors():
    # cell 0 at the centre of a ring of 8 cells at distance 1, plus far cells
    ring = np.stack([np.cos(np.arange(8) * np.pi / 4),
                     np.sin(np.arange(8) * np.pi / 4)], axis=1)
    c = np.concatenate([[[0.0, 0.0]], ring,
                        50.0 + 10.0 * np.arange(12)[:, None]
                        * np.ones((1, 2))]).astype(np.float32)
    for mod in (jg, tg):
        kw = {} if mod is jg else {"device": "cpu"}
        with pytest.raises(ValueError, match="more than k_max=7"):
            mod.radius_neighbors(c, 1.5, 7, **kw)
        # exactly k_max in radius: complete, no error
        idx, _, valid = mod.radius_neighbors(c, 1.01, 8, **kw)
        assert int(np.asarray(_np(valid))[0].sum()) == 8
        with pytest.raises(ValueError, match="needs >= 2 cells"):
            mod.radius_neighbors(c[:1], 1.0, 4, **kw)
    # the messages are the reference's
    msgs = []
    for mod, kw in ((jg, {}), (tg, {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            mod.radius_neighbors(c, 1.5, 7, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # k_max at least n − 1: n − 1 columns, no overflow check
    idx, dist, valid = tg.radius_neighbors(c[:6], 100.0, 10, device="cpu")
    ij, dj, vj = jg.radius_neighbors(c[:6], 100.0, 10)
    assert idx.shape == (6, 5) == np.asarray(ij).shape
    np.testing.assert_array_equal(_np(valid), np.asarray(vj))


def test_build_graph_radius_bitwise():
    c = _coords(1200, 3)
    radius = 5.0
    assert _clear_radius(c, radius)
    gj = jg.build_graph(c, radius=radius, k_max=32)
    gt = tg.build_graph(c, radius=radius, k_max=32, device="cpu")
    np.testing.assert_array_equal(_np(gt.neighbor_idx),
                                  np.asarray(gj.neighbor_idx).astype(np.int64))
    np.testing.assert_array_equal(_np(gt.neighbor_w), np.asarray(gj.neighbor_w))
    np.testing.assert_array_equal(_np(gt.valid), np.asarray(gj.valid))
    np.testing.assert_allclose(_np(gt.distances), np.asarray(gj.distances),
                               rtol=0, atol=_ulp2(c))
    w = _np(gt.neighbor_w)
    assert (w[1200:] == 0).all()                       # isolated rows
    assert (_np(gt.neighbor_idx)[~_np(gt.valid)] == 0).all()
    assert tg.graph_moments(gt) == jg.graph_moments(gj)
    # carried across from the reference's arrays, unchanged
    gc = tg.graph_from_numpy(gj, device="cpu")
    for f in gt._fields:
        np.testing.assert_array_equal(_np(getattr(gc, f)),
                                      np.asarray(getattr(gj, f)), err_msg=f)
    with pytest.raises(ValueError, match="requires k_max"):
        tg.build_graph(c, radius=radius, device="cpu")


# ---------------------------------------------------------------------------
# The radius route through the banded nulls, on one plan
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rplan():
    rng = np.random.default_rng(11)
    c = _coords(1500, 4)
    n = c.shape[0]
    X = np.concatenate(
        [np.sin(c[:, :1] / 9.0) * 2 + rng.normal(0, 0.5, (n, 1))
         for _ in range(6)] + [rng.normal(0, 1, (n, 6))], axis=1
    ).astype(np.float32)
    gj = jg.build_graph(c, radius=5.5, k_max=32)
    pj = jb.build_null_plan(gj, c, block=B)
    Zj, _ = jm.standardize(jnp.asarray(X))
    gt = tg.graph_from_numpy(gj, device="cpu")
    S0 = float(np.asarray(gj.neighbor_w).sum())
    assert S0 == n - N_ISOLATED
    return dict(c=c, gj=gj, gt=gt, pj=pj, pt=tb.plan_from_numpy(pj, "cpu"),
                Zj=Zj, Zt=torch.as_tensor(np.array(Zj)), S0=S0)


def test_radius_plan_bitwise(rplan):
    """The port builds the reference's plan from the radius graph."""
    pt = tb.build_null_plan(rplan["gt"], rplan["c"], block=B)
    for f in rplan["pj"]._fields:
        np.testing.assert_array_equal(_np(getattr(pt, f)),
                                      _np(getattr(rplan["pj"], f)), err_msg=f)
    assert rplan["pj"].far_bmax > 0


def test_radius_band_codes(rplan):
    """Band codes on a radius plan: live slots 127 (equal weights a row),
    dead slots 0, and the all-zero isolated rows keep scale 1 and code 0,
    as the reference's ``_build_band_i8`` and full-row codes."""
    pt, pj = rplan["pt"], rplan["pj"]
    A8, sw = tb._build_band_i8(pt.local_idx, pt.w_local, B)
    A8j, swj = jb._build_band_i8(pj.local_idx, pj.w_local, B)
    np.testing.assert_array_equal(_np(A8), np.asarray(A8j))
    np.testing.assert_array_equal(_np(sw), np.asarray(swj))
    fwq, fsw, fq = tb._full_row_codes(pt)
    live = _np(pt.w_local) > 0
    assert set(np.unique(_np(fwq)[live])) <= {127}
    assert (_np(fwq)[~live] == 0).all()
    rows = _np(pt.rank)[1500:]                     # isolated cells' rows
    assert (_np(pt.w_local)[rows] == 0).all()
    assert (_np(fsw).reshape(-1)[rows] == 1.0).all()
    assert set(np.unique(_np(fq)[_np(pt.far_w) > 0])) <= {127.0}


def test_radius_global_int8_p_bitwise(rplan):
    obs_j = jm.moran_observed(rplan["gj"], rplan["Zj"], rplan["S0"])
    obs_t = tm.moran_observed(rplan["gt"], rplan["Zt"], rplan["S0"])
    pj, _, _ = jb.banded_permutation_test(
        rplan["pj"], rplan["Zj"], rplan["S0"], obs_j, seed=5,
        n_permutations=29, precision="int8")
    for impl in ("auto", "xla"):
        pt, _, _ = tb.banded_permutation_test(
            rplan["pt"], rplan["Zt"], rplan["S0"], obs_t, seed=5,
            n_permutations=29, precision="int8", band_impl=impl)
        np.testing.assert_array_equal(_np(pt), np.asarray(pj))


@pytest.mark.parametrize("precision,far_mode", [
    ("int8", "auto"), ("int8", "exact"), ("bf16", "auto")],
    ids=["K2_windowed", "K3_band_only", "K4_bf16"])
def test_radius_global_p_vs_pallas_kernels(rplan, precision, far_mode):
    """The reference's global Pallas kernels in interpret mode on the radius
    plan (``band_impl="pallas_halo"``: K2 with windowed far edges, K3 with
    exact ones, K4 for bf16): int8 p bitwise; bf16 counts within one draw
    (float32 sums in another order; equal on this fixture)."""
    obs_j = jm.moran_observed(rplan["gj"], rplan["Zj"], rplan["S0"])
    obs_t = tm.moran_observed(rplan["gt"], rplan["Zt"], rplan["S0"])
    P = 9
    pj, _, _ = jb.banded_permutation_test(
        rplan["pj"], rplan["Zj"], rplan["S0"], obs_j, seed=5, n_permutations=P,
        precision=precision, far_mode=far_mode, band_impl="pallas_halo")
    pt, _, _ = tb.banded_permutation_test(
        rplan["pt"], rplan["Zt"], rplan["S0"], obs_t, seed=5, n_permutations=P,
        precision=precision, far_mode=far_mode)
    if precision == "int8":
        np.testing.assert_array_equal(_np(pt), np.asarray(pj))
    else:
        counts = np.round((_np(pt) - np.asarray(pj)) * (P + 1))
        assert np.abs(counts).max() <= 1


def test_radius_global_bf16_p(rplan):
    obs_j = jm.moran_observed(rplan["gj"], rplan["Zj"], rplan["S0"])
    obs_t = tm.moran_observed(rplan["gt"], rplan["Zt"], rplan["S0"])
    pj, _, _ = jb.banded_permutation_test(rplan["pj"], rplan["Zj"],
                                          rplan["S0"], obs_j, seed=3,
                                          n_permutations=29)
    pt, _, _ = tb.banded_permutation_test(rplan["pt"], rplan["Zt"],
                                          rplan["S0"], obs_t, seed=3,
                                          n_permutations=29)
    assert np.abs(_np(pt) - np.asarray(pj)).max() <= 0.05


@pytest.mark.parametrize("band_impl", ["auto", "pallas", "xla"])
def test_radius_local_int8_p_bitwise(rplan, band_impl):
    ref = np.asarray(jb.banded_local_moran_pvalues(
        rplan["pj"], rplan["Zj"], 5, 29, band_impl="xla"))
    got = tb.banded_local_moran_pvalues(rplan["pt"], rplan["Zt"], 5, 29,
                                        band_impl=band_impl)
    np.testing.assert_array_equal(_np(got), ref)
    # isolated cells: |I| = 0 at every placement, so every draw ties the
    # observed value and counts: p = 1, as the reference
    assert (_np(got)[1500:] == 1.0).all()


def test_radius_local_int8_counts_vs_pallas_k7(rplan):
    pj = rplan["pj"]
    ref = np.asarray(jb._banded_local_moran_p_i8(
        pj.order, pj.rank, pj.local_idx, pj.w_local, pj.far_src, pj.far_dst,
        pj.far_w, rplan["Zj"][:, :8], jnp.uint32(3), block=pj.block, n=pj.n,
        n_permutations=7, perm_method="feistel", band_impl="pallas",
        far_starts=pj.far_starts, far_bmax=pj.far_bmax, interpret=True))
    got = tb.banded_local_moran_pvalues(rplan["pt"], rplan["Zt"][:, :8], 3, 7)
    np.testing.assert_array_equal(_np(got), ref)


# ---------------------------------------------------------------------------
# The public API on a radius graph
# ---------------------------------------------------------------------------


def _pair(n=1500, g=8, seed=0):
    rng = np.random.default_rng(seed)
    c = _coords(n, seed + 20)
    m = c.shape[0]
    X = np.concatenate(
        [3 * np.sin(c[:, :1] / 12.0) + rng.normal(0, 0.5, (m, 1))
         for _ in range(g // 2)] + [rng.normal(0, 1, (m, g - g // 2))],
        axis=1).astype(np.float32)
    var = pd.DataFrame(index=[f"G{j}" for j in range(g)])
    a = JSpatialData(X=X.copy(), var=var.copy())
    a.obsm["spatial"] = c
    b = sctt.SpatialData(X=X.copy(), var=var.copy())
    b.obsm["spatial"] = c.copy()
    scts.build_spatial_weights(a, radius=5.5, k_max=32)
    sctt.build_spatial_weights(b, radius=5.5, k_max=32, device="cpu")
    return a, b


@pytest.mark.parametrize("null_method", ["banded_int8", "banded"])
def test_public_morans_i_on_radius_graph(null_method):
    a, b = _pair()
    kw = dict(n_permutations=29, seed=2, use_existing_graph=True,
              null_method=null_method)
    scts.morans_i(a, **kw)
    sctt.morans_i(b, device="cpu", **kw)
    da, db = a.uns["morans_i"], b.uns["morans_i"]
    assert list(db.columns) == list(da.columns)
    assert list(db["gene"]) == list(da["gene"])
    for col in ("I", "expected_I", "z_score"):
        np.testing.assert_allclose(db[col], da[col], rtol=1e-5, atol=1e-6)
    if null_method == "banded_int8":
        np.testing.assert_array_equal(db["p_value"], da["p_value"])
    else:
        assert np.abs(db["p_value"] - da["p_value"]).max() <= 0.05
    assert (db["p_value"][:4] <= 1.0 / 30 + 1e-6).all()   # smooth genes


def test_public_gearys_c_on_radius_graph():
    a, b = _pair(seed=1)
    kw = dict(n_permutations=29, seed=4, use_existing_graph=True,
              null_method="banded_int8")
    scts.gearys_c(a, **kw)
    sctt.gearys_c(b, device="cpu", **kw)
    da, db = a.uns["gearys_c"], b.uns["gearys_c"]
    np.testing.assert_allclose(db["C"], da["C"], rtol=1e-5, atol=1e-6)
    # z = (C − 1)/σ magnifies C's last float32 bits: the tolerance of
    # tests/test_torch_autocorrelation.py
    np.testing.assert_allclose(db["z_score"], da["z_score"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(db["p_value"], da["p_value"])


def test_public_local_morans_i_on_radius_graph():
    P = 29
    a, b = _pair(seed=2)
    kw = dict(n_permutations=P, seed=4, null_method="banded_int8",
              use_existing_graph=True, batch_size=8)
    scts.local_morans_i(a, **kw)
    sctt.local_morans_i(b, device="cpu", **kw)
    for k in ("I", "z", "lag", "p", "p_adj", "quadrant"):
        want = np.asarray(a.obsm[f"local_morans_{k}"], np.float32)
        got = np.asarray(b.obsm[f"local_morans_{k}"], np.float32)
        assert got.shape == want.shape, k
        if k in ("p", "p_adj"):
            near = np.abs(got - want) <= 1.0 / (P + 1) + 1e-6
            assert near.all() and (got == want).mean() >= 0.999, k
        elif k == "quadrant":
            assert (got == want).mean() >= 0.999
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    assert (b.obsm["local_morans_p"][1500:] == 1.0).all()
