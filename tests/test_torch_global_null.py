"""The port's global null, the parts around the dense-band kernels K5 and
K6, against the JAX package on the same numpy-seeded inputs.

Tolerances:
- the rotation-baked band A4 and integer counts: bitwise;
- cross products: rtol 1e-5 plus an absolute 1e-6 of the largest |cross|
  (float32 summation order differs between the Pallas kernels in
  interpret mode and torch);
- float permutation counts: within ±1 draw per gene (a draw can tie the
  observed value within float32 summation noise), null mean rtol 1e-5;
- bf16 p within 0.05 (the reference's XLA path rounds the band lag to bf16,
  the port keeps it in float32), as tests/test_banded.py allows;
- the slot null with a bf16 table: p within 0.05.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import spatialcore_tpu as sct
import spatialcore_tpu.spatial as scts
import spatialcore_tpu_torch as sctt
from spatialcore_tpu.ops import banded as jb
from spatialcore_tpu.ops import graph as jg
from spatialcore_tpu.ops import moran as jm
from spatialcore_tpu.ops import streaming as js
from spatialcore_tpu_torch.core.metadata import get_operations
from spatialcore_tpu_torch.kernels import band_cross as kern
from spatialcore_tpu_torch.ops import banded as tb
from spatialcore_tpu_torch.ops import graph as tg
from spatialcore_tpu_torch.ops import moran as tm
from spatialcore_tpu_torch.ops import streaming as ts

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

B = 64
P = 19


def _world(n, g, seed):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 60, (n, 2)).astype(np.float32)
    X = np.concatenate(
        [np.sin(coords[:, :1] / (6.0 + j)) + rng.normal(0, 0.4, (n, 1))
         for j in range(g // 2)]
        + [rng.normal(0, 1, (n, g - g // 2))], axis=1).astype(np.float32)
    return coords, X


@pytest.fixture(scope="module")
def setup():
    """8 blocks of B=64 (the last one partial), 20 genes."""
    coords, X = _world(8 * B - 37, 20, seed=3)
    gj = jg.build_graph(coords, n_neighbors=6)
    pj = jb.build_null_plan(gj, coords, block=B)
    Zj, _ = jm.standardize(jnp.asarray(X))
    return dict(coords=coords, X=X, gj=gj, gt=tg.graph_from_numpy(gj, device="cpu"),
                pj=pj, pt=tb.plan_from_numpy(pj, "cpu"),
                S0=float(np.asarray(gj.neighbor_w).sum()), Zj=Zj,
                Zt=torch.as_tensor(np.array(Zj)))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


def _counts(p, n_perm=P):
    return np.round(_np(p) * (n_perm + 1) - 1)


def _dtypes(name):
    return ((jnp.float32, torch.float32) if name == "f32"
            else (jnp.bfloat16, torch.bfloat16))


def _observed(setup, stat):
    fj, ft = ((jm.moran_observed, tm.moran_observed) if stat == "moran"
              else (jm.geary_observed, tm.geary_observed))
    return (fj(setup["gj"], setup["Zj"], setup["S0"]),
            ft(setup["gt"], setup["Zt"], setup["S0"]))


# ---------------------------------------------------------------------------
# K5 and K6: the dense bands and the plain versions of their kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_build_band_rot4_bitwise(setup, dtype):
    jdt, tdt = _dtypes(dtype)
    pj, pt = setup["pj"], setup["pt"]
    want = jb._build_band_rot4(pj.local_idx, pj.w_local, B, jdt)
    got = tb._build_band_rot4(pt.local_idx, pt.w_local, B, tdt)
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_np(got.float()), _np(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dense_crosses_match_pallas(setup, dtype):
    """K5's and K6's plain versions (the wrappers on CPU tensors) against
    the Pallas kernels in interpret mode, ragged gene count."""
    jdt, tdt = _dtypes(dtype)
    pj, pt = setup["pj"], setup["pt"]
    nbb = pj.local_idx.shape[0] // B
    zp = np.random.default_rng(1).normal(size=((nbb + 2) * B, 27)).astype(np.float32)
    zp_j = jnp.asarray(zp).astype(jdt)
    zp_t = torch.as_tensor(np.array(zp_j.astype(jnp.float32))).to(tdt)
    A = jb._build_band(pj.local_idx, pj.w_local, B, jdt)
    A4 = jb._build_band_rot4(pj.local_idx, pj.w_local, B, jdt)
    At = tb._build_band(pt.local_idx, pt.w_local.to(tdt), B, tdt)
    A4t = tb._build_band_rot4(pt.local_idx, pt.w_local, B, tdt)
    z3 = zp_j.reshape(nbb + 2, B, -1)
    k5 = jb._band_cross_pallas(A, z3, interpret=True)
    k6 = jb._band_cross_pallas_halo4(A4, z3, interpret=True)
    before = dict(kern.LAUNCHES)
    _close(kern.band_cross_dense(At, zp_t, B), k5)
    _close(kern.band_cross_rot4(A4t, zp_t, B), k6)
    _close(kern.band_cross_dense_plain(At, zp_t, B), k5)
    _close(kern.band_cross_rot4_plain(A4t, zp_t, B), k6)
    assert kern.LAUNCHES == before          # CPU tensors: no launch


def test_dense_wrappers_refuse_bad_operands(setup):
    pt = setup["pt"]
    A = tb._build_band(pt.local_idx, pt.w_local, B, torch.float32)
    zp = torch.zeros((A.shape[0] + 2) * B, 8)
    with pytest.raises(ValueError, match="share a dtype"):
        kern.band_cross_dense(A, zp.to(torch.bfloat16), B)
    with pytest.raises(ValueError, match="4·block"):
        kern.band_cross_rot4(A, zp, B)
    with pytest.raises(ValueError, match=r"\(nb\+2\)"):
        kern.band_cross_dense(A, zp[:-1], B)
    assert kern.band_cross_dense(A, zp, B).shape == (8,)


# ---------------------------------------------------------------------------
# banded_permutation_test: the dense-band routes, the "sort" stream and the
# fused Moran + Geary pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("band_impl", ["pallas", "pallas_halo4"])
def test_dense_band_impls_match_reference(setup, band_impl):
    obs_j, obs_t = _observed(setup, "moran")
    kw = dict(seed=5, n_permutations=P, precision="f32", band_impl=band_impl)
    pj, mj, _ = jb.banded_permutation_test(setup["pj"], setup["Zj"], setup["S0"],
                                           obs_j, **kw)
    pt, mt, _ = tb.banded_permutation_test(setup["pt"], setup["Zt"], setup["S0"],
                                           obs_t, **kw)
    assert np.abs(_counts(pt) - _counts(pj)).max() <= 1
    np.testing.assert_allclose(_np(mt), _np(mj), rtol=1e-5,
                               atol=1e-5 * float(np.abs(_np(mj)).max()))
    # the compact-band route draws the same permutations
    pa, ma, _ = tb.banded_permutation_test(setup["pt"], setup["Zt"], setup["S0"],
                                           obs_t, seed=5, n_permutations=P,
                                           precision="f32")
    assert np.abs(_counts(pt) - _counts(pa)).max() <= 1
    np.testing.assert_allclose(_np(mt), _np(ma), rtol=1e-5,
                               atol=1e-5 * float(np.abs(_np(ma)).max()))


@pytest.mark.parametrize("precision,far_mode", [("f32", "auto"), ("int8", "win")])
def test_sort_stream_matches_reference(setup, precision, far_mode):
    """perm_method="sort": jax.random.permutation's stream keyed
    perm_global; int8 counts bitwise."""
    obs_j, obs_t = _observed(setup, "moran")
    kw = dict(seed=9, n_permutations=P, precision=precision,
              perm_method="sort", far_mode=far_mode, draw_offset=3)
    pj, mj, _ = jb.banded_permutation_test(setup["pj"], setup["Zj"], setup["S0"],
                                           obs_j, **kw)
    pt, mt, _ = tb.banded_permutation_test(setup["pt"], setup["Zt"], setup["S0"],
                                           obs_t, **kw)
    if precision == "int8":
        np.testing.assert_array_equal(_counts(pt), _counts(pj))
    else:
        assert np.abs(_counts(pt) - _counts(pj)).max() <= 1
    np.testing.assert_allclose(_np(mt), _np(mj), rtol=1e-5,
                               atol=1e-5 * float(np.abs(_np(mj)).max()))


def test_sort_stream_is_the_slot_nulls(setup):
    """The sort stream's draws are the slot null's: the same per-gene
    statistics, so f32 p within ±1 draw and means within 1e-5."""
    _, obs_t = _observed(setup, "moran")
    pb, mb, _ = tb.banded_permutation_test(
        setup["pt"], setup["Zt"], setup["S0"], obs_t, seed=2, n_permutations=P,
        precision="f32", perm_method="sort")
    ps, ms, _ = tm.permutation_test_global(setup["gt"], setup["Zt"], setup["S0"],
                                           obs_t, seed=2, n_permutations=P)
    assert np.abs(_counts(pb) - _counts(ps)).max() <= 1
    np.testing.assert_allclose(_np(mb), _np(ms), atol=1e-5)


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_moran_geary_fused_equals_separate(setup, precision):
    """One gather and one cross per draw serve both statistics: bitwise the
    separate runs' p, mean and std; against the reference, int8 counts
    bitwise and f32 within ±1 draw."""
    (om_j, om_t), (og_j, og_t) = _observed(setup, "moran"), _observed(setup, "geary")
    alts = ("greater", "less")
    kw = dict(seed=4, n_permutations=P, precision=precision)
    fused = tb.banded_permutation_test(setup["pt"], setup["Zt"], setup["S0"],
                                       torch.stack([om_t, og_t]),
                                       stat="moran_geary", alternative=alts, **kw)
    for i, (stat, obs) in enumerate((("moran", om_t), ("geary", og_t))):
        alone = tb.banded_permutation_test(setup["pt"], setup["Zt"], setup["S0"],
                                           obs, stat=stat, alternative=alts[i], **kw)
        for f, a in zip(fused, alone):
            assert torch.equal(f[i], a)
    pj, _, _ = jb.banded_permutation_test(setup["pj"], setup["Zj"], setup["S0"],
                                          jnp.stack([om_j, og_j]),
                                          stat="moran_geary", alternative=alts, **kw)
    assert _np(fused[0]).shape == (2, 20)
    if precision == "int8":
        np.testing.assert_array_equal(_counts(fused[0]), _counts(pj))
    else:
        assert np.abs(_counts(fused[0]) - _counts(pj)).max() <= 1
    with pytest.raises(ValueError, match=r"\[2, G\]"):
        tb.banded_permutation_test(setup["pt"], setup["Zt"], setup["S0"], om_t,
                                   stat="moran_geary", **kw)
    with pytest.raises(ValueError, match="2 entries"):
        tb.banded_permutation_test(setup["pt"], setup["Zt"], setup["S0"],
                                   torch.stack([om_t, og_t]), stat="moran_geary",
                                   alternative=("greater",), **kw)


# ---------------------------------------------------------------------------
# The slot null
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stat,alternative,null_dtype", [
    ("moran", "greater", "float32"),
    ("geary", "less", "float32"),
    ("moran", "two-sided", "bfloat16"),
])
def test_permutation_test_global_matches_reference(setup, stat, alternative,
                                                   null_dtype):
    obs_j, obs_t = _observed(setup, stat)
    kw = dict(seed=6, n_permutations=P, stat=stat, alternative=alternative,
              null_dtype=null_dtype)
    pj, mj, sj = jm.permutation_test_global(setup["gj"], setup["Zj"], setup["S0"],
                                            obs_j, **kw)
    pt, mt, st = tm.permutation_test_global(setup["gt"], setup["Zt"], setup["S0"],
                                            obs_t, **kw)
    if null_dtype == "bfloat16":
        assert np.abs(_np(pt) - _np(pj)).max() <= 0.05
        return
    assert np.abs(_counts(pt) - _counts(pj)).max() <= 1
    np.testing.assert_allclose(_np(mt), _np(mj), rtol=1e-5,
                               atol=1e-5 * float(np.abs(_np(mj)).max()))
    np.testing.assert_allclose(_np(st) ** 2 + _np(mt) ** 2,
                               _np(sj) ** 2 + _np(mj) ** 2, rtol=1e-5)


def test_permutation_test_global_float64(setup):
    """float64 Z stays float64 in the moments; the counts match the
    reference's x64 run within ±1 draw."""
    X = setup["X"].astype(np.float64)
    with jax.enable_x64(True):
        Zj, _ = jm.standardize(jnp.asarray(X))
        assert Zj.dtype == jnp.float64
        obs_j = jm.moran_observed(setup["gj"], Zj, setup["S0"])
        pj, mj, _ = jm.permutation_test_global(setup["gj"], Zj, setup["S0"],
                                               obs_j, seed=1, n_permutations=P)
        pj, mj = np.asarray(pj), np.asarray(mj)
    Zt, _ = tm.standardize(torch.as_tensor(X))
    obs_t = tm.moran_observed(setup["gt"], Zt, setup["S0"])
    pt, mt, st = tm.permutation_test_global(setup["gt"], Zt, setup["S0"], obs_t,
                                            seed=1, n_permutations=P)
    assert mt.dtype == torch.float64 and st.dtype == torch.float64
    assert np.abs(_counts(pt) - _counts(pj)).max() <= 1
    np.testing.assert_allclose(_np(mt), mj, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# streaming_moran_null
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision,tile,prep_chunk,n_genes", [
    ("bf16", 64, 32, 80),
    ("int8", 64, 32, 80),
    ("int4", 256, 128, 130),
])
def test_streaming_matches_reference(setup, precision, tile, prep_chunk, n_genes):
    X = _world(setup["coords"].shape[0], n_genes, seed=12)[1]
    kw = dict(n_genes=n_genes, S0=setup["S0"], seed=8, n_permutations=P,
              tile=tile, prep_chunk=prep_chunk, chunk=8, precision=precision)
    Ij, pj, mj, _ = js.streaming_moran_null(
        setup["gj"], setup["pj"], lambda s, w, ci: jnp.asarray(X[:, s:s + w]),
        band_impl="xla", **kw)
    It, pt, mt, _ = ts.streaming_moran_null(
        setup["gt"], setup["pt"], lambda s, w, ci: X[:, s:s + w], device="cpu",
        **kw)
    assert It.shape == pt.shape == (n_genes,)
    np.testing.assert_allclose(It, Ij, rtol=1e-5, atol=1e-6)
    if precision == "bf16":
        assert np.abs(pt - pj).max() <= 0.05
    else:
        assert np.abs(_counts(pt) - _counts(pj)).max() <= 1
        np.testing.assert_allclose(mt, mj, rtol=1e-4, atol=1e-6)


def test_chunk_and_tile_split_invariance():
    """p bitwise at any tile and chunk split (draws keyed by the global
    draw index; every tile sees draw d's permutation)."""
    coords, X = _world(400, 48, seed=7)
    graph = tg.build_graph(torch.as_tensor(coords), n_neighbors=6, device="cpu")
    plan = tb.build_null_plan(graph, block=64)

    def run(tile, chunk):
        return ts.streaming_moran_null(
            graph, plan, lambda st, w, ci: X[:, st:st + w], n_genes=48,
            S0=400.0, seed=11, n_permutations=24, tile=tile, prep_chunk=16,
            chunk=chunk, device="cpu")

    I0, p0, m0, s0 = run(tile=48, chunk=24)
    for tile, chunk in ((48, 8), (16, 24), (16, 8)):
        I1, p1, m1, s1 = run(tile, chunk)
        np.testing.assert_array_equal(p0, p1)
        np.testing.assert_allclose(m0, m1, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(s0, s1, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(I0, I1, rtol=1e-6)
    with pytest.raises(ValueError, match="int4"):
        ts.streaming_moran_null(graph, plan, lambda st, w, ci: X[:, st:st + w],
                                n_genes=48, S0=400.0, n_permutations=4, tile=128,
                                prep_chunk=64, precision="int4", device="cpu")


# ---------------------------------------------------------------------------
# The public functions
# ---------------------------------------------------------------------------


def _pair(n=600, g=12):
    coords, X = _world(n, g, seed=5)
    X[:, 3] = 1.0                           # zero variance: z 0, p 1
    var = pd.DataFrame(index=[f"G{j}" for j in range(g)])
    a = sct.SpatialData(X=X.copy(), var=var.copy())
    a.obsm["spatial"] = coords
    b = sctt.SpatialData(X=X.copy(), var=var.copy())
    b.obsm["spatial"] = coords.copy()
    return a, b


def _frames_match(dt, dj, col, p_tol):
    assert list(dt.columns) == list(dj.columns)
    assert list(dt["gene"]) == list(dj["gene"])
    np.testing.assert_allclose(dt[col], dj[col], rtol=1e-5)
    np.testing.assert_allclose(dt["z_score"], dj["z_score"], rtol=1e-4, atol=1e-5)
    assert np.abs(dt["p_value"] - dj["p_value"]).max() <= p_tol
    assert dt.loc[3, "z_score"] == 0.0 and dt.loc[3, "p_value"] == 1.0


def test_global_autocorrelation_matches_reference():
    """Slot route ("auto" below 100k cells) against the reference's, and
    morans_i(null_method="slots") against both."""
    a, b = _pair()
    scts.global_autocorrelation(a, n_permutations=P, seed=3, gene_batch_size=5)
    sctt.global_autocorrelation(b, n_permutations=P, seed=3, gene_batch_size=5,
                                device="cpu")
    tol = 1.0 / (P + 1) + 1e-6
    _frames_match(b.uns["morans_i"], a.uns["morans_i"], "I", tol)
    _frames_match(b.uns["gearys_c"], a.uns["gearys_c"], "C", tol)
    op = get_operations(b)[-1]
    assert op["function"] == "global_autocorrelation"
    assert op["parameters"]["null_method"] == "slots"
    assert op["parameters"]["backend"] == "spatialcore_tpu_torch"
    fused = b.uns["morans_i"].copy()
    sctt.morans_i(b, n_permutations=P, seed=3, null_method="slots", device="cpu",
                  key_added="m_slots", gene_batch_size=5)
    pd.testing.assert_frame_equal(b.uns["m_slots"], fused)
    scts.morans_i(a, n_permutations=P, seed=3, null_method="slots",
                  key_added="m_slots")
    _frames_match(b.uns["m_slots"], a.uns["m_slots"], "I", tol)
    with pytest.raises(ValueError, match="mesh's axes"):
        sctt.global_autocorrelation(b, mesh=object(), device="cpu")


def test_global_autocorrelation_fused_equals_separate():
    """The fused banded pass gives bitwise the separate calls' DataFrames."""
    _, b = _pair()
    kw = dict(n_permutations=P, seed=7, null_method="banded_int8", device="cpu")
    sctt.global_autocorrelation(b, keys_added=("mi", "gc"), **kw)
    sctt.morans_i(b, **kw)
    sctt.gearys_c(b, use_existing_graph=True, **kw)
    pd.testing.assert_frame_equal(b.uns["mi"], b.uns["morans_i"])
    pd.testing.assert_frame_equal(b.uns["gc"], b.uns["gearys_c"])
