"""The port's local Moran (LISA) path against the JAX package, on the CPU.

Tolerances, and why:
- int8 LISA p-values and counts: bitwise. Every decision is an exact
  integer comparison, the draws are the reference's Feistel stream
  bitwise, and p = (count + 1)·f32(1/(P+1)) is the expression XLA
  compiles the reference's division into. Held against the reference's
  XLA path and against its Pallas kernels K7 (windowed far) and K8 (dense
  far) in interpret mode, for every port ``band_impl``.
- quadrant codes: equal (the same comparisons on equal inputs).
- observed I / z / lag: rtol 1e-5 (float32 summation order of the lag).
- bf16 / f32 banded LISA p: within one draw, 1/(P+1), for every cell
  (float32 summation order of the band lag can flip a tie); the reference's
  own test allows 0.03 at P=99.
- the public function: obsm I / z / lag rtol 1e-5; p and p_adj within one
  draw for at least 99.9% of the entries and quadrants equal for at least
  99.9% (the two packages standardize with float32 sums in different
  orders, and a z-score one ulp apart can quantize to the neighbouring
  int8 code); uns params equal but for the wall time.
"""

import warnings

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
from spatialcore_tpu_torch.kernels import lisa_count as kern_lisa
from spatialcore_tpu_torch.ops import banded as tb
from spatialcore_tpu_torch.ops import graph as tg
from spatialcore_tpu_torch.ops import moran as tm
from spatialcore_tpu_torch.ops import streaming as ts

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

B = 64


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _setup(coords, g, seed):
    rng = np.random.default_rng(seed)
    n = coords.shape[0]
    X = np.stack(
        [np.sin(coords[:, 0] / 9.0) * 2 + rng.normal(0, 0.5, n)
         for _ in range(g // 2)]
        + [rng.normal(0, 1, n) for _ in range(g - g // 2)], axis=1
    ).astype(np.float32)
    gj = jg.build_graph(coords, n_neighbors=6)
    pj = jb.build_null_plan(gj, coords, block=B)
    Zj, _ = jm.standardize(jnp.asarray(X))
    return dict(gj=gj, gt=tg.graph_from_numpy(gj, device="cpu"), pj=pj,
                pt=tb.plan_from_numpy(pj, "cpu"), Zj=Zj,
                Zt=torch.as_tensor(np.array(Zj)))


@pytest.fixture(scope="module")
def setup():
    coords = np.random.default_rng(7).uniform(0, 100, (1000, 2)).astype(np.float32)
    s = _setup(coords, 20, 7)
    assert s["pj"].far_bmax > 0                 # the plan has far edges
    s["ref"] = {P: np.asarray(jb.banded_local_moran_pvalues(
        s["pj"], s["Zj"], 5, P, band_impl="xla")) for P in (49, 129)}
    return s


# ---------------------------------------------------------------------------
# Observed statistics and quadrants
# ---------------------------------------------------------------------------


def test_local_moran_observed_matches_reference(setup):
    rj = jm.local_moran(setup["gj"], setup["Zj"], 0, 0)
    rt = tm.local_moran(setup["gt"], setup["Zt"], 0, 0)
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)
    assert bool((rt.p_value == 1).all())
    with pytest.raises(ValueError, match="null"):
        tm.local_moran(setup["gt"], setup["Zt"], 0, 0, null="bogus")
    # the slot nulls: the reference's draws and counts, bitwise
    for null in ("total", "conditional"):
        pj = jm.local_moran(setup["gj"], setup["Zj"], 0, 9, null=null).p_value
        pt = tm.local_moran(setup["gt"], setup["Zt"], 0, 9, null=null).p_value
        np.testing.assert_array_equal(_np(pt), np.asarray(pj))


def test_classify_quadrants_equal():
    rng = np.random.default_rng(1)
    z = rng.normal(size=(500, 6)).astype(np.float32)
    lag = rng.normal(size=(500, 6)).astype(np.float32)
    z[:20] = 0.0
    lag[20:40] = 0.0
    p = rng.uniform(size=(500, 6)).astype(np.float32)
    for pv in (None, p):
        got = tm.classify_quadrants(torch.as_tensor(z), torch.as_tensor(lag),
                                    None if pv is None else torch.as_tensor(pv))
        want = jm.classify_quadrants(jnp.asarray(z), jnp.asarray(lag),
                                     None if pv is None else jnp.asarray(pv))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(_np(got), _np(want))
    assert tm.QUADRANT_LABELS == jm.QUADRANT_LABELS


# ---------------------------------------------------------------------------
# The int8 LISA null
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("band_impl", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("P", [49, 129], ids=["int8_counters", "int16_counters"])
def test_int8_p_bitwise_vs_reference(setup, P, band_impl):
    got = tb.banded_local_moran_pvalues(setup["pt"], setup["Zt"], 5, P,
                                        band_impl=band_impl)
    np.testing.assert_array_equal(_np(got), setup["ref"][P])


@pytest.mark.parametrize("windowed", [True, False], ids=["K7_windowed", "K8_dense"])
def test_int8_p_bitwise_vs_pallas_kernels(setup, windowed):
    """The reference's fused Pallas draw steps in interpret mode: K7 with
    the plan's far runs, K8 (dense far layer) without them."""
    pj = setup["pj"]
    ref = np.asarray(jb._banded_local_moran_p_i8(
        pj.order, pj.rank, pj.local_idx, pj.w_local, pj.far_src, pj.far_dst,
        pj.far_w, setup["Zj"][:, :8], jnp.uint32(3), block=pj.block, n=pj.n,
        n_permutations=7, perm_method="feistel", band_impl="pallas",
        far_starts=pj.far_starts if windowed else None,
        far_bmax=pj.far_bmax if windowed else 0, interpret=True))
    pt = setup["pt"]
    if not windowed:
        pt = pt._replace(far_starts=None, far_bmax=0)
    for impl in ("auto", "pallas"):
        got = tb.banded_local_moran_pvalues(pt, setup["Zt"][:, :8], 3, 7,
                                            band_impl=impl)
        np.testing.assert_array_equal(_np(got), ref)


def test_int8_band_only_plan_bitwise():
    """Cells on a line: no far edges, the band-only draw step."""
    x = np.arange(640, dtype=np.float32)
    s = _setup(np.stack([x, np.zeros_like(x)], axis=1), 6, 3)
    assert tb._n_live_far(s["pt"]) == 0
    ref = np.asarray(jb.banded_local_moran_pvalues(s["pj"], s["Zj"], 2, 19,
                                                   band_impl="xla"))
    before = dict(kern_lisa.LAUNCHES)
    got = tb.banded_local_moran_pvalues(s["pt"], s["Zt"], 2, 19)
    np.testing.assert_array_equal(_np(got), ref)
    assert kern_lisa.LAUNCHES == before        # CPU tensors: the plain version


def test_return_counts_and_prequantized_codes(setup):
    ref = np.asarray(jb.banded_local_moran_pvalues(setup["pj"], setup["Zj"], 5,
                                                   49, return_counts=True))
    got = tb.banded_local_moran_pvalues(setup["pt"], setup["Zt"], 5, 49,
                                        return_counts=True)
    assert got.dtype == torch.int8 and ref.dtype == np.int8
    np.testing.assert_array_equal(_np(got), ref)
    codes, _ = tb._quantize_z(setup["Zt"])
    np.testing.assert_array_equal(
        _np(tb.banded_local_moran_pvalues(setup["pt"], codes, 5, 49)),
        setup["ref"][49])


def test_banded_local_moran_int8_matches_reference(setup):
    rj = jb.banded_local_moran(setup["pj"], setup["gj"], setup["Zj"], 5, 49,
                               precision="int8")
    rt = tb.banded_local_moran(setup["pt"], setup["gt"], setup["Zt"], 5, 49,
                               precision="int8")
    np.testing.assert_array_equal(_np(rt.p_value), _np(rj.p_value))
    np.testing.assert_allclose(_np(rt.local_I), _np(rj.local_I), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_float_null_matches_reference(setup, precision):
    P = 49
    rj = jb.banded_local_moran(setup["pj"], setup["gj"], setup["Zj"], 4, P,
                               precision=precision)
    rt = tb.banded_local_moran(setup["pt"], setup["gt"], setup["Zt"], 4, P,
                               precision=precision)
    assert np.abs(_np(rt.p_value) - _np(rj.p_value)).max() <= 1.0 / (P + 1) + 1e-6
    np.testing.assert_allclose(_np(rt.lag), _np(rj.lag), rtol=1e-5, atol=1e-6)


def test_null_refusals(setup):
    pt, Zt = setup["pt"], setup["Zt"]
    # the "sort" stream: the slot null's draws, counts bitwise
    np.testing.assert_array_equal(
        _np(tb.banded_local_moran_pvalues(pt, Zt, 0, 5, perm_method="sort")),
        np.asarray(jb.banded_local_moran_pvalues(
            setup["pj"], setup["Zj"], 0, 5, perm_method="sort",
            band_impl="xla")))
    with pytest.raises(ValueError, match="perm_method"):
        tb.banded_local_moran_pvalues(pt, Zt, 0, 5, perm_method="")
    with pytest.raises(ValueError, match="band_impl"):
        tb.banded_local_moran_pvalues(pt, Zt, 0, 5, band_impl="bogus")
    with pytest.raises(ValueError, match="precision"):
        tb.banded_local_moran(pt, setup["gt"], Zt, 0, 5, precision="int4")
    wide = pt._replace(local_idx=torch.zeros((pt.n_padded, 1001), dtype=torch.int64),
                       w_local=torch.zeros((pt.n_padded, 1001)))
    with pytest.raises(ValueError, match="k <= 1000"):
        tb.banded_local_moran_pvalues(wide, Zt, 0, 5)
    # P=0 needs no draws: the sort stream is accepted there, as in the reference
    res = tb.banded_local_moran(pt, setup["gt"], Zt, 0, 0, perm_method="sort")
    assert bool((res.p_value == 1).all())


def test_wrapper_refuses_bad_operands(setup):
    pt = setup["pt"]
    li = pt.local_idx.to(torch.int32)
    wq = torch.zeros_like(li, dtype=torch.int8)
    table = torch.zeros(pt.n, 16, dtype=torch.int8)
    rows = tb._padded_rows(pt, "cpu")
    obs = torch.zeros(li.shape[0], 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 4"):
        kern_lisa.lisa_observed(li, wq, table[:, :14].contiguous(), rows, B)
    with pytest.raises(ValueError, match="rows"):
        kern_lisa.lisa_observed(li, wq, table, rows.to(torch.int32), B)
    with pytest.raises(ValueError, match="rows"):
        kern_lisa.lisa_observed(li, wq, table, rows[:-1], B)
    with pytest.raises(ValueError, match="table's device"):
        kern_lisa.lisa_observed(li, wq, table, rows.to("meta"), B)
    with pytest.raises(ValueError, match="table"):
        kern_lisa.lisa_observed(li, wq, table.to(torch.int16), rows, B)
    with pytest.raises(ValueError, match="cnt"):
        kern_lisa.lisa_count(li, wq, table, rows, B, obs, obs.to(torch.float32))
    ptr = torch.zeros(li.shape[0] + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="not both"):
        kern_lisa.lisa_count(li, wq, table, rows, B, obs, torch.zeros_like(obs),
                             far_row_ptr=ptr,
                             far_q=torch.zeros(0, dtype=torch.int8),
                             far_rows=torch.zeros(0, dtype=torch.int64), far=obs)
    with pytest.raises(ValueError, match="far_rows"):
        kern_lisa.lisa_count(li, wq, table, rows, B, obs, torch.zeros_like(obs),
                             far_row_ptr=ptr,
                             far_q=torch.zeros(0, dtype=torch.int8))
    cnt = torch.zeros_like(obs, dtype=torch.int16)
    assert kern_lisa.lisa_count(li, wq, table, rows, B, obs, cnt) is cnt
    assert bool((cnt == 1).all())                 # |0·0| >= 0 everywhere


# ---------------------------------------------------------------------------
# Streaming and the public function
# ---------------------------------------------------------------------------


def _pair(n=1200, g=12, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 400, (n, 2)).astype(np.float32)
    X = np.concatenate(
        [3 * np.sin(coords[:, :1] / 30.0) + rng.normal(0, 0.5, (n, 1))
         for _ in range(g // 2)]
        + [rng.normal(0, 1, (n, g - g // 2))], axis=1).astype(np.float32)
    X[:, 3] = 2.0                                 # zero variance: 0 / NS
    var = pd.DataFrame(index=[f"G{j}" for j in range(g)])
    a = JSpatialData(X=X.copy(), var=var.copy())
    a.obsm["spatial"] = coords
    b = sctt.SpatialData(X=X.copy(), var=var.copy())
    b.obsm["spatial"] = coords.copy()
    return a, b


def _close_obsm(a, b, key, keys, P):
    for k in keys:
        want = np.asarray(a.obsm[f"{key}_{k}"], np.float32)
        got = np.asarray(b.obsm[f"{key}_{k}"], np.float32)
        assert got.shape == want.shape, k
        if k in ("p", "p_adj"):
            near = np.abs(got - want) <= 1.0 / (P + 1) + 1e-6
            assert near.all() and (got == want).mean() >= 0.999, k
        elif k == "quadrant":
            assert (got == want).mean() >= 0.999
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=k)



@pytest.mark.parametrize("k", [1, 6, 32, 50, 64, 128, "bound"])
@pytest.mark.parametrize("stat", ["moran", "geary", "getis_star", "getis_g", "lee"])
def test_lisa_tiles_fit_shared_memory(stat, k):
    """The local draw step's launch shape for every block the wrappers take
    (B ≤ 512), up to the largest k each statistic takes (geary 256, the
    others 1,000), for every far form, counter and the observed entry: its
    shared memory fits one H100 block, the tile is a power of two of 16–128
    genes, the chunk is 1..B rows and at most four rows a thread, at most a
    far entry a chunk row is staged, and the pipeline has 2–4 stages, at
    most one more than a block's chunks."""
    if k == "bound":
        k = kern_lisa.GEARY_MAX_K if stat == "geary" else kern_lisa.LEE_MAX_K
    forms = (0, 1, 2) if stat == "moran" else (1,)
    for block in range(1, kern_lisa.MAX_BLOCK + 1):
        for far_form in forms:
            for cnt_bytes in (0, 1, 2, 4):
                t = kern_lisa.lisa_tiles(block, k, stat, far_form, cnt_bytes, 1000,
                                         3907)
                assert t.smem == kern_lisa.lisa_smem_bytes(
                    block, k, stat, far_form, cnt_bytes, t.tile, t.chunk, t.far_cap,
                    t.stages)
                assert t.smem <= 232_448
                assert 16 <= t.tile <= 128 and t.tile & (t.tile - 1) == 0
                genes = 8 if stat == "getis_g" and cnt_bytes else 16
                assert 1 <= t.chunk <= min(block, 4 * 512 // (t.tile // genes))
                assert 0 <= t.far_cap <= t.chunk and t.run >= 1
                assert 2 <= t.stages <= 4 and t.stages - 1 <= -(-block // t.chunk)
    if (stat, k) == ("moran", 6):
        assert kern_lisa.lisa_tiles(256, 6, "moran", 1, 1, 1024, 3907) == (
            128, 29, 256, 128, 2, 192_080)


def _params(d, key):
    p = dict(d.uns[f"{key}_params"])
    p.pop("computation_time_seconds")
    return p


@pytest.mark.parametrize("output_mode", ["full", "compact"])
def test_local_morans_i_matches_reference(output_mode):
    P = 49
    a, b = _pair()
    kw = dict(n_permutations=P, seed=4, null_method="banded_int8",
              batch_size=5, output_mode=output_mode, alpha=0.25)
    scts.local_morans_i(a, **kw)
    sctt.local_morans_i(b, device="cpu", **kw)
    keys = (("I", "z", "lag", "p", "p_adj", "quadrant") if output_mode == "full"
            else ("I", "p", "p_adj", "quadrant"))
    assert sorted(b.obsm) == sorted(a.obsm)
    _close_obsm(a, b, "local_morans", keys, P)
    assert _params(b, "local_morans") == _params(a, "local_morans")
    assert isinstance(b.obsm["local_morans_p"], np.ndarray)
    assert (b.obsm["local_morans_p"][:, 3] == 1).all()
    assert (b.obsm["local_morans_quadrant"][:, 3] == 0).all()
    sig = np.isin(b.obsm["local_morans_quadrant"][:, :6], (1, 2)).mean()
    assert sig > 0.05                      # the smooth genes cluster


def test_local_morans_i_no_permutations_matches_reference():
    a, b = _pair()
    scts.local_morans_i(a, n_permutations=0)
    sctt.local_morans_i(b, n_permutations=0, device="cpu")
    _close_obsm(a, b, "local_morans", ("I", "z", "lag", "p", "p_adj",
                                       "quadrant"), 1)
    assert _params(b, "local_morans") == _params(a, "local_morans")


def test_compact_streaming_lean_path_equals_full():
    """The device sink's lean post-pass (run here on CPU tensors) gives the
    full run's p / p_adj / I cast to the compact dtypes, and its quadrants."""
    _, b = _pair(g=10)
    b.X = torch.as_tensor(b.X)
    sctt.local_morans_i(b, n_permutations=19, seed=2, null_method="banded_int8",
                        batch_size=10, device="cpu")
    graph = sctt.build_spatial_weights(b, store=False, device="cpu")
    plan = tb.build_null_plan(graph, torch.as_tensor(b.obsm["spatial"]), block=256)
    sink, finalize = ts.device_local_sink(10, keys=("I", "p", "p_adj", "quadrant"))
    ts.streaming_local_null(graph, plan, lambda s, w: b.X[:, s:s + w], 10, sink,
                            seed=2, n_permutations=19, tile=10, post_chunk=4,
                            keys=("I", "p", "p_adj", "quadrant"), device="cpu")
    out = finalize()
    for k, dt in (("p", torch.float16), ("p_adj", torch.float16),
                  ("I", torch.bfloat16), ("quadrant", torch.int8)):
        assert out[k].dtype == dt
        want = torch.as_tensor(b.obsm[f"local_morans_{k}"]).to(dt)
        assert torch.equal(out[k], want), k


def test_streaming_refusals():
    _, b = _pair(n=300, g=4)
    graph = sctt.build_spatial_weights(b, store=False, device="cpu")
    plan = tb.build_null_plan(graph, torch.as_tensor(b.obsm["spatial"]), block=64)
    sink, _ = ts.host_local_sink(300, 4)
    args = (graph, plan, lambda s, w: b.X[:, s:s + w], 4, sink)
    with pytest.raises(ValueError, match="stat"):
        ts.streaming_local_null(*args, stat="bogus", device="cpu")
    with pytest.raises(ValueError, match="pair of tiles"):
        ts.streaming_local_null(*args, stat="lee", device="cpu")
    # the bf16 recipe is keys-mode int8 LISA only, as the reference's
    for kw in ({}, {"keys": ("C",), "stat": "geary"},
               {"keys": ("p",), "precision": "bf16"}):
        with pytest.raises(ValueError, match="wide-tile moran recipe"):
            ts.streaming_local_null(*args, obs_dtype="bf16", device="cpu", **kw)
    with pytest.raises(ValueError, match="unknown keys"):
        ts.streaming_local_null(*args, keys=("C",), device="cpu")


def test_local_morans_i_refusals():
    a, b = _pair(n=300, g=4)
    for kw, exc, match in (
            (dict(null_method="banded_int4"), ValueError, "null_method"),
            (dict(null="bogus"), ValueError, "null"),
            (dict(output_mode="bogus"), ValueError, "output_mode"),
            (dict(null_method="banded_int8", n_permutations=0,
                  output_mode="compact"), ValueError, "compact")):
        with pytest.raises(exc, match=match):
            sctt.local_morans_i(b, **{"n_permutations": 9, **kw}, device="cpu")
    # the slot null: "slots", "auto" at this size, and the conditional null
    # from a banded method (a warning, then the slot null), each against the
    # reference's route
    for kw in (dict(null_method="slots"), {},
               dict(null="conditional", null_method="banded_int8")):
        run = dict(n_permutations=9, seed=1, **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            scts.local_morans_i(a, **run)
            sctt.local_morans_i(b, device="cpu", **run)
        _close_obsm(a, b, "local_morans", ("I", "p", "p_adj", "quadrant"), 9)
        assert b.uns["local_morans_params"]["null_method"] == "slots"
