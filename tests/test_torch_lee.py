"""The port's Lee's L path against the JAX package, on the CPU.

Tolerances, and why:
- observed L_local and lag: atol 1e-5 (float32; the lag sums its slots in
  the reference's order, the products may round apart by an ulp); L_global
  rtol 1e-5, atol 1e-4 (a float32 sum over cells in another order).
- direct null (``lees_l_pairs``, ``jax.random.permutation`` draws): global
  p equal to the reference; per-cell counts equal to the reference run op
  by op (``jax.disable_jit()``), whose lag and L are bitwise the port's.
  The reference's jit-compiled draw loop rounds the observed and the drawn
  L apart, so on integer-valued data, where |L_perm| = |L_obs| ties are
  common, its counts differ from its own op-by-op run (ROADMAP Queue 3);
  on continuous data they are equal, which is checked too.
- int8 banded null: per-cell p bitwise against the reference's XLA body,
  under both draw streams, and against its Pallas kernel K7 (lee tail,
  windowed far) in interpret mode; the global p equal on these fixtures
  (the port sums the global L blockwise in a fixed order, the reference's
  XLA body by an einsum, so they could part only at an exact float32 tie).
- float (f32 / bf16) banded null: every p within one draw, 1/(P+1) (the
  lag's summation order; equal on these fixtures); "sort" at f32 against
  the direct null within one draw.
- the public functions, on continuous expression (no exact ties): obs L
  rtol 1e-5 (atol 1e-5); p, quadrants, the global p and the uns params
  equal, under every null_method; compact planes equal (L: atol 1e-5
  before the bf16 cast rounds it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import spatialcore_tpu.spatial as scts
from spatialcore_tpu import SpatialData as JSpatialData
from spatialcore_tpu.ops import banded as jb
from spatialcore_tpu.ops import graph as jg
from spatialcore_tpu.ops import lee as jl
import spatialcore_tpu_torch as sctt
from spatialcore_tpu_torch.kernels import lisa_count as kern_lisa
from spatialcore_tpu_torch.ops import banded as tb
from spatialcore_tpu_torch.ops import graph as tg
from spatialcore_tpu_torch.ops import lee as tl
from spatialcore_tpu_torch.ops import streaming as ts

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

B = 64


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _std(X):
    return ((X - X.mean(0)) / X.std(0)).astype(np.float32)


def _counts(p, P):
    return np.round(_np(p).astype(np.float64) * (P + 1) - 1).astype(np.int64)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    coords = rng.uniform(0, 100, (1000, 2)).astype(np.float32)
    gj = jg.build_graph(coords, n_neighbors=6)
    pj = jb.build_null_plan(gj, coords, block=B)
    assert 0 < pj.far_bmax <= 1024            # K7's windowed route applies
    X = rng.normal(size=(1000, 8)).astype(np.float32)
    Y = rng.normal(size=(1000, 8)).astype(np.float32)
    wave = 2 * np.sin(coords[:, :1] / 10)
    X[:, :4] += wave
    Y[:, :4] += wave
    Zx, Zy = _std(X), _std(Y)
    # integer-valued counts: |L_perm| = |L_obs| ties are common
    C = rng.poisson(2.0, (1000, 8)).astype(np.float32)
    C[:, :4] += np.round(5 * np.maximum(np.sin(coords[:, :1] / 20.0), 0))
    Zc = _std(C)
    return dict(gj=gj, gt=tg.graph_from_numpy(gj, device="cpu"), pj=pj,
                pt=tb.plan_from_numpy(pj, "cpu"), Zx=Zx, Zy=Zy,
                Cx=Zc[:, :4], Cy=Zc[:, 4:])


# ---------------------------------------------------------------------------
# The direct null
# ---------------------------------------------------------------------------


def test_lees_l_pairs_observed_matches_reference(setup):
    rj = jl.lees_l_pairs(setup["gj"], jnp.asarray(setup["Zx"]),
                         jnp.asarray(setup["Zy"]), 0, 0)
    rt = tl.lees_l_pairs(setup["gt"], torch.as_tensor(setup["Zx"]),
                         torch.as_tensor(setup["Zy"]), 0, 0)
    np.testing.assert_allclose(_np(rt.L_local), np.asarray(rj.L_local), atol=1e-5)
    np.testing.assert_allclose(_np(rt.lag_zy), np.asarray(rj.lag_zy), atol=1e-5)
    np.testing.assert_allclose(_np(rt.L_global), np.asarray(rj.L_global),
                               rtol=1e-5, atol=1e-4)
    assert bool((rt.p_global == 1).all()) and bool((rt.p_local == 1).all())


def test_lees_l_pairs_direct_null_matches_reference(setup):
    """Continuous data: global and per-cell p equal to the jit-compiled
    reference."""
    P = 29
    args = (jnp.asarray(setup["Zx"]), jnp.asarray(setup["Zy"]), 3, P)
    rj = jl.lees_l_pairs(setup["gj"], *args, compute_cell_pvalues=True)
    rt = tl.lees_l_pairs(setup["gt"], torch.as_tensor(setup["Zx"]),
                         torch.as_tensor(setup["Zy"]), 3, P,
                         compute_cell_pvalues=True)
    np.testing.assert_array_equal(_np(rt.p_global), np.asarray(rj.p_global))
    np.testing.assert_array_equal(_np(rt.p_local), np.asarray(rj.p_local))


def test_lees_l_pairs_direct_null_ties_match_op_by_op_reference(setup):
    """Integer-valued data: the counts equal the reference run op by op,
    whose lag and L are bitwise the port's."""
    P = 19
    Cx, Cy = setup["Cx"], setup["Cy"]
    with jax.disable_jit():
        rd = jl.lees_l_pairs(setup["gj"], jnp.asarray(Cx), jnp.asarray(Cy), 4,
                             P, compute_cell_pvalues=True)
    rt = tl.lees_l_pairs(setup["gt"], torch.as_tensor(Cx), torch.as_tensor(Cy),
                         4, P, compute_cell_pvalues=True)
    np.testing.assert_array_equal(_np(rt.lag_zy), np.asarray(rd.lag_zy))
    np.testing.assert_array_equal(_np(rt.L_local), np.asarray(rd.L_local))
    np.testing.assert_array_equal(_counts(rt.p_local, P),
                                  _counts(rd.p_local, P))
    np.testing.assert_array_equal(_counts(rt.p_global, P),
                                  _counts(rd.p_global, P))


# ---------------------------------------------------------------------------
# The int8 banded null and K7's lee tail
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("perm_method", ["feistel", "sort"])
@pytest.mark.parametrize("cells", [True, False], ids=["cells", "global_only"])
def test_int8_lee_bitwise_vs_reference(setup, perm_method, cells):
    P = 29
    gj_, lj_ = jb.banded_lees_l(setup["pj"], jnp.asarray(setup["Zx"]),
                                jnp.asarray(setup["Zy"]), 5, P,
                                precision="int8", compute_cell_pvalues=cells,
                                perm_method=perm_method, band_impl="xla")
    for impl in ("auto", "xla"):
        g, loc = tb.banded_lees_l(setup["pt"], torch.as_tensor(setup["Zx"]),
                                  torch.as_tensor(setup["Zy"]), 5, P,
                                  precision="int8", compute_cell_pvalues=cells,
                                  perm_method=perm_method, band_impl=impl)
        np.testing.assert_array_equal(_np(loc), np.asarray(lj_))
        np.testing.assert_array_equal(_np(g), np.asarray(gj_))


def test_int8_lee_bitwise_vs_pallas_kernel(setup):
    """The reference's fused Pallas draw step K7 (lee tail, windowed far)
    in interpret mode, on integer-valued data."""
    pj = setup["pj"]
    Cx, Cy = setup["Cx"][:, :3], setup["Cy"][:, :3]
    gj_, lj_ = jb._banded_lees_p_i8(
        pj.order, pj.rank, pj.local_idx, pj.w_local, pj.far_src, pj.far_dst,
        pj.far_w, jnp.asarray(Cx), jnp.asarray(Cy), jnp.uint32(2),
        block=pj.block, n=pj.n, n_permutations=7, perm_method="feistel",
        compute_cell_pvalues=True, band_impl="pallas",
        far_starts=pj.far_starts, far_bmax=pj.far_bmax, interpret=True)
    g, loc = tb.banded_lees_l(setup["pt"], torch.as_tensor(Cx),
                              torch.as_tensor(Cy), 2, 7, precision="int8",
                              compute_cell_pvalues=True, band_impl="pallas")
    np.testing.assert_array_equal(_np(loc), np.asarray(lj_))
    np.testing.assert_array_equal(_np(g), np.asarray(gj_))


def test_int8_lee_int16_counters_and_no_launches(setup):
    """int16 counters past 127 draws; CPU tensors launch nothing."""
    P = 130
    Zx, Zy = setup["Zx"][:, :2], setup["Zy"][:, :2]
    _, lj_ = jb.banded_lees_l(setup["pj"], jnp.asarray(Zx), jnp.asarray(Zy), 1,
                              P, precision="int8", compute_cell_pvalues=True,
                              band_impl="xla")
    before = dict(kern_lisa.LAUNCHES)
    _, loc = tb.banded_lees_l(setup["pt"], torch.as_tensor(Zx),
                              torch.as_tensor(Zy), 1, P, precision="int8",
                              compute_cell_pvalues=True)
    np.testing.assert_array_equal(_np(loc), np.asarray(lj_))
    assert kern_lisa.LAUNCHES == before


def _lee_operands(pt, Zx, Zy):
    """The int8 Lee operands of one plan at the identity placement."""
    wq, sw, far_q = tb._full_row_codes(pt)
    n_live = tb._n_live_far(pt)
    ptr, dst = tb._rows_far(pt, n_live)
    Yp = tb._pad_cols4(tb._quantize_z(torch.as_tensor(Zy))[0])[
        tb._padded_rows(pt, "cpu")]
    zx = tb._relabeled_x(pt, tb._pad_cols4(tb._quantize_z(torch.as_tensor(Zx))[0]))
    far = dict(far_row_ptr=ptr, far_q=far_q[:n_live].to(torch.int8), Zf=Yp[dst])
    return (pt.local_idx.to(torch.int32), wq, Yp, B, zx,
            sw.reshape(-1).contiguous()), far


def test_lee_partials_follow_the_fixed_order(setup):
    """The plain version's partials equal the definition written out:
    per block, row group q sums sw·f32(Lq) over rows q, q+16, ... in row
    order, then the 16 group sums in group order, each step rounded to
    float32; the three entries agree."""
    args, far = _lee_operands(setup["pt"], setup["Zx"], setup["Zy"])
    li, wq, Yp, _, zx, sw = args
    abs_l, part = kern_lisa.lee_observed(*args, **far)
    lag = kern_lisa._int_lag_plain(li, wq, Yp, B, far["far_row_ptr"],
                                   far["far_q"], far["Zf"], 0, li.shape[0])
    Lq = (zx.to(torch.int32) * lag).numpy()
    np.testing.assert_array_equal(abs_l.numpy(), np.abs(Lq))
    swn = sw.numpy()
    f32 = np.float32
    want = np.zeros(part.shape, f32)
    for n in range(part.shape[0]):
        tot = np.zeros(part.shape[1], f32)
        for q in range(16):
            acc = np.zeros(part.shape[1], f32)
            for i in range(n * B + q, (n + 1) * B, 16):
                acc = (acc + (f32(swn[i]) * Lq[i].astype(f32)).astype(f32)
                       ).astype(f32)
            tot = (tot + acc).astype(f32)
        want[n] = tot
    np.testing.assert_array_equal(part.numpy(), want)
    np.testing.assert_array_equal(kern_lisa.lee_partial(*args, **far).numpy(),
                                  want)
    cnt = torch.zeros(abs_l.shape, dtype=torch.int8)
    got = kern_lisa.lee_count(*args, abs_l, cnt, **far)
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool((cnt == 1).all())                 # every |Lq| >= itself
    # the fixed-order global sum: pairwise halves over zero-padded rows
    part5 = torch.arange(5 * 3, dtype=torch.float32).reshape(5, 3) / 7
    want5 = ((part5[0] + part5[4]) + part5[2]) + (part5[1] + part5[3])
    assert torch.equal(tb._tree_sum(part5), want5)


def test_lee_wrappers_refuse_bad_operands(setup):
    args, far = _lee_operands(setup["pt"], setup["Zx"][:, :4],
                              setup["Zy"][:, :4])
    li, wq, Yp, _, zx, sw = args
    with pytest.raises(ValueError, match="zx"):
        kern_lisa.lee_partial(li, wq, Yp, B, zx[:, :3].contiguous(), sw, **far)
    with pytest.raises(ValueError, match="sw_row"):
        kern_lisa.lee_partial(li, wq, Yp, B, zx, sw.double(), **far)
    with pytest.raises(ValueError, match="row pointers"):
        kern_lisa.lee_partial(li, wq, Yp, B, zx, sw, far_row_ptr=None,
                              far_q=None, Zf=None)
    wide = torch.zeros((li.shape[0], 1001), dtype=torch.int32)
    with pytest.raises(ValueError, match="k <= 1000"):
        kern_lisa.lee_partial(wide, torch.zeros_like(wide, dtype=torch.int8),
                              Yp, B, zx, sw, **far)


# ---------------------------------------------------------------------------
# The float banded null
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision,perm_method", [
    ("f32", "feistel"), ("bf16", "feistel"), ("f32", "sort")])
def test_float_lee_null_matches_reference(setup, precision, perm_method):
    P = 29
    gj_, lj_ = jb.banded_lees_l(setup["pj"], jnp.asarray(setup["Zx"]),
                                jnp.asarray(setup["Zy"]), 5, P,
                                precision=precision, compute_cell_pvalues=True,
                                perm_method=perm_method)
    g, loc = tb.banded_lees_l(setup["pt"], torch.as_tensor(setup["Zx"]),
                              torch.as_tensor(setup["Zy"]), 5, P,
                              precision=precision, compute_cell_pvalues=True,
                              perm_method=perm_method)
    assert np.abs(_np(loc) - np.asarray(lj_)).max() <= 1.0 / (P + 1) + 1e-6
    assert np.abs(_np(g) - np.asarray(gj_)).max() <= 1.0 / (P + 1) + 1e-6


def test_sort_stream_reproduces_the_direct_null(setup):
    """perm_method="sort" draws the direct null's permutations: at f32 the
    banded p is within one draw of lees_l_pairs (lag summation order)."""
    P = 29
    Zx, Zy = torch.as_tensor(setup["Zx"]), torch.as_tensor(setup["Zy"])
    direct = tl.lees_l_pairs(setup["gt"], Zx, Zy, 5, P, compute_cell_pvalues=True)
    g, loc = tb.banded_lees_l(setup["pt"], Zx, Zy, 5, P, precision="f32",
                              compute_cell_pvalues=True, perm_method="sort")
    assert (loc - direct.p_local).abs().max() <= 1.0 / (P + 1) + 1e-6
    assert (g - direct.p_global).abs().max() <= 1.0 / (P + 1) + 1e-6


def test_lee_null_refusals(setup):
    pt = setup["pt"]
    Zx, Zy = torch.as_tensor(setup["Zx"]), torch.as_tensor(setup["Zy"])
    for kw, match in ((dict(precision="int4"), "precision"),
                      (dict(perm_method="Sort"), "perm_method"),
                      (dict(band_impl="bogus"), "band_impl")):
        with pytest.raises(ValueError, match=match):
            tb.banded_lees_l(pt, Zx, Zy, 0, 5, **kw)


# ---------------------------------------------------------------------------
# Streaming and the public functions
# ---------------------------------------------------------------------------


PAIRS = [("G0", "G1"), ("G2", "G3"), ("G4", "G5"), ("G0", "G7"), ("G6", "G2")]


def _pair(n=1200, g=8, seed=0):
    """Continuous expression, the first half with a shared smooth signal;
    G7 has zero variance."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 400, (n, 2)).astype(np.float32)
    X = rng.lognormal(0.5, 0.5, (n, g)).astype(np.float32)
    X[:, :g // 2] += 3 * np.maximum(np.sin(coords[:, :1] / 40.0), 0)
    X[:, g - 1] = 3.0
    var = pd.DataFrame(index=[f"G{j}" for j in range(g)])
    a = JSpatialData(X=X.copy(), var=var.copy())
    a.obsm["spatial"] = coords
    b = sctt.SpatialData(X=X.copy(), var=var.copy())
    b.obsm["spatial"] = coords.copy()
    return a, b


@pytest.mark.parametrize("null_method", ["direct", "banded", "banded_int8"])
def test_lees_l_matches_reference(null_method):
    a, b = _pair()
    kw = dict(n_permutations=29, seed=3, null_method=null_method)
    ra = scts.lees_l(a, PAIRS, **kw)
    rb = sctt.lees_l(b, PAIRS, device="cpu", **kw)
    assert [(r["gene_x"], r["gene_y"]) for r in rb] == PAIRS
    for x, y in zip(ra, rb):
        np.testing.assert_allclose(y["L"], x["L"], rtol=1e-5, atol=1e-4)
        assert y["p_value"] == x["p_value"]
    assert rb[3] == {"gene_x": "G0", "gene_y": "G7", "L": 0.0, "p_value": 1.0}
    one = sctt.lees_l(b, ("G0", "G1"), device="cpu", **kw)
    assert isinstance(one, dict) and one["p_value"] == rb[0]["p_value"]


def _params(d, key):
    p = dict(d.uns[key])
    p.pop("computation_time_seconds", None)
    return p


@pytest.mark.parametrize("null_method", ["direct", "banded", "banded_int8"])
def test_lees_l_local_full_matches_reference(null_method):
    a, b = _pair()
    kw = dict(n_permutations=29, seed=3, null_method=null_method,
              compute_cell_pvalues=True, significance_filter=True)
    scts.lees_l_local(a, PAIRS, **kw)
    sctt.lees_l_local(b, PAIRS, device="cpu", **kw)
    assert sorted(b.obs.columns) == sorted(a.obs.columns)
    for gx, gy in PAIRS:
        key = f"{gx}_{gy}"
        np.testing.assert_allclose(b.obs[f"{key}_lees_l"], a.obs[f"{key}_lees_l"],
                                   rtol=1e-5, atol=1e-5)
        assert b.obs[f"{key}_quadrant"].equals(a.obs[f"{key}_quadrant"])
        pa, pb = _params(a, f"{key}_lees_l_params"), _params(b, f"{key}_lees_l_params")
        np.testing.assert_allclose(pb.pop("global_L"), pa.pop("global_L"),
                                   rtol=1e-5, atol=1e-4)
        assert pb == pa
        if (gx, gy) != ("G0", "G7"):
            np.testing.assert_array_equal(b.obs[f"{key}_pvalue"],
                                          a.obs[f"{key}_pvalue"])
    hh = (b.obs["G0_G1_quadrant"] == "HH").mean()
    assert hh > 2 * (b.obs["G4_G5_quadrant"] == "HH").mean()    # the signal


def test_lees_l_local_compact_matches_reference():
    a, b = _pair()
    kw = dict(n_permutations=29, seed=3, null_method="banded_int8",
              compute_cell_pvalues=True, output_mode="compact", alpha=0.1)
    scts.lees_l_local(a, PAIRS, **kw)
    sctt.lees_l_local(b, PAIRS, device="cpu", **kw)
    for k in ("L", "p", "p_adj", "quadrant"):
        want = np.asarray(a.obsm[f"lees_local_{k}"], np.float32)
        got = np.asarray(b.obsm[f"lees_local_{k}"], np.float32)
        assert got.shape == want.shape == (1200, len(PAIRS)), k
        if k == "L":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    assert _params(b, "lees_local_params") == _params(a, "lees_local_params")


def test_lee_compact_lean_path_equals_full():
    """The device sink's lean post-pass (run here on CPU tensors) gives the
    full streaming run's planes cast to the compact dtypes; the full
    streaming p equals lees_l_local's."""
    _, b = _pair()
    b.X = torch.as_tensor(b.X)
    graph = sctt.build_spatial_weights(b, store=False, device="cpu")
    plan = tb.build_null_plan(graph, torch.as_tensor(b.obsm["spatial"]), block=256)
    ix = [int(g[1]) for g, _ in PAIRS]
    iy = [int(g[1]) for _, g in PAIRS]

    def get_tile(s, w):
        return b.X[:, ix[s:s + w]], b.X[:, iy[s:s + w]]

    run = dict(stat="lee", seed=2, n_permutations=19, tile=3, device="cpu")
    sink, store = ts.host_local_sink(1200, len(PAIRS))
    ts.streaming_local_null(graph, plan, get_tile, len(PAIRS), sink, **run)
    assert sorted(store) == ["L", "lag", "p", "p_adj", "quadrant"]
    assert (store["p"][:, 3] == 1).all() and (store["quadrant"][:, 3] == 0).all()
    keys = ("L", "lag", "p", "p_adj", "quadrant")
    sink, finalize = ts.device_local_sink(len(PAIRS), keys=keys)
    ts.streaming_local_null(graph, plan, get_tile, len(PAIRS), sink,
                            post_chunk=2, keys=keys, **run)
    out = finalize()
    for k in keys:
        dt = ts._COMPACT_DTYPES[k]
        assert out[k].dtype == dt
        assert torch.equal(out[k], torch.as_tensor(store[k]).to(dt)), k
    # the same p as lees_l_local's full mode (banded_int8)
    sctt.lees_l_local(b, PAIRS, n_permutations=19, seed=2, device="cpu",
                      null_method="banded_int8", compute_cell_pvalues=True)
    np.testing.assert_array_equal(b.obs["G2_G3_pvalue"], store["p"][:, 1])


def test_lees_l_refusals():
    _, b = _pair(n=300)
    with pytest.raises(ValueError, match="null_method"):
        sctt.lees_l(b, ("G0", "G1"), null_method="slots", n_permutations=0,
                    device="cpu")
    with pytest.raises(ValueError, match="not found"):
        sctt.lees_l(b, ("G0", "X9"), device="cpu")
    for kw, match in ((dict(significance_filter=True), "significance_filter"),
                      (dict(output_mode="bogus"), "output_mode"),
                      (dict(output_mode="compact", null_method="direct"),
                       "compact"),
                      (dict(gene_pairs=None), "gene_pairs")):
        with pytest.raises(ValueError, match=match):
            sctt.lees_l_local(b, **{"gene_pairs": ("G0", "G1"), **kw},
                              device="cpu")
    d = sctt.lees_l_local(b, genes=["G0", "G1", "G2"], n_permutations=0,
                          device="cpu", copy=True)
    assert [c for c in d.obs.columns if c.endswith("_lees_l")] == [
        "G0_G1_lees_l", "G0_G2_lees_l", "G1_G2_lees_l"]
