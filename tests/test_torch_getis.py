"""The port's Getis-Ord Gi* / Gi path against the JAX package, on the CPU.

Tolerances, and why:
- int8 Getis p_sim: bitwise, for Gi* and Gi under every alternative,
  against the reference's XLA body, and against its Pallas kernel K7
  (getis_star / getis_g tails, windowed far) in interpret mode for two of
  the cases. Gi* decides on exact integers (one-sided) or by the sign of
  f32(A − A_o)·(f32(A + A_o) − 2·c2), which depends only on c2's bits; c2
  and the column sums are bitwise the reference's (the code sums stay
  below 2²⁴ here). Gi centres in float32: the reference's XLA body
  compiles its expression into another one (the divide by s becomes a
  multiply by an approximate rsqrt), so the port's cp values differ from
  it in the last bits, yet every count is equal here: an exact (lag, own)
  tie counts as extreme in both, and distinct pairs lie far more than an
  ulp apart.
- observed G and z: rtol 1e-5 (atol 1e-5 for z near 0; float32 sums in
  another order); analytic p: rtol 1e-4, atol 1e-6.
- float (f32 / bf16) banded p_sim: within one draw, 1/(P+1), for every
  cell. Gi* is held against the reference run op by op
  (``jax.disable_jit()``): its jit-compiled draw loop counts fewer draws
  than its own op-by-op run (up to 10 of 29 here; a defect of the
  reference, recorded in ROADMAP Queue 3), while the port equals the
  op-by-op run.
- the public function: obsm G / z rtol 1e-5 (atol 1e-5), p rtol 1e-4;
  p_sim and p_adj within one draw for at least 99.9% of the entries;
  hotspot codes equal for at least 99.9%; uns params equal but for the
  wall time. The analytic path's p_adj (BH over continuous p, a sort):
  atol 1e-4, as p values 1e-4 apart in relative terms can trade places
  in the step-up minimum.
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
from spatialcore_tpu.ops import getis as jgo
from spatialcore_tpu.ops import graph as jg
import spatialcore_tpu_torch as sctt
from spatialcore_tpu_torch.kernels import lisa_count as kern_lisa
from spatialcore_tpu_torch.ops import banded as tb
from spatialcore_tpu_torch.ops import getis as tgo
from spatialcore_tpu_torch.ops import graph as tg
from spatialcore_tpu_torch.ops import streaming as ts

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

B = 64
ALTS = ["two-sided", "greater", "less"]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    coords = rng.uniform(0, 100, (1000, 2)).astype(np.float32)
    gj = jg.build_graph(coords, n_neighbors=6)
    pj = jb.build_null_plan(gj, coords, block=B)
    assert pj.far_bmax > 0                        # the plan has far edges
    # raw, non-negative counts; the first half carries a smooth hot region
    X = rng.poisson(3.0, (1000, 12)).astype(np.float32)
    X[:, :6] += np.round(4 * np.maximum(np.sin(coords[:, :1] / 15.0), 0))
    return dict(gj=gj, gt=tg.graph_from_numpy(gj, device="cpu"), pj=pj,
                pt=tb.plan_from_numpy(pj, "cpu"), Xj=jnp.asarray(X),
                Xt=torch.as_tensor(X))


@pytest.mark.parametrize("star", [True, False], ids=["Gi_star", "Gi"])
@pytest.mark.parametrize("alternative", ALTS)
def test_getis_ord_observed_matches_reference(setup, star, alternative):
    rj = jgo.getis_ord(setup["gj"], setup["Xj"], star=star,
                       alternative=alternative)
    rt = tgo.getis_ord(setup["gt"], setup["Xt"], star=star,
                       alternative=alternative)
    np.testing.assert_allclose(_np(rt.G), _np(rj.G), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(rt.z_score), _np(rj.z_score), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(rt.p_value), _np(rj.p_value), rtol=1e-4,
                               atol=1e-6)
    assert bool((rt.p_sim == 1).all())


def test_getis_ord_refusals(setup):
    with pytest.raises(ValueError, match="alternative"):
        tgo.getis_ord(setup["gt"], setup["Xt"], alternative="both")
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        tgo.getis_ord(setup["gt"], setup["Xt"], n_permutations=9)
    one = tgo.getis_ord(setup["gt"], setup["Xt"][:, 0])      # 1-D input
    assert tuple(one.G.shape) == (1000, 1)


def test_quantize_x_bitwise(setup):
    qj, sj = jb._quantize_x(setup["Xj"] * 0.37)
    qt, st = tb._quantize_x(setup["Xt"] * 0.37)
    np.testing.assert_array_equal(_np(qt), np.asarray(qj))
    np.testing.assert_array_equal(_np(st), np.asarray(sj))


# ---------------------------------------------------------------------------
# The int8 Getis null
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("star", [True, False], ids=["Gi_star", "Gi"])
@pytest.mark.parametrize("alternative", ALTS)
def test_int8_getis_bitwise_vs_reference(setup, star, alternative):
    P = 29
    ref = np.asarray(jb.banded_getis(setup["pj"], setup["Xj"], 5, P, star=star,
                                     alternative=alternative, precision="int8",
                                     band_impl="xla"))
    for impl in ("auto", "xla"):
        got = tb.banded_getis(setup["pt"], setup["Xt"], 5, P, star=star,
                              alternative=alternative, precision="int8",
                              band_impl=impl)
        np.testing.assert_array_equal(_np(got), ref)


@pytest.mark.parametrize("star,alternative", [(True, "two-sided"),
                                              (False, "greater")],
                         ids=["Gi_star_two_sided", "Gi_greater"])
def test_int8_getis_bitwise_vs_pallas_kernel(setup, star, alternative):
    """The reference's fused Pallas draw step K7 (getis_star / getis_g
    tail, windowed far) in interpret mode."""
    pj = setup["pj"]
    ref = np.asarray(jb._banded_getis_p_i8(
        pj.order, pj.rank, pj.local_idx, pj.w_local, pj.far_src, pj.far_dst,
        pj.far_w, setup["Xj"][:, :8], jnp.uint32(3), block=pj.block, n=pj.n,
        n_permutations=7, star=star, alternative=alternative,
        perm_method="feistel", band_impl="pallas", far_starts=pj.far_starts,
        far_bmax=pj.far_bmax, interpret=True))
    got = tb.banded_getis(setup["pt"], setup["Xt"][:, :8], 3, 7, star=star,
                          alternative=alternative, precision="int8",
                          band_impl="pallas")
    np.testing.assert_array_equal(_np(got), ref)


def test_int8_getis_counters_and_launches(setup):
    """int16 counters past 127 draws; CPU tensors launch nothing."""
    P = 130
    ref = np.asarray(jb.banded_getis(setup["pj"], setup["Xj"][:, :4], 2, P,
                                     precision="int8", band_impl="xla"))
    before = dict(kern_lisa.LAUNCHES)
    got = tb.banded_getis(setup["pt"], setup["Xt"][:, :4], 2, P,
                          precision="int8")
    np.testing.assert_array_equal(_np(got), ref)
    assert kern_lisa.LAUNCHES == before


@pytest.mark.parametrize("star,precision", [(True, "f32"), (False, "f32"),
                                            (True, "bf16")],
                         ids=["Gi_star_f32", "Gi_f32", "Gi_star_bf16"])
def test_float_getis_null_matches_reference(setup, star, precision):
    P = 29
    with jax.disable_jit():
        ref = np.asarray(jb.banded_getis(setup["pj"], setup["Xj"], 4, P,
                                         star=star, alternative="greater",
                                         precision=precision))
    got = tb.banded_getis(setup["pt"], setup["Xt"], 4, P, star=star,
                          alternative="greater", precision=precision)
    assert np.abs(_np(got) - ref).max() <= 1.0 / (P + 1) + 1e-6


def test_getis_null_refusals(setup):
    pt, Xt = setup["pt"], setup["Xt"]
    for kw, exc, match in (
            (dict(precision="int4"), ValueError, "precision"),
            (dict(alternative="both"), ValueError, "alternative"),
            (dict(perm_method=""), ValueError, "perm_method"),
            (dict(perm_method="sort"), NotImplementedError, "slot null"),
            (dict(band_impl="bogus"), ValueError, "band_impl")):
        with pytest.raises(exc, match=match):
            tb.banded_getis(pt, Xt, 0, 5, **kw)


def test_getis_wrapper_refuses_bad_operands(setup):
    pt = setup["pt"]
    li = pt.local_idx.to(torch.int32)
    wb = torch.zeros_like(li, dtype=torch.int8)
    zp = torch.zeros(li.shape[0] + 2 * B, 16, dtype=torch.int8)
    far = dict(far_row_ptr=torch.zeros(li.shape[0] + 1, dtype=torch.int32),
               far_q=torch.zeros(0, dtype=torch.int8),
               Zf=torch.zeros(0, 16, dtype=torch.int8))
    obs = torch.zeros(li.shape[0], 16, dtype=torch.int32)
    cnt = torch.zeros_like(obs, dtype=torch.int8)
    with pytest.raises(ValueError, match="wp1 and tm"):
        kern_lisa.getis_star_count(li, wb, zp, B, obs, cnt,
                                   alternative="two-sided", **far)
    with pytest.raises(ValueError, match="alternative"):
        kern_lisa.getis_star_count(li, wb, zp, B, obs, cnt, alternative="x",
                                   **far)
    with pytest.raises(ValueError, match="obs"):
        kern_lisa.getis_g_count(
            li, wb, zp, B, obs, cnt, alternative="less", w_row=torch.zeros(
                li.shape[0]), tot=torch.zeros(16), sq=torch.zeros(16),
            inv_m=1.0, lag_o=obs, me_o=zp[B:-B].contiguous(), **far)
    assert kern_lisa.getis_star_count(li, wb, zp, B, obs, cnt,
                                      alternative="greater", **far) is cnt
    assert bool((cnt == 1).all())                 # 0 >= 0 everywhere
    assert bool((kern_lisa.getis_lag(li, wb, zp, B, **far) == 0).all())


# ---------------------------------------------------------------------------
# Streaming and the public function
# ---------------------------------------------------------------------------


def _pair(n=1200, g=12, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 400, (n, 2)).astype(np.float32)
    X = rng.poisson(2.0, (n, g)).astype(np.float32)
    X[:, :g // 2] += np.round(5 * np.maximum(np.sin(coords[:, :1] / 40.0), 0))
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
        if k in ("p_sim", "p_adj"):
            near = np.abs(got - want) <= 1.0 / (P + 1) + 1e-6
            assert near.all() and (got == want).mean() >= 0.999, k
        elif k == "hotspot":
            assert (got == want).mean() >= 0.999
        elif k == "p":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=k)


def _params(d, key):
    p = dict(d.uns[f"{key}_params"])
    p.pop("computation_time_seconds")
    return p


@pytest.mark.parametrize("output_mode,star,alternative", [
    ("full", True, "two-sided"), ("compact", True, "two-sided"),
    ("full", False, "greater")], ids=["full", "compact", "full_Gi_greater"])
def test_getis_ord_gi_matches_reference(output_mode, star, alternative):
    P = 49
    a, b = _pair()
    kw = dict(n_permutations=P, seed=4, null_method="banded_int8", star=star,
              alternative=alternative, batch_size=5, output_mode=output_mode,
              alpha=0.1)
    scts.getis_ord_gi(a, **kw)
    sctt.getis_ord_gi(b, device="cpu", **kw)
    assert sorted(b.obsm) == sorted(a.obsm)
    _close_obsm(a, b, "getis_ord", ("G", "z", "p", "p_sim", "p_adj", "hotspot"),
                P)
    assert _params(b, "getis_ord") == _params(a, "getis_ord")
    assert isinstance(b.obsm["getis_ord_p_sim"], np.ndarray)
    low = b.obsm["getis_ord_p_sim"] <= 0.05
    assert low[:, :6].mean() > 2 * low[:, 6:].mean()   # the hot region shows


def test_getis_ord_gi_analytic_matches_reference():
    """The default n_permutations=0: the analytic path alone, no kernel."""
    a, b = _pair()
    scts.getis_ord_gi(a)
    before = dict(kern_lisa.LAUNCHES)
    sctt.getis_ord_gi(b, device="cpu")
    assert kern_lisa.LAUNCHES == before
    assert sorted(b.obsm) == sorted(a.obsm)
    _close_obsm(a, b, "getis_ord", ("G", "z", "p", "hotspot"), 1)
    np.testing.assert_allclose(b.obsm["getis_ord_p_adj"],
                               a.obsm["getis_ord_p_adj"], rtol=1e-4, atol=1e-4)
    assert (b.obsm["getis_ord_hotspot"][:, :6] == 1).mean() > 0.1
    assert _params(b, "getis_ord") == _params(a, "getis_ord")


def test_compact_streaming_lean_path_equals_full():
    """The device sink's lean post-pass (run here on CPU tensors) gives the
    full run's planes cast to the compact dtypes."""
    _, b = _pair(g=10)
    b.X = torch.as_tensor(b.X)
    sctt.getis_ord_gi(b, n_permutations=19, seed=2, null_method="banded_int8",
                      batch_size=10, device="cpu")
    graph = sctt.build_spatial_weights(b, store=False, device="cpu")
    plan = tb.build_null_plan(graph, torch.as_tensor(b.obsm["spatial"]), block=256)
    keys = ("G", "z_score", "p", "p_sim", "p_adj", "hotspot")
    sink, finalize = ts.device_local_sink(10, keys=keys)
    ts.streaming_local_null(graph, plan, lambda s, w: b.X[:, s:s + w], 10, sink,
                            stat="getis", seed=2, n_permutations=19, tile=10,
                            post_chunk=4, keys=keys, device="cpu")
    out = finalize()
    for k, dt in (("G", torch.bfloat16), ("z_score", torch.bfloat16),
                  ("p", torch.float16), ("p_sim", torch.float16),
                  ("p_adj", torch.float16), ("hotspot", torch.int8)):
        assert out[k].dtype == dt
        sfx = "z" if k == "z_score" else k
        want = torch.as_tensor(b.obsm[f"getis_ord_{sfx}"]).to(dt)
        assert torch.equal(out[k], want), k


def test_getis_ord_gi_refusals():
    _, b = _pair(n=300, g=4)
    for kw, exc, match in (
            (dict(null_method="banded_int4"), ValueError, "null_method"),
            (dict(alternative="both"), ValueError, "alternative"),
            (dict(output_mode="bogus"), ValueError, "output_mode"),
            (dict(null_method="direct"), NotImplementedError, "Queue 1 item 4"),
            (dict(), NotImplementedError, "slot"),          # auto, small
            (dict(null_method="banded_int8", n_permutations=0,
                  output_mode="compact"), ValueError, "compact")):
        with pytest.raises(exc, match=match):
            sctt.getis_ord_gi(b, **{"n_permutations": 9, **kw}, device="cpu")
