"""The port's local Geary path against the JAX package, on the CPU.

Tolerances, and why:
- int8 local-Geary p-values, counts and observed code values: bitwise.
  Every decision is an exact int32 comparison (k ≤ 256), the draws are the
  reference's Feistel stream bitwise, and p = (count + 1)·f32(1/(P+1)) is
  the expression XLA compiles the reference's division into. Held against
  the reference's XLA body and against its Pallas kernel K7 (geary tail,
  windowed far) in interpret mode, for every port ``band_impl``.
- observed C: rtol 1e-5 (float32 summation order of the standardization).
- bf16 / f32 banded local-Geary p: within one draw, 1/(P+1), for every
  cell (float32 summation order of the band lags can flip a tie).
- the public function: obsm C rtol 1e-5; p and p_adj within one draw for
  at least 99.9% of the entries (the two packages standardize with float32
  sums in different orders, and a z-score one ulp apart can quantize to
  the neighbouring int8 code); uns params equal but for the wall time.
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
    s["ref"] = {P: tuple(np.asarray(a) for a in jb.banded_local_geary(
        s["pj"], s["Zj"], 5, P, precision="int8", band_impl="xla"))
        for P in (49, 129)}
    return s


def test_local_geary_observed_matches_reference(setup):
    rj = jm.local_geary(setup["gj"], setup["Zj"], 0, 0)
    rt = tm.local_geary(setup["gt"], setup["Zt"], 0, 0)
    np.testing.assert_allclose(_np(rt.local_C), _np(rj.local_C), rtol=1e-5,
                               atol=1e-6)
    assert bool((rt.p_value == 1).all())
    with pytest.raises(ValueError, match="null"):
        tm.local_geary(setup["gt"], setup["Zt"], 0, 0, null="bogus")
    for null in ("total", "conditional"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
            tm.local_geary(setup["gt"], setup["Zt"], 0, 9, null=null)


# ---------------------------------------------------------------------------
# The int8 local-Geary null
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("band_impl", ["auto", "pallas", "xla"])
@pytest.mark.parametrize("P", [49, 129], ids=["int8_counters", "int16_counters"])
def test_int8_geary_bitwise_vs_reference(setup, P, band_impl):
    c, p = tb.banded_local_geary(setup["pt"], setup["Zt"], 5, P,
                                 precision="int8", band_impl=band_impl)
    assert c.dtype == torch.int32
    np.testing.assert_array_equal(_np(c), setup["ref"][P][0])
    np.testing.assert_array_equal(_np(p), setup["ref"][P][1])


def test_int8_geary_bitwise_vs_pallas_kernel(setup):
    """The reference's fused Pallas draw step K7 (geary tail, windowed far)
    in interpret mode."""
    pj = setup["pj"]
    c_ref, p_ref = jb._banded_local_geary_p_i8(
        pj.order, pj.rank, pj.local_idx, pj.w_local, pj.far_src, pj.far_dst,
        pj.far_w, setup["Zj"][:, :8], jnp.uint32(3), block=pj.block, n=pj.n,
        n_permutations=7, perm_method="feistel", band_impl="pallas",
        far_starts=pj.far_starts, far_bmax=pj.far_bmax, interpret=True)
    for impl in ("auto", "pallas"):
        c, p = tb.banded_local_geary(setup["pt"], setup["Zt"][:, :8], 3, 7,
                                     precision="int8", band_impl=impl)
        np.testing.assert_array_equal(_np(c), np.asarray(c_ref))
        np.testing.assert_array_equal(_np(p), np.asarray(p_ref))


def test_int8_geary_band_only_plan_bitwise():
    """Cells on a line: no far edges (an empty row-pointer list)."""
    x = np.arange(640, dtype=np.float32)
    s = _setup(np.stack([x, np.zeros_like(x)], axis=1), 6, 3)
    assert tb._n_live_far(s["pt"]) == 0
    ref = jb.banded_local_geary(s["pj"], s["Zj"], 2, 19, precision="int8",
                                band_impl="xla")
    before = dict(kern_lisa.LAUNCHES)
    got = tb.banded_local_geary(s["pt"], s["Zt"], 2, 19, precision="int8")
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert kern_lisa.LAUNCHES == before        # CPU tensors: the plain version


def test_int8_geary_prequantized_codes(setup):
    codes, _ = tb._quantize_z(setup["Zt"])
    _, p = tb.banded_local_geary(setup["pt"], codes, 5, 49, precision="int8")
    np.testing.assert_array_equal(_np(p), setup["ref"][49][1])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_float_geary_null_matches_reference(setup, precision):
    P = 49
    cj, pj = jb.banded_local_geary(setup["pj"], setup["Zj"], 4, P,
                                   precision=precision)
    ct, pt = tb.banded_local_geary(setup["pt"], setup["Zt"], 4, P,
                                   precision=precision)
    assert np.abs(_np(pt) - np.asarray(pj)).max() <= 1.0 / (P + 1) + 1e-6
    np.testing.assert_allclose(_np(ct), np.asarray(cj), rtol=1e-5, atol=1e-5)


def test_geary_null_refusals(setup):
    pt, Zt = setup["pt"], setup["Zt"]
    with pytest.raises(NotImplementedError, match="slot null"):
        tb.banded_local_geary(pt, Zt, 0, 5, perm_method="sort")
    with pytest.raises(ValueError, match="perm_method"):
        tb.banded_local_geary(pt, Zt, 0, 5, perm_method="")
    with pytest.raises(ValueError, match="band_impl"):
        tb.banded_local_geary(pt, Zt, 0, 5, precision="int8", band_impl="bogus")
    with pytest.raises(ValueError, match="precision"):
        tb.banded_local_geary(pt, Zt, 0, 5, precision="int4")
    wide = pt._replace(local_idx=torch.zeros((pt.n_padded, 257), dtype=torch.int64),
                       w_local=torch.zeros((pt.n_padded, 257)))
    with pytest.raises(ValueError, match="k <= 256"):
        tb.banded_local_geary(wide, Zt, 0, 5, precision="int8")


def test_geary_wrapper_refuses_bad_operands(setup):
    pt = setup["pt"]
    li = pt.local_idx.to(torch.int32)
    wq = torch.zeros_like(li, dtype=torch.int8)
    zp = torch.zeros(li.shape[0] + 2 * B, 16, dtype=torch.int8)
    w_row = torch.zeros(li.shape[0], dtype=torch.int32)
    far = dict(far_row_ptr=torch.zeros(li.shape[0] + 1, dtype=torch.int32),
               far_q=torch.zeros(0, dtype=torch.int8),
               Zf=torch.zeros(0, 16, dtype=torch.int8))
    with pytest.raises(ValueError, match="row pointers"):
        kern_lisa.geary_observed(li, wq, zp, B, w_row, far_row_ptr=None,
                                 far_q=None, Zf=None)
    with pytest.raises(ValueError, match="w_row"):
        kern_lisa.geary_observed(li, wq, zp, B, w_row.to(torch.float32), **far)
    wide = torch.zeros((li.shape[0], 257), dtype=torch.int32)
    with pytest.raises(ValueError, match="k <= 256"):
        kern_lisa.geary_observed(wide, wide.to(torch.int8), zp, B, w_row, **far)
    obs = torch.zeros(li.shape[0], 16, dtype=torch.int32)
    cnt = torch.zeros_like(obs, dtype=torch.int16)
    assert kern_lisa.geary_count(li, wq, zp, B, obs, cnt, w_row, **far) is cnt
    assert bool((cnt == 1).all())                 # 0 <= 0 everywhere


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
    X[:, 3] = 2.0                                 # zero variance: 0 / p 1
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
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=k)


def _params(d, key):
    p = dict(d.uns[f"{key}_params"])
    p.pop("computation_time_seconds")
    return p


@pytest.mark.parametrize("output_mode", ["full", "compact"])
def test_local_gearys_c_matches_reference(output_mode):
    P = 49
    a, b = _pair()
    kw = dict(n_permutations=P, seed=4, null="total", null_method="banded_int8",
              batch_size=5, output_mode=output_mode)
    scts.local_gearys_c(a, **kw)
    sctt.local_gearys_c(b, device="cpu", **kw)
    assert sorted(b.obsm) == sorted(a.obsm)
    _close_obsm(a, b, "local_geary", ("C", "p", "p_adj"), P)
    assert _params(b, "local_geary") == _params(a, "local_geary")
    assert isinstance(b.obsm["local_geary_p"], np.ndarray)
    assert (b.obsm["local_geary_p"][:, 3] == 1).all()
    assert (b.obsm["local_geary_C"][:, 3] == 0).all()
    sig = (b.obsm["local_geary_p_adj"][:, :6] < 0.05).mean()
    assert sig > 0.05                      # the smooth genes cohere


def test_local_gearys_c_no_permutations_matches_reference():
    a, b = _pair()
    scts.local_gearys_c(a, n_permutations=0)
    sctt.local_gearys_c(b, n_permutations=0, device="cpu")
    _close_obsm(a, b, "local_geary", ("C", "p", "p_adj"), 1)
    assert _params(b, "local_geary") == _params(a, "local_geary")


def test_compact_streaming_lean_path_equals_full():
    """The device sink's lean post-pass (run here on CPU tensors) gives the
    full run's C / p / p_adj cast to the compact dtypes."""
    _, b = _pair(g=10)
    b.X = torch.as_tensor(b.X)
    sctt.local_gearys_c(b, n_permutations=19, seed=2, null="total",
                        null_method="banded_int8", batch_size=10, device="cpu")
    graph = sctt.build_spatial_weights(b, store=False, device="cpu")
    plan = tb.build_null_plan(graph, torch.as_tensor(b.obsm["spatial"]), block=256)
    sink, finalize = ts.device_local_sink(10, keys=("C", "p", "p_adj"))
    ts.streaming_local_null(graph, plan, lambda s, w: b.X[:, s:s + w], 10, sink,
                            stat="geary", seed=2, n_permutations=19, tile=10,
                            post_chunk=4, keys=("C", "p", "p_adj"), device="cpu")
    out = finalize()
    for k, dt in (("p", torch.float16), ("p_adj", torch.float16),
                  ("C", torch.bfloat16)):
        assert out[k].dtype == dt
        want = torch.as_tensor(b.obsm[f"local_geary_{k}"]).to(dt)
        assert torch.equal(out[k], want), k


def test_local_gearys_c_refusals():
    _, b = _pair(n=300, g=4)
    for kw, exc, match in (
            (dict(null_method="banded_int4"), ValueError, "null_method"),
            (dict(null="total", output_mode="bogus"), ValueError, "output_mode"),
            (dict(), NotImplementedError, "Queue 1 item 4"),  # conditional
            (dict(null="total", null_method="direct"), NotImplementedError,
             "slot"),
            (dict(null="total"), NotImplementedError, "slot"),  # auto, small
            (dict(null="total", null_method="banded_int8", n_permutations=0,
                  output_mode="compact"), ValueError, "compact")):
        with pytest.raises(exc, match=match):
            sctt.local_gearys_c(b, **{"n_permutations": 9, **kw}, device="cpu")
    # the banded methods with the conditional null warn and fall back to
    # the (unported) slot null
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(NotImplementedError, match="slot"):
            sctt.local_gearys_c(b, n_permutations=9, null="conditional",
                                null_method="banded_int8", device="cpu")
