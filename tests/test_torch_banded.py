"""The port's banded null against the JAX package, on one plan.

Tolerances:
- plans, quantized codes, packed bytes and integer lags: bitwise;
- cross products: rtol 1e-5 plus an absolute 1e-6 of the largest |cross|
  (float32 summation order differs between XLA, torch and the kernels);
- permutation counts at int4/int8/f32: within ±1 draw per gene (a draw can
  tie the observed value within float32 summation noise); null mean and
  second moment rtol 1e-5; bf16 p within 0.05, as tests/test_banded.py allows for
  bf16-class operators.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialcore_tpu.ops import banded as jb
from spatialcore_tpu.ops import graph as jg
from spatialcore_tpu.ops import moran as jm
from spatialcore_tpu.ops import streaming as js
from spatialcore_tpu_torch.core.rng import feistel_apply, fold_in, key_for, permutation
from spatialcore_tpu_torch.kernels import band_cross as kern
from spatialcore_tpu_torch.kernels import lisa_count as kern_lisa
from spatialcore_tpu_torch.ops import banded as tb
from spatialcore_tpu_torch.ops import graph as tg
from spatialcore_tpu_torch.ops import moran as tm
from spatialcore_tpu_torch.ops import streaming as ts
from spatialcore_tpu_torch.utils import profiling as prof

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

B = 64


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    n, g = 1000, 20
    coords = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    X = np.stack(
        [np.sin(coords[:, 0] / 9.0) + rng.normal(0, 0.3, n) for _ in range(g // 2)]
        + [rng.normal(0, 1, n) for _ in range(g - g // 2)], axis=1
    ).astype(np.float32)
    gj = jg.build_graph(coords, n_neighbors=6)
    gt = tg.graph_from_numpy(gj, device="cpu")
    pj = jb.build_null_plan(gj, coords, block=B)
    S0 = float(np.asarray(gj.neighbor_w).sum())
    Zj, _ = jm.standardize(jnp.asarray(X))
    Zt = torch.as_tensor(np.array(Zj))
    return dict(coords=coords, gj=gj, gt=gt, pj=pj, pt=tb.plan_from_numpy(pj, "cpu"),
                S0=S0, Zj=Zj, Zt=Zt)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


def test_host_plan_bitwise(setup):
    pt = tb.build_null_plan(setup["gt"], setup["coords"], block=B)
    for f in setup["pj"]._fields:
        np.testing.assert_array_equal(_np(getattr(pt, f)),
                                      _np(getattr(setup["pj"], f)), err_msg=f)


def test_graph_order_plan_bitwise(setup):
    """No coordinates: reverse Cuthill-McKee order, host path."""
    pj = jb.build_null_plan(setup["gj"], None, block=B)
    pt = tb.build_null_plan(setup["gt"], None, block=B)
    for f in pj._fields:
        np.testing.assert_array_equal(_np(getattr(pt, f)), _np(getattr(pj, f)),
                                      err_msg=f)


def test_device_plan_matches(setup):
    """float32 Hilbert path: every index array bitwise. rc_sum within
    float32 rounding: the reference scatter-adds the column sums in float32,
    the port in float64 (order-independent on CUDA) rounded once."""
    pj = jb.build_null_plan(setup["gj"], jnp.asarray(setup["coords"]), block=B)
    pt = tb.build_null_plan(setup["gt"], torch.as_tensor(setup["coords"]), block=B)
    for f in pj._fields:
        if f == "rc_sum":
            np.testing.assert_allclose(_np(pt.rc_sum), _np(pj.rc_sum), rtol=1e-6)
        else:
            np.testing.assert_array_equal(_np(getattr(pt, f)),
                                          _np(getattr(pj, f)), err_msg=f)


# ---------------------------------------------------------------------------
# Quantization and packing
# ---------------------------------------------------------------------------


def test_quantize_pack_unpack_bitwise():
    rng = np.random.default_rng(0)
    Z = (rng.normal(size=(300, 64)) * 3).astype(np.float32)
    Z[:, 5] = 0.0
    Z[:, 7] *= 10          # saturates at the clip
    Zj, Zt = jnp.asarray(Z), torch.as_tensor(Z)
    for fj, ft in ((jb._quantize_z, tb._quantize_z),
                   (jb._quantize_z4_codes, tb._quantize_z4_codes),
                   (jb._quantize_z4, tb._quantize_z4)):
        (aj, sj), (at, st) = fj(Zj), ft(Zt)
        np.testing.assert_array_equal(_np(at), _np(aj))
        np.testing.assert_array_equal(_np(st), _np(sj))
    codes, _ = jb._quantize_z4_codes(Zj)
    ct = torch.as_tensor(np.array(codes))
    np.testing.assert_array_equal(_np(tb._pack_codes(ct[:, :32], ct[:, 32:])),
                                  _np(jb._pack_codes(codes[:, :32], codes[:, 32:])))
    packed = rng.integers(-128, 128, (50, 40)).astype(np.int8)
    np.testing.assert_array_equal(_np(tb._unpack_nibbles(torch.as_tensor(packed))),
                                  _np(jb._unpack_nibbles(jnp.asarray(packed))))
    with pytest.raises(ValueError, match="even gene count"):
        tb._pack_codes(ct[:, :3])


def test_tile_widths_match_reference():
    for n, t in ((8192, 4096), (5000, 2048), (700, 2048), (1500, 2048), (1, 4)):
        assert ts.tile_widths(n, t) == js.tile_widths(n, t)


# ---------------------------------------------------------------------------
# Plain crosses against the reference's XLA twins and Pallas kernels
# ---------------------------------------------------------------------------


def _int_operands(setup, G, packed, win, seed=0):
    """The same quantized operator built by both packages, plus random
    codes for one draw's gathered tables."""
    pj, pt = setup["pj"], setup["pt"]
    nbb = pj.local_idx.shape[0] // B
    n_padded = pj.local_idx.shape[0]
    rng = np.random.default_rng(seed)
    lim = 7 if packed else 127
    zp = rng.integers(-lim, lim + 1, ((nbb + 2) * B, G)).astype(np.int8)
    gidx = np.clip(np.arange((nbb + 2) * B) - B, 0, pj.n - 1)
    ops = tb._int_ops(pt, "int4" if packed else "int8",
                      "win" if win else "exact", use_plain=True)
    out = dict(zp=zp, ops=ops, nbb=nbb)
    if win:
        local_max = jnp.max(pj.w_local, axis=1)
        far_max = jnp.zeros((n_padded,), jnp.float32).at[pj.far_src - B].max(
            pj.far_w, mode="drop")
        rowmax = jnp.maximum(local_max, far_max)
        sw_row = jnp.where(rowmax > 0, rowmax / 127.0, 1.0)
        A8, sw = jb._build_band_i8(pj.local_idx, pj.w_local, B,
                                   row_scale=sw_row.reshape(nbb, B, 1))
        far_q = jnp.clip(jnp.round(pj.far_w / sw_row[pj.far_src - B]), 0, 127)
        S, nw, rowp, qp, rif, w_idx, starts0, runs = jb._win_far_pack(
            pj.far_src, pj.far_dst, pj.far_w, far_q, pj.far_starts,
            pj.order[jnp.asarray(gidx)], B, pj.far_bmax)
        zf = rng.integers(-lim, lim + 1, (nw * S, G)).astype(np.int8)
        out.update(jwin=(w_idx, starts0, runs, rowp, qp), S=S, nw=nw, zf=zf)
        # the port packs the same operator
        tS, tnw, trowp, tqp, tw_idx, tstarts, truns = ops.win_ops
        assert (tS, tnw) == (S, nw)
        for a, b in ((trowp, rowp), (tqp, qp), (tw_idx, w_idx),
                     (tstarts, starts0), (truns, runs)):
            np.testing.assert_array_equal(_np(a), _np(b))
    else:
        A8, sw = jb._build_band_i8(pj.local_idx, pj.w_local, B)
    np.testing.assert_array_equal(_np(ops.A8), _np(A8))
    np.testing.assert_array_equal(_np(ops.sw), _np(sw))
    out.update(A8=A8, sw=sw)
    return out


@pytest.mark.parametrize("win", [True, False], ids=["K2_win", "K3_band"])
def test_int8_cross_matches_reference(setup, win):
    o = _int_operands(setup, 128, packed=False, win=win)
    ops, nbb = o["ops"], o["nbb"]
    zp3 = o["zp"].reshape(nbb + 2, B, -1)
    zp_t = torch.as_tensor(o["zp"])
    if win:
        w_idx, starts0, runs, rowp, qp = o["jwin"]
        zf3 = o["zf"].reshape(o["nw"], o["S"], -1)
        want = jb._band_cross_win_i8_xla(w_idx, starts0, runs, o["A8"], o["sw"],
                                         jnp.asarray(zp3), jnp.asarray(zf3), rowp, qp)
        pallas = jb._band_cross_win_pallas_i8(
            w_idx, starts0, runs, o["A8"], o["sw"], jnp.asarray(zp3),
            jnp.asarray(zf3), rowp, qp, interpret=True)
        S, nw, trowp, tqp, tw_idx, tstarts, truns = ops.win_ops
        plain = tb._band_cross_win_i8_plain(
            tw_idx, tstarts, truns, ops.A8, ops.sw, torch.as_tensor(zp3),
            torch.as_tensor(zf3), trowp, tqp)
        ptr = tb._row_ptr(setup["pt"].far_src, tb._n_live_far(setup["pt"]), B,
                         ops.local_idx32.shape[0])
        far = dict(far_row_ptr=ptr, far_q=tqp.reshape(-1),
                   Zf=torch.as_tensor(o["zf"]))
        lag_dense = tb._band_lag_win_i8_plain(
            tw_idx, tstarts, truns, ops.A8, torch.as_tensor(zp3),
            torch.as_tensor(zf3), trowp, tqp)
    else:
        want = jb._band_cross_i8_xla(o["A8"], o["sw"], jnp.asarray(zp3))
        pallas = jb._band_cross_pallas_i8(o["A8"], o["sw"], jnp.asarray(zp3),
                                          interpret=True)
        plain = tb._band_cross_i8_plain(ops.A8, ops.sw, torch.as_tensor(zp3))
        far = {}
        lag_dense = kern.band_lag_dense(ops.A8, torch.as_tensor(zp3), 0, nbb)
    compact = kern.band_cross_int8(ops.local_idx32, ops.wq, ops.sw.reshape(-1),
                                   zp_t, B, packed=False, **far)
    lag_compact = kern.band_lag_int8_plain(ops.local_idx32, ops.wq, zp_t, B,
                                           packed=False, **far)
    np.testing.assert_array_equal(_np(lag_compact), _np(lag_dense))
    for got in (plain, compact, pallas):
        _close(got, want)


def test_int4_cross_matches_reference(setup):
    """K1: nibble-packed codes, windowed far — Pallas kernel in interpret
    mode against the port's dense twin and compact plain version."""
    o = _int_operands(setup, 256, packed=True, win=True)
    ops, nbb = o["ops"], o["nbb"]
    w_idx, starts0, runs, rowp, qp = o["jwin"]
    zpk = _np(tb._pack_codes(torch.as_tensor(o["zp"])))
    zfk = _np(tb._pack_codes(torch.as_tensor(o["zf"])))
    zpk3 = zpk.reshape(nbb + 2, B, -1)
    zfk3 = zfk.reshape(o["nw"], o["S"], -1)
    pallas = jb._band_cross_win_pallas_i4(
        w_idx, starts0, runs, o["A8"], o["sw"], jnp.asarray(zpk3),
        jnp.asarray(zfk3), rowp, qp, interpret=True)
    want = jb._band_cross_win_i8_xla(
        w_idx, starts0, runs, o["A8"], o["sw"],
        jnp.asarray(o["zp"].reshape(nbb + 2, B, -1)),
        jnp.asarray(o["zf"].reshape(o["nw"], o["S"], -1)), rowp, qp)
    S, nw, trowp, tqp, tw_idx, tstarts, truns = ops.win_ops
    plain = tb._band_cross_win_i8_plain(
        tw_idx, tstarts, truns, ops.A8, ops.sw,
        tb._unpack_nibbles(torch.as_tensor(zpk3)),
        tb._unpack_nibbles(torch.as_tensor(zfk3)), trowp, tqp)
    ptr = tb._row_ptr(setup["pt"].far_src, tb._n_live_far(setup["pt"]), B,
                     ops.local_idx32.shape[0])
    far = dict(far_row_ptr=ptr, far_q=tqp.reshape(-1), Zf=torch.as_tensor(zfk))
    compact = kern.band_cross_int8(ops.local_idx32, ops.wq, ops.sw.reshape(-1),
                                   torch.as_tensor(zpk), B, packed=True, **far)
    # packed and unpacked compact lags are the same integers
    lag4 = kern.band_lag_int8_plain(ops.local_idx32, ops.wq, torch.as_tensor(zpk),
                                    B, packed=True, **far)
    lag8 = kern.band_lag_int8_plain(
        ops.local_idx32, ops.wq, torch.as_tensor(o["zp"]), B, packed=False,
        far_row_ptr=ptr, far_q=tqp.reshape(-1), Zf=torch.as_tensor(o["zf"]))
    np.testing.assert_array_equal(_np(lag4), _np(lag8))
    for got in (plain, compact, pallas):
        _close(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_float_cross_matches_reference(setup, dtype):
    """K4: the halo Pallas kernel (interpret mode) accumulates the lag in
    float32, as the port's kernel and plain versions do."""
    pj, pt = setup["pj"], setup["pt"]
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    nbb = pj.local_idx.shape[0] // B
    zp = np.random.default_rng(1).normal(size=((nbb + 2) * B, 96)).astype(np.float32)
    zp_j = jnp.asarray(zp).astype(jdt)
    zp_t = torch.as_tensor(np.array(zp_j.astype(jnp.float32))).to(tdt)
    A = jb._build_band(pj.local_idx, pj.w_local, B, jdt)
    At = tb._build_band(pt.local_idx, pt.w_local.to(tdt), B, tdt)
    np.testing.assert_array_equal(_np(At.float()), _np(A.astype(jnp.float32)))
    pallas = jb._band_cross_pallas_halo(A, zp_j.reshape(nbb + 2, B, -1),
                                        interpret=True)
    plain = kern.band_cross_dense_plain(At, zp_t, B)
    li32 = pt.local_idx.to(torch.int32)
    w_c = pt.w_local.to(tdt)
    compact = kern.band_cross_float(li32, w_c, zp_t, B)
    # compact and dense lags: equal where the lag is exact (f32 operands
    # with k=6 equal weights round identically; bf16 products are exact)
    lag_c = kern.band_lag_float_plain(li32, w_c, zp_t, B)
    lag_d = kern.band_lag_dense(At, zp_t.reshape(nbb + 2, B, -1), 0, nbb)
    np.testing.assert_allclose(_np(lag_c), _np(lag_d), rtol=1e-6, atol=1e-6)
    for got in (plain, compact):
        _close(got, pallas)


# ---------------------------------------------------------------------------
# The permutation test on one plan
# ---------------------------------------------------------------------------


def _counts(p, P):
    return np.round(_np(p) * (P + 1) - 1)


@pytest.mark.parametrize("precision,stat,band_impl,far_mode", [
    ("int4", "moran", "auto", "auto"),
    ("int4", "geary", "xla", "auto"),
    ("int8", "moran", "auto", "auto"),
    ("int8", "geary", "auto", "exact"),
    ("int8", "moran", "xla", "exact"),
    ("f32", "moran", "auto", "auto"),
    ("f32", "geary", "xla", "auto"),
])
def test_permutation_test_matches_reference(setup, precision, stat, band_impl,
                                            far_mode):
    P = 49
    alt = "greater" if stat == "moran" else "less"
    obs_fn = (jm.moran_observed, tm.moran_observed) if stat == "moran" else \
        (jm.geary_observed, tm.geary_observed)
    obs_j = obs_fn[0](setup["gj"], setup["Zj"], setup["S0"])
    obs_t = obs_fn[1](setup["gt"], setup["Zt"], setup["S0"])
    pj, mj, sj = jb.banded_permutation_test(
        setup["pj"], setup["Zj"], setup["S0"], obs_j, seed=5, n_permutations=P,
        stat=stat, alternative=alt, precision=precision, far_mode=far_mode)
    pt, mt, st = tb.banded_permutation_test(
        setup["pt"], setup["Zt"], setup["S0"], obs_t, seed=5, n_permutations=P,
        stat=stat, alternative=alt, precision=precision, band_impl=band_impl,
        far_mode=far_mode)
    assert np.abs(_counts(pt, P) - _counts(pj, P)).max() <= 1
    np.testing.assert_allclose(_np(mt), _np(mj), rtol=1e-5,
                               atol=1e-5 * float(np.abs(_np(mj)).max()))
    # std = sqrt(E[v²] − mean²) cancels for Geary (values ≈ 1, spread ≈ 0.02):
    # hold the raw second moment E[v²] = std² + mean² to rtol 1e-5 instead
    np.testing.assert_allclose(_np(st) ** 2 + _np(mt) ** 2,
                               _np(sj) ** 2 + _np(mj) ** 2, rtol=1e-5)


def test_bf16_permutation_test_matches_reference(setup):
    """bf16: the reference's XLA path rounds the lag to bf16, the port (like
    the Pallas kernel) keeps it in float32 — p within 0.05."""
    obs_j = jm.moran_observed(setup["gj"], setup["Zj"], setup["S0"])
    obs_t = tm.moran_observed(setup["gt"], setup["Zt"], setup["S0"])
    pj, _, _ = jb.banded_permutation_test(setup["pj"], setup["Zj"], setup["S0"],
                                          obs_j, seed=3, n_permutations=49)
    pt, _, _ = tb.banded_permutation_test(setup["pt"], setup["Zt"], setup["S0"],
                                          obs_t, seed=3, n_permutations=49)
    assert np.abs(_np(pt) - _np(pj)).max() <= 0.05


@pytest.mark.parametrize("precision", ["int4", "int8", "bf16"])
def test_draw_offset_chunks_bitwise(setup, precision):
    """Chunked draw_offset runs reproduce the unchunked counts bitwise."""
    obs = tm.moran_observed(setup["gt"], setup["Zt"], setup["S0"])
    P = 20
    p_full, _, _ = tb.banded_permutation_test(
        setup["pt"], setup["Zt"], setup["S0"], obs, seed=6, n_permutations=P,
        precision=precision)
    total = 0
    for off, pc in ((0, 8), (8, 8), (16, 4)):
        p_c, _, _ = tb.banded_permutation_test(
            setup["pt"], setup["Zt"], setup["S0"], obs, seed=6,
            n_permutations=pc, precision=precision, draw_offset=off)
        total = total + _counts(p_c, pc)
    np.testing.assert_array_equal(total, _counts(p_full, P))


def test_prepacked_int4_matches_inline(setup):
    """Pre-packed (Zpk, sz) tables give the inline route's p bitwise; the
    null mean differs only by the den convention (Σz² inline, Σ(c·s)²
    pre-packed), a per-gene positive factor — as the reference's test."""
    G = setup["Zt"].shape[1]
    Zpad = torch.nn.functional.pad(setup["Zt"], (0, 256 - G))
    obs = torch.nn.functional.pad(
        tm.moran_observed(setup["gt"], setup["Zt"], setup["S0"]), (0, 256 - G))
    Zpk, s4 = tb._quantize_z4(Zpad)
    p_in, m_in, _ = tb.banded_permutation_test(
        setup["pt"], Zpad, setup["S0"], obs, seed=3, n_permutations=29,
        precision="int4")
    p_pk, m_pk, _ = tb.banded_permutation_test(
        setup["pt"], Zpk, setup["S0"], obs, seed=3, n_permutations=29,
        precision="int4", sz=s4)
    np.testing.assert_array_equal(_np(p_pk), _np(p_in))
    np.testing.assert_allclose(_np(m_pk), _np(m_in), rtol=0.06, atol=1e-7)
    with pytest.raises(ValueError, match="256-multiple"):
        tb.banded_permutation_test(setup["pt"], Zpk[:, :70], setup["S0"],
                                   obs[:140], seed=3, n_permutations=9,
                                   precision="int4", sz=s4)


def test_unported_options_raise(setup):
    obs = tm.moran_observed(setup["gt"], setup["Zt"], setup["S0"])
    args = (setup["pt"], setup["Zt"], setup["S0"], obs, 0, 3)
    # the local nulls take the "sort" stream too: the reference's draws
    p = tb.banded_local_moran_pvalues(setup["pt"], setup["Zt"], 0, 3,
                                      perm_method="sort")
    want = jb.banded_local_moran_pvalues(setup["pj"], setup["Zj"], 0, 3,
                                         perm_method="sort", band_impl="xla")
    np.testing.assert_array_equal(_np(p), np.asarray(want))
    for fn, jfn in ((tb.banded_local_geary, jb.banded_local_geary),
                    (tb.banded_getis, jb.banded_getis)):
        got = fn(setup["pt"], setup["Zt"], 0, 3, precision="int8",
                 perm_method="sort")
        want = jfn(setup["pj"], setup["Zj"], 0, 3, precision="int8",
                   perm_method="sort", band_impl="xla")
        if isinstance(got, tuple):
            got, want = got[1], want[1]
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    with pytest.raises(ValueError, match="perm_method"):
        tb.banded_permutation_test(*args, perm_method="shuffle")
    with pytest.raises(ValueError, match="band_impl"):
        tb.banded_permutation_test(*args, band_impl="bogus")
    with pytest.raises(ValueError, match="far_mode='win'"):
        tb.banded_permutation_test(*args, precision="f32", far_mode="win")


@pytest.mark.parametrize("esz", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("k", [1, 6, 32, 50, 64, 128, 256])
def test_float_tiles_fit_shared_memory(esz, k):
    """K4's launch shape for every block the wrapper takes: its shared
    memory fits one H100 block, its ring rows are whole 16-byte lanes, and
    the band chunk is 1..B rows (the whole block where it fits)."""
    for block in range(1, kern.MAX_BLOCK + 1):
        for G, n_blocks in ((1024, 3907), (33, 1)):
            t = kern.float_tiles(block, k, esz, G, n_blocks)
            assert t.smem == kern.float_smem_bytes(block, k, esz, t.gt, t.chunk)
            assert t.smem <= 232_448
            assert (t.gt * esz) % 16 == 0 and 1 <= t.chunk <= block
            assert t.run >= 1
    assert kern.float_tiles(256, 6, 2, 1024, 3907) == (64, 32, 256, 149_568)
    assert kern.float_tiles(256, 50, 2, 1024, 3907).chunk < 256


@pytest.mark.parametrize("packed", [True, False], ids=["int4", "int8"])
@pytest.mark.parametrize("k", [1, 6, 32, 50, 64, 128, 256])
def test_int_tiles_fit_shared_memory(packed, k):
    """K1–K3's launch shape for every block the wrapper takes: its shared
    memory fits one H100 block, the column tile is whole 16-byte lanes (a
    power of two up to 256 bytes), the band chunk is 1..B rows (the whole
    block where it fits) and at most a far entry a chunk row is staged."""
    for block in range(1, kern.MAX_BLOCK + 1):
        for G, n_blocks in ((4096, 3907), (1000, 7), (8, 1)):
            t = kern.int_tiles(block, k, packed, G, n_blocks)
            assert t.smem == kern.int_smem_bytes(block, k, packed, t.tile,
                                                 t.chunk, t.far_cap)
            assert t.smem <= 232_448
            assert t.tile % 16 == 0 and 16 <= t.tile <= 256
            assert t.tile & (t.tile - 1) == 0
            assert 1 <= t.chunk <= block and t.run >= 1
            assert 0 <= t.far_cap <= t.chunk
    assert kern.int_tiles(256, 6, True, 4096, 3907) == (128, 32, 256, 256,
                                                        216_800)
    assert kern.int_tiles(256, 50, True, 4096, 3907).chunk < 256


@pytest.mark.parametrize("width", [3, 4], ids=["K5", "K6"])
@pytest.mark.parametrize("esz", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("block", range(16, kern.DENSE_MAX_BLOCK + 1, 16))
def test_dense_tiles_fit_shared_memory(block, esz, width):
    """K5's / K6's launch shape for every block the kernels take (a
    multiple of 16 up to 256): the default is a built shape that fits one
    H100 block and skips; every built shape either fits and is mirrored by
    dense_smem_bytes, or is refused, and a shape not built is refused."""
    t = kern.dense_tiles(block, width, esz)
    assert (t.mt, t.stages) in kern.DENSE_SHAPES and t.skip
    assert t.smem == kern.dense_smem_bytes(block, width, esz, *t[:2]) <= 232_448
    for shape in kern.DENSE_SHAPES:
        smem = kern.dense_smem_bytes(block, width, esz, *shape)
        if smem <= 232_448:
            assert kern.dense_tiles(block, width, esz, shape, skip=False) == (
                *shape, False, smem)
        else:
            with pytest.raises(ValueError, match="shared memory"):
                kern.dense_tiles(block, width, esz, shape)
    with pytest.raises(ValueError, match="built for"):
        kern.dense_tiles(block, width, esz, (64, 2))


@pytest.mark.parametrize("width", [3, 4], ids=["K5", "K6"])
@pytest.mark.parametrize("rows,cols", [(16, 16), (64, 16), (48, 32)])
def test_nonzero_tiles_counts_the_band_tiles(setup, width, rows, cols):
    """``kern.nonzero_tiles`` (the tiles the dense kernels multiply, and
    chip_smoke's operation count) against a numpy count on the test plan's
    dense band, with ragged tiles (48 rows of B=64)."""
    pt = setup["pt"]
    build = tb._build_band if width == 3 else tb._build_band_rot4
    A = build(pt.local_idx, pt.w_local, B, torch.float32)
    A[0, :rows] = 0                     # one block's first row tiles empty
    nz = A.numpy() != 0
    want = sum(bool(nz[n, r:r + rows, c:c + cols].any())
               for n in range(nz.shape[0]) for r in range(0, nz.shape[1], rows)
               for c in range(0, nz.shape[2], cols))
    assert kern.nonzero_tiles(A, rows, cols) == want
    assert 0 < want < nz.shape[0] * -(-B // rows) * (width * B // cols)


# ---------------------------------------------------------------------------
# The benchmark's contract: one row source, one draw loop
# ---------------------------------------------------------------------------


def _null_run(setup, null: str, precision: str, perm_method: str, P: int):
    """One banded null on the tiny plan: its outputs."""
    pt, Zt = setup["pt"], setup["Zt"]
    kw = dict(perm_method=perm_method)
    if null == "global":
        obs = tm.moran_observed(setup["gt"], Zt, setup["S0"])
        return tb.banded_permutation_test(pt, Zt, setup["S0"], obs, seed=5,
                                          n_permutations=P, precision=precision,
                                          draw_offset=2, **kw)
    if null == "moran":
        return tb.banded_local_moran(pt, setup["gt"], Zt, 3, P,
                                     precision=precision, **kw).p_value
    if null == "geary":
        return tb.banded_local_geary(pt, Zt, 3, P, precision=precision, **kw)
    if null == "getis":
        return tb.banded_getis(pt, Zt.abs(), 3, P, precision=precision, **kw)
    return tb.banded_lees_l(pt, Zt[:, :10], Zt[:, 10:], 3, P,
                            precision=precision, compute_cell_pvalues=True, **kw)


@pytest.mark.parametrize("perm_method", ["feistel", "sort"])
@pytest.mark.parametrize("null,precision", [
    ("global", "f32"), ("global", "int8"), ("global", "int4"),
    ("moran", "int8"), ("moran", "f32"), ("geary", "int8"), ("geary", "f32"),
    ("getis", "int8"), ("getis", "f32"), ("lee", "int8"), ("lee", "f32")])
def test_draw_loop_calls_the_module_global_walk(setup, monkeypatch, null,
                                                precision, perm_method):
    """Every draw loop looks up ``ops.banded.feistel_apply`` once a draw,
    on the padded rows alone (the traced benchmark run wraps that global),
    and counts each draw in ``draws``; the "sort" stream never walks. The
    global int nulls read their far values from the gathered table: p
    bitwise the reference's, which walks the far targets separately."""
    P = 7
    walks = []
    walk = tb.feistel_apply

    def counting(k, idx, n):
        walks.append(idx.numel())
        return walk(k, idx, n)

    monkeypatch.setattr(tb, "feistel_apply", counting)
    draws0 = prof.counters().get("draws", 0)
    got = _null_run(setup, null, precision, perm_method, P)
    assert prof.counters()["draws"] - draws0 == P
    if perm_method == "sort":
        assert walks == []
    else:
        assert walks == [setup["pt"].n_padded + 2 * B] * P
    if null == "global" and precision != "f32":
        obs = jm.moran_observed(setup["gj"], setup["Zj"], setup["S0"])
        want = jb.banded_permutation_test(
            setup["pj"], setup["Zj"], setup["S0"], obs, seed=5, n_permutations=P,
            precision=precision, perm_method=perm_method, draw_offset=2,
            band_impl="xla")
        np.testing.assert_array_equal(_np(got[0]), _np(want[0]))
        for g, w in zip(got[1:], want[1:]):
            _close(g, w)


def _gathered_rows(setup, null: str, precision: str, P: int, **kw) -> int:
    """``ops.banded.gather_rows`` counted over one banded null of P draws."""
    before = prof.counters().get("ops.banded.gather_rows", 0)
    if kw:
        tb.banded_local_moran_pvalues(setup["pt"]._replace(far_starts=None,
                                                            far_bmax=0),
                                      setup["Zt"], 3, P, **kw)
    else:
        _null_run(setup, null, precision, "feistel", P)
    return prof.counters()["ops.banded.gather_rows"] - before


@pytest.mark.parametrize("null,precision,dense", [
    ("global", "f32", False), ("global", "int8", False), ("global", "int4", False),
    ("moran", "int8", False), ("moran", "int8", True), ("moran", "f32", False),
    ("geary", "int8", False), ("geary", "f32", False), ("getis", "int8", False),
    ("getis", "f32", False), ("lee", "int8", False), ("lee", "f32", False)])
def test_draw_loop_gathers_only_what_its_step_copies(setup, null, precision,
                                                     dense):
    """The rows ``ops.banded.gather_rows`` counts a draw (the difference of
    runs of 6 and 3 draws): none for the int8 local nulls, whose draw steps
    read the table through the draw's rows, but the far values of K8's
    dense layer; every padded row (and the global int null's far rows) for
    the float nulls and the global nulls, which still gather."""
    pt = setup["pt"]
    kw = dict(band_impl="pallas") if dense else {}
    per_draw = (_gathered_rows(setup, null, precision, 6, **kw)
                - _gathered_rows(setup, null, precision, 3, **kw)) / 3
    rows = pt.n_padded + 2 * B
    if dense:
        want = tb._n_live_far(pt)
    elif precision == "int8" and null != "global":
        want = 0
    elif null == "global" and precision != "f32":
        want = rows + tb._int_ops(pt, precision, "win", use_plain=True
                                  ).far_rows.numel()
    else:
        want = rows
    assert per_draw == want


def _k7_operands(pt, seed: int = 11):
    """A random draw of ``pt``'s int8 local operands: codes of the cells read
    through a random permutation's padded rows (whose padding repeats the
    first and last cell), the far list as row pointers and as K8's dense
    layer."""
    gen = torch.Generator().manual_seed(seed)
    wq, _, far_q = tb._full_row_codes(pt)
    lo = tb._local_setup(pt, "cpu")
    table = torch.randint(-127, 128, (pt.n, 12), generator=gen, dtype=torch.int8)
    rows = torch.randperm(pt.n, generator=gen)[lo.rows_idx]
    assert rows[:B].unique().numel() == 1 and rows[-B:].unique().numel() == 1
    fq = far_q[:lo.n_live]
    Zp = table[rows]
    Zf = Zp[lo.far_dst]
    dense = torch.zeros((pt.n_padded, 12), dtype=torch.int32).index_add_(
        0, lo.far_row, Zf.to(torch.int32) * fq.to(torch.int32)[:, None])
    far = dict(far_row_ptr=lo.ptr, far_q=fq.to(torch.int8))
    return lo.li, wq, table, rows, Zp, Zf, far, rows[lo.far_dst], dense


@pytest.mark.parametrize("form", ["rows", "dense", "none"])
def test_lisa_plain_reads_through_rows_as_the_gathered_table(setup, form):
    """K7's moran entries on ``(table, rows)``: bitwise the old form, the
    statistic on the gathered table ``Zp = table[rows]`` and far values
    ``Zp[far_dst]``, for each far form, on a random permutation's rows."""
    li, wq, table, rows, Zp, Zf, far, far_rows, dense = _k7_operands(setup["pt"])
    n = li.shape[0]
    if form == "rows":
        kw = dict(far, far_rows=far_rows)
        old = (far["far_row_ptr"], far["far_q"], Zf, None)
    elif form == "dense":
        kw, old = dict(far=dense), (None, None, None, dense)
    else:
        kw, old = {}, (None, None, None, None)
    want = kern_lisa._abs_ip_plain(li, wq, Zp, B, *old, 0, n)
    got = kern_lisa.lisa_observed(li, wq, table, rows, B, **kw)
    assert torch.equal(got, want)
    obs = want.flip(0).contiguous()
    cnt = torch.zeros_like(want, dtype=torch.int16)
    kern_lisa.lisa_count(li, wq, table, rows, B, obs, cnt, **kw)
    assert torch.equal(cnt, (want >= obs).to(torch.int16))
    assert 0 < int(cnt.sum()) < cnt.numel()


def test_geary_plain_reads_through_rows_as_the_gathered_table(setup):
    """K7's geary entries on ``(table, rows)``: bitwise the geary value of
    the gathered table and its far values, on a random permutation's rows
    with the plan's repeated padding rows."""
    li, wq, table, rows, Zp, Zf, far, far_rows, _ = _k7_operands(setup["pt"], 12)
    n = li.shape[0]
    lo = tb._local_setup(setup["pt"], "cpu")
    w_code = wq.to(torch.int32).sum(1, dtype=torch.int32).index_add_(
        0, lo.far_row, far["far_q"].to(torch.int32))
    want = kern_lisa._geary_plain(li, wq, Zp, B, w_code, far["far_row_ptr"],
                                  far["far_q"], Zf, 0, n)
    got = kern_lisa.geary_observed(li, wq, table, rows, B, w_code,
                                   far_rows=far_rows, **far)
    assert torch.equal(got, want)
    obs = want.flip(0).contiguous()
    cnt = torch.zeros_like(want, dtype=torch.int8)
    kern_lisa.geary_count(li, wq, table, rows, B, obs, cnt, w_code,
                          far_rows=far_rows, **far)
    assert torch.equal(cnt, (want <= obs).to(torch.int8))


def _rif_walk_int_null(pt, Z, S0, seed, P, precision, perm_method, draw0,
                       band_impl):
    """The global int8/int4 windowed null as it drew before its far values
    came from the gathered table: one walk over the padded rows AND the far
    targets' original-space rows ``rif``, the far values gathered at the
    walked ``rif`` (p, null mean, null std; Moran, "greater")."""
    G = Z.shape[1]
    Z = torch.nn.functional.pad(Z, (0, (-G) % (256 if precision == "int4" else 128)))
    Ztab, s_z = tb._quantize_z4(Z) if precision == "int4" else tb._quantize_z(Z)
    den = kern.tree_sum(Z.to(torch.float32) ** 2, 512)
    den = torch.where(den > 0, den, torch.ones_like(den))
    rows_idx = tb._padded_rows(pt, Z.device)
    use_plain = band_impl == "xla"
    ops = tb._int_ops(pt, precision, "win", use_plain)
    S, nw = ops.win_ops[:2]
    far_dst = pt.far_dst
    rif = rows_idx[torch.nn.functional.pad(far_dst, (0, nw * S - far_dst.shape[0]))]

    def value(rows, rowsf):
        return tb._banded_stat_int(ops, pt.rc_sum, Ztab[rows], Ztab[rowsf],
                                   s_z * s_z, den, S0, n=pt.n, stat="moran",
                                   use_plain=use_plain)

    observed = value(rows_idx, rif)
    sort = perm_method == "sort"
    base = key_for(seed, "perm_global" if sort else "perm_feistel", 0)
    idx_all = torch.cat([rows_idx, rif])
    L = rows_idx.shape[0]
    count = torch.zeros(Z.shape[1], dtype=torch.int32)
    s1 = torch.zeros(Z.shape[1], dtype=torch.float32)
    s2 = torch.zeros(Z.shape[1], dtype=torch.float32)
    for step in range(draw0, draw0 + P):
        key = fold_in(base, step)
        perm_rows = (permutation(key, pt.n, device=Z.device)[idx_all] if sort
                     else feistel_apply(key, idx_all, pt.n))
        vals = value(perm_rows[:L], perm_rows[L:])
        count += (vals >= observed).to(torch.int32)
        s1 += vals
        s2 += vals * vals
    inv_p = torch.tensor(1.0, dtype=torch.float32) / P
    mean = s1 * inv_p
    var = torch.clamp_min(s2 * inv_p - mean ** 2, 0.0)
    return tb._p_from_counts(count, P)[:G], mean[:G], torch.sqrt(var)[:G]


@pytest.mark.parametrize("band_impl", ["auto", "xla"])
@pytest.mark.parametrize("perm_method", ["feistel", "sort"])
@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_int_null_far_values_from_the_gathered_table_are_bitwise(
        setup, precision, perm_method, band_impl):
    """Reading the far values as the gathered table's rows ``Zp[far_rows]``
    leaves the global int null bitwise what the separate walk of the far
    targets gave: p, null mean and null std, on both streams, kernel
    wrapper and plain twin."""
    pt, Zt, S0 = setup["pt"], setup["Zt"], setup["S0"]
    assert pt.far_starts is not None and tb._n_live_far(pt) > 0
    obs = tm.moran_observed(setup["gt"], Zt, S0)
    got = tb.banded_permutation_test(pt, Zt, S0, obs, seed=5, n_permutations=9,
                                     precision=precision, perm_method=perm_method,
                                     band_impl=band_impl, far_mode="win",
                                     draw_offset=2)
    want = _rif_walk_int_null(pt, Zt, S0, 5, 9, precision, perm_method, 2,
                              band_impl)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_refuses_bad_operands(setup):
    pt = setup["pt"]
    li = pt.local_idx.to(torch.int32)
    wq = torch.zeros_like(li, dtype=torch.int8)
    sw = torch.ones(li.shape[0])
    zp = torch.zeros(li.shape[0] + 2 * B, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="local_idx"):
        kern.band_cross_int8(pt.local_idx, wq, sw, zp, B, packed=False)
    with pytest.raises(ValueError, match="multiple of 4 columns"):
        kern.band_cross_int8(li, wq, sw, zp[:, :126].contiguous(), B, packed=False)
    with pytest.raises(ValueError, match="share a dtype"):
        kern.band_cross_float(li, pt.w_local, zp.to(torch.bfloat16), B)
    assert kern.band_cross_int8(li, wq, sw, zp, B, packed=False).shape == (128,)
