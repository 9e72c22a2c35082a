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
from spatialcore_tpu_torch.kernels import band_cross as kern
from spatialcore_tpu_torch.ops import banded as tb
from spatialcore_tpu_torch.ops import graph as tg
from spatialcore_tpu_torch.ops import moran as tm
from spatialcore_tpu_torch.ops import streaming as ts

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
    rows_idx_t = pt.order[torch.as_tensor(gidx)]
    ops, _ = tb._int_ops(pt, "int4" if packed else "int8",
                         "win" if win else "exact", rows_idx_t, use_plain=True)
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
        ptr = tb._far_row_ptr(setup["pt"].far_src, setup["pt"].far_starts, B,
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
    ptr = tb._far_row_ptr(setup["pt"].far_src, setup["pt"].far_starts, B,
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
    # the local nulls' "sort" stream comes with the local slot nulls
    for fn in (tb.banded_local_moran_pvalues, tb.banded_local_geary,
               tb.banded_getis):
        with pytest.raises(NotImplementedError, match="local slot nulls"):
            fn(setup["pt"], setup["Zt"], 0, 3, perm_method="sort")
    with pytest.raises(ValueError, match="perm_method"):
        tb.banded_permutation_test(*args, perm_method="shuffle")
    with pytest.raises(ValueError, match="band_impl"):
        tb.banded_permutation_test(*args, band_impl="bogus")
    with pytest.raises(ValueError, match="far_mode='win'"):
        tb.banded_permutation_test(*args, precision="f32", far_mode="win")


@pytest.mark.parametrize("esz", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("k", [1, 6, 50, 256])
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
@pytest.mark.parametrize("k", [1, 6, 50, 256])
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
