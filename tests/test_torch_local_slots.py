"""The port's local slot nulls, their conditional draws, the join counts,
the multivariate local Geary and the local "sort" streams against the JAX
package, on the CPU.

Tolerances, and why:
- ``permutation_keys``, ``batch_permutations``, ``choice`` without
  replacement and the conditional draw indices: bitwise (the same threefry
  integers).
- slot-null p-values (local Moran and local Geary, total and conditional;
  Getis-Ord Gi* / Gi under every alternative) on continuous data: bitwise
  against the reference's jit-compiled scan, given the same Z. Both add the
  k slots in slot order in float32, and p = (count + 1)·f32(1/(P+1)) is
  the expression XLA compiles the reference's division into.
- on integer-valued data the counts are bitwise the reference's run op by
  op (``jax.disable_jit()``). Its jit-compiled scan counts exact ties of
  the statistic otherwise (XLA rounds the observed and the drawn values
  apart), up to 6 of 19 draws per cell here; that is a defect of the
  reference (ROADMAP Queue 3), so nothing here pins the jitted counts on
  such data.
- observed I / lag / C / Gi z: within 1e-5 relative to Σ|terms| (float32
  summation order).
- Getis column sums above 2²⁴: the port sums them in float64 and is
  permutation-invariant, the reference re-sums each permuted column in
  float32 (ROADMAP Queue 3); counts within 2 draws and at least 90% equal
  there (measured: 2.0–5.5% differ).
- join counts BB / WW / BW and their p-values: bitwise (integers in
  float32 below 2²⁴); local join counts: BB and p bitwise.
- multivariate local Geary: c within 1e-5 relative, counts within one draw
  (torch's and XLA's row sums over the variables add in other orders).
- int8 "sort" streams of the banded LISA, local Geary and Getis nulls:
  counts bitwise against the reference's XLA body and its Pallas kernel K7
  in interpret mode; the float32 sort streams within one draw; the f32
  banded LISA on the sort stream against the slot null: within one draw.
- the public functions on continuous data: obsm statistics within 1e-5,
  p / p_adj within one draw for every entry and equal for at least 99.9%
  (the two packages standardize with float32 sums in different orders);
  on integer data standardized exactly (n = 1,024, columns summing to 0)
  their counts are bitwise the reference's op-by-op run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import spatialcore_tpu.spatial as scts
from spatialcore_tpu import SpatialData as JSpatialData
from spatialcore_tpu.core import rng as jr
from spatialcore_tpu.ops import banded as jb
from spatialcore_tpu.ops import getis as jgo
from spatialcore_tpu.ops import graph as jg
from spatialcore_tpu.ops import moran as jm
from spatialcore_tpu.spatial import autocorrelation as jac
import spatialcore_tpu_torch as sctt
from spatialcore_tpu_torch.core import rng as tr
from spatialcore_tpu_torch.ops import banded as tb
from spatialcore_tpu_torch.ops import getis as tgo
from spatialcore_tpu_torch.ops import graph as tg
from spatialcore_tpu_torch.ops import moran as tm
from spatialcore_tpu_torch.spatial import autocorrelation as tac

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

B = 64
P = 29
ALTS = ["two-sided", "greater", "less"]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _counts(p, n_perm):
    return np.round(_np(p).astype(np.float64) * (n_perm + 1)).astype(np.int64)


def _graphs(coords):
    gj = jg.build_graph(coords, n_neighbors=6)
    return gj, tg.graph_from_numpy(gj, device="cpu")


@pytest.fixture(scope="module")
def setup():
    """1,000 uniform cells, 8 continuous genes (half with a smooth
    signal), a block-64 null plan with far edges, and raw counts."""
    rng = np.random.default_rng(7)
    n, g = 1000, 8
    coords = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    X = np.concatenate(
        [np.sin(coords[:, :1] / 9.0) * 2 + rng.normal(0, 0.5, (n, g // 2)),
         rng.normal(0, 1, (n, g - g // 2))], axis=1).astype(np.float32)
    gj, gt = _graphs(coords)
    pj = jb.build_null_plan(gj, coords, block=B)
    assert pj.far_bmax > 0                        # the plan has far edges
    Zj, _ = jm.standardize(jnp.asarray(X))
    counts = rng.poisson(3.0, (n, g)).astype(np.float32)
    counts[:, :4] += np.round(4 * np.maximum(np.sin(coords[:, :1] / 15.0), 0))
    return dict(coords=coords, X=X, gj=gj, gt=gt, pj=pj,
                pt=tb.plan_from_numpy(pj, "cpu"), Zj=Zj,
                Zt=torch.as_tensor(np.array(Zj)), counts=counts)


def _exact_integers(n=1024, g=4, seed=3):
    """Integer values whose columns sum to 0 at n = 1,024 cells: every
    float32 mean and variance is exact, so both packages standardize them
    to the same bits."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    X = (np.round(3 * np.sin(coords[:, :1] / 12.0 + np.arange(g)))
         + rng.integers(-2, 3, (n, g))).astype(np.float32)
    X[-1] -= X.sum(axis=0)
    return coords, X


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n_perm,stream", [
    (0, 3, "perm"), (5, 4, "abc"), (123, 1, "perm_local"), (2**31 + 5, 6, "x")])
def test_permutation_keys_bitwise(seed, n_perm, stream):
    want = np.asarray(jax.random.key_data(
        jr.permutation_keys(seed, n_perm, stream))).astype(np.int64)
    np.testing.assert_array_equal(
        tr.permutation_keys(seed, n_perm, stream).numpy(), want)


@pytest.mark.parametrize("seed,n,n_perm", [(0, 10, 3), (5, 7, 4), (9, 1, 2),
                                           (123, 1700, 2)])
def test_batch_permutations_bitwise(seed, n, n_perm):
    want = np.asarray(jr.batch_permutations(seed, n, n_perm))
    got = tr.batch_permutations(seed, n, n_perm, device="cpu").numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,m,k", [(0, 6, 6), (1, 7, 6), (2, 1000, 6),
                                      (3, 2000, 50)])
def test_choice_without_replacement_bitwise(seed, m, k):
    key = jr.key_for(seed, "x", 0)
    want = np.asarray(jax.random.choice(key, m, (k,), replace=False))
    got = tr._choice(tr.key_for(seed, "x", 0), m, k, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="without replacement"):
        tr._choice(tr.key_for(seed, "x", 0), k - 1, k, device="cpu")


@pytest.mark.parametrize("seed,n,k", [(0, 7, 6), (1, 8, 6), (2, 1000, 6),
                                      (3, 1700, 12)])
def test_conditional_draw_indices_bitwise(seed, n, k):
    for d in (0, 3):
        want = jm._conditional_draw_indices(
            jax.random.fold_in(jr.key_for(seed, "perm_local", 0), d), n, k)
        got = tm._conditional_draw_indices(
            tr.fold_in(tr.key_for(seed, "perm_local", 0), d), n, k, "cpu")
        assert len(got) == k
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        slots = torch.stack(got, dim=1)
        cells = torch.arange(n)[:, None]
        assert not bool((slots == cells).any())            # never the cell
        assert bool((slots.sort(dim=1).values.diff(dim=1) > 0).all())


# ---------------------------------------------------------------------------
# The slot nulls (ops)
# ---------------------------------------------------------------------------


def _rel_close(got, want, terms):
    """|got − want| ≤ 1e-5·Σ|terms| elementwise (float32 summation order)."""
    assert (np.abs(_np(got) - _np(want)) <= 1e-5 * _np(terms) + 1e-7).all()


@pytest.mark.parametrize("null", ["total", "conditional"])
def test_local_moran_slot_null_bitwise(setup, null):
    rj = jm.local_moran(setup["gj"], setup["Zj"], 5, P, null=null)
    rt = tm.local_moran(setup["gt"], setup["Zt"], 5, P, null=null)
    np.testing.assert_array_equal(_np(rt.p_value), _np(rj.p_value))
    terms = np.abs(_np(setup["Zt"])) * tm.spatial_lag(
        setup["gt"], setup["Zt"].abs()).numpy()
    _rel_close(rt.local_I, rj.local_I, terms)
    _rel_close(rt.lag, rj.lag, tm.spatial_lag(setup["gt"], setup["Zt"].abs()))
    assert 0.0 < float((rt.p_value <= 0.05).float().mean()) < 0.5


@pytest.mark.parametrize("null", ["total", "conditional"])
def test_local_geary_slot_null_bitwise(setup, null):
    rj = jm.local_geary(setup["gj"], setup["Zj"], 5, P, null=null)
    rt = tm.local_geary(setup["gt"], setup["Zt"], 5, P, null=null)
    np.testing.assert_array_equal(_np(rt.p_value), _np(rj.p_value))
    _rel_close(rt.local_C, rj.local_C, rt.local_C)         # all terms ≥ 0


@pytest.mark.parametrize("star", [True, False], ids=["Gi_star", "Gi"])
@pytest.mark.parametrize("alternative", ALTS)
def test_getis_slot_null_bitwise(setup, star, alternative):
    X = setup["X"] + 3.0
    rj = jgo.getis_ord(setup["gj"], jnp.asarray(X), star=star,
                       alternative=alternative, seed=4, n_permutations=P)
    rt = tgo.getis_ord(setup["gt"], torch.as_tensor(X), star=star,
                       alternative=alternative, seed=4, n_permutations=P)
    np.testing.assert_array_equal(_np(rt.p_sim), _np(rj.p_sim))
    np.testing.assert_allclose(_np(rt.z_score), _np(rj.z_score), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(rt.G), _np(rj.G), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("case", ["moran_total", "moran_conditional",
                                  "geary_total", "geary_conditional",
                                  "getis_star", "getis_g"])
def test_integer_counts_equal_the_op_by_op_reference(case):
    """Integer-valued data: the same Z in both packages, and counts equal
    to the reference run op by op (its jit-compiled scan resolves exact
    ties of the statistic otherwise, ROADMAP Queue 3)."""
    n_perm = 19
    coords, X = _exact_integers(n=600, g=3)
    gj, gt = _graphs(coords)
    stat, kind = case.split("_")
    if stat == "getis":
        # raw counts whose column sums (and sums of squares) stay below 2²⁴
        Xc = np.random.default_rng(4).poisson(3.0, X.shape).astype(np.float32)
        jfn = lambda: jgo.getis_ord(gj, jnp.asarray(Xc), star=kind == "star",
                                    seed=2, n_permutations=n_perm).p_sim
        got = tgo.getis_ord(gt, torch.as_tensor(Xc), star=kind == "star",
                            seed=2, n_permutations=n_perm).p_sim
    else:
        Zj, _ = jm.standardize(jnp.asarray(X))
        fn = jm.local_moran if stat == "moran" else jm.local_geary
        tfn = tm.local_moran if stat == "moran" else tm.local_geary
        jfn = lambda: fn(gj, Zj, 2, n_perm, null=kind).p_value
        got = tfn(gt, torch.as_tensor(np.array(Zj)), 2, n_perm,
                  null=kind).p_value
    with jax.disable_jit():
        want = jfn()
    np.testing.assert_array_equal(_counts(got, n_perm), _counts(want, n_perm))


def test_getis_column_sums_above_2_24():
    """Counts near 40,000 over 1,000 cells: column sums pass 2²⁴. The port's
    are exact and the same for every permutation; the reference re-sums
    each permuted column in float32, so its moments (and its one-pass
    variance, which cancels at such means) drift from draw to draw
    (ROADMAP Queue 3). Measured here: 2.0–5.5% of the counts differ, by at
    most 2 of 29 draws; the test holds that bound and at least 90% equal."""
    rng = np.random.default_rng(11)
    coords = rng.uniform(0, 100, (1000, 2)).astype(np.float32)
    X = rng.poisson(40_000.0, (1000, 3)).astype(np.float32)
    assert X.sum(axis=0).min() > 2 ** 24
    gj, gt = _graphs(coords)
    tot, _ = tgo._column_sums(torch.as_tensor(X))
    np.testing.assert_array_equal(tot.numpy()[0],
                                  X.astype(np.float64).sum(0).astype(np.float32))
    for star in (True, False):
        want = jgo.getis_ord(gj, jnp.asarray(X), star=star, seed=1,
                             n_permutations=P).p_sim
        got = tgo.getis_ord(gt, torch.as_tensor(X), star=star, seed=1,
                            n_permutations=P).p_sim
        d = np.abs(_counts(got, P) - _counts(want, P))
        assert d.max() <= 2 and (d == 0).mean() >= 0.9


def _labels(coords, seed):
    rng = np.random.default_rng(seed)
    x = (rng.uniform(size=coords.shape[0]) < 0.3).astype(np.float32)
    x[coords[:, 0] < 30] = 1.0                    # a clustered patch
    return x


@pytest.mark.parametrize("seed", [3, 8])
def test_join_counts_bitwise(setup, seed):
    x = _labels(setup["coords"], seed)
    rj = jm.join_counts(setup["gj"], jnp.asarray(x), seed, P)
    rt = tm.join_counts(setup["gt"], torch.as_tensor(x), seed, P)
    assert sorted(rt) == sorted(rj)
    for k in rj:
        assert rt[k].dtype == torch.float32
        np.testing.assert_array_equal(_np(rt[k]), np.asarray(rj[k]), err_msg=k)
    assert _counts(rt["p_BB"], P) == 1            # the patch clusters


@pytest.mark.parametrize("seed", [3, 8])
def test_local_join_counts_bitwise(setup, seed):
    x = _labels(setup["coords"], seed)
    bj, pj = jm.local_join_counts(setup["gj"], jnp.asarray(x), seed, P)
    bt, pt = tm.local_join_counts(setup["gt"], torch.as_tensor(x), seed, P)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert bool((pt[torch.as_tensor(x) == 0] == 1).all())
    b0, p0 = tm.local_join_counts(setup["gt"], torch.as_tensor(x), seed, 0)
    assert torch.equal(b0, bt) and bool((p0 == 1).all())


@pytest.mark.parametrize("g", [1, 8])
def test_local_geary_multivariate_matches_reference(setup, g):
    cj, pj = jm.local_geary_multivariate(setup["gj"], setup["Zj"][:, :g], 6, P)
    ct, pt = tm.local_geary_multivariate(setup["gt"], setup["Zt"][:, :g], 6, P)
    _rel_close(ct, cj, ct)                                # all terms ≥ 0
    assert np.abs(_counts(pt, P) - _counts(pj, P)).max() <= 1


# ---------------------------------------------------------------------------
# The local "sort" streams
# ---------------------------------------------------------------------------


def _sort_pair(setup, stat, ref_impl):
    """(port, reference) int8 counts of one banded local null on the "sort"
    stream; the reference through its XLA body or its Pallas kernel K7 in
    interpret mode, the port through "auto" (the kernel's plain version on
    the CPU) or "xla"."""
    impl = "xla" if ref_impl == "xla" else "auto"
    if stat == "moran":
        return (tb.banded_local_moran_pvalues(setup["pt"], setup["Zt"], 5, P,
                                              perm_method="sort",
                                              band_impl=impl),
                jb.banded_local_moran_pvalues(setup["pj"], setup["Zj"], 5, P,
                                              perm_method="sort",
                                              band_impl=ref_impl))
    if stat == "geary":
        return (tb.banded_local_geary(setup["pt"], setup["Zt"], 5, P,
                                      precision="int8", perm_method="sort",
                                      band_impl=impl)[1],
                jb.banded_local_geary(setup["pj"], setup["Zj"], 5, P,
                                      precision="int8", perm_method="sort",
                                      band_impl=ref_impl)[1])
    star = stat == "getis_star"
    alt = "two-sided" if star else "greater"
    X = setup["counts"]
    return (tb.banded_getis(setup["pt"], torch.as_tensor(X), 5, P, star=star,
                            alternative=alt, precision="int8",
                            perm_method="sort", band_impl=impl),
            jb.banded_getis(setup["pj"], jnp.asarray(X), 5, P, star=star,
                            alternative=alt, precision="int8",
                            perm_method="sort", band_impl=ref_impl))


@pytest.mark.parametrize("ref_impl", ["xla", "pallas"])
@pytest.mark.parametrize("stat", ["moran", "geary", "getis_star", "getis_g"])
def test_int8_sort_stream_bitwise(setup, stat, ref_impl):
    got, want = _sort_pair(setup, stat, ref_impl)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("stat", ["moran", "geary", "getis"])
def test_float_sort_stream_within_one_draw(setup, stat):
    if stat == "moran":
        got = tb.banded_local_moran(setup["pt"], setup["gt"], setup["Zt"], 5, P,
                                    precision="f32", perm_method="sort").p_value
        want = jb.banded_local_moran(setup["pj"], setup["gj"], setup["Zj"], 5,
                                     P, precision="f32",
                                     perm_method="sort").p_value
    elif stat == "geary":
        got = tb.banded_local_geary(setup["pt"], setup["Zt"], 5, P,
                                    perm_method="sort")[1]
        want = jb.banded_local_geary(setup["pj"], setup["Zj"], 5, P,
                                     perm_method="sort")[1]
    else:
        got = tb.banded_getis(setup["pt"], torch.as_tensor(setup["X"]), 5, P,
                              perm_method="sort")
        want = jb.banded_getis(setup["pj"], jnp.asarray(setup["X"]), 5, P,
                               perm_method="sort")
    assert np.abs(_counts(got, P) - _counts(want, P)).max() <= 1


@pytest.mark.parametrize("stat", ["moran", "geary"])
def test_f32_sort_stream_matches_the_slot_null(setup, stat):
    """The f32 banded null on the sort stream draws the slot null's
    permutations (keys ``perm_local`` / ``perm_local_geary``): the same
    statistic up to float32 summation order."""
    if stat == "moran":
        band = tb.banded_local_moran(setup["pt"], setup["gt"], setup["Zt"], 5,
                                     P, precision="f32",
                                     perm_method="sort").p_value
        slot = tm.local_moran(setup["gt"], setup["Zt"], 5, P,
                              null="total").p_value
    else:
        band = tb.banded_local_geary(setup["pt"], setup["Zt"], 5, P,
                                     perm_method="sort")[1]
        slot = tm.local_geary(setup["gt"], setup["Zt"], 5, P,
                              null="total").p_value
    assert np.abs(_counts(band, P) - _counts(slot, P)).max() <= 1


# ---------------------------------------------------------------------------
# The public routes
# ---------------------------------------------------------------------------


def _pair(coords, X, obs=None):
    var = pd.DataFrame(index=[f"G{j}" for j in range(X.shape[1])])
    a = JSpatialData(X=X.copy(), var=var.copy(),
                     obs=None if obs is None else obs.copy())
    a.obsm["spatial"] = coords
    b = sctt.SpatialData(X=X.copy(), var=var.copy(),
                         obs=None if obs is None else obs.copy())
    b.obsm["spatial"] = coords.copy()
    return a, b


def _continuous(n=1000, g=6, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 400, (n, 2)).astype(np.float32)
    X = np.concatenate(
        [3 * np.sin(coords[:, :1] / 30.0) + rng.normal(0, 0.5, (n, g // 2)),
         rng.normal(0, 1, (n, g - g // 2))], axis=1).astype(np.float32)
    return coords, X


def _params(d, key):
    p = dict(d.uns[f"{key}_params"])
    p.pop("computation_time_seconds")
    return p


def _close_obsm(a, b, key, keys, n_perm):
    for k in keys:
        want = np.asarray(a.obsm[f"{key}_{k}"], np.float32)
        got = np.asarray(b.obsm[f"{key}_{k}"], np.float32)
        assert got.shape == want.shape, k
        if k in ("p", "p_adj", "p_sim"):
            assert (np.abs(got - want) <= 1.0 / (n_perm + 1) + 1e-6).all(), k
            assert (got == want).mean() >= 0.999, k
        elif k in ("quadrant", "hotspot"):
            assert (got == want).mean() >= 0.999, k
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def test_local_morans_i_defaults_match_reference():
    """Every default: P=10, k=6, "auto" → the slot null, total."""
    a, b = _pair(*_continuous())
    scts.local_morans_i(a)
    sctt.local_morans_i(b, device="cpu")
    assert sorted(b.obsm) == sorted(a.obsm)
    _close_obsm(a, b, "local_morans", ("I", "z", "lag", "p", "p_adj",
                                       "quadrant"), 10)
    assert _params(b, "local_morans") == _params(a, "local_morans")
    assert b.uns["local_morans_params"]["null_method"] == "slots"


def test_local_morans_i_conditional_matches_reference():
    """null="conditional" on the slot null, and its fall-through from a
    banded method (a warning, then the slot null)."""
    a, b = _pair(*_continuous(g=4))
    kw = dict(null="conditional", n_permutations=19, seed=3, batch_size=3)
    scts.local_morans_i(a, **kw)
    sctt.local_morans_i(b, device="cpu", **kw)
    _close_obsm(a, b, "local_morans", ("I", "p", "p_adj", "quadrant"), 19)
    assert _params(b, "local_morans") == _params(a, "local_morans")
    before = b.obsm["local_morans_p"].copy()
    sctt.local_morans_i(b, device="cpu", null_method="banded_int8", **kw)
    np.testing.assert_array_equal(b.obsm["local_morans_p"], before)


def test_local_gearys_c_defaults_match_reference():
    """Every default: the conditional slot null with P=99."""
    a, b = _pair(*_continuous(n=600, g=3))
    scts.local_gearys_c(a)
    sctt.local_gearys_c(b, device="cpu")
    assert sorted(b.obsm) == sorted(a.obsm)
    _close_obsm(a, b, "local_geary", ("C", "p", "p_adj"), 99)
    assert _params(b, "local_geary") == _params(a, "local_geary")


@pytest.mark.parametrize("null_method", ["direct", "auto"])
def test_local_gearys_c_total_slot_null_matches_reference(null_method):
    a, b = _pair(*_continuous(g=4))
    kw = dict(null="total", null_method=null_method, n_permutations=19,
              seed=2, batch_size=3)
    scts.local_gearys_c(a, **kw)
    sctt.local_gearys_c(b, device="cpu", **kw)
    _close_obsm(a, b, "local_geary", ("C", "p", "p_adj"), 19)
    assert _params(b, "local_geary") == _params(a, "local_geary")
    assert b.uns["local_geary_params"]["null_method"] == "direct"


@pytest.mark.parametrize("star,alternative,null_method", [
    (True, "two-sided", "direct"), (False, "greater", "auto")])
def test_getis_ord_gi_slot_null_matches_reference(star, alternative,
                                                  null_method):
    coords, X = _continuous(g=4)
    a, b = _pair(coords, X + 4.0)
    kw = dict(star=star, alternative=alternative, null_method=null_method,
              n_permutations=19, seed=5, batch_size=3, alpha=0.2)
    scts.getis_ord_gi(a, **kw)
    sctt.getis_ord_gi(b, device="cpu", **kw)
    assert sorted(b.obsm) == sorted(a.obsm)
    _close_obsm(a, b, "getis_ord", ("G", "z", "p_sim", "p_adj", "hotspot"), 19)
    assert _params(b, "getis_ord") == _params(a, "getis_ord")


@pytest.mark.parametrize("fn,key,kw", [
    ("local_morans_i", "local_morans", dict(null="conditional")),
    ("local_gearys_c", "local_geary", {}),
    ("getis_ord_gi", "getis_ord", dict(null_method="direct"))])
def test_public_integer_counts_equal_the_op_by_op_reference(fn, key, kw):
    """Exactly standardized integer data: the port's counts equal the
    reference's public call run op by op."""
    n_perm = 9
    coords, X = _exact_integers()
    if fn == "getis_ord_gi":                      # raw counts, sums below 2²⁴
        X = np.random.default_rng(4).poisson(3.0, X.shape).astype(np.float32)
    a, b = _pair(coords, X)
    kw = dict(n_permutations=n_perm, seed=4, **kw)
    with jax.disable_jit():
        getattr(scts, fn)(a, **kw)
    getattr(sctt, fn)(b, device="cpu", **kw)
    p = "p_sim" if fn == "getis_ord_gi" else "p"
    np.testing.assert_array_equal(_counts(b.obsm[f"{key}_{p}"], n_perm),
                                  _counts(a.obsm[f"{key}_{p}"], n_perm))


def test_gene_batches_draw_the_same_permutations():
    """Each gene batch redraws the same permutations, as the reference's
    batch loop does: the batch size changes nothing."""
    coords, X = _continuous(n=500, g=5)
    _, one = _pair(coords, X)
    _, three = _pair(coords, X)
    for d, bs in ((one, 5), (three, 2)):
        sctt.local_morans_i(d, n_permutations=9, batch_size=bs, device="cpu")
        sctt.local_gearys_c(d, n_permutations=9, batch_size=bs, device="cpu")
        sctt.getis_ord_gi(d, n_permutations=9, batch_size=bs, device="cpu")
    for k in ("local_morans_p", "local_geary_p", "getis_ord_p_sim"):
        np.testing.assert_array_equal(one.obsm[k], three.obsm[k])


def _label_pair(seed=0):
    coords, X = _continuous(n=800, g=3, seed=seed)
    lab = np.where(np.sin(coords[:, 0] / 40.0) > 0.3, "tumour", "stroma")
    obs = pd.DataFrame({"cell_type": pd.Categorical(lab),
                        "flag": lab == "tumour",
                        "score": np.where(lab == "tumour", 2.5, 0.0)},
                       index=[str(i) for i in range(len(lab))])
    return _pair(coords, X, obs)


@pytest.mark.parametrize("column,category", [("cell_type", "tumour"),
                                             ("flag", None), ("score", None)])
def test_join_count_statistics_matches_reference(column, category):
    a, b = _label_pair()
    scts.join_count_statistics(a, column, category=category,
                               n_permutations=P, seed=2)
    sctt.join_count_statistics(b, column, category=category,
                               n_permutations=P, seed=2, device="cpu")
    ja, tb_ = dict(a.uns["join_counts"]), dict(b.uns["join_counts"])
    ja.pop("computation_time_seconds")
    tb_.pop("computation_time_seconds")
    assert tb_ == ja
    assert _counts(tb_["p_BB"], P) == 1


def test_local_join_counts_matches_reference():
    a, b = _label_pair(seed=1)
    scts.local_join_counts(a, "cell_type", category="tumour",
                           n_permutations=P, seed=3)
    sctt.local_join_counts(b, "cell_type", category="tumour",
                           n_permutations=P, seed=3, device="cpu")
    for col in ("cell_type_local_jc_BB", "cell_type_local_jc_p"):
        np.testing.assert_array_equal(b.obs[col].to_numpy(),
                                      a.obs[col].to_numpy())
    assert (b.obs["cell_type_local_jc_p"] < 0.05).mean() > 0.1


def test_local_gearys_c_multivariate_matches_reference():
    a, b = _pair(*_continuous(n=800, g=4))
    scts.local_gearys_c_multivariate(a, n_permutations=P, seed=5)
    sctt.local_gearys_c_multivariate(b, n_permutations=P, seed=5, device="cpu")
    np.testing.assert_allclose(b.obs["local_geary_mv"], a.obs["local_geary_mv"],
                               rtol=1e-5, atol=1e-6)
    dc = np.abs(_counts(b.obs["local_geary_mv_p"].to_numpy(), P)
                - _counts(a.obs["local_geary_mv_p"].to_numpy(), P))
    assert dc.max() <= 1
    assert _params(b, "local_geary_mv") == _params(a, "local_geary_mv")


def test_binarize_and_join_count_refusals():
    a, b = _label_pair()
    for col, cat in (("cell_type", "tumour"), ("flag", None), ("score", None)):
        np.testing.assert_array_equal(tac._binarize_obs_column(b, col, cat),
                                      jac._binarize_obs_column(a, col, cat))
    with pytest.raises(ValueError, match="not boolean or numeric"):
        tac._binarize_obs_column(b, "cell_type")
    with pytest.raises(ValueError, match="not found"):
        tac._binarize_obs_column(b, "nope")
    b.obs["none"] = False
    with pytest.raises(ValueError, match="constant"):
        sctt.join_count_statistics(b, "none", device="cpu")
    with pytest.raises(ValueError, match="both"):
        sctt.local_join_counts(b, "none", device="cpu")
