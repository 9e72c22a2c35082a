"""Point patterns in the port against the JAX package, on the CPU: the
bucket grid, the pair counts, Ripley's K / L with CSR envelopes, cross-type
K with label-permutation envelopes, co-occurrence and Clark-Evans, and the
``jax.random.uniform`` stream their CSR draws use.

Tolerances, and why:
- ``uniform``: bitwise (threefry bits and the same float32 operations);
- the CSR draws' coordinates: bitwise. The reference's CPU run contracts
  ``mins + u·span`` into one fused multiply-add (one rounding); the port
  forms the same single rounding exactly (``core.rng._fma32``);
- bucket tables, integer pair counts and the label permutations: bitwise.
  The reference's CPU run also fuses a pair's squared distance as
  ``fma(dy, dy, dx·dx)``, which the port reproduces, so pairs placed
  exactly on a radius count alike (asserted with radii set to pair
  distances);
- K, L, K_cross and the envelopes' quantiles: bitwise where the counts
  are (the same float32 roundings and numpy reductions follow);
- Clark-Evans: rtol 1e-6 (the nearest-neighbour distances agree to 2 ulp,
  ROADMAP Queue 3).
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import spatialcore_tpu.spatial as scts
from spatialcore_tpu import SpatialData as JSpatialData
from spatialcore_tpu.core.rng import key_for as jkey_for
from spatialcore_tpu.ops import ripley as jr
import spatialcore_tpu_torch as sctt
import spatialcore_tpu_torch.spatial as sctts
from spatialcore_tpu_torch.core import rng
from spatialcore_tpu_torch.ops import ripley as tr

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("shape", [(1,), (7,), (1001, 2), (3, 5, 2), (4096,)])
@pytest.mark.parametrize("draw", [0, 5, 2 ** 31 + 3])
def test_uniform_bitwise(shape, draw):
    kj = jax.random.fold_in(jkey_for(3, "ripley_csr"), draw)
    kt = rng.fold_in(rng.key_for(3, "ripley_csr"), draw)
    want = np.asarray(jax.random.uniform(kj, shape))
    got = rng.uniform(kt, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(_np(got)), _bits(want))
    lo, hi = -2.5, 7.25
    np.testing.assert_array_equal(
        _bits(_np(rng.uniform(kt, shape, lo, hi))),
        _bits(jax.random.uniform(kj, shape, minval=lo, maxval=hi)))


def test_fma32_rounds_once():
    """Against exact rational arithmetic, on random operands and on
    operands whose float64 sum lands exactly halfway between two float32
    values (where rounding twice goes wrong)."""
    r = np.random.default_rng(0)
    a = r.uniform(-3, 3, 4000).astype(np.float32)
    b = r.uniform(-3, 3, 4000).astype(np.float32)
    c = r.uniform(-3, 3, 4000).astype(np.float32)
    # halfway cases: c = 1, a·b = 2⁻²⁴ + tiny: the float64 sum rounds the
    # tiny part away and lands on the float32 midpoint 1 + 2⁻²⁴
    a[:3] = np.float32(2.0 ** -12)
    b[:3] = np.float32(2.0 ** -12) * np.float32(1 + 2.0 ** -23) ** np.arange(1, 4)
    c[:3] = 1.0
    got = _np(rng._fma32(*(torch.as_tensor(x) for x in (a, b, c))))
    for i in range(a.size):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))          # near, then fix to nearest
        cands = [lo, np.nextafter(lo, np.float32(-np.inf)),
                 np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32)) & 1))
        assert got[i] == best, i
    assert (got[:3] == np.nextafter(np.float32(1), np.float32(2))).all()


def test_csr_points_bitwise():
    """The reference's CPU run computes ``mins + u·span`` as one fused
    multiply-add; the port's CSR points are that single rounding."""
    mins = np.array([1.3, -7.7], np.float32)
    maxs = np.array([124.756, 69.4], np.float32)
    span = (maxs - mins).astype(np.float32)

    @jax.jit
    def ref(key):
        return jnp.asarray(mins) + jax.random.uniform(key, (3001, 2)) * jnp.asarray(span)

    for s in (0, 1, 17):
        want = np.asarray(ref(jax.random.fold_in(jkey_for(2, "ripley_csr"), s)))
        got = tr.csr_points(rng.key_for(2, "ripley_csr"), s,
                            torch.as_tensor(mins), torch.as_tensor(span), 3001)
        np.testing.assert_array_equal(_bits(_np(got)), _bits(want))
    u = np.asarray(jax.random.uniform(jax.random.fold_in(
        jkey_for(2, "ripley_csr"), 0), (3001, 2)))
    separate = mins + (u * span).astype(np.float32)
    assert (separate != np.asarray(ref(jax.random.fold_in(
        jkey_for(2, "ripley_csr"), 0)))).any()   # the rounding differs


def _pattern(n, seed, n_types=1, side=100.0):
    r = np.random.default_rng(seed)
    centres = r.uniform(0, side, (6, 2))
    half = n // 2
    pts = np.concatenate([centres[r.integers(0, 6, half)]
                          + r.normal(0, side / 30, (half, 2)),
                          r.uniform(0, side, (n - half, 2))]).astype(np.float32)
    codes = r.integers(0, n_types, n).astype(np.int32)
    return pts, codes


def test_grid_spec_and_table_bitwise():
    c, _ = _pattern(2500, 1)
    spec_j = jr.make_grid_spec(c, 9.0, capacity_slack=2.0)
    spec_t = tr.make_grid_spec(c, 9.0, capacity_slack=2.0)
    for f in spec_j._fields:
        np.testing.assert_array_equal(np.asarray(getattr(spec_t, f)),
                                      np.asarray(getattr(spec_j, f)), err_msg=f)
    tj, bxj, byj, mcj = jr._bin_points(jnp.asarray(c), jnp.asarray(spec_j.mins),
                                       jnp.asarray(spec_j.span), spec_j.nbx,
                                       spec_j.nby, spec_j.capacity)
    tt, bxt, byt, mct = tr._bin_points(torch.as_tensor(c),
                                       torch.as_tensor(spec_t.mins),
                                       torch.as_tensor(spec_t.span), spec_t.nbx,
                                       spec_t.nby, spec_t.capacity)
    np.testing.assert_array_equal(_np(tt), np.asarray(tj).astype(np.int64))
    np.testing.assert_array_equal(_np(bxt), np.asarray(bxj))
    np.testing.assert_array_equal(_np(byt), np.asarray(byj))
    assert int(mct) == int(mcj)
    g = tr.build_bucket_grid(c, 9.0, device="cpu")
    gj = jr.build_bucket_grid(c, 9.0)
    np.testing.assert_array_equal(_np(g.table), np.asarray(gj.table))
    assert (g.nbx, g.nby, g.window) == (gj.nbx, gj.nby, gj.window)


@pytest.mark.parametrize("n_types", [1, 3])
def test_pair_counts_bitwise(n_types):
    """Radii at actual pair distances (every r² the fused d² of a pair): a
    pair on a radius counts in both packages, or in neither."""
    c, codes = _pattern(3000, 2, n_types)
    spec = jr.make_grid_spec(c, 8.0)
    args_j = jr._bin_points(jnp.asarray(c), jnp.asarray(spec.mins),
                            jnp.asarray(spec.span), spec.nbx, spec.nby,
                            spec.capacity)[:3]
    args_t = tr._bin_points(torch.as_tensor(c), torch.as_tensor(spec.mins),
                            torch.as_tensor(spec.span), spec.nbx, spec.nby,
                            spec.capacity)[:3]
    # d² of pairs as the reference forms them: fma(dy, dy, dx·dx)
    i, j = np.arange(0, 600, 3), np.arange(1, 601, 3)
    dx = (c[i, 0] - c[j, 0]).astype(np.float32)
    dy = (c[i, 1] - c[j, 1]).astype(np.float32)
    d2 = _np(rng._fma32(torch.as_tensor(dy), torch.as_tensor(dy),
                       torch.as_tensor(dx * dx)))
    rsq = np.concatenate([d2[d2 <= 60.0][:12],
                          np.float32([0.5, 4.0, 25.0, 64.0])]).astype(np.float32)
    rsq = rsq[np.random.default_rng(0).permutation(rsq.size)]   # unsorted
    cj, ctj = jr._pair_counts(jnp.asarray(c), *args_j, jnp.asarray(rsq),
                              jnp.asarray(codes), nbx=spec.nbx, nby=spec.nby,
                              window=spec.window, n_radii=rsq.size,
                              n_types=n_types)
    ct_, ctt = tr._pair_counts(torch.as_tensor(c), *args_t, torch.as_tensor(rsq),
                               torch.as_tensor(codes.astype(np.int64)), spec.nbx,
                               spec.nby, spec.window, n_types)
    assert ct_.dtype == torch.int64
    np.testing.assert_array_equal(_np(ct_), np.asarray(cj).astype(np.int64))
    if n_types > 1:
        np.testing.assert_array_equal(_np(ctt), np.asarray(ctj).astype(np.int64))
        assert (_np(ctt).sum(axis=(1, 2)) == _np(ct_)).all()
    # exact against a brute-force count with the same d²
    dxa = c[:, None, 0] - c[None, :, 0]
    dya = c[:, None, 1] - c[None, :, 1]
    d2a = _np(rng._fma32(torch.as_tensor(dya), torch.as_tensor(dya),
                        torch.as_tensor((dxa * dxa).astype(np.float32))))
    np.fill_diagonal(d2a, np.inf)
    brute = (d2a[None] <= rsq[:, None, None]).sum(axis=(1, 2))
    np.testing.assert_array_equal(_np(ct_), brute)


def test_ripley_k_bitwise():
    c, _ = _pattern(2000, 3)
    radii = np.linspace(1.0, 12.0, 9).astype(np.float32)
    want = jr.ripley_k(c, radii, n_simulations=19, seed=4)
    got = tr.ripley_k(c, radii, n_simulations=19, seed=4, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
        if isinstance(want[k], np.ndarray):
            assert np.asarray(got[k]).dtype == want[k].dtype, k
    assert (got["K"][-3:] > got["K_env_hi"][-3:]).all()     # clustered


def test_cross_type_k_and_co_occurrence_bitwise():
    c, codes = _pattern(2400, 4, n_types=4)
    codes[:600] = 0                 # type 0 rides the clusters' first half
    radii = np.linspace(2.0, 14.0, 7).astype(np.float32)
    want = jr.cross_type_k(c, codes, 4, radii, n_permutations=19, seed=8)
    got = tr.cross_type_k(c, codes, 4, radii, n_permutations=19, seed=8,
                          device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    cj = jr.co_occurrence_counts(c, codes, 4, radii)
    ct = tr.co_occurrence_counts(c, codes, 4, radii, device="cpu")
    assert ct.dtype == np.float32
    np.testing.assert_array_equal(ct, np.asarray(cj))


def test_label_permutations_bitwise():
    base_j = jkey_for(8, "ripley_labelperm")
    base_t = rng.key_for(8, "ripley_labelperm")
    for s in (0, 3, 18):
        want = np.asarray(jax.random.permutation(jax.random.fold_in(base_j, s),
                                                 2400))
        got = rng.permutation(rng.fold_in(base_t, s), 2400, device="cpu")
        np.testing.assert_array_equal(_np(got), want)


def test_type_pair_counts_are_exact_integers():
    """The port's counts are int64 (exact at any size; the reference's
    type-pair sums are float32, exact below 2²⁴, ROADMAP Queue 3): every
    type pair against a brute-force count, all pairs within the largest
    radius."""
    c, codes = _pattern(1500, 5, n_types=3, side=20.0)
    radii_sq = torch.tensor([1.0, 9.0, 900.0])
    spec = tr.make_grid_spec(c, 30.0)
    t, bx, by, _ = tr._bin_points(torch.as_tensor(c), torch.as_tensor(spec.mins),
                                  torch.as_tensor(spec.span), spec.nbx, spec.nby,
                                  spec.capacity)
    tot, ct = tr._pair_counts(torch.as_tensor(c), t, bx, by, radii_sq,
                              torch.as_tensor(codes.astype(np.int64)), spec.nbx,
                              spec.nby, spec.window, 3)
    n_t = np.bincount(codes, minlength=3)
    full = np.outer(n_t, n_t) - np.diag(n_t)
    np.testing.assert_array_equal(_np(ct)[-1], full)
    assert int(tot[-1]) == 1500 * 1499


def test_capacity_overflow_raises(monkeypatch):
    """A bucket holding more cells than the capacity raises with the
    reference's message, in both packages."""
    c, codes = _pattern(800, 6, n_types=2)
    radii = np.float32([3.0, 6.0])
    msgs = []
    for mod in (jr, tr):
        real = mod.make_grid_spec
        monkeypatch.setattr(mod, "make_grid_spec",
                            lambda *a, **k: real(*a, **k)._replace(capacity=2))
        kw = {} if mod is jr else {"device": "cpu"}
        for call in (lambda: mod.ripley_k(c, radii, **kw),
                     lambda: mod.co_occurrence_counts(c, codes, 2, radii, **kw),
                     lambda: mod.cross_type_k(c, codes, 2, radii, **kw)):
            with pytest.raises(ValueError, match="bucket capacity overflow") as e:
                call()
            msgs.append(str(e.value))
        monkeypatch.undo()
    assert msgs[:3] == msgs[3:]
    with pytest.raises(ValueError, match="needs >= 2 points"):
        tr.ripley_k(c[:1], radii, device="cpu")


# ---------------------------------------------------------------------------
# The public functions
# ---------------------------------------------------------------------------


def _pair(n=2000, seed=7, n_types=4):
    c, codes = _pattern(n, seed, n_types)
    labels = pd.Categorical(np.array(list("ABCD"))[codes])
    X = np.zeros((n, 1), np.float32)
    var = pd.DataFrame(index=["G0"])
    a = JSpatialData(X=X.copy(), var=var.copy(),
                     obs=pd.DataFrame({"cell_type": labels}))
    a.obsm["spatial"] = c
    b = sctt.SpatialData(X=X.copy(), var=var.copy(),
                         obs=pd.DataFrame({"cell_type": labels}))
    b.obsm["spatial"] = c.copy()
    return a, b


def _without_time(d):
    d = dict(d)
    d.pop("computation_time_seconds", None)
    return d


def _uns_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


def test_public_point_patterns_match_reference():
    a, b = _pair()
    scts.ripleys_k(a, n_radii=8, n_simulations=9, seed=2)
    sctts.ripleys_k(b, n_radii=8, n_simulations=9, seed=2, device="cpu")
    _uns_equal(_without_time(b.uns["ripley_k"]), _without_time(a.uns["ripley_k"]))
    scts.cross_type_ripleys_k(a, "cell_type", n_radii=5, n_permutations=9)
    sctts.cross_type_ripleys_k(b, "cell_type", n_radii=5, n_permutations=9,
                               device="cpu")
    _uns_equal(_without_time(b.uns["ripley_k_cross"]),
               _without_time(a.uns["ripley_k_cross"]))
    assert b.uns["ripley_k_cross_types"] == a.uns["ripley_k_cross_types"]
    scts.co_occurrence(a, "cell_type", n_radii=6)
    sctts.co_occurrence(b, "cell_type", n_radii=6, device="cpu")
    _uns_equal(_without_time(b.uns["co_occurrence"]),
               _without_time(a.uns["co_occurrence"]))
    assert b.uns["co_occurrence_types"] == a.uns["co_occurrence_types"]
    assert [op["function"] for op in sctt.core.get_operations(b)] == [
        "ripleys_k", "cross_type_ripleys_k", "co_occurrence"]


def test_public_clark_evans_matches_reference():
    a, b = _pair(n=3000, seed=9)
    scts.clark_evans(a)
    sctts.clark_evans(b, device="cpu")
    want, got = _without_time(a.uns["clark_evans"]), _without_time(b.uns["clark_evans"])
    assert sorted(got) == sorted(want)
    for k in ("n_cells", "area", "expected_nn_distance"):
        assert got[k] == want[k], k
    for k in ("R", "z", "p_value", "mean_nn_distance"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert got["R"] < 1                                    # clustered


def test_public_refusals():
    _, b = _pair(n=300)
    with pytest.raises(ValueError, match="not found"):
        sctts.ripleys_k(b, spatial_key="xy", device="cpu")
    with pytest.raises(ValueError, match="All radii must be > 0"):
        sctts.ripleys_k(b, radii=[0.0, 1.0], device="cpu")
    with pytest.raises(ValueError, match="not found"):
        sctts.co_occurrence(b, "nope", device="cpu")
    b.obs["one"] = "A"
    with pytest.raises(ValueError, match="needs ≥2 types"):
        sctts.cross_type_ripleys_k(b, "one", device="cpu")
    with pytest.raises(ValueError, match="needs >= 3 cells"):
        sctts.clark_evans(sctt.SpatialData(X=np.zeros((2, 1), np.float32),
                                           obsm={"spatial": np.zeros((2, 2))}),
                          device="cpu")
