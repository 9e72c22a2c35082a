"""The float global null's far-edge cross and Geary degree term
(``kernels/global_terms.py``) on the CPU: the plain version, the wrapper's
checks, and the null's routing through them.

Tolerances, and why:
- the plain version against a float64 einsum of the same terms (weights
  rounded to the table's dtype, values widened): within 1e-5·Σ|terms|,
  float32 rounding of each product and of the pairwise sums;
- the null (``banded_permutation_test``) against a frozen copy of the
  torch-op chain it ran before the terms had a kernel: bitwise
  (``torch.equal``), since on the CPU the plain version is that chain.

The kernel itself is held against the plain version on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import pytest
import torch

from spatialcore_tpu_torch.kernels import band_cross as kern
from spatialcore_tpu_torch.kernels import global_terms as kern_terms
from spatialcore_tpu_torch.ops import banded
from spatialcore_tpu_torch.ops.graph import build_graph
from spatialcore_tpu_torch.utils import profiling as prof

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

B = 64
N = 2000
N_ISOLATED = 4


def _knn_plan():
    gen = torch.Generator().manual_seed(0)
    coords = torch.rand((N, 2), generator=gen) * 300
    return banded.build_null_plan(build_graph(coords, n_neighbors=6, device="cpu"),
                                  coords, block=B)


def _radius_plan():
    """A radius graph with dead slots and ``N_ISOLATED`` cells far from
    every other (rows with no edge and rc = 0)."""
    gen = torch.Generator().manual_seed(1)
    coords = torch.rand((N, 2), generator=gen) * 300
    lone = torch.stack([500.0 + 40.0 * torch.arange(N_ISOLATED, dtype=torch.float32),
                        torch.full((N_ISOLATED,), 500.0)], dim=1)
    coords = torch.cat([coords, lone])
    graph = build_graph(coords, radius=9.0, k_max=24, device="cpu")
    return banded.build_null_plan(graph, coords, block=B)


@pytest.fixture(scope="module")
def plans():
    return {"knn": _knn_plan(), "radius": _radius_plan()}


def _table(plan, G: int, dtype, seed: int = 3):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((plan.n_padded + 2 * B, G), generator=gen).to(dtype)


def _einsum64(Zp, far_src, far_dst, far_w, rc_sum, block):
    """The two terms in float64 on the same operands, and Σ|terms| of
    each."""
    z = Zp.double()
    w = far_w.to(Zp.dtype).double()
    fs, fd = z[far_src], z[far_dst]
    z1 = z[block:block + rc_sum.shape[0]]
    rc = rc_sum.double()
    return (torch.einsum("f,fg,fg->g", w, fs, fd),
            torch.einsum("f,fg,fg->g", w.abs(), fs.abs(), fd.abs()),
            torch.einsum("i,ig,ig->g", rc, z1, z1),
            torch.einsum("i,ig,ig->g", rc.abs(), z1, z1))


def _close(got, want, scale):
    err = (got.double() - want).abs()
    assert bool((err <= 1e-5 * scale + 1e-30).all()), float(err.max())


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["knn", "radius"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("stat", ["moran", "geary", "moran_geary"])
@pytest.mark.parametrize("G", [1, 33, 100])
def test_plain_terms_equal_a_float64_einsum(plans, kind, dtype, stat, G):
    plan = plans[kind]
    n_live = banded._n_live_far(plan)
    assert 0 < n_live < plan.far_src.shape[0]      # a padded capacity
    Zp = _table(plan, G, dtype)
    geary = stat != "moran"
    far, sq = kern_terms.global_terms_plain(Zp, plan.far_src, plan.far_dst,
                                            plan.far_w, plan.rc_sum, B, geary)
    want, scale, want_sq, scale_sq = _einsum64(
        Zp, plan.far_src[:n_live], plan.far_dst[:n_live], plan.far_w[:n_live],
        plan.rc_sum, B)
    assert far.dtype == torch.float32 and far.shape == (G,)
    _close(far, want, scale)
    if not geary:
        assert sq is None
        return
    assert sq.dtype == torch.float32 and sq.shape == (G,)
    _close(sq, want_sq, scale_sq)
    # the same terms from the live heads alone (the kernel's operands)
    far_h, sq_h = kern_terms.global_terms_plain(
        Zp, *banded._global_far(plan, True), plan.rc_sum, B, geary)
    _close(far_h, want, scale)
    assert torch.equal(sq_h, sq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("form", ["empty", "padding_only"])
def test_plain_terms_on_an_empty_far_list(plans, dtype, form):
    """No live far edge: the far term is zeros, the degree term as ever."""
    plan = plans["radius"]
    Zp = _table(plan, 17, dtype)
    F = 0 if form == "empty" else 128
    src = torch.zeros(F, dtype=torch.int64)
    w = torch.zeros(F, dtype=torch.float32)
    far, sq = kern_terms.global_terms_plain(Zp, src, src.clone(), w,
                                            plan.rc_sum, B, True)
    assert torch.equal(far, torch.zeros(17))
    _, _, want_sq, scale_sq = _einsum64(Zp, src[:0], src[:0], w[:0],
                                        plan.rc_sum, B)
    _close(sq, want_sq, scale_sq)
    far_m, sq_m = kern_terms.global_terms(Zp, src, src.clone(), w, plan.rc_sum,
                                          B, False)
    assert torch.equal(far_m, torch.zeros(17)) and sq_m is None


def test_weights_round_to_the_table_dtype():
    """One far edge of weight 1 + 2^-10: bf16 rounds it to 1 (8 bits of
    mantissa), f32 keeps it."""
    Zp = torch.ones((2 * B + B, 1))
    src = torch.tensor([B])
    w = torch.tensor([1.0 + 2.0 ** -10])
    rc = torch.zeros(B)
    for dtype, want in ((torch.bfloat16, 1.0), (torch.float32, 1.0 + 2.0 ** -10)):
        far, _ = kern_terms.global_terms(Zp.to(dtype), src, src, w, rc, B, False)
        assert float(far[0]) == want


# ---------------------------------------------------------------------------
# The wrapper on the CPU
# ---------------------------------------------------------------------------


def test_wrapper_takes_the_plain_version_on_the_cpu(plans):
    plan = plans["knn"]
    Zp = _table(plan, 40, torch.bfloat16)
    args = (Zp, plan.far_src, plan.far_dst, plan.far_w, plan.rc_sum, B, True)
    before = dict(kern_terms.LAUNCHES)
    far, sq = kern_terms.global_terms(*args)
    assert dict(kern_terms.LAUNCHES) == before
    want_far, want_sq = kern_terms.global_terms_plain(*args)
    assert torch.equal(far, want_far) and torch.equal(sq, want_sq)


def test_wrapper_raises_on_operands_it_cannot_take(plans):
    plan = plans["knn"]
    Zp = _table(plan, 8, torch.float32)
    good = dict(Zp=Zp, far_src=plan.far_src, far_dst=plan.far_dst,
                far_w=plan.far_w, rc_sum=plan.rc_sum, block=B, geary=True)
    for bad in (dict(Zp=Zp.double()), dict(Zp=Zp[:-1]), dict(Zp=Zp[:, 0]),
                dict(rc_sum=plan.rc_sum.double()), dict(far_w=plan.far_w[:-1]),
                dict(far_dst=plan.far_dst[:, None]), dict(block=B // 2)):
        with pytest.raises(ValueError):
            kern_terms.global_terms(**{**good, **bad})


def test_far_heads_are_the_live_edges_as_int32(plans):
    plan = plans["radius"]
    n_live = banded._n_live_far(plan)
    src, dst, w = banded._global_far(plan, True)
    assert src.dtype == dst.dtype == torch.int32 and w.dtype == torch.float32
    assert src.shape == dst.shape == w.shape == (n_live,)
    assert bool((w > 0).all()) and not bool((plan.far_w[n_live:] > 0).any())
    assert torch.equal(src.long(), plan.far_src[:n_live])
    assert torch.equal(dst.long(), plan.far_dst[:n_live])
    full = banded._global_far(plan, False)
    assert all(a is b for a, b in zip(full, (plan.far_src, plan.far_dst,
                                              plan.far_w)))


@pytest.mark.parametrize("n_far,n_rows,geary,want", [
    (250_000, 1_000_704, False, (kern_terms.CTAS, 0)),
    (0, 1_000_704, False, (0, 0)),
    (0, 1_000_704, True, (0, kern_terms.CTAS)),
    (505_000, 1_000_704, True, (133, 131)),
    (1, 1_000_704, True, (1, kern_terms.CTAS - 1)),
    (10 ** 9, 64, True, (kern_terms.CTAS - 1, 1)),
])
def test_the_cta_split_follows_the_rows_each_kind_reads(n_far, n_rows, geary, want):
    assert kern_terms.split_ctas(n_far, n_rows, geary) == want


# ---------------------------------------------------------------------------
# The null through the terms, bitwise the chain it ran before
# ---------------------------------------------------------------------------


def _frozen_stat_float(local_idx32, w_c, A, far, rc_sum, Zp, den, S0, *,
                       block, n, stat, band_impl, genes=None):
    """The float null's draw statistic before its far-edge and degree
    terms had a kernel, frozen."""
    far_src, far_dst, far_w = far
    B_ = block
    nb = local_idx32.shape[0] // B_
    if band_impl == "xla":
        cross = kern.band_cross_dense_plain(A, Zp, B_, genes)
    else:
        cross = kern.band_cross_float(local_idx32, w_c, Zp, B_, genes)
    fs = Zp[far_src].to(torch.float32)
    ft = Zp[far_dst].to(torch.float32)
    fw = far_w.to(Zp.dtype).to(torch.float32)
    cross = cross + kern.tree_sum(fw[:, None] * fs * ft)

    def sq():
        z1 = Zp[B_:B_ + nb * B_].to(torch.float32)
        return rc_sum @ (z1 * z1)

    return banded._finish_stat(cross, sq, den, S0, n, stat)


@pytest.mark.parametrize("kind", ["knn", "radius"])
@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize("stat", ["moran", "geary", "moran_geary"])
@pytest.mark.parametrize("band_impl", ["auto", "xla"])
def test_null_is_bitwise_the_frozen_chain(plans, monkeypatch, kind, precision,
                                          stat, band_impl):
    plan = plans[kind]
    gen = torch.Generator().manual_seed(5)
    Z = torch.randn((plan.n, 24), generator=gen)
    obs = torch.rand((2, 24) if stat == "moran_geary" else (24,), generator=gen)
    run = lambda: banded.banded_permutation_test(
        plan, Z, float(plan.n), obs, 11, 7, stat=stat, precision=precision,
        band_impl=band_impl)
    prof.reset()
    with prof.tracing():
        got = run()
    names = [s["name"] for s in prof.spans()]
    assert names.count("kernels.global_terms") == 7 == names.count("draw")
    monkeypatch.setattr(banded, "_banded_stat_float", _frozen_stat_float)
    want = run()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
