"""Each hand-written kernel against its plain version, on a CUDA device.

The kernels have no CPU mode, so these tests skip without a card. This
file imports only torch and the port (no JAX), so it runs on a GPU machine
without the JAX package's test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerance: band cross |Δcross_g| ≤ 1e-5 · Σ_i |term_i| — float32 summation
order only; the integer lags are exact in both versions. The local
statistics' draw-step kernel (LISA, local Geary, Gi*, Gi): counts and
observed values equal — exact integers, and Gi's float32 centring rounds
at the plain version's places.
"""

import pytest
import torch

from spatialcore_tpu_torch.kernels import band_cross as kern
from spatialcore_tpu_torch.kernels import lisa_count as kern_lisa
from spatialcore_tpu_torch.ops import banded
from spatialcore_tpu_torch.ops.graph import build_graph

B = 64
N = 40 * B


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def plan():
    gen = torch.Generator().manual_seed(0)
    coords = torch.rand((N, 2), generator=gen) * 300
    return banded.build_null_plan(build_graph(coords, n_neighbors=6, device="cpu"),
                                  coords, block=B)


def _assert_close(got, want, scale):
    err = (got.cpu().double() - want.double()).abs()
    assert bool((err <= 1e-5 * scale + 1e-30).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode,G", [("int4_win", 512), ("int8_win", 256),
                                    ("int8_band", 260)])
def test_int8_kernel_matches_plain(cuda_device, plan, mode, G):
    packed = mode == "int4_win"
    gen = torch.Generator().manual_seed(1)
    nb = plan.n_padded // B
    rows_idx = plan.order[(torch.arange((nb + 2) * B) - B).clamp(0, plan.n - 1)]
    ops, _ = banded._int_ops(plan, "int4" if packed else "int8",
                             "win" if mode.endswith("win") else "exact",
                             rows_idx, use_plain=False)
    lim = 7 if packed else 127

    def codes(rows):
        c = torch.randint(-lim, lim + 1, (rows, G), generator=gen, dtype=torch.int8)
        return banded._pack_codes(c) if packed else c

    def absc(t):
        return banded._pack_codes(kern.unpack_nibbles(t).abs()) if packed else t.abs()

    zp = codes((nb + 2) * B)
    far = {}
    if ops.win:
        far = dict(far_row_ptr=ops.far_ptr, far_q=ops.win_ops[3].reshape(-1),
                   Zf=codes(ops.win_ops[0] * ops.win_ops[1]))
    sw = ops.sw.reshape(-1)
    want = kern.band_cross_int8(ops.local_idx32, ops.wq, sw, zp, B,
                                packed=packed, **far)
    fabs = dict(far, Zf=absc(far["Zf"])) if far else {}
    scale = kern.band_cross_int8(ops.local_idx32, ops.wq, sw, absc(zp), B,
                                 packed=packed, **fabs).double()
    on = lambda t: t.to(cuda_device)  # noqa: E731
    before = kern.LAUNCHES[mode]
    got = kern.band_cross_int8(on(ops.local_idx32), on(ops.wq), on(sw), on(zp), B,
                               packed=packed, **{k: on(v) for k, v in far.items()})
    assert kern.LAUNCHES[mode] == before + 1
    _assert_close(got, want, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,G", [(torch.bfloat16, 96), (torch.float32, 33)])
def test_float_kernel_matches_plain(cuda_device, plan, dtype, G):
    gen = torch.Generator().manual_seed(2)
    li = plan.local_idx.to(torch.int32)
    w = plan.w_local.to(dtype)
    zp = torch.randn((plan.n_padded + 2 * B, G), generator=gen).to(dtype)
    want = kern.band_cross_float(li, w, zp, B)
    lag = kern.band_lag_float_plain(li, w.abs(), zp.abs(), B)
    scale = (zp[B:B + plan.n_padded].abs().float() * lag).double().sum(0)
    before = kern.LAUNCHES["float"]
    got = kern.band_cross_float(li.to(cuda_device), w.to(cuda_device),
                                zp.to(cuda_device), B)
    assert kern.LAUNCHES["float"] == before + 1
    _assert_close(got, want, scale)


@pytest.mark.cuda
def test_kernel_runs_are_bitwise_reproducible(cuda_device, plan):
    li = plan.local_idx.to(torch.int32).to(cuda_device)
    w = plan.w_local.to(torch.bfloat16).to(cuda_device)
    zp = torch.randn((plan.n_padded + 2 * B, 128), device=cuda_device).to(torch.bfloat16)
    a = kern.band_cross_float(li, w, zp, B)
    b = kern.band_cross_float(li, w, zp, B)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_wrapper_raises_on_a_cuda_tensor_it_cannot_take(cuda_device, plan):
    li = plan.local_idx.to(torch.int32).to(cuda_device)
    w = plan.w_local.to(cuda_device)
    zp = torch.zeros((plan.n_padded + 2 * B, 8), dtype=torch.float64,
                     device=cuda_device)
    with pytest.raises(ValueError):
        kern.band_cross_float(li, w, zp, B)


# ---------------------------------------------------------------------------
# The LISA draw-step kernel (csrc/lisa_count_int8.cu): exact, so equality
# ---------------------------------------------------------------------------


def _lisa_operands(nb: int, G: int, k: int = 6, seed: int = 3):
    """Synthetic LISA operands: a compact band with some zero weights, and
    a far list whose rows include every block's first and last row."""
    gen = torch.Generator().manual_seed(seed)
    n = nb * B
    li = torch.randint(0, 3 * B, (n, k), generator=gen, dtype=torch.int32)
    wq = torch.randint(0, 128, (n, k), generator=gen).to(torch.int8)
    wq[torch.rand((n, k), generator=gen) < 0.2] = 0

    def codes(rows):
        return torch.randint(-127, 128, (rows, G), generator=gen, dtype=torch.int8)

    per_row = torch.randint(0, 3, (n,), generator=gen)
    per_row[0::B] = 2                               # each block's first row
    per_row[B - 1::B] = 3                           # ... and last row
    ptr = torch.zeros(n + 1, dtype=torch.int32)
    ptr[1:] = torch.cumsum(per_row, 0).to(torch.int32)
    F = int(ptr[-1])
    far_q = torch.randint(0, 128, (F,), generator=gen).to(torch.int8)
    zp, zf = codes(n + 2 * B), codes(F)
    dense = torch.randint(-k * 127 * 127, k * 127 * 127, (n, G), generator=gen,
                          dtype=torch.int32)
    obs = kern_lisa.lisa_observed(li, wq, codes(n + 2 * B), B,
                                  far_row_ptr=ptr, far_q=far_q, Zf=codes(F))
    return dict(li=li, wq=wq, zp=zp, obs=obs,
                far={"rows": dict(far_row_ptr=ptr, far_q=far_q, Zf=zf),
                     "dense": dict(far=dense), "none": {}})


@pytest.mark.cuda
@pytest.mark.parametrize("nb,G", [(1, 64), (5, 260)], ids=["one_block", "G260"])
@pytest.mark.parametrize("form", ["rows", "dense", "none"])
@pytest.mark.parametrize("cdt", [torch.int8, torch.int16, torch.int32])
def test_lisa_count_kernel_equals_plain(cuda_device, nb, G, form, cdt):
    o = _lisa_operands(nb, G)
    far = o["far"][form]
    cnt0 = torch.randint(0, 100, o["obs"].shape).to(cdt)
    want = kern_lisa.lisa_count(o["li"], o["wq"], o["zp"], B, o["obs"],
                                cnt0.clone(), **far)
    assert 0 < int((want != cnt0).sum()) < want.numel()
    on = lambda t: t.to(cuda_device)  # noqa: E731
    mode = {"rows": "lisa_win", "dense": "lisa_dense", "none": "lisa_band"}[form]
    before = kern_lisa.LAUNCHES[mode]
    got = kern_lisa.lisa_count(on(o["li"]), on(o["wq"]), on(o["zp"]), B,
                               on(o["obs"]), on(cnt0), **{k: on(v) for k, v in far.items()})
    torch.cuda.synchronize()
    assert kern_lisa.LAUNCHES[mode] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["rows", "dense", "none"])
def test_lisa_observed_kernel_equals_plain(cuda_device, form):
    o = _lisa_operands(3, 132)
    far = o["far"][form]
    want = kern_lisa.lisa_observed(o["li"], o["wq"], o["zp"], B, **far)
    before = kern_lisa.LAUNCHES["lisa_obs"]
    got = kern_lisa.lisa_observed(o["li"].to(cuda_device), o["wq"].to(cuda_device),
                                  o["zp"].to(cuda_device), B,
                                  **{k: v.to(cuda_device) for k, v in far.items()})
    torch.cuda.synchronize()
    assert kern_lisa.LAUNCHES["lisa_obs"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_lisa_pvalues_on_the_card_equal_the_cpu(cuda_device, plan):
    """The whole int8 LISA null on the card (kernel route) against the CPU
    (plain route) on one plan: p bitwise, through both far forms."""
    Z = torch.randn((plan.n, 40), generator=torch.Generator().manual_seed(4))
    want = banded.banded_local_moran_pvalues(plan, Z, 9, 19)
    on_card = banded.NullPlan(*[t.to(cuda_device) if isinstance(t, torch.Tensor)
                                else t for t in plan])
    for impl in ("auto", "pallas"):
        got = banded.banded_local_moran_pvalues(on_card, Z.to(cuda_device), 9, 19,
                                                band_impl=impl)
        assert torch.equal(got.cpu(), want)


# ---------------------------------------------------------------------------
# The geary, getis_star and getis_g tails of the same kernel: exact
# integers, or float32 rounded at the plain version's places, so equality
# ---------------------------------------------------------------------------


def _tail_operands(nb: int, G: int, getis: bool, seed: int = 5):
    """Operands of the geary / Getis entries: LISA's synthetic band and far
    list, with 0/1 codes and non-negative values for Getis."""
    o = _lisa_operands(nb, G, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    far = dict(o["far"]["rows"])
    n = o["li"].shape[0]
    src = torch.repeat_interleave(torch.arange(n), far["far_row_ptr"].diff().long())
    wq = o["wq"]
    if getis:
        wq = (wq != 0).to(torch.int8)
        far["far_q"] = torch.ones_like(far["far_q"])
        o["zp"] = o["zp"].abs()
        far["Zf"] = far["Zf"].abs()
    w_row = wq.to(torch.int32).sum(1, dtype=torch.int32).index_add_(
        0, src, far["far_q"].to(torch.int32))
    other = torch.randint(0 if getis else -127, 128, o["zp"].shape, generator=gen,
                          dtype=torch.int8)
    other_far = dict(far, Zf=torch.randint(0 if getis else -127, 128,
                                           far["Zf"].shape, generator=gen,
                                           dtype=torch.int8))
    return dict(li=o["li"], wq=wq, zp=o["zp"], far=far, w_row=w_row,
                other=other, other_far=other_far)


def _on(t, dev):
    return t.to(dev) if isinstance(t, torch.Tensor) else t


@pytest.mark.cuda
@pytest.mark.parametrize("nb,G", [(1, 64), (5, 260)], ids=["one_block", "G260"])
@pytest.mark.parametrize("cdt", [torch.int8, torch.int16, torch.int32])
def test_geary_kernel_equals_plain(cuda_device, nb, G, cdt):
    o = _tail_operands(nb, G, getis=False)
    obs = kern_lisa.geary_observed(o["li"], o["wq"], o["other"], B, o["w_row"],
                                   **o["other_far"])
    cnt0 = torch.randint(0, 100, obs.shape).to(cdt)
    want = kern_lisa.geary_count(o["li"], o["wq"], o["zp"], B, obs, cnt0.clone(),
                                 o["w_row"], **o["far"])
    assert 0 < int((want != cnt0).sum()) < want.numel()
    before = kern_lisa.LAUNCHES["geary_win"]
    got = kern_lisa.geary_count(*[_on(t, cuda_device) for t in (
        o["li"], o["wq"], o["zp"])], B, obs.to(cuda_device), cnt0.to(cuda_device),
        o["w_row"].to(cuda_device), **{k: _on(v, cuda_device) for k, v in o["far"].items()})
    torch.cuda.synchronize()
    assert kern_lisa.LAUNCHES["geary_win"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("getis", [False, True], ids=["geary", "getis_lag"])
def test_geary_and_getis_observed_kernels_equal_plain(cuda_device, getis):
    o = _tail_operands(3, 132, getis=getis)
    far_dev = {k: _on(v, cuda_device) for k, v in o["far"].items()}
    args = [o["li"], o["wq"], o["zp"]]
    args_dev = [t.to(cuda_device) for t in args]
    mode = "getis_obs" if getis else "geary_obs"
    before = kern_lisa.LAUNCHES[mode]
    if getis:
        want = kern_lisa.getis_lag(*args, B, **o["far"])
        got = kern_lisa.getis_lag(*args_dev, B, **far_dev)
    else:
        want = kern_lisa.geary_observed(*args, B, o["w_row"], **o["far"])
        got = kern_lisa.geary_observed(*args_dev, B, o["w_row"].to(cuda_device),
                                       **far_dev)
    torch.cuda.synchronize()
    assert kern_lisa.LAUNCHES[mode] == before + 1
    assert torch.equal(got.cpu(), want)


def _getis_moments(zp, n_rows: int, star: bool):
    codes = zp[B:B + n_rows].to(torch.int64)
    tot, sq = codes.sum(0).float(), (codes * codes).sum(0).float()
    inv_m = float(torch.tensor(1.0) / (n_rows if star else n_rows - 1))
    return tot, sq, inv_m


@pytest.mark.cuda
@pytest.mark.parametrize("alternative", ["two-sided", "greater", "less"])
@pytest.mark.parametrize("star", [True, False], ids=["getis_star", "getis_g"])
def test_getis_count_kernels_equal_plain(cuda_device, star, alternative):
    o = _tail_operands(5, 260, getis=True)
    n = o["li"].shape[0]
    lag_o = kern_lisa.getis_lag(o["li"], o["wq"], o["other"], B, **o["other_far"])
    me_o = o["other"][B:B + n].contiguous()
    tot, sq, inv_m = _getis_moments(o["zp"], n, star)
    w = o["w_row"].to(torch.float32)
    if star:
        obs = lag_o + me_o.to(torch.int32)
        kw = dict(wp1=w + 1.0, tm=tot * inv_m) if alternative == "two-sided" else {}
        fn, mode = kern_lisa.getis_star_count, "getis_star_win"
    else:
        obs = kern_lisa.gi_center(lag_o, me_o, w, tot, sq, inv_m)
        kw = dict(w_row=w, tot=tot, sq=sq, inv_m=inv_m, lag_o=lag_o, me_o=me_o)
        fn, mode = kern_lisa.getis_g_count, "getis_g_win"
    cnt0 = torch.randint(0, 100, obs.shape).to(torch.int8)
    want = fn(o["li"], o["wq"], o["zp"], B, obs, cnt0.clone(),
              alternative=alternative, **o["far"], **kw)
    assert 0 < int((want != cnt0).sum()) < want.numel()
    before = kern_lisa.LAUNCHES[mode]
    got = fn(*[t.to(cuda_device) for t in (o["li"], o["wq"], o["zp"])], B,
             obs.to(cuda_device), cnt0.to(cuda_device), alternative=alternative,
             **{k: _on(v, cuda_device) for k, v in {**o["far"], **kw}.items()})
    torch.cuda.synchronize()
    assert kern_lisa.LAUNCHES[mode] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_geary_and_getis_pvalues_on_the_card_equal_the_cpu(cuda_device, plan):
    """The int8 local-Geary and Getis nulls on the card (kernel route)
    against the CPU (plain route) on one plan: p bitwise."""
    gen = torch.Generator().manual_seed(6)
    Z = torch.randn((plan.n, 40), generator=gen)
    X = torch.poisson(torch.full((plan.n, 40), 3.0), generator=gen)
    on_card = banded.NullPlan(*[t.to(cuda_device) if isinstance(t, torch.Tensor)
                                else t for t in plan])
    want = banded.banded_local_geary(plan, Z, 9, 19, precision="int8")
    got = banded.banded_local_geary(on_card, Z.to(cuda_device), 9, 19,
                                    precision="int8")
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    for star, alt in ((True, "two-sided"), (False, "less")):
        want = banded.banded_getis(plan, X, 9, 19, star=star, alternative=alt,
                                   precision="int8")
        got = banded.banded_getis(on_card, X.to(cuda_device), 9, 19, star=star,
                                  alternative=alt, precision="int8")
        assert torch.equal(got.cpu(), want)
