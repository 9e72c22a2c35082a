"""Each hand-written kernel against its plain version, on a CUDA device.

The kernels have no CPU mode, so these tests skip without a card. This
file imports only torch and the port (no JAX), so it runs on a GPU machine
without the JAX package's test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerance: band cross |Δcross_g| ≤ 1e-5 · Σ_i |term_i| — float32 summation
order only; the integer lags are exact in both versions. The local
statistics' draw-step kernel (LISA, local Geary, Gi*, Gi, Lee): counts and
observed values equal — exact integers, and Gi's float32 centring and
Lee's block partials round at the plain version's places, so those are
equal too. The kNN kernel: indices and squared distances equal (the same
float32 operations, ties by id). ``permutation`` on the card: equal to
the CPU's.
"""

import pytest
import torch

from spatialcore_tpu_torch.core import rng
from spatialcore_tpu_torch.kernels import band_cross as kern
from spatialcore_tpu_torch.kernels import knn as kern_knn
from spatialcore_tpu_torch.kernels import lisa_count as kern_lisa
from spatialcore_tpu_torch.ops import banded
from spatialcore_tpu_torch.ops.graph import build_graph

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

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


def _codes(gen, rows: int, G: int, lim: int, packed: bool):
    """Random value codes in [-lim, lim], nibble-packed when ``packed``."""
    c = torch.randint(-lim, lim + 1, (rows, G), generator=gen, dtype=torch.int8)
    return banded._pack_codes(c) if packed else c


def _far_operands(gen, counts, G: int, lim: int, packed: bool):
    """Far operands with ``counts[r]`` entries on row r: row pointers,
    random weight codes in [0, 127] and value codes."""
    ptr = torch.zeros(counts.shape[0] + 1, dtype=torch.int32)
    ptr[1:] = torch.cumsum(counts, 0)
    F = int(ptr[-1])
    return dict(far_row_ptr=ptr,
                far_q=torch.randint(0, 128, (F,), generator=gen, dtype=torch.int8),
                Zf=_codes(gen, F, G, lim, packed))


def _check_int_kernel(cuda_device, li, wq, sw, zp, far, blk, packed, mode,
                      tiles):
    def absc(t):
        return banded._pack_codes(kern.unpack_nibbles(t).abs()) if packed else t.abs()

    def absw(t):                        # |−128| needs more than int8
        return t.to(torch.int16).abs()

    want = kern.band_cross_int8(li, wq, sw, zp, blk, packed=packed, **far)
    fabs = dict(far, Zf=absc(far["Zf"]), far_q=absw(far["far_q"])) if far else {}
    scale = kern.band_cross_int8_plain(li, absw(wq), sw, absc(zp), blk,
                                       packed=packed, **fabs).double()
    on = lambda t: t.to(cuda_device)  # noqa: E731
    before = kern.LAUNCHES[mode]
    got = kern.band_cross_int8_tiled(on(li), on(wq), on(sw), on(zp), blk, tiles,
                                     packed=packed,
                                     **{k: on(v) for k, v in far.items()})
    assert kern.LAUNCHES[mode] == before + 1
    _assert_close(got, want, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,G,blk,k,nb,run", [
    ("int4_win", 512, B, 6, None, None),      # the kNN plan, 40 blocks
    ("int8_win", 256, B, 6, None, None),
    ("int8_band", 260, B, 6, None, None),     # ragged: 4-byte ring fills
    ("int4_win", 1000, 256, 6, 7, 3),         # ragged int4, run ∤ nb
    ("int8_win", 260, 100, 6, 9, 4),          # B neither 16·m nor 32·m
    ("int8_band", 4096, 256, 50, 5, 2),       # k = 50: the band in chunks
    ("int4_win", 4096, 512, 50, 3, 2),
    ("int8_win", 1024, 512, 6, 4, 3),
    ("int4_win", 1000, 100, 50, 1, None),     # one-block plans
    ("int8_band", 260, 256, 6, 1, None),
])
def test_int8_kernel_matches_plain(cuda_device, plan, mode, G, blk, k, nb, run):
    """K1–K3 on the kNN plan's int operands and on synthetic bands (random
    signed weight codes, some zero; 0–3 far entries a row) at every edge of
    the design: B of 64/100/256/512, k of 6 and 50, column counts ragged
    against the 16-byte lane and the tile, runs that do not divide nb, one
    block; launched through ``band_cross_int8_tiled``."""
    packed = mode == "int4_win"
    gen = torch.Generator().manual_seed(1)
    lim = 7 if packed else 127
    if nb is None:
        rows_idx = plan.order[(torch.arange(plan.n_padded + 2 * blk) - blk)
                              .clamp(0, plan.n - 1)]
        ops, _ = banded._int_ops(plan, "int4" if packed else "int8",
                                 "win" if mode.endswith("win") else "exact",
                                 rows_idx, use_plain=False)
        li, wq, sw = ops.local_idx32, ops.wq, ops.sw.reshape(-1)
        far = {}
        if ops.win:
            far = dict(far_row_ptr=ops.far_ptr, far_q=ops.win_ops[3].reshape(-1),
                       Zf=_codes(gen, ops.win_ops[0] * ops.win_ops[1], G, lim,
                                 packed))
    else:
        rows = nb * blk
        li = torch.randint(0, 3 * blk, (rows, k), generator=gen, dtype=torch.int32)
        wq = torch.randint(-128, 128, (rows, k), generator=gen, dtype=torch.int8)
        wq[torch.rand((rows, k), generator=gen) < 0.2] = 0
        sw = torch.rand(rows, generator=gen) + 0.5
        far = (_far_operands(gen, torch.randint(0, 4, (rows,), generator=gen), G,
                             lim, packed) if mode.endswith("win") else {})
    zp = _codes(gen, li.shape[0] + 2 * blk, G, lim, packed)
    tiles = kern.int_tiles(blk, li.shape[1], packed, G, li.shape[0] // blk, run=run)
    _check_int_kernel(cuda_device, li, wq, sw, zp, far, blk, packed, mode, tiles)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,G", [("int4_win", 1024), ("int8_win", 512),
                                    ("int4_win", 1000), ("int8_band", 260)])
@pytest.mark.parametrize("sign", [1, -1])
@pytest.mark.parametrize("wcode", [127, -128])
def test_int8_kernel_lane_overflow(cuda_device, mode, G, sign, wcode):
    """Every value code at its extreme (int4 ±7, int8 ±127, one sign per
    case) and every band and far weight code 127 (or −128), at k = 50 with
    up to 60 far entries a row (most of them past the chunk's staged far
    entries): the kernel's packed integer sums (int4's high-nibble sums
    carry 16 × lag) must not overflow or lose a term — an error of one
    term is far above the tolerance — so the lags stay exact."""
    packed = mode == "int4_win"
    blk, nb, k = 256, 3, 50
    rows = nb * blk
    gen = torch.Generator().manual_seed(3)
    lim = 7 if packed else 127
    li = torch.randint(0, 3 * blk, (rows, k), generator=gen, dtype=torch.int32)
    wq = torch.full((rows, k), wcode, dtype=torch.int8)
    sw = torch.rand(rows, generator=gen) + 0.5
    far = (_far_operands(gen, torch.randint(0, 61, (rows,), generator=gen), G,
                         lim, packed) if mode.endswith("win") else {})
    code = torch.full((1, 2), sign * lim, dtype=torch.int8)
    fill = int((banded._pack_codes(code) if packed else code)[0, 0])
    zp = torch.full((rows + 2 * blk, G // 2 if packed else G), fill,
                    dtype=torch.int8)
    if far:
        far["Zf"].fill_(fill)
        far["far_q"].fill_(wcode)
    tiles = kern.int_tiles(blk, k, packed, G, nb, run=2)
    _check_int_kernel(cuda_device, li, wq, sw, zp, far, blk, packed, mode, tiles)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,G,blk,k,nb,run,offset", [
    (torch.bfloat16, 96, B, 6, None, None, 0),    # the kNN plan, 40 blocks
    (torch.float32, 33, B, 6, None, None, 0),     # odd G: element fills
    (torch.bfloat16, 1000, 256, 6, 7, 3, 0),      # G ragged against Gt=64
    (torch.float32, 1000, 256, 50, 5, 2, 0),      # k=50: the band in chunks
    (torch.bfloat16, 33, 512, 50, 3, 2, 0),
    (torch.float32, 512, 512, 6, 4, 3, 0),
    (torch.bfloat16, 1024, 100, 6, 9, 4, 1),      # B neither 16·m nor 32·m;
                                                  # band views off 16 bytes
    (torch.float32, 100, 256, 6, 1, None, 0),     # a one-block plan
    (torch.bfloat16, 33, B, 50, 1, None, 0),
])
def test_float_kernel_matches_plain(cuda_device, plan, dtype, G, blk, k, nb, run,
                                    offset):
    """K4 on the kNN plan and on synthetic bands (some zero weights) at
    every edge of its design: B of 64/100/256/512, k of 6 and 50, G ragged
    against the gene tile, runs that do not divide nb, one block, and band
    operands whose data is not 16-byte aligned (``offset`` rows into a
    larger tensor)."""
    gen = torch.Generator().manual_seed(2)
    if nb is None:
        li, w = plan.local_idx.to(torch.int32), plan.w_local.to(dtype)
    else:
        rows = nb * blk + offset
        li = torch.randint(0, 3 * blk, (rows, k), generator=gen,
                           dtype=torch.int32)
        w = torch.rand((rows, k), generator=gen)
        w[torch.rand((rows, k), generator=gen) < 0.2] = 0
        w = w.to(dtype)
    zp = torch.randn((li.shape[0] - offset + 2 * blk, G), generator=gen).to(dtype)
    # the views are taken on each device: .to() of a view would copy it
    # to a fresh, aligned allocation
    on = [li.to(cuda_device)[offset:], w.to(cuda_device)[offset:],
          zp.to(cuda_device)]
    li, w = li[offset:], w[offset:]
    assert (on[0].data_ptr() % 16 != 0) == bool(offset)
    want = kern.band_cross_float(li, w, zp, blk)
    scale = kern.band_cross_float(li, w.abs(), zp.abs(), blk).double()
    tiles = kern.float_tiles(blk, k, zp.element_size(), G, li.shape[0] // blk,
                             run=run)
    before = kern.LAUNCHES["float"]
    got = kern.band_cross_float_tiled(*on, blk, tiles)
    assert kern.LAUNCHES["float"] == before + 1
    _assert_close(got, want, scale)
    assert torch.equal(got, kern.band_cross_float(*on, blk) if run is None
                       else kern.band_cross_float_tiled(*on, blk, tiles))


_DENSE = {"dense": (3, banded._build_band, kern.band_cross_dense,
                    kern.band_cross_dense_tiled),
          "rot4": (4, banded._build_band_rot4, kern.band_cross_rot4,
                   kern.band_cross_rot4_tiled)}


def _dense_band(plan, entry, kind, blk, nb, dtype, gen):
    """A dense band for K5 (``entry`` "dense") or K6 ("rot4"): the kNN
    plan's ("plan", B=64), a synthetic kNN-like band (k=6 random window
    columns a row, a fifth of the weights zero), the same with rows 64–127
    of every block zero ("zero_tile": an all-zero 64-row tile), or a fully
    dense random A ("dense": no tile is skipped; K6's fourth column block
    holds weights too)."""
    width, build = _DENSE[entry][:2]
    if kind == "plan":
        return build(plan.local_idx, plan.w_local.to(dtype), B, dtype)
    if kind == "dense":
        return torch.randn((nb, blk, width * blk), generator=gen).to(dtype)
    li = torch.randint(0, 3 * blk, (nb * blk, 6), generator=gen)
    w = torch.rand((nb * blk, 6), generator=gen)
    w[torch.rand((nb * blk, 6), generator=gen) < 0.2] = 0
    A = build(li, w.to(dtype), blk, dtype)
    if kind == "zero_tile":
        A[:, 64:128] = 0
    return A


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["dense", "rot4"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("kind,blk,nb,G", [
    ("plan", B, None, 33),          # odd G: element loads
    ("plan", B, None, 96),          # 16-byte copies, a ragged gene tile
    ("plan", B, None, 200),
    ("plan", B, None, 1000),
    ("band", 16, 7, 96),            # B below the row tile
    ("band", 256, 17, 200),         # 17 blocks: no run of 16 divides them
    ("band", 64, 1, 1000),          # a one-block plan
    ("band", 256, 1, 96),
    ("dense", 64, 5, 96),           # nothing to skip
    ("dense", 256, 3, 200),
    ("zero_tile", 256, 3, 130),     # an all-zero 64-row tile
], ids=["plan-G33", "plan-G96", "plan-G200", "plan-G1000", "B16-nb7",
        "B256-nb17", "B64-one-block", "B256-one-block", "dense-B64",
        "dense-B256", "zero-64-row-tile"])
def test_dense_kernels_match_plain(cuda_device, plan, entry, dtype, kind, blk,
                                   nb, G):
    """K5 / K6 against their plain versions at every edge of the design:
    B of 16, 64 and 256, one block and block counts that no run divides,
    ragged G in both dtypes (odd G takes element loads), a band where most
    tiles are skipped beside a dense A where none is, and an all-zero row
    tile. Each launch shape (the default, 32 and 64 rows a CTA where they
    fit, the skip off) agrees within 1e-5·Σ|terms|, adds one launch, and
    two runs are bitwise equal."""
    width, _, fn, tiled = _DENSE[entry]
    gen = torch.Generator().manual_seed(5)
    A = _dense_band(plan, entry, kind, blk, nb, dtype, gen)
    blk = A.shape[1]
    zp = torch.randn(((A.shape[0] + 2) * blk, G), generator=gen).to(dtype)
    want = fn(A, zp, blk)
    scale = fn(A.abs(), zp.abs(), blk).double()
    Ad, zd = A.to(cuda_device), zp.to(cuda_device)
    esz = A.element_size()
    shapes = [None, kern.dense_tiles(blk, width, esz, skip=False)]
    shapes += [kern.dense_tiles(blk, width, esz, shape)
               for shape in kern.DENSE_SHAPES
               if kern.dense_smem_bytes(blk, width, esz, *shape) <= kern.SMEM_LIMIT]
    for tiles in shapes:
        before = kern.LAUNCHES[entry]
        got = tiled(Ad, zd, blk, tiles)
        assert kern.LAUNCHES[entry] == before + 1
        _assert_close(got, want, scale)
        assert torch.equal(got, tiled(Ad, zd, blk, tiles))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["dense", "rot4"])
def test_dense_kernels_skip_what_the_plain_version_turns_into_nan(
        cuda_device, plan, entry):
    """An Inf in a Zp row that only zero weights reach: the plain version
    multiplies it by 0 and gives NaN for that gene, the skipping kernels
    skip the all-zero tiles and stay finite (the other genes agree).
    Public routes pass finite, standardized values."""
    A = _dense_band(plan, entry, "plan", B, None, torch.float32, None)
    A[0, :, :B] = 0                 # block 0's first window slab: slab 0
    zp = torch.randn((plan.n_padded + 2 * B, 64),
                     generator=torch.Generator().manual_seed(6))
    zp[0, 0] = float("inf")         # slab 0 is in block 0's window only
    fn = _DENSE[entry][2]
    want = fn(A, zp, B)
    got = fn(A.to(cuda_device), zp.to(cuda_device), B).cpu()
    assert torch.isnan(want[0]) and torch.isfinite(got).all()
    scale = fn(A.abs(), zp.abs().nan_to_num(posinf=0.0), B).double()
    _assert_close(got[1:], want[1:], scale[1:])


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


# ---------------------------------------------------------------------------
# Lee's tail of the same kernel (draw step, observed and partial-only
# entries), the kNN kernel, and the sort-based permutation on the card
# ---------------------------------------------------------------------------


def _lee_operands(nb: int, G: int, seed: int = 7):
    """LISA's synthetic band and far list, fixed x codes, row scales, and
    the observed |Lq| of another placement."""
    o = _lisa_operands(nb, G, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    n = o["li"].shape[0]
    zx = torch.randint(-127, 128, (n, G), generator=gen, dtype=torch.int8)
    sw = torch.rand(n, generator=gen) * 0.01 + 1e-4
    far = dict(o["far"]["rows"])
    other = torch.randint(-127, 128, o["zp"].shape, generator=gen,
                          dtype=torch.int8)
    obs, _ = kern_lisa.lee_observed(o["li"], o["wq"], other, B, zx, sw, **far)
    return dict(args=(o["li"], o["wq"], o["zp"], B, zx, sw), far=far, obs=obs)


@pytest.mark.cuda
@pytest.mark.parametrize("nb,G", [(1, 64), (5, 260)], ids=["one_block", "G260"])
@pytest.mark.parametrize("cdt", [torch.int8, torch.int16, torch.int32])
def test_lee_kernels_equal_plain(cuda_device, nb, G, cdt):
    o = _lee_operands(nb, G)
    args_dev = tuple(_on(t, cuda_device) for t in o["args"])
    far_dev = {k: _on(v, cuda_device) for k, v in o["far"].items()}
    cnt0 = torch.randint(0, 100, o["obs"].shape).to(cdt)
    want_cnt = cnt0.clone()
    want_part = kern_lisa.lee_count(*o["args"], o["obs"], want_cnt, **o["far"])
    assert 0 < int((want_cnt != cnt0).sum()) < want_cnt.numel()
    before = dict(kern_lisa.LAUNCHES)
    got_cnt = cnt0.to(cuda_device)
    got_part = kern_lisa.lee_count(*args_dev, o["obs"].to(cuda_device), got_cnt,
                                   **far_dev)
    want_obs, want_opart = kern_lisa.lee_observed(*o["args"], **o["far"])
    got_obs, got_opart = kern_lisa.lee_observed(*args_dev, **far_dev)
    got_ppart = kern_lisa.lee_partial(*args_dev, **far_dev)
    torch.cuda.synchronize()
    for mode in ("lee_win", "lee_obs", "lee_partial"):
        assert kern_lisa.LAUNCHES[mode] == before[mode] + 1
    assert torch.equal(got_cnt.cpu(), want_cnt)
    assert torch.equal(got_part.cpu(), want_part)
    assert torch.equal(got_obs.cpu(), want_obs)
    assert torch.equal(got_opart.cpu(), want_opart)
    assert torch.equal(got_ppart.cpu(), want_opart)


@pytest.mark.cuda
@pytest.mark.parametrize("k,include_self", [(6, False), (6, True), (50, False),
                                            (50, True), (130, False)])
def test_knn_kernel_equals_plain(cuda_device, k, include_self):
    """Duplicated points and an integer lattice: equal distances break by
    id in both."""
    gen = torch.Generator().manual_seed(k)
    n = 5000
    xy = torch.randint(0, 80, (n, 2), generator=gen).to(torch.float32) - 40.0
    xy[::7] = xy[torch.randint(0, n, (len(xy[::7]),), generator=gen)]
    want_d, want_i = kern_knn.knn_topk(xy, k, include_self)
    before = kern_knn.LAUNCHES["knn"]
    got_d, got_i = kern_knn.knn_topk(xy.to(cuda_device), k, include_self)
    torch.cuda.synchronize()
    assert kern_knn.LAUNCHES["knn"] == before + 1
    assert torch.equal(got_i.cpu(), want_i)
    assert torch.equal(got_d.cpu(), want_d)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1625, 1626, 100_000])
def test_permutation_on_the_card_equals_the_cpu(cuda_device, n):
    k = rng.fold_in(rng.key_for(3, "perm_lee", 0), 5)
    got = rng.permutation(k, n, device=cuda_device)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), rng.permutation(k, n, device="cpu"))


@pytest.mark.cuda
def test_lee_pvalues_on_the_card_equal_the_cpu(cuda_device, plan):
    """The int8 Lee null on the card (kernel route) against the CPU (plain
    route) on one plan: global and per-cell p bitwise, both streams."""
    gen = torch.Generator().manual_seed(8)
    Zx, Zy = torch.randn((plan.n, 40), generator=gen), torch.randn(
        (plan.n, 40), generator=gen)
    on_card = banded.NullPlan(*[t.to(cuda_device) if isinstance(t, torch.Tensor)
                                else t for t in plan])
    for perm_method, cells in (("feistel", True), ("sort", False)):
        want = banded.banded_lees_l(plan, Zx, Zy, 9, 19, precision="int8",
                                    compute_cell_pvalues=cells,
                                    perm_method=perm_method)
        got = banded.banded_lees_l(on_card, Zx.to(cuda_device),
                                   Zy.to(cuda_device), 9, 19, precision="int8",
                                   compute_cell_pvalues=cells,
                                   perm_method=perm_method)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)
