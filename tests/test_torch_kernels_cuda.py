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


#: (B, k, nb, G, run): one block; G ragged against the 16-gene lane and the
#: 128-gene tile; B of 64, 100, 256 and 512; k of 6 and 50; runs that do
#: not divide nb (None: the chooser's run)
LISA_CASES = [(64, 6, 1, 64, None), (64, 6, 5, 260, 2), (100, 6, 7, 1000, 3),
              (256, 50, 3, 260, 2), (512, 6, 3, 1000, 2)]
LISA_IDS = ["B64_one_block", "B64_G260_run2", "B100_G1000_run3", "B256_k50_run2",
            "B512_G1000_run2"]
#: geary also at its exactness bound, k = 256 with codes ±127
GEARY_CASES = LISA_CASES + [(64, 256, 2, 132, None)]
GEARY_IDS = LISA_IDS + ["B64_k256_pm127"]
#: Lee also at k = 300
LEE_CASES = LISA_CASES + [(64, 300, 2, 260, None)]
LEE_IDS = LISA_IDS + ["B64_k300"]
_FORMS = {"none": 0, "rows": 1, "dense": 2}


def _lisa_operands(nb: int, G: int, k: int = 6, blk: int = B, seed: int = 3,
                   one_code_a_row: bool = False):
    """Synthetic LISA operands: a compact band with some zero weights (with
    ``one_code_a_row`` every nonzero weight of a row is one code, as in a
    kNN band), and a far list of 0–3 entries a row whose rows include every
    block's first and last row. At k = 256 every code is ±127 (geary's
    exactness bound)."""
    gen = torch.Generator().manual_seed(seed)
    n = nb * blk
    li = torch.randint(0, 3 * blk, (n, k), generator=gen, dtype=torch.int32)
    wq = torch.randint(0, 128, (n, k), generator=gen).to(torch.int8)
    wq[torch.rand((n, k), generator=gen) < 0.2] = 0
    if one_code_a_row:
        row = torch.randint(1, 128, (n, 1), generator=gen).to(torch.int8)
        wq = torch.where(wq != 0, row, wq)

    def codes(rows):
        if k == 256:
            return (torch.randint(0, 2, (rows, G), generator=gen) * 254 - 127
                    ).to(torch.int8)
        return torch.randint(-127, 128, (rows, G), generator=gen, dtype=torch.int8)

    per_row = torch.randint(0, 4, (n,), generator=gen)
    per_row[0::blk] = 2                             # each block's first row
    per_row[blk - 1::blk] = 3                       # ... and last row
    ptr = torch.zeros(n + 1, dtype=torch.int32)
    ptr[1:] = torch.cumsum(per_row, 0).to(torch.int32)
    F = int(ptr[-1])
    far_q = torch.randint(0, 128, (F,), generator=gen).to(torch.int8)
    zp, zf = codes(n + 2 * blk), codes(F)
    dense = torch.randint(-k * 127 * 127, k * 127 * 127, (n, G), generator=gen,
                          dtype=torch.int32)
    obs = kern_lisa.lisa_observed(li, wq, codes(n + 2 * blk), blk,
                                  far_row_ptr=ptr, far_q=far_q, Zf=codes(F))
    return dict(li=li, wq=wq, zp=zp, obs=obs, blk=blk,
                far={"rows": dict(far_row_ptr=ptr, far_q=far_q, Zf=zf),
                     "dense": dict(far=dense), "none": {}})


def _on(t, dev):
    return t.to(dev) if isinstance(t, torch.Tensor) else t


def _shapes(case, stat: str, form: int, cnt_bytes: int):
    """Every launch shape a case runs at: the chooser's, the narrowest tile
    (16 genes), ragged 7-row chunks staging one far entry, and no far entry
    staged."""
    blk, k, nb, G, run = case
    t = kern_lisa.lisa_tiles(blk, k, stat, form, cnt_bytes, G, nb, run=run)
    narrow = kern_lisa.lisa_tiles(blk, k, stat, form, cnt_bytes, G, nb,
                                  max_tile=16, run=run)
    return [t, narrow, t._replace(chunk=min(7, t.chunk), far_cap=min(1, t.far_cap)),
            t._replace(far_cap=0)]


def _equal_at_every_shape(fn, mode: str, want, shapes):
    """``fn(tiles)`` at every launch shape, twice each: one launch a call,
    and both runs equal to ``want`` (a tensor or a tuple) bitwise."""
    want = want if isinstance(want, tuple) else (want,)
    for tiles in shapes:
        for _ in range(2):
            before = kern_lisa.LAUNCHES[mode]
            got = fn(tiles)
            torch.cuda.synchronize()
            assert kern_lisa.LAUNCHES[mode] == before + 1, tiles
            got = got if isinstance(got, tuple) else (got,)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w), tiles


@pytest.mark.cuda
@pytest.mark.parametrize("case", LISA_CASES, ids=LISA_IDS)
@pytest.mark.parametrize("form", ["rows", "dense", "none"])
@pytest.mark.parametrize("cdt", [torch.int8, torch.int16, torch.int32])
def test_lisa_count_kernel_equals_plain(cuda_device, case, form, cdt):
    blk, k, nb, G, _ = case
    o = _lisa_operands(nb, G, k=k, blk=blk)
    far = o["far"][form]
    cnt0 = torch.randint(0, 100, o["obs"].shape).to(cdt)
    want = kern_lisa.lisa_count(o["li"], o["wq"], o["zp"], blk, o["obs"],
                                cnt0.clone(), **far)
    assert 0 < int((want != cnt0).sum()) < want.numel()
    args = [_on(o[x], cuda_device) for x in ("li", "wq", "zp")]
    obs, cnt = o["obs"].to(cuda_device), cnt0.to(cuda_device)
    far_dev = {x: _on(v, cuda_device) for x, v in far.items()}
    mode = {"rows": "lisa_win", "dense": "lisa_dense", "none": "lisa_band"}[form]
    _equal_at_every_shape(
        lambda tiles: kern_lisa.lisa_count(*args, blk, obs, cnt.clone(), **far_dev,
                                           tiles=tiles),
        mode, want, _shapes(case, "moran", _FORMS[form], cnt0.element_size()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", LISA_CASES, ids=LISA_IDS)
@pytest.mark.parametrize("form", ["rows", "dense", "none"])
def test_lisa_observed_kernel_equals_plain(cuda_device, case, form):
    blk, k, nb, G, _ = case
    o = _lisa_operands(nb, G, k=k, blk=blk)
    far = o["far"][form]
    want = kern_lisa.lisa_observed(o["li"], o["wq"], o["zp"], blk, **far)
    args = [_on(o[x], cuda_device) for x in ("li", "wq", "zp")]
    far_dev = {x: _on(v, cuda_device) for x, v in far.items()}
    _equal_at_every_shape(
        lambda tiles: kern_lisa.lisa_observed(*args, blk, **far_dev, tiles=tiles),
        "lisa_obs", want, _shapes(case, "moran", _FORMS[form], 0))


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


def _tail_operands(case, getis: bool, seed: int = 5, one_code_a_row: bool = False):
    """Operands of the geary / Getis entries: LISA's synthetic band and far
    list, with 0/1 codes and non-negative values for Getis."""
    blk, k, nb, G, _ = case
    o = _lisa_operands(nb, G, k=k, blk=blk, seed=seed, one_code_a_row=one_code_a_row)
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
    def codes(shape):                   # at k = 256 ±127, as the draw's
        if k == 256 and not getis:
            return (torch.randint(0, 2, shape, generator=gen) * 254 - 127).to(torch.int8)
        return torch.randint(0 if getis else -127, 128, shape, generator=gen,
                             dtype=torch.int8)

    other = codes(o["zp"].shape)
    other_far = dict(far, Zf=codes(far["Zf"].shape))
    return dict(li=o["li"], wq=wq, zp=o["zp"], far=far, w_row=w_row,
                other=other, other_far=other_far)


@pytest.mark.cuda
@pytest.mark.parametrize("case", GEARY_CASES, ids=GEARY_IDS)
@pytest.mark.parametrize("cdt", [torch.int8, torch.int16, torch.int32])
@pytest.mark.parametrize("one_code_a_row", [False, True], ids=["codes", "one_code_a_row"])
def test_geary_kernel_equals_plain(cuda_device, case, cdt, one_code_a_row):
    """Both ways the kernel sums w·z²: per code, and by one dp4a a group
    where a row's nonzero weights are one code."""
    blk = case[0]
    o = _tail_operands(case, getis=False, one_code_a_row=one_code_a_row)
    obs = kern_lisa.geary_observed(o["li"], o["wq"], o["other"], blk, o["w_row"],
                                   **o["other_far"])
    cnt0 = torch.randint(0, 100, obs.shape).to(cdt)
    want = kern_lisa.geary_count(o["li"], o["wq"], o["zp"], blk, obs, cnt0.clone(),
                                 o["w_row"], **o["far"])
    assert 0 < int((want != cnt0).sum()) < want.numel()
    args = [_on(o[x], cuda_device) for x in ("li", "wq", "zp")]
    obs, cnt, w_row = (t.to(cuda_device) for t in (obs, cnt0, o["w_row"]))
    far_dev = {x: _on(v, cuda_device) for x, v in o["far"].items()}
    _equal_at_every_shape(
        lambda tiles: kern_lisa.geary_count(*args, blk, obs, cnt.clone(), w_row,
                                            **far_dev, tiles=tiles),
        "geary_win", want, _shapes(case, "geary", 1, cnt0.element_size()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", GEARY_CASES, ids=GEARY_IDS)
@pytest.mark.parametrize("getis", [False, True], ids=["geary", "getis_lag"])
@pytest.mark.parametrize("one_code_a_row", [False, True], ids=["codes", "one_code_a_row"])
def test_geary_and_getis_observed_kernels_equal_plain(cuda_device, case, getis,
                                                      one_code_a_row):
    blk = case[0]
    o = _tail_operands(case, getis=getis, one_code_a_row=one_code_a_row)
    far_dev = {x: _on(v, cuda_device) for x, v in o["far"].items()}
    args = [o["li"], o["wq"], o["zp"]]
    args_dev = [t.to(cuda_device) for t in args]
    if getis:
        want = kern_lisa.getis_lag(*args, blk, **o["far"])
        fn = lambda tiles: kern_lisa.getis_lag(*args_dev, blk, **far_dev,  # noqa: E731
                                               tiles=tiles)
        mode, stat = "getis_obs", "getis_star"
    else:
        want = kern_lisa.geary_observed(*args, blk, o["w_row"], **o["far"])
        w_row = o["w_row"].to(cuda_device)
        fn = lambda tiles: kern_lisa.geary_observed(  # noqa: E731
            *args_dev, blk, w_row, **far_dev, tiles=tiles)
        mode, stat = "geary_obs", "geary"
    _equal_at_every_shape(fn, mode, want, _shapes(case, stat, 1, 0))


def _radius_rows(wq: torch.Tensor, far: dict, seed: int = 7):
    """A radius plan's band: row i's first deg_i slots live at code 127,
    the rest dead (code 0), a row in nine with no live slot and no far
    entry (an isolated cell); far codes 127."""
    gen = torch.Generator().manual_seed(seed)
    n, k = wq.shape
    deg = torch.randint(0, k + 1, (n, 1), generator=gen)
    deg[::9] = 0
    live = torch.arange(k)[None, :] < deg
    ptr = far["far_row_ptr"].clone()
    per_row = ptr.diff()
    per_row[::9] = 0
    ptr[1:] = torch.cumsum(per_row, 0).to(ptr.dtype)
    F = int(ptr[-1])
    rows = dict(far, far_row_ptr=ptr, far_q=torch.full((F,), 127, dtype=torch.int8),
                Zf=far["Zf"][:F])
    return torch.where(live, 127, 0).to(torch.int8), rows


@pytest.mark.cuda
@pytest.mark.parametrize("k", [32, 48, 128])
@pytest.mark.parametrize("stat", ["moran", "geary"])
def test_draw_step_on_radius_rows(cuda_device, k, stat):
    """K7's moran and geary tails and their observed entries on a radius
    plan's rows: live and dead slots in one row (geary's one-code dp4a
    path), all-zero rows, k of 32–128; bitwise equal to the plain version
    at every launch shape."""
    blk, nb, G = 64, 3, 260
    case = (blk, k, nb, G, 2)
    o = _lisa_operands(nb, G, k=k, blk=blk)
    wq, far = _radius_rows(o["wq"], o["far"]["rows"])
    n = wq.shape[0]
    src = torch.repeat_interleave(torch.arange(n), far["far_row_ptr"].diff().long())
    w_row = wq.to(torch.int32).sum(1, dtype=torch.int32).index_add_(
        0, src, far["far_q"].to(torch.int32))
    host = [o["li"], wq, o["zp"]]
    dev = [t.to(cuda_device) for t in host]
    far_dev = {x: _on(v, cuda_device) for x, v in far.items()}
    if stat == "moran":
        obs = kern_lisa.lisa_observed(*host, blk, **far)
        _equal_at_every_shape(
            lambda tiles: kern_lisa.lisa_observed(*dev, blk, **far_dev, tiles=tiles),
            "lisa_obs", obs, _shapes(case, "moran", 1, 0))
        # the count compares one placement's value with another's
        obs = kern_lisa.lisa_observed(o["li"], wq, o["zp"].flip(0), blk, **far)
        cnt0 = torch.randint(0, 100, obs.shape).to(torch.int8)
        want = kern_lisa.lisa_count(*host, blk, obs, cnt0.clone(), **far)
        fn = lambda tiles: kern_lisa.lisa_count(  # noqa: E731
            *dev, blk, obs.to(cuda_device), cnt0.to(cuda_device), **far_dev,
            tiles=tiles)
        mode = "lisa_win"
    else:
        obs = kern_lisa.geary_observed(*host, blk, w_row, **far)
        w_dev = w_row.to(cuda_device)
        _equal_at_every_shape(
            lambda tiles: kern_lisa.geary_observed(*dev, blk, w_dev, **far_dev,
                                                   tiles=tiles),
            "geary_obs", obs, _shapes(case, "geary", 1, 0))
        obs = kern_lisa.geary_observed(o["li"], wq, o["zp"].flip(0), blk, w_row,
                                       **far)
        cnt0 = torch.randint(0, 100, obs.shape).to(torch.int8)
        want = kern_lisa.geary_count(*host, blk, obs, cnt0.clone(), w_row, **far)
        fn = lambda tiles: kern_lisa.geary_count(  # noqa: E731
            *dev, blk, obs.to(cuda_device), cnt0.to(cuda_device), w_dev,
            **far_dev, tiles=tiles)
        mode = "geary_win"
    assert 0 < int((want != cnt0).sum()) < want.numel()
    _equal_at_every_shape(fn, mode, want, _shapes(case, stat, 1, 1))


def _getis_moments(zp, blk: int, n_rows: int, star: bool):
    codes = zp[blk:blk + n_rows].to(torch.int64)
    tot, sq = codes.sum(0).float(), (codes * codes).sum(0).float()
    inv_m = float(torch.tensor(1.0) / (n_rows if star else n_rows - 1))
    return tot, sq, inv_m


@pytest.mark.cuda
@pytest.mark.parametrize("case", LISA_CASES, ids=LISA_IDS)
@pytest.mark.parametrize("alternative", ["two-sided", "greater", "less"])
@pytest.mark.parametrize("star", [True, False], ids=["getis_star", "getis_g"])
def test_getis_count_kernels_equal_plain(cuda_device, case, star, alternative):
    blk = case[0]
    o = _tail_operands(case, getis=True)
    n = o["li"].shape[0]
    lag_o = kern_lisa.getis_lag(o["li"], o["wq"], o["other"], blk, **o["other_far"])
    me_o = o["other"][blk:blk + n].contiguous()
    tot, sq, inv_m = _getis_moments(o["zp"], blk, n, star)
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
    want = fn(o["li"], o["wq"], o["zp"], blk, obs, cnt0.clone(),
              alternative=alternative, **o["far"], **kw)
    assert 0 < int((want != cnt0).sum()) < want.numel()
    args = [o[x].to(cuda_device) for x in ("li", "wq", "zp")]
    obs, cnt = obs.to(cuda_device), cnt0.to(cuda_device)
    kw_dev = {x: _on(v, cuda_device) for x, v in {**o["far"], **kw}.items()}
    _equal_at_every_shape(
        lambda tiles: fn(*args, blk, obs, cnt.clone(), alternative=alternative,
                         **kw_dev, tiles=tiles),
        mode, want, _shapes(case, mode[:-4], 1, 1))


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


@pytest.mark.cuda
@pytest.mark.parametrize("stat,mode", [("moran", "lisa_win"),
                                       ("geary", "geary_win"),
                                       ("getis_star", "getis_star_win"),
                                       ("getis_g", "getis_g_win")])
def test_sort_stream_on_the_card_equals_the_cpu(cuda_device, plan, stat, mode):
    """The int8 local nulls on the "sort" stream (the slot null's
    ``jax.random.permutation`` draws) on the card: the K7 tail launched once
    a draw, p bitwise equal to the CPU's plain route."""
    gen = torch.Generator().manual_seed(10)
    Z = torch.randn((plan.n, 40), generator=gen)
    X = torch.poisson(torch.full((plan.n, 40), 3.0), generator=gen)
    on_card = banded.NullPlan(*[t.to(cuda_device) if isinstance(t, torch.Tensor)
                                else t for t in plan])

    def run(pl, dev):
        if stat == "moran":
            return banded.banded_local_moran_pvalues(
                pl, Z.to(dev), 9, 19, perm_method="sort")
        if stat == "geary":
            return banded.banded_local_geary(pl, Z.to(dev), 9, 19,
                                             precision="int8",
                                             perm_method="sort")[1]
        star = stat == "getis_star"
        return banded.banded_getis(pl, X.to(dev), 9, 19, star=star,
                                   alternative="two-sided" if star else "less",
                                   precision="int8", perm_method="sort")

    kern_lisa.reset_launch_counts()
    got = run(on_card, cuda_device)
    torch.cuda.synchronize()
    assert kern_lisa.LAUNCHES[mode] == 19
    assert torch.equal(got.cpu(), run(plan, "cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("null", ["total", "conditional"])
def test_slot_nulls_on_the_card_equal_the_cpu(cuda_device, null):
    """The local slot nulls (torch ops, no kernel) on the card: the
    conditional draws bitwise, local Moran / Geary and Getis counts equal to
    the CPU's on integer-valued data standardized exactly."""
    from spatialcore_tpu_torch.ops import getis, moran

    key = rng.fold_in(rng.key_for(2, "perm_local", 0), 3)
    for a, b in zip(moran._conditional_draw_indices(key, 5000, 6, cuda_device),
                    moran._conditional_draw_indices(key, 5000, 6, "cpu")):
        assert torch.equal(a.cpu(), b)
    gen = torch.Generator().manual_seed(12)
    coords = torch.randint(0, 2048, (4096, 2), generator=gen).float()
    X = torch.randint(-3, 4, (4096, 8), generator=gen).float()
    X[-1] -= X.sum(dim=0)
    Xc = torch.poisson(torch.full((4096, 8), 3.0), generator=gen)
    graph = build_graph(coords, n_neighbors=6, device="cpu")
    gcard = type(graph)(*[t.to(cuda_device) for t in graph])
    Z, _ = moran.standardize(X)
    for fn in (moran.local_moran, moran.local_geary):
        want = fn(graph, Z, 4, 19, null=null).p_value
        got = fn(gcard, Z.to(cuda_device), 4, 19, null=null).p_value
        assert torch.equal(got.cpu(), want)
    star = null == "total"
    want = getis.getis_ord(graph, Xc, star=star, seed=4, n_permutations=19)
    got = getis.getis_ord(gcard, Xc.to(cuda_device), star=star, seed=4,
                          n_permutations=19)
    assert torch.equal(got.p_sim.cpu(), want.p_sim)


# ---------------------------------------------------------------------------
# Lee's tail of the same kernel (draw step, observed and partial-only
# entries), the kNN kernel, and the sort-based permutation on the card
# ---------------------------------------------------------------------------


def _lee_operands(case, seed: int = 7):
    """LISA's synthetic band and far list, fixed x codes, row scales, and
    the observed |Lq| of another placement."""
    blk, k, nb, G, _ = case
    o = _lisa_operands(nb, G, k=k, blk=blk, seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    n = o["li"].shape[0]
    zx = torch.randint(-127, 128, (n, G), generator=gen, dtype=torch.int8)
    sw = torch.rand(n, generator=gen) * 0.01 + 1e-4
    far = dict(o["far"]["rows"])
    other = torch.randint(-127, 128, o["zp"].shape, generator=gen,
                          dtype=torch.int8)
    obs, _ = kern_lisa.lee_observed(o["li"], o["wq"], other, blk, zx, sw, **far)
    return dict(args=(o["li"], o["wq"], o["zp"], blk, zx, sw), far=far, obs=obs)


@pytest.mark.cuda
@pytest.mark.parametrize("case", LEE_CASES, ids=LEE_IDS)
@pytest.mark.parametrize("cdt", [torch.int8, torch.int16, torch.int32])
def test_lee_kernels_equal_plain(cuda_device, case, cdt):
    o = _lee_operands(case)
    args_dev = tuple(_on(t, cuda_device) for t in o["args"])
    far_dev = {x: _on(v, cuda_device) for x, v in o["far"].items()}
    cnt0 = torch.randint(0, 100, o["obs"].shape).to(cdt)
    want_cnt = cnt0.clone()
    want_part = kern_lisa.lee_count(*o["args"], o["obs"], want_cnt, **o["far"])
    assert 0 < int((want_cnt != cnt0).sum()) < want_cnt.numel()
    want_obs, want_opart = kern_lisa.lee_observed(*o["args"], **o["far"])
    obs, cnt = o["obs"].to(cuda_device), cnt0.to(cuda_device)

    def count(tiles):
        c = cnt.clone()
        part = kern_lisa.lee_count(*args_dev, obs, c, **far_dev, tiles=tiles)
        return c, part

    _equal_at_every_shape(count, "lee_win", (want_cnt, want_part),
                          _shapes(case, "lee", 1, cnt0.element_size()))
    _equal_at_every_shape(
        lambda tiles: kern_lisa.lee_observed(*args_dev, **far_dev, tiles=tiles),
        "lee_obs", (want_obs, want_opart), _shapes(case, "lee", 1, 0))
    _equal_at_every_shape(
        lambda tiles: kern_lisa.lee_partial(*args_dev, **far_dev, tiles=tiles),
        "lee_partial", want_opart, _shapes(case, "lee", 1, 0))


def _knn_shapes(n: int, k: int, every: bool = True):
    """The chooser's shape for (n, k), 1,024-point tiles, and (``every``)
    other tiles, stages and CTA sizes, with a partial last tile where n
    allows."""
    t = kern_knn.knn_tiles(n, k)
    shapes = [t, t._replace(tile=1024)]
    if every:
        shapes += [kern_knn.KnnTiles(64, 128, 2), kern_knn.KnnTiles(128, 256, 4)]
    out = []
    for s in shapes:
        kern_knn.check_tiles(s)
        if s not in out:
            out.append(s)
    return out


def _knn_coords(n: int, kind: str, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    if kind == "lattice":               # equal distances everywhere
        xy = torch.randint(0, 80, (n, 2), generator=gen).to(torch.float32) - 40.0
    else:
        xy = torch.rand((n, 2), generator=gen) * 600 - 300
    dup = torch.arange(0, n, 7)         # duplicated points: ties at d2 = 0
    xy[dup] = xy[torch.randint(0, n, (len(dup),), generator=gen)]
    return xy


def _knn_equal_at_shapes(dev, xy, k, include_self, shapes, want):
    """Every shape gives ``want`` (d2, ids) bitwise, twice, one launch a
    call."""
    want_d, want_i = (w.cpu() for w in want)
    for tiles in shapes:
        runs = []
        for _ in range(2):
            before = kern_knn.LAUNCHES["knn"]
            runs.append(kern_knn.knn_topk_tiled(xy, k, include_self, tiles))
            torch.cuda.synchronize()
            assert kern_knn.LAUNCHES["knn"] == before + 1, tiles
        (d0, i0), (d1, i1) = runs
        assert torch.equal(d0, d1) and torch.equal(i0, i1), tiles
        got_d, got_i = d0.cpu(), i0.cpu()
        bad = int((got_i != want_i).any(1).sum())
        assert bad == 0, f"{tiles}: {bad} rows of ids differ"
        assert torch.equal(got_d, want_d), tiles


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5000, 66_536, "k+1"])
@pytest.mark.parametrize("include_self", [False, True])
@pytest.mark.parametrize("k", [1, 6, 8, 9, 16, 17, 50, 64, 65, 130, 256])
def test_knn_kernel_equals_plain(cuda_device, k, include_self, n):
    """Ids and d2 equal to the plain version's at every launch shape:
    duplicated points and an integer lattice at 5,000 points (equal
    distances break by id in both), uniform points at 66,536 (the chooser's
    shape and 1,024-point tiles; the plain version on the card), and
    n = k + 1."""
    if n == "k+1":
        n, kinds = k + 1, ("lattice", "uniform")
    elif n == 5000:
        kinds = ("lattice", "uniform")
    else:
        kinds = ("uniform",)
    for kind in kinds:
        xy = _knn_coords(n, kind, k + n)
        if n > 10_000:
            xy_dev = xy.to(cuda_device)
            want = kern_knn.knn_topk_plain(xy_dev, k, include_self)
            shapes = _knn_shapes(n, k, every=False)
        else:
            xy_dev = xy.to(cuda_device)
            want = kern_knn.knn_topk(xy, k, include_self)
            shapes = _knn_shapes(n, k)
        before = kern_knn.LAUNCHES["knn"]
        got = kern_knn.knn_topk(xy_dev, k, include_self)
        torch.cuda.synchronize()
        assert kern_knn.LAUNCHES["knn"] == before + 1
        _knn_equal_at_shapes(cuda_device, xy_dev, k, include_self, shapes, want)
        assert torch.equal(got[1].cpu(), want[1].cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("k,include_self", [(6, False), (6, True), (50, False),
                                            (130, True)])
def test_knn_kernel_overflow_rows(cuda_device, k, include_self):
    """Points at ±1e20, whose d2 to most others overflows to +Inf: those
    never enter, so some rows end in id -1 and d2 +Inf, as in the plain
    version."""
    n = 3000
    xy = _knn_coords(n, "uniform", 11)
    gen = torch.Generator().manual_seed(12)
    far = torch.randperm(n, generator=gen)[:40]
    signs = torch.randint(0, 2, (len(far), 2), generator=gen).to(torch.float32) * 2 - 1
    xy[far] = signs * 1e20 * (1 + torch.rand((len(far), 2), generator=gen))
    want = kern_knn.knn_topk(xy, k, include_self)
    assert bool((want[1] == -1).any()) and bool(torch.isinf(want[0]).any())
    _knn_equal_at_shapes(cuda_device, xy.to(cuda_device), k, include_self,
                         _knn_shapes(n, k), want)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [2.0 ** -60, 2.0 ** 50])
@pytest.mark.parametrize("k,include_self", [(6, False), (50, True)])
def test_knn_kernel_filter_ranges(cuda_device, k, include_self, scale):
    """A lattice scaled below the range of the kernel's expanded filter
    (every |coordinate| under 2^-50, so it ranks by the exact filter) and
    near its top (under 2^60, with a margin far above the k-th d2): ties
    still break by id, equal to the plain version at every shape."""
    xy = _knn_coords(3000, "lattice", 13) * scale
    want = kern_knn.knn_topk(xy, k, include_self)
    _knn_equal_at_shapes(cuda_device, xy.to(cuda_device), k, include_self,
                         _knn_shapes(3000, k), want)


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
