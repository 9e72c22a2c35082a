"""The float local Moran null's draw step (``kernels/lisa_float.py``) on the
CPU: its plain version and the null's routing through it.

Tolerance: none. The draw step's counts are held bitwise (``torch.equal``)
against a frozen copy of the torch-op loop the float null ran before the
draw step had a kernel: a gather, a product and an add per band slot, then
per far slot, then ``|z·lag| ≥ obs``. Exact ties decide p on discrete
counts, so the counts must fall the same way on every input: plans with
and without far edges, padded rows (+inf observed), ragged gene counts, a
radius plan with dead slots, f32 and bf16 tables. The kernel itself is
held against the plain version on the card (``tests/test_torch_kernels_
cuda.py``).
"""

import pytest
import torch

from spatialcore_tpu_torch.kernels import band_cross as kern
from spatialcore_tpu_torch.kernels import lisa_float as kern_float
from spatialcore_tpu_torch.ops import banded
from spatialcore_tpu_torch.ops.graph import build_graph
from spatialcore_tpu_torch.utils import profiling as prof

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

B = 64


# ---------------------------------------------------------------------------
# The loop the float null ran before its draw step had a kernel, frozen
# ---------------------------------------------------------------------------


def _old_far_slots(plan, n_live):
    Bp = plan.block
    rows = (plan.far_src[:n_live] - Bp).to(torch.int64)
    ptr = banded._row_ptr(plan.far_src, n_live, Bp, plan.n_padded)
    rank = torch.arange(n_live) - ptr[rows].to(torch.int64)
    R = int(rank.max()) + 1 if n_live else 0
    dst = torch.zeros((plan.n_padded, R), dtype=torch.int64)
    w = torch.zeros((plan.n_padded, R), dtype=torch.float32)
    dst[rows, rank] = plan.far_dst[:n_live].to(torch.int64)
    w[rows, rank] = plan.far_w[:n_live].to(torch.float32)
    return dst, w


def _old_lag(local_idx, w, Zp, block, far, r0, r1):
    rows = torch.arange(r0, r1)
    win0 = (rows // block) * block
    lag = None
    for s in range(local_idx.shape[1]):
        term = (w[r0:r1, s:s + 1].to(torch.float32)
                * Zp[win0 + local_idx[r0:r1, s]].to(torch.float32))
        lag = term if lag is None else lag + term
    fdst, fw = far
    for t in range(fdst.shape[1]):
        lag = lag + Zp[fdst[r0:r1, t]].to(torch.float32) * fw[r0:r1, t:t + 1]
    return lag


def _old_step(local_idx, w, Zp, block, far, obs, cnt):
    n_rows = local_idx.shape[0]
    lag = _old_lag(local_idx, w, Zp, block, far, 0, n_rows)
    Ip = Zp[block:block + n_rows].to(torch.float32) * lag
    cnt += (Ip.abs() >= obs).to(cnt.dtype)
    return cnt


def _old_null_p(plan, Z, abs_obs_new, seed, n_permutations, precision):
    Bp = plan.block
    wdt = torch.bfloat16 if precision == "bf16" else Z.dtype
    w = plan.w_local.to(wdt)
    Ztab = Z if Z.dtype == wdt else Z.to(wdt)
    rows_idx = banded._padded_rows(plan, Z.device)
    far = _old_far_slots(plan, banded._n_live_far(plan))
    rows_of = banded._draw_rows("feistel", seed, rows_idx, plan.n, "perm_local",
                                "perm_feistel_local")
    count = torch.zeros((plan.n_padded, Z.shape[1]), dtype=torch.int16)
    for step in range(n_permutations):
        _old_step(plan.local_idx, w, Ztab[rows_of(step)], Bp, far, abs_obs_new,
                  count)
    return banded._p_from_counts(count[plan.rank], n_permutations)


# ---------------------------------------------------------------------------
# Operands
# ---------------------------------------------------------------------------


def _discrete(shape, gen, dtype=torch.float32):
    """Standardized small counts: few distinct values, so products and
    lags coincide exactly and ties occur."""
    x = torch.poisson(torch.full(shape, 0.7), generator=gen)
    z = (x - x.mean(0)) / x.std(0).clamp_min(1e-3)
    return z.to(dtype)


def _synthetic(nb: int, G: int, k: int, per_row_max: int, seed: int, dtype):
    """A compact band (a fifth of the weights zero: dead slots) and a far
    list of 0..per_row_max entries a row (none with 0), in the wrapper's
    forms, a discrete table and observed values that tie with the first
    draw's |z·lag| on half of the rows."""
    gen = torch.Generator().manual_seed(seed)
    n = nb * B
    li = torch.randint(0, 3 * B, (n, k), generator=gen, dtype=torch.int16)
    w = torch.rand((n, k), generator=gen)
    w[torch.rand((n, k), generator=gen) < 0.2] = 0
    w = w.to(dtype)
    per_row = torch.randint(0, per_row_max + 1, (n,), generator=gen)
    ptr = torch.zeros(n + 1, dtype=torch.int32)
    ptr[1:] = torch.cumsum(per_row, 0).to(torch.int32)
    F = int(ptr[-1])
    far = dict(far_row_ptr=ptr,
               far_dst=torch.randint(0, n + 2 * B, (F,), generator=gen,
                                     dtype=torch.int32),
               far_w=torch.rand((F,), generator=gen))
    Zp = _discrete((n + 2 * B, G), gen, dtype)
    slots = kern_float.far_slots(**far)
    first = _old_lag(li, w, Zp, B, slots, 0, n)
    obs = (Zp[B:B + n].to(torch.float32) * first).abs()
    obs[1::2] = torch.rand((n // 2, G), generator=gen)
    obs[-3:] = float("inf")                 # padded rows never count
    return li, w, Zp, obs, far, slots


# ---------------------------------------------------------------------------
# The plain version against the frozen loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 3, 100, 130])
@pytest.mark.parametrize("per_row_max", [0, 3], ids=["no_far", "far"])
def test_draw_step_counts_equal_the_frozen_loop(dtype, G, per_row_max):
    li, w, Zp, obs, far, slots = _synthetic(3, G, 7, per_row_max, G, dtype)
    assert slots[0].shape[1] == per_row_max
    cnt0 = torch.randint(0, 50, obs.shape, generator=torch.Generator()
                         .manual_seed(1)).to(torch.int16)
    want = _old_step(li.to(torch.int64), w, Zp, B, slots, obs, cnt0.clone())
    before = dict(kern_float.LAUNCHES)
    got = kern_float.moran_count(li, w, Zp, B, obs, cnt0.clone(), **far)
    assert dict(kern_float.LAUNCHES) == before     # the CPU takes the plain version
    assert torch.equal(got, want)
    moved = (want - cnt0)[:-3]
    assert 0 < int(moved.sum()) < moved.numel()
    assert not bool((want - cnt0)[-3:].any())
    # every tie counts: the observed value is that draw's own |z·lag| on even rows
    assert bool((moved[0::2] == 1).all())


def test_int32_counters_and_a_second_draw():
    li, w, Zp, obs, far, slots = _synthetic(2, 12, 50, 2, 3, torch.float32)
    cnt = torch.zeros(obs.shape, dtype=torch.int32)
    want = cnt.clone()
    gen = torch.Generator().manual_seed(9)
    for _ in range(2):
        Zq = Zp[torch.randperm(Zp.shape[0], generator=gen)]
        _old_step(li.to(torch.int64), w, Zq, B, slots, obs, want)
        kern_float.moran_count(li, w, Zq, B, obs, cnt, **far)
    assert torch.equal(cnt, want) and int(cnt.max()) >= 1


def test_far_slots_keep_the_list_order():
    ptr = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    dst = torch.tensor([7, 3, 9, 1, 4], dtype=torch.int32)
    fw = torch.tensor([0.5, 0.25, 1.0, 2.0, 4.0])
    d, w = kern_float.far_slots(ptr, dst, fw)
    assert d.tolist() == [[7, 3, 0], [0, 0, 0], [9, 1, 4]]
    assert w.tolist() == [[0.5, 0.25, 0.0], [0.0, 0.0, 0.0], [1.0, 2.0, 4.0]]
    d4, _ = kern_float.far_slots(ptr, dst, fw, n_slots=4)
    assert d4.shape == (3, 4)


# ---------------------------------------------------------------------------
# The null through the draw step, on real plans
# ---------------------------------------------------------------------------


def _knn_plan(n: int, k: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    coords = torch.rand((n, 2), generator=gen) * 300
    return banded.build_null_plan(build_graph(coords, n_neighbors=k, device="cpu"),
                                  coords, block=B)


def _radius_plan(n: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    coords = torch.rand((n, 2), generator=gen) * 300
    graph = build_graph(coords, radius=9.0, k_max=24, device="cpu")
    return banded.build_null_plan(graph, coords, block=B)


def _obs_new(plan, G: int, seed: int):
    """|I| observed in the relabeled order, padded rows +inf."""
    gen = torch.Generator().manual_seed(seed)
    obs = (torch.rand((plan.n, G), generator=gen) * 0.5)
    return torch.nn.functional.pad(obs, (0, 0, 0, plan.n_padded - plan.n),
                                   value=float("inf"))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("which", ["knn", "radius"])
def test_null_p_equals_the_frozen_loop(precision, which):
    plan = _knn_plan(40 * B - 17, 6, 0) if which == "knn" else _radius_plan(2_000, 1)
    assert plan.n_padded > plan.n
    n_live = banded._n_live_far(plan)
    assert n_live > 0
    if which == "radius":
        assert float((plan.w_local == 0).float().mean()) > 0.3   # dead slots
    G = 5
    Z = _discrete((plan.n, G), torch.Generator().manual_seed(2))
    obs = _obs_new(plan, G, 3)
    want = _old_null_p(plan, Z, obs, 11, 9, precision)
    prof.reset()
    with prof.tracing():
        got = banded._banded_local_moran_p(plan, Z, obs, 11, n_permutations=9,
                                           precision=precision)
    assert torch.equal(got, want)
    names = [s["name"] for s in prof.spans()]
    assert names.count("kernels.lisa_float") == 9
    assert "ops.banded.local_lag" not in names


def test_public_float_null_equals_the_frozen_loop():
    """``banded_local_moran`` (f32) on a plan with far edges: p bitwise the
    frozen loop's, from the exact observed |I| it builds."""
    plan = _knn_plan(30 * B, 6, 4)
    gen = torch.Generator().manual_seed(5)
    coords = torch.rand((plan.n, 2), generator=gen) * 300
    graph = build_graph(coords, n_neighbors=6, device="cpu")
    plan = banded.build_null_plan(graph, coords, block=B)
    Z = _discrete((plan.n, 4), gen)
    res = banded.banded_local_moran(plan, graph, Z, 7, 9, precision="f32")
    obs = res.local_I.abs()[plan.order]
    obs = torch.nn.functional.pad(obs, (0, 0, 0, plan.n_padded - plan.n),
                                  value=float("inf"))
    assert torch.equal(res.p_value, _old_null_p(plan, Z, obs, 7, 9, "f32"))


# ---------------------------------------------------------------------------
# The wrapper's checks and the launch shape
# ---------------------------------------------------------------------------


def test_wrapper_refuses_what_the_kernel_does_not_take():
    li, w, Zp, obs, far, _ = _synthetic(2, 8, 4, 2, 0, torch.float32)
    cnt = torch.zeros(obs.shape, dtype=torch.int16)

    def call(**kw):
        args = dict(local_idx=li, w=w, Zp=Zp, block=B, obs=obs, cnt=cnt, **far)
        args.update(kw)
        return kern_float.moran_count(**args)

    call()
    bad = [dict(local_idx=li.to(torch.int32)),
           dict(w=w.to(torch.bfloat16)),
           dict(Zp=Zp.to(torch.float64), w=w.to(torch.float64)),
           dict(Zp=Zp[:-1]),
           dict(obs=obs.to(torch.float64)),
           dict(cnt=cnt.to(torch.int8)),
           dict(cnt=cnt[:, :4]),
           dict(far_row_ptr=far["far_row_ptr"][:-1]),
           dict(far_dst=far["far_dst"].to(torch.int64)),
           dict(far_w=far["far_w"][:-1]),
           dict(obs=obs.t().contiguous().t()),
           dict(block=48)]
    for kw in bad:
        with pytest.raises(ValueError):
            call(**kw)


@pytest.mark.parametrize("esz", [2, 4])
@pytest.mark.parametrize("block,k", [(64, 6), (256, 6), (256, 50), (512, 50),
                                     (256, 1000)])
def test_launch_shape_fits_shared_memory(esz, block, k):
    for G in (1, 3, 100, 130, 1024):
        t = kern_float.lisa_float_tiles(block, k, esz, G, 100)
        shapes = [t[0:3], t[3:6]]
        for tile, chunk, cap in shapes:
            rb = tile * esz
            assert rb & (rb - 1) == 0 and 16 <= rb <= 128
            assert 4 * block * rb <= 128 << 10
            assert 1 <= chunk <= min(block, kern_float._THREADS // (rb // 16))
            assert cap >= 0
        assert t.tail <= t.tile and G % t.tile <= t.tail
        assert t.smem == max(kern_float.lisa_float_smem_bytes(block, k, esz, *sh)
                             for sh in shapes) <= kern.SMEM_LIMIT
    # cell 2's shape: 32 float32 genes (a 128-byte row segment) a CTA, a row a
    # thread with room for ~7 far entries a row, the last 4 genes in a tile
    # of their own
    t = kern_float.lisa_float_tiles(256, 50, 4, 100, 1436)
    assert t[:2] == (32, 64) and t.far_cap >= 4 * 64 and t[3:5] == (4, 256)


def test_launch_counts_live_in_the_registry():
    kern_float.LAUNCHES["moran_f32"] += 3
    assert prof.counters()["kernels.lisa_float.moran_f32"] == 3
    kern_float.reset_launch_counts()
    assert not any(kern_float.LAUNCHES.values())
    with pytest.raises(KeyError):
        kern_float.LAUNCHES["moran_f16"] += 1
