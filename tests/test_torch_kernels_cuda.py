"""Each hand-written kernel against its plain version, on a CUDA device.

The kernels have no CPU mode, so these tests skip without a card. This
file imports only torch and the port (no JAX), so it runs on a GPU machine
without the JAX package's test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerance: |Δcross_g| ≤ 1e-5 · Σ_i |term_i| — float32 summation order only;
the integer lags are exact in both versions.
"""

import pytest
import torch

from spatialcore_tpu_torch.kernels import band_cross as kern
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
