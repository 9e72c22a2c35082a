"""Wrappers of the local Moran (LISA) draw-step kernel, and its plain version.

One CUDA source, ``csrc/lisa_count_int8.cu``, replaces the Pallas kernels
K7 (``_make_fused_win_kernel``, ``stat="moran"`` tail) and K8
(``_band_lag_count_kernel_i8``) of ``spatialcore_tpu/ops/banded.py``, and
the reference's XLA observed pass. Per padded row i and gene g, over int8
codes:

    lag_i[g] = Σ_slots wq·z[window + local_idx][g] + far_i[g]   (exact int32)
    val_i[g] = |z_i[g] · lag_i[g]|

:func:`lisa_count` (draw step)
    ``cnt += (val >= obs)``, in place, int8 / int16 / int32 counters.
:func:`lisa_observed`
    returns ``val`` as int32 [Npad, G] (the observed statistic when ``Zp``
    holds the identity placement).

Both take the compact band — ``local_idx`` int32 [Npad, k] (window-relative
rows in [0, 3B)) and ``wq`` int8 [Npad, k] weight codes — and ``Zp`` int8
[(nb+2)·B, G], the draw's gathered codes (block n's window is rows
[n·B, n·B + 3B), its own rows [n·B + B, n·B + 2B)). The far term comes in
one of three forms:

* row pointers (K7's function): ``far_row_ptr`` int32 [Npad+1] into the
  compact far list, ``far_q`` int8 [F] weight codes, ``Zf`` int8 [F, G] the
  gathered far values; row r's entries are ``[ptr[r], ptr[r+1])``;
* a dense int32 far layer ``far`` [Npad, G] (K8's function);
* none (a plan without far edges).

Each wrapper checks device, dtype, shape, contiguity and alignment, then:

* on a CPU tensor, runs the plain version (bitwise the kernel's result:
  all arithmetic is exact integer arithmetic);
* on a CUDA tensor, launches the kernel on the current stream and adds one
  to its entry in :data:`LAUNCHES` — or raises. There is no fallback.

Preconditions the wrappers do not check (a device readback per launch):
``local_idx`` values lie in [0, 3B), ``far_row_ptr`` is non-decreasing with
``far_row_ptr[-1]`` ≤ F, and k ≤ 1000 so that |z·lag| ≤ k·127³ < 2³¹.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build
from .band_cross import MAX_BLOCK, band_lag_int8_plain

#: kernel launches by far form (draw step) and of the observed entry
LAUNCHES = {"lisa_win": 0, "lisa_dense": 0, "lisa_band": 0, "lisa_obs": 0}

#: far forms as the C entry points number them
_FAR_NONE, _FAR_ROWS, _FAR_DENSE = 0, 1, 2
_COUNTER_DTYPES = (torch.int8, torch.int16, torch.int32)

#: elements of one [rows, G] temp in the plain version's row chunks
_PLAIN_CHUNK_ELEMS = 1 << 26


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def counter_dtype(n_permutations: int) -> torch.dtype:
    """Narrowest counter that holds P draws: int8 ≤ 127, int16 ≤ 32767."""
    return (torch.int8 if n_permutations <= 127
            else torch.int16 if n_permutations <= 32767 else torch.int32)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _row_chunks(n_rows: int, block: int, G: int):
    step = max(block, (_PLAIN_CHUNK_ELEMS // max(G, 1)) // block * block)
    return [(r0, min(r0 + step, n_rows)) for r0 in range(0, n_rows, step)]


def _abs_ip_plain(local_idx, wq, Zp, block: int, far_row_ptr, far_q, Zf, far,
                  r0: int, r1: int) -> torch.Tensor:
    """|z·lag| of padded rows [r0, r1) as int32.

    The float32 lag of :func:`band_lag_int8_plain` is exact (|lag| ≤ k·127²
    < 2²⁴ for k < 1040), so its int32 cast is the kernel's lag; the product
    is taken in int32 (|z·lag| ≤ k·127³ exceeds float32's 2²⁴ at k > 8).
    """
    lag = band_lag_int8_plain(local_idx, wq, Zp, block, packed=False,
                              far_row_ptr=far_row_ptr, far_q=far_q, Zf=Zf,
                              r0=r0, r1=r1).to(torch.int32)
    if far is not None:
        lag += far[r0:r1]
    z1 = Zp[block + r0:block + r1].to(torch.int32)
    return (z1 * lag).abs_()


def lisa_count_plain(local_idx, wq, Zp, block: int, obs, cnt, *,
                     far_row_ptr=None, far_q=None, Zf=None, far=None
                     ) -> torch.Tensor:
    """Plain version of :func:`lisa_count`: updates ``cnt`` in place."""
    for r0, r1 in _row_chunks(local_idx.shape[0], block, Zp.shape[1]):
        val = _abs_ip_plain(local_idx, wq, Zp, block, far_row_ptr, far_q, Zf,
                            far, r0, r1)
        cnt[r0:r1] += (val >= obs[r0:r1]).to(cnt.dtype)
    return cnt


def lisa_observed_plain(local_idx, wq, Zp, block: int, *, far_row_ptr=None,
                        far_q=None, Zf=None, far=None) -> torch.Tensor:
    """Plain version of :func:`lisa_observed`."""
    n_rows, G = local_idx.shape[0], Zp.shape[1]
    out = torch.empty((n_rows, G), dtype=torch.int32, device=Zp.device)
    for r0, r1 in _row_chunks(n_rows, block, G):
        out[r0:r1] = _abs_ip_plain(local_idx, wq, Zp, block, far_row_ptr,
                                   far_q, Zf, far, r0, r1)
    return out


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _plane(t, name: str, dtypes, shape, align: int, dev) -> None:
    _check(t.dtype in dtypes and tuple(t.shape) == tuple(shape),
           f"{name} must be {dtypes} {list(shape)}")
    _check(t.device == dev and t.is_contiguous(),
           f"{name} must be contiguous on Zp's device")
    _check(t.data_ptr() % align == 0, f"{name} must be {align}-byte aligned")


def _check_operands(local_idx, wq, Zp, block: int, far_row_ptr, far_q, Zf,
                    far) -> int:
    """Validate the common operands; returns the far form."""
    _check(local_idx.dtype == torch.int32 and local_idx.ndim == 2,
           "local_idx must be int32 [Npad, k]")
    n_rows, k = local_idx.shape
    _check(k >= 1, "the band needs at least one slot")
    _check(1 <= block <= MAX_BLOCK and n_rows % block == 0,
           f"block must be in [1, {MAX_BLOCK}] and divide Npad={n_rows}")
    dev = Zp.device
    _check(dev.type in ("cpu", "cuda"), f"unsupported device {dev}")
    _check(Zp.dtype == torch.int8 and Zp.ndim == 2
           and Zp.shape[0] == n_rows + 2 * block,
           "Zp must be int8 [(nb+2)·B, G]")
    G = Zp.shape[1]
    _check(G % 4 == 0, "G must be a multiple of 4 (the kernel reads 4 genes "
                       "per thread)")
    _plane(Zp, "Zp", (torch.int8,), (n_rows + 2 * block, G), 4, dev)
    _plane(local_idx, "local_idx", (torch.int32,), (n_rows, k), 4, dev)
    _plane(wq, "wq", (torch.int8,), (n_rows, k), 1, dev)
    if far_row_ptr is not None:
        _check(far is None, "give the far term as row pointers or as a "
                            "dense layer, not both")
        _plane(far_row_ptr, "far_row_ptr", (torch.int32,), (n_rows + 1,), 4, dev)
        _check(far_q is not None and Zf is not None,
               "row-pointer far edges need far_q and Zf")
        _check(far_q.ndim == 1, "far_q must be int8 [F]")
        _plane(far_q, "far_q", (torch.int8,), far_q.shape, 1, dev)
        _plane(Zf, "Zf", (torch.int8,), (far_q.shape[0], G), 4, dev)
        return _FAR_ROWS
    _check(far_q is None and Zf is None, "far_q and Zf need far_row_ptr")
    if far is not None:
        _plane(far, "far", (torch.int32,), (n_rows, G), 16, dev)
        return _FAR_DENSE
    return _FAR_NONE


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


_MODE = {_FAR_ROWS: "lisa_win", _FAR_DENSE: "lisa_dense", _FAR_NONE: "lisa_band"}


def lisa_count(local_idx, wq, Zp, block: int, obs, cnt, *, far_row_ptr=None,
               far_q=None, Zf=None, far=None) -> torch.Tensor:
    """One draw's counter update, in place: ``cnt += (|z·lag| ≥ obs)``.

    ``obs`` int32 [Npad, G]; ``cnt`` int8, int16 or int32 [Npad, G]. Other
    operands as the module docstring says. Returns ``cnt``.
    """
    form = _check_operands(local_idx, wq, Zp, block, far_row_ptr, far_q, Zf, far)
    n_rows, k = local_idx.shape
    G = Zp.shape[1]
    _plane(obs, "obs", (torch.int32,), (n_rows, G), 16, Zp.device)
    _plane(cnt, "cnt", _COUNTER_DTYPES, (n_rows, G), 4 * cnt.element_size(),
           Zp.device)
    if Zp.device.type == "cpu":
        return lisa_count_plain(local_idx, wq, Zp, block, obs, cnt,
                                far_row_ptr=far_row_ptr, far_q=far_q, Zf=Zf,
                                far=far)
    lib = build.load_library()
    with torch.cuda.device(Zp.device):
        err = lib.sct_lisa_count(
            _ptr(local_idx), _ptr(wq), _ptr(Zp), _ptr(far_row_ptr), _ptr(far_q),
            _ptr(Zf), _ptr(far), _ptr(obs), _ptr(cnt), n_rows // block, block,
            k, G, form, cnt.element_size(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"lisa_count launch failed: CUDA error {err}")
    LAUNCHES[_MODE[form]] += 1
    return cnt


def lisa_observed(local_idx, wq, Zp, block: int, *, far_row_ptr=None,
                  far_q=None, Zf=None, far=None) -> torch.Tensor:
    """|z·lag| as int32 [Npad, G] at the placement gathered into ``Zp``."""
    form = _check_operands(local_idx, wq, Zp, block, far_row_ptr, far_q, Zf, far)
    if Zp.device.type == "cpu":
        return lisa_observed_plain(local_idx, wq, Zp, block,
                                   far_row_ptr=far_row_ptr, far_q=far_q, Zf=Zf,
                                   far=far)
    n_rows, k = local_idx.shape
    G = Zp.shape[1]
    lib = build.load_library()
    with torch.cuda.device(Zp.device):
        out = torch.empty((n_rows, G), dtype=torch.int32, device=Zp.device)
        err = lib.sct_lisa_observed(
            _ptr(local_idx), _ptr(wq), _ptr(Zp), _ptr(far_row_ptr), _ptr(far_q),
            _ptr(Zf), _ptr(far), _ptr(out), n_rows // block, block, k, G, form,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"lisa_observed launch failed: CUDA error {err}")
    LAUNCHES["lisa_obs"] += 1
    return out
