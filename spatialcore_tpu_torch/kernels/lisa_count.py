"""Wrappers of the local statistics' draw-step kernel, and its plain version.

One CUDA source, ``csrc/lisa_count_int8.cu``, replaces the Pallas kernels
K7 (``_make_fused_win_kernel``: its ``moran``, ``geary``, ``lee``,
``getis_star`` and ``getis_g`` tails) and K8 (``_band_lag_count_kernel_i8``) of
``spatialcore_tpu/ops/banded.py``, and the reference's XLA observed
passes. Per padded row i and gene g, over int8 codes:

    lag_i[g]  = Σ_slots wq·z[window + local_idx][g] + far_i[g]   (exact int32)
    lag2_i[g] = the same sum over z²                              (geary)

and per statistic:

=============  ==========================================  ==================
statistic      draw step: ``cnt += extreme``               observed entry
=============  ==========================================  ==================
local Moran    ``|z·lag| ≥ obs``                           ``|z·lag|``
local Geary    ``z²·W + lag2 − 2·z·lag ≤ obs`` (W: the     the geary value
               row's total weight code)
Gi*            A = lag + z: ``A ≥ A_o`` / ``A ≤ A_o`` /    the binary lag
               ``f32(A−A_o)·(f32(A+A_o) − 2·c2) ≥ 0``
Gi             leave-one-out centred cp (f32) against      the binary lag
               cp_o, or an exact (lag, z) tie
Lee's L        Lq = x·lag: ``|Lq| ≥ obs``, and the         ``|Lq|`` and the
               block partials of the global L              partials
=============  ==========================================  ==================

Lee's x is the row's FIXED code of the pair's first gene (``zx``, an int8
plane in the relabeled order: Lee's null permutes y only), never the
gathered table's own row. Every Lee entry — the draw step, the observed
entry and a partial-only entry for the global-only null — also writes the
per-block partials ``part[n, g] = Σ_rows sw_row·f32(Lq)`` of the global L in
one fixed order (:func:`lee_block_partial`): row group q of the kernel's 16
(rows q, q + 16, …) sums its rows in row order, then the 16 group sums are
added in group order; each product and sum is rounded once (``__fmul_rn``,
``__fadd_rn``), so the partials are bitwise the plain version's.

with c2 = f32(tot/m)·(W+1) (Gi*, two-sided) and, for Gi,

    xbar = (tot − z)·f32(1/m),  s² = max((sq − z²)·f32(1/m) − xbar², 0)
    cp   = (lag − xbar·W) / sqrt(s² > 0 ? s² : 1)

every f32 operation rounded once, in this order, in both versions (the
kernel writes them as ``__f*_rn`` intrinsics, so nvcc contracts nothing
into an FMA). The divisions by the constant m are multiplications by its
float32 reciprocal, as XLA compiles the reference's ``x / m``.

All take the compact band — ``local_idx`` int32 [Npad, k] (window-relative
rows in [0, 3B)) and ``wq`` int8 [Npad, k] weight codes (0/1 for Getis) —
and ``Zp`` int8 [(nb+2)·B, G], the draw's gathered codes (block n's window
is rows [n·B, n·B + 3B), its own rows [n·B + B, n·B + 2B)). The far term
comes in one of three forms:

* row pointers (K7's function): ``far_row_ptr`` int32 [Npad+1] into the
  compact far list, ``far_q`` int8 [F] weight codes, ``Zf`` int8 [F, G] the
  gathered far values; row r's entries are ``[ptr[r], ptr[r+1])``. Geary
  and Getis always take this form (an empty list when a plan has none);
* a dense int32 far layer ``far`` [Npad, G] (K8's function; Moran only);
* none (Moran, a plan without far edges).

Each wrapper checks device, dtype, shape, contiguity and alignment, then:

* on a CPU tensor, runs the plain version (bitwise the kernel's result:
  integer arithmetic, and the f32 tails round at the same places);
* on a CUDA tensor, launches the kernel on the current stream and adds one
  to its entry in :data:`LAUNCHES` — or raises. There is no fallback.

Preconditions the wrappers do not check (a device readback per launch):
``local_idx`` values lie in [0, 3B), ``far_row_ptr`` is non-decreasing with
``far_row_ptr[-1]`` ≤ F, and k ≤ 1000 (Moran: |z·lag| ≤ k·127³ < 2³¹;
Lee: checked) or k ≤ 256 (Geary: Σ w·(Δz)² ≤ k·127·254² < 2³¹; checked).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import build
from .band_cross import MAX_BLOCK, band_lag_int8_plain

#: kernel launches: LISA's draw step by far form and its observed entry;
#: the geary, getis_star and getis_g draw steps; geary's and Getis's
#: observed entries; Lee's draw step, observed and partial-only entries
LAUNCHES = {"lisa_win": 0, "lisa_dense": 0, "lisa_band": 0, "lisa_obs": 0,
            "geary_win": 0, "geary_obs": 0, "getis_star_win": 0,
            "getis_g_win": 0, "getis_obs": 0, "lee_win": 0, "lee_obs": 0,
            "lee_partial": 0}

#: far forms as the C entry points number them
_FAR_NONE, _FAR_ROWS, _FAR_DENSE = 0, 1, 2
#: statistics and alternatives as sct_local_count numbers them
_GEARY, _GETIS_STAR, _GETIS_G = 1, 2, 3
_ALTS = {"two-sided": 0, "greater": 1, "less": 2}
#: the int8 local-Geary null's exactness bound: Σ w·(Δz)² ≤ k·127·254² < 2³¹
GEARY_MAX_K = 256
#: the int8 Lee null's exactness bound: |x·lag| ≤ k·127³ < 2³¹
LEE_MAX_K = 1000
#: the kernel's row groups: 256 threads, 16 across a row
ROW_GROUPS = 16
#: Lee's entries as sct_lee numbers them
_LEE_COUNT, _LEE_OBSERVED, _LEE_PARTIAL = 0, 1, 2
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


def _int_lag_plain(local_idx, wq, Zp, block: int, far_row_ptr, far_q, Zf,
                   r0: int, r1: int, square: bool = False) -> torch.Tensor:
    """int32 lag of padded rows [r0, r1) over the codes (``square``: over
    the squared codes, whose lag passes float32's 2²⁴ at k ≥ 9, so every
    term and sum here is int32). Far entries add into their rows."""
    def vals(t):
        t = t.to(torch.int32)
        return t * t if square else t

    dev = Zp.device
    rows = torch.arange(r0, r1, device=dev)
    win0 = (rows // block) * block                   # window start: n·B
    li = local_idx[r0:r1].to(torch.int64)
    w = wq[r0:r1].to(torch.int32)
    lag = torch.zeros((r1 - r0, Zp.shape[1]), dtype=torch.int32, device=dev)
    for s in range(li.shape[1]):
        lag += w[:, s:s + 1] * vals(Zp[win0 + li[:, s]])
    ptr = far_row_ptr.to(torch.int64)
    p0, p1 = int(ptr[r0]), int(ptr[r1])
    dst = torch.repeat_interleave(torch.arange(r1 - r0, device=dev),
                                  ptr[r0 + 1:r1 + 1] - ptr[r0:r1])
    return lag.index_add_(0, dst, far_q[p0:p1].to(torch.int32)[:, None]
                          * vals(Zf[p0:p1]))


def _geary_plain(local_idx, wq, Zp, block: int, w_row, far_row_ptr, far_q, Zf,
                 r0: int, r1: int) -> torch.Tensor:
    """Geary value z²·W + lag(z²) − 2·z·lag of rows [r0, r1), exact int32."""
    lag = _int_lag_plain(local_idx, wq, Zp, block, far_row_ptr, far_q, Zf, r0, r1)
    lag2 = _int_lag_plain(local_idx, wq, Zp, block, far_row_ptr, far_q, Zf,
                          r0, r1, square=True)
    z = Zp[block + r0:block + r1].to(torch.int32)
    return z * z * w_row[r0:r1, None] + lag2 - 2 * z * lag


def geary_count_plain(local_idx, wq, Zp, block: int, obs, cnt, w_row, *,
                      far_row_ptr, far_q, Zf) -> torch.Tensor:
    """Plain version of :func:`geary_count`: updates ``cnt`` in place."""
    for r0, r1 in _row_chunks(local_idx.shape[0], block, Zp.shape[1]):
        val = _geary_plain(local_idx, wq, Zp, block, w_row, far_row_ptr, far_q,
                           Zf, r0, r1)
        cnt[r0:r1] += (val <= obs[r0:r1]).to(cnt.dtype)
    return cnt


def geary_observed_plain(local_idx, wq, Zp, block: int, w_row, *, far_row_ptr,
                         far_q, Zf) -> torch.Tensor:
    """Plain version of :func:`geary_observed`."""
    n_rows, G = local_idx.shape[0], Zp.shape[1]
    out = torch.empty((n_rows, G), dtype=torch.int32, device=Zp.device)
    for r0, r1 in _row_chunks(n_rows, block, G):
        out[r0:r1] = _geary_plain(local_idx, wq, Zp, block, w_row, far_row_ptr,
                                  far_q, Zf, r0, r1)
    return out


def getis_lag_plain(local_idx, wb, Zp, block: int, *, far_row_ptr, far_q, Zf
                    ) -> torch.Tensor:
    """Plain version of :func:`getis_lag`."""
    n_rows, G = local_idx.shape[0], Zp.shape[1]
    out = torch.empty((n_rows, G), dtype=torch.int32, device=Zp.device)
    for r0, r1 in _row_chunks(n_rows, block, G):
        out[r0:r1] = _int_lag_plain(local_idx, wb, Zp, block, far_row_ptr,
                                    far_q, Zf, r0, r1)
    return out


def _alt_test(v, o, alternative: str):
    if alternative == "greater":
        return v >= o
    if alternative == "less":
        return v <= o
    return v.abs() >= o.abs()


def _gi_rows(lag, z, w_row, tot, sq, inv_m: float) -> torch.Tensor:
    """Gi's centred lag cp of one row chunk (float32, the kernel's order)."""
    zf = z.to(torch.float32)
    xbar = (tot - zf) * inv_m
    s2 = torch.clamp_min((sq - zf * zf) * inv_m - xbar * xbar, 0.0)
    s = torch.sqrt(torch.where(s2 > 0, s2, torch.ones_like(s2)))
    return (lag.to(torch.float32) - xbar * w_row[:, None]) / s


def gi_center(lag, me, w_row, tot, sq, inv_m: float) -> torch.Tensor:
    """Gi's leave-one-out centred lag cp [Npad, G] float32 from the binary
    lag (int32) and own codes (int8), in row chunks; the same expression
    the Gi draw step evaluates (module docstring)."""
    n_rows, G = lag.shape
    out = torch.empty((n_rows, G), dtype=torch.float32, device=lag.device)
    for r0, r1 in _row_chunks(n_rows, 1, G):
        out[r0:r1] = _gi_rows(lag[r0:r1], me[r0:r1], w_row[r0:r1], tot, sq,
                              inv_m)
    return out


def getis_star_count_plain(local_idx, wb, Zp, block: int, obs, cnt, *,
                           alternative: str, far_row_ptr, far_q, Zf, wp1=None,
                           tm=None) -> torch.Tensor:
    """Plain version of :func:`getis_star_count`: updates ``cnt`` in place."""
    for r0, r1 in _row_chunks(local_idx.shape[0], block, Zp.shape[1]):
        A = (_int_lag_plain(local_idx, wb, Zp, block, far_row_ptr, far_q, Zf,
                            r0, r1) + Zp[block + r0:block + r1].to(torch.int32))
        o = obs[r0:r1]
        if alternative == "greater":
            ext = A >= o
        elif alternative == "less":
            ext = A <= o
        else:
            c2 = tm * wp1[r0:r1, None]
            x = (A + o).to(torch.float32) - 2.0 * c2
            ext = (A - o).to(torch.float32) * x >= 0.0
        cnt[r0:r1] += ext.to(cnt.dtype)
    return cnt


def getis_g_count_plain(local_idx, wb, Zp, block: int, obs, cnt, *,
                        alternative: str, far_row_ptr, far_q, Zf, w_row, tot,
                        sq, inv_m: float, lag_o, me_o) -> torch.Tensor:
    """Plain version of :func:`getis_g_count`: updates ``cnt`` in place."""
    for r0, r1 in _row_chunks(local_idx.shape[0], block, Zp.shape[1]):
        lag = _int_lag_plain(local_idx, wb, Zp, block, far_row_ptr, far_q, Zf,
                             r0, r1)
        z = Zp[block + r0:block + r1]
        cp = _gi_rows(lag, z, w_row[r0:r1], tot, sq, inv_m)
        ext = (_alt_test(cp, obs[r0:r1], alternative)
               | ((lag == lag_o[r0:r1]) & (z == me_o[r0:r1])))
        cnt[r0:r1] += ext.to(cnt.dtype)
    return cnt


def lee_block_partial(Lq: torch.Tensor, sw_row: torch.Tensor, block: int
                      ) -> torch.Tensor:
    """Per-block partials [nb, G] (float32) of Σ_rows sw·f32(Lq) over whole
    blocks of rows, in the kernel's order: row group q (rows q, q + 16, …
    of the block) sums its products in row order from 0, then the 16 group
    sums are added in group order from 0. A block whose size is not a
    multiple of 16 is padded with +0 products, which change no sum."""
    rows, G = Lq.shape
    nb = rows // block
    prod = (sw_row[:, None] * Lq.to(torch.float32)).reshape(nb, block, G)
    grp = -(-block // ROW_GROUPS) * ROW_GROUPS
    if grp != block:
        prod = torch.nn.functional.pad(prod, (0, 0, 0, grp - block))
    prod = prod.reshape(nb, grp // ROW_GROUPS, ROW_GROUPS, G)
    acc = torch.zeros((nb, ROW_GROUPS, G), dtype=torch.float32, device=Lq.device)
    for j in range(grp // ROW_GROUPS):
        acc = acc + prod[:, j]
    part = torch.zeros((nb, G), dtype=torch.float32, device=Lq.device)
    for q in range(ROW_GROUPS):
        part = part + acc[:, q]
    return part


def _lee_plain(local_idx, wq, Zp, block: int, zx, sw_row, obs, cnt, out, *,
               far_row_ptr, far_q, Zf) -> torch.Tensor:
    """Lee's plain version, in row chunks of whole blocks: counts into
    ``cnt`` (draw step), |Lq| into ``out`` (observed), and the partials."""
    n_rows, G = local_idx.shape[0], Zp.shape[1]
    part = torch.empty((n_rows // block, G), dtype=torch.float32,
                       device=Zp.device)
    for r0, r1 in _row_chunks(n_rows, block, G):
        Lq = zx[r0:r1].to(torch.int32) * _int_lag_plain(
            local_idx, wq, Zp, block, far_row_ptr, far_q, Zf, r0, r1)
        part[r0 // block:r1 // block] = lee_block_partial(Lq, sw_row[r0:r1],
                                                          block)
        if cnt is not None:
            cnt[r0:r1] += (Lq.abs() >= obs[r0:r1]).to(cnt.dtype)
        if out is not None:
            out[r0:r1] = Lq.abs()
    return part


def lee_count_plain(local_idx, wq, Zp, block: int, zx, sw_row, obs, cnt, *,
                    far_row_ptr, far_q, Zf) -> torch.Tensor:
    """Plain version of :func:`lee_count`: updates ``cnt`` in place and
    returns the partials."""
    return _lee_plain(local_idx, wq, Zp, block, zx, sw_row, obs, cnt, None,
                      far_row_ptr=far_row_ptr, far_q=far_q, Zf=Zf)


def lee_observed_plain(local_idx, wq, Zp, block: int, zx, sw_row, *,
                       far_row_ptr, far_q, Zf):
    """Plain version of :func:`lee_observed`."""
    out = torch.empty((local_idx.shape[0], Zp.shape[1]), dtype=torch.int32,
                      device=Zp.device)
    part = _lee_plain(local_idx, wq, Zp, block, zx, sw_row, None, None, out,
                      far_row_ptr=far_row_ptr, far_q=far_q, Zf=Zf)
    return out, part


def lee_partial_plain(local_idx, wq, Zp, block: int, zx, sw_row, *,
                      far_row_ptr, far_q, Zf) -> torch.Tensor:
    """Plain version of :func:`lee_partial`."""
    return _lee_plain(local_idx, wq, Zp, block, zx, sw_row, None, None, None,
                      far_row_ptr=far_row_ptr, far_q=far_q, Zf=Zf)


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


def _check_rows_far(local_idx, wq, Zp, block: int, far_row_ptr, far_q, Zf):
    """Common checks of the geary / Getis entries: far edges as row
    pointers, possibly an empty list."""
    _check(far_row_ptr is not None, "geary, Getis and Lee take the far edges "
                                    "as row pointers (far_row_ptr, far_q, Zf)")
    _check_operands(local_idx, wq, Zp, block, far_row_ptr, far_q, Zf, None)
    return local_idx.shape[0], local_idx.shape[1], Zp.shape[1]


def _launch_count(stat: int, alternative: str, mode: str, local_idx, wq, Zp,
                  block: int, obs, cnt, far_row_ptr, far_q, Zf, row_i=None,
                  row_f=None, col_a=None, col_b=None, lag_o=None, me_o=None,
                  inv_m: float = 0.0):
    n_rows, k = local_idx.shape
    lib = build.load_library()
    with torch.cuda.device(Zp.device):
        err = lib.sct_local_count(
            stat, _ALTS[alternative], _ptr(local_idx), _ptr(wq), _ptr(Zp),
            _ptr(far_row_ptr), _ptr(far_q), _ptr(Zf), _ptr(obs), _ptr(cnt),
            _ptr(row_i), _ptr(row_f), _ptr(col_a), _ptr(col_b), _ptr(lag_o),
            _ptr(me_o), inv_m, n_rows // block, block, k, Zp.shape[1],
            cnt.element_size(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{mode} launch failed: CUDA error {err}")
    LAUNCHES[mode] += 1
    return cnt


def _launch_observed(stat: int, mode: str, local_idx, wq, Zp, block: int,
                     far_row_ptr, far_q, Zf, row_i=None) -> torch.Tensor:
    n_rows, k = local_idx.shape
    G = Zp.shape[1]
    lib = build.load_library()
    with torch.cuda.device(Zp.device):
        out = torch.empty((n_rows, G), dtype=torch.int32, device=Zp.device)
        err = lib.sct_local_observed(
            stat, _ptr(local_idx), _ptr(wq), _ptr(Zp), _ptr(far_row_ptr),
            _ptr(far_q), _ptr(Zf), _ptr(row_i), _ptr(out), n_rows // block,
            block, k, G, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{mode} launch failed: CUDA error {err}")
    LAUNCHES[mode] += 1
    return out


def _check_geary(local_idx, wq, Zp, block, w_row, far_row_ptr, far_q, Zf):
    n_rows, k, _ = _check_rows_far(local_idx, wq, Zp, block, far_row_ptr,
                                   far_q, Zf)
    _check(k <= GEARY_MAX_K, f"the int8 geary value is exact int32 for k <= "
                             f"{GEARY_MAX_K} (k*127*254^2 < 2^31), got k={k}")
    _plane(w_row, "w_row", (torch.int32,), (n_rows,), 4, Zp.device)


def geary_count(local_idx, wq, Zp, block: int, obs, cnt, w_row, *, far_row_ptr,
                far_q, Zf) -> torch.Tensor:
    """One local-Geary draw's counter update, in place:
    ``cnt += (z²·W + lag(z²) − 2·z·lag ≤ obs)``, exact int32.

    ``w_row`` int32 [Npad]: each row's total weight code (band + far);
    ``obs`` int32 [Npad, G]; ``cnt`` int8 / int16 / int32 [Npad, G]. Far
    edges as row pointers (module docstring). Returns ``cnt``.
    """
    _check_geary(local_idx, wq, Zp, block, w_row, far_row_ptr, far_q, Zf)
    n_rows, G = local_idx.shape[0], Zp.shape[1]
    _plane(obs, "obs", (torch.int32,), (n_rows, G), 16, Zp.device)
    _plane(cnt, "cnt", _COUNTER_DTYPES, (n_rows, G), 4 * cnt.element_size(),
           Zp.device)
    if Zp.device.type == "cpu":
        return geary_count_plain(local_idx, wq, Zp, block, obs, cnt, w_row,
                                 far_row_ptr=far_row_ptr, far_q=far_q, Zf=Zf)
    return _launch_count(_GEARY, "two-sided", "geary_win", local_idx, wq, Zp,
                         block, obs, cnt, far_row_ptr, far_q, Zf, row_i=w_row)


def geary_observed(local_idx, wq, Zp, block: int, w_row, *, far_row_ptr, far_q,
                   Zf) -> torch.Tensor:
    """The int32 geary value [Npad, G] at the placement gathered into ``Zp``."""
    _check_geary(local_idx, wq, Zp, block, w_row, far_row_ptr, far_q, Zf)
    if Zp.device.type == "cpu":
        return geary_observed_plain(local_idx, wq, Zp, block, w_row,
                                    far_row_ptr=far_row_ptr, far_q=far_q, Zf=Zf)
    return _launch_observed(_GEARY, "geary_obs", local_idx, wq, Zp, block,
                            far_row_ptr, far_q, Zf, row_i=w_row)


def getis_lag(local_idx, wb, Zp, block: int, *, far_row_ptr, far_q, Zf
              ) -> torch.Tensor:
    """The binary lag int32 [Npad, G] at the placement gathered into ``Zp``
    (Getis's observed entry; ``wb`` holds 0/1 codes)."""
    _check_rows_far(local_idx, wb, Zp, block, far_row_ptr, far_q, Zf)
    if Zp.device.type == "cpu":
        return getis_lag_plain(local_idx, wb, Zp, block,
                               far_row_ptr=far_row_ptr, far_q=far_q, Zf=Zf)
    return _launch_observed(_GETIS_STAR, "getis_obs", local_idx, wb, Zp, block,
                            far_row_ptr, far_q, Zf)


def getis_star_count(local_idx, wb, Zp, block: int, obs, cnt, *,
                     alternative: str, far_row_ptr, far_q, Zf, wp1=None,
                     tm=None) -> torch.Tensor:
    """One Gi* draw's counter update, in place, with A = lag + z against
    ``obs`` = A_o (int32 [Npad, G]): ``A ≥ A_o`` ("greater"), ``A ≤ A_o``
    ("less"), or the two-sided sign test with c2 = ``tm[g]·wp1[r]``
    (``tm`` f32 [G] = f32(tot/m), ``wp1`` f32 [Npad] = W + 1). Returns
    ``cnt``."""
    _check(alternative in _ALTS, f"invalid alternative {alternative!r}")
    n_rows, _, G = _check_rows_far(local_idx, wb, Zp, block, far_row_ptr,
                                   far_q, Zf)
    _plane(obs, "obs", (torch.int32,), (n_rows, G), 16, Zp.device)
    _plane(cnt, "cnt", _COUNTER_DTYPES, (n_rows, G), 4 * cnt.element_size(),
           Zp.device)
    if alternative == "two-sided":
        _check(wp1 is not None and tm is not None,
               "the two-sided Gi* test needs wp1 and tm")
        _plane(wp1, "wp1", (torch.float32,), (n_rows,), 4, Zp.device)
        _plane(tm, "tm", (torch.float32,), (G,), 16, Zp.device)
    if Zp.device.type == "cpu":
        return getis_star_count_plain(local_idx, wb, Zp, block, obs, cnt,
                                      alternative=alternative,
                                      far_row_ptr=far_row_ptr, far_q=far_q,
                                      Zf=Zf, wp1=wp1, tm=tm)
    return _launch_count(_GETIS_STAR, alternative, "getis_star_win", local_idx,
                         wb, Zp, block, obs, cnt, far_row_ptr, far_q, Zf,
                         row_f=wp1, col_a=tm)


def getis_g_count(local_idx, wb, Zp, block: int, obs, cnt, *, alternative: str,
                  far_row_ptr, far_q, Zf, w_row, tot, sq, inv_m: float, lag_o,
                  me_o) -> torch.Tensor:
    """One Gi draw's counter update, in place: the centred lag cp (module
    docstring) against ``obs`` = cp_o (f32 [Npad, G]) per ``alternative``,
    or an exact tie of (lag, z) with (``lag_o`` int32, ``me_o`` int8
    [Npad, G]). ``w_row`` f32 [Npad] (W), ``tot`` / ``sq`` f32 [G] (the
    codes' column sums), ``inv_m`` = f32(1/m). Returns ``cnt``."""
    _check(alternative in _ALTS, f"invalid alternative {alternative!r}")
    n_rows, _, G = _check_rows_far(local_idx, wb, Zp, block, far_row_ptr,
                                   far_q, Zf)
    dev = Zp.device
    _plane(obs, "obs", (torch.float32,), (n_rows, G), 16, dev)
    _plane(cnt, "cnt", _COUNTER_DTYPES, (n_rows, G), 4 * cnt.element_size(), dev)
    _plane(lag_o, "lag_o", (torch.int32,), (n_rows, G), 16, dev)
    _plane(me_o, "me_o", (torch.int8,), (n_rows, G), 4, dev)
    _plane(w_row, "w_row", (torch.float32,), (n_rows,), 4, dev)
    _plane(tot, "tot", (torch.float32,), (G,), 16, dev)
    _plane(sq, "sq", (torch.float32,), (G,), 16, dev)
    if dev.type == "cpu":
        return getis_g_count_plain(local_idx, wb, Zp, block, obs, cnt,
                                   alternative=alternative,
                                   far_row_ptr=far_row_ptr, far_q=far_q, Zf=Zf,
                                   w_row=w_row, tot=tot, sq=sq, inv_m=inv_m,
                                   lag_o=lag_o, me_o=me_o)
    return _launch_count(_GETIS_G, alternative, "getis_g_win", local_idx, wb, Zp,
                         block, obs, cnt, far_row_ptr, far_q, Zf, row_f=w_row,
                         col_a=tot, col_b=sq, lag_o=lag_o, me_o=me_o,
                         inv_m=inv_m)


def _check_lee(local_idx, wq, Zp, block: int, zx, sw_row, far_row_ptr, far_q,
               Zf):
    n_rows, k, G = _check_rows_far(local_idx, wq, Zp, block, far_row_ptr,
                                   far_q, Zf)
    _check(k <= LEE_MAX_K, f"the int8 Lee statistic is exact int32 for k <= "
                           f"{LEE_MAX_K} (k*127^3 < 2^31), got k={k}")
    _plane(zx, "zx", (torch.int8,), (n_rows, G), 4, Zp.device)
    _plane(sw_row, "sw_row", (torch.float32,), (n_rows,), 4, Zp.device)
    return n_rows, G


def _launch_lee(mode: int, name: str, local_idx, wq, Zp, block: int, zx,
                sw_row, far_row_ptr, far_q, Zf, obs=None, cnt=None):
    n_rows, k = local_idx.shape
    G = Zp.shape[1]
    lib = build.load_library()
    with torch.cuda.device(Zp.device):
        part = torch.empty((n_rows // block, G), dtype=torch.float32,
                           device=Zp.device)
        out = (torch.empty((n_rows, G), dtype=torch.int32, device=Zp.device)
               if mode == _LEE_OBSERVED else None)
        err = lib.sct_lee(
            mode, _ptr(local_idx), _ptr(wq), _ptr(Zp), _ptr(far_row_ptr),
            _ptr(far_q), _ptr(Zf), _ptr(zx), _ptr(sw_row), _ptr(obs), _ptr(cnt),
            _ptr(out), _ptr(part), n_rows // block, block, k, G,
            cnt.element_size() if cnt is not None else 1,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out, part


def lee_count(local_idx, wq, Zp, block: int, zx, sw_row, obs, cnt, *,
              far_row_ptr, far_q, Zf) -> torch.Tensor:
    """One Lee draw: ``cnt += (|x·lag| ≥ obs)`` in place, and the draw's
    per-block partials of the global L, returned as float32 [nb, G].

    ``zx`` int8 [Npad, G]: the fixed x codes in the relabeled order;
    ``sw_row`` f32 [Npad]: each row's weight scale; ``obs`` int32 [Npad, G]
    (|Lq| of the observed placement); ``cnt`` int8 / int16 / int32
    [Npad, G]. The band, ``Zp`` (the draw's gathered y codes) and the far
    edges (row pointers) as the module docstring says.
    """
    n_rows, G = _check_lee(local_idx, wq, Zp, block, zx, sw_row, far_row_ptr,
                           far_q, Zf)
    _plane(obs, "obs", (torch.int32,), (n_rows, G), 16, Zp.device)
    _plane(cnt, "cnt", _COUNTER_DTYPES, (n_rows, G), 4 * cnt.element_size(),
           Zp.device)
    if Zp.device.type == "cpu":
        return lee_count_plain(local_idx, wq, Zp, block, zx, sw_row, obs, cnt,
                               far_row_ptr=far_row_ptr, far_q=far_q, Zf=Zf)
    return _launch_lee(_LEE_COUNT, "lee_win", local_idx, wq, Zp, block, zx,
                       sw_row, far_row_ptr, far_q, Zf, obs=obs, cnt=cnt)[1]


def lee_observed(local_idx, wq, Zp, block: int, zx, sw_row, *, far_row_ptr,
                 far_q, Zf):
    """``(|Lq| int32 [Npad, G], partials f32 [nb, G])`` at the placement
    gathered into ``Zp`` (operands as :func:`lee_count`)."""
    _check_lee(local_idx, wq, Zp, block, zx, sw_row, far_row_ptr, far_q, Zf)
    if Zp.device.type == "cpu":
        return lee_observed_plain(local_idx, wq, Zp, block, zx, sw_row,
                                  far_row_ptr=far_row_ptr, far_q=far_q, Zf=Zf)
    return _launch_lee(_LEE_OBSERVED, "lee_obs", local_idx, wq, Zp, block, zx,
                       sw_row, far_row_ptr, far_q, Zf)


def lee_partial(local_idx, wq, Zp, block: int, zx, sw_row, *, far_row_ptr,
                far_q, Zf) -> torch.Tensor:
    """The partials f32 [nb, G] alone (the global-only Lee null; operands
    as :func:`lee_count`)."""
    _check_lee(local_idx, wq, Zp, block, zx, sw_row, far_row_ptr, far_q, Zf)
    if Zp.device.type == "cpu":
        return lee_partial_plain(local_idx, wq, Zp, block, zx, sw_row,
                                 far_row_ptr=far_row_ptr, far_q=far_q, Zf=Zf)
    return _launch_lee(_LEE_PARTIAL, "lee_partial", local_idx, wq, Zp, block,
                       zx, sw_row, far_row_ptr, far_q, Zf)[1]
