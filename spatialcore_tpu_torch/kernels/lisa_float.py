"""Wrapper of the float local Moran null's draw-step kernel, and its plain
version.

``csrc/lisa_float.cu`` runs one draw of the bf16 / f32 local Moran null
(``ops.banded._banded_local_moran_p``) in one launch. Per padded row i and
gene g of the draw's gathered table ``Zp``:

    lag_i[g] = ((w_0·z_0 + w_1·z_1) + …) + w_{k−1}·z_{k−1}   (band slots)
               + y_0·f_0 + y_1·f_1 + …                       (far edges)
    cnt[i, g] += |z_i[g] · lag_i[g]| ≥ obs[i, g]

every product rounded to float32 and added in that order: band slots in
slot order, then the row's far edges in their far-list order. It replaces
no Pallas kernel: the reference's ``_banded_local_moran_p``
(``spatialcore_tpu/ops/banded.py:2487``) is XLA ops.

The plain version, :func:`moran_count_plain`, is the port's torch-op loop
(:func:`band_lag`: a gather, a product and an add per band slot, then per
far slot of :func:`far_slots`, over [rows, G] float32 temps). The kernel
rounds at the same places, so the counts are equal bitwise: exact ties of
|z·lag| with obs, frequent on discrete counts, fall the same way. The
kernel reads the far edges as row pointers and skips the plain version's
empty far slots, which add ±0: that leaves |z·lag| as it is for every
finite table.

Operands: ``local_idx`` int16 [Npad, k] (window-relative rows in [0, 3B)),
``w`` [Npad, k] and ``Zp`` [(nb+2)·B, G], both float32 or both bfloat16
(block n's window is rows [n·B, n·B + 3B), its own rows [n·B + B, n·B +
2B)); the far list as row pointers ``far_row_ptr`` int32 [Npad+1] into
``far_dst`` int32 [F] (the ``Zp`` row of each far edge's value) and
``far_w`` float32 [F]; ``obs`` float32 [Npad, G] (padded rows +inf) and
``cnt`` int16 or int32 [Npad, G], updated in place.

The wrapper checks device, dtype, shape and contiguity, then:

* on a CPU tensor, runs the plain version;
* on a CUDA tensor, launches the kernel on the current stream and adds one
  to its mode in :data:`LAUNCHES` (``moran_f32`` or ``moran_bf16``) — or
  raises. There is no fallback.

Preconditions it does not check (a device read-back per launch):
``local_idx`` values lie in [0, 3B); ``far_row_ptr`` is non-decreasing
from 0 with ``far_row_ptr[-1]`` ≤ F, and ``far_dst`` values are rows of
``Zp``; the table is finite.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..utils.profiling import CounterGroup
from . import build
from .band_cross import _SMS, MAX_BLOCK, SMEM_LIMIT, _aligned16, _r16
from .lisa_count import _row_chunks

#: kernel launches by table precision (the counters
#: ``kernels.lisa_float.<mode>`` of ``utils.profiling``)
LAUNCHES = CounterGroup("kernels.lisa_float", ("moran_f32", "moran_bf16"))

#: threads of a CTA (``kThreads`` in the kernel's source)
_THREADS = 512
#: waves of CTAs a launch aims at: a CTA here is long (its far edges come
#: on top of the band), so the last wave's idle SMs cost more than the
#: band-cross kernels' (which aim at 8); at the vignette's shape 16 waves
#: (run 2) took 0.965 ms against 1.006 at 8 (run 5)
_WAVES = 16
_TABLE_DTYPES = (torch.float32, torch.bfloat16)
_COUNTER_DTYPES = (torch.int16, torch.int32)


def counter_dtype(n_permutations: int) -> torch.dtype:
    """Narrowest counter this module takes that holds P draws: int16 ≤ 32767
    (half the bytes of the [N, G] count update), int32 above."""
    return torch.int16 if n_permutations <= 32767 else torch.int32


def reset_launch_counts() -> None:
    LAUNCHES.clear()


# ---------------------------------------------------------------------------
# Launch shape
# ---------------------------------------------------------------------------


class LisaFloatTiles(NamedTuple):
    """Launch shape of the kernel."""
    tile: int          #: genes per CTA; tile·esz is a power of two, 16–512 bytes
    chunk: int         #: band rows a pipeline stage, at most one a thread
    far_cap: int       #: far entries of a chunk whose values are staged
    tail: int          #: genes of the last tile's CTAs (past the whole tiles)
    tail_chunk: int    #: ... its band rows a stage
    tail_far_cap: int  #: ... and its far entries staged a chunk
    run: int           #: consecutive band blocks a CTA walks over its slab ring
    smem: int          #: dynamic shared memory bytes (the larger of the two)


def lisa_float_smem_bytes(block: int, k: int, esz: int, tile: int, chunk: int,
                          far_cap: int = 0) -> int:
    """Shared memory of one tile's CTAs (``layout`` in ``lisa_float.cu``):
    the 4-slot ring [4B, tile·esz] bytes; two stage buffers of ``chunk``
    rows of int16 local_idx and weights and ``far_cap`` far entries' rows
    and weights (int32, float32), each part with 15 spare bytes for its
    copies' alignment phase; the far values [far_cap, tile·esz]."""
    rb = tile * esz
    buf = (_r16(chunk * k * 2 + 15) + _r16(chunk * k * esz + 15)
           + 2 * _r16(far_cap * 4 + 15))
    return 4 * block * rb + 2 * buf + far_cap * rb


def _tile_shape(block: int, k: int, esz: int, rb: int):
    """(tile, chunk, far_cap) at ring rows of ``rb`` bytes: a chunk of a row
    a thread (512 / (rb / 16) threads work at a row), fewer where the band
    rows do not fit or leave room for under 4 far entries a row (a kNN
    plan at k = 50 has ~5 a row on average, most of them on a few rows),
    and the rest of shared memory for far values; None when not one band
    row fits."""
    tile = rb // esz

    def cap_of(chunk):
        cap = max(0, (SMEM_LIMIT - lisa_float_smem_bytes(block, k, esz, tile, chunk)) // rb)
        while cap > 0 and lisa_float_smem_bytes(block, k, esz, tile, chunk, cap) > SMEM_LIMIT:
            cap -= 1
        return cap

    chunk = min(block, _THREADS // (rb // 16))
    while chunk > 1 and cap_of(chunk) < 4 * chunk:
        chunk -= 1
    if lisa_float_smem_bytes(block, k, esz, tile, chunk) > SMEM_LIMIT:
        return None
    return tile, chunk, cap_of(chunk)


@functools.lru_cache(maxsize=None)
def lisa_float_tiles(block: int, k: int, esz: int, G: int, n_blocks: int,
                     max_row_bytes: int = 128, run: Optional[int] = None
                     ) -> LisaFloatTiles:
    """(tile, chunk, far_cap, tail, tail_chunk, tail_far_cap, run) of the
    kernel for B = ``block``, k slots, values of ``esz`` bytes, G genes and
    ``n_blocks`` band blocks.

    The ring's row (tile·esz bytes, a power of two) is as wide as G needs,
    up to ``max_row_bytes``, and the ring at most 128 KB; a ring too wide
    for one band row halves. A chunk is a row a thread, and the shared
    memory left holds its far values (:func:`_tile_shape`). The genes past
    the whole tiles go to one last tile of the narrowest ring row that
    holds them, so a ragged G (100 = 3 × 32 + 4 in float32) does not pay a
    whole tile's band work for a few genes. ``run`` (default) is the
    longest, up to 32 blocks, that still gives every SM ~16 waves of CTAs.
    Cached: every launch asks for it.
    """
    rb = 16
    while rb < min(max_row_bytes, max(16, G * esz)) and 4 * block * rb * 2 <= (128 << 10):
        rb *= 2
    full = _tile_shape(block, k, esz, rb)
    while full is None and rb > 16:
        rb //= 2                  # a narrower ring leaves the band more room
        full = _tile_shape(block, k, esz, rb)
    _check(full is not None, f"k={k} band slots do not fit the kernel's shared memory")
    tile = full[0]
    last = full
    if G % tile:
        rb_t = 16
        while rb_t < (G % tile) * esz:
            rb_t *= 2
        last = _tile_shape(block, k, esz, rb_t)
    smem = max(lisa_float_smem_bytes(block, k, esz, *full),
               lisa_float_smem_bytes(block, k, esz, *last))
    if run is None:
        per_sm = max(1, min(2048 // _THREADS, 233_472 // (smem + 1024)))
        run = max(1, min(32, n_blocks * -(-G // tile) // (_WAVES * _SMS * per_sm)))
    return LisaFloatTiles(*full, *last, run, smem)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def band_lag(local_idx, w, Zp, block: int, far, r0: int, r1: int
             ) -> torch.Tensor:
    """float32 spatial lag of padded rows [r0, r1): band slot by slot on the
    compact band, then the far slots of :func:`far_slots` (``far``) in
    rank order. Every row adds its terms in one fixed order, so the sum is
    bitwise reproducible; an empty far slot adds ±0."""
    rows = torch.arange(r0, r1, device=Zp.device)
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


def far_slots(far_row_ptr, far_dst, far_w, n_slots: Optional[int] = None):
    """The far list as slots: ``(dst int64, w float32)`` [Npad, R], where
    slot t of a row holds its t-th far edge in list order and R is the
    most far edges any row has (``n_slots``, or read from the pointers).
    Empty slots read row 0 with weight 0."""
    ptr = far_row_ptr.to(torch.int64)
    n_rows, n_far = ptr.numel() - 1, far_dst.numel()
    dev = ptr.device
    per_row = ptr[1:] - ptr[:-1]
    if n_slots is None:
        n_slots = int(per_row.max()) if n_far else 0
    rows = torch.repeat_interleave(torch.arange(n_rows, device=dev), per_row)
    rank = torch.arange(n_far, device=dev) - ptr[rows]
    dst = torch.zeros((n_rows, n_slots), dtype=torch.int64, device=dev)
    w = torch.zeros((n_rows, n_slots), dtype=torch.float32, device=dev)
    dst[rows, rank] = far_dst.to(torch.int64)
    w[rows, rank] = far_w.to(torch.float32)
    return dst, w


def moran_count_plain(local_idx, w, Zp, block: int, obs, cnt, *, far_row_ptr,
                      far_dst, far_w) -> torch.Tensor:
    """Plain version of :func:`moran_count`: updates ``cnt`` in place."""
    far = far_slots(far_row_ptr, far_dst, far_w)
    for r0, r1 in _row_chunks(local_idx.shape[0], block, Zp.shape[1]):
        lag = band_lag(local_idx, w, Zp, block, far, r0, r1)
        Ip = Zp[block + r0:block + r1].to(torch.float32) * lag
        cnt[r0:r1] += (Ip.abs() >= obs[r0:r1]).to(cnt.dtype)
    return cnt


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _plane(t, name: str, dtypes, shape, dev) -> None:
    _check(t.dtype in dtypes and tuple(t.shape) == tuple(shape),
           f"{name} must be {dtypes} {list(shape)}")
    _check(t.device == dev and t.is_contiguous(),
           f"{name} must be contiguous on Zp's device")


def moran_count(local_idx, w, Zp, block: int, obs, cnt, *, far_row_ptr,
                far_dst, far_w, tiles: Optional[LisaFloatTiles] = None
                ) -> torch.Tensor:
    """One draw's counter update, in place: ``cnt += (|z·lag| ≥ obs)``.

    Operands as the module docstring says; ``tiles`` sets the kernel's
    launch shape (None: :func:`lisa_float_tiles`), for timing other
    shapes and testing runs that do not divide the block count. Returns
    ``cnt``.
    """
    _check(local_idx.ndim == 2, "local_idx must be int16 [Npad, k]")
    n_rows, k = local_idx.shape
    _check(k >= 1, "the band needs at least one slot")
    _check(1 <= block <= MAX_BLOCK and n_rows % block == 0,
           f"block must be in [1, {MAX_BLOCK}] and divide Npad={n_rows}")
    dev = Zp.device
    _check(dev.type in ("cpu", "cuda"), f"unsupported device {dev}")
    _check(Zp.ndim == 2 and Zp.shape[1] >= 1, "Zp must be [(nb+2)·B, G]")
    G = Zp.shape[1]
    _plane(Zp, "Zp", _TABLE_DTYPES, (n_rows + 2 * block, G), dev)
    _plane(local_idx, "local_idx", (torch.int16,), (n_rows, k), dev)
    _plane(w, "w", (Zp.dtype,), (n_rows, k), dev)
    _plane(obs, "obs", (torch.float32,), (n_rows, G), dev)
    _plane(cnt, "cnt", _COUNTER_DTYPES, (n_rows, G), dev)
    _plane(far_row_ptr, "far_row_ptr", (torch.int32,), (n_rows + 1,), dev)
    _check(far_dst.ndim == 1, "far_dst must be int32 [F]")
    _plane(far_dst, "far_dst", (torch.int32,), far_dst.shape, dev)
    _plane(far_w, "far_w", (torch.float32,), far_dst.shape, dev)
    if dev.type == "cpu":
        return moran_count_plain(local_idx, w, Zp, block, obs, cnt,
                                 far_row_ptr=far_row_ptr, far_dst=far_dst,
                                 far_w=far_w)
    esz = Zp.element_size()
    if tiles is None:
        tiles = lisa_float_tiles(block, k, esz, G, n_rows // block)
    local_idx, w = _aligned16(local_idx), _aligned16(w)
    far_dst, far_w = _aligned16(far_dst), _aligned16(far_w)
    lib = build.load_library()
    with torch.cuda.device(dev):
        err = lib.sct_lisa_float(
            local_idx.data_ptr(), w.data_ptr(), Zp.data_ptr(),
            far_row_ptr.data_ptr(), far_dst.data_ptr(), far_w.data_ptr(),
            obs.data_ptr(), cnt.data_ptr(), n_rows // block, block, k, G,
            int(esz == 2), cnt.element_size(), *tiles[:7],
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"lisa_float launch failed: CUDA error {err}")
    LAUNCHES["moran_bf16" if esz == 2 else "moran_f32"] += 1
    return cnt
