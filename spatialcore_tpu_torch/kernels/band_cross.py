"""Wrappers of the band-cross kernels, and their plain PyTorch versions.

Four kernels carry the global permutation null's hot loop, one draw each:

``band_cross_int8`` (``csrc/band_cross_int8.cu``; replaces Pallas K1–K3)
    cross_q[g] = Σ_i sw_i · z1_i[g] · lag_i[g], with the exact integer lag
    lag_i = Σ_slots wq·z[window + local_idx] (+ Σ_far q_e·zf_e[g]) over
    int8 codes, or int4 codes nibble-packed two genes per byte.
``band_cross_float`` (``csrc/band_cross_float.cu``; replaces Pallas K4)
    cross[g] = Σ_i z1_i[g] · lag_i[g], bf16 or f32 values, f32 lag.

These two share the slab ring of ``csrc/slab_ring.cuh``: a CTA walks a run
of band blocks over one column tile, so each slab of ``Zp`` crosses HBM
once per run; :func:`int_tiles` and :func:`float_tiles` pick the launch
shape.
``band_cross_dense`` (``csrc/band_cross_dense.cu``; replaces Pallas K5)
    the same cross with the lag a dense product A[n] @ window, A [nb, B, 3B].
``band_cross_rot4`` (``csrc/band_cross_dense.cu``; replaces Pallas K6)
    the same cross as one [B, 4B] @ [4B, G] product per block over a 4-slot
    ring of slabs, A4 [nb, B, 4B] in the rotation-baked layout.

These two share one main loop: a CTA stages one row tile of A in shared
memory once, lists the 16×16 tiles that hold a weight, and walks every
gene tile multiplying only those; :func:`dense_tiles` picks the row tile.

The first two take the compact band — ``local_idx`` [Npad, k]
(window-relative neighbour rows in [0, 3B)) and per-slot weights; the
lag is the same sum as the dense band's, exactly, for the integer
kernels. The last two multiply the reference's dense band on the tensor
cores (bf16) or the CUDA cores (f32). ``Zp`` is the draw's gathered value
table, flat [(nb+2)·B, cols]: block n's window is rows [n·B, n·B + 3B)
and its own rows are [n·B + B, n·B + 2B).

Each wrapper checks device, dtype, shape and contiguity, and then:

* on a CPU tensor, returns the plain version (same inputs, same result up
  to float32 summation order; the integer lags are equal bitwise);
* on a CUDA tensor, launches the kernel on the current stream and adds one
  to its entry in :data:`LAUNCHES` — or raises. There is no fallback.

Preconditions the wrappers do not check (they would need a device
readback per launch; ``ops.banded`` checks them once per call):
``local_idx`` values lie in [0, 3B), and ``far_row_ptr`` is non-decreasing
with ``far_row_ptr[-1]`` ≤ the far-list length.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import build

#: kernel launches by mode, counted where each wrapper launches its kernel
LAUNCHES = {"int4_win": 0, "int4_band": 0, "int8_win": 0, "int8_band": 0,
            "float": 0, "dense": 0, "rot4": 0}

#: rows per chunk of the plain versions' [rows, G] temps (times G ≤ 2**27)
_PLAIN_CHUNK_ELEMS = 1 << 27
#: largest block the kernels' shared-memory staging of 3B rows takes
MAX_BLOCK = 512
#: the dense kernels' blocks: multiples of 16 (tensor-core tiles) up to 256
#: (a row tile of K6's A4, [32, 4B] f32, in shared memory)
DENSE_MAX_BLOCK = 256
#: dynamic shared memory one block may use on the H100 (227 KB)
SMEM_LIMIT = 232_448
#: threads of a ``band_cross_float`` CTA (``kThreads`` in its source)
_FLOAT_THREADS = 512
#: threads of a ``band_cross_int8`` CTA (``kThreads`` in its source)
_INT_THREADS = 512
#: the H100's streaming multiprocessors
_SMS = 132
#: shared memory of one SM (228 KB), 1 KB of it reserved per resident CTA
_SM_SMEM = 233_472


def reset_launch_counts() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def unpack_nibbles(Zpk: torch.Tensor) -> torch.Tensor:
    """int8 packed [..., Gp2] → int8 codes [..., 2·Gp2] in natural order.

    Packed column j holds gene j in its high nibble and gene j + Gp2 in its
    low nibble, each stored as code + 8. Arithmetic shift + mask reads the
    nibbles right for either sign of the byte.
    """
    hi = ((Zpk >> 4) & 15) - 8
    lo = (Zpk & 15) - 8
    return torch.cat([hi, lo], dim=-1).to(torch.int8)


def _rows(Zp: torch.Tensor, idx, packed: bool) -> torch.Tensor:
    """Rows of a value table as float32 codes (unpacked when ``packed``)."""
    z = Zp[idx]
    return (unpack_nibbles(z) if packed else z).to(torch.float32)


def _row_chunks(n_rows: int, block: int, G: int):
    step = max(block, (_PLAIN_CHUNK_ELEMS // max(G, 1)) // block * block)
    return [(r0, min(r0 + step, n_rows)) for r0 in range(0, n_rows, step)]


# ---------------------------------------------------------------------------
# Plain versions (compact band form)
# ---------------------------------------------------------------------------


def band_lag_int8_plain(local_idx, wq, Zp, block: int, *, packed: bool,
                        far_row_ptr=None, far_q=None, Zf=None,
                        r0: int = 0, r1: Optional[int] = None) -> torch.Tensor:
    """Integer lag of padded rows [r0, r1) as float32 [rows, G].

    float32 holds every lag exactly: a row has at most k nonzero weight
    codes ≤ 127 times value codes ≤ 127, so |lag| ≤ k·127² < 2²⁴ for
    k < 1040, and each partial sum is an exactly representable integer —
    these lags equal the kernel's int32 lags bitwise.
    """
    r1 = local_idx.shape[0] if r1 is None else r1
    dev = Zp.device
    rows = torch.arange(r0, r1, device=dev)
    win0 = (rows // block) * block                   # window start: n·B
    li = local_idx[r0:r1].to(torch.int64)
    w = wq[r0:r1].to(torch.float32)
    lag = None
    for s in range(li.shape[1]):
        term = w[:, s:s + 1] * _rows(Zp, win0 + li[:, s], packed)
        lag = term if lag is None else lag + term
    if far_row_ptr is not None:
        ptr = far_row_ptr.to(torch.int64)
        p0, p1 = int(ptr[r0]), int(ptr[r1])
        dst = torch.repeat_interleave(torch.arange(r1 - r0, device=dev),
                                      ptr[r0 + 1:r1 + 1] - ptr[r0:r1])
        vals = far_q[p0:p1].to(torch.float32)[:, None] * _rows(
            Zf, slice(p0, p1), packed)
        lag.index_add_(0, dst, vals)    # integer-valued: exact in any order
    return lag


def band_cross_int8_plain(local_idx, wq, sw, Zp, block: int, *, packed: bool,
                          far_row_ptr=None, far_q=None, Zf=None) -> torch.Tensor:
    """Plain version of :func:`band_cross_int8` (same inputs)."""
    n_rows = local_idx.shape[0]
    G = Zp.shape[1] * (2 if packed else 1)
    cross = torch.zeros(G, dtype=torch.float32, device=Zp.device)
    for r0, r1 in _row_chunks(n_rows, block, G):
        lag = band_lag_int8_plain(local_idx, wq, Zp, block, packed=packed,
                                  far_row_ptr=far_row_ptr, far_q=far_q, Zf=Zf,
                                  r0=r0, r1=r1)
        z1 = _rows(Zp, slice(block + r0, block + r1), packed)
        cross += ((sw[r0:r1, None] * z1) * lag).sum(dim=0)
    return cross


def band_lag_float_plain(local_idx, w, Zp, block: int, r0: int = 0,
                         r1: Optional[int] = None) -> torch.Tensor:
    """float32 lag of padded rows [r0, r1): Σ_slots w·z, slot by slot."""
    r1 = local_idx.shape[0] if r1 is None else r1
    rows = torch.arange(r0, r1, device=Zp.device)
    win0 = (rows // block) * block
    li = local_idx[r0:r1].to(torch.int64)
    wf = w[r0:r1].to(torch.float32)
    lag = None
    for s in range(li.shape[1]):
        term = wf[:, s:s + 1] * Zp[win0 + li[:, s]].to(torch.float32)
        lag = term if lag is None else lag + term
    return lag


def band_cross_float_plain(local_idx, w, Zp, block: int) -> torch.Tensor:
    """Plain version of :func:`band_cross_float` (same inputs)."""
    n_rows = local_idx.shape[0]
    G = Zp.shape[1]
    cross = torch.zeros(G, dtype=torch.float32, device=Zp.device)
    for r0, r1 in _row_chunks(n_rows, block, G):
        lag = band_lag_float_plain(local_idx, w, Zp, block, r0, r1)
        cross += (Zp[block + r0:block + r1].to(torch.float32) * lag).sum(dim=0)
    return cross


# ---------------------------------------------------------------------------
# Plain versions (dense band form)
# ---------------------------------------------------------------------------


def block_chunks(nb: int, B: int, G: int):
    """Block ranges [n0, n1) whose [rows, G] temps stay bounded."""
    step = max(1, _PLAIN_CHUNK_ELEMS // max(B * G, 1))
    return [(n0, min(n0 + step, nb)) for n0 in range(0, nb, step)]


def band_lag_dense(A, Zp3, n0: int, n1: int) -> torch.Tensor:
    """Band lag of blocks [n0, n1) as float32 [(n1−n0)·B, G] from the dense
    band ``A`` [nb, B, 3B] and ``Zp3`` [nb+2, B, G].

    int8 operands are widened to float32: every lag is exact there. A row
    has at most k nonzero weight codes ≤ 127 times value codes ≤ 127, so
    |lag| ≤ k·127² < 2²⁴ for k < 1040 and every partial sum is an exactly
    representable integer — the plain lags and the kernel's int32 lags
    compare bitwise. (float32 matmul must not run in TF32.)
    """
    B = A.shape[1]
    lag = None
    for s in range(3):
        part = torch.bmm(A[n0:n1, :, s * B:(s + 1) * B].to(torch.float32),
                         Zp3[n0 + s:n1 + s].to(torch.float32))
        lag = part if lag is None else lag + part
    return lag.reshape((n1 - n0) * B, -1)


def dense_cross(Zp3, B: int, lag_fn, sw=None) -> torch.Tensor:
    """Σ_i (sw_i)·z1_i·lag_i over blocks in bounded chunks, ``Zp3``
    [nb+2, B, G]; ``lag_fn(n0, n1)`` gives the float32 lag of blocks
    [n0, n1) as [(n1−n0)·B, G]."""
    nb, G = Zp3.shape[0] - 2, Zp3.shape[2]
    z1 = Zp3.reshape(-1, G)[B:B + nb * B]
    cross = torch.zeros(G, dtype=torch.float32, device=Zp3.device)
    for n0, n1 in block_chunks(nb, B, G):
        t = z1[n0 * B:n1 * B].to(torch.float32)
        if sw is not None:
            t = sw.reshape(-1, 1)[n0 * B:n1 * B] * t
        cross += (t * lag_fn(n0, n1)).sum(dim=0)
    return cross


def band_cross_dense_plain(A, Zp, block: int) -> torch.Tensor:
    """Plain version of :func:`band_cross_dense` (same inputs): the lag of
    three batched products per block chunk, accumulated in float32 from
    bf16/f32 operands (the Pallas kernel's precision)."""
    nb = A.shape[0]
    Zp3 = Zp.reshape(nb + 2, block, -1)
    return dense_cross(Zp3, block, lambda n0, n1: band_lag_dense(A, Zp3, n0, n1))


def rot4_slabs(nb: int, n0: int, n1: int, device) -> torch.Tensor:
    """Slab held in ring slot s at block n, [n1−n0, 4]: slot s holds the one
    slab of n, n+1, n+2, n+3 that is ≡ s (mod 4) — the Pallas ring, whose
    fourth slot meets zero weights in A4."""
    n = torch.arange(n0, n1, device=device)[:, None]
    s = torch.arange(4, device=device)[None, :]
    return n + (s - n) % 4


def band_cross_rot4_plain(A4, Zp, block: int) -> torch.Tensor:
    """Plain version of :func:`band_cross_rot4` (same inputs): per block the
    4-slot window [4B, G] in slot order, then one product A4[n] @ window.
    Slab nb+2 (past the table, the last block's fourth slot) reads as
    zeros."""
    nb, B = A4.shape[0], block
    G = Zp.shape[1]
    Zp4 = torch.cat([Zp.reshape(nb + 2, B, G),
                     torch.zeros((1, B, G), dtype=Zp.dtype, device=Zp.device)])

    def lag(n0, n1):
        win = Zp4[rot4_slabs(nb, n0, n1, Zp.device)].reshape(n1 - n0, 4 * B, G)
        return torch.bmm(A4[n0:n1].to(torch.float32),
                         win.to(torch.float32)).reshape((n1 - n0) * B, G)

    return dense_cross(Zp4[:nb + 2], B, lag)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_band(local_idx, w, w_dtypes, Zp, block: int):
    _check(local_idx.dtype == torch.int32 and local_idx.ndim == 2,
           "local_idx must be int32 [Npad, k]")
    n_rows, k = local_idx.shape
    _check(k >= 1, "the band needs at least one slot")
    _check(1 <= block <= MAX_BLOCK and n_rows % block == 0,
           f"block must be in [1, {MAX_BLOCK}] and divide Npad={n_rows}")
    _check(w.dtype in w_dtypes and tuple(w.shape) == (n_rows, k),
           f"band weights must be {w_dtypes} [Npad, k]")
    _check(Zp.ndim == 2 and Zp.shape[0] == n_rows + 2 * block,
           "Zp must be [(nb+2)·B, cols]")
    for t in (local_idx, w, Zp):
        _check(t.device == Zp.device, "all operands must share one device")
        _check(t.is_contiguous(), "operands must be contiguous")
    _check(Zp.device.type in ("cpu", "cuda"),
           f"unsupported device {Zp.device}")
    return n_rows // block, k


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def band_cross_int8(local_idx, wq, sw, Zp, block: int, *, packed: bool,
                    far_row_ptr=None, far_q=None, Zf=None) -> torch.Tensor:
    """cross_q[g] (z_q·w_q units) of one draw in the int8 / int4 system.

    ``local_idx`` int32 [Npad, k]; ``wq`` int8 [Npad, k] weight codes;
    ``sw`` f32 [Npad] row scales; ``Zp`` int8 [(nb+2)·B, G] codes, or
    [(nb+2)·B, G/2] nibble-packed bytes when ``packed``. With far edges:
    ``far_row_ptr`` int32 [Npad+1] (row r's entries are
    [ptr[r], ptr[r+1])), ``far_q`` int8 [F] weight codes and ``Zf`` [F, cols]
    the gathered far values. Returns f32 [G].
    """
    return band_cross_int8_tiled(local_idx, wq, sw, Zp, block, None,
                                 packed=packed, far_row_ptr=far_row_ptr,
                                 far_q=far_q, Zf=Zf)


def band_cross_int8_tiled(local_idx, wq, sw, Zp, block: int,
                          tiles: Optional["IntTiles"], *, packed: bool,
                          far_row_ptr=None, far_q=None,
                          Zf=None) -> torch.Tensor:
    """:func:`band_cross_int8` with the kernel's launch shape given (None:
    :func:`int_tiles`): for timing other launch shapes and for testing runs
    that do not divide the block count."""
    nb, k = _check_band(local_idx, wq, (torch.int8,), Zp, block)
    _check(Zp.dtype == torch.int8, "Zp must be int8")
    _check(Zp.shape[1] % 4 == 0 and Zp.data_ptr() % 4 == 0,
           "Zp's rows must be 4-byte aligned: a multiple of 4 columns")
    _check(sw.dtype == torch.float32 and tuple(sw.shape) == (local_idx.shape[0],)
           and sw.device == Zp.device and sw.is_contiguous(),
           "sw must be contiguous f32 [Npad] on Zp's device")
    has_far = far_row_ptr is not None
    if has_far:
        _check(far_row_ptr.dtype == torch.int32
               and tuple(far_row_ptr.shape) == (local_idx.shape[0] + 1,),
               "far_row_ptr must be int32 [Npad+1]")
        _check(far_q.dtype == torch.int8 and far_q.ndim == 1,
               "far_q must be int8 [F]")
        _check(Zf.dtype == torch.int8 and Zf.ndim == 2
               and Zf.shape[0] == far_q.shape[0] and Zf.shape[1] == Zp.shape[1],
               "Zf must be int8 [F, cols] matching far_q and Zp")
        _check(Zf.data_ptr() % 4 == 0, "Zf must be 4-byte aligned")
        for t in (far_row_ptr, far_q, Zf):
            _check(t.device == Zp.device and t.is_contiguous(),
                   "far operands must be contiguous on Zp's device")
    else:
        _check(far_q is None and Zf is None,
               "far_q and Zf need far_row_ptr")
    if Zp.device.type == "cpu":
        return band_cross_int8_plain(local_idx, wq, sw, Zp, block,
                                     packed=packed, far_row_ptr=far_row_ptr,
                                     far_q=far_q, Zf=Zf)
    gcols = Zp.shape[1]
    G = 2 * gcols if packed else gcols
    if tiles is None:
        tiles = int_tiles(block, k, packed, G, nb)
    local_idx, wq, sw = _aligned16(local_idx), _aligned16(wq), _aligned16(sw)
    if has_far:
        far_row_ptr, far_q = _aligned16(far_row_ptr), _aligned16(far_q)
    lib = build.load_library()
    with torch.cuda.device(Zp.device):
        partial = torch.empty((-(-nb // tiles.run), G), dtype=torch.float32,
                              device=Zp.device)
        err = lib.sct_band_cross_int8(
            _ptr(local_idx), _ptr(wq), _ptr(sw), _ptr(Zp), _ptr(far_row_ptr),
            _ptr(far_q), _ptr(Zf), _ptr(partial), nb, block, k, gcols,
            int(packed), tiles.tile, tiles.run, tiles.chunk, tiles.far_cap,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"band_cross_int8 launch failed: CUDA error {err}")
    LAUNCHES[f"{'int4' if packed else 'int8'}_{'win' if has_far else 'band'}"] += 1
    # per-run partials reduce in a fixed order: no float atomics
    return partial.sum(dim=0)


class IntTiles(NamedTuple):
    """Launch shape of ``band_cross_int8``'s kernel."""
    tile: int      #: Zp columns (bytes) per CTA: a power of two, 16–256
    run: int       #: consecutive band blocks a CTA walks over its slab ring
    chunk: int     #: band rows staged in shared memory per pipeline stage
    far_cap: int   #: far entries of a chunk staged with it (the rest: global)
    smem: int      #: dynamic shared memory bytes (int_smem_bytes)


def _r16(b: int) -> int:
    return (b + 15) // 16 * 16


def int_smem_bytes(block: int, k: int, packed: bool, tile: int,
                   chunk: int, far_cap: int = 0) -> int:
    """Shared memory of the kernel (the layout in ``band_cross_int8.cu``):
    the 4-slot ring [4B, tile] bytes (which the final reduction, [warps,
    genes of the tile] f32, reuses), two band buffers of ``chunk`` rows of
    local_idx, wq (8 spare bytes), sw and far row pointers, each with 15
    spare bytes for its copies' alignment phase, and two far buffers of
    ``far_cap`` entries' values [far_cap, tile] and weight codes."""
    ring = max(4 * block * tile,
               (_INT_THREADS // 32) * tile * (2 if packed else 1) * 4)
    buf = (_r16(chunk * k * 4 + 15) + _r16(chunk * k + 8 + 15)
           + _r16(chunk * 4 + 15) + _r16((chunk + 1) * 4 + 15))
    far = far_cap * tile + _r16(far_cap + 15)
    return ring + 2 * buf + 2 * far


def _run_for(n_blocks: int, n_tiles: int, smem: int, threads: int) -> int:
    """The longest run, up to 32 blocks, that still gives every SM ~8
    waves of CTAs."""
    per_sm = max(1, min(2048 // threads, 233_472 // (smem + 1024)))
    return max(1, min(32, n_blocks * n_tiles // (8 * _SMS * per_sm)))


def int_tiles(block: int, k: int, packed: bool, G: int, n_blocks: int,
              max_row_bytes: int = 256, run: Optional[int] = None) -> IntTiles:
    """(tile, run, chunk) of ``band_cross_int8``'s kernel for B = ``block``,
    k slots, G genes (int4 ``packed``: G/2 byte columns) and ``n_blocks``
    band blocks.

    As :func:`float_tiles`: the ring's row (``tile`` bytes, a power of two)
    is as wide as the columns need, up to ``max_row_bytes``, and the ring at
    most 128 KB; the rest of shared memory holds the band's two buffers —
    the whole block's rows when they fit, else the most rows that do — and
    then two far buffers of up to one far entry a chunk row (``far_cap``;
    a chunk's entries past it are read from global memory in the inner
    loop). ``run`` (default) is the longest, up to 32 blocks, that still
    gives every SM ~8 waves of CTAs: Zp crosses HBM (run+2)/run times.
    """
    cols = G // 2 if packed else G
    rb = 16
    while rb < min(max_row_bytes, max(16, cols)) and 4 * block * rb * 2 <= (128 << 10):
        rb *= 2
    while True:
        chunk = min(block, (SMEM_LIMIT - int_smem_bytes(block, 0, packed, rb, 0))
                    // (2 * (5 * k + 8)))
        while chunk >= 1 and int_smem_bytes(block, k, packed, rb, chunk) > SMEM_LIMIT:
            chunk -= 1
        while chunk < block and int_smem_bytes(block, k, packed, rb,
                                               chunk + 1) <= SMEM_LIMIT:
            chunk += 1
        if chunk >= 1 or rb == 16:
            break
        rb //= 2                  # a narrower ring leaves the band more room
    _check(chunk >= 1, f"k={k} band slots do not fit the kernel's shared memory")
    far_cap = chunk
    while far_cap > 0 and int_smem_bytes(block, k, packed, rb, chunk,
                                         far_cap) > SMEM_LIMIT:
        far_cap -= 1
    smem = int_smem_bytes(block, k, packed, rb, chunk, far_cap)
    if run is None:
        run = _run_for(n_blocks, -(-cols // rb), smem, _INT_THREADS)
    return IntTiles(rb, run, chunk, far_cap, smem)


class FloatTiles(NamedTuple):
    """Launch shape of ``band_cross_float``'s kernel."""
    gt: int        #: genes per CTA; gt·esz is a power of two, 16–256 bytes
    run: int       #: consecutive band blocks a CTA walks over its slab ring
    chunk: int     #: band rows staged in shared memory per pipeline stage
    smem: int      #: dynamic shared memory bytes (float_smem_bytes)


def float_smem_bytes(block: int, k: int, esz: int, gt: int, chunk: int) -> int:
    """Shared memory of the kernel (the layout in ``band_cross_float.cu``):
    the 4-slot ring [4B, gt] (which the final reduction, [warps, gt] f32,
    reuses) and two band buffers of ``chunk`` rows of local_idx and w, each
    with 15 spare bytes for its copies' alignment phase."""
    ring = max(4 * block * gt * esz, (_FLOAT_THREADS // 32) * gt * 4)
    return ring + 2 * (_r16(chunk * k * 4 + 15) + _r16(chunk * k * esz + 15))


def float_tiles(block: int, k: int, esz: int, G: int, n_blocks: int,
                max_row_bytes: int = 256, run: Optional[int] = None) -> FloatTiles:
    """(gt, run, chunk) of ``band_cross_float``'s kernel for B = ``block``,
    k slots, values of ``esz`` bytes, G genes and ``n_blocks`` band blocks.

    The ring's row (gt·esz bytes, a power of two) is as wide as G needs, up
    to ``max_row_bytes``, and the ring at most 128 KB: a wider tile re-reads
    the band fewer times (once per gene tile), and the rest of shared
    memory goes to the band's two buffers — the whole block's rows when
    they fit, else the most rows that do. ``run`` (default) is the longest,
    up to 32 blocks, that still gives every SM ~8 waves of CTAs: Zp crosses
    HBM (run+2)/run times. Raises for a k so large that one band row's two
    buffers do not fit (k above ~12,000 in f32).
    """
    need = max(16, G * esz)
    rb = 16
    while rb < min(max_row_bytes, need) and 4 * block * rb * 2 <= (128 << 10):
        rb *= 2
    while True:
        gt = rb // esz
        # the most band rows that fit (the estimate leaves room for padding)
        chunk = min(block, (SMEM_LIMIT - float_smem_bytes(block, 0, esz, gt, 0)
                            - 64) // (2 * k * (4 + esz)))
        while chunk < block and float_smem_bytes(block, k, esz, gt,
                                                 chunk + 1) <= SMEM_LIMIT:
            chunk += 1
        if chunk >= 1 or rb == 16:
            break
        rb //= 2                  # a narrower ring leaves the band more room
    _check(chunk >= 1, f"k={k} band slots do not fit the kernel's shared memory")
    smem = float_smem_bytes(block, k, esz, gt, chunk)
    if run is None:
        run = _run_for(n_blocks, -(-G // gt), smem, _FLOAT_THREADS)
    return FloatTiles(gt, run, chunk, smem)


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh copy when its data is not 16-byte aligned (the
    kernel stages the band with 16-byte copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def band_cross_float(local_idx, w, Zp, block: int) -> torch.Tensor:
    """cross[g] of one draw in bf16 / f32: Σ_i z1_i·lag_i, f32 lag.

    ``local_idx`` int32 [Npad, k]; ``w`` [Npad, k] and ``Zp``
    [(nb+2)·B, G], both bf16 or both f32. Returns f32 [G].
    """
    return band_cross_float_tiled(local_idx, w, Zp, block, None)


def band_cross_float_tiled(local_idx, w, Zp, block: int,
                           tiles: Optional[FloatTiles]) -> torch.Tensor:
    """:func:`band_cross_float` with the kernel's launch shape given
    (None: :func:`float_tiles`): for timing other launch shapes and for
    testing runs that do not divide the block count."""
    nb, k = _check_band(local_idx, w, (torch.bfloat16, torch.float32), Zp, block)
    _check(Zp.dtype == w.dtype, "w and Zp must share a dtype (bf16 or f32)")
    if Zp.device.type == "cpu":
        return band_cross_float_plain(local_idx, w, Zp, block)
    G = Zp.shape[1]
    if tiles is None:
        tiles = float_tiles(block, k, Zp.element_size(), G, nb)
    local_idx, w = _aligned16(local_idx), _aligned16(w)
    lib = build.load_library()
    with torch.cuda.device(Zp.device):
        partial = torch.empty((-(-nb // tiles.run), G), dtype=torch.float32,
                              device=Zp.device)
        err = lib.sct_band_cross_float(
            _ptr(local_idx), _ptr(w), _ptr(Zp), _ptr(partial), nb, block, k,
            G, int(Zp.dtype == torch.bfloat16), tiles.gt, tiles.run,
            tiles.chunk, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"band_cross_float launch failed: CUDA error {err}")
    LAUNCHES["float"] += 1
    # per-run partials reduce in a fixed order: no float atomics
    return partial.sum(dim=0)


class DenseTiles(NamedTuple):
    """Launch shape of the dense-band kernels (K5, K6)."""
    mt: int        #: band rows per CTA, staged once in shared memory
    stages: int    #: pipeline stages of two window slices (stages − 1 in flight)
    skip: bool     #: skip the 16×16 tiles of A that hold no weight
    smem: int      #: dynamic shared memory bytes (dense_smem_bytes)


#: the dense kernels' launch shapes built (``launch_shape`` in the
#: source): (rows a CTA, pipeline stages)
DENSE_SHAPES = ((32, 2), (32, 3), (32, 4), (16, 4), (64, 4))


def dense_smem_bytes(block: int, width: int, esz: int, mt: int,
                     stages: int) -> int:
    """Shared memory of a dense-band kernel (the layout in
    ``band_cross_dense.cu``): A's row tile [mt, width·B] with 16 spare bytes
    a row, the ring of ``stages`` stages of two slices [16, gt] (gt = 512
    bytes of genes, 16 spare), the row groups' sums [mt/16, gt] f32, the
    list's first rows, the 16×16 tile flags, the list and its length."""
    gt, pad = 512 // esz, 16 // esz
    return (_r16(mt * (width * block + pad) * esz)
            + stages * 2 * 16 * (gt + pad) * esz
            + (mt // 16) * gt * 4 + 4 * 68 + 4 * 64 + 2 * 68 + 16)


def dense_tiles(block: int, width: int, esz: int,
                shape: Optional[tuple] = None, skip: bool = True) -> DenseTiles:
    """Launch shape of K5 (``width`` 3) or K6 (4) for B = ``block`` and
    values of ``esz`` bytes: ``shape`` (mt, stages) one of
    :data:`DENSE_SHAPES`. By default 32 rows and the most stages that still
    let two CTAs share an SM (on the card, two CTAs an SM hide each other's
    latency better than deeper stages in one), or 4 stages where no shape
    lets them (f32 at large B: its row tile of A is twice the bytes).
    ``skip`` False multiplies every tile (for timing what the skip is
    worth)."""
    if shape is None:
        two = [st for st in (4, 3, 2) if 2 * (dense_smem_bytes(
            block, width, esz, 32, st) + 1024) <= _SM_SMEM]
        shape = (32, two[0] if two else 4)
    _check(tuple(shape) in DENSE_SHAPES,
           f"the dense kernels are built for the shapes {DENSE_SHAPES}, got {shape}")
    smem = dense_smem_bytes(block, width, esz, *shape)
    _check(smem <= SMEM_LIMIT, f"B={block} at the shape {shape} needs {smem} "
           f"bytes of shared memory")
    return DenseTiles(*shape, skip, smem)


def nonzero_tiles(A: torch.Tensor, rows: int = 16, cols: int = 16) -> int:
    """Tiles of ``rows`` × ``cols`` of the dense band ``A`` [nb, B, KA]
    (cut from each block's row 0 and column 0, a ragged last tile padded
    with zeros) that hold a nonzero weight: the tiles a skipping kernel
    multiplies."""
    nb, nr, KA = A.shape
    pr, pc = -nr % rows, -KA % cols
    nz = A.ne(0).to(torch.uint8)
    if pr or pc:
        nz = torch.nn.functional.pad(nz, (0, pc, 0, pr))
    return int(nz.reshape(nb, (nr + pr) // rows, rows, (KA + pc) // cols, cols)
               .amax(dim=(2, 4)).sum())


def _dense_launch(entry: str, mode: str, A, Zp, block: int, width: int,
                  plain, tiles: Optional[DenseTiles]) -> torch.Tensor:
    """Shared checks and launch of the two dense-band kernels."""
    _check(A.ndim == 3 and A.dtype in (torch.bfloat16, torch.float32),
           "A must be bf16 or f32 [nb, B, width·B]")
    nb, B = A.shape[0], A.shape[1]
    _check(B == block and tuple(A.shape) == (nb, B, width * B),
           f"A must be [nb, block, {width}·block]")
    _check(1 <= block <= MAX_BLOCK, f"block must be in [1, {MAX_BLOCK}]")
    _check(Zp.ndim == 2 and Zp.shape[0] == (nb + 2) * block,
           "Zp must be [(nb+2)·B, G]")
    _check(Zp.dtype == A.dtype, "A and Zp must share a dtype (bf16 or f32)")
    for t in (A, Zp):
        _check(t.device == Zp.device, "all operands must share one device")
        _check(t.is_contiguous(), "operands must be contiguous")
    _check(Zp.device.type in ("cpu", "cuda"), f"unsupported device {Zp.device}")
    if Zp.device.type == "cpu":
        return plain(A, Zp, block)
    _check(block % 16 == 0 and block <= DENSE_MAX_BLOCK,
           f"the dense kernels take a block that is a multiple of 16 up to "
           f"{DENSE_MAX_BLOCK}, got {block}")
    if tiles is None:
        tiles = dense_tiles(block, width, A.element_size())
    G = Zp.shape[1]
    A = _aligned16(A)
    lib = build.load_library()
    with torch.cuda.device(Zp.device):
        partial = torch.empty((nb * -(-block // tiles.mt), G),
                              dtype=torch.float32, device=Zp.device)
        err = getattr(lib, entry)(
            _ptr(A), _ptr(Zp), _ptr(partial), nb, block, G,
            int(Zp.dtype == torch.bfloat16), tiles.mt, tiles.stages,
            int(tiles.skip),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    LAUNCHES[mode] += 1
    # per-(block, row tile) partials reduce in a fixed order: no atomics
    return partial.sum(dim=0)


def band_cross_dense(A, Zp, block: int) -> torch.Tensor:
    """cross[g] of one draw on the dense band (Pallas K5's function).

    ``A`` [nb, B, 3B] and ``Zp`` [(nb+2)·B, G], both bf16 or both f32.
    Returns f32 [G]. On the card: ``B`` a multiple of 16, at most 256.
    """
    return band_cross_dense_tiled(A, Zp, block, None)


def band_cross_dense_tiled(A, Zp, block: int,
                           tiles: Optional[DenseTiles]) -> torch.Tensor:
    """:func:`band_cross_dense` with the kernel's launch shape given (None:
    :func:`dense_tiles`): for timing other shapes and the skip's worth."""
    return _dense_launch("sct_band_cross_dense", "dense", A, Zp, block, 3,
                         band_cross_dense_plain, tiles)


def band_cross_rot4(A4, Zp, block: int) -> torch.Tensor:
    """cross[g] of one draw on the rotation-baked band (Pallas K6's
    function): ``A4`` [nb, B, 4B] from ``ops.banded._build_band_rot4``,
    ``Zp`` [(nb+2)·B, G], both bf16 or both f32. Returns f32 [G]."""
    return band_cross_rot4_tiled(A4, Zp, block, None)


def band_cross_rot4_tiled(A4, Zp, block: int,
                          tiles: Optional[DenseTiles]) -> torch.Tensor:
    """:func:`band_cross_rot4` with the kernel's launch shape given (None:
    :func:`dense_tiles`)."""
    return _dense_launch("sct_band_cross_rot4", "rot4", A4, Zp, block, 4,
                         band_cross_rot4_plain, tiles)
