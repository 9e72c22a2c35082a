"""Banded permutation null for global Moran's I / Geary's C.

Port of the global part of ``spatialcore_tpu/ops/banded.py``:

1. Relabel cells along a Hilbert curve (or reverse Cuthill-McKee on the
   graph) so kNN edges become near-diagonal: with block size B, most edges
   connect cells within one block of each other (the *band*); the rest are
   a compact *far* edge list (:func:`build_null_plan`).
2. Each permutation draw is ONE Feistel row permutation composed with the
   relabel (``core.rng.feistel_apply``), ONE row gather of the value table,
   and one band+far cross product ``cross[g] = Σ_i z_i·lag_i[g]``.
3. Geary's C rides the same cross: Σ w (a−b)² = Σ (r_i+c_i)·z_i² − 2·cross.

The cross product is the hot loop. On a CUDA tensor it runs in the
hand-written Hopper kernels of ``kernels/band_cross.py`` (int8/int4:
``csrc/band_cross_int8.cu``, replacing the Pallas kernels K1–K3; bf16/f32:
``csrc/band_cross_float.cu``, replacing K4). ``band_impl="xla"`` selects
the plain PyTorch twins below instead, which keep the reference's dense
band layout ``A[nb, B, 3B]`` (``_plain`` suffix; counterparts of the
reference's ``_xla`` functions).

Determinism: every reduction has a fixed order and no float atomics are
used, so counts are bitwise reproducible run to run; draws are keyed by
their global index (``draw_offset``), so chunked runs equal unchunked ones.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..core.logging import get_logger
from ..core.rng import feistel_apply, fold_in, key_for
from ..kernels import band_cross as kern
from .graph import SpatialGraph

logger = get_logger("ops.banded")

#: elements of one [rows, G] temp in the plain twins' block chunks
_PLAIN_CHUNK_ELEMS = 1 << 27


# ---------------------------------------------------------------------------
# Orderings
# ---------------------------------------------------------------------------


def hilbert_order(coords: np.ndarray, bits: int = 16) -> np.ndarray:
    """Cell ordering along a Hilbert curve (host, float64 normalization).

    Returns ``order`` such that ``coords[order]`` walks the curve; ties
    (same grid cell) break by original index (stable argsort).
    """
    coords = np.asarray(coords, np.float64)
    if coords.ndim != 2 or coords.shape[1] != 2:
        raise ValueError("hilbert_order requires [N, 2] coordinates")
    mins = coords.min(axis=0)
    span = np.maximum(coords.max(axis=0) - mins, 1e-12)
    side = (1 << bits) - 1
    x = np.minimum((coords[:, 0] - mins[0]) / span[0] * (side + 1), side)
    y = np.minimum((coords[:, 1] - mins[1]) / span[1] * (side + 1), side)
    x = x.astype(np.uint64)
    y = y.astype(np.uint64)
    d = np.zeros(coords.shape[0], np.uint64)
    s = np.uint64(1) << np.uint64(bits - 1)
    one = np.uint64(1)
    while s > 0:
        rx = ((x & s) > 0).astype(np.uint64)
        ry = ((y & s) > 0).astype(np.uint64)
        d += s * s * ((np.uint64(3) * rx) ^ ry)
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f = np.where(flip, s - one - x, x)
        y_f = np.where(flip, s - one - y, y)
        x, y = np.where(swap, y_f, x_f), np.where(swap, x_f, y_f)
        s >>= one
    return np.argsort(d, kind="stable").astype(np.int64)


def graph_order(graph: SpatialGraph) -> np.ndarray:
    """Bandwidth-minimizing order from the graph alone (reverse Cuthill-McKee)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    csr = graph.to_csr()
    sym = csr + csr.T
    return np.asarray(reverse_cuthill_mckee(sym.tocsr(), symmetric_mode=True),
                      np.int64)


def _hilbert_rank_device(coords: torch.Tensor, bits: int = 16
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hilbert ordering on ``coords``' device, float32 normalization.

    Same arithmetic as the reference's ``_hilbert_rank_device`` (float32
    quantization, then integer xy2d); int64 holds the uint32 curve index.
    """
    n = coords.shape[0]
    mins = coords.min(dim=0).values
    span = torch.clamp_min(coords.max(dim=0).values - mins, 1e-12)
    side = (1 << bits) - 1
    x = torch.clamp_max((coords[:, 0] - mins[0]) / span[0] * (side + 1),
                        side).to(torch.int64)
    y = torch.clamp_max((coords[:, 1] - mins[1]) / span[1] * (side + 1),
                        side).to(torch.int64)
    d = torch.zeros(n, dtype=torch.int64, device=coords.device)
    for level in range(bits - 1, -1, -1):
        s = 1 << level
        rx = ((x & s) > 0).to(torch.int64)
        ry = ((y & s) > 0).to(torch.int64)
        d = d + s * s * ((3 * rx) ^ ry)
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f = torch.where(flip, s - 1 - x, x)
        y_f = torch.where(flip, s - 1 - y, y)
        x, y = torch.where(swap, y_f, x_f), torch.where(swap, x_f, y_f)
    order = torch.argsort(d, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=coords.device)
    return order, rank


def _plan_relabel(idx, w, order, rank, block: int):
    """Relabel edges into new positions; band split + Geary terms.

    The column sums ``c`` are accumulated in float64 (exact for these
    few-term sums, so independent of the scatter order of CUDA's
    ``index_add_``) and rounded once to float32.
    """
    n, k = idx.shape
    idx_r = rank[idx[order]]
    w_r = w[order]
    rows = torch.arange(n, device=idx.device)[:, None]
    rel = idx_r - (rows // block - 1) * block
    valid = w_r > 0
    inwin = (rel >= 0) & (rel < 3 * block) & valid
    far = valid & ~inwin
    local_idx = torch.where(inwin, rel, torch.zeros_like(rel))
    w_local = torch.where(inwin, w_r, torch.zeros_like(w_r)).to(torch.float32)
    r = w_r.to(torch.float64).sum(dim=1)
    c = torch.zeros(n, dtype=torch.float64, device=idx.device).index_add_(
        0, idx_r[valid], w_r[valid].to(torch.float64))
    rc = (r + c).to(torch.float32)
    n_pad = (-n) % block
    if n_pad:
        local_idx = torch.nn.functional.pad(local_idx, (0, 0, 0, n_pad))
        w_local = torch.nn.functional.pad(w_local, (0, 0, 0, n_pad))
        rc = torch.nn.functional.pad(rc, (0, n_pad))
    return idx_r, w_r, far, local_idx, w_local, rc


def _plan_far(idx_r, w_r, far, block: int, cap: int):
    """Compact the far-edge list (row-major) to a power-of-two capacity."""
    fi, fj = torch.nonzero(far, as_tuple=True)
    pad = cap - fi.numel()
    far_src = torch.nn.functional.pad(fi + block, (0, pad))
    far_dst = torch.nn.functional.pad(idx_r[fi, fj] + block, (0, pad))
    far_w = torch.nn.functional.pad(w_r[fi, fj].to(torch.float32), (0, pad))
    return far_src, far_dst, far_w


def _plan_far_runs(far_src, far_w, nb: int, block: int):
    """Run starts of each block in the compact far list: ``(starts [nb+1],
    max_run)``. The list is grouped by block by construction (row-major
    order, padding at the tail), so block n owns ``[starts[n], starts[n+1])``.
    """
    live = far_w > 0
    bn = torch.where(live, (far_src - block) // block,
                     torch.full_like(far_src, nb))
    starts = torch.searchsorted(
        bn, torch.arange(nb + 1, dtype=bn.dtype, device=bn.device))
    return starts, int((starts[1:] - starts[:-1]).max())


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _far_cap(n_far: int) -> int:
    return 1 << max(int(np.ceil(np.log2(max(n_far, 1)))), 7)


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


class NullPlan(NamedTuple):
    """Relabeled, band-split graph structure for the banded null.

    Index arrays (int64) live in new-order coordinates. ``local_idx`` is
    relative to each row's 3-block window start (b−1)·B ∈ [0, 3B); far-edge
    indices carry a +B offset into the front-padded ``Zp`` buffer. Block n's
    far edges are ``far_*[far_starts[n]:far_starts[n+1]]``.
    """

    order: torch.Tensor        # int64 [N] — original index at each new position
    local_idx: torch.Tensor    # int64 [Npad, k]
    w_local: torch.Tensor      # f32 [Npad, k] (0 where far/invalid/pad)
    far_src: torch.Tensor      # int64 [F] padded-coords row of far-edge source
    far_dst: torch.Tensor      # int64 [F]
    far_w: torch.Tensor        # f32 [F] (0 = padding)
    rc_sum: torch.Tensor       # f32 [Npad] row+col weight sums (Geary)
    block: int
    n: int
    rank: torch.Tensor = None  # int64 [N] — new position of each original cell
    far_starts: torch.Tensor = None  # int64 [nb+1]
    far_bmax: int = 0

    @property
    def n_padded(self) -> int:
        return self.local_idx.shape[0]


def build_null_plan(graph: SpatialGraph, coords=None, block: int = 256
                    ) -> NullPlan:
    """Relabel cells and split edges into band vs far list.

    A torch tensor ``coords`` [N, 2] builds the whole plan on its device
    (float32 Hilbert quantization, as the reference's device path,
    spatialcore_tpu/ops/banded.py:289-308). Numpy ``coords`` (or none, which
    orders by reverse Cuthill-McKee) takes the host path, bitwise equal to
    the reference's host path (:310-377); its tensors land on the graph's
    device.
    """
    dev = graph.neighbor_idx.device
    if (isinstance(coords, torch.Tensor) and coords.ndim == 2
            and coords.shape[1] == 2):
        n, k = graph.neighbor_idx.shape
        order, rank = _hilbert_rank_device(coords.to(device=dev,
                                                     dtype=torch.float32))
        idx_r, w_r, far, local_idx, w_local, rc = _plan_relabel(
            graph.neighbor_idx, graph.neighbor_w.to(torch.float32), order,
            rank, block)
        n_far = int(far.sum())
        logger.info(f"null plan (device): N={n:,} k={k} block={block} "
                    f"far_edges={n_far:,} ({n_far / (n * k):.2%})")
        far_src, far_dst, far_w = _plan_far(idx_r, w_r, far, block,
                                            _far_cap(n_far))
        nb = local_idx.shape[0] // block
        far_starts, bmax = _plan_far_runs(far_src, far_w, nb, block)
        return NullPlan(order=order, local_idx=local_idx, w_local=w_local,
                        far_src=far_src, far_dst=far_dst, far_w=far_w,
                        rc_sum=rc, block=block, n=n, rank=rank,
                        far_starts=far_starts, far_bmax=bmax)

    idx = graph.neighbor_idx.cpu().numpy()
    w = graph.neighbor_w.cpu().numpy().astype(np.float32)
    n, k = idx.shape
    if coords is not None and np.asarray(coords).shape[1] == 2:
        order = hilbert_order(np.asarray(coords))
    else:
        order = graph_order(graph)
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n, dtype=np.int64)

    idx_r = rank[idx[order]]
    w_r = w[order]
    rows = np.arange(n, dtype=np.int64)[:, None]
    rel = idx_r - (rows // block - 1) * block
    valid = w_r > 0
    inwin = (rel >= 0) & (rel < 3 * block) & valid
    far = valid & ~inwin
    n_far = int(far.sum())
    logger.info(f"null plan: N={n:,} k={k} block={block} "
                f"far_edges={n_far:,} ({n_far / max(valid.sum(), 1):.2%})")
    local_idx = np.where(inwin, rel, 0).astype(np.int64)
    w_local = np.where(inwin, w_r, 0.0).astype(np.float32)

    fi, fj = np.nonzero(far)                     # row-major: deterministic
    pad = _far_cap(n_far) - n_far
    far_src = np.pad((fi + block).astype(np.int64), (0, pad))
    far_dst = np.pad((idx_r[fi, fj] + block).astype(np.int64), (0, pad))
    far_wv = np.pad(w_r[fi, fj].astype(np.float32), (0, pad))

    r = w_r.sum(axis=1)
    c = np.zeros(n, np.float64)
    np.add.at(c, idx_r[valid], w_r[valid])
    rc = (r + c).astype(np.float32)

    n_pad = (-n) % block
    if n_pad:
        local_idx = np.pad(local_idx, ((0, n_pad), (0, 0)))
        w_local = np.pad(w_local, ((0, n_pad), (0, 0)))
        rc = np.pad(rc, (0, n_pad))
    nb = local_idx.shape[0] // block
    bcnt = np.bincount((far_src[:n_far] - block) // block, minlength=nb)
    far_starts = np.concatenate([[0], np.cumsum(bcnt)]).astype(np.int64)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return NullPlan(order=t(order), local_idx=t(local_idx), w_local=t(w_local),
                    far_src=t(far_src), far_dst=t(far_dst), far_w=t(far_wv),
                    rc_sum=t(rc), block=block, n=n, rank=t(rank),
                    far_starts=t(far_starts),
                    far_bmax=int(bcnt.max()) if n_far else 0)


def plan_from_numpy(plan, device: Union[str, torch.device] = "cuda") -> NullPlan:
    """Port plan from a reference ``NullPlan``'s fields (copied to the host).

    Carries one plan across the two packages, so both run the same relabel
    and band/far split. Index arrays become int64, weights float32.
    """
    def idx(a):
        return None if a is None else torch.as_tensor(
            np.asarray(a).astype(np.int64), device=device)

    def f32(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    return NullPlan(order=idx(plan.order), local_idx=idx(plan.local_idx),
                    w_local=f32(plan.w_local), far_src=idx(plan.far_src),
                    far_dst=idx(plan.far_dst), far_w=f32(plan.far_w),
                    rc_sum=f32(plan.rc_sum), block=int(plan.block),
                    n=int(plan.n), rank=idx(plan.rank),
                    far_starts=idx(plan.far_starts),
                    far_bmax=int(plan.far_bmax or 0))


# ---------------------------------------------------------------------------
# Operator: band tensors, quantization, far packing
# ---------------------------------------------------------------------------


def _build_band(local_idx, w_local, block: int, dtype) -> torch.Tensor:
    """Dense band tensor A[nb, B, 3B] (the plain twins' layout).

    Duplicate slots add up; padding and far slots carry weight 0.
    """
    nb = local_idx.shape[0] // block
    k = local_idx.shape[1]
    A = torch.zeros((nb, block, 3 * block), dtype=dtype, device=local_idx.device)
    return A.scatter_add_(2, local_idx.reshape(nb, block, k),
                          w_local.reshape(nb, block, k).to(dtype))


def _band_codes_i8(local_idx, w_local, block: int, row_scale=None):
    """Compact int8 band weight codes ``wq [Npad, k]`` and row scales.

    sw[n, b] = rowmax/127, wq = round(w/sw) clipped to [0, 127]: for
    row-normalized kNN (k equal weights) every code is exactly 127.
    ``row_scale`` ([nb, B, 1]) overrides the band-local rowmax (the
    windowed-far system passes the full-row max so far weights don't clip).
    Returns ``(wq int8 [Npad, k], sw f32 [nb, B, 1])``.
    """
    nb = local_idx.shape[0] // block
    k = local_idx.shape[1]
    lw3 = w_local.reshape(nb, block, k).to(torch.float32)
    if row_scale is None:
        rowmax = lw3.max(dim=2, keepdim=True).values
        sw = torch.where(rowmax > 0, rowmax / 127.0, torch.ones_like(rowmax))
    else:
        sw = row_scale
    wq = torch.clamp(torch.round(lw3 / sw), 0, 127).to(torch.int8)
    return wq.reshape(nb * block, k), sw


def _build_band_i8(local_idx, w_local, block: int, row_scale=None):
    """int8 dense band ``A8 [nb, B, 3B]`` and row scale ``sw [nb, B, 1]``.

    Entries accumulate in int8 as in the reference (distinct neighbours
    never share a column, so no entry exceeds 127).
    """
    wq, sw = _band_codes_i8(local_idx, w_local, block, row_scale)
    return _build_band(local_idx, wq, block, torch.int8), sw


def _quantize_z(Z: torch.Tensor, clip: float = 8.0):
    """Per-gene symmetric int8 quantization: ``(Zq int8, s f32 [G])``.

    s_g = min(max|z_g|, clip)/127; values beyond ±clip·σ saturate.
    """
    Zf = Z.to(torch.float32)
    s = torch.clamp_max(Zf.abs().max(dim=0).values, clip) / 127.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    Zq = torch.clamp(torch.round(Zf / s), -127, 127).to(torch.int8)
    return Zq, s


def _quantize_z4_codes(Z: torch.Tensor, clip: float = 8.0):
    """int4 codes without packing: ``(codes int8 in [-7, 7], s f32 [G])``."""
    Zf = Z.to(torch.float32)
    s = torch.clamp_max(Zf.abs().max(dim=0).values, clip) / 7.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    return torch.clamp(torch.round(Zf / s), -7, 7).to(torch.int8), s


def _pack_codes(codes: torch.Tensor, lo: Optional[torch.Tensor] = None):
    """Pack int4 codes into split-half nibble bytes (inverse of
    :func:`_unpack_nibbles`).

    One-arg form: codes [N, G] (G even) → [N, G//2] with gene j in the HIGH
    nibble of packed column j and gene j + G//2 in the LOW nibble. Two-arg
    form packs two same-shape blocks. Bytes hold (c+8) nibbles; the
    arithmetic runs in uint8 (one byte per value, wrapping shift).
    """
    if lo is None:
        G = codes.shape[-1]
        if G % 2:
            raise ValueError(f"int4 packing needs an even gene count, got {G}")
        hi, lo = codes[..., :G // 2], codes[..., G // 2:]
    else:
        hi = codes
        if hi.shape != lo.shape:
            raise ValueError(f"hi/lo shape mismatch: {tuple(hi.shape)} vs "
                             f"{tuple(lo.shape)}")
    h8 = (hi + 8).to(torch.uint8) << 4
    return (h8 | (lo + 8).to(torch.uint8)).view(torch.int8)


def _quantize_z4(Z: torch.Tensor, clip: float = 8.0):
    """Per-gene int4 quantization, nibble-packed: ``(Zpk int8 [N, G//2], s)``."""
    codes, s = _quantize_z4_codes(Z, clip)
    return _pack_codes(codes), s


#: int8 packed [..., Gp2] → int8 codes [..., 2·Gp2] (split-half layout)
_unpack_nibbles = kern.unpack_nibbles


def _win_far_pack(far_src, far_dst, far_w, far_q, far_starts, rows_idx,
                  B: int, far_bmax: int):
    """Pack the compact far list into the reference's windowed operands.

    Returns ``(S, nw, rowp, qp, rif, w_idx, starts0, runs)`` as the
    reference's ``_win_far_pack``: ``rowp``/``qp`` [nw, 1, S] hold each far
    entry's row in its block and its int8 weight code; ``rif`` are the
    original-space rows of each far target (per draw the caller gathers
    ``Zq[perm∘rif]``; padding gathers row 0 with weight code 0). The
    Hopper kernel reads the same compact list through row pointers
    (:func:`_far_row_ptr`) instead of the S-row windows.
    """
    S = _round_up(max(int(far_bmax), 1), 128)
    F = far_src.shape[0]
    nw = -(-F // S) + 2
    pad = nw * S - F
    pad1 = lambda a: torch.nn.functional.pad(a, (0, pad))  # noqa: E731
    rowp = pad1(torch.where(far_w > 0, (far_src - B) % B,
                            torch.zeros_like(far_src))).reshape(nw, 1, S)
    qp = pad1(torch.clamp(far_q, 0, 127).to(torch.int8)).reshape(nw, 1, S)
    rif = rows_idx[pad1(far_dst)]
    w_idx = far_starts[:-1] // S
    starts0 = far_starts[:-1]
    runs = far_starts[1:] - far_starts[:-1]
    return S, nw, rowp, qp, rif, w_idx, starts0, runs


def _far_row_ptr(far_src, far_starts, block: int, n_padded: int) -> torch.Tensor:
    """CSR row pointers [Npad+1] (int32) over the compact far list.

    Entry e < far_starts[-1] adds into padded row ``far_src[e] − B``. Both
    plan builders emit the list in row-major order, so these rows are
    non-decreasing and row r's entries are ``[ptr[r], ptr[r+1])``; a list
    in any other order is refused (one flag read back per call).
    """
    n_live = int(far_starts[-1])
    rows = far_src[:n_live] - block
    if n_live > 1 and bool((rows[1:] < rows[:-1]).any()):
        raise ValueError("far-edge list is not sorted by source row; "
                         "rebuild the plan with build_null_plan")
    ptr = torch.searchsorted(rows, torch.arange(n_padded + 1, device=rows.device,
                                                dtype=rows.dtype))
    return ptr.to(torch.int32)


# ---------------------------------------------------------------------------
# Plain twins of the band-cross kernels (dense band layout)
# ---------------------------------------------------------------------------


def _block_chunks(nb: int, B: int, G: int):
    """Block ranges [n0, n1) whose [rows, G] temps stay bounded."""
    step = max(1, _PLAIN_CHUNK_ELEMS // max(B * G, 1))
    return [(n0, min(n0 + step, nb)) for n0 in range(0, nb, step)]


def _band_lag_dense(A, Zp, n0: int, n1: int) -> torch.Tensor:
    """Band lag of blocks [n0, n1) as float32 [(n1−n0)·B, G].

    int8 operands are widened to float32: every lag is exact there. A row
    has at most k nonzero weight codes ≤ 127 times value codes ≤ 127, so
    |lag| ≤ k·127² < 2²⁴ for k < 1040 and every partial sum is an exactly
    representable integer — the plain lags and the kernel's int32 lags
    compare bitwise. (float32 matmul must not run in TF32, PyTorch's
    default on CUDA.)
    """
    B = A.shape[1]
    lag = None
    for s in range(3):
        part = torch.bmm(A[n0:n1, :, s * B:(s + 1) * B].to(torch.float32),
                         Zp[n0 + s:n1 + s].to(torch.float32))
        lag = part if lag is None else lag + part
    return lag.reshape((n1 - n0) * B, -1)


def _far_dst(starts, runs, rowp, nb: int, B: int) -> torch.Tensor:
    """Destination padded row of every compact far entry (reference's
    ``blk_of`` construction: the owner of a position is the LAST block whose
    run starts at or before it)."""
    F = rowp.numel()
    marks = torch.zeros(F + 1, dtype=torch.int64, device=rowp.device)
    marks.index_add_(0, starts.clamp_max(F),
                     torch.ones_like(starts, dtype=torch.int64))
    blk_of = torch.cumsum(marks[:F], 0) - 1
    return blk_of.clamp(0, nb - 1) * B + rowp.reshape(-1)


def _band_lag_win_i8_plain(w_idx, starts, runs, A8, Zp8, Zf, rowp, qp,
                           n0: int = 0, n1: Optional[int] = None
                           ) -> torch.Tensor:
    """Integer band + windowed-far lag of blocks [n0, n1) (float32 holding
    integers). Far entry e adds q_e·zf_e into its destination row; entries
    outside every run carry weight code 0 and are skipped."""
    nb, B, _ = A8.shape
    n1 = nb if n1 is None else n1
    G = Zp8.shape[2]
    lag = _band_lag_dense(A8, Zp8, n0, n1)
    dst = _far_dst(starts, runs, rowp, nb, B)
    q = qp.reshape(-1)
    sel = (dst >= n0 * B) & (dst < n1 * B) & (q != 0)
    vals = Zf.reshape(-1, G)[:q.numel()][sel].to(torch.float32) * q[sel][:, None]
    # integer-valued float32 adds: exact in any order (bound above)
    return lag.index_add_(0, dst[sel] - n0 * B, vals)


def _chunked_cross(Zp, B: int, lag_fn, sw=None) -> torch.Tensor:
    """Σ_i (sw_i)·z1_i·lag_i over blocks in bounded chunks; ``lag_fn(n0, n1)``
    gives the float32 lag of blocks [n0, n1)."""
    nb, G = Zp.shape[0] - 2, Zp.shape[2]
    z1 = Zp.reshape(-1, G)[B:B + nb * B]
    cross = torch.zeros(G, dtype=torch.float32, device=Zp.device)
    for n0, n1 in _block_chunks(nb, B, G):
        t = z1[n0 * B:n1 * B].to(torch.float32)
        if sw is not None:
            t = sw.reshape(-1, 1)[n0 * B:n1 * B] * t
        cross += (t * lag_fn(n0, n1)).sum(dim=0)
    return cross


def _band_cross_win_i8_plain(w_idx, starts, runs, A8, sw, Zp8, Zf, rowp, qp
                             ) -> torch.Tensor:
    """Plain twin of the int8/int4 windowed-far kernels (K1/K2): cross_q[g]
    in z_q·w_q units = Σ_i sw_i·z1_i·(band + far lag)_i."""
    return _chunked_cross(Zp8, A8.shape[1], lambda n0, n1: _band_lag_win_i8_plain(
        w_idx, starts, runs, A8, Zp8, Zf, rowp, qp, n0, n1), sw)


def _band_cross_i8_plain(A8, sw, Zp8) -> torch.Tensor:
    """Plain twin of the int8 band-only kernel (K3): Σ_i sw_i·z1_i·lag_i."""
    return _chunked_cross(Zp8, A8.shape[1],
                          lambda n0, n1: _band_lag_dense(A8, Zp8, n0, n1), sw)


def _band_cross_float_plain(A, Zp) -> torch.Tensor:
    """Plain twin of the float band kernel (K4): Σ_i z1_i·lag_i with the lag
    accumulated in float32 from bf16/f32 operands (the Pallas kernel's
    precision; the reference's XLA path rounds the lag to the table dtype)."""
    return _chunked_cross(Zp, A.shape[1],
                          lambda n0, n1: _band_lag_dense(A, Zp, n0, n1))


# ---------------------------------------------------------------------------
# One draw's statistic
# ---------------------------------------------------------------------------


def _finish_stat(cross, sq_fn, den, S0: float, n: int, stat: str):
    """Turn the draw's cross term into Moran's I or Geary's C."""
    if stat == "moran":
        return (n / S0) * cross / den
    return (n - 1) * (sq_fn() - 2.0 * cross) / (2.0 * S0 * den)


class _IntOps(NamedTuple):
    """Per-call operands of the int8/int4 null system."""

    packed: bool
    win: bool
    block: int
    nb: int
    local_idx32: torch.Tensor   # int32 [Npad, k]  (kernel)
    wq: torch.Tensor            # int8 [Npad, k]   (kernel)
    sw: torch.Tensor            # f32 [nb, B, 1]
    A8: Optional[torch.Tensor]  # int8 [nb, B, 3B] (plain twin only)
    far_ptr: Optional[torch.Tensor]   # int32 [Npad+1] (kernel, win)
    win_ops: Optional[tuple]    # (S, nw, rowp, qp, w_idx, starts0, runs)
    far_exact: Optional[tuple]  # (far_src, far_dst, far_w) for far_mode=exact


def _banded_stat_int(ops: _IntOps, rc_sum, Ztab, sz2, den, S0, rows, rowsf,
                     *, n: int, stat: str, use_plain: bool):
    """One draw's statistic in the int8 (``Ztab`` codes) or int4
    (``Ztab`` nibble-packed bytes) null system.

    Covers the reference's ``_banded_stat_i4_win``, ``_banded_stat_i8_win``
    and ``_banded_stat_i8``: band products are exact integers scaled by the
    row scale sw; windowed far edges ride the same integer lag, exact far
    edges are added in float32 outside the kernel; one sz² converts back
    to z units.
    """
    B, nb = ops.block, ops.nb
    Zp = Ztab[rows]                                  # ONE random row gather
    Zf = Ztab[rowsf] if ops.win else None            # compact far gather
    if use_plain:
        unpack = _unpack_nibbles if ops.packed else (lambda t: t)
        Zp3 = unpack(Zp).reshape(nb + 2, B, -1)
        if ops.win:
            S, nw, rowp, qp, w_idx, starts0, runs = ops.win_ops
            cross_q = _band_cross_win_i8_plain(
                w_idx, starts0, runs, ops.A8, ops.sw, Zp3,
                unpack(Zf).reshape(nw, S, -1), rowp, qp)
        else:
            cross_q = _band_cross_i8_plain(ops.A8, ops.sw, Zp3)
    else:
        far = {}
        if ops.win:
            far = dict(far_row_ptr=ops.far_ptr,
                       far_q=ops.win_ops[3].reshape(-1), Zf=Zf)
        cross_q = kern.band_cross_int8(ops.local_idx32, ops.wq,
                                       ops.sw.reshape(-1), Zp, B,
                                       packed=ops.packed, **far)
    if ops.far_exact is not None:
        far_src, far_dst, far_w = ops.far_exact
        cross_q = cross_q + (far_w[:, None] * Zp[far_src].to(torch.float32)
                             * Zp[far_dst].to(torch.float32)).sum(dim=0)

    def sq():
        z1 = Zp[B:B + nb * B]
        z1 = (_unpack_nibbles(z1) if ops.packed else z1).to(torch.float32)
        return rc_sum @ (z1 * z1 * sz2)

    return _finish_stat(cross_q * sz2, sq, den, S0, n, stat)


def _banded_stat_float(local_idx32, w_c, A, far_src, far_dst, far_w, rc_sum,
                       Ztab, den, S0, rows, *, block: int, n: int, stat: str,
                       use_plain: bool):
    """One draw's statistic in bf16/f32 (reference ``_banded_stat``).

    The far-edge einsum stays in the table dtype with float32 accumulation,
    as in the reference.
    """
    B = block
    nb = local_idx32.shape[0] // B
    G = Ztab.shape[1]
    Zp = Ztab[rows]                                  # ONE random row gather
    if use_plain:
        cross = _band_cross_float_plain(A, Zp.reshape(nb + 2, B, G))
    else:
        cross = kern.band_cross_float(local_idx32, w_c, Zp, B)
    fs = Zp[far_src].to(torch.float32)
    ft = Zp[far_dst].to(torch.float32)
    fw = far_w.to(Zp.dtype).to(torch.float32)
    cross = cross + (fw[:, None] * fs * ft).sum(dim=0)

    def sq():
        z1 = Zp[B:B + nb * B].to(torch.float32)
        return rc_sum @ (z1 * z1)

    return _finish_stat(cross, sq, den, S0, n, stat)


# ---------------------------------------------------------------------------
# Draw loop
# ---------------------------------------------------------------------------


def _extreme(v, o, alt: str):
    if alt == "greater":
        return v >= o
    if alt == "less":
        return v <= o
    return v.abs() >= o.abs()


def _int_ops(plan: NullPlan, precision: str, far_mode: str, rows_idx,
             use_plain: bool):
    """Build the int8/int4 operator once per call: band codes, row scales
    and (windowed far) the packed far operands. Returns (ops, rif)."""
    block = plan.block
    nbb = plan.n_padded // block
    win = far_mode == "win"
    rif = None
    far_ptr = win_ops = far_exact = None
    if win:
        # full-row weight scale (band + far rowmax) so far codes don't clip
        local_max = plan.w_local.max(dim=1).values
        live = plan.far_w > 0
        far_max = torch.zeros(plan.n_padded, dtype=torch.float32,
                              device=plan.w_local.device).scatter_reduce_(
            0, plan.far_src[live] - block, plan.far_w[live], "amax")
        rowmax = torch.maximum(local_max, far_max)
        sw_row = torch.where(rowmax > 0, rowmax / 127.0, torch.ones_like(rowmax))
        wq, sw = _band_codes_i8(plan.local_idx, plan.w_local, block,
                                row_scale=sw_row.reshape(nbb, block, 1))
        far_q = torch.clamp(torch.round(
            plan.far_w / sw_row[(plan.far_src - block).clamp_min(0)]), 0, 127)
        S, nw, rowp, qp, rif, w_idx, starts0, runs = _win_far_pack(
            plan.far_src, plan.far_dst, plan.far_w, far_q, plan.far_starts,
            rows_idx, block, plan.far_bmax)
        win_ops = (S, nw, rowp, qp, w_idx, starts0, runs)
        if not use_plain:
            far_ptr = _far_row_ptr(plan.far_src, plan.far_starts, block,
                                   plan.n_padded)
    else:
        wq, sw = _band_codes_i8(plan.local_idx, plan.w_local, block)
        far_exact = (plan.far_src, plan.far_dst, plan.far_w)
    A8 = _build_band(plan.local_idx, wq, block, torch.int8) if use_plain else None
    ops = _IntOps(packed=precision == "int4", win=win, block=block, nb=nbb,
                  local_idx32=plan.local_idx.to(torch.int32), wq=wq, sw=sw,
                  A8=A8, far_ptr=far_ptr, win_ops=win_ops, far_exact=far_exact)
    return ops, rif


def _banded_test(plan: NullPlan, Z, S0, observed, seed: int, den, sz,
                 draw0: int, *, n_permutations: int, stat: str, alternative,
                 precision: str, use_plain: bool, far_mode: str):
    """The draw loop: Feistel rows → row gather → band cross → counts.

    A Python loop over draws with three on-device accumulators (extreme
    count, Σ value, Σ value²), the reference's ``lax.scan`` carry.
    """
    n, block = plan.n, plan.block
    prepacked = precision == "int4" and Z.dtype == torch.int8
    if den is None:
        if prepacked:
            if sz is None:
                raise ValueError("int4 Z requires its per-gene scale `sz`")
            codes = _unpack_nibbles(Z).to(torch.float32)
            den = (codes * codes).sum(dim=0) * sz * sz
        else:
            den = (Z.to(torch.float32) ** 2).sum(dim=0)
            if precision == "int8" and Z.dtype == torch.int8:
                if sz is None:
                    raise ValueError("int8 Z requires its per-gene scale `sz`")
                den = den * sz * sz
        den = torch.where(den > 0, den, torch.ones_like(den))
    G = Z.shape[1] * (2 if prepacked else 1)
    nbb = plan.n_padded // block
    # padded row-relabel indices, fixed across draws: per draw the value
    # rows are Z[perm[rows_idx]] — one Feistel evaluation + one row gather
    gidx = torch.clamp(torch.arange((nbb + 2) * block, device=Z.device) - block,
                       0, n - 1)
    rows_idx = plan.order[gidx]
    if not use_plain and bool(((plan.local_idx < 0)
                               | (plan.local_idx >= 3 * block)).any()):
        raise ValueError("plan.local_idx must lie in [0, 3·block)")
    rif = None
    if precision in ("int8", "int4"):
        if precision == "int4":
            Ztab, s_z = (Z, sz) if prepacked else _quantize_z4(Z)
        elif Z.dtype == torch.int8:
            if sz is None:
                raise ValueError("int8 Z requires its per-gene scale `sz`")
            Ztab, s_z = Z, sz
        else:
            Ztab, s_z = _quantize_z(Z)
        sz2 = s_z * s_z
        ops, rif = _int_ops(plan, precision, far_mode, rows_idx, use_plain)

        def stat_fn(rows, rowsf):
            return _banded_stat_int(ops, plan.rc_sum, Ztab, sz2, den, S0, rows,
                                    rowsf, n=n, stat=stat, use_plain=use_plain)

        # draws compare against the observed value of the SAME quantized
        # operator (identity placement)
        observed = stat_fn(rows_idx, rif)
    else:
        wdt = torch.bfloat16 if precision == "bf16" else Z.dtype
        Ztab = Z if Z.dtype == wdt else Z.to(wdt)
        w_c = plan.w_local.to(wdt)
        A = _build_band(plan.local_idx, w_c, block, wdt) if use_plain else None
        local_idx32 = plan.local_idx.to(torch.int32)

        def stat_fn(rows, rowsf=None):
            return _banded_stat_float(local_idx32, w_c, A, plan.far_src,
                                      plan.far_dst, plan.far_w, plan.rc_sum,
                                      Ztab, den, S0, rows, block=block, n=n,
                                      stat=stat, use_plain=use_plain)

    base = key_for(seed, "perm_feistel", 0)
    idx_all = rows_idx if rif is None else torch.cat([rows_idx, rif])
    L = rows_idx.shape[0]
    count = torch.zeros(G, dtype=torch.int32, device=Z.device)
    s1 = torch.zeros(G, dtype=torch.float32, device=Z.device)
    s2 = torch.zeros(G, dtype=torch.float32, device=Z.device)
    for step in range(n_permutations):
        key = fold_in(base, step + draw0)
        perm_rows = feistel_apply(key, idx_all, n)
        vals = stat_fn(perm_rows[:L], perm_rows[L:] if rif is not None else None)
        count += _extreme(vals, observed, alternative).to(torch.int32)
        s1 += vals
        s2 += vals * vals
    P = n_permutations
    p = (count + 1.0) / (P + 1.0)
    mean = s1 / P
    var = torch.clamp_min(s2 / P - mean ** 2, 0.0)
    return p, mean, torch.sqrt(var)


_KERNEL_IMPLS = ("auto", "pallas_halo")


def banded_permutation_test(
    plan: NullPlan,
    Z: torch.Tensor,
    S0: float,
    observed: torch.Tensor,
    seed: int,
    n_permutations: int,
    stat: str = "moran",
    alternative: str = "greater",
    precision: str = "bf16",
    perm_method: str = "feistel",
    band_impl: str = "auto",
    den: Optional[torch.Tensor] = None,
    sz: Optional[torch.Tensor] = None,
    draw_offset: int = 0,
    far_mode: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Monte-Carlo p-values, null mean and null std of a global statistic.

    Port of the reference's ``banded_permutation_test``; draws are bitwise
    the reference's Feistel stream, keyed at global indices
    ``[draw_offset, draw_offset + n_permutations)`` so chunked runs
    reproduce the unchunked run bitwise.

    ``band_impl``: "auto" (or "pallas_halo", the reference's name for the
    same kernels) runs the band cross through ``kernels.band_cross`` —
    the hand-written Hopper kernel on a CUDA tensor, its plain version on a
    CPU tensor; "xla" runs the plain dense-band twins on any device.
    "pallas" and "pallas_halo4" (Pallas kernels K5, K6) are not ported.

    ``precision``: "bf16" (default), "f32", "int8" (per-gene int8 codes,
    exact integer band dots) or "int4" (nibble-packed codes, windowed far
    only). For int8, ``far_mode="auto"`` means "win" whenever the plan has
    its far-run structure. Integer draws compare against the observed
    value of the same quantized operator (``observed`` is ignored).
    """
    if perm_method == "sort":
        raise NotImplementedError(
            "perm_method='sort' draws with jax.random.permutation, which is "
            "not ported yet (ROADMAP Queue 1 item 4, the slot null)")
    if perm_method != "feistel":
        raise ValueError("perm_method must be 'feistel' or 'sort', "
                         f"got {perm_method!r}")
    if band_impl in ("pallas", "pallas_halo4"):
        raise NotImplementedError(
            f"band_impl={band_impl!r} (Pallas kernel "
            f"{'K5' if band_impl == 'pallas' else 'K6'}) is not ported yet "
            "(ROADMAP Queue 2); 'auto' runs the Hopper kernel")
    if band_impl not in _KERNEL_IMPLS + ("xla",):
        raise ValueError(f"unknown band_impl {band_impl!r}")
    if precision not in ("bf16", "f32", "int8", "int4"):
        raise ValueError(f"unknown precision {precision!r}")
    use_plain = band_impl == "xla"
    prepacked = precision == "int4" and Z.dtype == torch.int8
    G = Z.shape[1] * (2 if prepacked else 1)
    has_runs = plan.far_starts is not None and plan.far_bmax > 0
    if precision not in ("int8", "int4") and far_mode == "win":
        raise ValueError("far_mode='win' requires precision='int8'/'int4' "
                         "(the windowed far operator is int8-quantized)")
    if precision == "int4":
        if not has_runs:
            raise ValueError(
                "precision='int4' needs a NullPlan with far-run structure "
                "(far_starts/far_bmax); rebuild via build_null_plan")
        if far_mode == "exact":
            raise ValueError("precision='int4' has no exact-far path; use "
                             "far_mode='win' (or 'auto')")
        far_mode = "win"
        # each packed half holds whole 128-gene groups -> 256-multiple G
        pad_g = (-G) % 256
        if prepacked and pad_g:
            raise ValueError(
                f"pre-packed int4 tables must cover a 256-multiple gene "
                f"count, got G={G}")
    elif precision == "int8":
        if far_mode == "auto":
            far_mode = "win" if has_runs else "exact"
        if far_mode == "win" and not has_runs:
            raise ValueError("far_mode='win' needs a NullPlan with far-run "
                             "structure (far_starts/far_bmax); rebuild the "
                             "plan with ops.banded.build_null_plan")
        pad_g = (-G) % 128   # int8 kernel columns come in 4-byte words
    else:
        far_mode = "exact"
        pad_g = 0
    if stat not in ("moran", "geary"):
        raise ValueError(f"stat must be 'moran' or 'geary' (the fused "
                         f"'moran_geary' pass is not ported yet), got {stat!r}")
    if pad_g:
        Z = torch.nn.functional.pad(Z, (0, pad_g))
        observed = torch.nn.functional.pad(observed, (0, pad_g))
        if den is not None:
            den = torch.nn.functional.pad(den, (0, pad_g), value=1.0)
        if sz is not None:
            sz = torch.nn.functional.pad(sz, (0, pad_g), value=1.0)
    p, mean, std = _banded_test(
        plan, Z, S0, observed, int(seed) & 0xFFFFFFFF, den, sz,
        int(draw_offset), n_permutations=n_permutations, stat=stat,
        alternative=alternative, precision=precision, use_plain=use_plain,
        far_mode=far_mode)
    if pad_g:
        p, mean, std = p[:G], mean[:G], std[:G]
    return p, mean, std
