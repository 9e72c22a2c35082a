"""Banded permutation nulls: global Moran's I / Geary's C, and the local
statistics (local Moran, local Geary, Getis-Ord, Lee's L).

Port of the global part and of the local Moran (LISA) part of
``spatialcore_tpu/ops/banded.py``:

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
``csrc/band_cross_float.cu`` on the compact band, replacing K4, and
``csrc/band_cross_dense.cu`` on the dense band ``A[nb, B, 3B]`` or its
rotation-baked form ``A4[nb, B, 4B]``, replacing K5 and K6 behind
``band_impl="pallas"`` and ``"pallas_halo4"``); the bf16/f32 null's
far-edge cross and Geary's degree term in one more launch a draw
(``kernels/global_terms.py``, ``csrc/global_terms.cu``). ``band_impl="xla"``
selects the plain PyTorch twins below instead, which keep the reference's
dense band layout (``_plain`` suffix; counterparts of the reference's
``_xla`` functions). Draws come from the Feistel stream, or with
``perm_method="sort"`` from ``core.rng.permutation`` (the slot null's
``jax.random.permutation`` stream). ``stat="moran_geary"`` counts both
statistics from one gather and one cross per draw.

LISA (:func:`banded_local_moran`, :func:`banded_local_moran_pvalues`): the
same relabel and draws, but the statistic is per cell. In the int8 system
each draw step is ``count += |z·lag| ≥ obs`` over exact integers, on a CUDA
tensor in the hand-written kernel of ``kernels/lisa_count.py``
(``csrc/lisa_count_int8.cu``, replacing Pallas K7's moran tail and K8).
Departure from the reference: ``band_impl="auto"`` always takes that kernel
on a CUDA tensor (row-pointer far edges, or the dense far layer when the
plan has no run structure); the reference's auto rule drops to XLA beyond
the TPU kernels' VMEM limits (far_bmax > 1024), which a row-pointer read
does not have. The counts are bitwise equal either way. The bf16 / f32
LISA null's draw step (float32 lag, ``|z·lag| ≥ obs`` against the exact
observed |I|) runs on a CUDA tensor in the hand-written kernel of
``kernels/lisa_float.py`` (``csrc/lisa_float.cu``; the reference has XLA
ops there), rounding where its torch-op plain version does.

Lee's L (:func:`banded_lees_l`) permutes only the y column of each gene
pair; its int8 draw step adds the per-block partials of the global L,
which :func:`_tree_sum` reduces in one fixed pairwise order on every
device. Its draws come from the Feistel stream, or with
``perm_method="sort"`` from ``core.rng.permutation`` (``jax.random.
permutation``, bitwise), the direct null's stream.

Determinism: every reduction has a fixed order and no float atomics are
used, so counts are bitwise reproducible run to run; draws are keyed by
their global index (``draw_offset``), so chunked runs equal unchunked ones.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..core.logging import get_logger
from ..core.rng import feistel_apply, fold_in, key_for, permutation
from ..kernels import band_cross as kern
from ..kernels import global_terms as kern_terms
from ..kernels import lisa_count as kern_lisa
from ..kernels import lisa_float as kern_float
from ..utils.profiling import count, read_back, set_count, span, traced
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


def _count_plan(n: int, k: int, n_live: int, n_far: int) -> None:
    """The plan's sizes as counters: rows (cells), slots (rows × k), live
    slots (edges of weight > 0, band and far) and far edges. A radius
    graph's slots past a cell's degree are dead: 1 − live / slots."""
    set_count("plan.rows", n)
    set_count("plan.slots", n * k)
    set_count("plan.live_slots", n_live)
    set_count("plan.far_edges", n_far)


@traced("ops.banded.build_null_plan")
def build_null_plan(graph: SpatialGraph, coords=None, block: int = 256
                    ) -> NullPlan:
    """Relabel cells and split edges into band vs far list.

    A torch tensor ``coords`` [N, 2] builds the whole plan on its device
    (float32 Hilbert quantization, as the reference's device path,
    spatialcore_tpu/ops/banded.py:289-308). Numpy ``coords`` (or none, which
    orders by reverse Cuthill-McKee) takes the host path, bitwise equal to
    the reference's host path (:310-377); its tensors land on the graph's
    device. Either path sets the counters ``plan.rows``, ``plan.slots``,
    ``plan.live_slots`` and ``plan.far_edges`` (:func:`_count_plan`).
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
        n_far, n_live = torch.stack([far.sum(), (w_r > 0).sum()]).tolist()
        _count_plan(n, k, n_live, n_far)
        logger.info(f"null plan (device): N={n:,} k={k} block={block} "
                    f"far_edges={n_far:,} ({n_far / max(n_live, 1):.2%})")
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
    n_far, n_live = int(far.sum()), int(valid.sum())
    _count_plan(n, k, n_live, n_far)
    logger.info(f"null plan: N={n:,} k={k} block={block} "
                f"far_edges={n_far:,} ({n_far / max(n_live, 1):.2%})")
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


def _build_band_rot4(local_idx, w_local, block: int, dtype) -> torch.Tensor:
    """A4[nb, B, 4B]: :func:`_build_band` with each window slab's B-wide
    weight block at column (padded_slab % 4)·B — the layout of the
    single-product ring kernel (K6). The column block no window slab covers
    stays zero. Scattered into zeros one slot at a time, in slot order, so
    A4 equals the reference's (``spatialcore_tpu/ops/banded.py:610``)
    bitwise."""
    nb = local_idx.shape[0] // block
    k = local_idx.shape[1]
    li3 = local_idx.reshape(nb, block, k)
    lw3 = w_local.reshape(nb, block, k).to(dtype)
    slab = torch.arange(nb, device=local_idx.device)[:, None, None] + li3 // block
    col4 = (slab % 4) * block + li3 % block
    A = torch.zeros((nb, block, 4 * block), dtype=dtype, device=local_idx.device)
    for j in range(k):
        A.scatter_add_(2, col4[:, :, j:j + 1], lw3[:, :, j:j + 1])
    return A


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


def _win_far_pack(far_src, far_dst, far_w, far_q, far_starts, B: int,
                  far_bmax: int):
    """Pack the compact far list into the reference's windowed operands.

    Returns ``(S, nw, rowp, qp, far_rows, w_idx, starts0, runs)`` as the
    reference's ``_win_far_pack``, with the far targets' rows of the
    gathered table ``far_rows`` [nw·S] in place of their original-space
    rows: ``rowp``/``qp`` [nw, 1, S] hold each far entry's row in its
    block and its int8 weight code; per draw the far values are
    ``Zp[far_rows]``, the rows the reference gathers after walking the far
    targets separately (padding reads row 0 with weight code 0). The
    Hopper kernel reads the same compact list through row pointers
    (:func:`_row_ptr`) instead of the S-row windows.
    """
    S = _round_up(max(int(far_bmax), 1), 128)
    F = far_src.shape[0]
    nw = -(-F // S) + 2
    pad = nw * S - F
    pad1 = lambda a: torch.nn.functional.pad(a, (0, pad))  # noqa: E731
    rowp = pad1(torch.where(far_w > 0, (far_src - B) % B,
                            torch.zeros_like(far_src))).reshape(nw, 1, S)
    qp = pad1(torch.clamp(far_q, 0, 127).to(torch.int8)).reshape(nw, 1, S)
    w_idx = far_starts[:-1] // S
    starts0 = far_starts[:-1]
    runs = far_starts[1:] - far_starts[:-1]
    return S, nw, rowp, qp, pad1(far_dst), w_idx, starts0, runs


def _row_ptr(far_src, n_live: int, block: int, n_padded: int) -> torch.Tensor:
    """CSR row pointers [Npad+1] (int32) over the first ``n_live`` (live)
    entries of the compact far list.

    Entry e adds into padded row ``far_src[e] − B``. Both plan builders
    emit the list in row-major order, so these rows are non-decreasing and
    row r's entries are ``[ptr[r], ptr[r+1])``; a list in any other order
    is refused (one flag read back per call).
    """
    rows = far_src[:n_live] - block
    if n_live > 1 and bool(read_back((rows[1:] < rows[:-1]).any())):
        raise ValueError("far-edge list is not sorted by source row; "
                         "rebuild the plan with build_null_plan")
    ptr = torch.searchsorted(rows, torch.arange(n_padded + 1, device=rows.device,
                                                dtype=rows.dtype))
    return ptr.to(torch.int32)


# ---------------------------------------------------------------------------
# Plain twins of the band-cross kernels (dense band layout)
# ---------------------------------------------------------------------------


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
    lag = kern.band_lag_dense(A8, Zp8, n0, n1)
    dst = _far_dst(starts, runs, rowp, nb, B)
    q = qp.reshape(-1)
    sel = (dst >= n0 * B) & (dst < n1 * B) & (q != 0)
    vals = Zf.reshape(-1, G)[:q.numel()][sel].to(torch.float32) * q[sel][:, None]
    # integer-valued float32 adds: exact in any order (bound above)
    return lag.index_add_(0, dst[sel] - n0 * B, vals)


def _band_cross_win_i8_plain(w_idx, starts, runs, A8, sw, Zp8, Zf, rowp, qp,
                             genes: Optional[int] = None) -> torch.Tensor:
    """Plain twin of the int8/int4 windowed-far kernels (K1/K2): cross_q[g]
    in z_q·w_q units = Σ_i sw_i·z1_i·(band + far lag)_i."""
    return kern.dense_cross(Zp8, A8.shape[1], lambda n0, n1: _band_lag_win_i8_plain(
        w_idx, starts, runs, A8, Zp8, Zf, rowp, qp, n0, n1), sw, genes)


def _band_cross_i8_plain(A8, sw, Zp8, genes: Optional[int] = None
                         ) -> torch.Tensor:
    """Plain twin of the int8 band-only kernel (K3): Σ_i sw_i·z1_i·lag_i."""
    return kern.dense_cross(Zp8, A8.shape[1],
                            lambda n0, n1: kern.band_lag_dense(A8, Zp8, n0, n1),
                            sw, genes)


# ---------------------------------------------------------------------------
# One draw's statistic
# ---------------------------------------------------------------------------


def _finish_stat(cross, sq_fn, den, S0: float, n: int, stat: str):
    """Turn the draw's cross term into Moran's I, Geary's C, or both
    stacked [2, G] ("moran_geary": one gather and one cross serve both)."""
    moran = (n / S0) * cross / den
    if stat == "moran":
        return moran
    geary = (n - 1) * (sq_fn() - 2.0 * cross) / (2.0 * S0 * den)
    if stat == "geary":
        return geary
    return torch.stack([moran, geary])


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
    far_rows: Optional[torch.Tensor]  # int64 [nw·S] far targets' rows (win)
    far_exact: Optional[tuple]  # (far_src, far_dst, far_w) for far_mode=exact


def _banded_stat_int(ops: _IntOps, rc_sum, Zp, Zf, sz2, den, S0, *, n: int,
                     stat: str, use_plain: bool, genes: Optional[int] = None):
    """One draw's statistic in the int8 (``Zp`` codes) or int4 (``Zp``
    nibble-packed bytes) null system, on the draw's gathered table ``Zp``
    and (windowed far) its far values ``Zf = Zp[ops.far_rows]``.

    Covers the reference's ``_banded_stat_i4_win``, ``_banded_stat_i8_win``
    and ``_banded_stat_i8``: band products are exact integers scaled by the
    row scale sw; windowed far edges ride the same integer lag, exact far
    edges are added in float32 outside the kernel; one sz² converts back
    to z units.
    """
    B, nb = ops.block, ops.nb
    with span("kernels.band_cross"):
        if use_plain:
            unpack = _unpack_nibbles if ops.packed else (lambda t: t)
            Zp3 = unpack(Zp).reshape(nb + 2, B, -1)
            if ops.win:
                S, nw, rowp, qp, w_idx, starts0, runs = ops.win_ops
                cross_q = _band_cross_win_i8_plain(
                    w_idx, starts0, runs, ops.A8, ops.sw, Zp3,
                    unpack(Zf).reshape(nw, S, -1), rowp, qp, genes)
            else:
                cross_q = _band_cross_i8_plain(ops.A8, ops.sw, Zp3, genes)
        else:
            far = {}
            if ops.win:
                far = dict(far_row_ptr=ops.far_ptr,
                           far_q=ops.win_ops[3].reshape(-1), Zf=Zf)
            cross_q = kern.band_cross_int8(ops.local_idx32, ops.wq,
                                           ops.sw.reshape(-1), Zp, B,
                                           packed=ops.packed, genes=genes, **far)
        if ops.far_exact is not None:
            far_src, far_dst, far_w = ops.far_exact
            cross_q = cross_q + kern.tree_sum(
                far_w[:, None] * Zp[far_src].to(torch.float32)
                * Zp[far_dst].to(torch.float32))

        def sq():
            with span("ops.banded.geary_sq"):
                z1 = Zp[B:B + nb * B]
                z1 = (_unpack_nibbles(z1) if ops.packed else z1).to(torch.float32)
                return rc_sum @ (z1 * z1 * sz2)

        return _finish_stat(cross_q * sz2, sq, den, S0, n, stat)


def _banded_stat_float(local_idx32, w_c, A, far, rc_sum, Zp, den, S0, *,
                       block: int, n: int, stat: str, band_impl: str,
                       genes: Optional[int] = None):
    """One draw's statistic in bf16/f32 (reference ``_banded_stat``) on the
    draw's gathered table ``Zp``.

    The band cross by ``band_impl``: "auto"/"pallas_halo" the compact-band
    kernel (K4), "pallas" the dense-band kernel on ``A`` (K5),
    "pallas_halo4" the ring kernel on the rotation-baked ``A`` (K6), "xla"
    the dense plain twin. The far-edge cross and Geary's degree term
    Σ (r_i + c_i)·z_i² (``kernels.global_terms``, one launch on a CUDA
    table; "xla" its plain version) on ``far``, the far list as
    :func:`_global_far` gives it, inside a ``kernels.global_terms`` span;
    both in the table dtype with float32 sums, as in the reference.
    """
    B = block
    with span("kernels.band_cross"):
        if band_impl == "xla":
            cross = kern.band_cross_dense_plain(A, Zp, B, genes)
        elif band_impl == "pallas":
            cross = kern.band_cross_dense(A, Zp, B, genes)
        elif band_impl == "pallas_halo4":
            cross = kern.band_cross_rot4(A, Zp, B, genes)
        else:
            cross = kern.band_cross_float(local_idx32, w_c, Zp, B, genes)
    terms = (kern_terms.global_terms_plain if band_impl == "xla"
             else kern_terms.global_terms)
    with span("kernels.global_terms"):
        far_cross, sq = terms(Zp, *far, rc_sum, B, geary=stat != "moran")
    return _finish_stat(cross + far_cross, lambda: sq, den, S0, n, stat)


def _global_far(plan: NullPlan, kernel: bool):
    """The far list of the float global null's terms, once a call: for the
    kernel its live head as int32 rows and float32 weights (one read-back,
    :func:`_n_live_far`), for the plain version the plan's padded list."""
    if not kernel:
        return plan.far_src, plan.far_dst, plan.far_w
    return kern_terms.far_heads(plan.far_src, plan.far_dst, plan.far_w,
                                _n_live_far(plan))


# ---------------------------------------------------------------------------
# Draw loop
# ---------------------------------------------------------------------------


def _draw_steps(n_permutations: int, start: int = 0):
    """The draw indices ``start, …, start + n_permutations − 1``, each
    draw's body inside a ``draw`` span and counted in ``draws``: only
    :func:`_draws` iterates through this."""
    for step in range(start, start + n_permutations):
        with span("draw"):
            count("draws")
            yield step


def _draw_rows(perm_method: str, seed: int, rows_idx: torch.Tensor, n: int,
               sort_stream: str, feistel_stream: str):
    """Draw step → the padded table's rows ``perm[rows_idx]``: the one row
    source of every banded null. "sort": ``jax.random.permutation``'s
    stream bitwise, key base ``sort_stream`` (the slot nulls':
    ``perm_global``, ``perm_local``, ``perm_local_geary``, ``perm_getis``,
    ``perm_lee``); "feistel": the Feistel stream, key base
    ``feistel_stream`` (``perm_feistel``, ``perm_feistel_local`` ...).
    Draw d is keyed ``fold_in(base, d)``. ``feistel_apply`` is looked up
    as this module's global at every draw."""
    sort = perm_method == "sort"
    base = key_for(seed, sort_stream if sort else feistel_stream, 0)

    def rows(step: int) -> torch.Tensor:
        key = fold_in(base, step)
        if sort:
            return permutation(key, n, device=rows_idx.device)[rows_idx]
        return feistel_apply(key, rows_idx, n)

    return rows


def _gather(table: torch.Tensor, rows: torch.Tensor, far_dst=None):
    """``(Zp, Zf)``: the row gather ``Zp = table[rows]`` and, with
    ``far_dst``, the far values ``Zf = Zp[far_dst]`` (the far targets'
    rows of the gathered table: one far-value source for every null),
    inside an ``ops.banded.gather`` span. The rows it writes add to the
    counter ``ops.banded.gather_rows`` (sizes known on the host: no
    read-back)."""
    with span("ops.banded.gather"):
        count("ops.banded.gather_rows",
              rows.numel() + (0 if far_dst is None else far_dst.numel()))
        Zp = table[rows]
        return Zp, None if far_dst is None else Zp[far_dst]


def _draws(table: torch.Tensor, rows_of, n_permutations: int, far_dst=None,
           start: int = 0, gather: bool = True):
    """The draw loop of every banded null: draw d's rows (``rows_of``,
    :func:`_draw_rows`) and their :func:`_gather`, yielded as ``(Zp, Zf)``
    inside draw d's ``draw`` span (:func:`_draw_steps`), where the null
    runs its step, for d in ``[start, start + n_permutations)``. With
    ``gather=False`` (the int8 local nulls, whose draw step reads ``table``
    through the rows itself) it yields ``(rows, far_rows)`` instead: the
    draw's rows and the far targets' rows ``rows[far_dst]``, no code
    copied."""
    for step in _draw_steps(n_permutations, start):
        rows = rows_of(step)
        if gather:
            yield _gather(table, rows, far_dst)
        else:
            count("ops.banded.gather_rows", 0)
            yield rows, None if far_dst is None else rows[far_dst]


def _padded_rows(plan: NullPlan, device) -> torch.Tensor:
    """Original-space row of every padded table position (fixed relabel
    composition; per draw the rows are ``perm[rows_idx]``)."""
    B = plan.block
    gidx = torch.clamp(torch.arange(plan.n_padded + 2 * B, device=device) - B,
                       0, plan.n - 1)
    return plan.order[gidx]


def _extreme(v, o, alt: str):
    if alt == "greater":
        return v >= o
    if alt == "less":
        return v <= o
    return v.abs() >= o.abs()


def _full_row_codes(plan: NullPlan):
    """int8 band and far weight codes under the FULL-row weight scale.

    The row scale is the row's largest weight over band AND far edges, so
    a far edge carrying the row's maximum does not clip at 127 (the
    reference's windowed-far and LISA systems, ops/banded.py:2355-2365).
    Returns ``(wq int8 [Npad, k], sw f32 [nb, B, 1], far_q f32 [F])``; the
    far codes are integers in [0, 127] (0 on padding entries).
    """
    block = plan.block
    local_max = plan.w_local.max(dim=1).values
    live = plan.far_w > 0
    far_max = torch.zeros(plan.n_padded, dtype=torch.float32,
                          device=plan.w_local.device).scatter_reduce_(
        0, plan.far_src[live] - block, plan.far_w[live], "amax")
    rowmax = torch.maximum(local_max, far_max)
    sw_row = torch.where(rowmax > 0, rowmax / 127.0, torch.ones_like(rowmax))
    wq, sw = _band_codes_i8(plan.local_idx, plan.w_local, block,
                            row_scale=sw_row.reshape(-1, block, 1))
    far_q = torch.clamp(torch.round(
        plan.far_w / sw_row[(plan.far_src - block).clamp_min(0)]), 0, 127)
    return wq, sw, far_q


def _int_ops(plan: NullPlan, precision: str, far_mode: str, use_plain: bool
             ) -> _IntOps:
    """Build the int8/int4 operator once per call: band codes, row scales
    and (windowed far) the packed far operands."""
    block = plan.block
    nbb = plan.n_padded // block
    win = far_mode == "win"
    far_ptr = win_ops = far_rows = far_exact = None
    if win:
        wq, sw, far_q = _full_row_codes(plan)
        S, nw, rowp, qp, far_rows, w_idx, starts0, runs = _win_far_pack(
            plan.far_src, plan.far_dst, plan.far_w, far_q, plan.far_starts,
            block, plan.far_bmax)
        win_ops = (S, nw, rowp, qp, w_idx, starts0, runs)
        if not use_plain:
            far_ptr = _row_ptr(plan.far_src, _n_live_far(plan), block,
                               plan.n_padded)
    else:
        wq, sw = _band_codes_i8(plan.local_idx, plan.w_local, block)
        far_exact = (plan.far_src, plan.far_dst, plan.far_w)
    A8 = _build_band(plan.local_idx, wq, block, torch.int8) if use_plain else None
    return _IntOps(packed=precision == "int4", win=win, block=block, nb=nbb,
                   local_idx32=plan.local_idx.to(torch.int32), wq=wq, sw=sw,
                   A8=A8, far_ptr=far_ptr, win_ops=win_ops, far_rows=far_rows,
                   far_exact=far_exact)


@traced("draws")
def _banded_test(plan: NullPlan, Z, S0, observed, seed: int, den, sz,
                 draw0: int, *, n_permutations: int, stat: str, alternative,
                 precision: str, band_impl: str, far_mode: str,
                 perm_method: str, genes: Optional[int] = None):
    """The global null: permuted rows → row gather → band cross → counts.

    :func:`_draws` with three on-device accumulators (extreme count,
    Σ value, Σ value²), the reference's ``lax.scan`` carry. Draw d's rows
    come from the Feistel stream (key base ``perm_feistel``) or, with
    ``perm_method="sort"``, from ``permutation`` (key base ``perm_global``,
    the slot null's stream), each keyed by ``fold_in(base, d)``. The
    windowed far values are the gathered table's rows ``Zp[far_rows]``;
    the reference walks the far targets separately, to the same rows.
    """
    use_plain = band_impl == "xla"
    n, block = plan.n, plan.block
    prepacked = precision == "int4" and Z.dtype == torch.int8
    if den is None:
        if prepacked:
            if sz is None:
                raise ValueError("int4 Z requires its per-gene scale `sz`")
            codes = _unpack_nibbles(Z).to(torch.float32)
            den = kern.tree_sum(codes * codes, 512) * sz * sz
        else:
            den = kern.tree_sum(Z.to(torch.float32) ** 2, 512)
            if precision == "int8" and Z.dtype == torch.int8:
                if sz is None:
                    raise ValueError("int8 Z requires its per-gene scale `sz`")
                den = den * sz * sz
        den = torch.where(den > 0, den, torch.ones_like(den))
    G = Z.shape[1] * (2 if prepacked else 1)
    # per draw the value rows are Z[perm[rows_idx]]: one Feistel
    # evaluation + one row gather
    rows_idx = _padded_rows(plan, Z.device)
    if not use_plain and bool(read_back(((plan.local_idx < 0)
                                         | (plan.local_idx >= 3 * block)).any())):
        raise ValueError("plan.local_idx must lie in [0, 3·block)")
    far_rows = None
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
        ops = _int_ops(plan, precision, far_mode, use_plain)
        far_rows = ops.far_rows

        def stat_fn(Zp, Zf):
            return _banded_stat_int(ops, plan.rc_sum, Zp, Zf, sz2, den, S0,
                                    n=n, stat=stat, use_plain=use_plain,
                                    genes=genes)

        # draws compare against the observed value of the SAME quantized
        # operator (identity placement)
        observed = stat_fn(*_gather(Ztab, rows_idx, far_rows))
    else:
        wdt = torch.bfloat16 if precision == "bf16" else Z.dtype
        Ztab = Z if Z.dtype == wdt else Z.to(wdt)
        w_c = plan.w_local.to(wdt)
        # the dense band, once per call: 1.54 GB (A) / 2.05 GB (A4) of bf16
        # at 1M cells
        A = None
        if band_impl == "pallas_halo4":
            A = _build_band_rot4(plan.local_idx, w_c, block, wdt)
        elif band_impl in ("pallas", "xla"):
            A = _build_band(plan.local_idx, w_c, block, wdt)
        local_idx32 = plan.local_idx.to(torch.int32)
        far = _global_far(plan, Z.device.type == "cuda" and not use_plain)

        def stat_fn(Zp, Zf):
            return _banded_stat_float(local_idx32, w_c, A, far, plan.rc_sum,
                                      Zp, den, S0, block=block, n=n,
                                      stat=stat, band_impl=band_impl,
                                      genes=genes)

    rows_of = _draw_rows(perm_method, seed, rows_idx, n, "perm_global",
                         "perm_feistel")
    fused = stat == "moran_geary"
    shape = (2, G) if fused else (G,)
    count = torch.zeros(shape, dtype=torch.int32, device=Z.device)
    s1 = torch.zeros(shape, dtype=torch.float32, device=Z.device)
    s2 = torch.zeros(shape, dtype=torch.float32, device=Z.device)
    for Zp, Zf in _draws(Ztab, rows_of, n_permutations, far_rows, draw0):
        vals = stat_fn(Zp, Zf)
        if fused:
            ext = torch.stack([_extreme(vals[i], observed[i], alternative[i])
                               for i in range(2)])
        else:
            ext = _extreme(vals, observed, alternative)
        count += ext.to(torch.int32)
        s1 += vals
        s2 += vals * vals
    # the reference's jitted scan divides by the constants P + 1 and P as
    # multiplications by their float32 reciprocals (see _p_from_counts)
    inv_p = torch.tensor(1.0, dtype=torch.float32) / n_permutations
    mean = s1 * inv_p.to(s1.device)
    var = torch.clamp_min(s2 * inv_p.to(s2.device) - mean ** 2, 0.0)
    return _p_from_counts(count, n_permutations), mean, torch.sqrt(var)


_BAND_IMPLS = ("auto", "pallas_halo", "pallas", "pallas_halo4", "xla")


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
    launch_genes: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Monte-Carlo p-values, null mean and null std of a global statistic.

    Port of the reference's ``banded_permutation_test``; draws are bitwise
    the reference's streams, keyed at global indices
    ``[draw_offset, draw_offset + n_permutations)`` so chunked runs
    reproduce the unchunked run bitwise. ``perm_method``: "feistel"
    (default) or "sort", ``jax.random.permutation``'s stream keyed
    ``perm_global`` — the draws of ``ops.moran.permutation_test_global``.

    ``band_impl`` runs the band cross through ``kernels.band_cross`` — the
    hand-written Hopper kernel on a CUDA tensor, its plain version on a CPU
    tensor: "auto" (or "pallas_halo", the reference's name for the same
    route) the compact band (K4's function); "pallas" the dense band
    ``A[nb, B, 3B]`` (K5); "pallas_halo4" the rotation-baked ring over
    ``A4[nb, B, 4B]`` (K6); "xla" the plain dense-band twins on any
    device. The dense bands are built once per call. For int8/int4 every
    name but "xla" runs the integer kernel, as the reference's do.

    ``stat``: "moran", "geary", or "moran_geary", the fused pass: one
    gather and one cross per draw serve both statistics; ``observed`` is
    then [2, G] (Moran, Geary), ``alternative`` a string or a 2-tuple, and
    the outputs are [2, G].

    ``precision``: "bf16" (default), "f32", "int8" (per-gene int8 codes,
    exact integer band dots) or "int4" (nibble-packed codes, windowed far
    only). For int8, ``far_mode="auto"`` means "win" whenever the plan has
    its far-run structure. Integer draws compare against the observed
    value of the same quantized operator (``observed`` is ignored).

    ``launch_genes`` (default G): the gene count the kernels' launch shapes
    and the plain versions' row chunks are chosen for. A gene-sharded call
    on a block of a wider table passes the whole table's G, so that each
    gene's float sums run in the order of the whole call (every per-gene
    sum here is then independent of its neighbours: ``kern.tree_sum``).
    """
    _check_perm_method(perm_method)
    if band_impl not in _BAND_IMPLS:
        raise ValueError(f"unknown band_impl {band_impl!r}")
    if precision not in ("bf16", "f32", "int8", "int4"):
        raise ValueError(f"unknown precision {precision!r}")
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
    if stat not in ("moran", "geary", "moran_geary"):
        raise ValueError(f"stat must be 'moran', 'geary' or 'moran_geary', "
                         f"got {stat!r}")
    observed = torch.as_tensor(observed, device=Z.device)
    if stat == "moran_geary":
        if observed.ndim != 2 or observed.shape[0] != 2:
            raise ValueError("stat='moran_geary' needs observed of shape "
                             "[2, G] (stacked moran, geary)")
        if isinstance(alternative, (tuple, list)):
            if len(alternative) != 2:
                raise ValueError("fused alternative must have 2 entries")
            alternative = tuple(alternative)
        else:
            alternative = (alternative, alternative)
    if pad_g:
        Z = torch.nn.functional.pad(Z, (0, pad_g))
        observed = torch.nn.functional.pad(observed, (0, pad_g))
        if den is not None:
            den = torch.nn.functional.pad(den, (0, pad_g), value=1.0)
        if sz is not None:
            sz = torch.nn.functional.pad(sz, (0, pad_g), value=1.0)
    genes = None
    if launch_genes is not None:
        mult = 256 if precision == "int4" else 128 if precision == "int8" else 1
        genes = -(-int(launch_genes) // mult) * mult
    p, mean, std = _banded_test(
        plan, Z, S0, observed, int(seed) & 0xFFFFFFFF, den, sz,
        int(draw_offset), n_permutations=n_permutations, stat=stat,
        alternative=alternative, precision=precision, band_impl=band_impl,
        far_mode=far_mode, perm_method=perm_method, genes=genes)
    if pad_g:
        p, mean, std = p[..., :G], mean[..., :G], std[..., :G]
    return p, mean, std


# ---------------------------------------------------------------------------
# Banded LOCAL Moran (LISA)
# ---------------------------------------------------------------------------

#: gene-column chunk width of the one-time observed pass
_OBS_CHUNK = 256
#: the int8 LISA null's exactness bound: |z·lag| ≤ k·127³ < 2³¹
_LISA_MAX_K = 1000


def _chunked_cols(fn, arrs, G: int, width: Optional[int] = None):
    """Evaluate ``fn`` over gene-column chunks of its ``[:, G]`` operands
    and concatenate its outputs on the last (gene) axis: bounds the
    one-time observed pass's temps to one chunk's."""
    width = _OBS_CHUNK if width is None else width
    if G <= width:
        return fn(*arrs)
    return torch.cat([fn(*(a[:, s:s + width] for a in arrs))
                      for s in range(0, G, width)], dim=-1)


def _check_perm_method(perm_method: str) -> None:
    """Validate ``perm_method`` up front, so a typo fails loudly."""
    if perm_method not in ("feistel", "sort"):
        raise ValueError("perm_method must be 'feistel' or 'sort', "
                         f"got {perm_method!r}")


def _n_live_far(plan: NullPlan) -> int:
    """Number of live far edges (both plan builders put them first)."""
    if plan.far_starts is not None:
        return int(read_back(plan.far_starts[-1]))
    return int(read_back((plan.far_w > 0).sum()))


def _p_from_counts(count: torch.Tensor, n_permutations: int) -> torch.Tensor:
    """p = (count + 1)/(P + 1) as the reference computes it: XLA folds the
    division by the constant into a multiplication by its float32
    reciprocal, which lands 1 ulp off the direct quotient for part of the
    counts; the same expression here keeps p bitwise."""
    inv = torch.tensor(1.0, dtype=torch.float32) / (n_permutations + 1.0)
    return (count.to(torch.float32) + 1.0) * inv.to(count.device)


def _pad_cols4(T: torch.Tensor) -> torch.Tensor:
    """Pad the gene axis to a multiple of 4 (the kernel reads 4 genes per
    thread); padded columns are zero codes and are sliced off after."""
    G = T.shape[1]
    return torch.nn.functional.pad(T, (0, _round_up(max(G, 1), 4) - G)).contiguous()


def _row_spans(n_padded: int, block: int, G: int):
    """Whole-block row ranges of the float nulls' per-draw work, each
    holding about ``_PLAIN_CHUNK_ELEMS`` values of [rows, G] temps."""
    step = max(block, (_PLAIN_CHUNK_ELEMS // max(G, 1)) // block * block)
    return [(r0, min(r0 + step, n_padded)) for r0 in range(0, n_padded, step)]


def _check_impl(band_impl: str) -> None:
    if band_impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown band_impl {band_impl!r}")


def _lisa_far_form(plan: NullPlan, band_impl: str) -> str:
    """How the int8 LISA draw step receives the far edges.

    "rows": row pointers into the compact far list (K7's function);
    "dense": a dense int32 far layer per draw (K8's function). "pallas"
    follows the reference's rule (windowed when 0 < far_bmax and
    round_up(far_bmax, 128) ≤ 1024, else the dense kernel); "auto" and
    "xla" take row pointers whenever the plan has ``far_starts`` — the
    reference's far_bmax cap and VMEM gate are TPU limits that a
    row-pointer read does not have — and no far operand at all when the
    plan has no live far edge.
    """
    has_runs = plan.far_starts is not None
    if band_impl == "pallas":
        return ("rows" if has_runs and 0 < plan.far_bmax
                and _round_up(plan.far_bmax, 128) <= 1024 else "dense")
    return "rows" if has_runs else "dense"


class _Local(NamedTuple):
    """A local null's per-call operands (:func:`_local_setup`)."""

    rows_idx: torch.Tensor       # int64 [Npad+2B] (:func:`_padded_rows`)
    li: Optional[torch.Tensor]   # [Npad, k] band index, int32 or int16
    n_live: int                  # live far edges: the far list's head
    far_row: torch.Tensor        # int64 [n_live] padded row each adds into
    far_dst: torch.Tensor        # int64 [n_live] its target's table row
    ptr: Optional[torch.Tensor]  # int32 [Npad+1] row pointers ("rows")
    slots: Optional[tuple]       # (dst, w) [Npad, R] ("slots")


def _local_setup(plan: NullPlan, device, far: str = "rows",
                 li: Optional[torch.dtype] = torch.int32) -> _Local:
    """What every local null builds once per call: the padded rows, the
    live far count (one read-back), the live far list's rows and targets,
    and the band index in dtype ``li`` (None: not built). ``far`` is the
    far list's form: "rows" its row pointers (:func:`_row_ptr`; one
    read-back, the order check), "slots" the torch-op float nulls' slot
    form (:func:`kernels.lisa_float.far_slots`; one more, the widest row),
    "dense" neither (K8's dense far layer). The draw loop then reads
    nothing back."""
    n_live = _n_live_far(plan)
    ptr = slots = None
    dst = plan.far_dst[:n_live]
    if far in ("rows", "slots"):
        ptr = _row_ptr(plan.far_src, n_live, plan.block, plan.n_padded)
    if far == "slots":
        R = int(read_back((ptr[1:] - ptr[:-1]).max())) if n_live else 0
        slots = kern_float.far_slots(ptr, dst, plan.far_w[:n_live], R)
    return _Local(rows_idx=_padded_rows(plan, device),
                  li=None if li is None else plan.local_idx.to(li).contiguous(),
                  n_live=n_live, far_row=plan.far_src[:n_live] - plan.block,
                  far_dst=dst, ptr=ptr, slots=slots)


def _observed(fn, table: torch.Tensor, rows_idx, far_dst, chunked: bool):
    """An int8 local null's observed pass at the identity placement:
    ``fn(T, rows, far_rows)`` on ``table`` read at the padded rows
    ``rows_idx`` and the far targets' rows ``rows_idx[far_dst]`` (as a
    draw's, :func:`_draws` with ``gather=False``), a gene-column chunk of
    ``table`` at a time when ``chunked`` (the plain versions: bounds their
    temps)."""
    far_rows = None if far_dst is None else rows_idx[far_dst]

    def at_identity(T):
        return fn(T, rows_idx, far_rows)

    if not chunked:
        return at_identity(table)
    return _chunked_cols(at_identity, (table,), table.shape[1]).contiguous()


@traced("draws")
def _banded_local_moran_p_i8(plan: NullPlan, Z: torch.Tensor, seed: int, *,
                             n_permutations: int, band_impl: str = "auto",
                             return_counts: bool = False,
                             perm_method: str = "feistel") -> torch.Tensor:
    """LISA permutation p via the int8 null system (reference
    ``_banded_local_moran_p_i8``, ops/banded.py:2314).

    z quantizes per gene (:func:`_quantize_z`), band AND far weights per
    row with the full-row scale (:func:`_full_row_codes`). Each draw's
    local statistic is the exact int32 ``|z_code · Σ w_code z_code|``; the
    observed value comes from the same operator at the identity placement,
    so the per-gene and per-row scales cancel inside the comparison and
    the counts are exact integers. Counters are int8 for P ≤ 127, int16
    for P ≤ 32767, int32 above.

    Per draw: the padded rows of one draw (:func:`_draw_rows`, Feistel or
    "sort"), the far targets' rows ``rows[far_dst]``, and the draw-step
    kernel (``kernels.lisa_count``), which reads ``Zq`` through those rows
    (no permuted table is written) and updates the counters in place;
    K8's dense far form gathers the far values ``Zq[far_rows]`` for its
    layer.
    ``band_impl="xla"`` runs the kernel's plain version instead, on any
    device. Returns p [n, G] in the original cell order, or the integer
    counts with ``return_counts``.
    """
    B = plan.block
    k_total = plan.local_idx.shape[1]
    if k_total > _LISA_MAX_K:
        raise ValueError(
            f"int8 LISA null supports k <= {_LISA_MAX_K} (int32 bound "
            f"k*127^3), got k={k_total}; use precision='bf16'")
    Zq = Z if Z.dtype == torch.int8 else _quantize_z(Z)[0]
    G = Zq.shape[1]
    Zq = _pad_cols4(Zq)
    wq, _, far_q = _full_row_codes(plan)
    form = _lisa_far_form(plan, band_impl)
    lo = _local_setup(plan, Zq.device, form)
    if lo.n_live == 0 and band_impl != "pallas":
        form = "none"                             # the band-only step
    far_dst = None if form == "none" else lo.far_dst
    count_fn, obs_fn = ((kern_lisa.lisa_count_plain, kern_lisa.lisa_observed_plain)
                        if band_impl == "xla" else
                        (kern_lisa.lisa_count, kern_lisa.lisa_observed))
    fq = far_q[:lo.n_live]
    fq8, fq32 = fq.to(torch.int8), fq.to(torch.int32)[:, None]

    def far(T, far_rows):
        if form == "rows":
            return dict(far_row_ptr=lo.ptr, far_q=fq8, far_rows=far_rows)
        if form == "dense":
            Zf = _gather(T, far_rows)[0]
            layer = torch.zeros((plan.n_padded, Zf.shape[1]),
                                dtype=torch.int32, device=Zf.device)
            # integer adds: exact in any order
            return dict(far=layer.index_add_(0, lo.far_row,
                                             Zf.to(torch.int32) * fq32))
        return {}

    # observed via the SAME quantized operator, at the identity placement
    abs_obs = _observed(lambda T, rows, fr: obs_fn(lo.li, wq, T, rows, B,
                                                   **far(T, fr)),
                        Zq, lo.rows_idx, far_dst, band_impl == "xla")
    rows_of = _draw_rows(perm_method, seed, lo.rows_idx, plan.n, "perm_local",
                         "perm_feistel_local")
    count = torch.zeros(abs_obs.shape, dtype=kern_lisa.counter_dtype(
        n_permutations), device=Zq.device)
    for rows, far_rows in _draws(Zq, rows_of, n_permutations, far_dst,
                                 gather=False):
        with span("kernels.lisa_count"):
            count_fn(lo.li, wq, Zq, rows, B, abs_obs, count, **far(Zq, far_rows))
    count = count[plan.rank, :G]                  # original order
    if return_counts:
        return count
    return _p_from_counts(count, n_permutations)


def banded_local_moran_pvalues(
    plan: NullPlan,
    Z: torch.Tensor,
    seed: int,
    n_permutations: int,
    perm_method: str = "feistel",
    band_impl: str = "auto",
    return_counts: bool = False,
) -> torch.Tensor:
    """LISA null p-values only, int8 quantized-operator system.

    Runs on the device of ``Z`` and ``plan`` (a CUDA tensor goes through
    the Hopper kernel ``csrc/lisa_count_int8.cu``). ``Z`` may be
    pre-quantized int8 codes (:func:`_quantize_z`): the per-gene scale
    cancels inside the comparison. With ``return_counts`` the integer
    extreme counts come back instead of f32 p.

    ``band_impl``: "auto" runs the kernel with row-pointer far edges
    whenever the plan has ``far_starts`` and the dense far layer (K8's
    function) otherwise — unlike the reference, whose auto rule falls back
    to XLA beyond the TPU kernels' VMEM limits; "pallas" follows the
    reference's choice between the windowed (K7) and dense (K8) kernels;
    "xla" runs the kernel's plain version on any device. All three give
    bitwise-equal counts: integer adds commute. ``perm_method``: "feistel"
    (default) or "sort", the slot null's ``perm_local`` stream
    (``jax.random.permutation``, bitwise).
    """
    _check_perm_method(perm_method)
    _check_impl(band_impl)
    return _banded_local_moran_p_i8(
        plan, Z, int(seed) & 0xFFFFFFFF, n_permutations=n_permutations,
        band_impl=band_impl, return_counts=return_counts,
        perm_method=perm_method)


@traced("draws")
def _banded_local_moran_p(plan: NullPlan, Z: torch.Tensor, abs_obs_new,
                          seed: int, *, n_permutations: int,
                          precision: str, perm_method: str = "feistel"
                          ) -> torch.Tensor:
    """LISA permutation p through the bf16/f32 banded null (reference
    ``_banded_local_moran_p``, ops/banded.py:2487; XLA there). Per draw one
    row gather and one draw step (``kernels.lisa_float``: the band + far
    lag on the compact band, products rounded to float32 and added in slot
    order, then each row's far edges in list order; |z·lag| compared with
    the exact observed |I| (``abs_obs_new``, relabeled order, padded rows
    +inf) and the int16 counters (int32 above 32,767 draws) updated in
    place). A CUDA table goes through the hand-written kernel, a CPU one
    through its torch-op plain version: the counts are equal bitwise."""
    B = plan.block
    wdt = torch.bfloat16 if precision == "bf16" else Z.dtype
    w = plan.w_local.to(wdt).contiguous()
    Ztab = Z if Z.dtype == wdt else Z.to(wdt)
    lo = _local_setup(plan, Z.device, li=torch.int16)   # rows < 3B ≤ 1536
    far = dict(far_row_ptr=lo.ptr, far_dst=lo.far_dst.to(torch.int32),
               far_w=plan.far_w[:lo.n_live].to(torch.float32))
    rows_of = _draw_rows(perm_method, seed, lo.rows_idx, plan.n, "perm_local",
                         "perm_feistel_local")
    count = torch.zeros((plan.n_padded, Z.shape[1]), device=Z.device,
                        dtype=kern_float.counter_dtype(n_permutations))
    for Zp, _ in _draws(Ztab, rows_of, n_permutations):
        with span("kernels.lisa_float"):
            kern_float.moran_count(lo.li, w, Zp, B, abs_obs_new, count, **far)
    return _p_from_counts(count[plan.rank], n_permutations)


def banded_local_moran(
    plan: NullPlan,
    graph: SpatialGraph,
    Z: torch.Tensor,
    seed: int,
    n_permutations: int,
    precision: str = "bf16",
    perm_method: str = "feistel",
    band_impl: str = "auto",
):
    """Drop-in ``ops.moran.local_moran`` with the banded permutation null.

    Observed I/z/lag come from the exact direct pass (one ``spatial_lag``
    over ``graph``); only the null runs through the banded machinery.
    Returns a ``LocalMoranResult`` in the original cell order, on the
    device of ``Z``. ``precision="int8"`` runs the null in the per-gene
    quantized operator (:func:`banded_local_moran_pvalues`, the Hopper
    kernel on a CUDA tensor); "bf16" / "f32" run the float null
    (:func:`_banded_local_moran_p`, ``csrc/lisa_float.cu`` on a CUDA
    tensor). ``perm_method="sort"`` draws the slot null's permutations (key
    ``perm_local``): with ``precision="f32"`` the p-values then equal
    ``ops.moran.local_moran(null="total")``'s up to float32 summation
    order.
    """
    from .moran import LocalMoranResult, local_moran

    _check_perm_method(perm_method)
    if precision not in ("bf16", "f32", "int8"):
        raise ValueError(f"unknown precision {precision!r}")
    with span("prep"):
        obs = local_moran(graph, Z, seed, 0)
    if n_permutations == 0:
        return obs
    if precision == "int8":
        p = banded_local_moran_pvalues(plan, Z, seed, n_permutations,
                                       perm_method=perm_method,
                                       band_impl=band_impl)
        return LocalMoranResult(obs.local_I, obs.z, obs.lag, p)
    abs_obs_new = obs.local_I.abs()[plan.order]
    if plan.n_padded > plan.n:
        # padded rows never win a comparison (inf observed)
        abs_obs_new = torch.nn.functional.pad(
            abs_obs_new, (0, 0, 0, plan.n_padded - plan.n), value=float("inf"))
    p = _banded_local_moran_p(plan, Z, abs_obs_new, int(seed) & 0xFFFFFFFF,
                              n_permutations=n_permutations,
                              precision=precision, perm_method=perm_method)
    return LocalMoranResult(obs.local_I, obs.z, obs.lag, p)


# ---------------------------------------------------------------------------
# Banded LOCAL Geary and Getis-Ord Gi / Gi*
# ---------------------------------------------------------------------------


@traced("draws")
def _banded_local_geary_p_i8(plan: NullPlan, Z: torch.Tensor, seed: int, *,
                             n_permutations: int, band_impl: str = "auto",
                             perm_method: str = "feistel"):
    """Local Geary total-null p, fully integer (reference
    ``_banded_local_geary_p_i8``, ops/banded.py:2846).

    The expansion c_i = z_i²·W_i + Σ_j w_ij z_j² − 2 z_i Σ_j w_ij z_j is
    exact in the quantized domain: z codes per gene (:func:`_quantize_z`),
    band and far weights per row under the full-row scale
    (:func:`_full_row_codes`), W_i the row's total weight code. Every term
    shares the positive factor s_g²·sw_row, so ``c_perm ≤ c_obs`` is an
    exact int32 comparison (k ≤ 256). The observed value comes from the
    same operator at the identity placement. Per draw: one draw's rows
    (:func:`_draw_rows`) and the far targets' rows ``rows[far_dst]``, and
    the geary draw step (``kernels.lisa_count.geary_count``, which reads
    ``Zq`` through them; its plain version with ``band_impl="xla"``).
    Counters are int8 for P ≤ 127.
    Returns ``(c_obs in code units, p)`` [n, G] in the original order.
    """
    B = plan.block
    k_total = plan.local_idx.shape[1]
    if k_total > kern_lisa.GEARY_MAX_K:
        raise ValueError(
            f"int8 local-Geary null supports k <= {kern_lisa.GEARY_MAX_K} "
            f"(int32 bound k*127*254^2), got k={k_total}; use precision='f32'")
    Zq = Z if Z.dtype == torch.int8 else _quantize_z(Z)[0]
    G = Zq.shape[1]
    Zq = _pad_cols4(Zq)
    wq, _, far_q = _full_row_codes(plan)
    lo = _local_setup(plan, Zq.device)
    fq8 = far_q[:lo.n_live].to(torch.int8)
    # each row's TOTAL weight code: band codes + far codes
    w_code = wq.to(torch.int32).sum(dim=1, dtype=torch.int32).index_add_(
        0, lo.far_row, far_q[:lo.n_live].to(torch.int32))
    count_fn, obs_fn = ((kern_lisa.geary_count_plain, kern_lisa.geary_observed_plain)
                        if band_impl == "xla" else
                        (kern_lisa.geary_count, kern_lisa.geary_observed))
    c_obs = _observed(lambda T, rows, fr: obs_fn(lo.li, wq, T, rows, B, w_code,
                                                 far_row_ptr=lo.ptr, far_q=fq8,
                                                 far_rows=fr),
                      Zq, lo.rows_idx, lo.far_dst, band_impl == "xla")
    rows_of = _draw_rows(perm_method, seed, lo.rows_idx, plan.n,
                         "perm_local_geary", "perm_feistel_local_geary")
    count = torch.zeros(c_obs.shape, dtype=kern_lisa.counter_dtype(
        n_permutations), device=Zq.device)
    for rows, far_rows in _draws(Zq, rows_of, n_permutations, lo.far_dst,
                                 gather=False):
        with span("kernels.lisa_count"):
            count_fn(lo.li, wq, Zq, rows, B, c_obs, count, w_code,
                     far_row_ptr=lo.ptr, far_q=fq8, far_rows=far_rows)
    return (c_obs[plan.rank, :G],
            _p_from_counts(count[plan.rank, :G], n_permutations))


@traced("draws")
def _banded_local_geary_p(plan: NullPlan, Z: torch.Tensor, seed: int, *,
                          n_permutations: int, precision: str,
                          perm_method: str = "feistel"):
    """Local Geary total-null p through the bf16/f32 banded null (reference
    ``_banded_local_geary_p``, ops/banded.py:2779; XLA there, torch ops on
    the compact band here): per draw one row gather, the band + far lags of
    z and of z² (rounded to the table dtype, as the reference), and
    ``c = z²·W + lag(z²) − 2·z·lag`` compared with the same operator's
    observed value. Returns ``(c_obs, p)`` [n, G] in the original order."""
    B = plan.block
    n_padded = plan.n_padded
    wdt = torch.bfloat16 if precision == "bf16" else torch.float32
    w = plan.w_local.to(wdt)
    Ztab = Z.to(wdt)
    dev = Z.device
    lo = _local_setup(plan, dev, "slots", li=None)
    # each row's TOTAL weight (band + far)
    row_w = plan.w_local.to(torch.float32).sum(dim=1).index_add_(
        0, lo.far_row, plan.far_w[:lo.n_live].to(torch.float32))
    chunks = _row_spans(n_padded, B, Z.shape[1])

    def geary(Zp):
        Zp2 = (Zp.to(torch.float32) * Zp.to(torch.float32)).to(wdt)
        for r0, r1 in chunks:
            lag1 = kern_float.band_lag(plan.local_idx, w, Zp, B, lo.slots, r0, r1)
            lag2 = kern_float.band_lag(plan.local_idx, w, Zp2, B, lo.slots, r0, r1)
            me = Zp[B + r0:B + r1].to(torch.float32)
            yield r0, r1, me * me * row_w[r0:r1, None] + lag2 - 2.0 * me * lag1

    c_obs = torch.empty((n_padded, Z.shape[1]), dtype=torch.float32, device=dev)
    for r0, r1, c in geary(Ztab[lo.rows_idx]):
        c_obs[r0:r1] = c
    rows_of = _draw_rows(perm_method, seed, lo.rows_idx, plan.n,
                         "perm_local_geary", "perm_feistel_local_geary")
    cdt = kern_float.counter_dtype(n_permutations)
    count = torch.zeros(c_obs.shape, dtype=cdt, device=dev)
    for Zp, _ in _draws(Ztab, rows_of, n_permutations):
        with span("ops.banded.local_lag"):
            for r0, r1, c in geary(Zp):
                count[r0:r1] += (c <= c_obs[r0:r1]).to(cdt)
    return c_obs[plan.rank], _p_from_counts(count[plan.rank], n_permutations)


def banded_local_geary(plan: NullPlan, Z: torch.Tensor, seed: int,
                       n_permutations: int, precision: str = "f32",
                       perm_method: str = "feistel", band_impl: str = "auto"):
    """Local Geary total-null p-values via the banded plan (reference
    ``banded_local_geary``). Returns ``(c_obs_operator, p)`` [n, G] in the
    original cell order; callers take the observed C from the exact direct
    pass (``ops.moran.local_geary``) and only ``p`` from here (the int8
    route's first value is in integer code units).

    ``precision``: "f32" / "bf16" run the float null in torch ops; "int8"
    the fully integer null (k ≤ 256), whose draw step on a CUDA tensor is
    the Hopper kernel's geary tail with row-pointer far edges for
    ``band_impl`` "auto" and "pallas" alike (the reference's non-windowed
    alternative is its XLA body, whose function that kernel computes);
    "xla" runs the kernel's plain version on any device. Counts are
    bitwise equal either way. ``perm_method``: "feistel" (default) or
    "sort", the slot null's ``perm_local_geary`` stream.
    """
    if precision not in ("bf16", "f32", "int8"):
        raise ValueError(
            f"banded_local_geary supports precision 'bf16', 'f32' or "
            f"'int8', got {precision!r}")
    _check_perm_method(perm_method)
    _check_impl(band_impl)
    seed = int(seed) & 0xFFFFFFFF
    if precision == "int8":
        return _banded_local_geary_p_i8(plan, Z, seed,
                                        n_permutations=n_permutations,
                                        band_impl=band_impl,
                                        perm_method=perm_method)
    return _banded_local_geary_p(plan, Z, seed, n_permutations=n_permutations,
                                 precision=precision, perm_method=perm_method)


def _quantize_x(X: torch.Tensor):
    """Per-gene int8 quantization of RAW values (reference ``_quantize_x``):
    s_g = max|x_g|/127, no clip beyond the int8 range. ``(Xq int8, s)``."""
    Xf = X.to(torch.float32)
    s = Xf.abs().max(dim=0).values / 127.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    return torch.clamp(torch.round(Xf / s), -127, 127).to(torch.int8), s


def _code_moments(Xq: torch.Tensor):
    """Column sums of the codes and of their squares, exact in int64 and
    rounded once to float32 ([G] each). The reference sums float32 codes;
    the two agree wherever its partial sums stay below 2²⁴."""
    G = Xq.shape[1]
    tot = torch.zeros(G, dtype=torch.int64, device=Xq.device)
    sq = torch.zeros(G, dtype=torch.int64, device=Xq.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(G, 1))
    for r0 in range(0, Xq.shape[0], step):
        x = Xq[r0:r0 + step].to(torch.int32)
        tot += x.sum(dim=0, dtype=torch.int64)
        sq += (x * x).sum(dim=0, dtype=torch.int64)
    return tot.to(torch.float32), sq.to(torch.float32)


def _inv_m(n: int, star: bool) -> float:
    """f32(1/m), m = n (Gi*) or n − 1 (Gi): XLA compiles the reference's
    ``x / m`` into a multiplication by this reciprocal."""
    return float(torch.tensor(1.0, dtype=torch.float32) / (n if star else n - 1))


@traced("draws")
def _banded_getis_p_i8(plan: NullPlan, X: torch.Tensor, seed: int, *,
                       n_permutations: int, star: bool, alternative: str,
                       band_impl: str = "auto", perm_method: str = "feistel"
                       ) -> torch.Tensor:
    """Getis-Ord Gi/Gi* permutation p_sim, int8 quantized operator
    (reference ``_banded_getis_p_i8``, ops/banded.py:3144).

    Getis adjacency is binary (band codes ``w_local > 0``, every live far
    edge 1), so the only quantization is per gene on raw X
    (:func:`_quantize_x`); the binary lag is an exact int32 sum of codes.
    Gi*: A = lag + own is exact, one-sided decisions are integer
    comparisons and two-sided the sign test against c2 = f32(tot/m)·(W+1).
    Gi: the leave-one-out centred lag cp in float32, with an exact
    (lag, own) tie counted as extreme (``kernels.lisa_count``). Per draw:
    one draw's rows (:func:`_draw_rows`), the far targets' rows, and the
    Getis draw step, which reads ``Xq`` through them. Returns p_sim [n, G]
    in the original order.
    """
    B = plan.block
    Xq = _quantize_x(X)[0]
    G = Xq.shape[1]
    Xq = _pad_cols4(Xq)
    dev = Xq.device
    wb = (plan.w_local > 0).to(torch.int8)
    lo = _local_setup(plan, dev)
    fb = torch.ones(lo.n_live, dtype=torch.int8, device=dev)
    w_row = wb.to(torch.int32).sum(dim=1, dtype=torch.int32).index_add_(
        0, lo.far_row,
        torch.ones(lo.n_live, dtype=torch.int32, device=dev)).to(torch.float32)
    tot, sq = _code_moments(Xq)
    inv_m = _inv_m(plan.n, star)
    if band_impl == "xla":
        lag_fn, star_fn, g_fn = (kern_lisa.getis_lag_plain,
                                 kern_lisa.getis_star_count_plain,
                                 kern_lisa.getis_g_count_plain)
    else:
        lag_fn, star_fn, g_fn = (kern_lisa.getis_lag, kern_lisa.getis_star_count,
                                 kern_lisa.getis_g_count)
    lag_o = _observed(lambda T, rows, fr: lag_fn(lo.li, wb, T, rows, B,
                                                 far_row_ptr=lo.ptr, far_q=fb,
                                                 far_rows=fr),
                      Xq, lo.rows_idx, lo.far_dst, band_impl == "xla")
    me_o = Xq[lo.rows_idx[B:B + plan.n_padded]]
    if star:
        obs = lag_o + me_o.to(torch.int32)          # A_o, exact
        del lag_o, me_o
        kw = {}
        if alternative == "two-sided":
            kw = dict(wp1=w_row + 1.0, tm=tot * inv_m)
        count_fn = star_fn
    else:
        obs = kern_lisa.gi_center(lag_o, me_o, w_row, tot, sq, inv_m)
        kw = dict(w_row=w_row, tot=tot, sq=sq, inv_m=inv_m, lag_o=lag_o,
                  me_o=me_o)
        count_fn = g_fn
    rows_of = _draw_rows(perm_method, seed, lo.rows_idx, plan.n, "perm_getis",
                         "perm_feistel_getis")
    count = torch.zeros(obs.shape, dtype=kern_lisa.counter_dtype(
        n_permutations), device=dev)
    for rows, far_rows in _draws(Xq, rows_of, n_permutations, lo.far_dst,
                                 gather=False):
        with span("kernels.lisa_count"):
            count_fn(lo.li, wb, Xq, rows, B, obs, count, alternative=alternative,
                     far_row_ptr=lo.ptr, far_q=fb, far_rows=far_rows, **kw)
    return _p_from_counts(count[plan.rank, :G], n_permutations)


@traced("draws")
def _banded_getis_p(plan: NullPlan, X: torch.Tensor, seed: int, *,
                    n_permutations: int, star: bool, alternative: str,
                    precision: str, perm_method: str = "feistel"
                    ) -> torch.Tensor:
    """Getis-Ord Gi/Gi* permutation p_sim through the bf16/f32 banded null
    (reference ``_banded_getis_p``, ops/banded.py:3033; torch ops on the
    compact band here). The per-gene column statistics are invariant under
    the column shuffle and the per-cell scale cancels, so Gi* compares the
    centred binary lag ``(lag + x) − (tot/m)·(W+1)`` and Gi the
    leave-one-out ``(lag − x̄_(i)·W)/s_(i)``. Returns p_sim [n, G]."""
    B = plan.block
    n_padded = plan.n_padded
    wdt = torch.bfloat16 if precision == "bf16" else torch.float32
    wb = (plan.w_local > 0).to(torch.float32)
    w = wb.to(wdt)
    Xf = X.to(torch.float32)
    Xtab = Xf.to(wdt)
    dev = X.device
    lo = _local_setup(plan, dev, "slots", li=None)
    fdst, fw = lo.slots
    far = (fdst, (fw > 0).to(torch.float32))        # binary far weights
    w_row = wb.sum(dim=1).index_add_(
        0, lo.far_row,
        torch.ones(lo.n_live, dtype=torch.float32, device=dev))[:, None]
    tot = Xf.sum(dim=0)
    sq = (Xf * Xf).sum(dim=0)
    del Xf
    inv_m = _inv_m(plan.n, star)
    chunks = _row_spans(n_padded, B, X.shape[1])

    def center(Xp):
        for r0, r1 in chunks:
            lag = kern_float.band_lag(plan.local_idx, w, Xp, B, far, r0, r1)
            me = Xp[B + r0:B + r1].to(torch.float32)
            W = w_row[r0:r1]
            if star:
                yield r0, r1, (lag + me) - (tot * inv_m) * (W + 1.0)
                continue
            xbar = (tot - me) * inv_m
            s2 = torch.clamp_min((sq - me * me) * inv_m - xbar * xbar, 0.0)
            s = torch.sqrt(torch.where(s2 > 0, s2, torch.ones_like(s2)))
            yield r0, r1, (lag - xbar * W) / s

    obs_c = torch.empty((n_padded, X.shape[1]), dtype=torch.float32, device=dev)
    for r0, r1, c in center(Xtab[lo.rows_idx]):
        obs_c[r0:r1] = c
    rows_of = _draw_rows(perm_method, seed, lo.rows_idx, plan.n, "perm_getis",
                         "perm_feistel_getis")
    cdt = kern_float.counter_dtype(n_permutations)
    count = torch.zeros(obs_c.shape, dtype=cdt, device=dev)
    for Xp, _ in _draws(Xtab, rows_of, n_permutations):
        with span("ops.banded.local_lag"):
            for r0, r1, c in center(Xp):
                count[r0:r1] += _extreme(c, obs_c[r0:r1], alternative).to(cdt)
    return _p_from_counts(count[plan.rank], n_permutations)


def banded_getis(plan: NullPlan, X: torch.Tensor, seed: int,
                 n_permutations: int, star: bool = True,
                 alternative: str = "two-sided", precision: str = "f32",
                 perm_method: str = "feistel", band_impl: str = "auto"
                 ) -> torch.Tensor:
    """Getis-Ord permutation p_sim via the banded plan (reference
    ``banded_getis``), on raw ``X``. Observed G / z / analytic p come from
    the exact direct pass (``ops.getis.getis_ord`` with P=0).

    ``precision``: "f32" / "bf16" run the float null in torch ops; "int8"
    quantizes X per gene against the exact binary adjacency, its draw step
    on a CUDA tensor the Hopper kernel's getis_star / getis_g tail with
    row-pointer far edges (``band_impl`` "auto" or "pallas"); "xla" runs
    the kernel's plain version on any device. ``perm_method``: "feistel"
    (default) or "sort", the slot null's ``perm_getis`` stream.
    """
    if precision not in ("bf16", "f32", "int8"):
        raise ValueError(
            f"banded_getis supports precision 'bf16', 'f32' or 'int8', "
            f"got {precision!r}")
    if alternative not in ("two-sided", "greater", "less"):
        raise ValueError(f"invalid alternative {alternative!r}")
    _check_perm_method(perm_method)
    _check_impl(band_impl)
    seed = int(seed) & 0xFFFFFFFF
    if precision == "int8":
        return _banded_getis_p_i8(plan, X, seed, n_permutations=n_permutations,
                                  star=star, alternative=alternative,
                                  band_impl=band_impl, perm_method=perm_method)
    return _banded_getis_p(plan, X, seed, n_permutations=n_permutations,
                           star=star, alternative=alternative,
                           precision=precision, perm_method=perm_method)


# ---------------------------------------------------------------------------
# Banded Lee's L
# ---------------------------------------------------------------------------


#: Σ over axis 0 in one fixed pairwise order (``kern.tree_sum``)
_tree_sum = kern.tree_sum


def _relabeled_x(plan: NullPlan, X: torch.Tensor) -> torch.Tensor:
    """The pair's fixed x column in the relabeled order, padded rows zero."""
    x = X[plan.order]
    if plan.n_padded > plan.n:
        x = torch.nn.functional.pad(x, (0, 0, 0, plan.n_padded - plan.n))
    return x.contiguous()


@traced("draws")
def _banded_lees_p(plan: NullPlan, Zx: torch.Tensor, Zy: torch.Tensor,
                   seed: int, *, n_permutations: int, precision: str,
                   compute_cell_pvalues: bool, perm_method: str):
    """Lee's L permutation p through the bf16/f32 banded null (reference
    ``_banded_lees_p``, ops/banded.py:2539; XLA there, torch ops on the
    compact band here). Per draw one row gather of the permuted y columns
    and the band + far lag (:func:`kernels.lisa_float.band_lag`: band
    slots, then each row's far edges in list order, float32 accumulation);
    x stays fixed.
    The observed values come from the same operator at the identity
    placement. Returns ``(p_global [G], p_local [n, G])`` in the original
    order (``p_local`` ones without ``compute_cell_pvalues``)."""
    B = plan.block
    n_padded = plan.n_padded
    G = Zy.shape[1]
    dev = Zy.device
    wdt = torch.bfloat16 if precision == "bf16" else torch.float32
    w = plan.w_local.to(wdt)
    Ytab = Zy.to(wdt)
    zx = _relabeled_x(plan, Zx.to(torch.float32))
    lo = _local_setup(plan, dev, "slots", li=None)
    spans = _row_spans(n_padded, B, G)

    def lees(Yp):
        for r0, r1 in spans:
            yield r0, r1, zx[r0:r1] * kern_float.band_lag(
                plan.local_idx, w, Yp, B, lo.slots, r0, r1)

    abs_l = (torch.empty((n_padded, G), dtype=torch.float32, device=dev)
             if compute_cell_pvalues else None)
    Lg = torch.zeros(G, dtype=torch.float32, device=dev)
    for r0, r1, L in lees(Ytab[lo.rows_idx]):
        if abs_l is not None:
            abs_l[r0:r1] = L.abs()
        Lg += L.sum(dim=0)
    abs_g = Lg.abs()
    rows_of = _draw_rows(perm_method, seed, lo.rows_idx, plan.n, "perm_lee",
                         "perm_feistel_lee")
    cdt = kern_float.counter_dtype(n_permutations)
    cg = torch.zeros(G, dtype=torch.int32, device=dev)
    cl = (torch.zeros((n_padded, G), dtype=cdt, device=dev)
          if compute_cell_pvalues else None)
    for Yp, _ in _draws(Ytab, rows_of, n_permutations):
        with span("ops.banded.local_lag"):
            Lg = torch.zeros(G, dtype=torch.float32, device=dev)
            for r0, r1, L in lees(Yp):
                if cl is not None:
                    cl[r0:r1] += (L.abs() >= abs_l[r0:r1]).to(cdt)
                Lg += L.sum(dim=0)
            cg += (Lg.abs() >= abs_g).to(torch.int32)
    p_l = (_p_from_counts(cl[plan.rank], n_permutations) if compute_cell_pvalues
           else torch.ones((plan.n, G), dtype=torch.float32, device=dev))
    return _p_from_counts(cg, n_permutations), p_l


@traced("draws")
def _banded_lees_p_i8(plan: NullPlan, Zx: torch.Tensor, Zy: torch.Tensor,
                      seed: int, *, n_permutations: int, perm_method: str,
                      compute_cell_pvalues: bool, band_impl: str = "auto"):
    """Lee's L nulls in the int8 quantized-operator system (reference
    ``_banded_lees_p_i8``, ops/banded.py:2615).

    Both columns quantize per gene pair (:func:`_quantize_z`), the weights
    per row with the full-row scale (:func:`_full_row_codes`). The per-cell
    draw statistic is the exact int32 ``Lq = x_code · Σ w_code·y_code``
    (k ≤ 1000); the positive factor s_x·s_y·sw_row multiplies both sides of
    every per-cell comparison, so ``|Lq| ≥ |Lq_obs|`` is exact. The global
    L re-applies the row scale in float32: the draw step returns per-block
    partials Σ_rows sw_row·f32(Lq) in a fixed order, which
    :func:`_tree_sum` reduces in a fixed order, the same for the observed
    value and every draw. Per draw: the draw's rows (Feistel or
    ``permutation``) and the far targets' rows, and one Lee entry of
    ``kernels.lisa_count``, which reads the y codes through them — the
    draw step with ``compute_cell_pvalues``,
    the partial-only entry without (the kernel on a CUDA tensor, its plain
    version on a CPU tensor or with ``band_impl="xla"``). Counters are int8
    for P ≤ 127. Returns ``(p_global [G], p_local [n, G])``.
    """
    B = plan.block
    k_total = plan.local_idx.shape[1]
    if k_total > kern_lisa.LEE_MAX_K:
        raise ValueError(
            f"int8 Lee null supports k <= {kern_lisa.LEE_MAX_K} (int32 bound "
            f"k*127^3), got k={k_total}; use precision='bf16'")
    Zyq = _pad_cols4(_quantize_z(Zy)[0])
    G = Zy.shape[1]
    dev = Zyq.device
    zx = _relabeled_x(plan, _pad_cols4(_quantize_z(Zx)[0]))
    wq, sw, far_q = _full_row_codes(plan)
    sw_row = sw.reshape(-1).contiguous()
    lo = _local_setup(plan, dev)
    fq8 = far_q[:lo.n_live].to(torch.int8)
    if band_impl == "xla":
        count_fn, obs_fn, part_fn = (kern_lisa.lee_count_plain,
                                     kern_lisa.lee_observed_plain,
                                     kern_lisa.lee_partial_plain)
    else:
        count_fn, obs_fn, part_fn = (kern_lisa.lee_count, kern_lisa.lee_observed,
                                     kern_lisa.lee_partial)
    # the identity placement: |Lq| per cell and the partials, or the
    # partials alone
    first_fn = obs_fn if compute_cell_pvalues else part_fn
    obs = _observed(lambda T, rows, fr: first_fn(lo.li, wq, T, rows, B, zx, sw_row,
                                                 far_row_ptr=lo.ptr, far_q=fq8,
                                                 far_rows=fr),
                    Zyq, lo.rows_idx, lo.far_dst, False)
    abs_l, part = obs if compute_cell_pvalues else (None, obs)
    abs_g = _tree_sum(part).abs()
    rows_of = _draw_rows(perm_method, seed, lo.rows_idx, plan.n, "perm_lee",
                         "perm_feistel_lee")
    cg = torch.zeros(Zyq.shape[1], dtype=torch.int32, device=dev)
    cl = (torch.zeros((plan.n_padded, Zyq.shape[1]), device=dev,
                      dtype=kern_lisa.counter_dtype(n_permutations))
          if compute_cell_pvalues else None)
    for rows, far_rows in _draws(Zyq, rows_of, n_permutations, lo.far_dst,
                                 gather=False):
        with span("kernels.lisa_count"):
            far = dict(far_row_ptr=lo.ptr, far_q=fq8, far_rows=far_rows)
            if cl is not None:
                part = count_fn(lo.li, wq, Zyq, rows, B, zx, sw_row, abs_l, cl,
                                **far)
            else:
                part = part_fn(lo.li, wq, Zyq, rows, B, zx, sw_row, **far)
            cg += (_tree_sum(part).abs() >= abs_g).to(torch.int32)
    p_l = (_p_from_counts(cl[plan.rank, :G], n_permutations)
           if compute_cell_pvalues
           else torch.ones((plan.n, G), dtype=torch.float32, device=dev))
    return _p_from_counts(cg[:G], n_permutations), p_l


def banded_lees_l(plan: NullPlan, Zx: torch.Tensor, Zy: torch.Tensor,
                  seed: int, n_permutations: int, precision: str = "bf16",
                  compute_cell_pvalues: bool = False,
                  perm_method: str = "feistel", band_impl: str = "auto"):
    """Lee's L permutation p-values (global, and per cell with
    ``compute_cell_pvalues``) via the banded plan (reference
    ``banded_lees_l``). The observed L comes from the exact direct pass
    (``ops.lee.lees_l_pairs`` with ``n_permutations=0``); this evaluates
    the null only. Returns ``(p_global [P], p_local [n, P])`` in the
    original cell order, on the device of ``Zy``.

    ``perm_method``: "feistel" (default) or "sort", which reproduces the
    direct null's draws (``jax.random.permutation`` keyed ``perm_lee``).
    ``precision``: "bf16" / "f32" run the float null in torch ops; "int8"
    the quantized-operator null (k ≤ 1000), whose draw step on a CUDA
    tensor is the Hopper kernel's lee tail with row-pointer far edges for
    ``band_impl`` "auto" and "pallas" alike (the partial-only entry when
    only the global p is asked for, which the reference leaves to XLA);
    "xla" runs the kernel's plain version on any device. The per-cell
    counts are bitwise equal either way; the global p can differ from the
    reference's XLA einsum only at an exact float32 tie of |L|.
    """
    if precision not in ("bf16", "f32", "int8"):
        raise ValueError(
            f"banded_lees_l supports precision 'bf16', 'f32' or 'int8', "
            f"got {precision!r}")
    _check_perm_method(perm_method)
    _check_impl(band_impl)
    seed = int(seed) & 0xFFFFFFFF
    if precision == "int8":
        return _banded_lees_p_i8(plan, Zx, Zy, seed,
                                 n_permutations=n_permutations,
                                 perm_method=perm_method,
                                 compute_cell_pvalues=compute_cell_pvalues,
                                 band_impl=band_impl)
    return _banded_lees_p(plan, Zx, Zy, seed, n_permutations=n_permutations,
                          precision=precision,
                          compute_cell_pvalues=compute_cell_pvalues,
                          perm_method=perm_method)
