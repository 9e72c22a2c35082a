"""Wrapper of the exact 2D kNN kernel, its launch-shape chooser, and its
plain version.

``csrc/knn_topk.cu`` replaces the Pallas kernel K9 (``_knn_kernel`` of
``spatialcore_tpu/ops/pallas_knn.py``): for every point q of ``xy``
float32 [n, 2], its k nearest points by

    d2 = (qx − cx)² + (qy − cy)²        (float32, each operation rounded once)

sorted by (d2, candidate id), so an equal distance keeps the lower id; the
point itself is left out unless ``include_self``. Returns ``(d2 float32
[n, k], ids int64 [n, k])``; a row with fewer than k finite candidates
ends in id −1 and d2 +Inf.

* On a CPU tensor the wrapper runs the plain version, the all-pairs scan
  ``ops.graph.knn_scan`` (d2 over query tiles, then the (d2, id)
  lexicographic top-k). Its subtractions, products and sum are separate
  float32 operations, as the kernel's intrinsics are, so the two agree
  bitwise.
* On a CUDA tensor it orders the points along a Morton curve
  (:func:`knn_operands`), launches the kernel on the current
  stream with the ids of that order and the largest |coordinate| (its
  filter's margin), and adds one to :data:`LAUNCHES` — or raises. There
  is no fallback.

The kernel takes k ≤ :data:`MAX_K`. Its launch shape is a :class:`KnnTiles`
from :func:`knn_tiles`; :func:`knn_topk_tiled` takes one given by the
caller (tests and timings).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.graph import knn_scan
from ..utils.profiling import CounterGroup
from . import build

#: kernel launches (the counter ``kernels.knn.knn`` of ``utils.profiling``)
LAUNCHES = CounterGroup("kernels.knn", ("knn",))
#: the kernel's largest top-k bound (8 keys a lane)
MAX_K = 256
#: shared memory a CTA may use on the H100 (bytes)
SMEM_LIMIT = 232_448


class KnnTiles(NamedTuple):
    """Launch shape of the kNN kernel."""
    threads: int    #: threads a CTA: a multiple of 32, ≤ 256
    tile: int       #: candidates a ring stage: a multiple of 128
    stages: int     #: ring stages in shared memory: 2–4


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def knn_smem_bytes(tiles: KnnTiles) -> int:
    """Shared memory of the kernel: ``stages`` tiles of ``tile`` float2."""
    return tiles.stages * tiles.tile * 8


def kmax(k: int) -> int:
    """The list length the kernel keeps for k: 32·W keys spread over a
    warp, W ∈ {1, 2, 4, 8}."""
    return 32 * next(w for w in (1, 2, 4, 8) if k <= 32 * w)


def queries_a_warp(k: int) -> int:
    """Queries a warp of the instance for k (``knn_topk.cu``'s
    warp_kernel): 8, and 4 at KMAX ≥ 128, where 8 lists would not fit 128
    registers a thread."""
    return 8 if kmax(k) <= 64 else 4


def queries_a_cta(k: int, tiles: KnnTiles) -> int:
    return tiles.threads // 32 * queries_a_warp(k)


@functools.lru_cache(maxsize=None)
def knn_tiles(n: int, k: int) -> KnnTiles:
    """The launch shape for n points and k neighbours.

    CTAs of 256 threads (128 ran slower) and a 3-stage ring (2 ran as
    fast, 4 slower: one CTA an SM fits). The tile is 4,096 points (the
    fastest of 512–4,096 in chip_smoke's timings at 66,536 and 1M points),
    or n rounded up to 128 where that is less. k does not change the
    shape. Cached: every launch asks for it.
    """
    return KnnTiles(256, min(4096, -(-n // 128) * 128), 3)


def check_tiles(tiles: KnnTiles) -> None:
    """Raise ValueError unless the kernel takes ``tiles``."""
    def need(cond, msg):
        if not cond:
            raise ValueError(f"knn launch shape {tiles}: {msg}")

    need(32 <= tiles.threads <= 256 and tiles.threads % 32 == 0,
         "threads must be a multiple of 32, at most 256")
    need(tiles.tile >= 128 and tiles.tile % 128 == 0, "tile must be a multiple of 128")
    need(2 <= tiles.stages <= 4, "stages must be 2-4")
    need(knn_smem_bytes(tiles) <= SMEM_LIMIT,
         f"shared memory must be stages * tile * 8 <= {SMEM_LIMIT}")


def morton_codes_plain(xy: torch.Tensor) -> torch.Tensor:
    """int64 [n]: each point's Morton (Z-order) code over a 2¹⁶ × 2¹⁶ grid
    of the points' bounding box, in torch ops (on the card too: the
    wrapper's point order). Non-finite coordinates, and a box of width 0,
    go to cell 0; a NaN coordinate sends every point to cell 0."""
    lo, hi = torch.aminmax(xy, dim=0)
    scale = torch.full_like(lo, 65535.0) / (hi - lo)    # one rounding, as the kernel's
    cell = ((xy - lo) * scale).nan_to_num_(0.0, 0.0, 0.0)
    cell = cell.clamp_(0, 65535).to(torch.int64)
    for shift, mask in ((8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333),
                        (1, 0x55555555)):              # 16 bits onto the even bits
        cell |= cell << shift
        cell &= mask
    return cell[:, 0] | (cell[:, 1] << 1)


def knn_topk_plain(xy: torch.Tensor, k: int, include_self: bool = False,
                   queries: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`knn_topk`: ``ops.graph.knn_scan``, the
    all-pairs scan in query tiles of bounded size. ``queries`` (int64 ids)
    gives the rows of those points only."""
    ids, d2 = knn_scan(xy, k, include_self, queries)
    return d2, ids


def _check_operand(xy: torch.Tensor, k: int) -> None:
    if xy.dtype != torch.float32 or xy.ndim != 2 or xy.shape[1] != 2:
        raise ValueError("xy must be float32 [n, 2]")
    if not xy.is_contiguous() or xy.data_ptr() % 8:
        raise ValueError("xy must be contiguous and 8-byte aligned")
    n = xy.shape[0]
    if not 1 <= k < n:
        raise ValueError(f"k={k} must be in [1, n_cells={n})")
    if xy.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xy.device}")
    if xy.device.type == "cuda" and k > MAX_K:
        raise ValueError(f"the kNN kernel takes k <= {MAX_K}, got k={k}")


def knn_topk(xy: torch.Tensor, k: int, include_self: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest points of every point of ``xy`` (float32 [n, 2],
    contiguous): ``(d2 float32 [n, k], ids int64 [n, k])``, each row sorted
    by (d2, id). Needs 1 ≤ k < n, and k ≤ :data:`MAX_K` on a CUDA tensor.
    The launch shape is :func:`knn_tiles`'s."""
    _check_operand(xy, k)
    if xy.device.type == "cpu":
        return knn_topk_plain(xy, k, include_self)
    return knn_topk_tiled(xy, k, include_self, knn_tiles(xy.shape[0], k))


def knn_topk_tiled(xy: torch.Tensor, k: int, include_self: bool,
                   tiles: KnnTiles) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`knn_topk` at the launch shape ``tiles`` (checked; the plain
    version on a CPU tensor)."""
    _check_operand(xy, k)
    check_tiles(tiles)
    if xy.device.type == "cpu":
        return knn_topk_plain(xy, k, include_self)
    with torch.cuda.device(xy.device):
        out_d, out_i = knn_launch(*knn_operands(xy), k, include_self, tiles)
    return out_d, out_i.to(torch.int64)


def knn_operands(xy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's operands from ``xy`` on the card: the points along a
    Morton curve (a new tensor, so 16-byte aligned for ``cp.async``), their
    ids (int32) and the largest |coordinate| (float32 [1]: the filter's
    margin; NaN where a coordinate is, and the kernel then filters by the
    exact d2). A CTA's queries are then neighbours and it scans their own
    tile first; the kernel's keys carry the ids, so the answer does not
    depend on the order."""
    order = torch.argsort(morton_codes_plain(xy))
    return xy[order], order.to(torch.int32), xy.abs().amax().reshape(1)


def knn_launch(xs: torch.Tensor, order: torch.Tensor, rmax: torch.Tensor, k: int,
               include_self: bool, tiles: KnnTiles) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on :func:`knn_operands`' operands at ``tiles`` on
    the current stream (unchecked: :func:`knn_topk_tiled` checks) and add
    one to :data:`LAUNCHES`: ``(d2 float32 [n, k], ids int32 [n, k])``."""
    n = xs.shape[0]
    lib = build.load_library()
    out_d = torch.empty((n, k), dtype=torch.float32, device=xs.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=xs.device)
    err = lib.sct_knn(xs.data_ptr(), order.data_ptr(), rmax.data_ptr(), n, k,
                      int(include_self), tiles.threads, tiles.tile, tiles.stages,
                      out_d.data_ptr(), out_i.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn launch failed: CUDA error {err}")
    LAUNCHES["knn"] += 1
    return out_d, out_i
