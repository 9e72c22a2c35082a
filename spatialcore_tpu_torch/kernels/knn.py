"""Wrapper of the exact 2D kNN kernel, and its plain version.

``csrc/knn_topk.cu`` replaces the Pallas kernel K9 (``_knn_kernel`` of
``spatialcore_tpu/ops/pallas_knn.py``): for every point q of ``xy``
float32 [n, 2], its k nearest points by

    d2 = (qx − cx)² + (qy − cy)²        (float32, each operation rounded once)

sorted by (d2, candidate id), so an equal distance keeps the lower id; the
point itself is left out unless ``include_self``. Returns ``(d2 float32
[n, k], ids int64 [n, k])``.

* On a CPU tensor the wrapper runs the plain version, the all-pairs scan
  ``ops.graph.knn_scan`` (d2 over query tiles, then the (d2, id)
  lexicographic top-k). Its subtractions, products and sum are separate
  float32 operations, as the kernel's intrinsics are, so the two agree
  bitwise.
* On a CUDA tensor it launches the kernel on the current stream and adds
  one to :data:`LAUNCHES` — or raises. There is no fallback.

The kernel takes k ≤ :data:`MAX_K` (its largest template bound).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.graph import knn_scan
from . import build

#: kernel launches
LAUNCHES = {"knn": 0}
#: the kernel's largest top-k bound (template parameter KMAX)
MAX_K = 256


def reset_launch_counts() -> None:
    LAUNCHES["knn"] = 0


def knn_topk_plain(xy: torch.Tensor, k: int, include_self: bool = False,
                   queries: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`knn_topk`: ``ops.graph.knn_scan``, the
    all-pairs scan in query tiles of bounded size. ``queries`` (int64 ids)
    gives the rows of those points only."""
    ids, d2 = knn_scan(xy, k, include_self, queries)
    return d2, ids


def knn_topk(xy: torch.Tensor, k: int, include_self: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest points of every point of ``xy`` (float32 [n, 2],
    contiguous): ``(d2 float32 [n, k], ids int64 [n, k])``, each row sorted
    by (d2, id). Needs 1 ≤ k < n, and k ≤ :data:`MAX_K` on a CUDA tensor."""
    if xy.dtype != torch.float32 or xy.ndim != 2 or xy.shape[1] != 2:
        raise ValueError("xy must be float32 [n, 2]")
    if not xy.is_contiguous() or xy.data_ptr() % 8:
        raise ValueError("xy must be contiguous and 8-byte aligned")
    n = xy.shape[0]
    if not 1 <= k < n:
        raise ValueError(f"k={k} must be in [1, n_cells={n})")
    if xy.device.type == "cpu":
        return knn_topk_plain(xy, k, include_self)
    if xy.device.type != "cuda":
        raise ValueError(f"unsupported device {xy.device}")
    if k > MAX_K:
        raise ValueError(f"the kNN kernel takes k <= {MAX_K}, got k={k}")
    lib = build.load_library()
    with torch.cuda.device(xy.device):
        out_d = torch.empty((n, k), dtype=torch.float32, device=xy.device)
        out_i = torch.empty((n, k), dtype=torch.int32, device=xy.device)
        err = lib.sct_knn(xy.data_ptr(), n, k, int(include_self),
                          out_d.data_ptr(), out_i.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn launch failed: CUDA error {err}")
    LAUNCHES["knn"] += 1
    return out_d, out_i.to(torch.int64)
