"""Exact kNN over all pairs through the hand-written Hopper kernel.

Port of ``spatialcore_tpu/ops/pallas_knn.py`` (``pallas_knn``, the exact
all-pairs kNN with a running top-k, Pallas kernel K9): the same checks,
the same float32 conditioning, and the same neighbour order. The kernel is
``csrc/knn_topk.cu`` through ``kernels.knn.knn_topk`` (its plain version on
a CPU tensor).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from ..kernels.knn import knn_topk


def centred_xy(coords, device: Union[str, torch.device] = "cuda"
               ) -> torch.Tensor:
    """2D coordinates (array or tensor) as the kernel's operand: float32
    [N, 2], centred by their numpy float32 mean on the host
    (``coords - coords.mean(axis=0)``, the reference's conditioning bit for
    bit; a device mean would sum in another order), contiguous on
    ``device``."""
    if isinstance(coords, torch.Tensor):
        coords = coords.detach().cpu().numpy()
    coords = np.asarray(coords, np.float32)
    if coords.ndim != 2 or coords.shape[1] != 2:
        raise ValueError("pallas_knn supports 2D coordinates")
    centred = coords - coords.mean(axis=0, keepdims=True)
    return torch.as_tensor(np.ascontiguousarray(centred)).to(device)


def pallas_knn(coords, k: int, include_self: bool = False,
               device: Union[str, torch.device] = "cuda"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN over all pairs: ``(indices int64 [N, k], distances f32
    [N, k])`` on ``device``, sorted ascending by squared distance, ties by
    candidate id; self is excluded unless ``include_self``.

    As the reference: 2D coordinates only, k < N, and the coordinates are
    centred on the host by :func:`centred_xy`. Distances are ``sqrt`` of
    the squared distances the kernel ranks by.
    """
    xy = centred_xy(coords, device)
    n = xy.shape[0]
    if k >= n:
        raise ValueError(f"k={k} must be < n_cells={n}")
    d2, idx = knn_topk(xy, k, include_self)
    return idx, torch.sqrt(d2)
