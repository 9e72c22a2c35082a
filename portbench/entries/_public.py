"""Set-up shared by the entries that go through the public API: the
section as a ``SpatialData`` with X on the device, and the kNN graph built
and stored by ``spatial.build_spatial_weights``, timed."""

from __future__ import annotations

import time

import numpy as np
import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def adata_with_graph(section: dict, device) -> tuple:
    """(adata, graph seconds)."""
    from spatialcore_tpu_torch.core.container import SpatialData
    from spatialcore_tpu_torch.spatial import build_spatial_weights

    adata = SpatialData(X=section["X"])
    adata.obsm["spatial"] = section["coords"]
    sync(device)
    t = time.perf_counter()
    build_spatial_weights(adata, n_neighbors=int(section["k"]), device=device)
    sync(device)
    return adata, time.perf_counter() - t


def gene_names(adata, section: dict) -> list:
    return [adata.var_names[i] for i in section["genes"]]


def stored_graph(adata, cells) -> dict:
    g = adata.uns["spatial_graph"]
    rows = np.asarray(cells)
    return {"nbr": torch.as_tensor(np.asarray(g["neighbor_idx"])[rows]),
            "w": torch.as_tensor(np.asarray(g["neighbor_w"])[rows])}
