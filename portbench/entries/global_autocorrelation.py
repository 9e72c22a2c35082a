"""``spatial.global_autocorrelation`` on the section's X on the device:
Moran's I and Geary's C in one call, on the radius graph stored by
``spatial.build_spatial_weights(radius=, k_max=)``, with every other
argument at its default but the traffic's.

A configuration reaches an entry only through ``n_neighbors``, so the
graph's radius and cap come from the traffic's ``graph``. Set-up builds
and stores the radius graph, timed as ``graph_build_s``, and warms up with
one call at the traffic's genes and a few draws through the banded null
(``warm_args``), which also builds and caches the null plan.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.entries._public import gene_names, sync

WARM_DRAWS = 2
KEYS = {"moran": ("morans_i", "I"), "geary": ("gearys_c", "C")}


def _kw(st: dict, n_perms: int, **extra) -> dict:
    kw = dict(genes=st["genes"], n_permutations=n_perms,
              use_existing_graph=True, seed=st["seed"], device=st["device"])
    kw.update(st["traffic"].get("args", {}))
    kw.update(extra)
    return kw


def setup(section: dict, traffic: dict, device) -> dict:
    from spatialcore_tpu_torch.core.container import SpatialData
    from spatialcore_tpu_torch.spatial import (build_spatial_weights,
                                               global_autocorrelation)

    adata = SpatialData(X=section["X"])
    adata.obsm["spatial"] = section["coords"]
    g = traffic["graph"]
    sync(device)
    t = time.perf_counter()
    build_spatial_weights(adata, radius=float(g["radius_um"]),
                          k_max=int(g["k_max"]), device=device)
    sync(device)
    st = {"adata": adata, "genes": gene_names(adata, section),
          "seed": int(section["null_seed"]), "traffic": traffic,
          "device": device,
          "spans": {"graph_build_s": time.perf_counter() - t}}
    global_autocorrelation(adata, **_kw(st, WARM_DRAWS,
                                        **traffic.get("warm_args", {})))
    return st


def call(st: dict) -> None:
    from spatialcore_tpu_torch.spatial import global_autocorrelation

    global_autocorrelation(st["adata"],
                           **_kw(st, int(st["traffic"]["n_permutations"])))


def work(st: dict) -> dict:
    return {"null_gpps": len(st["genes"]) * int(st["traffic"]["n_permutations"])}


def outputs(st: dict, smp: dict) -> dict:
    uns = st["adata"].uns
    out = {}
    for s, (key, col) in KEYS.items():
        df = uns[key]
        out[col] = torch.as_tensor(df[col].to_numpy()[smp["genes"]])
        out[f"p_{s}"] = torch.as_tensor(df["p_value"].to_numpy()[smp["genes"]])
    g = uns["spatial_graph"]
    rows = np.asarray(smp["cells"])
    for k, f in (("nbr", "neighbor_idx"), ("w", "neighbor_w"),
                 ("valid", "valid")):
        out[k] = torch.as_tensor(np.asarray(g[f])[rows])
    return out
