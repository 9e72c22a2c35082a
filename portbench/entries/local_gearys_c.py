"""``spatial.local_gearys_c`` on the section's X on the device, with the
stored graph and every other argument at its default but the traffic's.

Set-up stores the graph (``build_spatial_weights``) and warms up with one
call at the traffic's genes and arguments and a few draws, which also
builds and caches the null plan.
"""

from __future__ import annotations

import torch

from portbench.entries._public import adata_with_graph, gene_names, stored_graph

WARM_DRAWS = 2
KEY = "local_geary"
PLANES = ("C", "p", "p_adj")


def _kw(st: dict, n_perms: int) -> dict:
    kw = dict(genes=st["genes"], n_neighbors=st["k"], n_permutations=n_perms,
              use_existing_graph=True, seed=st["seed"], device=st["device"])
    kw.update(st["traffic"].get("args", {}))
    return kw


def setup(section: dict, traffic: dict, device) -> dict:
    from spatialcore_tpu_torch.spatial import local_gearys_c

    adata, graph_s = adata_with_graph(section, device)
    st = {"adata": adata, "genes": gene_names(adata, section),
          "k": int(section["k"]), "seed": int(section["null_seed"]),
          "traffic": traffic, "device": device,
          "spans": {"graph_build_s": graph_s}}
    local_gearys_c(adata, **_kw(st, WARM_DRAWS))
    return st


def call(st: dict) -> None:
    from spatialcore_tpu_torch.spatial import local_gearys_c

    local_gearys_c(st["adata"], **_kw(st, int(st["traffic"]["n_permutations"])))


def work(st: dict) -> dict:
    n = st["adata"].n_obs
    return {"local_cgpps": n * len(st["genes"])
            * int(st["traffic"]["n_permutations"])}


def outputs(st: dict, smp: dict) -> dict:
    obsm = st["adata"].obsm
    cols = torch.as_tensor(smp["genes"])
    out = {}
    for k in PLANES:
        plane = torch.as_tensor(obsm[f"{KEY}_{k}"])
        out[k] = plane.index_select(1, cols.to(plane.device))
    out.update(stored_graph(st["adata"], smp["cells"]))
    return out
