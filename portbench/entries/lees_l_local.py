"""``spatial.lees_l_local`` on the section's X on the device, with the stored
graph, over the traffic's gene pairs (panel indices, x then y), and every
other argument at its default but the traffic's.

Set-up stores the graph (``build_spatial_weights``) and warms up with one
call at the traffic's pairs and arguments and a few draws, which also
builds and caches the null plan.
"""

from __future__ import annotations

import torch

from portbench.entries._public import adata_with_graph, stored_graph

WARM_DRAWS = 2
KEY = "lees_local"


def _kw(st: dict, n_perms: int) -> dict:
    kw = dict(gene_pairs=st["pairs"], n_neighbors=st["k"],
              n_permutations=n_perms, use_existing_graph=True, seed=st["seed"],
              device=st["device"])
    kw.update(st["traffic"].get("args", {}))
    return kw


def setup(section: dict, traffic: dict, device) -> dict:
    from spatialcore_tpu_torch.spatial import lees_l_local

    adata, graph_s = adata_with_graph(section, device)
    names = adata.var_names
    st = {"adata": adata, "pairs": [(names[x], names[y])
                                    for x, y in traffic["pairs"]],
          "k": int(section["k"]), "seed": int(section["null_seed"]),
          "traffic": traffic, "device": device,
          "spans": {"graph_build_s": graph_s}}
    lees_l_local(adata, **_kw(st, WARM_DRAWS))
    return st


def call(st: dict) -> None:
    from spatialcore_tpu_torch.spatial import lees_l_local

    lees_l_local(st["adata"], **_kw(st, int(st["traffic"]["n_permutations"])))


def work(st: dict) -> dict:
    n = st["adata"].n_obs
    return {"local_cgpps": n * len(st["pairs"])
            * int(st["traffic"]["n_permutations"])}


def outputs(st: dict, smp: dict) -> dict:
    obsm = st["adata"].obsm
    cols = torch.as_tensor(smp["genes"])
    out = {}
    for k in ("L", "p", "p_adj", "quadrant"):
        plane = torch.as_tensor(obsm[f"{KEY}_{k}"])
        out[k] = plane.index_select(1, cols.to(plane.device))
    out.update(stored_graph(st["adata"], smp["cells"]))
    return out
