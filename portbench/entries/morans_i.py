"""``spatial.morans_i`` on the section's X on the device, with the stored
graph and every other argument at its default but the traffic's.

Set-up stores the graph (``build_spatial_weights``) and warms up with one
call at the traffic's genes and a few draws through the route "auto"
resolves to at the cell's size, which also builds and caches the null
plan.
"""

from __future__ import annotations

import torch

from portbench.entries._public import adata_with_graph, gene_names, stored_graph

WARM_DRAWS = 2


def _kw(st: dict, n_perms: int, **extra) -> dict:
    kw = dict(genes=st["genes"], n_neighbors=st["k"], n_permutations=n_perms,
              use_existing_graph=True, seed=st["seed"], device=st["device"])
    kw.update(st["traffic"].get("args", {}))
    kw.update(extra)
    return kw


def setup(section: dict, traffic: dict, device) -> dict:
    from spatialcore_tpu_torch.spatial import morans_i

    adata, graph_s = adata_with_graph(section, device)
    st = {"adata": adata, "genes": gene_names(adata, section),
          "k": int(section["k"]), "seed": int(section["null_seed"]),
          "traffic": traffic, "device": device,
          "spans": {"graph_build_s": graph_s}}
    morans_i(adata, **_kw(st, WARM_DRAWS, **traffic.get("warm_args", {})))
    return st


def call(st: dict) -> None:
    from spatialcore_tpu_torch.spatial import morans_i

    morans_i(st["adata"], **_kw(st, int(st["traffic"]["n_permutations"])))


def work(st: dict) -> dict:
    return {"null_gpps": len(st["genes"]) * int(st["traffic"]["n_permutations"])}


def outputs(st: dict, smp: dict) -> dict:
    df = st["adata"].uns["morans_i"]
    out = {"I": torch.as_tensor(df["I"].to_numpy()[smp["genes"]]),
           "p": torch.as_tensor(df["p_value"].to_numpy()[smp["genes"]])}
    out.update(stored_graph(st["adata"], smp["cells"]))
    return out
