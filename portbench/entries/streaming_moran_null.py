"""``ops.streaming.streaming_moran_null`` over the whole panel.

Set-up builds the kNN graph (``ops.graph.build_graph``), the null plan
(``ops.banded.build_null_plan`` on the device) and S0, then warms up with
one call over one tile's width at the traffic's tile and a few draws. A
call streams every gene of the section in ``tile``-wide tiles with
``chunk`` draws a call of the banded null, at the traffic's precision.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.entries._public import sync

WARM_DRAWS = 2


def setup(section: dict, traffic: dict, device) -> dict:
    from spatialcore_tpu_torch.ops.banded import build_null_plan
    from spatialcore_tpu_torch.ops.graph import build_graph, graph_moments

    coords, X = section["coords"], section["X"]
    sync(device)
    t = time.perf_counter()
    graph = build_graph(coords, n_neighbors=int(section["k"]), device=device)
    sync(device)
    graph_s = time.perf_counter() - t
    plan = build_null_plan(graph, coords)
    cols = section["genes"]
    start = int(cols[0])
    if not np.array_equal(cols, np.arange(start, start + len(cols))):
        raise ValueError("streaming_moran_null streams a contiguous panel")
    st = {"graph": graph, "plan": plan, "S0": graph_moments(graph)["S0"],
          "get_tile": lambda s, w, ci: X[:, start + s:start + s + w],
          "n_genes": len(cols), "traffic": traffic, "device": device,
          "seed": int(section["null_seed"]), "spans": {"graph_build_s": graph_s}}
    _run(st, min(st["n_genes"], int(traffic["tile"])), WARM_DRAWS, WARM_DRAWS)
    return st


def _run(st: dict, n_genes: int, n_perms: int, chunk: int):
    from spatialcore_tpu_torch.ops.streaming import streaming_moran_null

    tr = st["traffic"]
    return streaming_moran_null(
        st["graph"], st["plan"], st["get_tile"], n_genes, st["S0"],
        seed=st["seed"], n_permutations=n_perms, tile=int(tr["tile"]),
        chunk=chunk, precision=tr["precision"]["null"], device=st["device"])


def call(st: dict) -> None:
    tr = st["traffic"]
    st["result"] = _run(st, st["n_genes"], int(tr["n_permutations"]),
                        int(tr["chunk"]))


def work(st: dict) -> dict:
    return {"null_gpps": st["n_genes"] * int(st["traffic"]["n_permutations"])}


def outputs(st: dict, smp: dict) -> dict:
    I, p, mean, std = (torch.as_tensor(a[smp["genes"]]) for a in st["result"])
    rows = torch.as_tensor(smp["cells"], device=st["graph"].neighbor_idx.device)
    return {"I": I, "p": p, "null_mean": mean, "null_std": std,
            "nbr": st["graph"].neighbor_idx[rows].cpu(),
            "w": st["graph"].neighbor_w[rows].cpu()}
