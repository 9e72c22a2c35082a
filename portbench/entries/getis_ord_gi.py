"""``spatial.getis_ord_gi`` on the section's raw counts on the device, with
the stored graph and every other argument at its default but the
traffic's.

Gi* reads raw values. Where the traffic says ``values: raw_counts``,
set-up turns the section's X (log1p counts) back into the counts in
place, ``round(expm1(X))`` (exact for these counts), so the card holds
the one matrix a deployment holds, and marks the section
(``raw_counts``) so that the reference reads it as it stands. Set-up
then stores the graph (``build_spatial_weights``) and warms up with one
call at the traffic's genes and arguments and ``WARM_DRAWS`` draws, the
fewest that take the int16 counters of the window's calls, which also
builds and caches the null plan.
"""

from __future__ import annotations

import torch

from portbench.entries._public import adata_with_graph, gene_names, stored_graph

#: the fewest draws whose counters are int16, as the window's 999 are
WARM_DRAWS = 128
KEY = "getis_ord"
PLANES = ("G", "z", "p", "p_sim", "p_adj", "hotspot")


def to_raw_counts(section: dict) -> None:
    """The section's log1p counts back to the counts, in place, once."""
    if not section.get("raw_counts"):
        section["X"].expm1_().round_()
        section["raw_counts"] = True


def _kw(st: dict, n_perms: int) -> dict:
    kw = dict(genes=st["genes"], n_neighbors=st["k"], n_permutations=n_perms,
              use_existing_graph=True, seed=st["seed"], device=st["device"])
    kw.update(st["traffic"].get("args", {}))
    return kw


def setup(section: dict, traffic: dict, device) -> dict:
    from spatialcore_tpu_torch.spatial import getis_ord_gi

    if traffic.get("values") == "raw_counts":
        to_raw_counts(section)
    adata, graph_s = adata_with_graph(section, device)
    st = {"adata": adata, "genes": gene_names(adata, section),
          "k": int(section["k"]), "seed": int(section["null_seed"]),
          "traffic": traffic, "device": device,
          "spans": {"graph_build_s": graph_s}}
    getis_ord_gi(adata, **_kw(st, WARM_DRAWS))
    return st


def call(st: dict) -> None:
    from spatialcore_tpu_torch.spatial import getis_ord_gi

    getis_ord_gi(st["adata"], **_kw(st, int(st["traffic"]["n_permutations"])))


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
