"""Tiny Gi* hot-spot and local Geary cells beside ``tiny.py``'s, for the CPU
tests: the real traffic mixes ``getis_gi_int8`` and ``local_geary_int8``
at 6,000 cells, Gi* on 16 genes with 150 draws (int16 counters, as the
real cell's 999) and local Geary on 40 genes with 19."""

from __future__ import annotations

import contextlib
import json
from pathlib import Path

from portbench.tests import tiny

GI, GE = "tiny.getis_gi_int8", "tiny.local_geary_int8"
#: the tiny cells' limits: their counts are exact integers equal to the
#: reference's on the CPU, so no count may lie outside; the observed
#: values are float32 planes there (the host sink) against the reference's
#: bf16, one bf16 step (2**-8 of the value) apart at most
GI_LIMITS = {"graph_gap": 1e-4, "obs_gap.G": 0.01, "obs_gap.z": 0.01,
             "p_flip_share": 0.0, "p_adj_gap": 1e-3, "hotspot_gap": 0.0}
GE_LIMITS = {"graph_gap": 1e-4, "obs_gap": 0.01, "p_flip_share": 0.0,
             "p_adj_gap": 1e-3}
#: the real cells each stands in, in every list of BENCHMARK.json
STANDS_FOR = {GI: "xenium_1m.getis_gi_int8", GE: "xenium_1m.local_geary_int8"}


def make_root(tmp: Path) -> Path:
    """``tiny.make_root`` with ``tiny.local_int8``, plus the two cells, their
    traffic and limits, and their names in every list the real cells
    stand in."""
    root = tiny.make_root(Path(tmp), ["tiny.local_int8"])
    pb, real = root / "portbench", tiny.REPO / "portbench"
    gi = json.loads((real / "traffic" / "getis_gi_int8.json").read_text())
    gi.update(genes=16, n_permutations=150, kernel_genes=16, compare_genes=8,
              compare_cells=256, trace={"skip": 2, "active": 4})
    ge = json.loads((real / "traffic" / "local_geary_int8.json").read_text())
    ge.update(genes=40, n_permutations=19, kernel_genes=40, compare_genes=8,
              compare_cells=256, trace={"skip": 2, "active": 4})
    for name, t in (("t_getis_gi_int8", gi), ("t_local_geary_int8", ge)):
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for name, lim in ((GI, GI_LIMITS), (GE, GE_LIMITS)):
        (pb / "limits" / f"{name}.json").write_text(json.dumps(lim))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"] += [
        {"name": GI, "config": "tiny_k6", "traffic": "t_getis_gi_int8",
         "chips": 1, "why": "test"},
        {"name": GE, "config": "tiny_k6", "traffic": "t_local_geary_int8",
         "chips": 1, "why": "test"}]
    real_bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    real_lists = {m["name"]: m.get("workloads", []) for k in
                  ("end_to_end", "per_layer") for m in real_bench[k]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        ws, real_ws = m.get("workloads"), real_lists.get(m["name"], [])
        for cell, stands_for in STANDS_FOR.items():
            if ws is not None and stands_for in real_ws:
                ws.append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@contextlib.contextmanager
def fault(name: str, col: int):
    """A fault of the program while the block runs: ``"count_off"``, the
    first cell's count of column ``col`` (of each tile, ``col`` modulo its
    width) one draw off; ``"gi_log1p"``, Gi*'s observed pass fed log1p of
    the raw values; ``"geary_scaled"``, local Geary's observed C 2% high;
    ``"bh_low"``, every adjusted p 4% low (BH with its m one 256-cell block
    short of the 6,000 cells gives that where nothing is significant)."""
    import torch

    from spatialcore_tpu_torch.ops import banded, fdr, getis, moran

    if name == "count_off":
        mod, attr = banded, "_p_from_counts"
        orig = banded._p_from_counts

        def patched(count, P):
            if count.ndim == 2:             # the per-cell counts of a tile
                count = count.clone()
                j = col % count.shape[1]
                count[0, j] += -1 if int(count[0, j]) > 0 else 1
            return orig(count, P)
    elif name == "gi_log1p":
        mod, attr = getis, "getis_ord"
        orig = getis.getis_ord

        def patched(graph, X, *a, **kw):
            return orig(graph, torch.log1p(X), *a, **kw)
    elif name == "geary_scaled":
        mod, attr = moran, "local_geary"
        orig = moran.local_geary

        def patched(*a, **kw):
            r = orig(*a, **kw)
            return r._replace(local_C=r.local_C * 1.02)
    elif name == "bh_low":
        mod, attr = fdr, "apply_fdr"
        orig = fdr.apply_fdr

        def patched(*a, **kw):
            return orig(*a, **kw) * 0.96
    else:
        raise ValueError(name)
    setattr(mod, attr, patched)
    try:
        yield
    finally:
        setattr(mod, attr, orig)


#: each cell's faults
FAULTS = {GI: ("count_off", "gi_log1p", "bh_low"), GE: ("count_off", "geary_scaled")}


def first_compared_column(root: Path, cell: str, seed: int) -> int:
    """The first gene column ``cell``'s reference compares at ``seed``."""
    from portbench.harness import spec

    bench = spec.load_benchmark(root)
    tr = spec.traffic(root, spec.cell(bench, cell)["traffic"])
    ref = spec.reference(root, tr["entry"])
    return int(ref.sample(6000, int(tr["genes"]), seed, tr)["genes"][0])
