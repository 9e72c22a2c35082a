"""Tiny Lee's L and int8 Moran's I cells beside ``tiny.py``'s, for the CPU
tests: the real traffic mixes ``lees_local_int8`` and ``morans_int8`` at
6,000 cells, 19 draws, with a tiny ligand-receptor-shaped pair list drawn
by the real list's rule from a 300-gene panel."""

from __future__ import annotations

import contextlib
import json
from pathlib import Path

import numpy as np

from portbench.tests import tiny

LEE, MI8 = "tiny.lees_int8", "tiny.morans_int8"
TILE = 256
#: the tiny cell's limits: its counts are exact integers equal to the
#: reference's on the CPU, so no count may lie outside
LEE_LIMITS = {"graph_gap": 1e-4, "obs_gap": 0.02, "p_flip_share": 0.0,
              "p_adj_gap": 1e-3, "quadrant_gap": 1e-3}
MI8_LIMITS = {"graph_gap": 1e-4, "obs_gap": 1e-3, "p_gap": 0.5}


def pairs(n_genes: int = 300, n_pairs: int = 320, n_lig: int = 40,
          n_rec: int = 60, seed: int = 26) -> list:
    """``[x, y]`` panel indices: disjoint ligand and receptor sets, Zipf 0.6
    degrees, listed ligand by ligand (the real list's rule, scaled)."""
    rng = np.random.default_rng(seed)
    genes = rng.permutation(n_genes)
    lig, rec = genes[:n_lig], genes[n_lig:n_lig + n_rec]
    pl = 1 / np.arange(1, n_lig + 1) ** 0.6
    pr = 1 / np.arange(1, n_rec + 1) ** 0.6
    pl, pr = pl / pl.sum(), pr / pr.sum()
    out = set()
    while len(out) < n_pairs:
        out.add((int(rng.choice(n_lig, p=pl)), int(rng.choice(n_rec, p=pr))))
    return [[int(lig[a]), int(rec[b])] for a, b in sorted(out)]


PAIRS = pairs()


def tile_counts(p: list = PAIRS, tile: int = TILE) -> dict:
    """What the ``lee.*`` counters add for one call's pair tiles."""
    tiles = [p[s:s + tile] for s in range(0, len(p), tile)]
    return {"lee.pairs": len(p),
            "lee.x_genes": sum(len({x for x, _ in t}) for t in tiles),
            "lee.y_genes": sum(len({y for _, y in t}) for t in tiles)}


def make_root(tmp: Path) -> Path:
    """``tiny.make_root`` with ``tiny.local_int8`` and ``tiny.morans``, plus
    the two cells, their traffic and limits, and their names in every list
    the real cells stand in."""
    root = tiny.make_root(Path(tmp), ["tiny.morans", "tiny.local_int8"])
    pb, real = root / "portbench", tiny.REPO / "portbench"
    lee = json.loads((real / "traffic" / "lees_local_int8.json").read_text())
    lee.update(genes=len(PAIRS), n_permutations=19, pairs=PAIRS,
               compare_genes=8, compare_cells=256, trace={"skip": 2, "active": 4})
    mi8 = json.loads((real / "traffic" / "morans_int8.json").read_text())
    mi8.update(genes=40, n_permutations=19, kernel_genes=40, compare_genes=16,
               compare_cells=256)
    for name, t in (("t_lees_int8", lee), ("t_morans_int8", mi8)):
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for name, lim in ((LEE, LEE_LIMITS), (MI8, MI8_LIMITS)):
        (pb / "limits" / f"{name}.json").write_text(json.dumps(lim))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"] += [
        {"name": LEE, "config": "tiny_k6", "traffic": "t_lees_int8",
         "chips": 1, "why": "test"},
        {"name": MI8, "config": "tiny_k6", "traffic": "t_morans_int8",
         "chips": 1, "why": "test"}]
    real_lists = {m["name"]: m.get("workloads", []) for k in
                  ("end_to_end", "per_layer") for m in json.loads(
                      (tiny.REPO / "BENCHMARK.json").read_text())[k]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        ws, real_ws = m.get("workloads"), real_lists.get(m["name"], [])
        for cell, stands_for in ((LEE, "xenium_1m.lees_local_int8"),
                                 (MI8, "xenium_1m.morans_int8")):
            if ws is not None and stands_for in real_ws:
                ws.append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@contextlib.contextmanager
def fault(name: str, col: int):
    """A fault of the program while the block runs: ``"count_off"``, the
    first cell's count of pair column ``col`` (of each tile, ``col`` modulo
    its width) one draw off; ``"x_y_swapped"``, pair ``col``'s x and y
    genes swapped before its tile is built."""
    from spatialcore_tpu_torch.ops import banded
    from spatialcore_tpu_torch.spatial import autocorrelation as ac

    if name == "count_off":
        mod, attr = banded, "_p_from_counts"
        orig = banded._p_from_counts

        def patched(count, P):
            if count.ndim == 2:             # the per-cell counts of a tile
                count = count.clone()
                j = col % count.shape[1]
                count[0, j] += -1 if int(count[0, j]) > 0 else 1
            return orig(count, P)
    elif name == "x_y_swapped":
        mod, attr = ac, "_run_compact_stream"
        orig = ac._run_compact_stream

        def patched(*args, pair_names=None, **kw):
            gx, gy = list(pair_names[0]), list(pair_names[1])
            gx[col], gy[col] = gy[col], gx[col]
            return orig(*args, pair_names=(gx, gy), **kw)
    else:
        raise ValueError(name)
    setattr(mod, attr, patched)
    try:
        yield
    finally:
        setattr(mod, attr, orig)


FAULTS = ("count_off", "x_y_swapped")


def first_compared_column(root: Path, seed: int) -> int:
    """The first pair column the Lee cell's reference compares at ``seed``."""
    from portbench.harness import spec

    tr = spec.traffic(root, "t_lees_int8")
    ref = spec.reference(root, "lees_l_local")
    return int(ref.sample(6000, len(PAIRS), seed, tr)["genes"][0])
