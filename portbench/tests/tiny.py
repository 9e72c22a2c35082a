"""A tiny benchmark beside the real one, for the CPU tests: a temporary
root holding a copy of ``portbench/`` and a ``BENCHMARK.json`` of small
cells that reuse the real entries, references and metric readers."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
LOOSE = {"graph_gap": 1e-4, "obs_gap": 1e-3, "p_gap": 0.5, "moment_gap": 1e-3,
         "p_flip_share": 1e-3, "p_adj_gap": 1e-3, "quadrant_gap": 1e-3}

CONFIGS = {
    "tiny_k6": {"n_cells": 6000, "n_genes": 300, "n_neighbors": 6,
                "extent_um": 800.0},
    "small_k16": {"n_cells": 100_000, "n_genes": 8, "n_neighbors": 16,
                  "extent_um": 3000.0},
}
COUNTS = {"log_rate_mean": -0.5, "log_rate_sd": 0.8, "signal_every": 4,
          "signal_amp": 1.5, "wavelength_um": [200.0, 600.0]}
TRAFFIC = {
    "t_int4": {"entry": "streaming_moran_null", "genes": None,
               "n_permutations": 30, "tile": 512, "chunk": 15,
               "precision": {"graph": "f32", "obs": "f32", "null": "int4"},
               "kernel_genes": 512, "compare_genes": 16,
               "compare_cells": 256},
    "t_morans": {"entry": "morans_i", "genes": 40, "n_permutations": 19,
                 "args": {"null_method": "banded"},
                 "warm_args": {"null_method": "banded"},
                 "precision": {"graph": "f32", "obs": "f32", "null": "bf16"},
                 "kernel_genes": 40, "compare_genes": 16,
                 "compare_cells": 256},
    "t_local_f32": {"entry": "local_morans_i", "genes": 4,
                    "n_permutations": 9, "alpha": 0.05,
                    "precision": {"graph": "f32", "obs": "f32", "null": "f32",
                                  "post": "f32"},
                    "compare_genes": 4, "compare_cells": 256},
    "t_local_int8": {"entry": "local_morans_i", "genes": 40,
                     "n_permutations": 19, "alpha": 0.05,
                     "args": {"null_method": "banded_int8",
                              "output_mode": "compact"},
                     "precision": {"graph": "f32", "obs": "f32",
                                   "null": "int8", "post": "f32"},
                     "kernel_genes": 40, "compare_genes": 8,
                     "compare_cells": 256},
}
CELLS = {"tiny.int4": ("tiny_k6", "t_int4"),
         "tiny.morans": ("tiny_k6", "t_morans"),
         "small.local_f32": ("small_k16", "t_local_f32"),
         "tiny.local_int8": ("tiny_k6", "t_local_int8")}
GLOBAL = ["tiny.int4", "tiny.morans"]
LOCAL = ["small.local_f32", "tiny.local_int8"]


def make_root(tmp: Path, cells=None) -> Path:
    """A root with the tiny benchmark (``cells``: a subset of CELLS)."""
    root = Path(tmp)
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = list(cells or CELLS)
    for name, c in CONFIGS.items():
        c = dict(c, name=name, block=256, counts=COUNTS)
        (root / "portbench" / "configs" / f"{name}.json").write_text(
            json.dumps(c))
    for name, t in TRAFFIC.items():
        (root / "portbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(t))
    for cell in cells:
        keys = ["graph_gap", "obs_gap"] + (
            ["p_gap"] + (["moment_gap"] if cell == "tiny.int4" else [])
            if cell in GLOBAL else ["p_flip_share", "p_adj_gap",
                                    "quadrant_gap"])
        (root / "portbench" / "limits" / f"{cell}.json").write_text(
            json.dumps({k: LOOSE[k] for k in keys}))
    used = {CELLS[c][0] for c in cells}
    g = [c for c in cells if c in GLOBAL]
    lo = [c for c in cells if c in LOCAL]
    bench = dict(real)
    bench["configs"] = [{"name": n, "source": "test", "file":
                         f"portbench/configs/{n}.json", "reduced": [],
                         "why": "test"} for n in CONFIGS if n in used]
    bench["workloads"] = [{"name": c, "config": CELLS[c][0],
                           "traffic": CELLS[c][1], "chips": 1, "why": "test"}
                          for c in cells]
    e2e = {m["name"]: dict(m) for m in real["end_to_end"]}
    e2e["null_gpps"]["workloads"] = g
    e2e["local_cgpps"]["workloads"] = lo
    bench["end_to_end"] = [m for m in e2e.values()
                           if m.get("workloads", True)]
    pl = []
    for m in real["per_layer"]:
        m = dict(m)
        if m["name"] == "graph_build_s":
            m["workloads"] = cells
        elif m["name"].endswith(".global"):
            m["workloads"] = g
        else:
            m["workloads"] = [c for c in lo if c == "tiny.local_int8"
                              or not m["name"].startswith("lisa")]
        if m["workloads"]:
            pl.append(m)
    bench["per_layer"] = pl
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def run_cell(run, root: Path, cell: str, trace: int = 0, seed: int = 2**31 + 77,
             seconds: float = 0.01) -> dict:
    """One run of ``cell`` on the CPU; its result line as a dict."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)], device="cpu",
                      root=root)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])
