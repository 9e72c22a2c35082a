"""BENCHMARK.json against the benchmark's contract, every file found by
name, and a cell added as new files only."""

from __future__ import annotations

import hashlib
import json
import re
from pathlib import Path

import pytest
import torch

from portbench.harness import spec
from portbench.tests import tiny

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_paths():
    assert set(BENCH) == KEYS
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (REPO / p).is_dir()
    assert len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and (REPO / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        seen.add(c["name"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in seen and w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = [m["name"] for k in ("configs", "workloads") for m in BENCH[k]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len(set(names)) == len(names)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    cells = {w["name"] for w in BENCH["workloads"]}
    for cell in cells:
        e2e = spec.metrics_of(BENCH, cell, "end_to_end")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert spec.metrics_of(BENCH, cell, "per_layer")
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            assert cell in cells
            assert m["moves"] in {e["name"] for e in
                                  spec.metrics_of(BENCH, cell, "end_to_end")}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_files_found_by_name(cell):
    w = spec.cell(BENCH, cell)
    cfg = spec.config(REPO, BENCH, w["config"])
    tr = spec.traffic(REPO, w["traffic"])
    assert cfg["n_cells"] > 0 and cfg["n_neighbors"] > 0
    assert spec.entry(REPO, tr["entry"]).call
    assert spec.reference(REPO, tr["entry"]).expected
    assert spec.limits(REPO, cell)
    for kind in ("end_to_end", "per_layer"):
        for m in spec.metrics_of(BENCH, cell, kind):
            assert spec.metric_reader(REPO, m["name"]).read


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_and_metric_as_new_files_only(tmp_path):
    """A cell on a new configuration and traffic mix, with a new per-layer
    metric, runs from new files and new BENCHMARK.json entries alone."""
    from portbench import run

    root = tiny.make_root(tmp_path, ["tiny.morans"])
    before = _digest(root)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "tiny_k6.json").read_text())
    cfg.update(name="tiny_k8", n_neighbors=8, n_cells=5000)
    (pb / "configs" / "tiny_k8.json").write_text(json.dumps(cfg))
    tr = json.loads((pb / "traffic" / "t_morans.json").read_text())
    tr.update(genes=24, n_permutations=9)
    (pb / "traffic" / "t_morans_small.json").write_text(json.dumps(tr))
    (pb / "limits" / "tiny8.morans_small.json").write_text(json.dumps(
        {"graph_gap": 1e-4, "obs_gap": 1e-3, "p_gap": 0.5}))
    (pb / "metrics" / "calls_in_window.py").write_text(
        "def read(ctx):\n    return ctx['work']['null_gpps'] / 24 / 9\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_k8", "source": "test", "reduced": [],
                             "file": "portbench/configs/tiny_k8.json",
                             "why": "test"})
    bench["workloads"].append({"name": "tiny8.morans_small", "config": "tiny_k8",
                               "traffic": "t_morans_small", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "null_gpps":
            m["workloads"].append("tiny8.morans_small")
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "host dispatch", "moves": "null_gpps",
                               "workloads": ["tiny8.morans_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = tiny.run_cell(run, root, "tiny8.morans_small", trace=1)
    assert out["correct"] and out["metrics"]["calls_in_window"]["value"] >= 1
    after = _digest(root)
    assert all(after[k] == v for k, v in before.items())
