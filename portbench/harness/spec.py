"""Everything a run needs, found by the names in ``BENCHMARK.json``.

- a configuration is the JSON file its ``configs`` entry names;
- a traffic mix is ``portbench/traffic/<traffic>.json``;
- the traffic names its ``entry``: the program's call is
  ``portbench/entries/<entry>.py`` and its reference
  ``portbench/reference/<entry>.py``;
- a metric, end to end or per layer, is read by
  ``portbench/metrics/<metric name>.py``;
- a cell's correctness limits are ``portbench/limits/<cell name>.json``.

Adding a cell, a configuration, a traffic mix or a metric is adding files
and entries; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

PB = "portbench"


def load_benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(root: Path, bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((Path(root) / c["file"]).read_text())
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(root: Path, name: str) -> dict:
    return json.loads((Path(root) / PB / "traffic" / f"{name}.json").read_text())


def limits(root: Path, cell_name: str) -> dict:
    return json.loads((Path(root) / PB / "limits" / f"{cell_name}.json")
                      .read_text())


def _load(root: Path, kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py`` of this root, loaded from
    its path (a name may hold dots); it imports what it shares with others
    absolutely, from the ``portbench`` package."""
    path = Path(root) / PB / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file for {name!r} at {path}")
    mod_name = f"{PB}_{kind}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(root: Path, name: str):
    return _load(root, "entries", name)


def reference(root: Path, name: str):
    return _load(root, "reference", name)


def metric_reader(root: Path, name: str):
    return _load(root, "metrics", name)


def applies(metric: dict, cell_name: str, bench: dict) -> bool:
    """Whether a metric is reported in a cell: its ``workloads`` list, or,
    without one, every cell (a per-layer metric: every cell that reports
    the end-to-end metric it ``moves``)."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    for m in bench["end_to_end"]:
        if m["name"] == moves:
            return applies(m, cell_name, bench)
    return False


def metrics_of(bench: dict, cell_name: str, kind: str) -> list:
    return [m for m in bench[kind] if applies(m, cell_name, bench)]
