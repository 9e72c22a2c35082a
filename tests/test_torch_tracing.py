"""The port's tracing (``spatialcore_tpu_torch.utils.profiling``): spans,
counters and read-backs on the CPU.

- Off, nothing is recorded and no profiler range is opened; counters
  count either way.
- Spans nest with the right parent and call ids; self time and total
  wait add up.
- ``rng.feistel_passes`` equals a direct count of the cycle walk, and one
  ``feistel_apply`` call on the CPU reads back once a pass (the round keys
  are Python ints).
- Answers are bitwise the same with tracing on and off.
- A ``profile_trace`` holds the program's ``spatialcore.*`` ranges one to
  one with the in-memory spans, nested alike and in the same order.
- The benchmark's readers of the program's counters and spans, on a
  hand-built context and in a traced run of a tiny cell.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from spatialcore_tpu_torch.core import SpatialData
from spatialcore_tpu_torch.core import rng
from spatialcore_tpu_torch.kernels import band_cross as kern
from spatialcore_tpu_torch.kernels import feistel as kern_feistel
from spatialcore_tpu_torch.kernels import knn as kern_knn
from spatialcore_tpu_torch.kernels import lisa_count as kern_lisa
from spatialcore_tpu_torch.ops import banded as tb
from spatialcore_tpu_torch.ops import graph as tg
from spatialcore_tpu_torch.ops import streaming as ts
from spatialcore_tpu_torch.spatial import local_morans_i, morans_i
from spatialcore_tpu_torch.utils import profiling as prof

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
N, G = 1500, 12


@pytest.fixture(autouse=True)
def _clean():
    prof.reset()
    yield
    prof.reset()


@pytest.fixture(scope="module")
def section():
    r = np.random.default_rng(5)
    c = r.uniform(0, 120, (N, 2)).astype(np.float32)
    X = np.concatenate(
        [2 * np.sin(c[:, :1] / 10.0) + r.normal(0, 0.5, (N, 1))
         for _ in range(G // 2)] + [r.normal(0, 1, (N, G // 2))],
        axis=1).astype(np.float32)
    graph = tg.build_graph(c, n_neighbors=6, device="cpu")
    plan = tb.build_null_plan(graph, torch.as_tensor(c), block=64)
    return {"coords": c, "X": X, "graph": graph, "plan": plan,
            "S0": tg.graph_moments(graph)["S0"]}


def _streaming(s, precision="bf16"):
    X = s["X"]
    if precision == "int4":             # int4 tiles are 256-multiples
        X = np.tile(X, (1, 22))[:, :256]
    return ts.streaming_moran_null(
        s["graph"], s["plan"], lambda a, w, ci: X[:, a:a + w], X.shape[1],
        s["S0"], seed=3, n_permutations=7, tile=256 if precision == "int4"
        else 8, chunk=4, precision=precision, device="cpu")


def _adata(s):
    a = SpatialData(X=s["X"].copy())
    a.obsm["spatial"] = s["coords"]
    return a


def _local(s, null_method):
    a = local_morans_i(_adata(s), n_neighbors=6, n_permutations=9, seed=4,
                       null_method=null_method, device="cpu")
    return [a.obsm[f"local_morans_{k}"]
            for k in ("I", "z", "lag", "p", "p_adj", "quadrant")]


def _streaming_local(s):
    sink, store = ts.host_local_sink(N, G)
    ts.streaming_local_null(s["graph"], s["plan"],
                            lambda a, w: s["X"][:, a:a + w], G, sink, seed=2,
                            n_permutations=9, tile=8, device="cpu")
    return [store[k] for k in sorted(store)]


def _morans(s):
    a = morans_i(_adata(s), n_neighbors=6, n_permutations=9, seed=1,
                 null_method="banded", device="cpu")
    return [a.uns["morans_i"][c].to_numpy() for c in ("I", "p_value")]


RUNS = {"streaming_bf16": _streaming,
        "streaming_int4": lambda s: _streaming(s, "int4"),
        "local_morans_banded": lambda s: _local(s, "banded"),
        "local_morans_int8": lambda s: _local(s, "banded_int8"),
        "streaming_local_int8": _streaming_local,
        "morans_banded": _morans}
#: the runs whose draw steps read the table through the draw's rows
READ_THROUGH = ("local_morans_int8", "streaming_local_int8")


def _equal(a, b) -> bool:
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b)) and len(a) == len(b)


# --------------------------------------------------------------------------
# Off costs nothing but counters
# --------------------------------------------------------------------------


@pytest.mark.parametrize("run", ["streaming_bf16", "local_morans_banded"])
def test_off_records_no_span_and_opens_no_range(section, run, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    RUNS[run](section)
    assert prof.spans() == []
    c = prof.counters()
    assert c["draws"] > 0 and c["rng.feistel_calls"] == c["draws"]
    assert c["host_syncs"] > c["rng.feistel_passes"] >= c["draws"]


# --------------------------------------------------------------------------
# Spans: parents, calls, self time, wait
# --------------------------------------------------------------------------


def _dur(d):
    return d["end_ns"] - d["start_ns"]


def test_spans_nest_with_parents_calls_and_sums():
    with prof.tracing():
        with prof.span("a"):
            prof._blocking(time.sleep, 0.002)
            with prof.span("b"):
                with prof.span("c"):
                    prof._blocking(time.sleep, 0.003)
            with prof.timer("d", sync=False):
                prof.read_back(torch.ones(3))
        with prof.span("e"):
            pass
    with prof.span("off"):          # tracing is off again
        pass
    sp = {d["name"]: d for d in prof.spans()}
    assert [d["name"] for d in prof.spans()] == ["a", "b", "c", "d", "e"]
    a, b, c, d, e = (sp[k] for k in "abcde")
    assert a["parent"] is None and e["parent"] is None
    assert b["parent"] == a["id"] and d["parent"] == a["id"]
    assert c["parent"] == b["id"]
    assert a["call"] == b["call"] == c["call"] == d["call"] != e["call"]
    assert a["self_ns"] == _dur(a) - _dur(b) - _dur(d) >= 0
    assert b["self_ns"] == _dur(b) - _dur(c)
    assert c["self_ns"] == _dur(c)
    assert a["wait_ns"] >= 2_000_000 and c["wait_ns"] >= 3_000_000
    assert b["wait_ns"] == 0 and b["total_wait_ns"] == c["wait_ns"]
    assert d["total_wait_ns"] == d["wait_ns"]
    assert a["total_wait_ns"] == (a["wait_ns"] + b["total_wait_ns"]
                                  + d["total_wait_ns"])
    assert c["wait_ns"] <= _dur(c) and a["total_wait_ns"] <= _dur(a)
    assert prof.counters()["host_syncs"] == 3


def test_span_left_open_by_an_exception_leaves_the_stack_clean():
    with prof.tracing():
        with pytest.raises(ValueError):
            with prof.span("outer"):
                with prof.span("inner"):
                    raise ValueError
        with prof.span("next"):
            pass
    sp = {d["name"]: d for d in prof.spans()}
    assert sp["next"]["parent"] is None
    assert sp["inner"]["parent"] == sp["outer"]["id"]
    assert all(d["end_ns"] is not None for d in sp.values())


def test_launch_counts_live_in_the_registry():
    for mod, key, name in ((kern, "float", "kernels.band_cross.float"),
                           (kern_lisa, "lisa_win", "kernels.lisa_count.lisa_win"),
                           (kern_knn, "knn", "kernels.knn.knn"),
                           (kern_feistel, "walk", "kernels.feistel.walk")):
        assert dict(mod.LAUNCHES) == {k: 0 for k in mod.LAUNCHES}
        mod.LAUNCHES[key] += 2
        assert prof.counters()[name] == 2 and mod.LAUNCHES[key] == 2
        assert {**mod.LAUNCHES}[key] == 2
        mod.reset_launch_counts()
        assert not any(mod.LAUNCHES.values()) and name not in prof.counters()
    with pytest.raises(KeyError):
        kern.LAUNCHES["no_such_mode"] += 1


# --------------------------------------------------------------------------
# Feistel passes and read-backs against a direct count
# --------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _walk(x: int, keys, bits: int, n: int) -> tuple:
    """One value's cycle walk in Python integers: (value, evaluations)."""
    mask = (1 << bits) - 1
    passes = 0
    while True:
        left, right = x >> bits, x & mask
        for k in keys:
            h = ((right ^ k) * 0x9E3779B1) & _M32
            h ^= h >> 15
            h = (h * 0x85EBCA77) & _M32
            h ^= h >> 13
            left, right = right, (left ^ h) & mask
        x = (left << bits) | right
        passes += 1
        if x < n:
            return x, passes


@pytest.mark.parametrize("n,seed", [(300, 0), (300, 7), (1025, 1),
                                    (4000, 2), (4096, 3)])
def test_feistel_passes_and_syncs_match_a_direct_count(n, seed):
    k = rng.key_for(seed, "perm_feistel", 0)
    keys = rng.feistel_round_keys(k)
    bits = max((int(n - 1).bit_length() + 1) // 2, 1)
    bits += (1 << (2 * bits)) < n
    idx = np.random.default_rng(seed).integers(0, n, 257)
    walks = [_walk(int(i), keys, bits, n) for i in idx]
    prof.reset()
    got = rng.feistel_apply(k, torch.as_tensor(idx), n)
    want = max(w[1] for w in walks)
    c = prof.counters()
    assert got.tolist() == [w[0] for w in walks]
    assert c["rng.feistel_calls"] == 1
    assert c["rng.feistel_passes"] == want
    assert c["host_syncs"] == want


def test_counts_kept_on_the_card_fold_in_when_read_or_reset(monkeypatch):
    held = {"n": 5}

    def fold():
        if held["n"]:
            prof.count("test.folded", held["n"])
            held["n"] = 0

    monkeypatch.setattr(prof, "_folds", [*prof._folds, fold])
    assert prof.counters()["test.folded"] == 5
    assert prof.counters()["test.folded"] == 5
    held["n"] = 2
    prof.reset()
    assert "test.folded" not in prof.counters() and held["n"] == 0


def test_feistel_walk_on_the_cpu_launches_nothing_and_checks_its_arguments():
    k = rng.fold_in(rng.key_for(3, "perm_feistel", 0), 1)
    idx = torch.arange(300)
    keys = rng.feistel_round_keys(k)
    rows = rng.feistel_apply(k, idx, 300)
    assert sorted(rows.tolist()) == list(range(300))
    assert kern_feistel.feistel_walk(idx.to(torch.int32), keys, 5, 300).tolist() \
        == rows.tolist()
    assert prof.counters().get("kernels.feistel.walk", 0) == 0
    for bad in (dict(idx=idx.float()), dict(bits=4), dict(bits=17, n=300),
                dict(n=1), dict(round_keys=keys[:7]),
                dict(idx=torch.arange(300, device="meta"))):
        args = {**dict(idx=idx, round_keys=keys, bits=5, n=300), **bad}
        with pytest.raises(ValueError):
            kern_feistel.feistel_walk(**args)


# --------------------------------------------------------------------------
# Bitwise answers with tracing on and off
# --------------------------------------------------------------------------


@pytest.mark.parametrize("run", list(RUNS))
def test_answers_bitwise_with_tracing_on_and_off(section, run):
    off = RUNS[run](section)
    c_off = prof.counters()
    prof.reset()
    with prof.tracing():
        on = RUNS[run](section)
    assert _equal(off, on)
    assert prof.counters() == c_off
    names = {d["name"] for d in prof.spans()}
    assert {"draws", "draw", "core.rng.feistel"} <= names
    # the int8 local nulls read the value table through the draw's rows:
    # they gather nothing; every other null gathers its rows a draw
    assert ("ops.banded.gather" in names) == (run not in READ_THROUGH)
    draws = [d for d in prof.spans() if d["name"] == "draw"]
    assert len(draws) == c_off["draws"]
    assert all(d["parent"] is not None for d in draws)


# --------------------------------------------------------------------------
# The profiler's trace holds the spans
# --------------------------------------------------------------------------


def _nest(events):
    """Each event's parent index by containment, events in start order."""
    stack, parents = [], []
    for i, e in enumerate(events):
        end = e["ts"] + e["dur"]
        while stack and not (events[stack[-1]]["ts"] <= e["ts"] and
                             end <= events[stack[-1]]["ts"]
                             + events[stack[-1]]["dur"]):
            stack.pop()
        parents.append(stack[-1] if stack else None)
        stack.append(i)
    return parents


@pytest.mark.parametrize("run", ["streaming_bf16", "local_morans_banded"])
def test_profile_trace_holds_the_spans(section, run, tmp_path):
    with prof.profile_trace(tmp_path) as path:
        RUNS[run](section)
    sp = prof.spans()
    events = sorted((e for e in json.loads(Path(path).read_text())
                     ["traceEvents"] if e.get("ph") == "X"
                     and str(e.get("name", "")).startswith("spatialcore.")),
                    key=lambda e: (e["ts"], -e["dur"]))
    assert [e["name"] for e in events] == ["spatialcore." + d["name"]
                                           for d in sp]
    index = {d["id"]: i for i, d in enumerate(sp)}
    assert _nest(events) == [index.get(d["parent"]) for d in sp]
    n_draw = sum(e["name"] == "spatialcore.draw" for e in events)
    assert n_draw == prof.counters()["draws"] > 0


# --------------------------------------------------------------------------
# The benchmark's readers
# --------------------------------------------------------------------------


def _reader(name):
    from portbench.harness import spec

    return spec.metric_reader(REPO, name)


@pytest.mark.parametrize("scope", ["global", "local"])
def test_counter_readers_on_a_hand_built_context(scope):
    passes = _reader(f"feistel_passes_per_draw.{scope}")
    syncs = _reader(f"host_syncs_per_draw.{scope}")
    ctx = {"tracer": None, "trace": None}
    assert passes.read(ctx) is None and syncs.read(ctx) is None
    prof.count("rng.feistel_calls", 4)
    prof.count("rng.feistel_passes", 22)
    prof.count("draws", 4)
    prof.count("host_syncs", 27)
    assert passes.read(ctx) == 5.5
    assert syncs.read(ctx) == 6.75


@pytest.mark.parametrize("scope", ["global", "local"])
def test_wait_reader_on_a_hand_built_context(scope):
    wait = _reader(f"host_wait_ms_per_draw.{scope}")
    ctx = {"tracer": SimpleNamespace(active=2)}
    assert wait.read(ctx) is None
    with prof.tracing():
        with prof.span("draws"):
            for ms in (1, 3, 20):
                with prof.span("draw"):
                    prof._blocking(time.sleep, ms * 1e-3)
                    with prof.span("core.rng.feistel"):
                        prof._blocking(time.sleep, ms * 1e-3)
    draws = [d for d in prof.spans() if d["name"] == "draw"]
    want = 1e-6 * (draws[0]["total_wait_ns"] + draws[1]["total_wait_ns"]) / 2
    assert wait.read(ctx) == pytest.approx(want, rel=1e-12)
    assert 4.0 <= wait.read(ctx) < 20.0
    assert wait.read({"tracer": None}) is None


_TINY_RUNS = """
import json, sys
import torch
torch.set_num_threads(1)
from pathlib import Path
from portbench import run
from portbench.tests import tiny
from spatialcore_tpu_torch.utils import profiling
root = tiny.make_root(Path(sys.argv[1]), sys.argv[2:])
for cell in sys.argv[2:]:
    profiling.reset()
    out = tiny.run_cell(run, root, cell, trace=1)
    print(json.dumps({"cell": cell, "out": out,
                      "counters": profiling.counters()}))
"""


def test_traced_tiny_cells_report_the_program_metrics(tmp_path):
    """A ``--trace 1`` run of a tiny global and a tiny local cell, in a
    process of its own (the harness refuses a process that holds JAX),
    reports the six metrics beside the accepted ones."""
    import subprocess
    import sys

    cells = ["tiny.morans", "tiny.local_int8"]
    res = subprocess.run([sys.executable, "-c", _TINY_RUNS, str(tmp_path)]
                         + cells, cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(x) for x in res.stdout.splitlines()
             if x.startswith('{"cell"')]
    assert [x["cell"] for x in lines] == cells
    for x in lines:
        scope = "global" if x["cell"] == "tiny.morans" else "local"
        m, c = x["out"]["metrics"], x["counters"]
        assert x["out"]["correct"]
        assert {f"feistel_ms_per_draw.{scope}",
                f"kernel_launches_per_draw.{scope}"} <= set(m)
        assert m[f"feistel_passes_per_draw.{scope}"]["value"] == (
            c["rng.feistel_passes"] / c["rng.feistel_calls"])
        assert m[f"host_syncs_per_draw.{scope}"]["value"] == (
            c["host_syncs"] / c["draws"])
        # passes a draw from the domain: 6,000 cells in 4**7 values
        assert 15 < m[f"feistel_passes_per_draw.{scope}"]["value"] < 28
        assert m[f"host_wait_ms_per_draw.{scope}"]["value"] >= 0
