"""The yardstick's parts on the CPU: the frozen draw stream, the
reference kNN, the work counts, the trace reduction, the control, and
what the run and the reference import."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench.harness import trace
from portbench.reference import draws, knn, stats
from portbench.tests import tiny
from portbench.work import band_cross, lisa_count

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("n", [2, 1000, 4097, 65537])
@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 2**33 + 5])
def test_draws_match_the_program_stream(n, seed):
    from spatialcore_tpu_torch.core.rng import feistel_apply, fold_in, key_for

    P = draws.permutations(seed, "perm_feistel", [0, 3], n, "cpu")
    base = key_for(seed & 0xFFFFFFFF, "perm_feistel", 0)
    for i, d in enumerate([0, 3]):
        assert torch.equal(P[i], feistel_apply(fold_in(base, d),
                                               torch.arange(n), n))
    assert torch.equal(P[0].sort().values, torch.arange(n))


@pytest.mark.parametrize("n,k,scale", [(3000, 6, 1000.0), (2000, 50, 1000.0),
                                       (3000, 6, 30.0), (4000, 6, 2e4)])
def test_knn_matches_brute_force(n, k, scale):
    g = torch.Generator().manual_seed(n + k)
    c = torch.rand((n, 2), generator=g) * scale
    if scale < 100:
        c = torch.round(c)            # duplicated points
    if scale > 1e4:                   # a lattice of rounded bf16 values
        c = c.to(torch.bfloat16).to(torch.float32)
    i, d = knn.knn(c, k)
    ib, db = knn._brute(c, torch.arange(n), k)
    assert torch.equal(d, db) and torch.equal(i, ib)


def test_work_counts_on_a_hand_sized_graph():
    # 4 cells, 2 neighbours, 8 genes
    assert band_cross.work(4, 2, 8, "int4") == (4 * 8 * 0.5 + 4 * 2 * 5 + 32,
                                                128.0, "int8")
    assert band_cross.work(4, 2, 8, "bf16") == (4 * 8 * 2 + 4 * 2 * 6 + 32,
                                                128.0, "bf16")
    assert lisa_count.work(4, 2, 8) == (4 * 8 * 7 + 40, 128.0, "int8")
    # bytes bound: 1M x 4,096 int4 ~ 0.64 ms at 3.35 TB/s
    assert abs(band_cross.seconds(10**6, 6, 4096, "int4") - 0.6204e-3) < 2e-6


def test_trace_reduction():
    ev = [{"ph": "X", "name": "ProfilerStep#1", "cat": "user_annotation",
           "ts": 0.0, "dur": 100.0},
          {"ph": "X", "name": "ProfilerStep#2", "cat": "user_annotation",
           "ts": 100.0, "dur": 100.0},
          {"ph": "X", "name": "aten::where", "cat": "cpu_op", "ts": 40.0,
           "dur": 100.0},
          {"ph": "X", "name": "void k1(int)", "cat": "kernel", "ts": 10.0,
           "dur": 20.0},
          {"ph": "X", "name": "void k1(int)", "cat": "kernel", "ts": 25.0,
           "dur": 10.0},
          {"ph": "X", "name": "Memcpy DtoH", "cat": "gpu_memcpy", "ts": 150.0,
           "dur": 100.0}]
    s = trace.reduce_events(ev)
    assert s["window_s"] == pytest.approx(200e-6)
    assert s["busy_s"] == pytest.approx(75e-6)     # 10-35 and 150-200
    assert s["n_kernels"] == 2 and s["steps"] == 2
    gaps = dict(s["breakdown"]["idle_gaps"])
    assert gaps["aten::where"] == pytest.approx(115e-6)   # 35-150
    assert gaps["host, outside any op"] == pytest.approx(10e-6)
    assert dict(s["breakdown"]["device_ops"])["void k1"] == pytest.approx(30e-6)


def test_trace_without_step_ranges_spans_the_device_activity():
    ev = [{"ph": "X", "name": "cudaLaunchKernel", "cat": "cuda_runtime",
           "ts": 5.0, "dur": 2.0},
          {"ph": "X", "name": "void k1(int)", "cat": "kernel", "ts": 10.0,
           "dur": 20.0},
          {"ph": "X", "name": "void k1(int)", "cat": "kernel", "ts": 45.0,
           "dur": 5.0},
          {"ph": "X", "name": "void k1(int)", "cat": "kernel", "ts": 45.0,
           "dur": 5.0}]
    assert trace.reduce_events(ev) is None
    s = trace.reduce_events(ev, steps=2)
    assert s["window_s"] == pytest.approx(45e-6)
    assert s["busy_s"] == pytest.approx(25e-6)
    assert s["steps"] == 2 and s["n_kernels"] == 2


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_control_fails_the_limits(tmp_path, cell):
    """The control (the reference one precision step down) fails at least
    one of the cell's numbers; the limits of the real cell with the same
    precisions hold it."""
    from portbench.control import readings_for

    root = tiny.make_root(tmp_path, [cell])
    real = {"tiny.int4": "xenium_1m.global_int4",
            "tiny.morans": "xenium_1m.morans_auto",
            "small.local_f32": "cosmx_367k.local_moran_auto",
            "tiny.local_int8": "xenium_1m.local_moran_int8"}[cell]
    lim = json.loads((REPO / "portbench" / "limits" / f"{real}.json").read_text())
    rec = readings_for(root, cell, 2**31 + 5, program=False, device="cpu")
    assert any(v > lim[k] for k, v in rec["control"].items()), rec


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_program_nor_jax():
    mods = _modules_after(
        "import json, sys, torch\n"
        "from portbench.harness import spec\n"
        "from pathlib import Path\n"
        "for e in ('streaming_moran_null', 'morans_i', 'local_morans_i'):\n"
        "    spec.reference(Path('.'), e)\n"
        "from portbench.reference import stats\n"
        "Z = torch.randn(500, 3, dtype=torch.float64)\n"
        "idx = torch.randint(0, 500, (500, 4)); w = torch.full((500, 4), .25)\n"
        "stats.global_moran(Z, idx, w, obs_precision='f32', null_precision='int4',"
        " seed=1, n_permutations=3)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert not mods & {"jax", "jaxlib", "flax", "spatialcore_tpu",
                       "spatialcore_tpu_torch"}


def test_run_imports_no_jax(tmp_path):
    root = tiny.make_root(tmp_path, ["tiny.morans"])
    mods = _modules_after(
        "import json, sys\n"
        "from portbench import run\n"
        "from portbench.tests import tiny\n"
        f"tiny.run_cell(run, {str(root)!r}, 'tiny.morans', trace=1)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    assert "spatialcore_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "spatialcore_tpu"}


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "xenium_1m.global_int4", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_checkout_without_the_program_fails(tmp_path):
    """A directory holding only BENCHMARK.json and portbench/ gives no
    result (here: no card; on the card: the program does not import)."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "xenium_1m.morans_auto", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_precision_ladder():
    assert stats.LOWER == {"f32": "bf16", "bf16": "int8", "f16": "fp8",
                           "int8": "int4", "int4": "int2"}
