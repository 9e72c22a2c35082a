"""The local Geary cell at a tiny size on the CPU (``tiny_hotspot.py``): a
whole run agrees with its reference, the planted faults turn its
``correct`` false, and the local draw step's roofline reader reads the
geary instance."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.tests import tiny, tiny_hotspot
from portbench.work import lisa_count

torch.set_num_threads(1)

METRICS = Path(__file__).resolve().parents[1] / "metrics"
SEED = 2**31 + 77
CELL = tiny_hotspot.GE


def _reader(name):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_hotspot.make_root(tmp_path_factory.mktemp("pb_geary"))


def test_cell_agrees_with_reference(root):
    out = tiny.run_cell(run, root, CELL, trace=1, seed=SEED)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(tiny_hotspot.GE_LIMITS)
    assert out["checks"]["p_flip_share"]["value"] == 0.0
    assert "lisa_count_roofline.local" not in out["metrics"]
    assert {"local_cgpps"} <= set(tiny.run_cell(run, root, CELL,
                                                seed=SEED)["metrics"])


@pytest.mark.parametrize("fault", tiny_hotspot.FAULTS[CELL])
def test_fault_is_not_correct(root, fault):
    col = tiny_hotspot.first_compared_column(root, CELL, SEED)
    with tiny_hotspot.fault(fault, col):
        out = tiny.run_cell(run, root, CELL, seed=SEED)
    assert not out["correct"], out["checks"]
    bad = {k for k, c in out["checks"].items()
           if not isinstance(c["value"], float) or c["value"] > c["limit"]}
    assert bad & ({"p_flip_share"} if fault == "count_off" else {"obs_gap"})


def test_roofline_reader_reads_the_geary_draw_step():
    read = _reader("lisa_count_roofline.local")
    ctx = {"n_cells": 1_000_000, "k": 6,
           "traffic": {"kernel_genes": 256, "counter_bytes": 1}}
    assert read(dict(ctx, trace=None)) is None
    observed = {"kernels": {
        "void (anonymous namespace)::lisa_kernel<1, 1, false, signed char, 0>(Args, Tail)": [1e-3]}}
    assert read(dict(ctx, trace=observed)) is None
    mine = {"kernels": dict(observed["kernels"], **{
        "void (anonymous namespace)::lisa_kernel<1, 1, true, signed char, 6>(Args, Tail)":
            [0.8e-3, 1.2e-3]})}
    least = lisa_count.seconds(1_000_000, 6, 256)
    assert read(dict(ctx, trace=mine)) == pytest.approx(100 * least / 1.0e-3)
