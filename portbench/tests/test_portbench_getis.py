"""The Gi* hot-spot cell at a tiny size on the CPU (``tiny_hotspot.py``):
a whole run agrees with its reference, the planted faults turn its
``correct`` false, the real cell's limits compare the adjusted p, and the
local draw step's roofline reader reads the Gi* instance on int16
counters."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.tests import tiny, tiny_hotspot
from portbench.work import lisa_count

torch.set_num_threads(1)

REAL = Path(__file__).resolve().parents[1]
METRICS = REAL / "metrics"
SEED = 2**31 + 77
CELL = tiny_hotspot.GI


def _reader(name):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_hotspot.make_root(tmp_path_factory.mktemp("pb_getis"))


def test_cell_agrees_with_reference(root):
    out = tiny.run_cell(run, root, CELL, trace=1, seed=SEED)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(tiny_hotspot.GI_LIMITS)
    assert out["checks"]["p_flip_share"]["value"] == 0.0
    # on the CPU no kernel runs: the device readers find nothing to read
    assert "lisa_count_roofline.local" not in out["metrics"]
    assert out["metrics"]["gathered_rows_per_draw.local"]["value"] == 0.0


@pytest.mark.parametrize("fault", tiny_hotspot.FAULTS[CELL])
def test_fault_is_not_correct(root, fault):
    col = tiny_hotspot.first_compared_column(root, CELL, SEED)
    with tiny_hotspot.fault(fault, col):
        out = tiny.run_cell(run, root, CELL, seed=SEED)
    assert not out["correct"], out["checks"]
    bad = {k for k, c in out["checks"].items()
           if not isinstance(c["value"], float) or c["value"] > c["limit"]}
    assert bad & {"count_off": {"p_flip_share"}, "bh_low": {"p_adj_gap"},
                  "gi_log1p": {"obs_gap.G", "obs_gap.z"}}[fault]


def test_reference_refuses_values_that_are_not_counts(root):
    from portbench.harness import spec

    ref = spec.reference(root, "getis_ord_gi")
    X = torch.tensor([[0.0, 3.0], [1.0, 0.5]], dtype=torch.float64)
    with pytest.raises(ValueError, match="whole numbers"):
        ref.whole(X)
    idx = torch.tensor([[1], [0]])
    with pytest.raises(ValueError, match="whole numbers"):
        ref.null_counts(torch.log1p(X.round()), idx, precision="int8", seed=1,
                        n_permutations=1)


def test_real_cell_compares_the_adjusted_p():
    # sound runs read at most 6.53e-4, the control (f16 -> fp8) 0.0263
    lim = json.loads((REAL / "limits" / "xenium_1m.getis_gi_int8.json")
                     .read_text())
    assert 6.53e-4 < lim["p_adj_gap"] < 0.0263
    # no compared cell of the real section is hot or cold: not compared
    assert "hotspot_gap" not in lim


def test_roofline_reader_reads_the_gi_star_draw_step():
    read = _reader("lisa_count_roofline.local")
    ctx = {"n_cells": 1_000_000, "k": 6,
           "traffic": json.loads((REAL / "traffic" / "getis_gi_int8.json")
                                 .read_text())}
    assert read(dict(ctx, trace=None)) is None
    observed = {"kernels": {
        "void (anonymous namespace)::lisa_kernel<2, 1, false, signed char, 0>(Args, Tail)": [1e-3]}}
    assert read(dict(ctx, trace=observed)) is None
    mine = {"kernels": dict(observed["kernels"], **{
        "void (anonymous namespace)::lisa_kernel<2, 1, true, short, 6>(Args, Tail)":
            [1.0e-3, 1.5e-3]})}
    # int16 counters: 2 bytes read and written a cell and gene
    least = lisa_count.seconds(1_000_000, 6, 256, 2)
    assert least == pytest.approx(2_334_000_000 / 3.35e12, rel=1e-3)
    assert read(dict(ctx, trace=mine)) == pytest.approx(100 * least / 1.25e-3)
