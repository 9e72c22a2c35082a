"""The Lee's L cell and the int8 Moran's I cell at a tiny size on the CPU
(``tiny_lee.py``): each agrees with its reference, the faults turn the
Lee cell's ``correct`` false, the ``lee.*`` counters and their reader, and
the Lee draw step's work count and roofline reader."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.tests import tiny, tiny_lee
from portbench.work import lee_count
from spatialcore_tpu_torch.utils import profiling

torch.set_num_threads(1)

METRICS = Path(__file__).resolve().parents[1] / "metrics"
SEED = 2**31 + 77


def _reader(name):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_lee.make_root(tmp_path_factory.mktemp("pb_lee"))


@pytest.mark.parametrize("cell", [tiny_lee.LEE, tiny_lee.MI8])
def test_cell_agrees_with_reference(root, cell):
    out = tiny.run_cell(run, root, cell, seed=SEED)
    assert out["correct"], out["checks"]
    want = (tiny_lee.LEE_LIMITS if cell == tiny_lee.LEE
            else tiny_lee.MI8_LIMITS)
    assert set(out["checks"]) == set(want)
    assert set(out["metrics"]) == {"setup_s", "local_cgpps" if cell ==
                                   tiny_lee.LEE else "null_gpps"}


@pytest.mark.parametrize("fault", tiny_lee.FAULTS)
def test_fault_is_not_correct(root, fault):
    col = tiny_lee.first_compared_column(root, SEED)
    with tiny_lee.fault(fault, col):
        out = tiny.run_cell(run, root, tiny_lee.LEE, seed=SEED)
    assert not out["correct"], out["checks"]


def test_counters_and_their_reader(root):
    profiling.reset()
    out = tiny.run_cell(run, root, tiny_lee.LEE, trace=1, seed=SEED)
    c = profiling.counters()
    one = tiny_lee.tile_counts()
    calls = c["lee.pairs"] // one["lee.pairs"]
    assert calls == 1 + out["attempted"]            # the warm-up and the window
    assert {k: c[k] for k in one} == {k: v * calls for k, v in one.items()}
    y_dup = 100 * (1 - one["lee.y_genes"] / one["lee.pairs"])
    assert out["metrics"]["y_dup_pct.lee"]["value"] == pytest.approx(y_dup)
    profiling.reset()
    assert _reader("y_dup_pct.lee")({}) is None


def test_work_at_the_cell_sizes():
    # 4 cells, 2 neighbours, 8 pairs, int8 counters: 4*8*8 plane bytes,
    # 4*2*5 edges, 4*4 row scales, one 8-wide partial row
    assert lee_count.work(4, 2, 8) == (344, 128.0, "int8")
    assert lee_count.work(4, 2, 8, 2)[0] == 344 + 4 * 8 * 2
    # the cell's draw step: 1M cells, k 6, a tile of 256 pairs: 2.086 GB,
    # bytes-bound at 0.6227 ms
    assert lee_count.work(1_000_000, 6, 256) == (2_086_000_768, 3.072e9, "int8")
    assert lee_count.seconds(1_000_000, 6, 256) == pytest.approx(0.62269e-3,
                                                                 rel=1e-4)


def test_roofline_reader_reads_only_the_lee_draw_step():
    read = _reader("lee_count_roofline.lee")
    ctx = {"n_cells": 1_000_000, "k": 6,
           "traffic": {"kernel_genes": 256, "counter_bytes": 1}}
    assert read(dict(ctx, trace=None)) is None
    others = {"kernels": {
        "void (anonymous namespace)::lisa_kernel<0, 1, true, signed char, 6>(Args, Tail)": [1e-3],
        "void (anonymous namespace)::lisa_kernel<4, 1, false, signed char, 0>(Args, Tail)": [1e-3]}}
    assert read(dict(ctx, trace=others)) is None
    mine = {"kernels": dict(others["kernels"], **{
        "void (anonymous namespace)::lisa_kernel<4, 1, true, signed char, 6>(Args, Tail)":
            [1.0e-3, 1.5e-3]})}
    least = lee_count.seconds(1_000_000, 6, 256)
    assert read(dict(ctx, trace=mine)) == pytest.approx(100 * least / 1.25e-3)
