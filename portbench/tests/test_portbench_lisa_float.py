"""The float local Moran draw step's work count and its roofline reader."""

import importlib.util
from pathlib import Path

from portbench.work import lisa_float

READER = Path(__file__).resolve().parents[1] / "metrics" / "lisa_float_roofline.local.py"


def _reader():
    spec = importlib.util.spec_from_file_location("lisa_float_roofline", READER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_work_on_a_hand_sized_graph():
    # 4 cells, 2 neighbours, 8 genes: f32 table and int16 counters, then bf16 and int32
    assert lisa_float.work(4, 2, 8) == (4 * 8 * 12 + 4 * 2 * 8, 128.0, "f32")
    assert lisa_float.work(4, 2, 8, 2, 4) == (4 * 8 * 14 + 4 * 2 * 6, 128.0, "f32")
    # the CosMx vignette's draw step: 587.1 MB, bytes-bound at 0.1753 ms
    assert lisa_float.work(366_938, 50, 100)[0] == 587_100_800
    assert abs(lisa_float.seconds(366_938, 50, 100) - 0.17525e-3) < 1e-7


def test_reader_reads_only_its_kernel():
    read = _reader().read
    ctx = {"n_cells": 366_938, "k": 50,
           "traffic": {"genes": 100, "n_permutations": 99, "precision": {"null": "f32"}}}
    assert read(dict(ctx, trace=None)) is None
    other = {"kernels": {"void lisa_kernel<0, 1, true, signed char, 6>(Args, Tail)": [1e-3]}}
    assert read(dict(ctx, trace=other)) is None
    mine = {"kernels": {"void (anonymous namespace)::lisa_float_kernel<4, short>(Args)":
                        [1.0e-3, 1.5e-3]}}
    assert abs(read(dict(ctx, trace=mine)) - 100 * 0.17525e-3 / 1.25e-3) < 1e-3
