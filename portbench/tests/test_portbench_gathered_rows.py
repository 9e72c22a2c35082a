"""The ``gathered_rows_per_draw.local`` reader: the int8 Lee null of the
tiny Lee cell (``tiny_lee.py``) reads the y codes through the draw's rows,
so its traced run reads 0 gathered rows a draw; the reader is
``ops.banded.gather_rows`` over ``draws``, and None where the program keeps
no such counter."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.tests import tiny, tiny_lee
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
    return tiny_lee.make_root(tmp_path_factory.mktemp("pb_gathered"))


def test_gathered_rows_reader(root):
    profiling.reset()
    out = tiny.run_cell(run, root, tiny_lee.LEE, trace=1, seed=SEED)
    assert out["metrics"]["gathered_rows_per_draw.local"]["value"] == 0.0
    read = _reader("gathered_rows_per_draw.local")
    profiling.reset()
    assert read({}) is None
    profiling.count("draws", 4)
    assert read({}) is None
    profiling.count("ops.banded.gather_rows", 10)
    assert read({}) == 2.5
    profiling.reset()
