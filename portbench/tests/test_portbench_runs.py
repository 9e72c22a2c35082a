"""Whole runs of tiny cells on the CPU: each entry agrees with its
reference, and the faults of the program that a cell can have turn
``correct`` false. The card is not looked for (``run.main(device=)``);
the program runs its kernels' plain versions."""

from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.tests import tiny

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("pb"))


@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_entry_agrees_with_reference(root, cell):
    out = tiny.run_cell(run, root, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "null_gpps" if cell in tiny.GLOBAL
                                   else "local_cgpps"}
    assert list(out)[-1] == "checks"


def _state_unchanged(banded, monkeypatch):
    """The draws never reach the counts: the count a draw step hands on is
    the one it was given (zeros)."""
    orig = banded._p_from_counts
    monkeypatch.setattr(banded, "_p_from_counts",
                        lambda count, P: orig(torch.zeros_like(count), P))


def _half_the_draws(banded, monkeypatch):
    """Every other draw is left out, the one before it counted in its
    place."""
    orig = banded.feistel_apply
    memo = {}

    def feistel_apply(k, idx, n):
        key = (idx.data_ptr(), idx.numel(), n)
        memo[key] = memo.get(key, -1) + 1
        if memo[key] % 2 and ("rows", key) in memo:
            return memo[("rows", key)]
        rows = memo[("rows", key)] = orig(k, idx, n)
        return rows

    monkeypatch.setattr(banded, "feistel_apply", feistel_apply)


def _answer_altered(banded, monkeypatch):
    """Each gene's p is produced as its neighbour's."""
    orig = banded._p_from_counts
    monkeypatch.setattr(banded, "_p_from_counts",
                        lambda count, P: torch.roll(orig(count, P), 1, -1))


FAULTS = {"state_unchanged": _state_unchanged,
          "half_the_draws": _half_the_draws,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("cell", list(tiny.CELLS))
def test_fault_is_not_correct(root, cell, fault, monkeypatch):
    from spatialcore_tpu_torch.ops import banded

    FAULTS[fault](banded, monkeypatch)
    out = tiny.run_cell(run, root, cell)
    assert not out["correct"], out["checks"]


def test_trace_run_reports_per_layer_metrics(root):
    out = tiny.run_cell(run, root, "tiny.morans", trace=1)
    assert out["correct"]
    assert {"graph_build_s", "feistel_ms_per_draw.global",
            "kernel_launches_per_draw.global"} <= set(out["metrics"])
    assert out["device"]["window_s"] > 0 and "breakdown" in out
