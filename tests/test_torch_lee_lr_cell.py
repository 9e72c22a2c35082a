"""Local Lee's L over ligand-receptor-shaped gene pairs through the port's
public path, against the benchmark's plain reference
(``portbench/reference/lees_l_local.py``), on the CPU: the int8 null's
per-cell decisions, the ``lee.*`` counters and the ``ops.lee.lees_l_pairs``
span, and tiny runs of the benchmark's Lee cell and int8 Moran's I cell.

Tolerances, and why:
- the int8 null's counts: equal, cell by cell (both count exact integers
  Lq = x_code · Σ w_code · y_code[π] against the identity placement, on the
  same codes, which is checked first, and the same draws);
- the observed L: within 1e-5 + 1e-5·|L| of the reference's exact value
  (float32 standardization and a six-slot lag);
- the tiny cells: the limits of ``portbench/tests/tiny_lee.py`` (no count
  may lie outside the reference's).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness import section as section_mod
from portbench.reference import common as ref_common
from portbench.reference import lees_l_local as ref
from portbench.reference import stats as ref_stats
from portbench.tests import tiny_lee
from spatialcore_tpu_torch.core.container import SpatialData
from spatialcore_tpu_torch.ops import banded as tb
from spatialcore_tpu_torch.ops import moran as tm
from spatialcore_tpu_torch.spatial import (build_spatial_weights, lees_l,
                                           lees_l_local)
from spatialcore_tpu_torch.utils import profiling as prof

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
COUNTS = {"log_rate_mean": -0.5, "log_rate_sd": 0.8, "signal_every": 4,
          "signal_amp": 1.5, "wavelength_um": [100.0, 400.0]}
N, SIDE, GENES, P = 3000, 500.0, 40, 19
SEED = 2**31 + 93
#: 48 pairs of the 40-gene panel, drawn by the benchmark list's rule
PAIRS = tiny_lee.pairs(n_genes=GENES, n_pairs=48, n_lig=8, n_rec=12)


@pytest.fixture(scope="module")
def sec():
    cfg = {"n_cells": N, "n_genes": GENES, "extent_um": SIDE,
           "counts": COUNTS}
    return section_mod.make(cfg, 5, "cpu")


def _adata(sec):
    adata = SpatialData(X=sec["X"])
    adata.obsm["spatial"] = sec["coords"]
    build_spatial_weights(adata, n_neighbors=6, device="cpu")
    return adata


def _names(adata, pairs=PAIRS):
    return [(adata.var_names[x], adata.var_names[y]) for x, y in pairs]


def test_int8_decisions_equal_the_reference(sec):
    adata = _adata(sec)
    lees_l_local(adata, gene_pairs=_names(adata), n_permutations=P,
                 use_existing_graph=True, seed=SEED, null_method="banded_int8",
                 compute_cell_pvalues=True, output_mode="compact", device="cpu")
    cols = np.arange(len(PAIRS))
    X, Y = ref.pair_columns({"X": sec["X"]}, {"pairs": PAIRS}, cols)
    Zx, Zy = ref_stats.standardize(X), ref_stats.standardize(Y)
    for Z, raw in ((Zx, X), (Zy, Y)):     # the same codes on both sides
        Zp, _ = tm.standardize(raw.to(torch.float32))
        assert torch.equal(tb._quantize_z(Zp)[0].to(torch.int32),
                           ref_stats.codes(Z, "int8")[0])
    idx, w = ref_common.graph(sec["coords"], 6, "f32")
    r = ref.local_lee(Zx, Zy, idx, w, obs_precision="f32",
                      null_precision="int8", seed=SEED, n_permutations=P)
    p = torch.as_tensor(np.asarray(adata.obsm["lees_local_p"]),
                        dtype=torch.float64)
    count = torch.round(p * (P + 1)).to(torch.int64) - 1
    assert torch.equal(count, r["count_lo"])
    assert 0 < int((count < P // 4).sum()) < count.numel()
    L = torch.as_tensor(np.asarray(adata.obsm["lees_local_L"]),
                        dtype=torch.float64)
    torch.testing.assert_close(L, r["L"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route", ["compact", "full", "global"])
def test_lee_counters_count_each_set_of_pair_columns(sec, route):
    """``lee.pairs``, ``lee.x_genes`` and ``lee.y_genes`` add the pair
    columns built and their distinct genes: on the compact route through
    the stream's ``get_tile`` (one tile of the 48 pairs here; the tiny cell
    below runs two), on the full and global routes in ``_lees_columns``."""
    adata = _adata(sec)
    names = _names(adata)
    prof.reset()
    if route == "global":
        lees_l(adata, names, n_permutations=0, use_existing_graph=True,
               device="cpu")
    else:
        lees_l_local(adata, gene_pairs=names, n_permutations=3,
                     use_existing_graph=True, seed=SEED,
                     null_method="banded_int8", compute_cell_pvalues=True,
                     output_mode=route, device="cpu")
    c = prof.counters()
    assert {k: c.get(k) for k in ("lee.pairs", "lee.x_genes", "lee.y_genes")} \
        == tiny_lee.tile_counts(PAIRS, len(PAIRS))


def test_lees_l_pairs_span(sec):
    """``ops.lee.lees_l_pairs`` records once a call while tracing is on (the
    full route's exact observed pass) and nothing while it is off."""
    adata = _adata(sec)
    kw = dict(gene_pairs=_names(adata)[:4], n_permutations=3,
              use_existing_graph=True, seed=SEED, null_method="banded_int8",
              output_mode="full", device="cpu")
    prof.reset()
    lees_l_local(adata, **kw)
    assert prof.spans() == []
    with prof.tracing():
        lees_l_local(adata, **kw)
    sp = prof.spans()
    names = [s["name"] for s in sp]
    assert names.count("ops.lee.lees_l_pairs") == 1
    parent = {s["id"]: s["name"] for s in sp}
    assert parent[next(s["parent"] for s in sp
                       if s["name"] == "ops.lee.lees_l_pairs")] \
        == "spatial.lees_l_local"


_TINY = """
import json, sys
import torch
torch.set_num_threads(1)
from pathlib import Path
from portbench import run
from portbench.tests import tiny, tiny_lee
from spatialcore_tpu_torch.utils import profiling

seed = 2**31 + 77
root = tiny_lee.make_root(Path(sys.argv[1]))
profiling.reset()
lee = tiny.run_cell(run, root, tiny_lee.LEE, trace=1, seed=seed)
counters = {k: v for k, v in profiling.counters().items()
            if k.startswith("lee.")}
col = tiny_lee.first_compared_column(root, seed)
faulty = {}
for name in tiny_lee.FAULTS:
    with tiny_lee.fault(name, col):
        faulty[name] = tiny.run_cell(run, root, tiny_lee.LEE, seed=seed)
mi8 = tiny.run_cell(run, root, tiny_lee.MI8, seed=seed)
print(json.dumps({"lee": lee, "counters": counters, "faulty": faulty,
                  "mi8": mi8, "one_call": tiny_lee.tile_counts()}))
"""


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """The tiny cells in a process of their own (the harness refuses a
    process that holds JAX)."""
    res = subprocess.run([sys.executable, "-c", _TINY,
                          str(tmp_path_factory.mktemp("pb_lee"))], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_tiny_lee_cell_is_correct(tiny_runs):
    out = tiny_runs["lee"]
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(tiny_lee.LEE_LIMITS)
    assert out["checks"]["p_flip_share"]["value"] == 0.0


@pytest.mark.parametrize("fault", tiny_lee.FAULTS)
def test_tiny_lee_cell_fault_is_not_correct(tiny_runs, fault):
    out = tiny_runs["faulty"][fault]
    assert not out["correct"], out["checks"]
    bad = {k for k, c in out["checks"].items()
           if not isinstance(c["value"], float) or c["value"] > c["limit"]}
    assert bad & ({"p_flip_share"} if fault == "count_off"
                  else {"obs_gap", "p_flip_share"})


def test_tiny_lee_cell_counters_and_reader(tiny_runs):
    """The ``lee.*`` counters equal the pair list's per-tile distinct counts
    for every call (the warm-up and the window's), and ``y_dup_pct.lee``
    reads them."""
    c, one, out = tiny_runs["counters"], tiny_runs["one_call"], tiny_runs["lee"]
    calls = 1 + out["attempted"]
    assert c == {k: v * calls for k, v in one.items()}
    assert out["metrics"]["y_dup_pct.lee"]["value"] == pytest.approx(
        100 * (1 - one["lee.y_genes"] / one["lee.pairs"]), rel=1e-12)


def test_tiny_morans_int8_cell_is_correct(tiny_runs):
    out = tiny_runs["mi8"]
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(tiny_lee.MI8_LIMITS)
