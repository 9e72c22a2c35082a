"""Moran's I and Geary's C on a radius graph through the port's public path,
against the benchmark's plain reference
(``portbench/reference/global_autocorrelation.py``), on the CPU: the stored
radius graph, the observed values, the fused Moran + Geary null's counts,
the reference's Geary null form, isolated cells, the plan's counters and
spans, and a tiny run of the benchmark's radius cell.

Tolerances, and why:
- the graph: the stored neighbour sets equal the reference's on every cell
  with no pair within 1e-5 of the radius of it, and each weight is
  1/degree to float32's rounding (``graph_gap`` below 1e-6);
- observed I and C: within 1e-5 + 1e-5·|value| of the exact values (float32
  sums over a few thousand cells and up to 48 slots: ~1e-6 of the terms'
  magnitude);
- p: every count inside the reference's band [count_lo, count_hi] (draws
  that tie the observed value within 1e-5 of the sums' magnitude may fall
  either way); no tolerance beyond it;
- the Geary null's degree form against the published pairwise form: rtol
  1e-12 (two float64 sums of the same terms in other orders).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.harness import section as section_mod
from portbench.reference import draws as draws_mod
from portbench.reference import global_autocorrelation as ref
from portbench.reference import stats as ref_stats
from spatialcore_tpu_torch.core.container import SpatialData
from spatialcore_tpu_torch.ops import banded as tb
from spatialcore_tpu_torch.ops import graph as tg
from spatialcore_tpu_torch.ops import moran as tm
from spatialcore_tpu_torch.spatial import (build_spatial_weights,
                                           global_autocorrelation)
from spatialcore_tpu_torch.utils import profiling as prof

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
COUNTS = {"log_rate_mean": -0.5, "log_rate_sd": 0.8, "signal_every": 4,
          "signal_amp": 1.5, "wavelength_um": [100.0, 400.0]}
#: 3,000 cells on 500 x 500 um: a radius of 16.3 um gives mean degree 10
N, SIDE, RADIUS, K_MAX, GENES, P = 3000, 500.0, 16.3, 48, 16, 19
N_ISOLATED = 5
SEED = 2**31 + 91


def _section(n=N, side=SIDE, genes=GENES, seed=7):
    """Uniform cells plus ``N_ISOLATED`` cells far from every other (their
    radius rows are empty); log1p Poisson counts with planted waves."""
    cfg = {"n_cells": n, "n_genes": genes, "extent_um": side,
           "counts": COUNTS}
    sec = section_mod.make(cfg, seed, "cpu")
    lone = torch.stack([side * 1.5 + 40.0 * torch.arange(N_ISOLATED),
                        torch.full((N_ISOLATED,), side * 1.5)], dim=1)
    X = torch.log1p(torch.poisson(torch.full((N_ISOLATED, genes), 1.0),
                                  generator=torch.Generator().manual_seed(seed)))
    return {"coords": torch.cat([sec["coords"], lone]),
            "X": torch.cat([sec["X"], X])}


@pytest.fixture(scope="module")
def sec():
    return _section()


@pytest.fixture(scope="module")
def reference(sec):
    """The reference's graph, z-scores and the bf16 / f32 nulls."""
    idx, w, valid = ref.radius_graph(sec["coords"], RADIUS, K_MAX, "f32")
    Z = ref_stats.standardize(sec["X"].to(torch.float64))
    nulls = {p: ref.global_moran_geary(Z, idx, w, obs_precision="f32",
                                       null_precision=p, seed=SEED,
                                       n_permutations=P)
             for p in ("bf16", "f32")}
    return {"idx": idx, "w": w, "valid": valid, "Z": Z, **nulls}


def _program(sec, null_method="banded", n_permutations=P):
    adata = SpatialData(X=sec["X"])
    adata.obsm["spatial"] = sec["coords"]
    build_spatial_weights(adata, radius=RADIUS, k_max=K_MAX, device="cpu")
    global_autocorrelation(adata, n_permutations=n_permutations,
                           use_existing_graph=True, seed=SEED,
                           null_method=null_method, device="cpu")
    return adata


def _counts(p):
    return torch.round(torch.tensor(np.asarray(p), dtype=torch.float64)
                       * (P + 1)).to(torch.int64) - 1


def _inside_band(p, r):
    c = _counts(p)
    assert bool(((c >= r["count_lo"]) & (c <= r["count_hi"])).all()), (
        c, r["count_lo"], r["count_hi"])


def _program_f32_plan(sec):
    """The fused null at precision "f32" on the program's own plan, z-scores
    and observed values (the steps ``global_autocorrelation`` takes)."""
    graph = tg.build_graph(sec["coords"], radius=RADIUS, k_max=K_MAX,
                           device="cpu")
    plan = tb.build_null_plan(graph, sec["coords"])
    Z, _ = tm.standardize(sec["X"])
    S0 = tg.graph_moments(graph)["S0"]
    obs = torch.stack([tm.moran_observed(graph, Z, S0),
                       tm.geary_observed(graph, Z, S0)])
    p, _, _ = tb.banded_permutation_test(
        plan, Z, S0, obs, SEED, P, stat="moran_geary",
        alternative=("greater", "less"), precision="f32")
    return obs, p


@pytest.mark.parametrize("path", ["public_bf16", "plan_f32"])
def test_program_against_reference(sec, reference, path):
    if path == "public_bf16":
        adata = _program(sec)
        I = adata.uns["morans_i"]["I"].to_numpy()
        C = adata.uns["gearys_c"]["C"].to_numpy()
        p = [adata.uns[k]["p_value"].to_numpy()
             for k in ("morans_i", "gearys_c")]
        r = reference["bf16"]
        g = adata.uns["spatial_graph"]
        out = {k: torch.as_tensor(np.asarray(g[f])) for k, f in
               (("nbr", "neighbor_idx"), ("w", "neighbor_w"),
                ("valid", "valid"))}
        got = {"nbr": reference["idx"], "valid": reference["valid"]}
        assert ref.graph_gap(out, got, sec["coords"], np.arange(N + N_ISOLATED),
                             RADIUS) < 1e-6
        assert int(out["valid"].sum(1).max()) < K_MAX
        assert not bool(out["valid"][N:].any())
    else:
        obs, p = _program_f32_plan(sec)
        I, C = obs[0].numpy(), obs[1].numpy()
        r = reference["f32"]
    for got, want in ((I, r["I"]), (C, r["C"])):
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)
    _inside_band(p[0], r["moran"])
    _inside_band(p[1], r["geary"])


def test_geary_null_form_equals_the_pairwise_formula():
    """The reference's draws of I and of C in its degree form equal the
    published pairwise formulas on a dense W, at 200 cells."""
    s = _section(n=200, side=150.0, genes=6, seed=3)
    idx, w, _ = ref.radius_graph(s["coords"], 18.0, K_MAX, "f32")
    Z = ref_stats.standardize(s["X"].to(torch.float64))
    n = Z.shape[0]
    W = torch.zeros((n, n), dtype=torch.float64)
    W.index_put_((torch.arange(n)[:, None].expand_as(idx), idx), w,
                 accumulate=True)
    S0, den = float(W.sum()), (Z * Z).sum(0)
    op = ref_stats.Operator(Z, idx, w, "f32")
    rc = ref.degree_sums(idx, w)
    torch.testing.assert_close(rc, W.sum(0) + W.sum(1), rtol=1e-12, atol=0)
    for perm in draws_mod.permutations(SEED, "perm_feistel", range(5), n,
                                       "cpu"):
        Zp = Z[perm]
        I, _, C, C_mag = ref.placement(op, rc, den, S0, perm)
        diff = Zp[:, None, :] - Zp[None, :, :]
        C_pair = (n - 1) * (W[:, :, None] * diff ** 2).sum((0, 1)) / (
            2 * S0 * den)
        I_pair = n / S0 * (W[:, :, None] * Zp[:, None, :]
                           * Zp[None, :, :]).sum((0, 1)) / den
        torch.testing.assert_close(C, C_pair, rtol=1e-12, atol=1e-14)
        torch.testing.assert_close(I, I_pair, rtol=1e-12, atol=1e-14)
        assert bool((C_mag >= C.abs()).all())
    _, _, C_obs, _ = ref._observed(Z, idx, w, "f32", False)
    _, _, C_id, _ = ref.placement(op, rc, den, S0)
    torch.testing.assert_close(C_obs, C_id, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("null_method", ["banded", "banded_int8", "slots"])
def test_isolated_cells_give_finite_values(null_method):
    """A sparse section (mean degree ~2, ~13% of cells with no neighbour in
    radius) through every null: finite I, C, z and p, and the isolated
    cells counted."""
    s = _section(n=1000, side=500.0, genes=8, seed=11)
    adata = SpatialData(X=s["X"])
    adata.obsm["spatial"] = s["coords"]
    graph = build_spatial_weights(adata, radius=12.0, k_max=K_MAX,
                                  device="cpu")
    lone = int((~graph.valid.any(1)).sum())
    assert lone >= 50 + N_ISOLATED
    assert prof.counters()["graph.radius_isolated"] == lone
    global_autocorrelation(adata, n_permutations=9, use_existing_graph=True,
                           seed=SEED, null_method=null_method, device="cpu")
    for key, col in (("morans_i", "I"), ("gearys_c", "C")):
        df = adata.uns[key]
        vals = df[[col, f"expected_{col}", "z_score", "p_value"]].to_numpy()
        assert np.isfinite(vals).all(), (key, null_method)
        assert ((df["p_value"] > 0) & (df["p_value"] <= 1)).all()


@pytest.mark.parametrize("coords_as", ["tensor", "numpy"])
def test_plan_counters_on_both_plan_paths(sec, coords_as):
    """``build_null_plan`` sets the plan's sizes as counters on the device
    path (tensor coordinates) and the host path (numpy)."""
    graph = tg.build_graph(sec["coords"], radius=RADIUS, k_max=K_MAX,
                           device="cpu")
    coords = (sec["coords"] if coords_as == "tensor"
              else sec["coords"].numpy())
    prof.reset()
    plan = tb.build_null_plan(graph, coords)
    c = prof.counters()
    n = N + N_ISOLATED
    assert c["plan.rows"] == n and c["plan.slots"] == n * K_MAX
    assert c["plan.live_slots"] == int(graph.valid.sum())
    assert c["plan.far_edges"] == int((plan.far_w > 0).sum())
    assert 0 < c["plan.far_edges"] <= c["plan.live_slots"] <= c["plan.slots"]
    assert 0.7 < 1 - c["plan.live_slots"] / c["plan.slots"] < 0.85


def test_radius_and_geary_spans(sec):
    """The radius search records ``ops.graph.radius_neighbors`` and the
    fused null one ``kernels.global_terms`` a draw (its far-edge cross and
    Geary's degree term) while tracing is on, and nothing while it is
    off."""
    prof.reset()
    graph = tg.build_graph(sec["coords"], radius=RADIUS, k_max=K_MAX,
                           device="cpu")
    plan = tb.build_null_plan(graph, sec["coords"])
    Z, _ = tm.standardize(sec["X"])
    obs = torch.zeros((2, GENES))

    def run():
        tb.banded_permutation_test(plan, Z, 1.0, obs, 1, 3,
                                   stat="moran_geary")

    run()
    assert prof.spans() == []
    with prof.tracing():
        tg.radius_neighbors(sec["coords"], RADIUS, K_MAX)
        run()
    names = [s["name"] for s in prof.spans()]
    assert names.count("ops.graph.radius_neighbors") == 1
    assert names.count("kernels.global_terms") == 3


_TINY_RADIUS = """
import json, sys
import torch
torch.set_num_threads(1)
from pathlib import Path
from portbench import run
from portbench.harness import spec
from portbench.tests import tiny
from spatialcore_tpu_torch.ops import banded
from spatialcore_tpu_torch.utils import profiling

root = tiny.make_root(Path(sys.argv[1]), ["tiny.morans"])
pb, real = root / "portbench", Path.cwd()
cfg = {"name": "tiny_r18", "n_cells": 6000, "n_genes": 64, "n_neighbors": 48,
       "extent_um": 800.0, "block": 256, "counts": tiny.COUNTS}
(pb / "configs" / "tiny_r18.json").write_text(json.dumps(cfg))
tr = json.loads((real / "portbench/traffic/moran_geary_auto.json").read_text())
tr.update(genes=40, n_permutations=19, graph={"radius_um": 18.4, "k_max": 48},
          args={"null_method": "banded"}, kernel_genes=40, compare_genes=16,
          compare_cells=256)
(pb / "traffic" / "t_moran_geary.json").write_text(json.dumps(tr))
(pb / "limits" / "tiny.radius.json").write_text(
    (real / "portbench/limits/xenium_1m_r18.moran_geary_auto.json").read_text())
bench = json.loads((root / "BENCHMARK.json").read_text())
bench["configs"].append({"name": "tiny_r18", "source": "test", "reduced": [],
                         "file": "portbench/configs/tiny_r18.json", "why": "test"})
bench["workloads"].append({"name": "tiny.radius", "config": "tiny_r18",
                           "traffic": "t_moran_geary", "chips": 1, "why": "test"})
for m in bench["end_to_end"]:
    if m["name"] == "null_gpps":
        m["workloads"].append("tiny.radius")
for m in spec.load_benchmark(real)["per_layer"]:
    if m["name"].endswith(".radius"):
        bench["per_layer"].append(dict(m, workloads=["tiny.radius"]))
(root / "BENCHMARK.json").write_text(json.dumps(bench))
out = tiny.run_cell(run, root, "tiny.radius", trace=1)
counters = profiling.counters()
roof = spec.metric_reader(root, "band_cross_roofline.radius").read(
    {"trace": {"kernels": {"void band_cross_float_kernel<2, 6>": [1e-3, 3e-3]}},
     "traffic": tr, "n_cells": 6000})
orig = banded._p_from_counts
banded._p_from_counts = lambda count, P: torch.roll(orig(count, P), 1, -1)
faulty = tiny.run_cell(run, root, "tiny.radius")
print(json.dumps({"out": out, "counters": counters, "roof": roof,
                  "faulty_correct": faulty["correct"]}))
"""


def test_tiny_radius_cell_runs_correct(tmp_path):
    """A tiny radius cell beside the real benchmark (as
    ``portbench/tests/tiny.py`` builds one), in a process of its own (the
    harness refuses a process that holds JAX): its traced run is correct,
    the plan readers read the program's counters, the roofline reader
    reads a hand-built trace at the live mean degree, and p-values handed
    to the wrong genes are not correct."""
    from portbench.work import band_cross

    res = subprocess.run([sys.executable, "-c", _TINY_RADIUS, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    x = json.loads(res.stdout.strip().splitlines()[-1])
    out, c = x["out"], x["counters"]
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"graph_gap", "obs_gap.moran",
                                  "obs_gap.geary", "p_gap.moran",
                                  "p_gap.geary"}
    m = out["metrics"]
    assert m["dead_slot_pct.radius"]["value"] == pytest.approx(
        100 * (1 - c["plan.live_slots"] / c["plan.slots"]), rel=1e-12)
    assert 70 < m["dead_slot_pct.radius"]["value"] < 85
    assert m["far_edges_per_cell.radius"]["value"] == pytest.approx(
        c["plan.far_edges"] / c["plan.rows"], rel=1e-12)
    least = band_cross.seconds(6000, c["plan.live_slots"] / c["plan.rows"],
                               40, "bf16")
    assert x["roof"] == pytest.approx(100 * least / 2e-3, rel=1e-12)
    assert not x["faulty_correct"]
