"""Getis-Ord Gi* hot spots on raw counts through the port's public path,
against the benchmark's plain reference
(``portbench/reference/getis_ord_gi.py``), on the CPU: the int8 null's
per-cell counts on int16 counters (300 draws), the observed G and z, BH and
the hot / cold classes.

Tolerances, and why:
- the int8 codes of the raw counts and the null's counts: equal (both
  count exact integers A = Σ codes over the cell and its neighbours against
  the identity placement, on the same codes, which is checked first, the
  same draws and the same float32 centre f32(tot/m)·(W + 1));
- G and z: within 1e-5 relative (and 1e-6 absolute for z) of the
  reference's float64 values (float32 column moments and a seven-term sum);
- the adjusted p: within 1e-6 of BH over the reference's p_sim (float32
  products); the classes: equal, and some cells are hot.

A planted fault fails the comparison: one count one draw off, or log1p
values handed to the reference (it refuses values that are not counts).
"""

import numpy as np
import pytest
import torch

from portbench.harness import section as section_mod
from portbench.reference import common as ref_common
from portbench.reference import getis_ord_gi as ref
from portbench.reference import stats as ref_stats
from spatialcore_tpu_torch.core.container import SpatialData
from spatialcore_tpu_torch.ops import banded as tb
from spatialcore_tpu_torch.spatial import build_spatial_weights, getis_ord_gi

torch.set_num_threads(1)

#: strong plane waves in every gene, so that BH leaves hot spots at 2,048
#: cells
COUNTS = {"log_rate_mean": 0.5, "log_rate_sd": 0.3, "signal_every": 1,
          "signal_amp": 2.0, "wavelength_um": [150.0, 300.0]}
N, SIDE, GENES, P = 2048, 300.0, 8, 300
SEED = 2**31 + 281
ALPHA = 0.05


@pytest.fixture(scope="module")
def sec():
    cfg = {"n_cells": N, "n_genes": GENES, "extent_um": SIDE,
           "counts": COUNTS}
    s = section_mod.make(cfg, 7, "cpu")
    s["X"] = torch.round(torch.expm1(s["X"]))
    return s


@pytest.fixture(scope="module")
def port(sec):
    adata = SpatialData(X=sec["X"].clone())
    adata.obsm["spatial"] = sec["coords"]
    build_spatial_weights(adata, n_neighbors=6, device="cpu")
    getis_ord_gi(adata, n_neighbors=6, n_permutations=P, seed=SEED,
                 use_existing_graph=True, null_method="banded_int8",
                 output_mode="full", device="cpu")
    out = {k: torch.as_tensor(np.asarray(adata.obsm[f"getis_ord_{k}"]))
           for k in ("G", "z", "p", "p_sim", "p_adj", "hotspot")}
    out["count"] = torch.round(out["p_sim"].to(torch.float64) * (P + 1)
                               ).to(torch.int32) - 1
    return out


@pytest.fixture(scope="module")
def graph(sec):
    return ref_common.graph(sec["coords"], 6, "f32")


def _reference(X, idx):
    obs = ref.observed(X, idx, "f32", False)
    count = ref.null_counts(X, idx, precision="int8", seed=SEED,
                            n_permutations=P)
    p_adj = ref_stats.bh((count.to(torch.float64) + 1) / (P + 1))
    return dict(obs, count=count, p_adj=p_adj,
                hotspot=ref.hotspots(obs["z"], p_adj, ALPHA))


def _agrees(port, want) -> bool:
    return (torch.equal(port["count"], want["count"])
            and torch.allclose(port["G"].double(), want["G"], rtol=1e-5,
                               atol=0)
            and torch.allclose(port["z"].double(), want["z"], rtol=1e-5,
                               atol=1e-6)
            and torch.allclose(port["p_adj"].double(), want["p_adj"],
                               rtol=0, atol=1e-6)
            and torch.equal(port["hotspot"].to(torch.int8), want["hotspot"]))


def test_codes_equal_the_reference(sec):
    X = sec["X"].to(torch.float64)
    assert torch.equal(tb._quantize_x(sec["X"])[0].to(torch.int32),
                       ref.raw_codes(X, "int8")[0])


def test_gi_star_equals_the_reference(sec, port, graph):
    want = _reference(sec["X"].to(torch.float64), graph[0])
    assert port["p_sim"].dtype == torch.float32 and P > 127   # int16 counts
    assert _agrees(port, want)
    assert 0 < int((want["count"] == 0).sum()) < want["count"].numel()
    assert int((want["hotspot"] == 1).sum()) > 0


@pytest.mark.parametrize("fault", ["count_off", "log1p"])
def test_planted_fault_fails_the_comparison(sec, port, graph, fault):
    X = sec["X"].to(torch.float64)
    if fault == "count_off":
        bad = dict(port, count=port["count"].clone())
        bad["count"][0, 0] += 1
        assert not _agrees(bad, _reference(X, graph[0]))
    else:
        with pytest.raises(ValueError, match="whole numbers"):
            _reference(torch.log1p(X), graph[0])
