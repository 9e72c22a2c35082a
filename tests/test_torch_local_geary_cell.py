"""Local Geary's C with the total null through the port's public path,
against the benchmark's plain reference
(``portbench/reference/local_gearys_c.py``), on the CPU: the int8 null's
per-cell counts (99 draws, int8 counters), the observed C and BH.

Tolerances, and why:
- the z codes and the null's counts: equal (both count exact integers
  Σ w_code·(v_i − v_j)² against the identity placement, on the same codes,
  which is checked first, and the same draws);
- C: within 1e-5 + 1e-5·|C| of the reference's float64 value (float32
  standardization and a six-slot sum);
- the adjusted p: within 1e-6 of BH over the reference's p (float32
  products).

A planted fault (one count one draw off) fails the comparison.
"""

import numpy as np
import pytest
import torch

from portbench.harness import section as section_mod
from portbench.reference import common as ref_common
from portbench.reference import local_gearys_c as ref
from portbench.reference import stats as ref_stats
from spatialcore_tpu_torch.core.container import SpatialData
from spatialcore_tpu_torch.ops import banded as tb
from spatialcore_tpu_torch.ops import moran as tm
from spatialcore_tpu_torch.spatial import build_spatial_weights, local_gearys_c

torch.set_num_threads(1)

COUNTS = {"log_rate_mean": -0.5, "log_rate_sd": 0.8, "signal_every": 2,
          "signal_amp": 1.5, "wavelength_um": [100.0, 300.0]}
N, SIDE, GENES, P = 2048, 300.0, 12, 99
SEED = 2**31 + 283


@pytest.fixture(scope="module")
def sec():
    cfg = {"n_cells": N, "n_genes": GENES, "extent_um": SIDE,
           "counts": COUNTS}
    return section_mod.make(cfg, 9, "cpu")


@pytest.fixture(scope="module")
def port(sec):
    adata = SpatialData(X=sec["X"].clone())
    adata.obsm["spatial"] = sec["coords"]
    build_spatial_weights(adata, n_neighbors=6, device="cpu")
    local_gearys_c(adata, n_neighbors=6, n_permutations=P, seed=SEED,
                   use_existing_graph=True, null="total",
                   null_method="banded_int8", output_mode="full",
                   device="cpu")
    out = {k: torch.as_tensor(np.asarray(adata.obsm[f"local_geary_{k}"]))
           for k in ("C", "p", "p_adj")}
    out["count"] = torch.round(out["p"].to(torch.float64) * (P + 1)
                               ).to(torch.int32) - 1
    return out


@pytest.fixture(scope="module")
def want(sec):
    idx, w = ref_common.graph(sec["coords"], 6, "f32")
    Z = ref_stats.standardize(sec["X"])
    count = ref.null_counts(Z, idx, w, precision="int8", seed=SEED,
                            n_permutations=P)
    return {"C": ref.observed(Z, idx, w, "f32", False), "count": count,
            "p_adj": ref_stats.bh((count.to(torch.float64) + 1) / (P + 1))}


def _agrees(port, want) -> bool:
    return (torch.equal(port["count"], want["count"])
            and torch.allclose(port["C"].double(), want["C"], rtol=1e-5,
                               atol=1e-5)
            and torch.allclose(port["p_adj"].double(), want["p_adj"],
                               rtol=0, atol=1e-6))


def test_codes_equal_the_reference(sec):
    Zp, _ = tm.standardize(sec["X"])
    assert torch.equal(tb._quantize_z(Zp)[0].to(torch.int32),
                       ref_stats.codes(ref_stats.standardize(sec["X"]),
                                       "int8")[0])


def test_local_geary_equals_the_reference(port, want):
    assert _agrees(port, want)
    assert 0 < int((want["count"] < P // 10).sum()) < want["count"].numel()


def test_planted_fault_fails_the_comparison(port, want):
    bad = dict(port, count=port["count"].clone())
    bad["count"][0, 0] += 1
    assert not _agrees(bad, want)
