"""Public morans_i / gearys_c of the port against the JAX package.

Tolerances: I and C rtol 1e-5 (float32 summation order); z rtol 1e-4 with
an absolute 1e-5 for z near 0; int8 p within one draw (counts within ±1,
see test_torch_banded.py); bf16 p within 0.05 (the reference's XLA path
rounds the band lag to bf16, the port keeps it in float32).
"""

import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import spatialcore_tpu as sct
import spatialcore_tpu.spatial as scts
import spatialcore_tpu_torch as sctt
from spatialcore_tpu_torch.core.metadata import get_operations

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

P = 19


def _data(n=1500, g=16, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 500, (n, 2)).astype(np.float32)
    X = np.concatenate(
        [np.sin(coords[:, :1] / 40.0 * (1 + j)) + rng.normal(0, 0.5, (n, 1))
         for j in range(g // 2)]
        + [rng.poisson(2.0, (n, g - g // 2))], axis=1).astype(np.float32)
    X[:, 3] = 1.0                           # zero variance: z 0, p 1
    var = pd.DataFrame(index=[f"G{j}" for j in range(g)])
    return coords, X, var


def _pair(X_port=None):
    coords, X, var = _data()
    a = sct.SpatialData(X=X.copy(), var=var.copy())
    a.obsm["spatial"] = coords
    b = sctt.SpatialData(X=X.copy() if X_port is None else X_port, var=var.copy())
    b.obsm["spatial"] = coords.copy()
    return a, b


@pytest.mark.parametrize("fn,col,null_method,assumption", [
    ("morans_i", "I", "banded_int8", "normality"),
    ("morans_i", "I", "banded", "randomization"),
    ("gearys_c", "C", "banded_int8", "randomization"),
    ("gearys_c", "C", "banded", "normality"),
])
def test_matches_reference(fn, col, null_method, assumption):
    a, b = _pair()
    getattr(scts, fn)(a, n_permutations=P, seed=4, null_method=null_method,
                     assumption=assumption, gene_batch_size=10)
    getattr(sctt, fn)(b, n_permutations=P, seed=4, null_method=null_method,
                      assumption=assumption, gene_batch_size=10, device="cpu")
    key = "morans_i" if fn == "morans_i" else "gearys_c"
    dj, dt = a.uns[key], b.uns[key]
    assert list(dt.columns) == list(dj.columns)
    assert list(dt["gene"]) == list(dj["gene"])
    np.testing.assert_allclose(dt[col], dj[col], rtol=1e-5)
    np.testing.assert_allclose(dt[f"expected_{col}"], dj[f"expected_{col}"],
                               rtol=1e-12)
    np.testing.assert_allclose(dt["z_score"], dj["z_score"], rtol=1e-4, atol=1e-5)
    tol = 1.0 / (P + 1) + 1e-6 if null_method == "banded_int8" else 0.05
    assert np.abs(dt["p_value"] - dj["p_value"]).max() <= tol
    assert dt.loc[3, "z_score"] == 0.0 and dt.loc[3, "p_value"] == 1.0
    op = get_operations(b)[-1]
    assert op["function"] == fn
    assert op["parameters"]["backend"] == "spatialcore_tpu_torch"
    assert op["parameters"]["null_method"] == null_method


def test_analytic_p_matches_reference():
    a, b = _pair()
    scts.morans_i(a, n_permutations=0)
    sctt.morans_i(b, n_permutations=0, device="cpu")
    np.testing.assert_allclose(b.uns["morans_i"]["p_value"],
                               a.uns["morans_i"]["p_value"], rtol=1e-4, atol=1e-6)


def test_tensor_X_and_stored_graph():
    """A torch X is sliced where it lies; a stored graph is reused."""
    _, X, _ = _data()
    a, b = _pair(X_port=torch.as_tensor(X))
    sctt.morans_i(b, n_permutations=P, seed=4, null_method="banded_int8",
                  device="cpu")
    first = b.uns["morans_i"].copy()
    sctt.morans_i(b, n_permutations=P, seed=4, null_method="banded_int8",
                  use_existing_graph=True, device="cpu")
    pd.testing.assert_frame_equal(b.uns["morans_i"], first)
    scts.morans_i(a, n_permutations=P, seed=4, null_method="banded_int8")
    np.testing.assert_allclose(first["I"], a.uns["morans_i"]["I"], rtol=1e-5)


def test_container_keeps_and_clones_tensors():
    X = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    d = sctt.SpatialData(X=X)
    d.obsm["spatial"] = torch.zeros(4, 2)
    d.layers["raw"] = X * 2
    assert d.obsm["spatial"].__class__ is torch.Tensor and d.X is X
    c = d.copy()
    c.X[0, 0] = 99.0
    c.obsm["spatial"][0, 0] = 5.0
    assert d.X[0, 0] == 0.0 and d.obsm["spatial"][0, 0] == 0.0
    assert torch.equal(c.get_matrix("raw"), X * 2)
    with pytest.raises(ValueError, match="dim 0"):
        d.obsm["bad"] = torch.zeros(5, 2)


def test_unported_and_invalid_null_methods_raise():
    _, b = _pair()
    with pytest.raises(ValueError, match="null_method"):
        sctt.morans_i(b, null_method="banded_int4", device="cpu")
    with pytest.raises(ValueError, match="null_method"):
        sctt.global_autocorrelation(b, null_method="banded_int4", device="cpu")
    # the local slot null runs too, on the reference's draws. Compared on
    # the continuous genes: on the Poisson ones a permuted neighbourhood
    # often holds the observed one's values in another slot order, and such
    # near-ties resolve by the last bits of z, which the two packages'
    # standardizations leave different (tests/test_torch_local_slots.py pins
    # integer data standardized exactly)
    a, _ = _pair()
    scts.local_morans_i(a, null_method="slots", n_permutations=9, seed=1)
    sctt.local_morans_i(b, null_method="slots", n_permutations=9, seed=1,
                        device="cpu")
    got = b.obsm["local_morans_p"][:, :8]
    want = a.obsm["local_morans_p"][:, :8]
    assert (np.abs(got - want) <= 0.1 + 1e-6).all()
    assert (got == want).mean() >= 0.999
    # "auto" resolves to the slot null below 100k cells
    sctt.gearys_c(b, n_permutations=9, device="cpu")
    assert get_operations(b)[-1]["parameters"]["null_method"] == "slots"
    with pytest.raises(NotImplementedError, match="mesh"):
        sctt.morans_i(b, null_method="banded", mesh=object(), device="cpu")


def test_import_leaves_jax_unloaded():
    code = ("import sys, spatialcore_tpu_torch, spatialcore_tpu_torch.ops, "
            "spatialcore_tpu_torch.kernels.band_cross; "
            "sys.exit(1 if 'jax' in sys.modules or "
            "'spatialcore_tpu' in sys.modules else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
