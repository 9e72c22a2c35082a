"""The port's command line (``python -m spatialcore_tpu_torch``) and
``r_bridge``: the four cases of ``tests/test_cli.py`` run in-process with
``--device cpu`` (``info``, ``moran`` with and without ``--geary`` and
``domains``, ``pipeline``, ``benchmark``), ``moran`` ranking the genes as
the JAX package's command does on the same h5ad, one ``info`` run as a
subprocess, ``--device`` before and after the command, and ``r_bridge``
where R is not installed.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import spatialcore_tpu as sct
import spatialcore_tpu_torch as pt
from spatialcore_tpu import __main__ as jcli
from spatialcore_tpu_torch import __main__ as pcli
from spatialcore_tpu_torch import r_bridge

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)


def _adata(n_obs, n_vars, seed=0):
    rng = np.random.default_rng(seed)
    counts = rng.poisson(2.0, size=(n_obs, n_vars)).astype(np.float32)
    obs = pd.DataFrame(index=[f"cell_{i}" for i in range(n_obs)])
    var = pd.DataFrame(index=[f"GENE{j}" for j in range(n_vars)])
    d = pt.SpatialData(X=sp.csr_matrix(counts), obs=obs, var=var)
    d.obsm["spatial"] = rng.uniform(0, 1000, (n_obs, 2)).astype(np.float32)
    return d


def _run(capsys, *argv, cli=pcli):
    cli.main(list(argv))
    return capsys.readouterr().out


def test_cli_info(capsys):
    out = _run(capsys, "info", "--device", "cpu")
    assert out.splitlines()[0] == f"spatialcore_tpu_torch {pt.__version__}"
    assert "spatial" in out and "ok" in out
    assert "plotting     not ported yet (ROADMAP Queue 1 item 14d)" in out
    assert "parallel     not ported yet (ROADMAP Queue 1 item 15)" in out
    assert _run(capsys, "--device", "cpu", "info") == out


def test_cli_info_subprocess():
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/tmp"), "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(sys.path)}
    r = subprocess.run([sys.executable, "-m", "spatialcore_tpu_torch", "info"],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-500:]
    assert r.stdout.startswith("spatialcore_tpu_torch ")
    assert "annotation   ok" in r.stdout and "r_bridge     ok" in r.stdout


def _moran_file(tmp_path):
    adata = _adata(800, 6)
    X = adata.X.toarray()
    coords = np.asarray(adata.obsm["spatial"])
    X[:, 0] += np.sin(coords[:, 0] / 100).astype(np.float32) * 3
    X[:, 3] += np.cos(coords[:, 1] / 150).astype(np.float32) * 2
    adata.X = sp.csr_matrix(X)
    adata.obs["cell_type"] = np.random.default_rng(0).choice(["A", "B"], 800)
    path = tmp_path / "q.h5ad"
    pt.write_h5ad(adata, path)
    return path


def _genes(out, n):
    return [ln.split()[0] for ln in out.strip().splitlines()[-n:]]


def test_cli_moran_and_domains(tmp_path, capsys):
    path = _moran_file(tmp_path)
    out = _run(capsys, "moran", str(path), "--permutations", "19", "--top",
               "6", "--device", "cpu")
    assert "GENE0" in out.splitlines()[-6]           # structured gene ranks #1
    want = _run(capsys, "moran", str(path), "--permutations", "19", "--top",
                "6", cli=jcli)
    assert _genes(out, 6) == _genes(want, 6)

    out = _run(capsys, "--device", "cpu", "moran", str(path),
               "--permutations", "19", "--top", "3", "--geary")
    header = out.splitlines()[-4]
    assert "I" in header.split() and "C" in header.split()
    assert "p_value_C" in header

    dom = tmp_path / "dom.h5ad"
    out = _run(capsys, "domains", str(path), "cell_type == 'A'", "--platform",
               "xenium", "--out", str(dom), "--device", "cpu")
    assert "n_cells" in out and dom.exists()
    assert "spatial_domain" in pt.read_h5ad(dom).obs.columns


def test_cli_pipeline(tmp_path, capsys):
    rng = np.random.default_rng(1)
    n_per, n = 120, 360
    counts = rng.poisson(1.0, (n, 18)).astype(np.float32)
    for t in range(3):
        counts[t * n_per:(t + 1) * n_per, t * 5:t * 5 + 5] += rng.poisson(
            7.0, (n_per, 5))
    ref = _adata(n, 18)
    ref.X = sp.csr_matrix(counts)
    ref.layers["counts"] = sp.csr_matrix(counts)
    ref.obs["cell_type"] = np.repeat(["A", "B", "C"], n_per)
    pt.write_h5ad(ref, tmp_path / "ref.h5ad")
    q = _adata(n, 18)
    qc = counts[rng.permutation(n)]
    q.X = sp.csr_matrix(qc)
    q.layers["counts"] = sp.csr_matrix(qc)
    pt.write_h5ad(q, tmp_path / "q.h5ad")
    from spatialcore_tpu_torch.annotation import TrainingConfig

    TrainingConfig(references=[str(tmp_path / "ref.h5ad")], epochs=8,
                   confidence_threshold=0.5, make_plots=False
                   ).to_yaml(tmp_path / "cfg.yaml")
    outs = {}
    for name, cli, extra in (("port", pcli, ["--device", "cpu"]),
                             ("jax", jcli, [])):
        out = _run(capsys, "pipeline", str(tmp_path / "cfg.yaml"), "--adata",
                   str(tmp_path / "q.h5ad"), "--out",
                   str(tmp_path / f"{name}.h5ad"), *extra, cli=cli)
        assert "annotated" in out
        outs[name] = sct.read_h5ad(tmp_path / f"{name}.h5ad")
    back = outs["port"]
    assert back.obs["cell_type"].notna().all()
    assert back.uns["spatialcore_annotation"]["n_types"] == 3
    for col in ("cell_type", "cell_type_ontology_term_id"):
        assert back.obs[col].astype(str).equals(
            outs["jax"].obs[col].astype(str)), col


def test_cli_benchmark(tmp_path, capsys):
    adata = _adata(400, 8)
    adata.obs["cell_type"] = np.random.default_rng(1).choice(["A", "B", "C"],
                                                             400)
    adata.obs["other"] = np.random.default_rng(2).choice(["A", "B"], 400)
    path = tmp_path / "b.h5ad"
    pt.write_h5ad(adata, path)
    out = _run(capsys, "benchmark", str(path), "--columns", "cell_type",
               "--device", "cpu")
    for metric in ("unassigned_rate", "deg_log2fc", "marker_purity"):
        assert metric in out
    out = _run(capsys, "benchmark", str(path), "--columns", "cell_type,other",
               "--device", "cpu")
    assert "cell_type" in out and "other" in out


def test_r_bridge_not_available(tmp_path, monkeypatch):
    if shutil.which("Rscript") is None:
        assert r_bridge.check_r_available() is False
    monkeypatch.setenv("PATH", str(tmp_path))      # no Rscript on PATH
    assert r_bridge.check_r_available() is False
    with pytest.raises(r_bridge.RNotFoundError, match="Rscript not found"):
        r_bridge.get_r_version()
    with pytest.raises(r_bridge.RNotFoundError):
        r_bridge.run_r_code("1 + 1")
    script = tmp_path / "x.R"
    with pytest.raises(r_bridge.RBridgeError, match="not found"):
        r_bridge.run_r_script(script)
    script.write_text("cat(1)\n")
    with pytest.raises(r_bridge.RNotFoundError):
        r_bridge.run_r_script(script)
    assert issubclass(r_bridge.RExecutionError, r_bridge.RBridgeError)
    assert issubclass(r_bridge.RTimeoutError, r_bridge.RBridgeError)
    err = r_bridge.RExecutionError("m", stdout="o", stderr="e", returncode=2)
    assert (err.stdout, err.stderr, err.returncode) == ("o", "e", 2)
    from spatialcore_tpu import r_bridge as jr
    assert r_bridge.__all__ == jr.__all__


def test_import_needs_no_h5py_yaml_or_jax():
    """``import spatialcore_tpu_torch`` with h5py, yaml, optax and orbax
    unimportable: every module imports, the command line's ``info`` runs,
    and no JAX module is loaded."""
    code = (
        "import sys\n"
        "for m in ('h5py', 'yaml', 'optax', 'orbax', 'jax'):\n"
        "    sys.modules[m] = None\n"
        "import spatialcore_tpu_torch as p\n"
        "import spatialcore_tpu_torch.annotation.training\n"
        "import spatialcore_tpu_torch.annotation.pipeline\n"
        "import spatialcore_tpu_torch.annotation.loading\n"
        "from spatialcore_tpu_torch import __main__ as cli\n"
        "assert p.available_modules() == ['core', 'ops', 'spatial', 'stats', "
        "'annotation', 'utils', 'nmf', 'diffusion', 'r_bridge']\n"
        "cli.main(['info'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'optax', 'orbax', 'spatialcore_tpu') and sys.modules[m]]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-800:]
    assert "annotation   ok" in out.stdout


def test_no_module_of_the_port_imports_jax():
    """No source file of the port names JAX, optax, orbax or the JAX
    package in an import."""
    import re
    from pathlib import Path

    root = Path(pt.__file__).parent
    pat = re.compile(r"^\s*(import|from)\s+(jax|optax|orbax|spatialcore_tpu)"
                     r"(\.|\s|$)", re.M)
    hits = [str(p.relative_to(root)) for p in root.rglob("*.py")
            if pat.search(p.read_text())]
    assert not hits, hits
