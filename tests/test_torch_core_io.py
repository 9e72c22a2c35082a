"""The port's core layer and utils against the JAX package, on the CPU:
h5ad files each package reads from the other, normalization, gene names,
the container (slicing, ``concat``, ``Raw``), provenance, caching,
logging, and ``utils`` (the Xenium-like simulator, sparse moments, the
profiling hooks).

Tolerances, and why:
- h5ad: every value read back equal (bitwise; the same encoding both ways);
- normalization: ``normalize_total``, ``log1p`` and
  ``normalize_log1p_from_raw`` bitwise (the same numpy / scipy code);
  detection results equal;
- gene names, container, metadata: equal;
- ``simulate_xenium``: bitwise (numpy Philox streams; the port draws the
  per-cell niche and type choices in one vectorized pass that reproduces
  ``Generator.choice``'s single double per draw);
- ``sparse_gene_moments``: bitwise.
"""

import json
import logging
from importlib import resources
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import spatialcore_tpu as sct
import spatialcore_tpu.core as jcore
import spatialcore_tpu.utils as jutils
import spatialcore_tpu_torch as sctt
import spatialcore_tpu_torch.core as tcore
import spatialcore_tpu_torch.utils as tutils

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)


def _build(pkg, sparse: bool, seed: int = 0):
    """A container with every kind of value h5ad carries, from one seed."""
    r = np.random.default_rng(seed)
    n, g = 60, 9
    counts = r.poisson(1.5, (n, g)).astype(np.float32)
    X = sp.csr_matrix(counts) if sparse else counts
    obs = pd.DataFrame({
        "cell_type": pd.Categorical(r.choice(["T", "B", "Mac"], n)),
        "score": r.normal(size=n),
        "count": r.integers(0, 100, n),
        "flag": r.random(n) > 0.5,
        "label": r.choice(["a", "b", "c"], n).astype(object),
    }, index=[f"cell_{i}" for i in range(n)])
    var = pd.DataFrame({"gene_ids": [f"ENSG{i:011d}" for i in range(g)],
                        "hv": r.random(g) > 0.3},
                       index=[f"G{i}" for i in range(g)])
    a = pkg.SpatialData(X=X, obs=obs, var=var)
    a.layers["counts"] = sp.csr_matrix(counts)
    a.layers["dense"] = counts * 2
    a.obsm["spatial"] = r.uniform(0, 100, (n, 2)).astype(np.float32)
    a.obsm["X_pca"] = r.normal(size=(n, 3))
    a.varm["loadings"] = r.normal(size=(g, 2)).astype(np.float32)
    a.obsp["connectivities"] = sp.random(n, n, density=0.05, format="csr",
                                         random_state=seed, dtype=np.float32)
    a.uns["params"] = {"k": 6, "alpha": 0.05, "name": "run", "ok": True,
                       "nothing": None, "nested": {"v": np.arange(4)}}
    a.uns["table"] = pd.DataFrame({"gene": ["G0", "G1"], "I": [0.5, -0.1]})
    a.uns["labels"] = ["x", "y"]
    a.store_raw()
    pkg.core.update_metadata(a, "build", parameters={"seed": seed})
    return a


def _assert_same(got, want):
    assert got.shape == want.shape
    for attr in ("X",):
        x, y = getattr(got, attr), getattr(want, attr)
        assert sp.issparse(x) == sp.issparse(y)
        if sp.issparse(x):
            assert x.format == y.format and (x != y).nnz == 0
        else:
            np.testing.assert_array_equal(x, y)
    pd.testing.assert_frame_equal(got.obs, want.obs)
    pd.testing.assert_frame_equal(got.var, want.var)
    for attr in ("layers", "obsm", "varm", "obsp"):
        a, b = getattr(got, attr), getattr(want, attr)
        assert set(a) == set(b), attr
        for k in a:
            if sp.issparse(b[k]):
                assert (a[k] != b[k]).nnz == 0
            else:
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype
    assert got.uns["params"]["k"] == want.uns["params"]["k"]
    assert got.uns["params"]["name"] == "run" and got.uns["params"]["ok"] is True
    assert got.uns["params"]["nothing"] is None
    np.testing.assert_array_equal(got.uns["params"]["nested"]["v"], np.arange(4))
    pd.testing.assert_frame_equal(got.uns["table"], want.uns["table"])
    assert list(got.uns["labels"]) == ["x", "y"]
    assert (got.raw.X != want.raw.X).nnz == 0 if sp.issparse(want.raw.X) \
        else np.array_equal(got.raw.X, want.raw.X)
    pd.testing.assert_frame_equal(got.raw.var, want.raw.var)
    ops_got = [o["function"] for o in got.uns["spatialcore_metadata"]["operations"]]
    ops_want = [o["function"] for o in want.uns["spatialcore_metadata"]["operations"]]
    assert ops_got == ops_want == ["build"]


@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_h5ad_each_package_reads_the_other(tmp_path, sparse, writer):
    """A file written by one package reads back equal in both: X, layers,
    obs, var, obsm, varm, obsp, uns, raw and the provenance ledger."""
    w_pkg, r_pkgs = (sct, (sct, sctt)) if writer == "reference" else (sctt, (sct, sctt))
    src = _build(w_pkg, sparse)
    path = tmp_path / "x.h5ad"
    w_pkg.write_h5ad(src, path)
    assert isinstance(src.uns["spatialcore_metadata"], dict)  # restored
    backs = [pkg.read_h5ad(path) for pkg in r_pkgs]
    assert isinstance(backs[1], tcore.SpatialData)
    for back in backs:
        _assert_same(back, src)


def test_write_h5ad_takes_tensors(tmp_path):
    """Torch tensors in X, obsm, layers and uns are written as their numpy
    values; reading returns numpy, as the reference does."""
    r = np.random.default_rng(1)
    X = r.random((20, 4)).astype(np.float32)
    a = tcore.SpatialData(X=torch.as_tensor(X))
    a.obsm["spatial"] = torch.as_tensor(r.random((20, 2)).astype(np.float32))
    a.layers["z"] = torch.as_tensor(X * 3)
    a.uns["t"] = {"w": torch.arange(5)}
    path = tmp_path / "t.h5ad"
    tcore.write_h5ad(a, path)
    for back in (tcore.read_h5ad(path), jcore.read_h5ad(path)):
        np.testing.assert_array_equal(back.X, X)
        np.testing.assert_array_equal(back.obsm["spatial"], a.obsm["spatial"].numpy())
        np.testing.assert_array_equal(back.layers["z"], X * 3)
        np.testing.assert_array_equal(back.uns["t"]["w"], np.arange(5))


def test_import_needs_no_h5py_sklearn_or_jax():
    """``import spatialcore_tpu_torch`` and its subpackages work with h5py
    and sklearn unimportable, and load no JAX module."""
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "sys.modules['sklearn'] = None\n"
        "import spatialcore_tpu_torch, spatialcore_tpu_torch.core, "
        "spatialcore_tpu_torch.spatial, spatialcore_tpu_torch.utils, "
        "spatialcore_tpu_torch.ops, spatialcore_tpu_torch.annotation\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'spatialcore_tpu' or m.startswith('spatialcore_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _counts(n=300, g=12, seed=2):
    r = np.random.default_rng(seed)
    c = r.poisson(r.gamma(2.0, 1.0, (n, g))).astype(np.float32)
    c[5] = 0.0                                     # an empty cell
    return c


@pytest.mark.parametrize("sparse", [True, False])
def test_normalization_bitwise(sparse):
    c = _counts()
    mats = {}
    for name, pkg in (("ref", jcore), ("port", tcore)):
        a = pkg.SpatialData(X=sp.csr_matrix(c) if sparse else c.copy())
        a.layers["counts"] = sp.csr_matrix(c) if sparse else c.copy()
        pkg.normalize_total(a, target_sum=1e4)
        nt = a.X.copy()
        pkg.log1p(a)
        lg = a.X.copy()
        b = pkg.SpatialData(X=np.log1p(c))
        b.layers["raw_counts"] = c.copy()
        pkg.normalize_log1p_from_raw(b, target_sum=1e6)
        mats[name] = (nt, lg, b.X, a.uns["log1p"])
    for x, y in zip(mats["ref"][:3], mats["port"][:3]):
        x = x.toarray() if sp.issparse(x) else x
        y = y.toarray() if sp.issparse(y) else y
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert mats["ref"][3] == mats["port"][3]


def _states(pkg):
    c = _counts()
    norm = np.log1p(c / np.maximum(c.sum(1, keepdims=True), 1) * 1e4).astype(np.float32)
    cpm = np.log1p(c / np.maximum(c.sum(1, keepdims=True), 1) * 1e6).astype(np.float32)
    out = {
        "raw_X": pkg.SpatialData(X=c.copy()),
        "log1p_10k": pkg.SpatialData(X=norm.copy()),
        "log1p_cpm": pkg.SpatialData(X=cpm.copy()),
        "linear": pkg.SpatialData(X=(c * 37.3 + 30).astype(np.float32)),
        "negative": pkg.SpatialData(X=norm - 1.0),
    }
    lay = pkg.SpatialData(X=norm.copy())
    lay.layers["raw"] = sp.csr_matrix(c)
    out["layer_raw"] = lay
    raw = pkg.SpatialData(X=c.copy())
    raw.store_raw()
    raw.X = norm.copy()
    out["raw_X_store"] = raw
    return out


def test_normalization_detection_equal():
    ref, port = _states(jcore), _states(tcore)
    for k in ref:
        want = jcore.check_normalization_status(ref[k])
        got = tcore.check_normalization_status(port[k])
        assert got == want, k
        assert (tcore.find_raw_counts_source(port[k])
                == jcore.find_raw_counts_source(ref[k])), k
    with pytest.raises(ValueError, match="No raw counts"):
        tcore.normalize_log1p_from_raw(port["log1p_10k"])


def test_gene_names_with_builtin_mapping(tmp_path):
    mapping = json.loads((resources.files("spatialcore_tpu_torch.data.gene_mappings")
                          / "ensembl_to_hugo_builtin.json").read_text())
    ids = list(mapping)[:6]
    names = ([ids[0], ids[1] + ".7", ids[2], "ENSG99999999999", "CD3E",
              "MS4A1", ids[0]])
    results = {}
    for name, pkg in (("ref", jcore), ("port", tcore)):
        m = pkg.load_ensembl_to_hugo_mapping(cache_path=tmp_path / "none.tsv")
        a = pkg.SpatialData(X=np.zeros((3, len(names)), np.float32),
                            var=pd.DataFrame(index=names))
        a.store_raw()
        pkg.normalize_gene_names(a, ensembl_to_hugo=m)
        b = pkg.SpatialData(X=np.zeros((2, 3), np.float32),
                            var=pd.DataFrame({"feature_name": ["CD3E", "CD3E", "LYZ"]},
                                             index=["0", "1", "2"]))
        pkg.normalize_gene_names(b, ensembl_to_hugo=m)
        results[name] = (m, list(a.var_names), list(a.raw.var_names),
                         list(b.var_names))
    assert results["port"][0] == results["ref"][0]
    assert results["port"][1:] == results["ref"][1:]
    assert results["port"][1][0] == mapping[ids[0]]
    assert [tcore.is_ensembl_id(x) for x in names + [None, 3]] == \
        [jcore.is_ensembl_id(x) for x in names + [None, 3]]


def _grid_adata(pkg, seed=3):
    r = np.random.default_rng(seed)
    n, g = 12, 5
    a = pkg.SpatialData(
        X=sp.csr_matrix(r.poisson(1.0, (n, g)).astype(np.float32)),
        obs=pd.DataFrame({"t": list("abcabcabcabc")},
                         index=[f"c{i}" for i in range(n)]),
        var=pd.DataFrame(index=["A", "B", "A", "C", "B"]))
    a.obsm["spatial"] = r.random((n, 2)).astype(np.float32)
    a.varm["w"] = r.random((g, 2))
    a.obsp["d"] = sp.csr_matrix(r.random((n, n)).astype(np.float32))
    a.layers["l"] = r.random((n, g)).astype(np.float32)
    a.store_raw()
    return a


def _same_container(got, want):
    x, y = got.X, want.X
    np.testing.assert_array_equal(x.toarray() if sp.issparse(x) else x,
                                  y.toarray() if sp.issparse(y) else y)
    pd.testing.assert_frame_equal(got.obs, want.obs)
    pd.testing.assert_frame_equal(got.var, want.var)
    for attr in ("obsm", "varm", "obsp", "layers"):
        for k, v in getattr(want, attr).items():
            w = getattr(got, attr)[k]
            w = w.numpy() if isinstance(w, torch.Tensor) else w
            np.testing.assert_array_equal(w.toarray() if sp.issparse(w) else w,
                                          v.toarray() if sp.issparse(v) else v)
    if want.raw is not None:
        np.testing.assert_array_equal(got.raw.X.toarray(), want.raw.X.toarray())
        assert list(got.raw.var_names) == list(want.raw.var_names)


@pytest.mark.parametrize("index", [
    (slice(2, 9), slice(None)),
    (np.arange(12) % 3 == 0, ["A", "C"]),
    ([5, 0, 7], [4, 1]),
    (["c3", "c1"], slice(None, None, 2)),
    (4, 2),
])
def test_container_slicing(index):
    ref, port = _grid_adata(jcore), _grid_adata(tcore)
    ref.var_names_make_unique()
    port.var_names_make_unique()
    assert list(port.var_names) == list(ref.var_names) == ["A", "B", "A-1", "C", "B-1"]
    _same_container(port[index], ref[index])
    assert port[index].raw.shape == ref[index].raw.shape


def test_container_tensors_slice_on_their_device():
    a = _grid_adata(tcore)
    a.var_names_make_unique()
    a.obsm["emb"] = torch.arange(24.0).reshape(12, 2)
    a.layers["t"] = torch.ones(12, 5)
    sub = a[np.arange(12) > 6, [0, 3]]
    assert isinstance(sub.obsm["emb"], torch.Tensor)
    assert torch.equal(sub.obsm["emb"], a.obsm["emb"][7:])
    assert tuple(sub.layers["t"].shape) == (5, 2)
    c = a.copy()
    c.obsm["emb"][0, 0] = -1.0
    assert float(a.obsm["emb"][0, 0]) == 0.0     # copy() clones tensors
    with pytest.raises(IndexError):
        a[np.ones(3, bool)]
    with pytest.raises(KeyError):
        a[:, ["missing"]]


@pytest.mark.parametrize("join", ["inner", "outer"])
@pytest.mark.parametrize("sparse", [True, False])
def test_concat(join, sparse):
    outs = []
    for pkg in (jcore, tcore):
        r = np.random.default_rng(4)
        objs = []
        for i, genes in enumerate((["a", "b", "c"], ["b", "c", "d", "e"])):
            x = r.poisson(2.0, (4 + i, len(genes))).astype(np.float32)
            objs.append(pkg.SpatialData(
                X=sp.csr_matrix(x) if sparse else x,
                obs=pd.DataFrame({"q": np.arange(4 + i)},
                                 index=[f"c{j}" for j in range(4 + i)]),
                var=pd.DataFrame(index=genes)))
        outs.append(pkg.concat(objs, join=join, label="batch",
                               keys=["s1", "s2"], index_unique="-"))
    _same_container(outs[1], outs[0])
    t = tcore.concat([tcore.SpatialData(X=torch.ones(2, 2)),
                      tcore.SpatialData(X=torch.zeros(3, 2))])
    assert isinstance(t.X, torch.Tensor) and tuple(t.X.shape) == (5, 2)


def test_raw_and_get_matrix():
    for pkg in (jcore, tcore):
        a = _grid_adata(pkg)
        assert isinstance(a.raw, pkg.Raw)
        assert a.get_matrix("raw") is a.raw.X
        assert a.raw[[0, 2], [3]].shape == (2, 1)
        assert a.raw.to_adata().shape == a.shape
    with pytest.raises(ValueError, match="raw"):
        tcore.SpatialData(X=np.zeros((2, 2))).get_matrix("raw")


def test_metadata_tracker_and_h5ad_helpers(tmp_path):
    a = tcore.SpatialData(X=np.zeros((3, 2), np.float32))
    tr = tcore.MetadataTracker(a, json_path=tmp_path / "ledger.json")
    op = tr.record("step", parameters={"x": np.int64(3), "p": tmp_path})
    assert op["version"] == sctt.__version__
    assert json.loads((tmp_path / "ledger.json").read_text())["operations"][0][
        "parameters"]["x"] == 3
    tcore.prepare_metadata_for_h5ad(a)
    assert isinstance(a.uns["spatialcore_metadata"], str)
    tcore.update_metadata(a, "after")
    assert [o["function"] for o in tcore.get_operations(a)] == ["step", "after"]
    tcore.prepare_metadata_for_h5ad(a)
    tcore.restore_metadata_from_h5ad(a)
    assert isinstance(a.uns["spatialcore_metadata"], dict)


def test_cache_result_round_trip(tmp_path):
    calls = []

    @tcore.cache_result(name="mk", cache_dir=tmp_path)
    def make(n):
        calls.append(n)
        return tcore.SpatialData(X=np.full((n, 2), 1.5, np.float32))

    a = make(3)
    b = make(3)
    assert calls == [3] and np.array_equal(a.X, b.X)
    path = tcore.get_cache_path("mk", (3,), {}, tmp_path)
    assert path.exists() and path == jcore.get_cache_path("mk", (3,), {}, tmp_path)
    assert tcore.clear_cache(tmp_path, name="mk") == 1
    make(3, use_cache=False)
    assert calls == [3, 3]


def test_setup_logging(tmp_path):
    import io

    buf = io.StringIO()
    root = tcore.setup_logging("DEBUG", format_string="%(message)s", stream=buf)
    root = tcore.setup_logging("INFO", fmt="%(message)s", stream=buf)
    assert sum(isinstance(h, logging.StreamHandler)
               and not isinstance(h, logging.FileHandler)
               for h in root.handlers) == 1
    tcore.get_logger("test").info("hello")
    assert buf.getvalue().strip() == "hello"
    fh = tcore.setup_file_logging(tmp_path / "log" / "run.log")
    tcore.get_logger("test").warning("to file")
    for h in list(fh.handlers):
        if isinstance(h, logging.FileHandler):
            h.close()
            fh.removeHandler(h)
    assert "to file" in (tmp_path / "log" / "run.log").read_text()
    tcore.setup_logging()


@pytest.mark.parametrize("n_cells,n_genes,seed", [(1500, 128, 0), (700, 200, 7)])
def test_simulate_xenium_bitwise(n_cells, n_genes, seed):
    a, ta = jutils.simulate_xenium(n_cells=n_cells, n_genes=n_genes, seed=seed)
    b, tb = tutils.simulate_xenium(n_cells=n_cells, n_genes=n_genes, seed=seed)
    assert isinstance(b, tcore.SpatialData)
    assert (a.X != b.X).nnz == 0 and (a.layers["counts"] != b.layers["counts"]).nnz == 0
    assert a.obsm["spatial"].dtype == b.obsm["spatial"].dtype
    assert np.array_equal(a.obsm["spatial"], b.obsm["spatial"])
    pd.testing.assert_frame_equal(a.obs, b.obs)
    pd.testing.assert_frame_equal(a.var, b.var)
    assert ta == tb
    assert tutils.XENIUM_NICHES == jutils.XENIUM_NICHES


@pytest.mark.parametrize("ddof", [0, 1])
def test_sparse_gene_moments_bitwise(ddof):
    c = _counts()
    for X in (sp.csr_matrix(c), c):
        for x, y in zip(jutils.sparse_gene_moments(X, ddof=ddof),
                        tutils.sparse_gene_moments(X, ddof=ddof)):
            assert np.array_equal(x, y)


def test_profiling_hooks(tmp_path):
    store = {}
    with tutils.timer("blk", store=store):
        torch.ones(10).sum()
    assert store["blk"] >= 0

    @tutils.timed(label="f")
    def f(x):
        return x + 1

    assert f(1) == 2
    with tutils.profile_trace(tmp_path / "trace") as path:
        torch.ones(100).cumsum(0)
    assert json.loads(open(path).read())["traceEvents"]
