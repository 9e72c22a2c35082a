"""CPU parity of the port's loading, acquisition, discovery and the
``train_and_annotate`` pipeline against the JAX package: stratified
indices and backed loads equal (rows, X and obs), acquisition and the
gated cloud schemes, discovery and the metadata CSVs, the Synapse and
CELLxGENE clients' guards and pure helpers, ``train_and_annotate`` on the
same reference h5ads and query (``cell_type``, the CL ID columns and
``n_unassigned`` equal; the models within 1e-5 of max|W|; the port's run
from the references in memory bitwise its run from the files), the YAML
``TrainingConfig`` that each package writes loading in the other, and the
cases of ``tests/test_loading_acquisition.py`` and
``tests/test_pipeline.py`` on the port.
"""

import logging

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

import spatialcore_tpu as sct
import spatialcore_tpu.annotation as ja
import spatialcore_tpu_torch as pt
import spatialcore_tpu_torch.annotation as pa
from spatialcore_tpu.annotation import cellxgene as jcx
from spatialcore_tpu_torch.annotation import cellxgene as pcx
from spatialcore_tpu_torch.annotation import synapse as psyn

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

TYPES = ["T cell", "B cell", "Macrophage", "Fibroblast"]


def _write_ref(tmp_path, n=500, seed=0, name="ref.h5ad"):
    rng = np.random.default_rng(seed)
    X = sp.csr_matrix(rng.poisson(2.0, (n, 12)).astype(np.float32))
    obs = pd.DataFrame({"cell_type": rng.choice(["A", "B", "C"], n,
                                                p=[0.6, 0.3, 0.1])},
                       index=[f"cell_{i}" for i in range(n)])
    var = pd.DataFrame(index=[f"GENE{j}" for j in range(12)])
    adata = pt.SpatialData(X=X, obs=obs, var=var)
    adata.obsm["spatial"] = rng.uniform(0, 1000, (n, 2)).astype(np.float32)
    p = tmp_path / name
    pt.write_h5ad(adata, p)
    return p, adata


@pytest.mark.parametrize("n_target,min_per_class", [(200, 1), (37, 3),
                                                    (2000, 1)])
def test_stratified_sample_indices_equal(n_target, min_per_class):
    labels = np.array(["A"] * 600 + ["B"] * 300 + ["C"] * 100)
    got = pa.stratified_sample_indices(labels, n_target, seed=0,
                                       min_per_class=min_per_class)
    assert np.array_equal(got, ja.stratified_sample_indices(
        labels, n_target, seed=0, min_per_class=min_per_class))
    if n_target == 200:
        assert got.size == 200 and 0.5 < (labels[got] == "A").mean() < 0.7


@pytest.mark.parametrize("kw", [{"max_cells": 120, "stratify_by": "cell_type"},
                                {"max_cells": 90, "stratify_by": None},
                                {"max_cells": None}])
def test_load_adata_backed_equal(tmp_path, kw):
    p, full = _write_ref(tmp_path)
    got = pa.load_adata_backed(p, backed_threshold_bytes=0, seed=0, **kw)
    want = ja.load_adata_backed(p, backed_threshold_bytes=0, seed=0, **kw)
    assert list(got.obs_names) == list(want.obs_names)
    assert (got.X != want.X).nnz == 0
    pd.testing.assert_frame_equal(got.obs, want.obs)
    np.testing.assert_array_equal(got.obsm["spatial"], want.obsm["spatial"])
    if kw["max_cells"] == 120:
        assert got.obs["cell_type"].nunique() == 3
        lookup = {n: i for i, n in enumerate(full.obs_names)}
        full_X = full.X.toarray()
        for i, name in enumerate(got.obs_names[:20]):
            np.testing.assert_array_equal(got.X[i].toarray()[0],
                                          full_X[lookup[name]])


def test_small_file_loads_fully_and_subsample_equal(tmp_path):
    p, full = _write_ref(tmp_path)
    assert pa.load_adata_backed(p).n_obs == full.n_obs
    a = sct.read_h5ad(p)
    b = pt.read_h5ad(p)
    for kw in ({"stratify_by": "cell_type"}, {}):
        assert list(pa.subsample_adata(b, 77, seed=3, **kw).obs_names) == \
            list(ja.subsample_adata(a, 77, seed=3, **kw).obs_names)
    assert pa.subsample_adata(b, 10_000).n_obs == b.n_obs
    s = pa.get_loading_summary(b)
    assert s == ja.get_loading_summary(a)
    t = pa.get_loading_summary(pt.SpatialData(X=torch.tensor(b.X.toarray())))
    assert t["sparsity"] == s["sparsity"]
    assert pa.estimate_adata_memory_gb(1000, 100) == \
        ja.estimate_adata_memory_gb(1000, 100)
    assert pa.estimate_adata_memory_gb(p) == ja.estimate_adata_memory_gb(p)
    assert pa.get_available_memory_gb() > 0


def test_acquire_reference_local_and_cache(tmp_path):
    p, _ = _write_ref(tmp_path)
    out = tmp_path / "out" / "copy.h5ad"
    got = pa.acquire_reference(str(p), out)
    assert got.exists() and got.stat().st_size == p.stat().st_size
    assert pa.acquire_reference(str(p), out) == out       # skipped: exists
    assert pa.acquire_reference(f"file://{p}", out, force=True) == out
    assert pa.resolve_uri_to_local(f"file://{p}") == p
    with pytest.raises(FileNotFoundError):
        pa.resolve_uri_to_local(str(tmp_path / "missing.h5ad"))
    with pytest.raises(ValueError, match="Unknown URI scheme"):
        pa.resolve_uri_to_local("weird://thing")


def test_gated_cloud_schemes_raise_helpfully(tmp_path):
    for uri, sdk in (("gs://bucket/thing.h5ad", "gcsfs"),
                     ("s3://bucket/thing.h5ad", "boto3"),
                     ("synapse://syn123", "synapseclient"),
                     ("cellxgene://healthy_human_liver", "cellxgene")):
        try:
            __import__(sdk if sdk != "cellxgene" else "cellxgene_census")
            continue
        except ImportError:
            pass
        with pytest.raises(ImportError, match=sdk):
            pa.acquire_reference(uri, tmp_path / "o.h5ad",
                                 cache_dir=tmp_path / "cache")
    with pytest.raises(ValueError, match="Unknown dataset"):
        pa.download_cellxgene_reference("not_a_dataset", tmp_path)
    with pytest.raises(ImportError, match="cellxgene"):
        pa.query_cellxgene_census(tissue="lung",
                                  output_path=tmp_path / "x.h5ad")
    with pytest.raises(ImportError, match="synapseclient"):
        pa.download_synapse_reference("syn1", tmp_path / "s.h5ad")
    with pytest.raises(ImportError, match="synapseclient"):
        pa.authenticate_synapse()
    with pytest.raises(ImportError, match="synapseclient"):
        pa.list_synapse_folder("syn2")


def test_client_pure_helpers_equal():
    assert pcx.CELLXGENE_DATASETS == jcx.CELLXGENE_DATASETS
    pd.testing.assert_frame_equal(pa.list_available_datasets(),
                                  ja.list_available_datasets())
    for label in ("CD4-positive, alpha-beta T cell", None, "B cell", "t_cell"):
        assert pcx._label_tokens(label) == jcx._label_tokens(label)
    obs = pd.DataFrame({
        "cell_type": ["T cell", "CD4 T cell", "CD8 T cell", "B cell",
                      "naive B cell", "x"],
        "cell_type_ontology_term_id": ["CL:0000084", "CL:0000624",
                                       "CL:0000625", "CL:0000236",
                                       "CL:0000788", "UBERON:1"]})
    for min_tokens in (1, 2):
        got = pcx._parent_child_conflicts(obs, min_parent_tokens=min_tokens)
        assert got == jcx._parent_child_conflicts(
            obs, min_parent_tokens=min_tokens)
    assert pcx._parent_child_conflicts(obs, min_parent_tokens=2) == {
        "CL:0000084": ["CL:0000624", "CL:0000625"],
        "CL:0000236": ["CL:0000788"]}
    assert psyn._name_matches("a.h5ad", [".h5ad"])
    assert not psyn._name_matches("a.csv", [".h5ad"])
    assert psyn._name_matches("a.csv", None)


def test_discovery_and_metadata_roundtrip(tmp_path, capsys):
    _write_ref(tmp_path, name="a.h5ad")
    _write_ref(tmp_path, name="b.h5ad", seed=1)
    (tmp_path / "nested").mkdir()
    _write_ref(tmp_path / "nested", name="c.h5ad", seed=2)
    found = pa.discover_training_data(tmp_path)
    assert [(d.name, d.size_bytes) for d in found] == \
        [(d.name, d.size_bytes) for d in ja.discover_training_data(tmp_path)]
    assert {d.name for d in found} == {"a", "b", "c"}
    df = pa.make_metadata_template(found, tmp_path / "meta.csv")
    pd.testing.assert_frame_equal(df, ja.make_metadata_template(found))
    df.loc[df["name"] == "b", "include"] = False
    df.loc[df["name"] == "a", "tissue"] = "lung"
    df.to_csv(tmp_path / "meta.csv", index=False)
    assert set(pa.query_metadata(tmp_path / "meta.csv")["name"]) == {"a", "c"}
    assert list(pa.query_metadata(tmp_path / "meta.csv",
                                  tissue="lung")["name"]) == ["a"]
    pa.print_discovery_summary(found)
    ja.print_discovery_summary(found)
    out = capsys.readouterr().out.splitlines()
    assert out[:4] == out[4:]
    tmpl = pa.create_metadata_template(tmp_path / "t.csv", found)
    meta, samples = pa.load_local_metadata(tmpl)
    assert samples is None and len(meta) == 3
    meta["tissue"] = ["lung", "liver", "lung"]
    meta["n_cells"] = [500, 500, 2000]
    got = pa.query_local_references(meta, tissue="lung", min_cells=1000)
    pd.testing.assert_frame_equal(got, ja.query_local_references(
        meta, tissue="lung", min_cells=1000))
    assert list(got["name"]) == ["c"]
    with pytest.raises(FileNotFoundError):
        pa.discover_training_data(tmp_path / "nope")


def _raw_reference(pkg, n_per_type=250, n_genes=40, seed=0, source="ref",
                   counts_per_type=None):
    rng = np.random.default_rng(seed)
    sizes = counts_per_type or [n_per_type] * len(TYPES)
    lab = np.repeat(np.arange(len(TYPES)), sizes)
    counts = rng.poisson(1.0, size=(lab.size, n_genes)).astype(np.float32)
    for t, k in enumerate(sizes):
        counts[lab == t, t * 8:t * 8 + 8] += rng.poisson(8.0, size=(k, 8))
    obs = pd.DataFrame({"cell_type": np.array(TYPES)[lab]},
                       index=[f"{source}_{i}" for i in range(lab.size)])
    var = pd.DataFrame(index=[f"G{j}" for j in range(n_genes)])
    adata = pkg.SpatialData(X=sp.csr_matrix(counts), obs=obs, var=var)
    adata.layers["counts"] = sp.csr_matrix(counts)
    adata.uns["reference_name"] = source
    return adata


def _query(pkg):
    q = _raw_reference(pkg, seed=9, source="query",
                       counts_per_type=[130, 110, 120, 90])
    truth = q.obs["cell_type"].to_numpy().copy()
    q.obs.drop(columns=["cell_type"], inplace=True)
    return q, truth


def test_train_and_annotate_equal(tmp_path):
    """Both packages on the same reference h5ads and query; the port also
    from the same references in memory. (The reference's pipeline cannot
    take in-memory references: its metadata step deep-copies the config,
    references included, and its SpatialData does not survive
    ``copy.deepcopy``.)"""
    cfg = dict(epochs=12, max_cells_per_type=300, confidence_threshold=0.5,
               seed=0, make_plots=False, compute_benchmark=True)
    paths = []
    for seed, src, sizes in ((0, "refA", [300, 260, 240, 280]),
                             (1, "refB", [150, 170, 120, 140])):
        paths.append(tmp_path / f"{src}.h5ad")
        sct.write_h5ad(_raw_reference(sct, seed=seed, source=src,
                                      counts_per_type=sizes), paths[-1])
    runs = []
    for pkg, an, refs, kw in (
            (sct, ja, [str(p) for p in paths], {}),
            (pt, pa, [str(p) for p in paths], {"device": "cpu"}),
            (pt, pa, [pt.read_h5ad(p) for p in paths], {"device": "cpu"})):
        q, truth = _query(pkg)
        out = tmp_path / f"run{len(runs)}"
        q, model = an.train_and_annotate(
            q, references=refs,
            config=an.TrainingConfig(references=[], output_dir=str(out),
                                     model_name="e2e", **cfg), **kw)
        runs.append((q, model, out))
    (qj, mj, oj), (qp, mp, op), (qm, mm, _) = runs
    for col in ("cell_type", "cell_type_predicted",
                "cell_type_ontology_term_id", "cell_type_ontology_label"):
        assert qp.obs[col].astype(str).equals(qj.obs[col].astype(str)), col
        assert qm.obs[col].astype(str).equals(qp.obs[col].astype(str)), col
    sj, sp_ = (q.uns["spatialcore_annotation"] for q in (qj, qp))
    for k in ("n_unassigned", "n_types", "classes", "n_training_cells",
              "model_name"):
        assert sp_[k] == sj[k], k
    assert set(sp_["artifacts"]) == {"model", "metadata", "colors"}
    assert (op / "e2e.npz").exists()
    scale = float(np.abs(mj.W).max())
    np.testing.assert_allclose(mp.W, mj.W, rtol=0, atol=1e-5 * scale)
    assert np.array_equal(mm.W, mp.W)
    labeled = qp.obs["cell_type"].astype(str).to_numpy()
    assigned = labeled != "Unassigned"
    assert (labeled[assigned] == truth[assigned]).mean() > 0.9
    assert assigned.mean() > 0.8
    bench = qp.uns["annotation_benchmark"]["summary"]
    assert bench["gene_overlap"] == 1.0


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_pipeline_plot_stage_warns_and_goes_on(tmp_path):
    refs = [_raw_reference(pt, n_per_type=120, seed=0, source="refA")]
    q, _ = _query(pt)
    seen = _Records()
    log = logging.getLogger("spatialcore_tpu_torch.annotation.pipeline")
    log.addHandler(seen)
    try:
        q, model = pa.train_and_annotate(
            q, references=refs, device="cpu", epochs=3, make_plots=True,
            output_dir=str(tmp_path / "run"), confidence_threshold=0.5)
    finally:
        log.removeHandler(seen)
    assert not any("QC plot" in m for m in seen.messages), seen.messages
    for name in ("distribution", "confidence_histogram",
                 "confidence_by_celltype"):
        assert (tmp_path / "run" / f"celltyping_{name}.png").stat().st_size > 0
    assert q.uns["spatialcore_annotation"]["n_types"] == 4
    with pytest.raises(ValueError, match="Unknown config field"):
        pa.train_and_annotate(q, references=refs, device="cpu", nope=1)


def test_training_config_yaml_across_packages(tmp_path):
    cfg = pa.TrainingConfig(references=["a.h5ad"], epochs=7,
                            confidence_threshold=0.9, exclude_labels=["x"])
    p = cfg.to_yaml(tmp_path / "port.yaml")
    back = ja.TrainingConfig.from_yaml(p)
    assert back == ja.TrainingConfig(references=["a.h5ad"], epochs=7,
                                     confidence_threshold=0.9,
                                     exclude_labels=["x"])
    q = ja.TrainingConfig(references=["b.h5ad"], batch_size=64,
                          confidence_method="softmax")
    q.to_yaml(tmp_path / "jax.yaml")
    got = pa.TrainingConfig.from_yaml(tmp_path / "jax.yaml")
    assert got == pa.TrainingConfig(references=["b.h5ad"], batch_size=64,
                                    confidence_method="softmax")
    assert (tmp_path / "port.yaml").read_text() == \
        ja.TrainingConfig(references=["a.h5ad"], epochs=7,
                          confidence_threshold=0.9, exclude_labels=["x"]
                          ).to_yaml(tmp_path / "j2.yaml").read_text()
    for bad in (pa.TrainingConfig(references=[], epochs=0),
                pa.TrainingConfig(references=["a"], epochs=0),
                pa.TrainingConfig(references=["a"], confidence_threshold=2.0),
                pa.TrainingConfig(references=["a"], confidence_method="nope")):
        with pytest.raises(ValueError):
            bad.validate()


def test_train_and_annotate_config_from_yaml(tmp_path):
    ref = _raw_reference(pt, n_per_type=150, seed=2, source="refC")
    pt.write_h5ad(ref, tmp_path / "ref.h5ad")
    pa.TrainingConfig(references=[str(tmp_path / "ref.h5ad")], epochs=4,
                      confidence_threshold=0.5, make_plots=False
                      ).to_yaml(tmp_path / "cfg.yaml")
    q, truth = _query(pt)
    q, model = pa.train_and_annotate_config(q, tmp_path / "cfg.yaml",
                                            device="cpu")
    labels = q.obs["cell_type"].astype(str).to_numpy()
    assert (labels[labels != "Unassigned"] ==
            truth[labels != "Unassigned"]).mean() > 0.9
    assert model.metadata["epochs"] == 4
