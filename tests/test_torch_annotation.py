"""CPU parity of the port's annotation scoring path against the JAX
package: the ``CellTypeModel`` artifact (saved by either package, loaded
by the other: arrays bitwise, predictions equal), decision scores (within
1e-5: float32 products in another order), confidence transforms (within
1e-12, float64), the filters, the markers, the registry and URI
resolution, ``annotate_cells`` (labels equal, confidences within 1e-6),
``filter_by_marker_validation`` (labels equal), the benchmark's metrics
(within rtol 1e-5) and the whole path end to end on one container.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import spatialcore_tpu as sct
import spatialcore_tpu.annotation as ja
import spatialcore_tpu_torch as pt
import spatialcore_tpu_torch.annotation as pa
from spatialcore_tpu_torch.annotation import acquisition as pacq

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

MARKERS = ja.load_canonical_markers()
TYPES = ["B cell", "T cell", "endothelial cell", "fibroblast", "macrophage",
         "epithelial cell", "mast cell", "pericyte"]


def _panel(n=3000, seed=0, n_fill=12):
    """Log1p-normalized counts with planted types and their canonical
    markers, and two models (class centroids as weights; the second on a
    subset of the genes)."""
    rng = np.random.default_rng(seed)
    genes = sorted({g for t in TYPES for g in MARKERS[t]})
    genes += [f"FILL{i}" for i in range(n_fill)]
    gi = {g: i for i, g in enumerate(genes)}
    lab = rng.integers(0, len(TYPES), n)
    mu = np.full((len(TYPES), len(genes)), 0.3)
    for t, ty in enumerate(TYPES):
        for g in MARKERS[ty]:
            mu[t, gi[g]] = 3.0
    counts = rng.poisson(mu[lab]).astype(np.float32)
    X = np.log1p(counts / np.maximum(counts.sum(1, keepdims=True), 1) * 1e4
                 ).astype(np.float32)
    obs = pd.DataFrame({"truth": pd.Categorical(np.array(TYPES)[lab])})
    var = pd.DataFrame(index=genes)
    cent = np.stack([X[lab == t].mean(0) for t in range(len(TYPES))])
    mean, std = X.mean(0), X.std(0) + 1e-3
    W = ((cent - mean) / std).T.astype(np.float32)
    m1 = ja.CellTypeModel(genes=genes, classes=TYPES, W=W,
                          b=np.zeros(len(TYPES), np.float32),
                          scaler_mean=mean.astype(np.float32),
                          scaler_std=std.astype(np.float32),
                          metadata={"model_name": "panel"})
    k = len(genes) * 3 // 4
    extra = [f"ABSENT{i}" for i in range(4)]
    m2 = ja.CellTypeModel(
        genes=genes[:k] + extra, classes=TYPES,
        W=np.vstack([W[:k] * 1.3, rng.normal(0, 1, (4, len(TYPES)))]
                    ).astype(np.float32),
        b=rng.normal(0, 0.1, len(TYPES)).astype(np.float32),
        scaler_mean=np.concatenate([mean[:k], np.ones(4)]).astype(np.float32),
        scaler_std=np.concatenate([std[:k], np.ones(4)]).astype(np.float32),
        metadata={"model_name": "partial"})
    return X, obs, var, m1, m2


def _pair(X, obs, var):
    return (sct.SpatialData(X=X.copy(), obs=obs.copy(), var=var.copy()),
            pt.SpatialData(X=X.copy(), obs=obs.copy(), var=var.copy()))


def test_model_artifacts_cross_load(tmp_path):
    X, _, var, m1, m2 = _panel(n=500)
    path = m2.save(tmp_path / "jax_saved")
    port = pa.CellTypeModel.load(path)
    for f in ("W", "b", "scaler_mean", "scaler_std"):
        np.testing.assert_array_equal(getattr(port, f), getattr(m2, f))
    assert port.genes == m2.genes and port.classes == m2.classes
    assert port.metadata["model_name"] == "partial"
    back = ja.CellTypeModel.load(port.save(tmp_path / "port_saved"))
    for f in ("W", "b", "scaler_mean", "scaler_std"):
        np.testing.assert_array_equal(getattr(back, f), getattr(m2, f))
    assert back.genes == m2.genes and back.metadata == port.metadata
    gidx = np.array([list(var.index).index(g) if g in var.index else -1
                     for g in m2.genes], np.int32)
    lab_j, _ = m2.predict(X, gidx)
    lab_p, _ = port.predict(X, gidx, device="cpu")
    np.testing.assert_array_equal(lab_p, lab_j)


@pytest.mark.parametrize("batch", [65536, 128])
def test_decision_scores_within_tolerance(batch):
    """Absent genes score as the scaler mean; within 1e-5 of the
    reference's scores, from numpy and from a CPU tensor alike."""
    X, _, var, m1, m2 = _panel(n=700, seed=1)
    pm = pa.CellTypeModel(m2.genes, m2.classes, m2.W, m2.b, m2.scaler_mean,
                          m2.scaler_std)
    gidx = np.array([list(var.index).index(g) if g in var.index else -1
                     for g in m2.genes], np.int32)
    want = m2.decision_scores(X, gidx, batch_size=batch)
    for x in (X, torch.from_numpy(X)):
        got = pm.decision_scores(x, gidx, batch_size=batch, device="cpu")
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("method", ["raw", "zscore", "softmax", "minmax"])
def test_transform_confidence_matches(method):
    rng = np.random.default_rng(2)
    s = rng.normal(0, 3, (500, 6)).astype(np.float32)
    s[0] = 1.0                                       # a flat row
    want = ja.transform_confidence(s, method)
    np.testing.assert_allclose(pa.transform_confidence(s, method), want,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        pa.transform_confidence(torch.from_numpy(s), method), want,
        rtol=1e-12, atol=1e-12)


def test_transform_confidence_errors():
    with pytest.raises(ValueError, match="at least 2"):
        pa.transform_confidence(np.zeros((3, 1)))
    with pytest.raises(ValueError, match="Unknown"):
        pa.transform_confidence(np.zeros((3, 2)), "nope")


def test_markers_match_the_reference():
    assert pa.load_canonical_markers() == MARKERS
    from spatialcore_tpu.annotation import markers as jm
    from spatialcore_tpu_torch.annotation import markers as pm
    for t in ("B cell", "b CELL", "nope"):
        assert pa.get_markers_for_type(t) == ja.get_markers_for_type(t)
        assert pm.match_to_canonical(t) == jm.match_to_canonical(t)
    assert pm.list_available_cell_types() == jm.list_available_cell_types()


def test_registry_and_uri_resolution(tmp_path):
    _, _, _, m1, _ = _panel(n=200)
    reg = tmp_path / "registry.json"
    path = pa.publish_model(pa.CellTypeModel(m1.genes, m1.classes, m1.W, m1.b,
                                             m1.scaler_mean, m1.scaler_std,
                                             {"model_name": "panel"}),
                            "panel", models_dir=tmp_path / "models",
                            registry_path=reg)
    assert pa.load_registry(reg) == ja.load_registry(reg) == {"panel": str(path)}
    for name in ("panel", str(path), f"file://{path}"):
        got = pa.resolve_model(name, models_dir=tmp_path / "models",
                               registry_path=reg)
        np.testing.assert_array_equal(got.W, m1.W)
    jm = ja.resolve_model("panel", models_dir=tmp_path / "models",
                          registry_path=reg)
    np.testing.assert_array_equal(jm.W, m1.W)
    with pytest.raises(FileNotFoundError, match="publish_model"):
        pa.resolve_model("missing", models_dir=tmp_path, registry_path=reg)
    assert pa.resolve_uri_to_local(str(path)) == path
    assert pa.resolve_uri_to_local(f"file://{path}") == path
    with pytest.raises(FileNotFoundError):
        pa.resolve_uri_to_local(str(tmp_path / "nope.h5ad"))
    for uri in ("synapse://syn123", "cellxgene://census/lung"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 14"):
            pa.resolve_uri_to_local(uri, cache_dir=tmp_path)
    with pytest.raises(ValueError, match="Unknown URI scheme"):
        pa.resolve_uri_to_local("ftp://x/y", cache_dir=tmp_path)
    with pytest.raises(ImportError, match="optional dependency"):
        pacq._require("a_module_that_is_not_installed", "gs")


@pytest.mark.parametrize("which,kw", [
    ("single", {}),
    ("ensemble", {}),
    ("ensemble", {"batch_size": 256, "confidence_method": "softmax"}),
    ("single", {"renormalize_overlap": False}),
])
def test_annotate_cells_matches(which, kw):
    X, obs, var, m1, m2 = _panel(seed=3)
    a, b = _pair(X, obs, var)
    models = [m1] if which == "single" else [m1, m2]
    pm = [pa.CellTypeModel(m.genes, m.classes, m.W, m.b, m.scaler_mean,
                           m.scaler_std, dict(m.metadata)) for m in models]
    ja.annotate_cells(a, models, **kw)
    pa.annotate_cells(b, pm, device="cpu", **kw)
    for c in ("cell_type", "cell_type_predicted", "cell_type_model"):
        assert a.obs[c].astype(str).equals(b.obs[c].astype(str))
    for c in ("cell_type_confidence", "cell_type_confidence_raw"):
        np.testing.assert_allclose(b.obs[c], a.obs[c], atol=1e-5)
    np.testing.assert_allclose(b.obsm["cell_type_decision_scores"],
                               a.obsm["cell_type_decision_scores"], atol=1e-5)
    assert (b.uns["cell_type_decision_scores_classes"]
            == a.uns["cell_type_decision_scores_classes"])
    assert (a.obs["cell_type"].astype(str) == obs["truth"].astype(str)).mean() \
        > 0.9


def test_annotate_gate_front_end_and_helpers(tmp_path):
    X, obs, var, m1, m2 = _panel(n=800, seed=4)
    a, b = _pair(X, obs, var)
    bad = pa.CellTypeModel([f"X{i}" for i in range(10)], m1.classes,
                           np.zeros((10, len(TYPES)), np.float32), m1.b,
                           np.zeros(10, np.float32), np.ones(10, np.float32))
    with pytest.raises(ValueError, match="overlap the panel"):
        pa.annotate_cells(b, bad, device="cpu")
    path = m1.save(tmp_path / "panel")
    clusters = pd.Categorical(np.arange(800) % 7)
    a.obs["cl"] = clusters
    b.obs["cl"] = clusters
    kw = dict(custom_model_path=str(path), majority_voting=True,
              over_clustering="cl", min_prop=0.3, min_confidence=0.6)
    ja.annotate_celltypist(a, **kw)
    pa.annotate_celltypist(b, device="cpu", **kw)
    assert a.obs["cell_type"].astype(str).equals(b.obs["cell_type"].astype(str))
    assert pa.get_model_gene_overlap(str(path), b) == \
        ja.get_model_gene_overlap(str(path), a)
    sa, sb = ja.get_annotation_summary(a), pa.get_annotation_summary(b)
    assert sa["type_counts"] == sb["type_counts"]
    assert sb["median_confidence"] == pytest.approx(sa["median_confidence"],
                                                    abs=1e-6)
    assert pa.get_models_for_tissue("Lymph node") == \
        ja.get_models_for_tissue("Lymph node")
    assert pa.TISSUE_MODEL_PRESETS == ja.TISSUE_MODEL_PRESETS


def test_filters_match():
    X, obs, var, m1, _ = _panel(n=1000, seed=5)
    a, b = _pair(X, obs, var)
    conf = np.random.default_rng(5).random(1000)
    for d in (a, b):
        d.obs["cell_type"] = d.obs["truth"].astype(str)
        d.obs["cell_type_confidence"] = conf
        d.obs.loc[d.obs.index[:15], "cell_type"] = "rare"
    ja.filter_low_confidence(a, threshold=0.3)
    pa.filter_low_confidence(b, threshold=0.3)
    ja.filter_low_count_types(a, min_cells=20)
    pa.filter_low_count_types(b, min_cells=20)
    assert a.obs["cell_type"].astype(str).equals(b.obs["cell_type"].astype(str))
    for d, mod in ((a, ja), (b, pa)):
        d.obsm["cell_type_decision_scores"] = np.random.default_rng(6).normal(
            size=(1000, 3)).astype(np.float32)
        d.uns["cell_type_decision_scores_classes"] = ["x", "y", "z"]
        mod.compute_confidence_from_obsm(d, out_column="c2")
    np.testing.assert_allclose(b.obs["c2"], a.obs["c2"], rtol=1e-12)
    scores, classes = pa.extract_decision_scores(b, "cell_type_decision_scores")
    assert classes == ["x", "y", "z"] and scores.shape == (1000, 3)


@pytest.mark.parametrize("k", [2, 3])
def test_filter_by_marker_validation_matches(k):
    X, obs, var, m1, _ = _panel(n=2400, seed=6)
    a, b = _pair(X, obs, var)
    conf = np.random.default_rng(7).random(2400)
    for d in (a, b):
        d.obs["cell_type"] = d.obs["truth"].astype(str)
        d.obs["cell_type_confidence"] = conf
    kw = dict(markers=MARKERS, min_cells_per_type=100, n_components=k)
    ja.filter_by_marker_validation(a, **kw)
    pa.filter_by_marker_validation(b, device="cpu", **kw)
    assert a.obs["cell_type"].astype(str).equals(b.obs["cell_type"].astype(str))
    assert (b.obs["cell_type"] == "Unassigned").sum() > 0


def test_benchmark_metrics_match():
    X, obs, var, m1, _ = _panel(n=2000, seed=8)
    a, b = _pair(X, obs, var)
    rng = np.random.default_rng(8)
    noisy = obs["truth"].astype(str).to_numpy().copy()
    flip = rng.random(2000) < 0.2
    noisy[flip] = rng.choice(TYPES, flip.sum())
    noisy[:30] = "Unassigned"
    for d in (a, b):
        d.obs["noisy"] = pd.Categorical(noisy)
        d.obs["conf"] = rng.random(2000) if d is a else a.obs["conf"].to_numpy()
    ta = ja.marker_quality_metrics(a, "truth", markers=MARKERS)
    tb = pa.marker_quality_metrics(b, "truth", markers=MARKERS, device="cpu")
    pd.testing.assert_frame_equal(tb, ta, rtol=1e-5, check_dtype=False)
    da = ja.deg_log2fc(a, "noisy")
    db = pa.deg_log2fc(b, "noisy", device="cpu")
    pd.testing.assert_series_equal(db, da, atol=1e-4, check_exact=False)
    assert pa.gene_overlap(m1.genes[:5] + ["NOPE"], var.index) == \
        ja.gene_overlap(m1.genes[:5] + ["NOPE"], var.index)
    assert pa.unassigned_rate(b, "noisy", confidence_column="conf") == \
        ja.unassigned_rate(a, "noisy", confidence_column="conf")
    kw = dict(cell_type_columns=["truth", "noisy"],
              confidence_columns=[None, "conf"], markers=MARKERS)
    tab_a = ja.compare_annotation_methods(a, **kw)
    tab_b = pa.compare_annotation_methods(b, device="cpu", **kw)
    pd.testing.assert_frame_equal(tab_b, tab_a, atol=1e-4, check_exact=False)


def test_end_to_end_annotate_validate_benchmark(tmp_path):
    """``annotate_cells`` (ensemble, resolved from files) →
    ``filter_by_marker_validation`` → ``benchmark_annotation`` on the same
    container in both packages: labels equal at every step, the summary
    within 1e-4."""
    X, obs, var, m1, m2 = _panel(n=3000, seed=9)
    paths = [m1.save(tmp_path / "panel"), m2.save(tmp_path / "partial")]
    a, b = _pair(X, obs, var)
    ja.annotate_cells(a, [str(p) for p in paths], models_dir=tmp_path)
    pa.annotate_cells(b, [str(p) for p in paths], models_dir=tmp_path,
                      device="cpu")
    assert a.obs["cell_type"].astype(str).equals(b.obs["cell_type"].astype(str))
    ja.filter_by_marker_validation(a, markers=MARKERS, min_cells_per_type=50)
    pa.filter_by_marker_validation(b, markers=MARKERS, min_cells_per_type=50,
                                   device="cpu")
    assert a.obs["cell_type"].astype(str).equals(b.obs["cell_type"].astype(str))
    sa = ja.benchmark_annotation(a, markers=MARKERS, model_genes=m2.genes,
                                 confidence_column="cell_type_confidence")
    sb = pa.benchmark_annotation(b, markers=MARKERS, model_genes=m2.genes,
                                 confidence_column="cell_type_confidence",
                                 device="cpu")
    pd.testing.assert_series_equal(sb, sa, atol=1e-4, check_exact=False)
    assert set(b.uns["annotation_benchmark"]) == {"summary", "per_type",
                                                  "params"}
