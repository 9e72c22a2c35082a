"""The port's ``plotting/`` against the JAX package's: each figure function
of both packages runs on the same data under the Agg backend, and one
helper reads every axis of the two figures (title, labels, tick labels,
line data, collection offsets and face colours, patch extents, image
arrays, texts): equal, floats within 1e-6. The numeric parts are held
against the reference's sklearn values: NMI and ARI within 1e-12, the
silhouette means per type within rtol 1e-5, the classification table and
the confusion counts equal.
"""

import os
import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import spatialcore_tpu as sct  # noqa: E402
import spatialcore_tpu.plotting as jp  # noqa: E402
import spatialcore_tpu_torch as sctt  # noqa: E402
import spatialcore_tpu_torch.plotting as tp  # noqa: E402
import spatialcore_tpu_torch.spatial.neighborhoods as tnb  # noqa: E402

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

TYPES = ["B cell", "T cell", "monocyte", "natural killer cell"]
MARKERS = {"B cell": ["MS4A1", "CD79A", "CD79B", "CD19"],
           "T cell": ["CD3D", "CD3E", "CD3G", "TRAC"],
           "monocyte": ["CD14", "LYZ", "VCAN", "FCN1"],
           "natural killer cell": ["NKG7", "GNLY", "KLRD1", "PRF1"]}
GENES = [g for t in TYPES for g in MARKERS[t]] + [f"OTHER{i}" for i in range(4)]


def _data(n=800, seed=0):
    """Cells of four types with their markers raised, coordinates, scores
    and the results the result-reading figures need."""
    rng = np.random.default_rng(seed)
    labels = np.array(TYPES)[rng.integers(0, 4, n)]
    X = rng.poisson(0.3, (n, len(GENES))).astype(np.float32)
    for i, t in enumerate(TYPES):
        m = labels == t
        X[np.ix_(m, np.arange(4 * i, 4 * i + 4))] += rng.poisson(
            4.0, (int(m.sum()), 4))
    obs = pd.DataFrame(index=[f"c{i}" for i in range(n)])
    obs["cell_type"] = labels
    pred = labels.copy()
    flip = rng.random(n) < 0.15
    pred[flip] = np.array(TYPES)[rng.integers(0, 4, int(flip.sum()))]
    obs["cell_type_predicted"] = pred
    obs["cell_type_confidence"] = rng.beta(5, 2, n).astype(np.float32)
    obs["cell_type_model"] = np.array(["lr", "knn"])[rng.integers(0, 2, n)]
    obs["cell_type_ontology_term_id"] = obs["cell_type"].map(
        {t: f"CL:{i:07d}" for i, t in enumerate(TYPES)}).astype(str)
    obs["domain"] = np.where(rng.random(n) < 0.5, "d1", "d2")
    obs.loc[rng.random(n) < 0.3, "domain"] = None
    obs["distance_to_target"] = np.where(rng.random(n) < 0.8,
                                         rng.uniform(0, 100, n), np.nan)
    coords = rng.uniform(0, 1000, (n, 2)).astype(np.float32)
    z = rng.standard_normal((n, 2)).astype(np.float32)
    bands = pd.DataFrame({"gene": ["CD3D"] * 3 + ["LYZ"] * 3,
                          "band_lo": [0.0, 50, 100] * 2,
                          "band_hi": [50.0, 100, 150] * 2,
                          "I": rng.normal(0, 0.3, 6),
                          "p_value": [0.01, 0.2, 0.03, 0.5, 0.001, 0.04]})
    return dict(
        X=X, obs=obs, coords=coords, emb=rng.standard_normal((n, 5)),
        obsm={"X_umap": rng.standard_normal((n, 2)).astype(np.float32),
              "getis_ord_hotspot": rng.integers(-1, 2, (n, 2)).astype(np.int8),
              "local_morans_z": z,
              "local_morans_lag": (0.5 * z + 0.5 * rng.standard_normal(
                  (n, 2))).astype(np.float32),
              "local_morans_quadrant": rng.integers(0, 5, (n, 2)).astype(
                  np.int8)},
        uns={"getis_ord_params": {"genes": ["CD3D", "LYZ"], "star": True},
             "local_morans_params": {"genes": ["CD3D", "LYZ"]},
             "moran_correlogram": bands,
             "co_occurrence": {"score": rng.uniform(0.5, 1.5, (5, 4, 4)),
                               "interval": np.linspace(0, 100, 6)},
             "co_occurrence_types": np.array(TYPES),
             "domain_distances": {"distance_matrix": {
                 "d1": {"d1": 0.0, "d2": 120.0},
                 "d2": {"d1": 120.0, "d2": 0.0}}}})


def _adata(pkg, d, tensors=False):
    """One package's container over the data; the port's may hold its
    matrices as tensors (the figures copy them to the host)."""
    X = torch.as_tensor(d["X"]) if tensors else d["X"].copy()
    a = pkg.SpatialData(X=X, obs=d["obs"].copy(),
                        var=pd.DataFrame(index=GENES))
    a.obsm["spatial"] = (torch.as_tensor(d["coords"]) if tensors
                         else d["coords"].copy())
    a.obsm["X_pca"] = d["emb"].copy()
    for k, v in d["obsm"].items():
        a.obsm[k] = torch.as_tensor(v) if tensors else v.copy()
    for k, v in d["uns"].items():
        a.uns[k] = v.copy() if hasattr(v, "copy") else v
    return a


@pytest.fixture(scope="module")
def data():
    return _data()


def _colors(c):
    return np.asarray(c, np.float64).reshape(-1, 4) if len(c) else np.zeros(
        (0, 4))


def _summary(fig):
    """Everything a figure shows, axis by axis, as nested lists."""
    out = []
    for ax in fig.axes:
        ent = {"title": ax.get_title(), "xlabel": ax.get_xlabel(),
               "ylabel": ax.get_ylabel(),
               "xticks": [t.get_text() for t in ax.get_xticklabels()],
               "yticks": [t.get_text() for t in ax.get_yticklabels()],
               "texts": [t.get_text() for t in ax.texts],
               "lines": [np.asarray(ln.get_xydata(), np.float64)
                         for ln in ax.lines],
               "offsets": [np.asarray(c.get_offsets(), np.float64)
                           for c in ax.collections],
               "faces": [_colors(c.get_facecolors()) for c in ax.collections],
               "patches": [np.asarray(p.get_path().transformed(
                   p.get_patch_transform()).vertices, np.float64)
                   for p in ax.patches],
               "images": [np.asarray(im.get_array(), np.float64)
                          for im in ax.images]}
        leg = ax.get_legend()
        ent["legend"] = [t.get_text() for t in leg.get_texts()] if leg else []
        out.append(ent)
    return out


def _same_figure(got, want, rtol=1e-6):
    a, b = _summary(got), _summary(want)
    assert len(a) == len(b), (len(a), len(b))
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], str):
                assert x[k] == y[k], (i, k, x[k], y[k])
            elif x[k] and isinstance(x[k][0], str):
                assert x[k] == y[k], (i, k)
            else:
                assert len(x[k]) == len(y[k]), (i, k)
                for u, v in zip(x[k], y[k]):
                    assert u.shape == v.shape, (i, k, u.shape, v.shape)
                    np.testing.assert_allclose(u, v, rtol=rtol, atol=1e-6,
                                               err_msg=f"axis {i} {k}")
    plt.close(got)
    plt.close(want)


def _both(name, d, args_fn, tensors=False, port_kw=None, **kw):
    """(port figure, reference figure) of one function on the same data."""
    aj, at = _adata(sct, d), _adata(sctt, d, tensors)
    want = getattr(jp, name)(*args_fn(aj), **kw)
    got = getattr(tp, name)(*args_fn(at), **kw, **(port_kw or {}))
    return got, want


CPU = {"device": "cpu"}

FIGURES = [
    ("plot_celltype_distribution", lambda a: (a,), {}, None),
    ("plot_celltype_pie", lambda a: (a,), {}, None),
    ("plot_celltype_embedding", lambda a: (a,), {}, None),
    ("plot_celltype_umap", lambda a: (a,), {}, None),
    ("plot_confidence_histogram", lambda a: (a,), {"threshold": 0.6}, None),
    ("plot_confidence_by_celltype", lambda a: (a,), {}, None),
    ("plot_confidence_violin", lambda a: (a,), {}, None),
    ("plot_model_contribution", lambda a: (a,), {}, None),
    ("plot_spatial_celltype", lambda a: (a,), {}, None),
    ("plot_spatial_confidence", lambda a: (a,), {}, None),
    ("plot_spatial_gene", lambda a: (a, "CD3D"), {}, None),
    ("plot_spatial_genes", lambda a: (a, ["CD3D", "LYZ", "NKG7"]), {}, None),
    ("plot_spatial_multi_gene", lambda a: (a, ["CD14", "GNLY"]),
     {"dark_background": True}, None),
    ("plot_spatial_hotspots", lambda a: (a, "LYZ"), {}, None),
    ("plot_moran_scatter", lambda a: (a, "CD3D"), {}, None),
    ("plot_correlogram", lambda a: (a,), {}, None),
    ("plot_co_occurrence", lambda a: (a, "T cell"), {}, None),
    ("plot_domain_distances", lambda a: (a, "domain"), {}, None),
    ("plot_distance_map", lambda a: (a,), {}, None),
    ("plot_marker_heatmap", lambda a: (a,), {"markers": MARKERS}, None),
    ("plot_marker_dotplot", lambda a: (a,), {"markers": MARKERS}, None),
    ("plot_deg_heatmap", lambda a: (a,), {}, CPU),
    ("plot_celltype_confidence_spatial", lambda a: (a,), {}, None),
    ("plot_celltype_confidence", lambda a: (a,), {}, None),
    ("plot_ontology_mapping_table", lambda a: (a,), {}, None),
    ("plot_ontology_mapping", lambda a: (a,), {}, None),
    ("plot_confusion_matrix", lambda a: (
        a.obs["cell_type"], a.obs["cell_type_predicted"]), {}, CPU),
    ("plot_confusion_matrix", lambda a: (
        a, "cell_type", "cell_type_predicted"), {"normalize": False}, CPU),
    ("plot_classification_report", lambda a: (
        a.obs["cell_type"].to_numpy(), a.obs["cell_type_predicted"]), {}, CPU),
    ("plot_agreement_heatmap", lambda a: (
        a, ["cell_type", "cell_type_predicted"]), {}, CPU),
    ("plot_agreement_heatmap", lambda a: (
        a, ["cell_type", "cell_type_predicted", "cell_type_model"]), {}, CPU),
]


@pytest.mark.parametrize("tensors", [False, True])
@pytest.mark.parametrize("name,args_fn,kw,port_kw", FIGURES,
                         ids=[f"{f[0]}-{i}" for i, f in enumerate(FIGURES)])
def test_figure_matches_reference(data, name, args_fn, kw, port_kw, tensors):
    got, want = _both(name, data, args_fn, tensors, port_kw, **kw)
    _same_figure(got, want)


def test_method_comparison_matches_reference():
    df = pd.DataFrame({"method": ["lr", "knn", "rf"],
                       "accuracy": [0.9, 0.8, 0.85], "f1": [0.7, 0.75, 0.6]})
    _same_figure(tp.plot_method_comparison(df.copy()),
                 jp.plot_method_comparison(df.copy()))


def test_2d_validation_matches_reference(data):
    aj, at = _adata(sct, data), _adata(sctt, data, tensors=True)
    fj, sj = jp.plot_2d_validation(aj, markers=MARKERS,
                                   confidence_threshold=0.7)
    ft, st = tp.plot_2d_validation(at, markers=MARKERS,
                                   confidence_threshold=0.7, device="cpu")
    pd.testing.assert_frame_equal(st, sj)
    _same_figure(ft, fj)


def test_silhouette_by_type_matches_reference(data):
    """Per-type means within rtol 1e-5 of sklearn's silhouette_samples, on
    the same seeded 300-cell subsample."""
    aj, at = _adata(sct, data), _adata(sctt, data, tensors=True)
    at.obsm["X_pca"] = torch.as_tensor(data["emb"])
    kw = dict(sample_size=300, random_state=3)
    _same_figure(tp.plot_silhouette_by_type(at, device="cpu", **kw),
                 jp.plot_silhouette_by_type(aj, **kw), rtol=1e-5)


def test_silhouette_samples_match_sklearn():
    from sklearn.metrics import silhouette_samples

    rng = np.random.default_rng(4)
    X = rng.standard_normal((400, 6)).astype(np.float32)
    labels = rng.integers(0, 5, 400).astype(str)
    got = tp.benchmark.silhouette_samples(torch.as_tensor(X), labels).numpy()
    np.testing.assert_allclose(got, silhouette_samples(X, labels), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("seed,n_a,n_b", [(0, 4, 4), (1, 7, 3), (2, 1, 5),
                                          (3, 1, 1), (4, 30, 40)])
def test_agreement_metrics_match_sklearn(seed, n_a, n_b):
    from sklearn.metrics import (adjusted_rand_score,
                                 normalized_mutual_info_score)

    rng = np.random.default_rng(seed)
    a = rng.integers(0, n_a, 2000).astype(str)
    b = np.where(rng.random(2000) < 0.6, a,
                 rng.integers(0, n_b, 2000).astype(str))
    got = tp.agreement_metrics(a, b, device="cpu")
    assert abs(got["nmi"] - normalized_mutual_info_score(a, b)) <= 1e-12
    assert abs(got["ari"] - adjusted_rand_score(a, b)) <= 1e-12
    assert got["ari"] == tnb.adjusted_rand_score(a, b)
    assert got == jp.agreement_metrics(a, b) or (
        abs(got["nmi"] - jp.agreement_metrics(a, b)["nmi"]) <= 1e-12)
    codes = torch.as_tensor(np.unique(a, return_inverse=True)[1])
    assert abs(tp.agreement_metrics(codes, b, device="cpu")["nmi"]
               - got["nmi"]) <= 1e-12


def test_classification_table_and_counts_equal(data):
    aj, at = _adata(sct, data), _adata(sctt, data)
    pd.testing.assert_frame_equal(
        tp.classification_report_table(at, "cell_type", "cell_type_predicted",
                                       device="cpu"),
        jp.classification_report_table(aj, "cell_type",
                                       "cell_type_predicted"))
    yt = data["obs"]["cell_type"].to_numpy()
    yp = data["obs"]["cell_type_predicted"].to_numpy()
    cm = tp.benchmark.confusion_counts(yt, yp, TYPES, device="cpu").numpy()
    want = pd.crosstab(pd.Categorical(yt, TYPES), pd.Categorical(yp, TYPES),
                       dropna=False).to_numpy()
    np.testing.assert_array_equal(cm, want)


def test_gpairs_matches_reference(tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    feats = rng.gamma(2.0, 1.0, (3000, 2)).astype(np.float32)
    scores = feats.mean(axis=1)
    clusters = (scores > 2.0).astype(np.int64)
    figs = []
    for mod in (jp.gpairs, tp.gpairs):
        monkeypatch.setattr(mod, "save_figure",
                            lambda fig, path: figs.append(fig) or path)
    jp.gpairs.plot_gpairs(feats, scores, 2.0, clusters, ["a", "b"],
                          tmp_path / "g.png", n_sample=1000)
    tp.gpairs.plot_gpairs(torch.as_tensor(feats), torch.as_tensor(scores), 2.0,
                          torch.as_tensor(clusters), ["a", "b"],
                          tmp_path / "g.png", n_sample=1000)
    _same_figure(figs[1], figs[0])


def test_classify_plot_writes_gpairs(tmp_path):
    rng = np.random.default_rng(1)
    a = sctt.SpatialData(X=rng.poisson(2.0, (600, 3)).astype(np.float32),
                         var=pd.DataFrame(index=["M0", "M1", "M2"]))
    sctt.stats.classify_by_threshold(a, ["M0", "M1"], plot=True,
                                     output_dir=tmp_path, device="cpu")
    assert (tmp_path / "threshold_gpairs.png").stat().st_size > 0


def test_generate_annotation_plots_matches_reference(data, tmp_path):
    aj, at = _adata(sct, data), _adata(sctt, data, tensors=True)
    rj = jp.generate_annotation_plots(aj, markers=MARKERS,
                                      output_dir=tmp_path / "qc_reference")
    rt = tp.generate_annotation_plots(at, markers=MARKERS,
                                      output_dir=tmp_path / "qc",
                                      device="cpu")
    assert sorted(rt["figures"]) == sorted(rj["figures"])
    for name in rj["figures"]:
        _same_figure(rt["figures"][name], rj["figures"][name])
        assert rt["paths"][name].stat().st_size > 0
    pd.testing.assert_frame_equal(rt["summary"], rj["summary"])
    assert (tmp_path / "qc" / "celltyping_validation_summary.csv").exists()


def test_palettes_and_utils(tmp_path):
    labs = ["b", "a", "c", "a"]
    assert tp.generate_celltype_palette(labs) == jp.generate_celltype_palette(
        labs)
    assert tp.generate_celltype_palette(labs, colorblind=True,
                                        custom_colors={"a": "#123456"}) == \
        jp.generate_celltype_palette(labs, colorblind=True,
                                     custom_colors={"a": "#123456"})
    p = tp.save_palette({"a": "#000000"}, tmp_path / "p.json")
    assert jp.load_palette(p) == {"a": "#000000"} == tp.load_celltype_palette(p)
    fig, axes = tp.setup_multi_figure(2, 3)
    assert axes.shape == (2, 3)
    tp.format_axis_labels(axes[0, 0], xlabel="x", title="t", rotation=45)
    tp.despine(axes[0, 0])
    assert axes[0, 0].get_title() == "t"
    assert tp.save_figure(fig, tmp_path / "f", formats=["png", "pdf"]) == \
        tmp_path / "f.png"
    assert (tmp_path / "f.pdf").exists()
    fig, ax = tp.setup_figure(figsize=(3, 2))
    tp.close_figure(fig)
    assert sorted(tp.__all__) == sorted(jp.__all__)
    assert all(hasattr(tp, n) for n in tp.__all__)


def test_port_imports_without_matplotlib():
    """``import spatialcore_tpu_torch`` and its plotting package with
    matplotlib unimportable: nothing imports it until a figure is drawn."""
    code = ("import sys\n"
            "sys.modules['matplotlib'] = None\n"
            "import spatialcore_tpu_torch as p\n"
            "import spatialcore_tpu_torch.plotting as tp\n"
            "from spatialcore_tpu_torch.plotting import benchmark, validation\n"
            "assert 'plotting' in p.available_modules()\n"
            "assert tp.agreement_metrics(['a', 'b'], ['a', 'b'], "
            "device='cpu')['nmi'] == 1.0\n"
            "assert sys.modules['matplotlib'] is None\n"
            "try:\n"
            "    tp.setup_figure()\n"
            "except ImportError:\n"
            "    pass\n"
            "else:\n"
            "    raise SystemExit('a figure drawn without matplotlib')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-800:]
