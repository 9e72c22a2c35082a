"""The niche and domain path in the port against the JAX package, on the
CPU: neighborhood enrichment, neighborhood profiles, niches and their
stability, spatial domains and domain distances, and the path as a whole
from a simulated section written to and read from h5ad.

Tolerances, and why:
- ``neighborhood_enrichment``: counts, z, null mean and null std bitwise
  (exact integer counts; the same permutations; float32 sums in draw
  order; the reference's CPU run's fused multiply-adds and reciprocal
  multiplies reproduced, ``spatial/nhood.py``);
- ``compute_neighborhood_profile``: bitwise (exact counts, one division);
- ``identify_niches``: labels equal up to renaming (ARI 1.0), centroids and
  inertia rtol 1e-5 (Lloyd's sums in another order, ROADMAP Queue 3);
- ``niche_stability``: the ARIs equal (labels up to renaming on each
  subsample), the inertia per cell rtol 1e-5; the port's ARI bitwise
  sklearn's;
- ``make_spatial_domains``: the obs column, the params, boundaries and
  polygons equal (exact raster masks and labels); the port warns when the
  component loop stops at its cap with labels still changing;
- ``calculate_domain_distances``: "minimum" and "centroid" bitwise, per
  cell and per domain pair (``core.rng._fma32`` / ``_sqrt32``); "mean"
  rtol 1e-5 (the per-group sums add in another order).
"""

import logging

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch
from sklearn.metrics import adjusted_rand_score as sk_ari

import spatialcore_tpu as sct
import spatialcore_tpu.spatial as jsp
import spatialcore_tpu_torch as sctt
import spatialcore_tpu_torch.spatial as tsp
from spatialcore_tpu.utils import simulate_xenium as jsim
from spatialcore_tpu_torch.spatial.neighborhoods import adjusted_rand_score
from spatialcore_tpu_torch.utils import simulate_xenium as tsim

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

CPU = {"device": "cpu"}


def _pair(n=2500, seed=1, n_genes=128):
    """The same simulated section in both packages, at the default density."""
    extent = 5000.0 * (n / 40_000) ** 0.5
    a, _ = jsim(n_cells=n, n_genes=n_genes, extent=extent, seed=seed)
    b, _ = tsim(n_cells=n, n_genes=n_genes, extent=extent, seed=seed)
    return a, b


@pytest.fixture(scope="module")
def profiled():
    a, b = _pair()
    jsp.compute_neighborhood_profile(a, "true_type", k=10)
    tsp.compute_neighborhood_profile(b, "true_type", k=10, **CPU)
    return a, b


@pytest.mark.parametrize("n_perm,seed,k", [(0, 0, 6), (40, 3, 6), (25, 1, 10)])
def test_neighborhood_enrichment_bitwise(n_perm, seed, k):
    a, b = _pair(2000, seed=seed)
    jsp.neighborhood_enrichment(a, "true_type", n_permutations=n_perm,
                                seed=seed, n_neighbors=k)
    tsp.neighborhood_enrichment(b, "true_type", n_permutations=n_perm,
                                seed=seed, n_neighbors=k, **CPU)
    ua = a.uns["true_type_nhood_enrichment"]
    ub = b.uns["true_type_nhood_enrichment"]
    for key in ("count", "zscore", "null_mean", "null_std"):
        assert ub[key].dtype == ua[key].dtype == np.float32
        assert np.array_equal(ub[key], ua[key]), key
    assert ub["types"] == ua["types"] and ub["n_permutations"] == n_perm


def test_neighborhood_enrichment_large_counts():
    """Pair counts whose squares exceed 2^24: the fused s2 update and the
    variance's rounding decide the null std."""
    r = np.random.default_rng(7)
    n = 5000
    xy = r.uniform(0, 1000, (n, 2)).astype(np.float32)
    t = np.where(r.random(n) < 0.5, "a", "b")
    out = []
    for pkg, kw in ((sct, {}), (sctt, CPU)):
        d = pkg.SpatialData(X=np.zeros((n, 1), np.float32),
                            obs=pd.DataFrame({"t": t}))
        d.obsm["spatial"] = xy
        pkg.spatial.neighborhood_enrichment(d, "t", n_permutations=300, seed=3,
                                            **kw)
        out.append(d.uns["t_nhood_enrichment"])
    assert out[0]["count"].max() ** 2 > 2 ** 24
    for key in ("count", "zscore", "null_mean", "null_std"):
        assert np.array_equal(out[1][key], out[0][key]), key


def test_neighborhood_enrichment_stored_radius_graph():
    a, b = _pair(1500, seed=4)
    jsp.build_spatial_weights(a, radius=60.0, k_max=64)
    tsp.build_spatial_weights(b, radius=60.0, k_max=64, **CPU)
    jsp.neighborhood_enrichment(a, "true_type", n_permutations=20, seed=2)
    tsp.neighborhood_enrichment(b, "true_type", n_permutations=20, seed=2, **CPU)
    for key in ("count", "zscore", "null_mean", "null_std"):
        assert np.array_equal(b.uns["true_type_nhood_enrichment"][key],
                              a.uns["true_type_nhood_enrichment"][key]), key


@pytest.mark.parametrize("method,normalize", [("knn", True), ("knn", False),
                                              ("radius", True)])
def test_neighborhood_profile_bitwise(method, normalize):
    a, b = _pair(3000, seed=2)
    kw = dict(method=method, normalize=normalize, k=15, radius=80.0, k_max=96)
    jsp.compute_neighborhood_profile(a, "true_type", **kw)
    tsp.compute_neighborhood_profile(b, "true_type", **kw, **CPU)
    pa, pb = a.obsm["neighborhood_profile"], b.obsm["neighborhood_profile"]
    assert pb.dtype == pa.dtype == np.float32 and np.array_equal(pb, pa)
    assert (b.uns["neighborhood_profile_celltypes"]
            == a.uns["neighborhood_profile_celltypes"])


def test_neighborhood_profile_errors():
    _, b = _pair(600, seed=3)
    with pytest.raises(ValueError, match="empty neighborhood"):
        tsp.compute_neighborhood_profile(b, "true_type", method="radius",
                                         radius=1e-3, **CPU)
    with pytest.raises(ValueError, match="k="):
        tsp.compute_neighborhood_profile(b, "true_type", k=600, **CPU)
    with pytest.raises(ValueError, match="not found"):
        tsp.identify_niches(b, 3, **CPU)


@pytest.mark.parametrize("method", ["auto", "minibatch_kmeans"])
def test_identify_niches_up_to_renaming(profiled, method):
    a, b = profiled
    jsp.identify_niches(a, 6, method=method, random_state=3, n_init=3)
    tsp.identify_niches(b, 6, method=method, random_state=3, n_init=3, **CPU)
    assert adjusted_rand_score(a.obs["niche"], b.obs["niche"]) == 1.0
    assert list(b.obs["niche"].cat.categories) == list(a.obs["niche"].cat.categories)
    pa, pb = a.uns["niche_params"], b.uns["niche_params"]
    np.testing.assert_allclose(pb.pop("inertia"), pa.pop("inertia"), rtol=1e-5)
    assert pb == pa
    ca = a.uns["niche_centroids"]
    cb = b.uns["niche_centroids"]
    # the same clusters: match centroids by the labels' contingency
    for code in range(6):
        rows = (b.obs["niche"].cat.codes == code).to_numpy()
        ref_code = int(np.bincount(a.obs["niche"].cat.codes[rows]).argmax())
        np.testing.assert_allclose(cb[code], ca[ref_code], rtol=1e-5, atol=1e-7)


def test_niche_stability(profiled):
    a, b = profiled
    jsp.niche_stability(a, n_niches_range=range(4, 6), n_restarts=3, seed=2,
                        max_iter=50)
    tsp.niche_stability(b, n_niches_range=range(4, 6), n_restarts=3, seed=2,
                        max_iter=50, **CPU)
    for ra, rb in zip(a.uns["niche_stability"], b.uns["niche_stability"]):
        assert rb["n_niches"] == ra["n_niches"]
        assert rb["ari_mean"] == ra["ari_mean"] and rb["ari_std"] == ra["ari_std"]
        np.testing.assert_allclose(rb["inertia_per_cell"],
                                   ra["inertia_per_cell"], rtol=1e-5)


def test_adjusted_rand_score_bitwise_sklearn():
    r = np.random.default_rng(0)
    for t in range(200):
        n = int(r.integers(1, 300))
        x = r.integers(0, r.integers(1, 9), n)
        y = x.copy() if t % 4 == 0 else r.integers(0, r.integers(1, 9), n)
        if t % 5 == 0:
            y = np.array([f"l{v}" for v in (x + 2) % 3])
        assert adjusted_rand_score(x, y) == sk_ari(x, y)
    assert adjusted_rand_score([], []) == sk_ari([], [])


def _domains(pkg, d, kw, col, expr, **extra):
    pkg.spatial.make_spatial_domains(d, expr, output_column=col,
                                     platform="xenium", **extra, **kw)


def _same_domains(a, b, col):
    assert b.obs[col].astype(str).equals(a.obs[col].astype(str))
    assert list(b.obs[col].cat.categories) == list(a.obs[col].cat.categories)
    assert b.uns[f"{col}_params"] == a.uns[f"{col}_params"]
    for key in (f"{col}_boundaries", f"{col}_polygons"):
        ua, ub = a.uns[key], b.uns[key]
        assert ua.keys() == ub.keys()
        assert all(np.array_equal(ua[k], ub[k], equal_nan=True) for k in ua)


@pytest.fixture(scope="module")
def domained():
    a, b = _pair(4000, seed=5)
    for cell_type, col in (("B cell", "dom_b"), ("Endothelial", "dom_e")):
        _domains(sct, a, {}, col, f"true_type == '{cell_type}'")
        _domains(sctt, b, CPU, col, f"true_type == '{cell_type}'")
    return a, b


def test_make_spatial_domains_equal(domained):
    a, b = domained
    for col in ("dom_b", "dom_e"):
        _same_domains(a, b, col)
        assert a.uns[f"{col}_params"]["n_domains"] >= 2
    pd.testing.assert_frame_equal(tsp.get_domain_summary(b, "dom_b"),
                                  jsp.get_domain_summary(a, "dom_b"))
    pd.testing.assert_frame_equal(tsp.get_domain_summary(b, domain_column="dom_e"),
                                  jsp.get_domain_summary(a, domain_column="dom_e"))


@pytest.mark.parametrize("variant", ["bool_column", "ontology", "targets_only",
                                     "min_total"])
def test_make_spatial_domains_variants(variant):
    a, b = _pair(2500, seed=6)
    for d in (a, b):
        d.obs["is_t"] = d.obs["true_type"].str.startswith("T cell")
        d.obs["cell_type_ontology_id"] = np.where(
            d.obs["true_type"] == "B cell", "CL:0000236", "CL:0000000")
    expr, extra = {
        "bool_column": ("is_t", {}),
        "ontology": ("CL:0000236 | CL:0000625", {"domain_prefix": "B"}),
        "targets_only": ("is_t", {"assign_all_cells": False}),
        "min_total": ("true_type == 'Macrophage'",
                      {"min_total_cells_domain": 40, "cell_dist_um": 70.0,
                       "shrink_margin_um": 10.0}),
    }[variant]
    _domains(sct, a, {}, "dom", expr, **extra)
    _domains(sctt, b, CPU, "dom", expr, **extra)
    _same_domains(a, b, "dom")


def _snake_pair(n_rows=6, length=1500.0, spacing=160.0, step=8.0, seed=0):
    """Cells every ``step`` µm along a path winding through ``n_rows``
    rows ``spacing`` µm apart (``true_type`` "snake"), and scattered
    background cells ("other"), in both packages."""
    pts = []
    for r in range(n_rows):
        xs = np.arange(0.0, length, step)
        pts.append(np.stack([xs if r % 2 == 0 else xs[::-1],
                             np.full_like(xs, r * spacing)], 1))
        if r + 1 < n_rows:
            x = length - step if r % 2 == 0 else 0.0
            ys = np.arange(r * spacing, (r + 1) * spacing, step)
            pts.append(np.stack([np.full_like(ys, x), ys], 1))
    snake = np.vstack(pts)
    rng = np.random.default_rng(seed)
    other = rng.uniform([-200, -200], [length + 200, n_rows * spacing + 200],
                        (600, 2))
    coords = np.vstack([snake, other]).astype(np.float64)
    types = np.array(["snake"] * len(snake) + ["other"] * len(other))
    out = []
    for pkg in (sct, sctt):
        d = pkg.SpatialData(X=np.ones((len(coords), 2), np.float32),
                            obs=pd.DataFrame({"true_type": types}))
        d.obsm["spatial"] = coords.copy()
        out.append(d)
    return out


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _domains_seen(d, **kw):
    seen = _Warnings()
    log = logging.getLogger("spatialcore_tpu_torch.spatial.domains")
    log.addHandler(seen)
    try:
        _domains(sctt, d, CPU, "dom", "true_type == 'snake'", **kw)
    finally:
        log.removeHandler(seen)
    return [m for m in seen.messages if "connected-components" in m]


def test_domain_component_cap_warns(monkeypatch):
    """The winding band converges under the reference's cap (no warning,
    the reference's domains); with the cap cut to 3 iterations the loop
    stops with labels still changing, the band comes out as several
    domains, and the port warns, naming the cap and the raster."""
    from spatialcore_tpu_torch.ops import geometry as tg

    a, b = _snake_pair()
    _domains(sct, a, {}, "dom", "true_type == 'snake'")
    assert _domains_seen(b) == []
    _same_domains(a, b, "dom")
    assert b.uns["dom_params"]["n_domains"] == 1
    monkeypatch.setattr(tg, "CC_MAX_ITER", 3)
    _, c = _snake_pair()
    msgs = _domains_seen(c)
    assert len(msgs) == 1 and "cap of 3 iterations" in msgs[0]
    assert "x" in msgs[0].split("raster")[0].split()[-1]
    assert c.uns["dom_params"]["n_domains"] > 1


def test_detect_platform_and_errors():
    for c in (np.array([[0.0, 0.0], [14_000.0, 3.0]]),
              np.array([[0.0, 0.0], [30_000.0, 3.0]]),
              np.array([[0.0, 0.0], [60_000.0, 3.0]])):
        assert tsp.detect_platform(c) == jsp.detect_platform(c)
    _, b = _pair(500, seed=8)
    with pytest.raises(ValueError, match="filter_expression"):
        tsp.make_spatial_domains(b, None, **CPU)
    with pytest.raises(ValueError, match="No cells match"):
        tsp.make_spatial_domains(b, "true_type == 'none'", **CPU)
    with pytest.raises(KeyError):
        tsp.get_domain_summary(b, "missing")


@pytest.mark.parametrize("metric", ["minimum", "mean", "centroid"])
def test_domain_distances(domained, metric):
    a, b = domained
    jsp.calculate_domain_distances(a, "dom_b", "dom_e", distance_metric=metric)
    tsp.calculate_domain_distances(b, "dom_b", "dom_e", distance_metric=metric,
                                   **CPU)
    ma = jsp.get_distance_matrix(a)
    mb = tsp.get_distance_matrix(b)
    assert list(ma.index) == list(mb.index) and list(ma.columns) == list(mb.columns)
    da = a.obs["distance_to_target"].to_numpy()
    db = b.obs["distance_to_target"].to_numpy()
    assert b.obs["nearest_target_domain"].equals(a.obs["nearest_target_domain"])
    if metric == "mean":
        np.testing.assert_allclose(mb.to_numpy(), ma.to_numpy(), rtol=1e-5)
    else:
        assert np.array_equal(mb.to_numpy(), ma.to_numpy())
    assert np.array_equal(db, da, equal_nan=True)     # per cell: min or centroid
    ua, ub = dict(a.uns["domain_distances"]), dict(b.uns["domain_distances"])
    ua.pop("distance_matrix"), ub.pop("distance_matrix")
    assert ua == ub


def test_domain_distances_subset_and_modes(domained):
    a, b = domained
    src = list(a.obs["dom_b"].cat.categories[:1])
    tgt = list(a.obs["dom_e"].cat.categories[1:3])
    for pkg, d, kw in ((sct, a, {}), (sctt, b, CPU)):
        pkg.spatial.calculate_domain_distances(
            d, "dom_b", "dom_e", source_domain_subset=src,
            target_domain_subset=tgt, output_mode="cell",
            output_distance_column="dsub", output_nearest_column="nsub", **kw)
    assert np.array_equal(b.obs["dsub"].to_numpy(), a.obs["dsub"].to_numpy(),
                          equal_nan=True)
    assert b.obs["nsub"].equals(a.obs["nsub"])
    with pytest.raises(ValueError, match="not present"):
        tsp.calculate_domain_distances(b, "dom_b", "dom_e",
                                       source_domain_subset=["nope"], **CPU)
    with pytest.raises(KeyError):
        tsp.get_distance_matrix(b, key="missing")


def test_the_niche_and_domain_path(tmp_path):
    """The slice as a whole: a simulated section written to h5ad by each
    package and read back by the other, normalized from its raw counts,
    then enrichment, profiles, niches, two domain columns and their
    distances, against the reference's run of the same path."""
    a, b = _pair(3000, seed=9, n_genes=112)
    sct.write_h5ad(a, tmp_path / "ref.h5ad")
    sctt.write_h5ad(b, tmp_path / "port.h5ad")
    a = sct.read_h5ad(tmp_path / "port.h5ad")
    b = sctt.read_h5ad(tmp_path / "ref.h5ad")
    assert isinstance(b, sctt.SpatialData) and sp.issparse(b.X)
    sct.core.normalize_log1p_from_raw(a)
    sctt.core.normalize_log1p_from_raw(b)
    assert (a.X != b.X).nnz == 0
    for pkg, d, kw in ((sct, a, {}), (sctt, b, CPU)):
        s = pkg.spatial
        s.neighborhood_enrichment(d, "true_type", n_permutations=30, **kw)
        s.compute_neighborhood_profile(d, "true_type", k=15, **kw)
        s.identify_niches(d, 6, n_init=2, **kw)
        for ct, col in (("B cell", "dom_b"), ("Epithelial", "dom_x")):
            s.make_spatial_domains(d, f"true_type == '{ct}'", output_column=col,
                                   platform="xenium", **kw)
        s.calculate_domain_distances(d, "dom_b", "dom_x", **kw)
    for key in ("count", "zscore", "null_mean", "null_std"):
        assert np.array_equal(b.uns["true_type_nhood_enrichment"][key],
                              a.uns["true_type_nhood_enrichment"][key])
    assert np.array_equal(b.obsm["neighborhood_profile"], a.obsm["neighborhood_profile"])
    assert adjusted_rand_score(a.obs["niche"], b.obs["niche"]) == 1.0
    for col in ("dom_b", "dom_x"):
        _same_domains(a, b, col)
    assert np.array_equal(tsp.get_distance_matrix(b).to_numpy(),
                          jsp.get_distance_matrix(a).to_numpy())
    ops = [o["function"] for o in sctt.core.get_operations(b)]
    assert ops[-1] == "calculate_domain_distances" and "identify_niches" in ops
