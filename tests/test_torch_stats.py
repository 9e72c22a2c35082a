"""CPU parity of the port's ``stats`` (thresholds, GMMs, Wilcoxon DEG,
classification) against the JAX package.

The same seeded numpy inputs go through ``spatialcore_tpu.stats`` on the
CPU and through ``spatialcore_tpu_torch.stats`` with ``device="cpu"``.
Bitwise: the metagene scores (XLA's CPU ``exp`` / ``log``, tree-ordered
row sums, the even-count median), the GMM restarts' start indices, the
DEG ranks and rank sums below 2²⁴. Within a stated tolerance: the KS
threshold (its index into the sorted scores), the GMM fit, z (2 ulp: the
reference multiplies by XLA's reciprocal square root) and what follows
from them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from scipy.stats import rankdata

import spatialcore_tpu as sct
from spatialcore_tpu.core.rng import key_for as jkey_for
from spatialcore_tpu.stats import classify as jcls
from spatialcore_tpu.stats import deg as jdeg
from spatialcore_tpu.stats import thresholding as jthr
from spatialcore_tpu_torch import SpatialData
from spatialcore_tpu_torch.core import rng as prng
from spatialcore_tpu_torch.stats import classify as pcls
from spatialcore_tpu_torch.stats import deg as pdeg
from spatialcore_tpu_torch.stats import thresholding as pthr

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)


def _features(n=3000, f=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.gamma(1.0, 2.0, (n, f)).astype(np.float32)
    X[rng.random(X.shape) < 0.3] = 0.0
    return X


def _bimodal(seed=0, n_low=3000, n_high=1000):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(0, 1, n_low),
                           rng.normal(4, 1, n_high)]).astype(np.float32)


@pytest.mark.parametrize("width", [1, 4, 5, 40])
@pytest.mark.parametrize("method", list(jthr.MetageneMethod))
def test_metagene_scores_bitwise(method, width):
    X = _features(f=width, seed=width)
    want = np.asarray(jthr.compute_metagene_score(X, method))
    got = pthr.compute_metagene_score(X, method, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_even_count_median_takes_the_midpoint():
    X = np.array([[1, 2, 4, 10], [3, 1, 2, 2]], np.float32)
    got = pthr.compute_metagene_score(X, "median", device="cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.median(X, axis=1)))
    np.testing.assert_array_equal(got, [3.0, 2.0])


def test_xla_exp_log_bitwise():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(0, 3, 50_000),
                        rng.uniform(-89, 89, 50_000)]).astype(np.float32)
    np.testing.assert_array_equal(prng._exp32(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.jit(jnp.exp)(x)))
    y = np.concatenate([np.abs(x) + 1e-3, rng.gamma(1, 2, 50_000) + 0.1,
                        [0.0, np.inf]]).astype(np.float32)
    np.testing.assert_array_equal(prng._log32(torch.from_numpy(y)).numpy(),
                                  np.asarray(jax.jit(jnp.log)(y)))


@pytest.mark.parametrize("bq", [0.3, 0.5])
def test_threshold_ks_matches(bq):
    """The threshold sits at the same index of the sorted scores (index
    tolerance 0 on this sample; with ``bq=0.3`` the P90 floor decides) and
    within 1e-6; deviations within 1e-6, background moments rtol 1e-5."""
    s = _bimodal()
    t_j, dev_j, par_j = jthr.threshold_ks(s, background_quantile=bq)
    t_p, dev_p, par_p = pthr.threshold_ks(s, background_quantile=bq,
                                          device="cpu")
    srt = np.sort(s)
    assert np.searchsorted(srt, np.float32(t_p)) == \
        np.searchsorted(srt, np.float32(t_j))
    assert t_p == pytest.approx(t_j, rel=1e-6)
    np.testing.assert_allclose(dev_p, dev_j, atol=1e-6)
    for k in ("background_mean", "background_std"):
        np.testing.assert_allclose(par_p[k], par_j[k], rtol=1e-5)


def test_threshold_ks_zero_variance_background_falls_back():
    s = np.concatenate([np.zeros(600), np.linspace(1, 5, 400)]).astype(
        np.float32)
    t_j, _, par_j = jthr.threshold_ks(s)
    t_p, _, par_p = pthr.threshold_ks(s, device="cpu")
    assert t_p == pytest.approx(t_j, rel=1e-6)
    assert par_p["background_std"] == pytest.approx(par_j["background_std"],
                                                    rel=1e-6)


@pytest.mark.parametrize("n", [7, 4000, 100_000])
def test_gmm_restart_indices_bitwise(n):
    for r in range(10):
        want = np.asarray(jax.random.choice(jkey_for(42, "gmm", r), n, (3,),
                                            replace=False))
        got = prng._choice(prng.key_for(42, "gmm", r), n, 3, "cpu").numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [2, 3])
def test_gmm_fit_within_tolerance(k):
    """Means, stds, weights within 1e-4 (absolute, on unit-scale data);
    the mean log-likelihood within 1e-5."""
    s = _bimodal(seed=k)
    want = jthr.fit_gmm1d(jnp.asarray(s), n_components=k)
    got = pthr.fit_gmm1d(s, n_components=k, device="cpu")
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    assert float(got.log_lik) == pytest.approx(float(want.log_lik), abs=1e-5)


def test_batched_restarts_freeze_at_their_own_iteration():
    """The batch of restarts gives each restart the state it reaches
    alone: a restart stops at its own |Δll| ≤ tol, not the batch's."""
    x = torch.from_numpy(_bimodal(seed=5))
    R, K = 6, 3
    means0 = x[torch.stack([prng._choice(prng.key_for(1, "gmm", r), x.shape[0],
                                         K, "cpu") for r in range(R)])]
    stds0 = x.std(unbiased=False).expand(R, K).clone()
    w0 = torch.full((R, K), 1.0 / K)
    batch = pthr._em_fit(x, means0, stds0, w0, 200, 1e-4, 1e-4)
    for r in range(R):
        one = pthr._em_fit(x, means0[r:r + 1], stds0[r:r + 1], w0[r:r + 1],
                           200, 1e-4, 1e-4)
        for a, b in zip(batch, one):
            np.testing.assert_array_equal(a[r].numpy(), b[0].numpy())


@pytest.mark.parametrize("k", [2, 3])
def test_threshold_gmm_matches(k):
    s = _bimodal(seed=10 + k)
    t_j, lab_j, p_j, par_j = jthr.threshold_gmm(s, n_components=k)
    t_p, lab_p, p_p, par_p = pthr.threshold_gmm(s, n_components=k,
                                                device="cpu")
    assert t_p == pytest.approx(t_j, abs=1e-4)
    np.testing.assert_array_equal(lab_p, lab_j)
    np.testing.assert_allclose(p_p, np.asarray(p_j), atol=1e-5)
    assert par_p["sorted_component_indices"] == par_j["sorted_component_indices"]
    assert par_p["high_component_idx"] == par_j["high_component_idx"]
    np.testing.assert_allclose(
        np.asarray(pthr.gmm_posterior(s, par_p["gmm_model"])),
        np.asarray(jthr.gmm_posterior(s, par_j["gmm_model"])), atol=1e-5)


# ---------------------------------------------------------------------------
# Wilcoxon DEG
# ---------------------------------------------------------------------------


def _deg_data(n=3000, g=30, seed=0, n_groups=5):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, n_groups, n)
    counts = rng.poisson(1.0, (n, g)).astype(np.float32)
    counts[lab == 0, :4] += rng.poisson(3.0, ((lab == 0).sum(), 4))
    X = np.log1p(counts).astype(np.float32)
    X[:, -1] = rng.normal(0, 1, n)                 # a gene without ties
    return X, lab


def test_ranks_and_rank_sums_bitwise():
    """Average ranks over tie runs equal scipy's (exact), and the group
    rank sums equal the reference's float32 product below 2²⁴."""
    X, lab = _deg_data()
    twice, _ = pdeg._tie_ranks(torch.from_numpy(X).T)
    want = np.stack([rankdata(X[:, j]) for j in range(X.shape[1])])
    np.testing.assert_array_equal(twice.numpy() / 2, want)
    masks = np.eye(5, dtype=np.float32)[lab]
    R1, _ = pdeg._rank_sums(torch.from_numpy(X), torch.from_numpy(masks))
    ref = np.asarray(jnp.asarray(want.astype(np.float32)) @ jnp.asarray(masks))
    np.testing.assert_array_equal(R1.numpy(), ref)


def test_rank_sums_stay_exact_above_2_24():
    """At 12,000 cells a group's rank sum passes 2²⁴: the port's is the
    exact sum rounded once to float32."""
    rng = np.random.default_rng(3)
    n = 12_000
    X = np.round(rng.normal(0, 1, (n, 3)), 1).astype(np.float32)
    masks = (rng.random((n, 2)) < 0.5).astype(np.float32)
    R1, tie = pdeg._rank_sums(torch.from_numpy(X), torch.from_numpy(masks))
    exact = np.stack([rankdata(X[:, j]) for j in range(3)]) @ \
        masks.astype(np.float64)
    assert exact.max() > 2 ** 24
    np.testing.assert_array_equal(R1.numpy(), exact.astype(np.float32))
    c = [np.unique(X[:, j], return_counts=True)[1].astype(np.float64)
         for j in range(3)]
    want_tie = [float(np.sum(ci ** 3 - ci)) / (n * (n - 1.0)) for ci in c]
    np.testing.assert_array_equal(tie.numpy(), np.float32(want_tie))


@pytest.mark.parametrize("tie_correct", [False, True])
def test_rank_stats_z_within_2_ulp(tie_correct):
    X, lab = _deg_data(seed=1)
    masks = np.eye(5, dtype=np.float32)[lab]
    want = np.asarray(jdeg._rank_stats(jnp.asarray(X), jnp.asarray(masks),
                                       tie_correct=tie_correct))
    got = pdeg._rank_stats(torch.from_numpy(X), torch.from_numpy(masks),
                           tie_correct=tie_correct).numpy()
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got - want) <= 2 * ulp)


def _deg_pair(X, lab, **kw):
    obs = pd.DataFrame({"ct": pd.Categorical(np.array(list("ABCDE"))[lab])})
    var = pd.DataFrame(index=[f"g{i}" for i in range(X.shape[1])])
    a = sct.SpatialData(X=X.copy(), obs=obs.copy(), var=var.copy())
    b = SpatialData(X=X.copy(), obs=obs.copy(), var=var.copy())
    jdeg.rank_genes_groups(a, "ct", **kw)
    pdeg.rank_genes_groups(b, "ct", device="cpu", **kw)
    return a.uns["rank_genes_groups"], b.uns["rank_genes_groups"]


@pytest.mark.parametrize("kw", [{}, {"n_genes": 5, "groups": ["A", "C"]},
                                {"tie_correct": True}])
def test_rank_genes_groups_matches(kw):
    """Names equal; z within 2 ulp, p and p_adj within rtol 1e-5 (atol
    1e-12); log fold changes within 1e-4 (the reference's group means are
    float32 sums, the port's float64; a fold change near 0 magnifies
    their last bits)."""
    X, lab = _deg_data(seed=2)
    ra, rb = _deg_pair(X, lab, **kw)
    assert ra["params"] == rb["params"]
    assert list(ra["names"]) == list(rb["names"])
    for grp in ra["names"]:
        assert ra["names"][grp] == rb["names"][grp]
        z = np.asarray(ra["scores"][grp], np.float32)
        assert np.all(np.abs(np.asarray(rb["scores"][grp], np.float32) - z)
                      <= 2 * np.spacing(np.abs(z)))
        for k in ("pvals", "pvals_adj"):
            np.testing.assert_allclose(rb[k][grp], ra[k][grp], rtol=1e-5,
                                       atol=1e-12)
        np.testing.assert_allclose(rb["logfoldchanges"][grp],
                                   ra["logfoldchanges"][grp], atol=1e-4)


def test_rank_genes_groups_excludes_null_labels_and_validates():
    X, lab = _deg_data(n=600, seed=4)
    labels = np.array(list("ABCDE"), object)[lab]
    labels[:50] = None
    b = SpatialData(X=X, obs=pd.DataFrame({"ct": labels}),
                    var=pd.DataFrame(index=[f"g{i}" for i in range(X.shape[1])]))
    a = sct.SpatialData(X=X.copy(), obs=b.obs.copy(), var=b.var.copy())
    jdeg.rank_genes_groups(a, "ct")
    pdeg.rank_genes_groups(b, "ct", device="cpu")
    for grp in a.uns["rank_genes_groups"]["names"]:
        assert (a.uns["rank_genes_groups"]["names"][grp]
                == b.uns["rank_genes_groups"]["names"][grp])
    with pytest.raises(ValueError, match="wilcoxon"):
        pdeg.rank_genes_groups(b, "ct", method="t-test", device="cpu")
    with pytest.raises(ValueError, match="not present"):
        pdeg.rank_genes_groups(b, "ct", groups=["Z"], device="cpu")


# ---------------------------------------------------------------------------
# classify_by_threshold
# ---------------------------------------------------------------------------


def _classify_pair(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    high = rng.random(n) < 0.3
    genes = [f"M{i}" for i in range(3)] + ["OTHER"]
    X = rng.gamma(1.0, 0.3, (n, 4)).astype(np.float32)
    X[high, :3] += rng.gamma(4.0, 1.0, (high.sum(), 3)).astype(np.float32)
    obs = pd.DataFrame({"score_col": X[:, 0].copy()})
    obs.loc[:4, "score_col"] = np.nan
    var = pd.DataFrame(index=genes)
    a = sct.SpatialData(X=X.copy(), obs=obs.copy(), var=var.copy())
    b = SpatialData(X=X.copy(), obs=obs.copy(), var=var.copy())
    return a, b


@pytest.mark.parametrize("method,k,features", [
    ("ks", 2, ["M0", "M1", "M2"]),
    ("gmm", 2, ["M0", "M1", "M2"]),
    ("gmm", 3, ["M0", "M1", "M2"]),
    ("gmm", 2, ["score_col"]),
])
def test_classify_by_threshold_matches(method, k, features):
    """Scores bitwise (metagene or the raw feature); clusters equal. At
    4,000 valid cells and ``max_cells=2000`` the GMM fits the reference's
    subsample. Its ten restarts reach the same optimum, their mean
    log-likelihoods within 1e-6 of each other, so which one wins is decided
    by rounding and can differ between the packages (it does for the
    metagene here): the GMM's probabilities are held within 0.01 and its
    threshold within 1e-3; the KS run's within 1e-6 and 1e-4."""
    a, b = _classify_pair()
    kw = dict(threshold_method=method, n_components=k, max_cells=2000,
              plot=False)
    jcls.classify_by_threshold(a, features, **kw)
    pcls.classify_by_threshold(b, features, device="cpu", **kw)
    for c in ("threshold_score", "threshold_cluster"):
        np.testing.assert_array_equal(b.obs[c].to_numpy(), a.obs[c].to_numpy())
    gmm = method == "gmm"
    np.testing.assert_allclose(b.obs["threshold_probability"].to_numpy(),
                               a.obs["threshold_probability"].to_numpy(),
                               atol=1e-2 if gmm else 1e-6)
    pa, pb = a.uns["threshold_params"], b.uns["threshold_params"]
    assert pb["threshold"] == pytest.approx(pa["threshold"],
                                            abs=1e-3 if gmm else 1e-4)
    assert set(pa) == set(pb)
    for key in ("n_high", "n_low", "n_invalid", "feature_columns"):
        assert pa[key] == pb[key]


def test_classify_feature_resolution_and_errors(tmp_path):
    a, b = _classify_pair(n=500, seed=1)
    emb = np.random.default_rng(2).normal(size=(500, 3)).astype(np.float32)
    b.obsm["X_emb"] = emb
    b.uns["X_emb_params"] = {"genes": ["GA", "GB", "GC"]}
    feats = pcls._extract_features(b, ["M0", "score_col", "X_emb", "X_emb:GB",
                                       "X_emb:2"])
    np.testing.assert_array_equal(feats[:, 2], emb[:, 0])
    np.testing.assert_array_equal(feats[:, 3], emb[:, 1])
    np.testing.assert_array_equal(feats[:, 4], emb[:, 2])
    with pytest.raises(ValueError, match="not found"):
        pcls._extract_features(b, ["NOPE"])
    pcls.classify_by_threshold(b, ["M0"], plot=True, output_dir=tmp_path,
                               device="cpu")
    assert (tmp_path / "threshold_gpairs.png").stat().st_size > 0
