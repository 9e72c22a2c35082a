"""CPU parity of the port's ``nmf`` and ``diffusion`` against the JAX
package.

NMF: the init's uniform draws bitwise (``split(key_for(seed, "nmf"))``),
its scale within one float32 ulp (the reference sums X in XLA's order, the
port exactly), the fit's loss within rtol 1e-4 and its stopping step
equal. Diffusion: ``core/rng.normal`` bitwise ``jax.random.normal``, smoothing
within 1e-6, the diffusion map's eigenvalues within 1e-5 and its
embedding within 1e-4 up to the sign of each eigenvector.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spatialcore_tpu as sct
import spatialcore_tpu.core.rng as jrng
from spatialcore_tpu import diffusion as jdiff
from spatialcore_tpu import nmf as jnmf
from spatialcore_tpu_torch import SpatialData
from spatialcore_tpu_torch import diffusion as pdiff
from spatialcore_tpu_torch import nmf as pnmf
from spatialcore_tpu_torch.core import rng as prng

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)


def _low_rank(n=300, g=50, k=4, seed=0):
    rng = np.random.default_rng(seed)
    W = rng.gamma(2.0, 1.0, (n, k)).astype(np.float32)
    H = rng.gamma(2.0, 1.0, (k, g)).astype(np.float32)
    return W @ H + rng.gamma(1.0, 0.05, (n, g)).astype(np.float32)


@pytest.mark.parametrize("k,seed", [(4, 0), (10, 3)])
def test_nmf_init_draws_bitwise(k, seed):
    X = _low_rank()
    W0, H0 = pnmf.nmf_init(torch.from_numpy(X), k, seed)
    kw, kh = jax.random.split(jrng.key_for(seed, "nmf"))
    scale = float(jax.jit(lambda X: jnp.sqrt(jnp.mean(X) / k + 1e-9))(X))
    uw = np.asarray(jax.random.uniform(kw, (X.shape[0], k), jnp.float32))
    uh = np.asarray(jax.random.uniform(kh, (k, X.shape[1]), jnp.float32))
    s_port = pnmf.init_scale(torch.from_numpy(X), k)
    assert abs(np.float32(s_port) - np.float32(scale)) <= \
        np.spacing(np.float32(scale))
    np.testing.assert_array_equal(W0.numpy(), uw * np.float32(s_port))
    np.testing.assert_array_equal(H0.numpy(), uh * np.float32(s_port))


def test_nmf_init_bitwise_on_counts():
    """On integer counts the float32 sum is exact in both packages, so the
    init is the reference's bit for bit."""
    X = np.random.default_rng(1).poisson(3.0, (200, 30)).astype(np.float32)
    W0, H0 = pnmf.nmf_init(torch.from_numpy(X), 5, 2)
    kw, kh = jax.random.split(jrng.key_for(2, "nmf"))

    @jax.jit
    def init(X):
        scale = jnp.sqrt(jnp.mean(X) / 5 + 1e-9)
        return (jax.random.uniform(kw, (200, 5), jnp.float32) * scale,
                jax.random.uniform(kh, (5, 30), jnp.float32) * scale)

    w, h = init(X)
    np.testing.assert_array_equal(W0.numpy(), np.asarray(w))
    np.testing.assert_array_equal(H0.numpy(), np.asarray(h))


@pytest.mark.parametrize("k,max_iter,tol", [(4, 300, 1e-4), (6, 40, 1e-4),
                                            (4, 300, 1e-2)])
def test_nmf_fit_matches(k, max_iter, tol):
    """Loss within rtol 1e-4, the same number of steps, W and H within
    2e-3 of their scale (float32 products in another order)."""
    X = _low_rank()
    want = jnmf.nmf_fit(X, k, seed=0, max_iter=max_iter, tol=tol)
    got = pnmf.nmf_fit(X, k, seed=0, max_iter=max_iter, tol=tol, device="cpu")
    assert float(got.loss) == pytest.approx(float(want.loss), rel=1e-4)
    assert int(got.n_iter) == int(want.n_iter)
    for a, b in ((got.W, want.W), (got.H, want.H)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=2e-3 * np.abs(b).max())


def test_run_nmf_api():
    X = np.random.default_rng(4).poisson(2.0, (200, 30)).astype(np.float32)
    a = sct.SpatialData(X=X.copy())
    b = SpatialData(X=X.copy())
    jnmf.run_nmf(a, n_components=5)
    pnmf.run_nmf(b, n_components=5, device="cpu")
    assert b.obsm["X_nmf"].shape == (200, 5)
    assert b.varm["nmf_components"].shape == (30, 5)
    pa, pb = a.uns["nmf_params"], b.uns["nmf_params"]
    assert pb["n_iter"] == pa["n_iter"]
    assert pb["final_relative_loss"] == pytest.approx(
        pa["final_relative_loss"], rel=1e-4)
    assert pb["top_genes"]["program_1"][:3] == pa["top_genes"]["program_1"][:3]
    bad = SpatialData(X=X - 5.0)
    with pytest.raises(ValueError, match="non-negative"):
        pnmf.run_nmf(bad, n_components=3, device="cpu")
    with pytest.raises(ValueError, match="n_components"):
        pnmf.run_nmf(b, n_components=0, device="cpu")


@pytest.mark.parametrize("shape,seed", [((200_000, 5), 0), ((1000, 7), 5),
                                        ((333,), 9)])
def test_normal_bitwise(shape, seed):
    want = np.asarray(jax.random.normal(jrng.key_for(seed, "diffmap"), shape,
                                        jnp.float32))
    got = prng.normal(prng.key_for(seed, "diffmap"), shape).numpy()
    np.testing.assert_array_equal(got, want)


def _spatial_pair(n=800, g=3, seed=1):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    X = rng.normal(0, 1, (n, g)).astype(np.float32)
    a = sct.SpatialData(X=X.copy())
    b = SpatialData(X=X.copy())
    a.obsm["spatial"] = coords
    b.obsm["spatial"] = coords.copy()
    return a, b


@pytest.mark.parametrize("genes", [None, ["g1"]])
def test_smooth_expression_matches(genes):
    a, b = _spatial_pair()
    names = ["g0", "g1", "g2"]
    a.var_names = names
    b.var_names = names
    jdiff.smooth_expression(a, n_steps=4, alpha=0.6, n_neighbors=10,
                            genes=genes)
    pdiff.smooth_expression(b, n_steps=4, alpha=0.6, n_neighbors=10,
                            genes=genes, device="cpu")
    where = "obsm" if genes else "layers"
    got = getattr(b, where)["diffused"]
    assert isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, getattr(a, where)["diffused"], atol=1e-6)
    with pytest.raises(ValueError, match="alpha"):
        pdiff.smooth_expression(b, alpha=0.0, device="cpu")


def test_smooth_expression_uses_the_stored_graph():
    a, b = _spatial_pair(seed=2)
    from spatialcore_tpu_torch.spatial import build_spatial_weights

    build_spatial_weights(b, n_neighbors=4, device="cpu")
    pdiff.smooth_expression(b, n_steps=2, n_neighbors=10, device="cpu")
    jdiff.smooth_expression(a, n_steps=2, n_neighbors=4)
    np.testing.assert_allclose(b.layers["diffused"], a.layers["diffused"],
                               atol=1e-6)


@pytest.mark.parametrize("m", [3, 5])
def test_diffusion_map_matches_up_to_sign(m):
    rng = np.random.default_rng(2)
    coords = np.vstack([rng.normal([0, 0], 3.0, (200, 2)),
                        rng.normal([100, 0], 3.0, (200, 2))]).astype(np.float32)
    a = sct.SpatialData(X=np.zeros((400, 3), np.float32))
    b = SpatialData(X=np.zeros((400, 3), np.float32))
    a.obsm["spatial"] = coords
    b.obsm["spatial"] = coords.copy()
    jdiff.diffusion_map(a, n_components=m, n_neighbors=10, seed=0)
    pdiff.diffusion_map(b, n_components=m, n_neighbors=10, seed=0,
                        device="cpu")
    np.testing.assert_allclose(b.uns["X_diffmap_evals"],
                               a.uns["X_diffmap_evals"], atol=1e-5)
    ea, eb = a.obsm["X_diffmap"], b.obsm["X_diffmap"]
    sign = np.sign((ea * eb).sum(axis=0))
    np.testing.assert_allclose(eb * sign, ea, atol=1e-4)
