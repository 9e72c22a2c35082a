"""Port graphs against the JAX package: same neighbour sets, distances within
float32 rounding (rtol 1e-6), identical Cliff-Ord moments."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialcore_tpu.ops import graph as jg
from spatialcore_tpu_torch.ops import graph as tg

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)


def _coords(n, seed, clustered=False):
    rng = np.random.default_rng(seed)
    if not clustered:
        return rng.uniform(0, 100, (n, 2)).astype(np.float32)
    # dense clumps in a sparse background: widening rounds are needed
    centers = rng.uniform(0, 1000, (5, 2))
    pts = centers[rng.integers(0, 5, n - 50)] + rng.normal(0, 2, (n - 50, 2))
    return np.concatenate([pts, rng.uniform(0, 1000, (50, 2))]).astype(np.float32)


def _assert_same_knn(idx_t, dist_t, idx_j, dist_j, atol=0.0):
    idx_j = np.asarray(idx_j)
    dist_j = np.asarray(dist_j)
    np.testing.assert_array_equal(np.sort(idx_t.numpy(), axis=1),
                                  np.sort(idx_j.astype(np.int64), axis=1))
    np.testing.assert_allclose(dist_t.numpy(), dist_j, rtol=1e-6, atol=atol)
    # the port's order is (distance, id)
    d = dist_t.numpy()
    i = idx_t.numpy()
    assert ((d[:, 1:] > d[:, :-1]) | ((d[:, 1:] == d[:, :-1])
                                     & (i[:, 1:] > i[:, :-1]))).all()


@pytest.mark.parametrize("n,k,include_self", [(500, 6, False), (1500, 10, True)])
def test_knn_exact_matches_reference(n, k, include_self):
    c = _coords(n, n)
    ij, dj = jg.knn_exact(jnp.asarray(c), k, include_self=include_self)
    it, dt = tg.knn_exact(torch.as_tensor(c), k, include_self=include_self)
    # both centre the coordinates by a float32 mean whose summation order
    # differs (XLA's vs torch's), which moves every centred coordinate by up
    # to one ulp of the coordinate scale: allow 2 ulp absolute on distances
    _assert_same_knn(it, dt, ij, dj,
                     atol=2 * float(np.spacing(np.abs(c).max())))


@pytest.mark.parametrize("n,k,clustered,max_rounds", [
    (3000, 6, False, 6), (2000, 8, True, 6), (2000, 6, True, 1)])
def test_knn_grid_matches_reference(n, k, clustered, max_rounds):
    """Uniform cells resolve in round 0; clumped cells need widening rounds
    (max_rounds=1 sends them all to the exact host fallback)."""
    c = _coords(n, 3, clustered)
    ij, dj = jg.knn_grid(c, k, max_rounds=max_rounds)
    it, dt = tg.knn_grid(torch.as_tensor(c), k, max_rounds=max_rounds)
    _assert_same_knn(it, dt, ij, dj)
    # and both equal the exact scan
    ie, _ = tg.knn_exact(torch.as_tensor(c), k)
    np.testing.assert_array_equal(np.sort(it.numpy(), 1), np.sort(ie.numpy(), 1))


def test_build_graph_and_moments_match_reference():
    c = _coords(2500, 1)
    gj = jg.build_graph(c, n_neighbors=6, method="grid")
    gt = tg.build_graph(c, n_neighbors=6, method="grid", device="cpu")
    np.testing.assert_array_equal(np.sort(gt.neighbor_idx.numpy(), 1),
                                  np.sort(np.asarray(gj.neighbor_idx), 1))
    np.testing.assert_array_equal(gt.neighbor_w.numpy(), np.asarray(gj.neighbor_w))
    assert jg.graph_moments(gj) == tg.graph_moments(gt)
    # a graph carried over from the reference's arrays
    gc = tg.graph_from_numpy(gj, device="cpu")
    assert tg.graph_moments(gc) == jg.graph_moments(gj)
    assert gc.neighbor_idx.dtype == torch.int64


def test_spatial_lag_matches_reference():
    c = _coords(400, 2)
    gj = jg.build_graph(c, n_neighbors=5)
    gt = tg.graph_from_numpy(gj, device="cpu")
    Z = np.random.default_rng(0).normal(size=(400, 7)).astype(np.float32)
    np.testing.assert_allclose(tg.spatial_lag(gt, torch.as_tensor(Z)).numpy(),
                               np.asarray(jg.spatial_lag(gj, jnp.asarray(Z))),
                               rtol=1e-6, atol=1e-6)


def test_unported_graph_modes_raise():
    """Radius graphs are still refused; method="pallas" (K9) is ported and
    gives the exact scan's neighbours (tests/test_torch_knn.py), and an
    unknown method is a ValueError."""
    c = _coords(100, 0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        tg.build_graph(c, radius=5.0, k_max=10, device="cpu")
    with pytest.raises(ValueError, match="unknown kNN method"):
        tg.build_graph(c, method="pallas_v2", device="cpu")
    gp = tg.build_graph(c, method="pallas", device="cpu")
    ge = tg.build_graph(c, method="exact", device="cpu")
    np.testing.assert_array_equal(gp.neighbor_idx.numpy(), ge.neighbor_idx.numpy())
