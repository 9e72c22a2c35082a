"""K-Means and the raster geometry in the port against the JAX package, on
the CPU.

Tolerances, and why:
- the blocked cumulative sum, the tree sum and the squared distances:
  bitwise against ``jnp.cumsum`` / ``jnp.sum`` / the reference's
  ``_pairwise_sq`` under ``jit`` (the port adds in XLA's CPU order and
  forms its fused multiply-adds exactly, ``core.rng._fma32``);
- ``choice(p=)``: bitwise against ``jax.random.choice``;
- k-means++ seeds: bitwise (``kmeans(max_iter=0)`` returns them), full and
  mini-batch;
- ``kmeans`` / ``minibatch_kmeans`` labels: equal up to renaming (ARI 1.0)
  on separated blobs; centres and inertia rtol 1e-5 (Lloyd's centre sums
  are a matrix product in another order, ROADMAP Queue 3);
- ``dilate``, ``erode``, ``connected_components``, ``buffer_union_shrink``:
  bitwise (0/1 sums thresholded at 0.5; integer labels), also where the
  component loop stops at its cap with labels still changing (a
  serpentine), which the port flags;
- boundaries and adjacency: equal (the same host code).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialcore_tpu.core.rng import key_for as jkey_for
from spatialcore_tpu.ops import geometry as jg
from spatialcore_tpu.ops import kmeans as jk
from spatialcore_tpu_torch.core import rng
from spatialcore_tpu_torch.ops import geometry as tg
from spatialcore_tpu_torch.ops import kmeans as tk
from spatialcore_tpu_torch.spatial.neighborhoods import adjusted_rand_score

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)

LENGTHS = [1, 5, 16, 17, 31, 32, 33, 256, 1001, 1024, 4097, 100_001]


def _values(n, seed=0):
    return (np.random.default_rng(seed).random(n, dtype=np.float32) ** 3)


@pytest.mark.parametrize("n", LENGTHS)
def test_blocked_cumsum_bitwise(n):
    x = _values(n)
    want = np.asarray(jax.jit(jnp.cumsum)(x))
    got = tk._blocked_cumsum(torch.as_tensor(x)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n", LENGTHS)
def test_tree_sum_bitwise(n):
    x = _values(n, 1)
    want = np.asarray(jax.jit(jnp.sum)(x))
    assert tk._tree_sum(torch.as_tensor(x)).numpy() == want


@pytest.mark.parametrize("D", [1, 2, 13, 32, 33, 40, 70])
def test_pairwise_sq_bitwise(D):
    r = np.random.default_rng(D)
    X = r.random((500, D), dtype=np.float32)
    C = r.random((7, D), dtype=np.float32)
    want = np.asarray(jax.jit(jk._pairwise_sq)(X, C))
    got = tk._pairwise_sq(torch.as_tensor(X), torch.as_tensor(C)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("n,seed", [(3, 0), (17, 1), (1000, 2), (4097, 3)])
def test_choice_p_bitwise(n, seed):
    p = _values(n, seed)
    p = (p / p.sum()).astype(np.float32)
    for draw in range(8):
        kj = jax.random.fold_in(jkey_for(seed, "c"), draw)
        want = int(jax.jit(lambda k, p: jax.random.choice(k, n, p=p))(kj, p))
        got = tk._choice_p(rng.fold_in(rng.key_for(seed, "c"), draw),
                           torch.as_tensor(p))
        assert got == want


def _blobs(n, D, k, seed, spread=0.02):
    r = np.random.default_rng(seed)
    centres = r.random((k, D)).astype(np.float32) * 4
    lab = r.integers(0, k, n)
    X = (centres[lab] + r.normal(0, spread, (n, D))).astype(np.float32)
    return X, lab


@pytest.mark.parametrize("n,D,k,seed", [(700, 2, 3, 5), (1500, 13, 6, 11),
                                        (1200, 40, 4, 0), (300, 5, 8, 2)])
def test_plusplus_seeds_bitwise(n, D, k, seed):
    r = np.random.default_rng(seed)
    X = r.random((n, D), dtype=np.float32)
    X /= X.sum(1, keepdims=True)                   # profile-like rows
    want = np.asarray(jk.kmeans(jnp.asarray(X), k, seed=seed, n_init=1,
                                max_iter=0).centroids)
    got = tk.kmeans(X, k, seed=seed, n_init=1, max_iter=0, device="cpu")
    assert np.array_equal(got.centroids.numpy(), want)
    want = np.asarray(jk.minibatch_kmeans(jnp.asarray(X), k, seed=seed,
                                          batch_size=64, n_steps=0,
                                          n_init=1).centroids)
    got = tk.minibatch_kmeans(X, k, seed=seed, batch_size=64, n_steps=0,
                              n_init=1, device="cpu")
    assert np.array_equal(got.centroids.numpy(), want)


@pytest.mark.parametrize("n,D,k,seed", [(1200, 3, 4, 1), (2000, 13, 6, 4)])
def test_kmeans_labels_up_to_renaming(n, D, k, seed):
    X, _ = _blobs(n, D, k, seed)
    want = jk.kmeans(jnp.asarray(X), k, seed=seed, n_init=3)
    got = tk.kmeans(X, k, seed=seed, n_init=3, device="cpu")
    assert adjusted_rand_score(np.asarray(want.labels), got.labels.numpy()) == 1.0
    assert got.labels.dtype == torch.int32
    np.testing.assert_allclose(float(got.inertia), float(want.inertia), rtol=1e-5)
    order = np.argsort(np.asarray(want.centroids)[:, 0])
    np.testing.assert_allclose(np.sort(got.centroids.numpy()[:, 0]),
                               np.asarray(want.centroids)[order, 0], rtol=1e-5)
    want = jk.minibatch_kmeans(jnp.asarray(X), k, seed=seed, batch_size=128,
                               n_steps=40, n_init=2)
    got = tk.minibatch_kmeans(X, k, seed=seed, batch_size=128, n_steps=40,
                              n_init=2, device="cpu")
    assert adjusted_rand_score(np.asarray(want.labels), got.labels.numpy()) == 1.0
    np.testing.assert_allclose(float(got.inertia), float(want.inertia), rtol=1e-5)


def _raster(H, W, n_target, n_cells, seed):
    r = np.random.default_rng(seed)
    clump = r.normal([H * 0.3, W * 0.6], H * 0.05, (n_target // 2, 2))
    scatter = r.uniform(0, [H, W], (n_target - n_target // 2, 2))
    pix = np.clip(np.vstack([clump, scatter]), 0, [H - 1, W - 1]).astype(np.int32)
    cells = np.stack([r.integers(0, H, n_cells), r.integers(0, W, n_cells)],
                     1).astype(np.int32)
    return pix, cells


@pytest.mark.parametrize("H,W,rb,rs,seed", [(128, 256, 3, 1, 0),
                                            (256, 128, 6, 4, 1),
                                            (128, 128, 1, 0, 2),
                                            (256, 256, 9, 6, 3)])
def test_buffer_union_shrink_bitwise(H, W, rb, rs, seed):
    pix, cells = _raster(H, W, 400, 1500, seed)
    want = jg.buffer_union_shrink(jnp.asarray(pix), jnp.asarray(cells), (H, W),
                                  rb, rs)
    got = tg.buffer_union_shrink(pix, cells, (H, W), rb, rs, device="cpu")
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    grid = np.zeros((H, W), bool)
    grid[pix[:, 0], pix[:, 1]] = True
    dil_w = np.asarray(jg.dilate(jnp.asarray(grid), rb))
    dil_g = tg.dilate(torch.as_tensor(grid), rb).numpy()
    assert np.array_equal(dil_g, dil_w)
    assert np.array_equal(tg.erode(torch.as_tensor(np.array(dil_w)), rs).numpy(),
                          np.asarray(jg.erode(jnp.asarray(dil_w), rs)))
    labels = got.labels.numpy()
    assert tg.label_adjacency(labels, 2) == jg.label_adjacency(labels, 2)
    bw = jg.extract_boundaries(labels, (0.0, 0.0), 2.5)
    bg = tg.extract_boundaries(labels, (0.0, 0.0), 2.5)
    assert bw.keys() == bg.keys() and all(np.array_equal(bw[k], bg[k]) for k in bw)
    pw = jg.extract_boundary_polygons(labels, (1.0, 2.0), 2.5)
    pg = tg.extract_boundary_polygons(labels, (1.0, 2.0), 2.5)
    assert pw.keys() == pg.keys()
    assert all(len(pw[k]) == len(pg[k]) and all(np.array_equal(a, b) for a, b
                                                in zip(pw[k], pg[k])) for k in pw)


@pytest.mark.parametrize("max_iter", [1, 3, 256])
def test_connected_components_bitwise(max_iter):
    r = np.random.default_rng(max_iter)
    mask = r.random((128, 256)) > 0.55            # many small components
    mask[40:90, 10:200] = True                    # and a large one
    want = np.asarray(jg.connected_components(jnp.asarray(mask), max_iter=max_iter))
    got, iters, capped = tg._connected_components(torch.as_tensor(mask),
                                                  max_iter)
    assert np.array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and iters <= max_iter
    assert (not capped or iters == max_iter) and capped != (max_iter == 256)
    assert np.array_equal(tg.connected_components(torch.as_tensor(mask),
                                                  max_iter).numpy(), want)


def _serpentine(H, W, gap=2):
    """A one-pixel path winding down an [H, W] raster: the component loop
    needs about one iteration per row of the path to join it."""
    m = np.zeros((H, W), bool)
    rows = list(range(0, H, gap))
    for i, r in enumerate(rows):
        m[r, :] = True
        if i + 1 < len(rows):
            c = W - 1 if i % 2 == 0 else 0
            m[r:rows[i + 1] + 1, c] = True
    return m


@pytest.mark.parametrize("max_iter", [3, 256, 400])
def test_connected_components_cap_flag(max_iter):
    """A serpentine on a 320 × 320 raster needs about 320 iterations: at
    the reference's cap of 256 (and below) the loop stops with labels still
    changing and the path split in several components; the labels stay
    bitwise the capped reference's, and the flag says so."""
    mask = _serpentine(320, 320)
    want = np.asarray(jg.connected_components(jnp.asarray(mask),
                                              max_iter=max_iter))
    got, iters, capped = tg._connected_components(torch.as_tensor(mask),
                                                  max_iter)
    assert np.array_equal(got.numpy(), want)
    n_comp = len(np.unique(want[mask]))
    assert capped == (max_iter <= 256) == (n_comp > 1)
    assert iters == max_iter if capped else iters < max_iter
    assert tg.CC_MAX_ITER == 256


def test_disk_kernel_equal():
    for r in (0, 1, 4, 9):
        assert np.array_equal(tg.disk_kernel(r), jg.disk_kernel(r))
    m = torch.zeros((8, 8), dtype=torch.bool)
    assert tg.dilate(m, 0) is m and tg.erode(m, 0) is m
