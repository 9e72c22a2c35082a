"""The exact all-pairs kNN (the port of Pallas kernel K9) against the JAX
package's ``pallas_knn`` in interpret mode, on the CPU.

Tolerances, and why:
- neighbour indices: equal, order included. Both centre the coordinates
  by the same numpy float32 mean, compute d² = (qx−cx)² + (qy−cy)² with
  each operation rounded once and rank by (d², id), so ties — exact
  duplicates, and the equal distances of points on an integer lattice —
  break by the lower id in both.
- distances: within 1 ulp (``sqrt`` of the same float32 d² on two
  libraries; equal in practice).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialcore_tpu.ops import graph as jg
from spatialcore_tpu.ops.pallas_knn import pallas_knn as j_pallas_knn
from spatialcore_tpu_torch.kernels import knn as kern_knn
from spatialcore_tpu_torch.ops import graph as tg
from spatialcore_tpu_torch.ops.knn_kernel import pallas_knn

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)


def _coords(n, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        c = rng.uniform(0, 1000, (n, 2))
    elif kind == "duplicates":      # a fifth of the points repeat others
        c = rng.uniform(0, 1000, (n, 2))
        rep = rng.choice(n, n // 5, replace=False)
        c[rep] = c[rng.choice(n, n // 5)]
    else:                           # an integer lattice: many equal distances
        c = rng.integers(0, 60, (n, 2)).astype(np.float64) + 3000.0
    return c.astype(np.float32)


@pytest.mark.parametrize("kind,n,k,include_self", [
    ("uniform", 2000, 6, False), ("duplicates", 2000, 6, True),
    ("lattice", 1500, 6, False), ("lattice", 2500, 50, True),
    ("duplicates", 1800, 50, False)])
def test_pallas_knn_matches_reference(kind, n, k, include_self):
    c = _coords(n, n + k, kind)
    ij, dj = j_pallas_knn(c, k, include_self=include_self)
    it, dt = pallas_knn(c, k, include_self=include_self, device="cpu")
    assert it.dtype == torch.int64 and dt.dtype == torch.float32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij).astype(np.int64))
    np.testing.assert_array_max_ulp(dt.numpy(), np.asarray(dj), maxulp=1)
    if not include_self:
        assert not (it.numpy() == np.arange(n)[:, None]).any()


def test_build_graph_pallas_matches_reference():
    c = _coords(2200, 5, "duplicates")
    gj = jg.build_graph(c, n_neighbors=6, method="pallas")
    gt = tg.build_graph(c, n_neighbors=6, method="pallas", device="cpu")
    np.testing.assert_array_equal(gt.neighbor_idx.numpy(),
                                  np.asarray(gj.neighbor_idx).astype(np.int64))
    np.testing.assert_array_equal(gt.neighbor_w.numpy(), np.asarray(gj.neighbor_w))
    np.testing.assert_array_equal(gt.valid.numpy(), np.asarray(gj.valid))
    np.testing.assert_array_max_ulp(gt.distances.numpy(),
                                    np.asarray(gj.distances), maxulp=1)
    # the same neighbour sets as the grid search
    gg = tg.build_graph(c, n_neighbors=6, method="grid", device="cpu")
    same = (np.sort(gg.neighbor_idx.numpy(), 1)
            == np.sort(gt.neighbor_idx.numpy(), 1)).all(1)
    # rows that differ hold a distance tie at the k-th neighbour
    d = gt.distances.numpy()
    assert same.mean() > 0.95
    assert (d[~same, 5] == gg.distances.numpy()[~same, 5]).all()


def test_pallas_knn_accepts_a_tensor_and_centres_on_the_host():
    c = _coords(600, 1, "uniform") + np.float32(1e4)
    it, dt = pallas_knn(torch.as_tensor(c), 8, device="cpu")
    ij, dj = j_pallas_knn(c, 8)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij).astype(np.int64))
    np.testing.assert_array_max_ulp(dt.numpy(), np.asarray(dj), maxulp=1)


@pytest.mark.parametrize("include_self", [False, True])
def test_knn_plain_query_subset_equals_its_rows(include_self):
    """The plain version over a subset of queries (first and last rows, as
    the card's check at full size uses it) gives those rows of the whole
    scan."""
    c = _coords(1500, 9, "lattice")
    xy = torch.as_tensor(c - c.mean(axis=0, keepdims=True))
    d2, ids = kern_knn.knn_topk_plain(xy, 12, include_self)
    q = torch.cat([torch.arange(0, 100), torch.arange(1430, 1500)])
    qd, qi = kern_knn.knn_topk_plain(xy, 12, include_self, queries=q)
    assert torch.equal(qi, ids[q]) and torch.equal(qd, d2[q])


def test_knn_refusals():
    c = _coords(50, 0, "uniform")
    with pytest.raises(ValueError, match="2D"):
        pallas_knn(np.zeros((50, 3), np.float32), 4, device="cpu")
    with pytest.raises(ValueError, match="must be <"):
        pallas_knn(c, 50, device="cpu")
    xy = torch.as_tensor(c)
    with pytest.raises(ValueError, match="float32"):
        kern_knn.knn_topk(xy.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        kern_knn.knn_topk(torch.as_tensor(np.asfortranarray(c)), 4)
    with pytest.raises(ValueError, match="k=0"):
        kern_knn.knn_topk(xy, 0)
    before = dict(kern_knn.LAUNCHES)
    d2, ids = kern_knn.knn_topk(xy, 49, include_self=False)
    assert kern_knn.LAUNCHES == before            # CPU tensors launch nothing
    assert sorted(ids[0].tolist()) == list(range(1, 50))
    assert bool((d2[:, 1:] >= d2[:, :-1]).all())


@pytest.mark.parametrize("n", [2, 257, 66_536, 1_000_000])
@pytest.mark.parametrize("k", [1, 8, 16, 32, 64, 128, 256])
def test_knn_tiles_fit_shared_memory(k, n):
    """The chooser's shape, for every list length KMAX = 32, 64, 128, 256
    (and small k), is one the kernel takes: shared memory within the
    H100's 232,448 bytes, a list that holds k, and query tiles (queries a
    warp × warps a CTA) that cover the queries with only the last tile
    partial."""
    k = min(k, n - 1)
    t = kern_knn.knn_tiles(n, k)
    kern_knn.check_tiles(t)
    assert kern_knn.knn_smem_bytes(t) <= 232_448
    assert k <= kern_knn.kmax(k) <= kern_knn.MAX_K
    per = kern_knn.queries_a_cta(k, t)
    assert per == kern_knn.queries_a_warp(k) * (t.threads // 32)
    ctas = -(-n // per)
    assert (ctas - 1) * per < n <= ctas * per


@pytest.mark.parametrize("tiles,why", [
    ((16, 4096, 3), "threads"), ((288, 4096, 3), "threads"), ((48, 4096, 3), "threads"),
    ((256, 100, 3), "tile"), ((256, 64, 3), "tile"), ((256, 4096, 1), "stages"),
    ((256, 4096, 5), "stages"), ((256, 16384, 2), "shared memory")])
def test_knn_check_tiles_refuses(tiles, why):
    """A launch shape the kernel does not take is refused on the CPU too,
    before any launch, naming what is wrong."""
    t = kern_knn.KnnTiles(*tiles)
    with pytest.raises(ValueError, match=why):
        kern_knn.check_tiles(t)
    xy = torch.as_tensor(_coords(300, 1, "uniform"))
    with pytest.raises(ValueError, match=why):
        kern_knn.knn_topk_tiled(xy, 6, False, t)


def _morton_numpy(c):
    """Morton codes by a bit loop over the 2^16 x 2^16 cells of the box."""
    lo, hi = c.min(0), c.max(0)
    scale = np.float32(65535.0) / (hi - lo)
    cell = np.clip(np.nan_to_num((c - lo) * scale, nan=0.0, posinf=0.0, neginf=0.0),
                   0, 65535).astype(np.int64)
    code = np.zeros(len(c), np.int64)
    for b in range(16):
        code |= ((cell[:, 0] >> b) & 1) << (2 * b)
        code |= ((cell[:, 1] >> b) & 1) << (2 * b + 1)
    return code


@pytest.mark.parametrize("kind", ["uniform", "duplicates", "lattice"])
def test_knn_morton_codes_match_numpy(kind):
    """The wrapper's point order: morton_codes_plain's codes equal a bit
    loop's in numpy float32, cell for cell."""
    c = _coords(2000, 9, kind)
    got = kern_knn.morton_codes_plain(torch.as_tensor(c))
    np.testing.assert_array_equal(got.numpy(), _morton_numpy(c))


def test_knn_morton_order_is_a_permutation():
    """The wrapper's point order (the Morton codes sorted): any input, NaN,
    ±Inf and a box of width 0 included, gives a permutation; uniform points
    come out with their order neighbours near in the plane."""
    xy = torch.as_tensor(_coords(3000, 3, "uniform"))
    order = torch.argsort(kern_knn.morton_codes_plain(xy))
    assert torch.equal(order.sort().values, torch.arange(3000))
    step = (xy[order][1:] - xy[order][:-1]).norm(dim=1).mean()
    assert step < 0.1 * (xy[1:] - xy[:-1]).norm(dim=1).mean()
    xy[:4] = torch.tensor([[float("nan"), 0.0], [float("inf"), 1.0],
                           [-float("inf"), 2.0], [1e20, -1e20]])
    for pts in (xy, torch.zeros((5, 2)), torch.ones((1, 2))):
        o = torch.argsort(kern_knn.morton_codes_plain(pts))
        assert torch.equal(o.sort().values, torch.arange(pts.shape[0]))
