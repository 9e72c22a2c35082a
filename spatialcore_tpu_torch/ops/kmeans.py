"""K-Means (k-means++ init, Lloyd iterations, mini-batch variant) in torch ops.

Port of ``spatialcore_tpu/ops/kmeans.py``. The randomness is bitwise the
reference's: ``key_for(seed, "kmeans", restart)`` and ``split`` for the
seeding keys, ``randint`` for the first centre, ``choice(n, p=probs)`` for
the others (jax 0.9: ``p_cuml = cumsum(p)``, ``r = p_cuml[-1]·(1 −
uniform())``, ``searchsorted(p_cuml, r)``), ``permutation(key, n)[:m]`` for
the mini-batch seeding subsample and ``fold_in`` + ``randint`` for the
mini-batches.

The k-means++ seed indices are bitwise the reference's CPU run, which
needs the float32 sums in the order XLA's CPU backend adds them:

- ``jnp.sum`` of a vector is a tree: windows of 32 (the padding split
  evenly on both sides), each added in order, then the same on the window
  sums (:func:`_tree_sum`);
- ``jnp.cumsum`` is a blocked scan: blocks of 16 added in order, the
  block totals scanned the same way, and each block offset by the
  exclusive prefix of the totals (:func:`_blocked_cumsum`);
- a squared distance over D ≤ 32 features is one fused loop whose
  ``acc + d·d`` the compiler contracts into a fused multiply-add; over
  D > 32 the squares round first and then add as a tree
  (:func:`_pairwise_sq`).

Lloyd's assignments, the mini-batch steps and the final labels round their
distances the same way: profiles are counts over k neighbours, so many
cells sit on ties that another rounding breaks the other way.

Lloyd's and the mini-batch's centre sums are ``onehot.T @ X`` in float64,
rounded once to float32: never a float atomic scatter, whose order
changes from run to run, and the card's and the CPU's float64 sums differ
far below a float32 ulp, so they round alike, TF32 or not. The reference
adds them in float32 in XLA's dot order, so centres and inertia agree with
it to float32 rounding and the final labels agree up to renaming on
separated data.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch
import torch.nn.functional as F

from ..core.rng import _choice, _fma32, fold_in, key_for, randint, split, uniform

Device = Union[str, torch.device]

#: XLA's CPU tree reduction adds windows of this many values in order
_TREE = 32
#: XLA's CPU cumulative sum scans blocks of this many values in order
_SCAN = 16


class KMeansResult(NamedTuple):
    labels: torch.Tensor     # int32 [N]
    centroids: torch.Tensor  # float32 [k, D]
    inertia: torch.Tensor    # float32 scalar
    n_iter: int


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in XLA's CPU tree-reduction order."""
    n = x.shape[-1]
    if n <= _TREE:
        acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for j in range(n):
            acc = acc + x[..., j]
        return acc
    nw = -(-n // _TREE)
    left = (nw * _TREE - n) // 2
    padded = x.new_zeros(x.shape[:-1] + (nw * _TREE,))
    padded[..., left:left + n] = x
    windows = padded.reshape(x.shape[:-1] + (nw, _TREE))
    acc = torch.zeros(windows.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(_TREE):
        acc = acc + windows[..., j]
    return _tree_sum(acc)


def _blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum of a vector in XLA's CPU blocked-scan order."""
    n = x.shape[0]
    if n <= _SCAN:
        acc = torch.zeros((), dtype=x.dtype, device=x.device)
        out = []
        for j in range(n):
            acc = acc + x[j]
            out.append(acc)
        return torch.stack(out)
    nb = -(-n // _SCAN)
    blocks = x.new_zeros(nb * _SCAN)
    blocks[:n] = x
    blocks = blocks.reshape(nb, _SCAN)
    acc = torch.zeros(nb, dtype=x.dtype, device=x.device)
    inner = []
    for j in range(_SCAN):
        acc = acc + blocks[:, j]
        inner.append(acc)
    inner = torch.stack(inner, dim=1)
    totals = _blocked_cumsum(inner[:, -1])
    offset = torch.cat([totals.new_zeros(1), totals[:-1]])
    return (inner + offset[:, None]).reshape(-1)[:n]


def _pairwise_sq(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """[N, k] squared distances, rounded as the reference's CPU run rounds
    ``sum((X[:, None] − C[None])², axis=-1)``."""
    D = X.shape[1]
    if D > _TREE:
        d = X[:, None, :] - C[None, :, :]
        return _tree_sum(d * d)
    acc = torch.zeros((X.shape[0], C.shape[0]), dtype=X.dtype, device=X.device)
    for j in range(D):
        d = X[:, None, j] - C[None, :, j]
        acc = _fma32(d, d, acc)
    return acc


def _choice_p(k: torch.Tensor, probs: torch.Tensor) -> int:
    """``jax.random.choice(k, n, p=probs)`` (one draw, with replacement)."""
    p_cuml = _blocked_cumsum(probs)
    u = uniform(k, ()).to(probs.device)
    r = p_cuml[-1] * (1 - u)
    return int(torch.searchsorted(p_cuml, r.reshape(1), right=False)[0])


def _plusplus_init(k: torch.Tensor, X: torch.Tensor, n_centers: int):
    """k-means++ seeding: [n_centers, D] rows of X."""
    n = X.shape[0]
    k0, k = split(k)
    idx = [int(randint(k0, (), 0, n))]
    d2 = _pairwise_sq(X, X[idx[0]][None])[:, 0]
    floor = torch.tensor(1e-30, dtype=torch.float32, device=X.device)
    for _ in range(1, n_centers):
        k, sub = split(k)
        probs = d2 / torch.maximum(_tree_sum(d2), floor)
        idx.append(_choice_p(sub, probs))
        d2 = torch.minimum(d2, _pairwise_sq(X, X[idx[-1]][None])[:, 0])
    return X[idx].clone()


def _assign(X: torch.Tensor, centers: torch.Tensor):
    dist = _pairwise_sq(X, centers)
    return torch.argmin(dist, dim=1), _tree_sum(dist.amin(dim=1))


def _centre_sums(onehot: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """[k, D] per-centre sums of the rows of X, in float64 then rounded."""
    return (onehot.T.to(torch.float64) @ X.to(torch.float64)).to(torch.float32)


def _lloyd(X: torch.Tensor, centers: torch.Tensor, max_iter: int, tol: float):
    k = centers.shape[0]
    it = 0
    shift = float("inf")
    # the reference's while_loop tests (shift > tol) & (it < max_iter) on
    # the device; here the shift is read back once an iteration
    while shift > tol and it < max_iter:
        labels = torch.argmin(_pairwise_sq(X, centers), dim=1)
        onehot = F.one_hot(labels, k).to(X.dtype)
        counts = onehot.sum(dim=0)
        sums = _centre_sums(onehot, X)
        new = torch.where(counts[:, None] > 0,
                          sums / torch.clamp_min(counts[:, None], 1.0), centers)
        shift = float(torch.sqrt(((new - centers) ** 2).sum()))
        centers = new
        it += 1
    labels, inertia = _assign(X, centers)
    return labels.to(torch.int32), centers, inertia, it


def _as_points(X, device: Device) -> torch.Tensor:
    return torch.as_tensor(X).to(device=device, dtype=torch.float32)


def kmeans(X, k: int, seed: int = 0, n_init: int = 10, max_iter: int = 300,
           tol: float = 1e-6, device: Device = "cuda") -> KMeansResult:
    """Full-batch K-Means: best of ``n_init`` k-means++ restarts by inertia,
    on ``device``. Seeds are bitwise the reference's; labels agree with it
    up to renaming on separated data (module docstring)."""
    X = _as_points(X, device)
    best = None
    for restart in range(n_init):
        centers0 = _plusplus_init(key_for(seed, "kmeans", restart), X, k)
        res = _lloyd(X, centers0, max_iter, tol)
        # first restart with the least inertia wins, as jnp.argmin picks
        if best is None or float(res[2]) < float(best[2]):
            best = res
    labels, centers, inertia, n_iter = best
    return KMeansResult(labels, centers, inertia, n_iter)


def minibatch_kmeans(X, k: int, seed: int = 0, batch_size: int = 1024,
                     n_steps: int = 100, n_init: int = 3,
                     device: Device = "cuda") -> KMeansResult:
    """Mini-batch K-Means (Sculley 2010) with per-centre count learning
    rates, on ``device``: k-means++ on a ``min(n, 10·batch_size)``-row
    subsample, then ``n_steps`` batches drawn with ``randint``."""
    X = _as_points(X, device)
    n = X.shape[0]
    best = None
    for restart in range(n_init):
        init_key, key = split(key_for(seed, "mbkmeans", restart))
        sub = _choice(init_key, n, min(n, 10 * batch_size), device=X.device)
        centers = _plusplus_init(key, X[sub], k)
        counts = torch.zeros(k, dtype=torch.float32, device=X.device)
        for s in range(n_steps):
            idx = randint(fold_in(key, s), (batch_size,), 0, n).to(X.device)
            B = X[idx]
            labels = torch.argmin(_pairwise_sq(B, centers), dim=1)
            onehot = F.one_hot(labels, k).to(torch.float32)
            bcounts = onehot.sum(dim=0)
            bsums = _centre_sums(onehot, B)
            new_counts = counts + bcounts
            lr = bcounts / torch.clamp_min(new_counts, 1.0)
            bmeans = bsums / torch.clamp_min(bcounts[:, None], 1.0)
            step = torch.where(bcounts[:, None] > 0, bmeans - centers,
                               torch.zeros_like(centers))
            centers = centers + lr[:, None] * step
            counts = new_counts
        labels, inertia = _assign(X, centers)
        if best is None or float(inertia) < float(best[2]):
            best = (labels.to(torch.int32), centers, inertia)
    labels, centers, inertia = best
    return KMeansResult(labels, centers, inertia, n_steps)
