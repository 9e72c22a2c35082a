"""The port's multiple-testing corrections against the JAX package.

Tolerance: none — every value is bitwise equal. BH is the same float32
expression ``p·m/rank`` followed by a reversed cumulative minimum in both
packages, and the discrete BH keeps the stored float32 value of each level
as its representative, so grids that land 1 ulp off the direct division
stay exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialcore_tpu.ops import fdr as jf
from spatialcore_tpu_torch.ops import fdr as tf

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)


def _grid(L, shape, seed=3):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, L, size=shape)
    p = ((c + 1) / L).astype(np.float32)
    if p.ndim == 1:
        p[:40] = 1.0                           # tie mass at the top level
    else:
        p[:, 1] = 1.0                          # an all-ones column
        p[: L // 2, 2] = 1.0 / L               # heavy low-tie column
    return p


@pytest.mark.parametrize("L,shape", [(20, (400,)), (100, (1000, 7)), (8, (64, 3))])
def test_discrete_bh_bitwise(L, shape):
    p = _grid(L, shape)
    ref = np.asarray(jf.benjamini_hochberg_discrete(jnp.asarray(p), L, axis=0))
    got = tf.benjamini_hochberg_discrete(torch.as_tensor(p), L, axis=0).numpy()
    np.testing.assert_array_equal(got, ref)
    # and the sort path, in both packages
    np.testing.assert_array_equal(
        tf.benjamini_hochberg(torch.as_tensor(p), axis=0).numpy(),
        np.asarray(jf.benjamini_hochberg(jnp.asarray(p), axis=0)))
    np.testing.assert_array_equal(got, np.asarray(
        jf.benjamini_hochberg(jnp.asarray(p), axis=0)))


def test_discrete_bh_axis1_and_column_chunks(monkeypatch):
    """axis=1, and a chunk width that splits the columns unevenly."""
    p = _grid(20, (300, 5), seed=4).T.copy()
    ref = np.asarray(jf.benjamini_hochberg_discrete(jnp.asarray(p), 20, axis=1))
    np.testing.assert_array_equal(
        tf.benjamini_hochberg_discrete(torch.as_tensor(p), 20, axis=1).numpy(), ref)
    q = _grid(50, (200, 9), seed=5)
    monkeypatch.setattr(tf, "_CHUNK_ELEMS", 200 * 2)    # two columns a chunk
    np.testing.assert_array_equal(
        tf.benjamini_hochberg_discrete(torch.as_tensor(q), 50).numpy(),
        np.asarray(jf.benjamini_hochberg_discrete(jnp.asarray(q), 50)))


def test_discrete_bh_one_ulp_grid():
    """The two-sided doubling path's grid: (c+1)·f32(1/L) lands 1 ulp off
    (c+1)/L for part of the counts; the stored bits must be used."""
    L = 200
    c = np.random.default_rng(6).integers(0, L, size=(500, 4)).astype(np.float32)
    p = np.minimum(((c + 1) * np.float32(1.0 / L)).astype(np.float32), 1.0)
    assert np.any(p != (np.round(p * L)).astype(np.float32) / L)
    ref = np.asarray(jf.benjamini_hochberg(jnp.asarray(p), axis=0))
    np.testing.assert_array_equal(
        tf.benjamini_hochberg_discrete(torch.as_tensor(p), L, axis=0).numpy(), ref)


@pytest.mark.parametrize("method,n_levels", [("fdr_bh", 0), ("fdr_bh", 50),
                                             ("bh", 50), ("bonferroni", 0),
                                             ("none", 0)])
def test_apply_fdr_matches_reference(method, n_levels):
    p = _grid(50, (300, 6), seed=7)
    ref = np.asarray(jf.apply_fdr(jnp.asarray(p), method, axis=0,
                                  n_levels=n_levels))
    got = tf.apply_fdr(torch.as_tensor(p), method, axis=0, n_levels=n_levels)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_apply_fdr_refuses_unknown_method():
    with pytest.raises(ValueError, match="Unknown FDR method"):
        tf.apply_fdr(torch.ones(4), "holm")
