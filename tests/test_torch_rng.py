"""The port's counter-based randomness is bitwise the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialcore_tpu.core import rng as jrng
from spatialcore_tpu_torch.core import rng as trng

# One intra-op thread: xdist runs several test workers at once, and torch's
# default of one thread per core in each slows small ops several-fold.
torch.set_num_threads(1)


@pytest.mark.parametrize("seed,stream", [
    (0, ()), (7, ("perm_feistel", 0)), (123456, ("perm_global", 3, "x")),
    (2**31 - 1, ("moran", 17, 2**32 - 1)), (5, (-1,)),
])
def test_key_for_bitwise(seed, stream):
    want = np.asarray(jax.random.key_data(jrng.key_for(seed, *stream)))
    got = trng.key_for(seed, *stream).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_fold_in_split_bits_bitwise():
    k = jax.random.key(42)
    tk = trng.key(42)
    for d in (0, 1, 99, 2**32 - 1):
        np.testing.assert_array_equal(
            trng.fold_in(tk, d).numpy(),
            np.asarray(jax.random.key_data(jax.random.fold_in(k, d))))
    np.testing.assert_array_equal(
        trng.split(tk, 3).numpy(),
        np.asarray(jax.random.key_data(jax.random.split(k, 3))))
    np.testing.assert_array_equal(
        trng.random_bits(tk, (5, 3)).numpy(),
        np.asarray(jax.random.bits(k, (5, 3), jnp.uint32)).astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(0, 2**31 - 1), (-5, 17), (3, 3), (0, 1000)])
def test_randint_bitwise(lo, hi):
    k = jax.random.key(9)
    want = np.asarray(jax.random.randint(k, (64,), lo, hi, dtype=jnp.int32))
    np.testing.assert_array_equal(
        trng.randint(trng.key(9), (64,), lo, hi).numpy(), want)


def test_feistel_round_keys_bitwise():
    k = jrng.key_for(11, "perm_feistel", 0)
    want = np.asarray(jax.random.randint(
        k, (8,), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32))
    assert trng.feistel_round_keys(trng.key_for(11, "perm_feistel", 0)) == \
        want.tolist()


@pytest.mark.parametrize("n", [2, 3, 10, 17, 100, 1000, 4097, 12345])
def test_feistel_permutation_bitwise(n):
    """n not a power of 4 exercises the cycle walk."""
    want = np.asarray(jrng.feistel_permutation(jrng.key_for(1, "p", n), n))
    got = trng.feistel_permutation(trng.key_for(1, "p", n), n, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert sorted(got.tolist()) == list(range(n))


def test_feistel_apply_bitwise_with_duplicates():
    n = 777
    idx = np.random.default_rng(0).integers(0, n, 2000).astype(np.int32)
    jk = jrng.key_for(4, "perm_feistel", 0)
    jk = jax.random.fold_in(jk, 12)
    want = np.asarray(jrng.feistel_apply(jk, jnp.asarray(idx), n))
    tk = trng.fold_in(trng.key_for(4, "perm_feistel", 0), 12)
    got = trng.feistel_apply(tk, torch.as_tensor(idx), n)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_mul32_matches_uint32_wrap():
    a = np.random.default_rng(1).integers(0, 2**32, 1000, dtype=np.uint64)
    b = np.random.default_rng(2).integers(0, 2**32, 1000, dtype=np.uint64)
    want = (a.astype(np.uint32) * b.astype(np.uint32)).astype(np.int64)
    got = trng._mul32(torch.as_tensor(a.astype(np.int64)),
                      torch.as_tensor(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 1625, 1626, 5000, 70_000])
@pytest.mark.parametrize("seed,data", [(0, 0), (3, 17), (2**31 - 1, 2**32 - 1)])
def test_permutation_bitwise(n, seed, data):
    """One sort round up to n = 1,625, two from 1,626 (jax 0.9 _shuffle)."""
    k = jax.random.fold_in(jax.random.key(seed), data)
    want = np.asarray(jax.random.permutation(k, n))
    got = trng.permutation(trng.fold_in(trng.key(seed), data), n, device="cpu")
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_bits_on_a_device_and_key_for_stream():
    """random_bits takes the device its counters live on; the direct Lee
    null's keys (key_for(seed, "perm_lee", 0) folded with the draw)."""
    k = jax.random.key(8)
    want = np.asarray(jax.random.bits(k, (4, 6), jnp.uint32)).astype(np.int64)
    got = trng.random_bits(trng.key(8), (4, 6), device=torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), want)
    jk = jax.random.fold_in(jrng.key_for(5, "perm_lee", 0), 2)
    tk = trng.fold_in(trng.key_for(5, "perm_lee", 0), 2)
    np.testing.assert_array_equal(
        trng.permutation(tk, 3000, device="cpu").numpy(),
        np.asarray(jax.random.permutation(jk, 3000)))
