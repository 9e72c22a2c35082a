"""Counter-based randomness, bitwise equal to the JAX package's streams.

Port of ``spatialcore_tpu/core/rng.py``. Every random stream of the
reference is a JAX threefry key derived from ``(seed, *stream_ids)``; the
banded permutation null draws its rows from a keyed Feistel bijection whose
8 round keys come from ``jax.random.randint``. To reproduce those draws
bit for bit, this module implements the pieces of ``jax.random`` they use,
in torch integer ops, under jax 0.9's default
``jax_threefry_partitionable=True``:

- threefry2x32 (``jax/_src/prng.py``: ``_threefry2x32_lowering``);
- ``jax.random.key`` (``threefry_seed``), ``fold_in`` and ``split``
  (``_threefry_split_foldlike``);
- 32-bit ``random_bits`` (``_threefry_random_bits_partitionable``),
  ``randint``'s bits-to-range mapping (``jax/_src/random.py``: ``_randint``)
  and ``permutation`` (``_shuffle``: rounds of stable sorts by random keys).

torch has no full uint32 arithmetic, so values are held in int64 with
``& 0xFFFFFFFF`` masks. Additions, xors and shifts of 32-bit values stay
far below 2**63; a product of two 32-bit values can overflow int64, so
:func:`_mul32` splits one factor into 16-bit halves.

A key is an int64 tensor of shape [2] holding the two uint32 words of the
JAX key data (``jax.random.key_data``). Keys are tiny and live on the CPU;
the per-cell work — the Feistel evaluation, and ``random_bits`` and the
sorts of ``permutation`` — runs on the caller's device.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_FEISTEL_ROUNDS = 8


def _mul32(a, b):
    """(a * b) mod 2**32 for a, b in [0, 2**32), without int64 overflow.

    a·b = a_lo·b + 2**16·a_hi·b; modulo 2**32 the second term only keeps
    a_hi·b_lo. a_lo·b < 2**48 and (a_hi·b_lo) << 16 < 2**48.
    """
    return ((a & 0xFFFF) * b + (((a >> 16) * (b & 0xFFFF)) << 16)) & _M32


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds, as ``_threefry2x32_lowering``.

    ``k1, k2`` are the key words, ``x1, x2`` the count words (int64
    tensors of one shape holding uint32 values). Returns two such tensors.
    """
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _M32
    x1 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed: int) -> torch.Tensor:
    """``jax.random.key(seed)`` as its key data: int64 [2] on the CPU.

    A seed that fits 32 bits (signed or unsigned) gets a zero high word, as
    JAX builds it from an int32/uint32 scalar; wider seeds split into their
    high and low words (JAX's x64 behaviour).
    """
    seed = int(seed)
    if -(1 << 31) <= seed < (1 << 32):
        hi, lo = 0, seed & _M32
    else:
        hi, lo = (seed >> 32) & _M32, seed & _M32
    return torch.tensor([hi, lo], dtype=torch.int64)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of the count pair (0, data)."""
    zero = torch.zeros((), dtype=torch.int64)
    d = torch.tensor(int(data) & _M32, dtype=torch.int64)
    a, b = threefry2x32(k[0], k[1], zero, d)
    return torch.stack([a, b])


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable form): [num, 2] key data."""
    counts = torch.arange(num, dtype=torch.int64)
    a, b = threefry2x32(k[0], k[1], torch.zeros_like(counts), counts)
    return torch.stack([a, b], dim=1)


def random_bits(k: torch.Tensor, shape: Sequence[int],
                device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """``jax.random.bits`` at 32 bits: uint32 values in int64, ``shape``,
    computed on ``device`` (the key stays a pair of host words)."""
    size = int(np.prod(shape)) if len(shape) else 1
    i = torch.arange(size, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(int(k[0]), int(k[1]), i >> 32, i & _M32)
    return (b1 ^ b2).reshape(tuple(shape))


def permutation(k: torch.Tensor, n: int,
                device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """``jax.random.permutation(key, n)`` bitwise (jax 0.9 ``_shuffle``).

    ``ceil(3·ln(max(1, n)) / ln(2³²−1))`` rounds (one up to n = 1,625, two
    up to ~2.6M); each splits the key, draws 32-bit sort keys for the n
    positions and reorders ``arange(n)`` by a STABLE sort of them, as
    ``lax.sort_key_val`` does. Runs on ``device``; returns int64.
    """
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        k, sub = split(k)
        order = torch.sort(random_bits(sub, (n,), device), stable=True).indices
        x = x[order]
    return x


def randint(k: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)``.

    Two 32-bit words per value, combined modulo the span exactly as JAX's
    ``_randint`` does in uint32 arithmetic. Returns int64 holding int32
    values. ``minval``/``maxval`` must lie in the int32 range.
    """
    lo32, hi32 = -(1 << 31), (1 << 31) - 1
    if not (lo32 <= minval <= hi32 and lo32 <= maxval <= hi32):
        raise ValueError("randint bounds must lie in the int32 range")
    k1, k2 = split(k)
    higher = random_bits(k1, shape)
    lower = random_bits(k2, shape)
    span = 1 if maxval <= minval else (maxval - minval) & _M32
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & _M32) % span
    offset = (_mul32(higher % span, multiplier) + lower % span) & _M32
    offset = offset % span
    out = (minval + offset) & _M32
    return torch.where(out >= (1 << 31), out - (1 << 32), out)


def _fnv1a(s: str) -> int:
    h = 0x811C9DC5
    for ch in s.encode():
        h = ((h ^ ch) * 0x01000193) & _M32
    return h


def key_for(seed: int, *stream: Union[int, str]) -> torch.Tensor:
    """Derive a key from a base seed and a hierarchical stream path.

    Bitwise equal to ``spatialcore_tpu.core.rng.key_for``: string parts are
    FNV-1a hashed, every part is folded in as a uint32.
    """
    k = key(seed)
    for part in stream:
        if isinstance(part, str):
            part = _fnv1a(part)
        k = fold_in(k, int(part) & _M32)
    return k


# ---------------------------------------------------------------------------
# Feistel pseudo-random permutations (sort-free, O(n) elementwise)
# ---------------------------------------------------------------------------


def _feistel_bijection(x: torch.Tensor, round_keys: Sequence[int],
                       bits: int) -> torch.Tensor:
    """Keyed bijection on [0, 4**bits) via a balanced 8-round Feistel network.

    ``x`` holds uint32 values in int64; ``round_keys`` are Python ints.
    """
    mask = (1 << bits) - 1
    left = x >> bits
    right = x & mask
    for r in range(_FEISTEL_ROUNDS):
        h = _mul32(right ^ round_keys[r], 0x9E3779B1)
        h = h ^ (h >> 15)
        h = _mul32(h, 0x85EBCA77)
        h = h ^ (h >> 13)
        left, right = right, (left ^ h) & mask
    return (left << bits) | right


def feistel_round_keys(k: torch.Tensor) -> list:
    """The 8 round keys ``feistel_apply`` draws with ``randint``."""
    return randint(k, (_FEISTEL_ROUNDS,), 0, (1 << 31) - 1).tolist()


def feistel_apply(k: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Evaluate the keyed Feistel permutation of [0, n) at positions ``idx``.

    ``feistel_apply(k, idx, n)[p] == feistel_permutation(k, n)[idx[p]]``,
    bitwise equal to the reference. Runs on ``idx``'s device and returns
    int64 (torch's index type; the reference returns int32 of the same
    values). The cycle walk checks for out-of-range values once per pass,
    which reads one flag back to the host.
    """
    if n < 2:
        return torch.zeros(idx.shape, dtype=torch.int64, device=idx.device)
    bits = max((int(n - 1).bit_length() + 1) // 2, 1)
    if (1 << (2 * bits)) < n:
        bits += 1
    round_keys = feistel_round_keys(k)
    y = _feistel_bijection(idx.to(torch.int64), round_keys, bits)
    while True:
        out = y >= n
        if not bool(out.any()):
            return y
        y = torch.where(out, _feistel_bijection(y, round_keys, bits), y)


def feistel_permutation(k: torch.Tensor, n: int,
                        device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """Pseudo-random permutation of ``arange(n)`` without a sort."""
    if n < 2:
        return torch.zeros((n,), dtype=torch.int64, device=device)
    return feistel_apply(k, torch.arange(n, dtype=torch.int64, device=device), n)
