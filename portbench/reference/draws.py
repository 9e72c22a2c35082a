"""The draw stream of the banded permutation nulls, frozen as a definition.

This is the benchmark's own copy of what a draw is, written from the
published definition and not imported from the program, so that a change
to the program's stream cannot also change what the reference expects.

Draw ``d`` of a null permutes the cells with a keyed Feistel bijection:

- a key is the two 32-bit words of a JAX threefry-2x32 key;
  ``key_for(seed, *path)`` is ``key(seed)`` with every path part folded in
  (strings by their FNV-1a hash), and the draw's key is
  ``fold_in(key_for(seed & 0xFFFFFFFF, stream, 0), d)``, where ``stream``
  is ``"perm_feistel"`` for the global nulls and ``"perm_feistel_local"``
  for local Moran's I;
- the eight round keys are ``jax.random.randint(key, (8,), 0, 2**31 - 1)``;
- cell ``c`` takes the value of cell ``pi(c)``, where ``pi`` is the
  balanced 8-round Feistel network on ``[0, 4**bits)`` (``bits`` the
  smallest half-width whose square covers ``n``), walked in cycles until
  the value falls inside ``[0, n)``.

Keys are Python integers; the Feistel network runs in int64 torch ops on
any device, several draws at once.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
ROUNDS = 8


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1: int, k2: int, x1: int, x2: int):
    """Threefry-2x32, 20 rounds, on Python integers."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & M32
    x1 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def key(seed: int):
    seed = int(seed)
    if -(1 << 31) <= seed < (1 << 32):
        return 0, seed & M32
    return (seed >> 32) & M32, seed & M32


def fold_in(k, data: int):
    return threefry2x32(k[0], k[1], 0, int(data) & M32)


def split(k, num: int = 2) -> List[tuple]:
    return [threefry2x32(k[0], k[1], 0, i) for i in range(num)]


def _fnv1a(s: str) -> int:
    h = 0x811C9DC5
    for ch in s.encode():
        h = ((h ^ ch) * 0x01000193) & M32
    return h


def key_for(seed: int, *path) -> tuple:
    k = key(seed)
    for part in path:
        k = fold_in(k, _fnv1a(part) if isinstance(part, str) else int(part))
    return k


def _bits(k, count: int) -> List[int]:
    """32-bit ``jax.random.bits`` of shape [count] (partitionable form)."""
    out = []
    for i in range(count):
        a, b = threefry2x32(k[0], k[1], i >> 32, i & M32)
        out.append(a ^ b)
    return out


def round_keys(k) -> List[int]:
    """``randint(k, (8,), 0, 2**31 - 1)`` as int32 values."""
    k1, k2 = split(k)
    higher, lower = _bits(k1, ROUNDS), _bits(k2, ROUNDS)
    span = (1 << 31) - 1
    mult = ((((1 << 16) % span) ** 2) & M32) % span
    out = []
    for hi, lo in zip(higher, lower):
        off = (((hi % span) * mult) & M32) + lo % span
        out.append((off & M32) % span)
    return out


def draw_key(seed: int, stream: str, d: int) -> tuple:
    return fold_in(key_for(int(seed) & M32, stream, 0), d)


def _mul(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2**32 without int64 overflow."""
    return ((a & 0xFFFF) * b + (((a >> 16) * (b & 0xFFFF)) << 16)) & M32


def _network(x: torch.Tensor, rk: torch.Tensor, bits: int) -> torch.Tensor:
    """The Feistel network; ``rk`` [D, 8] round keys for the D rows of x."""
    mask = (1 << bits) - 1
    left, right = x >> bits, x & mask
    for r in range(ROUNDS):
        h = _mul(right ^ rk[:, r:r + 1], 0x9E3779B1)
        h = h ^ (h >> 15)
        h = _mul(h, 0x85EBCA77)
        h = h ^ (h >> 13)
        left, right = right, (left ^ h) & mask
    return (left << bits) | right


def half_bits(n: int) -> int:
    bits = max((int(n - 1).bit_length() + 1) // 2, 1)
    return bits + 1 if (1 << (2 * bits)) < n else bits


def permutations(seed: int, stream: str, draws: Sequence[int], n: int,
                 device) -> torch.Tensor:
    """[len(draws), n] int64: row i holds pi_d(c) for every cell c."""
    rk = torch.tensor([round_keys(draw_key(seed, stream, d)) for d in draws],
                      dtype=torch.int64, device=device)
    if n < 2:
        return torch.zeros((len(draws), n), dtype=torch.int64, device=device)
    bits = half_bits(n)
    y = _network(torch.arange(n, dtype=torch.int64, device=device)
                 .expand(len(draws), n), rk, bits)
    while True:
        rows, cols = torch.nonzero(y >= n, as_tuple=True)
        if rows.numel() == 0:
            return y
        y[rows, cols] = _network(y[rows, cols][:, None], rk[rows], bits)[:, 0]
