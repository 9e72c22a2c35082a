"""Counter-based randomness, bitwise equal to the JAX package's streams.

Port of ``spatialcore_tpu/core/rng.py``. Every random stream of the
reference is a JAX threefry key derived from ``(seed, *stream_ids)``; the
banded permutation null draws its rows from a keyed Feistel bijection whose
8 round keys come from ``jax.random.randint``. To reproduce those draws
bit for bit, this module implements the pieces of ``jax.random`` they use,
in torch integer ops (on Python ints where only a key or a few words come
out: ``fold_in`` and the Feistel round keys), under jax 0.9's default
``jax_threefry_partitionable=True``:

- threefry2x32 (``jax/_src/prng.py``: ``_threefry2x32_lowering``);
- ``jax.random.key`` (``threefry_seed``), ``fold_in`` and ``split``
  (``_threefry_split_foldlike``);
- 32-bit ``random_bits`` (``_threefry_random_bits_partitionable``),
  ``randint``'s bits-to-range mapping (``jax/_src/random.py``: ``_randint``)
  and ``permutation`` (``_shuffle``: rounds of stable sorts by random keys),
  and ``choice(replace=False)`` without weights, which is a prefix of a
  ``permutation`` (``jax/_src/random.py``: ``choice``);
- ``uniform`` and ``normal`` (√2 · erf⁻¹ of a uniform), with the float32
  arithmetic of the reference's CPU run: fused multiply-adds formed
  exactly (:func:`_fma32`), and XLA's own ``exp``, ``log``, ``log1p`` and
  ``erf_inv`` approximations (:func:`_exp32`, :func:`_log32`,
  :func:`_log1p32`, :func:`_erf_inv32`), which other modules reuse.

torch has no full uint32 arithmetic, so values are held in int64 with
``& 0xFFFFFFFF`` masks. Additions, xors and shifts of 32-bit values stay
far below 2**63; a product of two 32-bit values can overflow int64, so
:func:`_mul32` splits one factor into 16-bit halves.

A key is an int64 tensor of shape [2] holding the two uint32 words of the
JAX key data (``jax.random.key_data``). Keys are tiny and live on the CPU;
the per-cell work — the Feistel evaluation (``kernels.feistel``), and
``random_bits`` and the sorts of ``permutation`` — runs on the caller's
device.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from ..utils.profiling import count, span

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


def _words(k: torch.Tensor) -> tuple:
    """A key's two uint32 words as Python ints."""
    hi, lo = k.tolist()
    return int(hi), int(lo)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: threefry of the count pair (0, data), on
    Python ints."""
    return torch.tensor(threefry2x32(*_words(k), 0, int(data) & _M32),
                        dtype=torch.int64)


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


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a·b + c`` rounded once, as a fused multiply-add.

    a·b is exact in float64; the float64 sum's own error comes from a
    TwoSum, and where the float64 sum sits exactly halfway between two
    float32 values that error decides the side, so the double rounding
    lands where the single one does. Exact on any device.
    """
    p = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = p + c64
    bp = s - p
    err = (p - (s - bp)) + (c64 - bp)
    r = s.to(torch.float32)
    back = r.to(torch.float64)
    d = s - back
    toward = torch.where(d > 0, torch.full_like(r, float("inf")),
                         torch.full_like(r, float("-inf")))
    nxt = torch.nextafter(r, toward)
    tie = (d != 0) & (nxt.to(torch.float64) - back == 2 * d) & (err != 0)
    return torch.where(tie & ((err > 0) == (d > 0)), nxt, r)


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """float32 square root, correctly rounded on any device.

    torch's vectorized float32 ``sqrt`` on the CPU can land one ulp off
    the correctly rounded value that XLA (and CUDA) return; the float64
    root of a float32 rounds to the correctly rounded float32 root (53
    bits ≥ 2·24 + 2, so the double rounding is innocuous).
    """
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def uniform(k: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0,
            device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` bitwise
    (jax 0.9 ``_uniform``), computed on ``device``.

    The 32 random bits of each value keep their top 23 as the mantissa of
    a float in [1, 2) (``bits >> 9 | 0x3F800000``, bit-cast), 1.0 comes off,
    the result scales by ``maxval − minval`` and shifts by ``minval`` in one
    rounding (the fused multiply-add the reference's CPU run compiles it
    to; :func:`_fma32`), and values below ``minval`` are raised to it.
    """
    bits = random_bits(k, shape, device)
    one = (bits >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, _fma32(floats, (hi - lo).expand_as(floats),
                                    lo.expand_as(floats)))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """:func:`_fma32` of broadcast float32 operands on one device."""
    return _fma32(*torch.broadcast_tensors(a, b, c))


def _c(x: torch.Tensor, v: float) -> torch.Tensor:
    """The float32 constant ``v`` on ``x``'s device."""
    return torch.tensor(v, dtype=torch.float32, device=x.device)


_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def _exp32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp`` as XLA's CPU backend computes it: n = ⌊x·log2(e) +
    ½⌋ clamped to ±127, a = x − n·ln 2 in two fused steps, a Cephes
    polynomial in Horner form of fused multiply-adds, times 2ⁿ; results
    below the smallest normal flush to 0."""
    x = x.clamp(-87.8, 88.8)
    n = torch.floor(_fma(x, _c(x, 1.44269504088896341), _c(x, 0.5)))
    n = n.clamp(-127.0, 127.0)
    a = _fma(_c(x, -0.693359375), n, x)
    a = _fma(_c(x, 2.12194440e-4), n, a)
    z = _fma(a, _c(x, _EXP_P[0]), _c(x, _EXP_P[1]))
    for p in _EXP_P[2:]:
        z = _fma(z, a, _c(x, p))
    z = 1.0 + _fma(z, a * a, a)
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = z * pow2
    return torch.where(out < 1.1754943508222875e-38, torch.zeros_like(out), out)


_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _log32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` as XLA's CPU backend computes it: the mantissa in
    [√½, √2) − 1, a Cephes polynomial in three interleaved Horner chains of
    fused multiply-adds, and the exponent's two-part ln 2 added back with
    the compiler's fusions. 0 → −inf, negative → NaN, +inf → +inf."""
    inp = torch.maximum(x, _c(x, 1.1754943508222875e-38))
    bits = inp.view(torch.int32)
    e = 1.0 + ((bits >> 23) - 127).to(torch.float32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = m < 0.707106781186547524
    xx = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.to(torch.float32)
    x2 = xx * xx
    x3 = x2 * xx
    P = [_c(x, p) for p in _LOG_P]
    y = _fma(xx, P[0], P[1])
    y1 = _fma(xx, P[3], P[4])
    y2 = _fma(xx, P[6], P[7])
    y = _fma(y, xx, P[2])
    y1 = _fma(y1, xx, P[5])
    y2 = _fma(y2, xx, P[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, -2.12194440e-4 * e)
    xx = _fma(x2, _c(x, -0.5), xx) + y
    out = _fma(_c(x, 0.693359375), e, xx)
    out = torch.where(x == 0, torch.full_like(out, -math.inf), out)
    out = torch.where(x < 0, torch.full_like(out, math.nan), out)
    out = torch.where(torch.isposinf(x), x, out)
    return torch.where(torch.isnan(x), x, out)



_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, _c(x, c))
    return p


def _log1p32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p`` as XLA's CPU backend computes it: below
    √2 − 1 in magnitude a Cephes rational x − x²/2 + x³·P(x)/Q(x) (Horner
    chains of fused multiply-adds), above it :func:`_log32` of 1 + x."""
    x2 = x * x
    q = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + _fma(_c(x, -0.5), x2, (x * x2) * q)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       _log32(x + 1.0))


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erf_inv32(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function as XLA computes it: Giles' single
    precision approximation, w = −log1p(−x²) (:func:`_log1p32`), a degree-8
    polynomial in w − 2.5 below w = 5 and in √w − 3 above it (a correctly
    rounded root, :func:`_sqrt32`), evaluated by fused multiply-adds; ±1
    gives ±inf."""
    w = -_log1p32(-(x * x))
    lt = w < 5
    w = torch.where(lt, w - 2.5, _sqrt32(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, _c(x, a), _c(x, b))
        p = c if p is None else _fma(p, w, c)
    out = p * x
    return torch.where(x.abs() == 1, x * math.inf, out)


def normal(k: torch.Tensor, shape: Sequence[int],
           device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` (jax 0.9 ``_normal_real``):
    √2 · erf⁻¹(u) for u = ``uniform(key, shape, nextafter(−1, 0), 1)``,
    computed on ``device``, bitwise the reference's: u is, and erf⁻¹
    follows XLA's CPU arithmetic (:func:`_erf_inv32`)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(k, shape, lo, 1.0, device)
    return float(np.float32(math.sqrt(2.0))) * _erf_inv32(u)


def _choice(k: torch.Tensor, m: int, size: int,
            device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """``jax.random.choice(key, m, (size,), replace=False)`` with ``p=None``:
    jax 0.9 draws it as ``permutation(key, m)[:size]``. Runs on ``device``;
    returns int64. Like the reference, refuses ``size > m``."""
    if size > m:
        raise ValueError(f"cannot take {size} of {m} values without "
                         "replacement")
    return permutation(k, m, device)[:size]


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
    out = _randint_bits(random_bits(k1, shape), random_bits(k2, shape),
                        minval, maxval)
    return torch.where(out >= (1 << 31), out - (1 << 32), out)


def _randint_bits(higher, lower, minval: int, maxval: int):
    """``_randint``'s mapping of two 32-bit words to ``minval + offset``
    modulo 2**32 (uint32 arithmetic; int64 tensors or Python ints)."""
    span = 1 if maxval <= minval else (maxval - minval) & _M32
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & _M32) % span
    offset = (_mul32(higher % span, multiplier) + lower % span) & _M32
    return (minval + offset % span) & _M32


def _fnv1a(s: str) -> int:
    h = 0x811C9DC5
    for ch in s.encode():
        h = ((h ^ ch) * 0x01000193) & _M32
    return h


def np_rng(seed: int, *stream: Union[int, str]) -> np.random.Generator:
    """Host-side numpy Generator seeded from the same hierarchical path:
    ``default_rng([seed] + [fnv1a(part) or int(part), ...])``, the
    reference's ``np_rng``. For cheap host decisions (subsampling) that
    must be reproducible but never touch the device."""
    parts = [seed] + [_fnv1a(p) if isinstance(p, str) else int(p)
                      for p in stream]
    return np.random.default_rng(parts)


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


def permutation_keys(seed: int, n_permutations: int,
                     stream: str = "perm") -> torch.Tensor:
    """``n_permutations`` independent keys, [n_permutations, 2] key data:
    ``split(key_for(seed, stream), n_permutations)``. The stream path has
    no trailing draw index, unlike the nulls' ``key_for(seed, name, 0)``."""
    return split(key_for(seed, stream), n_permutations)


def batch_permutations(seed: int, n: int, n_permutations: int,
                       stream: str = "perm",
                       device: Union[str, torch.device] = "cuda"
                       ) -> torch.Tensor:
    """[n_permutations, n] int32 permutation rows; row p permutes
    ``arange(n)`` with the p-th key of :func:`permutation_keys`, bitwise
    the reference's ``batch_permutations``. Built on ``device``."""
    keys = permutation_keys(seed, n_permutations, stream)
    out = torch.empty((n_permutations, n), dtype=torch.int32, device=device)
    for p in range(n_permutations):
        out[p] = permutation(keys[p], n, device)
    return out


# ---------------------------------------------------------------------------
# Feistel pseudo-random permutations (sort-free, O(n) elementwise)
# ---------------------------------------------------------------------------


def feistel_bits(n: int) -> int:
    """Half the width of the Feistel domain of [0, n): the least ``bits``
    with 4**bits >= n (at least 1)."""
    bits = max((int(n - 1).bit_length() + 1) // 2, 1)
    return bits + ((1 << (2 * bits)) < n)


def feistel_round_keys(k: torch.Tensor) -> list:
    """The 8 round keys ``feistel_apply`` draws, ``randint(k, (8,), 0,
    2**31 - 1)`` bitwise, on Python ints: a split, then 8 words of each
    half's ``random_bits`` (18 threefry, no tensor op, no read-back)."""
    k0, k1 = _words(k)
    higher, lower = (threefry2x32(k0, k1, 0, c) for c in (0, 1))

    def bits(sub: tuple, i: int) -> int:
        b1, b2 = threefry2x32(*sub, 0, i)
        return b1 ^ b2

    return [_randint_bits(bits(higher, i), bits(lower, i), 0, (1 << 31) - 1)
            for i in range(_FEISTEL_ROUNDS)]


def feistel_apply(k: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Evaluate the keyed Feistel permutation of [0, n) at positions ``idx``.

    ``feistel_apply(k, idx, n)[p] == feistel_permutation(k, n)[idx[p]]``,
    bitwise equal to the reference. Runs on ``idx``'s device and returns
    int64 (torch's index type; the reference returns int32 of the same
    values): on a CUDA tensor one launch of the cycle-walk kernel, which
    reads nothing back; on a CPU tensor its plain version
    (``kernels.feistel``). Runs inside a ``core.rng.feistel`` span; counts
    ``rng.feistel_calls``.
    """
    from ..kernels.feistel import feistel_walk

    if n < 2:
        return torch.zeros(idx.shape, dtype=torch.int64, device=idx.device)
    with span("core.rng.feistel"):
        count("rng.feistel_calls")
        return feistel_walk(idx, feistel_round_keys(k), feistel_bits(n), n)


def feistel_permutation(k: torch.Tensor, n: int,
                        device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """Pseudo-random permutation of ``arange(n)`` without a sort."""
    if n < 2:
        return torch.zeros((n,), dtype=torch.int64, device=device)
    return feistel_apply(k, torch.arange(n, dtype=torch.int64, device=device), n)
