"""Wrapper of the Feistel cycle-walk kernel, and its plain version.

``csrc/feistel_walk.cu`` evaluates the keyed Feistel permutation of
``core.rng.feistel_apply`` at a tensor of positions: every value goes
through the balanced 8-round bijection on [0, 4**bits) until it lands in
[0, n), one thread a value, in one launch that reads nothing back. It
replaces no Pallas kernel (the JAX package's ``jax.lax.while_loop`` is one
compiled loop); the plain version, :func:`feistel_walk_plain`, runs each
pass as eager torch int64 ops over every value and reads one flag back a
pass.

* On a CPU tensor :func:`feistel_walk` returns the plain version.
* On a CUDA tensor it launches the kernel on the current stream and adds
  one to :data:`LAUNCHES` — or raises. There is no fallback.

Both give the same rows bitwise, and both count the walk's passes (the
longest walk of a call) in ``rng.feistel_passes``: the plain version a
pass at a time, the kernel on the device, in a running total per device
that the counters fold in when they are read (``utils.profiling``), never
inside a draw. That fold reads the total back, so reading the counters
waits for the walks already queued on the current stream.

Precondition the wrapper does not check (it would need a read-back):
``idx`` values lie in [0, n). A value outside it may walk a cycle that
never enters [0, n).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.rng import _FEISTEL_ROUNDS, _M32, _mul32
from ..utils import profiling
from ..utils.profiling import CounterGroup, count, read_back
from . import build

#: kernel launches (the counter ``kernels.feistel.walk`` of ``utils.profiling``)
LAUNCHES = CounterGroup("kernels.feistel", ("walk",))
#: device → int64 [3]: the running total of longest walks, the call's
#: longest walk and its blocks finished (the kernel's ``state``)
_totals: dict = {}
#: device → the part of its total already folded into the counters
_folded: dict = {}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _feistel_bijection(x: torch.Tensor, round_keys: Sequence[int],
                       bits: int) -> torch.Tensor:
    """Keyed bijection on [0, 4**bits) via a balanced 8-round Feistel network.

    ``x`` holds uint32 values in int64; ``round_keys`` are Python ints.
    Each evaluation is one cycle-walk pass (counter ``rng.feistel_passes``).
    """
    count("rng.feistel_passes")
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


def feistel_walk_plain(idx: torch.Tensor, round_keys: Sequence[int], bits: int,
                       n: int) -> torch.Tensor:
    """The cycle walk in torch int64 ops on ``idx``'s device: the bijection
    over every value, again over those still ≥ n, until none is; one flag
    read back a pass. Returns int64."""
    y = _feistel_bijection(idx.to(torch.int64), round_keys, bits)
    while True:
        out = y >= n
        if not bool(read_back(out.any())):
            return y
        y = torch.where(out, _feistel_bijection(y, round_keys, bits), y)


def feistel_walk(idx: torch.Tensor, round_keys: Sequence[int], bits: int,
                 n: int) -> torch.Tensor:
    """The Feistel permutation of [0, n) (domain [0, 4**bits), 2 ≤ n ≤
    4**bits, n < 2**32, bits ≤ 16) at the positions ``idx``: int64 of
    ``idx``'s shape on its device. The plain version on a CPU tensor, the
    kernel on a CUDA one."""
    if idx.dtype.is_floating_point or idx.dtype.is_complex or idx.dtype is torch.bool:
        raise ValueError(f"idx must hold integers, got {idx.dtype}")
    if not (1 <= bits <= 16 and 2 <= n <= min(1 << (2 * bits), _M32)):
        raise ValueError(f"n={n} must lie in [2, min(4**bits, 2**32 - 1)] with "
                         f"1 <= bits={bits} <= 16")
    if len(round_keys) != _FEISTEL_ROUNDS:
        raise ValueError(f"expected {_FEISTEL_ROUNDS} round keys, "
                         f"got {len(round_keys)}")
    if idx.device.type == "cpu":
        return feistel_walk_plain(idx, round_keys, bits, n)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    return _launch(idx.to(torch.int64).contiguous(), round_keys, bits, n)


def _launch(idx: torch.Tensor, round_keys: Sequence[int], bits: int,
            n: int) -> torch.Tensor:
    dev = idx.device
    with torch.cuda.device(dev):
        total = _totals.get(dev)
        if total is None:
            total = _totals[dev] = torch.zeros(3, dtype=torch.int64, device=dev)
            _folded[dev] = 0
        out = torch.empty_like(idx)
        lib = build.load_library()
        err = lib.sct_feistel_walk(idx.data_ptr(), out.data_ptr(), idx.numel(),
                                   *(int(k) & _M32 for k in round_keys), bits,
                                   n, total.data_ptr(),
                                   torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"feistel walk launch failed: CUDA error {err}")
    LAUNCHES["walk"] += 1
    return out


def _fold() -> None:
    """Add the passes the kernel counted since the last fold to
    ``rng.feistel_passes``: one read of each device's total, which waits
    for the walks queued on that device's current stream (the counters'
    own read, not the program's, so not a ``host_syncs``)."""
    for dev, total in _totals.items():
        seen = int(total[0])
        if seen != _folded[dev]:
            count("rng.feistel_passes", seen - _folded[dev])
            _folded[dev] = seen


profiling.fold_on_read(_fold)
