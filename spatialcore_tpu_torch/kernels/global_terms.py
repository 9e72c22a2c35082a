"""Wrapper of the float global null's far-edge and degree-term kernel, and
its plain version.

``csrc/global_terms.cu`` computes, in one launch a draw of the bf16 / f32
global null (``ops.banded._banded_stat_float``), the two terms of the
draw's gathered table ``Zp`` that the band cross (K4, K5 or K6) leaves
out, both summed in float32:

    far[g] = Σ_e w_e · z[src_e, g] · z[dst_e, g]    over the far edges
    sq[g]  = Σ_i rc_i · z[B + i, g]²                Geary's degree term

``w_e`` rounded to the table's dtype first, as the reference's einsum in
the table dtype does; ``rc`` is the plan's r_i + c_i over its padded rows
(``plan.rc_sum``). ``sq`` is computed only with ``geary`` (the "geary" and
"moran_geary" statistics). The kernel replaces no Pallas kernel: the
reference leaves both terms to XLA.

The plain version, :func:`global_terms_plain`, is the port's torch-op
chain: float32 copies of the far rows, their product and a
:func:`~.band_cross.tree_sum` over the list, and ``rc @ z²`` on a float32
copy of the table. It takes the plan's far list as it is, padded to a
power-of-two capacity with zero weights; the kernel takes only its live
head. The two sum in different orders: they agree within 1e-5·Σ|terms|.

Operands: ``Zp`` [(Npad + 2B), G], bfloat16 or float32; ``far_src``,
``far_dst`` (rows of ``Zp``) and ``far_w`` [F]; ``rc_sum`` float32 [Npad].
For the kernel the far list is int32 rows and float32 weights, every entry
live (:func:`far_heads` makes them once a call). The wrapper checks
device, dtype, shape and contiguity, then:

* on a CPU tensor, runs the plain version;
* on a CUDA tensor, launches the kernel on the current stream and adds one
  to its mode in :data:`LAUNCHES` (``moran_bf16``, ``moran_f32``,
  ``geary_bf16``, ``geary_f32``; "geary" with the degree term) — or
  raises. There is no fallback. With no far edge and no degree term there
  is nothing to launch: the far term is zeros.

The CTAs' partial rows reduce inside the launch, in a fixed order, with an
integer ticket a gene tile to find the last CTA (:data:`_tickets`, one set
a stream, zero between launches): no float atomics, so two launches on the
same operands are bitwise equal, and a gene's value does not depend on G.

Precondition it does not check (a device read-back per launch): the far
rows lie in [0, Npad + 2B).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.profiling import CounterGroup
from . import build
from .band_cross import _SMS, tree_sum

#: kernel launches by statistic and table precision (the counters
#: ``kernels.global_terms.<mode>`` of ``utils.profiling``)
LAUNCHES = CounterGroup("kernels.global_terms",
                        ("moran_bf16", "moran_f32", "geary_bf16", "geary_f32"))

#: CTAs of a launch, per gene tile: two a SM (``__launch_bounds__(256, 2)``
#: in the source), one wave
CTAS = 2 * _SMS
#: 16-byte vectors of a gene tile (``kTileVecs``); a tile of element loads
#: holds as many genes
TILE_VECS = 64
_TABLE_DTYPES = (torch.float32, torch.bfloat16)
#: (device, stream) → int32 ticket counters, one a gene tile, zero between
#: launches (each launch's last CTA resets its tile's)
_tickets: dict = {}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def split_ctas(n_far: int, n_rows: int, geary: bool) -> Tuple[int, int]:
    """(far CTAs, degree CTAs) of a launch: :data:`CTAS` in all, split by
    the rows each kind reads (two an edge, one a table row). Depends on
    the plan alone, never on G, so each gene's sums run in one order at
    every width."""
    if not geary:
        return (CTAS if n_far else 0), 0
    if not n_far:
        return 0, CTAS
    far = round(CTAS * 2 * n_far / (2 * n_far + n_rows))
    far = min(CTAS - 1, max(1, far))
    return far, CTAS - far


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def global_terms_plain(Zp, far_src, far_dst, far_w, rc_sum, block: int,
                       geary: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of :func:`global_terms`, in torch ops on any device:
    ``(far, sq)``, ``sq`` None without ``geary``."""
    fs = Zp[far_src].to(torch.float32)
    ft = Zp[far_dst].to(torch.float32)
    fw = far_w.to(Zp.dtype).to(torch.float32)
    far = tree_sum(fw[:, None] * fs * ft)
    if not geary:
        return far, None
    z1 = Zp[block:block + rc_sum.shape[0]].to(torch.float32)
    return far, rc_sum @ (z1 * z1)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def far_heads(far_src, far_dst, far_w, n_live: int):
    """The kernel's far list from a plan's padded one whose first
    ``n_live`` entries are its live edges: int32 rows, float32 weights,
    contiguous."""
    return (far_src[:n_live].to(torch.int32).contiguous(),
            far_dst[:n_live].to(torch.int32).contiguous(),
            far_w[:n_live].to(torch.float32).contiguous())


def global_terms(Zp, far_src, far_dst, far_w, rc_sum, block: int,
                 geary: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One draw's far-edge cross and (``geary``) degree term of ``Zp``:
    ``(far float32 [G], sq float32 [G] or None)``. Operands as the module
    docstring says."""
    dev = Zp.device
    _check(dev.type in ("cpu", "cuda"), f"unsupported device {dev}")
    _check(Zp.ndim == 2 and Zp.shape[1] >= 1 and Zp.dtype in _TABLE_DTYPES,
           "Zp must be bfloat16 or float32 [(Npad + 2B), G]")
    _check(rc_sum.ndim == 1 and rc_sum.dtype == torch.float32,
           "rc_sum must be float32 [Npad]")
    n_rows, G = rc_sum.shape[0], Zp.shape[1]
    _check(block >= 1 and Zp.shape[0] == n_rows + 2 * block,
           f"Zp must have Npad + 2·block = {n_rows + 2 * block} rows")
    _check(far_src.ndim == 1 and far_dst.shape == far_src.shape
           and far_w.shape == far_src.shape, "far_src, far_dst and far_w "
           "must be one-dimensional and of one length")
    for t in (far_src, far_dst, far_w, rc_sum):
        _check(t.device == dev, "every operand must be on Zp's device")
    if dev.type == "cpu":
        return global_terms_plain(Zp, far_src, far_dst, far_w, rc_sum, block,
                                  geary)
    _check(far_src.dtype == torch.int32 and far_dst.dtype == torch.int32
           and far_w.dtype == torch.float32,
           "the kernel takes int32 far rows and float32 far weights "
           "(far_heads)")
    for name, t in (("Zp", Zp), ("far_src", far_src), ("far_dst", far_dst),
                    ("far_w", far_w), ("rc_sum", rc_sum)):
        _check(t.is_contiguous(), f"{name} must be contiguous")
    n_far = far_src.shape[0]
    far_ctas, sq_ctas = split_ctas(n_far, n_rows, geary)
    if far_ctas + sq_ctas == 0:
        return torch.zeros(G, dtype=torch.float32, device=dev), None
    esz = Zp.element_size()
    vec16 = (G * esz) % 16 == 0 and Zp.data_ptr() % 16 == 0
    n_tiles = -(-(G * esz // 16 if vec16 else G) // TILE_VECS)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        key = (dev, stream.cuda_stream)
        tickets = _tickets.get(key)
        if tickets is None or tickets.numel() < n_tiles:
            tickets = _tickets[key] = torch.zeros(max(n_tiles, 64),
                                                  dtype=torch.int32, device=dev)
        partial = torch.empty((far_ctas + sq_ctas, G), dtype=torch.float32,
                              device=dev)
        out = torch.empty((2, G), dtype=torch.float32, device=dev)
        err = build.load_library().sct_global_terms(
            Zp.data_ptr(), far_src.data_ptr(), far_dst.data_ptr(),
            far_w.data_ptr(), n_far, rc_sum.data_ptr(), n_rows, block,
            partial.data_ptr(), out.data_ptr(), tickets.data_ptr(), G,
            int(esz == 2), int(vec16), far_ctas, sq_ctas, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"global_terms launch failed: CUDA error {err}")
    LAUNCHES[f"{'geary' if geary else 'moran'}_{'bf16' if esz == 2 else 'f32'}"] += 1
    return out[0], (out[1] if geary else None)
