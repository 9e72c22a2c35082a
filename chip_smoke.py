"""One run of the PyTorch port's main paths on one CUDA GPU.

    python3 chip_smoke.py

Phases (the script stops with a non-zero exit at the first failure):

1. Device and build: the card's name and power limit (nvidia-smi), and the
   nvcc build of ``spatialcore_tpu_torch/csrc/*.cu`` (one nvcc per source,
   in parallel) with its time.
2. Each kernel against its plain PyTorch version, on the card, at B=256 on
   300 blocks of a real kNN plan at the 1M-cell density: the band-cross
   kernel (int4/int8 windowed far at G=4096, int8 band-only at G=4096,
   bf16 at G=1024, f32 at G=512; agreement within 1e-5·Σ|terms|) and the
   local statistics' draw-step kernel at G=1024 (LISA: row-pointer far
   with int8 and int16 counters, dense far, band only, and the observed
   entry; the geary tail and its observed entry; the getis_star and
   getis_g tails under every alternative, and the Getis observed entry;
   counts and observed values equal). Each with its time, its plain version's time,
   its bound on this card, and ``torch.sparse.mm`` of the band as a
   float32 CSR matrix against the float32 table as a library yardstick.
3. The global null's headline workload through the ops entry points:
   1,000,000 cells uniform on [0, 6000]², k=6, B=256; graph, null plan,
   standardize, observed I, int4 quantization and packing; then
   ``banded_permutation_test(precision="int4")`` over 8,192 genes as two
   4,096-gene tiles with draws chunked through ``draw_offset``, the plain
   version for 2 draws on one tile, a bitwise re-run of one chunk, and one
   int8 exact-far chunk (the band-only kernel).
4. The global public API: ``morans_i(null_method="banded_int8")`` and
   ``gearys_c(null_method="banded")`` on a SpatialData of 1,000,000 cells ×
   1,024 genes whose X is a CUDA tensor; and a small input against the
   port's CPU path. Proof of path: every band-cross kernel mode launched
   during phases 3–4.
5. Local Moran (LISA). The main path, with the launch counts set to 0
   just before it and read just after:
   ``local_morans_i(null_method="banded_int8", n_permutations=99)`` at
   1,000,000 cells × 1,024 genes (CUDA X, k=6) in ``output_mode="full"``
   and "compact" (compact p / p_adj / I equal to the full run's cast); it
   must launch the row-pointer draw step once per draw and the observed
   entry. Then the per-draw split by CUDA events, and the other routes,
   each with counts of its own: the reference vignette's shape (366,938
   cells, k=50, 128 genes, 99 draws) through local_morans_i's default
   route ("auto" -> the float32 null in torch ops), and the int8 null's
   dense-far route (``band_impl="pallas"``) against its row-pointer route
   ("auto"), counts bitwise equal; a plan without far edges (cells on a
   line: the band-only draw step); a small input on the card against the
   port's CPU path (p, p_adj, quadrants bitwise).
6. Local Geary and Getis-Ord, each main path with counts of its own:
   ``local_gearys_c(null="total", null_method="banded_int8",
   n_permutations=99)`` and ``getis_ord_gi(null_method="banded_int8",
   n_permutations=99)`` (Gi*, two-sided; raw non-negative counts with a
   smooth hot region) at 1,000,000 cells × 1,024 genes (CUDA X, k=6), full
   and compact (compact planes equal to the full run's casts); each must
   launch its draw step once per draw and its observed entry once per
   call. Then each one's per-draw split, Gi (``star=False``,
   ``alternative="greater"``) at 1M × 256 genes, both float32 routes at a
   shape where "auto" takes them (200,000 cells, k=16, 128 genes, no
   kernel), and 4,096 scattered cells on the card against the port's CPU
   path (p / p_sim, p_adj, hotspots bitwise).

The last line is ``{"ok": true, "device": {...}}``; the line before it a
JSON summary of every kernel, and the one before that nvidia-smi's name
and power limit. Without a CUDA device the script raises.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from spatialcore_tpu_torch import (SpatialData, build_spatial_weights,
                                   gearys_c, getis_ord_gi, local_gearys_c,
                                   local_morans_i, morans_i)
from spatialcore_tpu_torch.core.rng import feistel_apply, fold_in, key_for
from spatialcore_tpu_torch.kernels import band_cross as kern
from spatialcore_tpu_torch.kernels import build
from spatialcore_tpu_torch.kernels import lisa_count as kern_lisa
from spatialcore_tpu_torch.ops import banded
from spatialcore_tpu_torch.ops.banded import (banded_local_moran_pvalues,
                                              banded_permutation_test,
                                              build_null_plan)
from spatialcore_tpu_torch.ops.graph import build_graph
from spatialcore_tpu_torch.ops.moran import moran_observed, standardize
from spatialcore_tpu_torch.ops.streaming import tile_widths

B = 256
K = 6
SIDE = 6000.0
#: kernel vs plain: |Δcross_g| <= REL_TOL · Σ_i |term_i| (float32 summation
#: order only; the integer lags themselves are exact in both)
REL_TOL = 1e-5

KERNELS = {
    "int4_win": ("band_cross_int8 (int4 packed, windowed far)",
                 "spatialcore_tpu_torch/csrc/band_cross_int8.cu",
                 "spatialcore_tpu/ops/banded.py:1122"),
    "int8_win": ("band_cross_int8 (int8, windowed far)",
                 "spatialcore_tpu_torch/csrc/band_cross_int8.cu",
                 "spatialcore_tpu/ops/banded.py:987"),
    "int8_band": ("band_cross_int8 (int8, band only)",
                  "spatialcore_tpu_torch/csrc/band_cross_int8.cu",
                  "spatialcore_tpu/ops/banded.py:879"),
    "float": ("band_cross_float (bf16/f32)",
              "spatialcore_tpu_torch/csrc/band_cross_float.cu",
              "spatialcore_tpu/ops/banded.py:511"),
}
LISA_SRC = "spatialcore_tpu_torch/csrc/lisa_count_int8.cu"
LISA_KERNELS = {
    "lisa_win": ("lisa_count (draw step, row-pointer far; K7 moran tail)",
                 LISA_SRC, "spatialcore_tpu/ops/banded.py:1389"),
    "lisa_dense": ("lisa_count (draw step, dense far layer; K8)",
                   LISA_SRC, "spatialcore_tpu/ops/banded.py:1291"),
    "lisa_band": ("lisa_count (draw step, no far edges; K8 without far)",
                  LISA_SRC, "spatialcore_tpu/ops/banded.py:1291"),
    "lisa_obs": ("lisa_observed (observed |z*lag|; the XLA abs_ip pass)",
                 LISA_SRC, "spatialcore_tpu/ops/banded.py:2369"),
    "geary_win": ("geary_count (draw step, row-pointer far; K7 geary tail)",
                  LISA_SRC, "spatialcore_tpu/ops/banded.py:1497"),
    "geary_obs": ("geary_observed (observed geary value; the XLA geary_q pass)",
                  LISA_SRC, "spatialcore_tpu/ops/banded.py:2899"),
    "getis_star_win": ("getis_star_count (draw step, row-pointer far; K7 "
                       "getis_star tail)", LISA_SRC,
                       "spatialcore_tpu/ops/banded.py:1517"),
    "getis_g_win": ("getis_g_count (draw step, row-pointer far; K7 getis_g tail)",
                    LISA_SRC, "spatialcore_tpu/ops/banded.py:1535"),
    "getis_obs": ("getis_lag (observed binary lag; the XLA lag_me_q pass)",
                  LISA_SRC, "spatialcore_tpu/ops/banded.py:3184"),
}
#: the card's published peaks (H100 SXM data sheet): HBM bytes/s, and
#: operations/s of the unit that could do each kernel's work
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def timed(fn, dev, reps: int = 1):
    """(result of the last call, mean seconds per call); synchronised."""
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync(dev)
    return out, (time.perf_counter() - t0) / reps


def event_ms(fn, reps: int) -> float:
    """Mean milliseconds per call by CUDA events, after two warm-up calls
    (NaN without a card: a CPU rehearsal of the phases times nothing)."""
    for _ in range(2):
        fn()
    if not torch.cuda.is_available():
        return float("nan")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def uniform_coords(n: int, side: float, gen, dev) -> torch.Tensor:
    return torch.rand((n, 2), generator=gen, device=dev) * side


def bound(nbytes: float, ops, unit: str = ""):
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the HBM rate and the operations over the unit's peak
    (``ops`` a count on ``unit``, or {unit: count} for mixed work, whose
    times add)."""
    if not isinstance(ops, dict):
        ops = {unit: ops}
    tb = nbytes / HBM_BYTES_PER_S
    to = sum(count / PEAK_OPS[u] for u, count in ops.items())
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def cross_work(plan, mode: str, G: int):
    """(bytes, operations, unit) one band-cross call must move and compute
    on ``plan`` at G genes: each input read once (the gathered table, the
    live far values, the compact band, row scales), the [G] output written
    once; a multiply-add per band slot, live far edge and row value."""
    n, k = plan.local_idx.shape
    nnz = int((plan.w_local != 0).sum())
    if mode in ("bf16", "f32"):
        esz = 2 if mode == "bf16" else 4
        return ((n + 2 * B) * G * esz + n * k * (4 + esz) + 4 * G,
                2 * (nnz + n) * G, mode)
    cols = G // 2 if mode == "int4_win" else G
    n_live = int(plan.far_starts[-1]) if mode != "int8_band" else 0
    far = n_live * (cols + 1) + 4 * (n + 1) if n_live else 0
    return ((n + 2 * B) * cols + n * k * 5 + 4 * n + 4 * G + far,
            2 * (nnz + n_live + n) * G, "int8")


def lisa_work(plan, G: int, far_form: str, cnt_bytes: int = 1,
              observed: bool = False):
    """(bytes, operations, unit) of one LISA draw step (or the observed
    pass) on ``plan`` at G genes: gathered codes, compact band and far
    operands read once; int32 obs read and the counters read and written
    (or the int32 output written); a multiply-add per band slot and live
    far edge, and the |z·lag| test per value."""
    n, k = plan.local_idx.shape
    nnz = int((plan.w_local != 0).sum())
    n_live = banded._n_live_far(plan)
    far_in = {"rows": 4 * (n + 1) + n_live * (G + 1), "dense": 4 * n * G,
              "none": 0}[far_form]
    planes = 4 * n * G if observed else 4 * n * G + 2 * cnt_bytes * n * G
    far_ops = n_live if far_form == "rows" else 0
    return ((n + 2 * B) * G + n * k * 5 + far_in + planes,
            2 * (nnz + far_ops) * G + (2 if observed else 4) * n * G, "int8")


def tail_work(plan, G: int, mode: str):
    """(bytes, {unit: operations}, "") of one draw step (or observed pass) of
    the geary / Getis tails on ``plan`` at G genes: gathered codes, compact
    band, far row pointers and values read once; the per-stat planes
    (int32 or f32 observed, int8 counters read and written, Gi's observed
    lag and own codes) and vectors; a multiply-add per band slot and live
    far edge per lag (two lags for geary), and the tail per value."""
    n, k = plan.local_idx.shape
    nnz = int((plan.w_local != 0).sum())
    n_live = banded._n_live_far(plan)
    common = (n + 2 * B) * G + n * k * 5 + 4 * (n + 1) + n_live * (G + 1)
    lag_ops = 2 * (nnz + n_live) * G
    plane = {"geary_win": 4 * n * G + 2 * n * G + 4 * n,
             "geary_obs": 4 * n * G + 4 * n,
             "getis_star_win": 4 * n * G + 2 * n * G + 4 * n + 4 * G,
             "getis_g_win": 9 * n * G + 2 * n * G + 4 * n + 8 * G,
             "getis_obs": 4 * n * G}[mode]
    ops = {"int8": (2 if mode.startswith("geary") else 1) * lag_ops
           + 6 * n * G}
    if mode == "getis_g_win":
        ops["f32"] = 14 * n * G
    elif mode == "getis_star_win":
        ops["f32"] = 5 * n * G
    return common + plane, ops, ""


def band_csr(plan, dev):
    """The band as a float32 CSR matrix [Npad, (nb+2)·B] over the padded
    value table (the library yardstick's operand)."""
    n_rows, k = plan.local_idx.shape
    rows = torch.arange(n_rows, device=dev).repeat_interleave(k)
    cols = (rows // B) * B + plan.local_idx.reshape(-1)
    vals = plan.w_local.reshape(-1)
    keep = vals != 0
    with warnings.catch_warnings():     # sparse CSR "in beta" notices
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(torch.stack([rows[keep], cols[keep]]),
                                      vals[keep], (n_rows, n_rows + 2 * B))
        return coo.coalesce().to_sparse_csr()


def library_ms(csr, table, reps: int = 10):
    """torch.sparse.mm (cuSPARSE SpMM) of the band against the float32
    table: the band lag alone, the nearest one-call yardstick."""
    zf = table.to(torch.float32)
    return event_ms(lambda: torch.sparse.mm(csr, zf), reps)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def real_plan(dev, n_blocks: int, gen, k: int = K):
    """A kNN plan of ``n_blocks`` blocks at the 1M-cell density."""
    n = n_blocks * B
    coords = uniform_coords(n, SIDE * (n / 1e6) ** 0.5, gen, dev)
    return build_null_plan(build_graph(coords, n_neighbors=k, device=dev),
                           coords, block=B)


def kernel_cases(dev, plan, gen, widths):
    """Operands of every band-cross kernel mode on ``plan``. Yields
    (mode, label, kernel_fn, plain_fn, scale_fn, nbytes, ops, unit, table):
    scale_fn gives Σ_i |term_i| per gene for the tolerance; nbytes / ops
    are what one call must move and compute; table is the value table the
    library yardstick multiplies."""
    n_blocks = plan.n_padded // B
    n = plan.n_padded
    rows_idx = torch.arange((n_blocks + 2) * B, device=dev) - B
    rows_idx = plan.order[rows_idx.clamp(0, plan.n - 1)]
    li = plan.local_idx.to(torch.int32)
    for mode, G in widths.items():
        if mode in ("bf16", "f32"):
            dt = torch.bfloat16 if mode == "bf16" else torch.float32
            zp = torch.randn(((n_blocks + 2) * B, G), generator=gen,
                             device=dev).to(dt)
            w = plan.w_local.to(dt)

            def scale(zp=zp, w=w):
                lag = kern.band_lag_float_plain(li, w.abs(), zp.abs(), B)
                return (zp[B:B + n].abs().float() * lag).double().sum(0)

            yield ("float", f"{mode} G={G}",
                   lambda zp=zp, w=w: kern.band_cross_float(li, w, zp, B),
                   lambda zp=zp, w=w: kern.band_cross_float_plain(li, w, zp, B),
                   scale, *cross_work(plan, mode, G), zp)
            continue
        packed = mode == "int4_win"
        far_mode = "exact" if mode == "int8_band" else "win"
        ops, _ = banded._int_ops(plan, "int4" if packed else "int8", far_mode,
                                 rows_idx, use_plain=False)
        lim = 7 if packed else 127
        cols = G // 2 if packed else G

        def codes(rows):
            c = torch.randint(-lim, lim + 1, (rows, G), generator=gen,
                              device=dev, dtype=torch.int8)
            return banded._pack_codes(c) if packed else c

        zp = codes((n_blocks + 2) * B)
        far = {}
        if ops.win:
            S, nw = ops.win_ops[0], ops.win_ops[1]
            far = dict(far_row_ptr=ops.far_ptr,
                       far_q=ops.win_ops[3].reshape(-1).contiguous(),
                       Zf=codes(nw * S))
        sw = ops.sw.reshape(-1).contiguous()
        check(zp.shape[1] == cols, "packed width")

        def scale(zp=zp, far=far, sw=sw, packed=packed):
            def absc(t):
                return (banded._pack_codes(kern.unpack_nibbles(t).abs())
                        if packed else t.abs())
            fabs = dict(far, Zf=absc(far["Zf"])) if far else {}
            return kern.band_cross_int8_plain(li, ops.wq, sw, absc(zp), B,
                                              packed=packed, **fabs).double()

        table = kern.unpack_nibbles(zp) if packed else zp
        yield (mode, f"{mode} G={G}",
               lambda zp=zp, far=far, sw=sw, packed=packed: kern.band_cross_int8(
                   li, ops.wq, sw, zp, B, packed=packed, **far),
               lambda zp=zp, far=far, sw=sw, packed=packed: kern.band_cross_int8_plain(
                   li, ops.wq, sw, zp, B, packed=packed, **far),
               scale, *cross_work(plan, mode, G), table)


def report(results, mode, label, err, ms, plain_ms, nbytes, ops, unit, lib_ms,
           first: bool = True):
    """Print one kernel line and keep its numbers (the first case of a mode
    gives its times; every case adds to its largest error)."""
    b_ms, b_by = bound(nbytes, ops, unit)
    n_ops = sum(ops.values()) if isinstance(ops, dict) else ops
    print(f"[kernels] {label}: max_abs_err={err:.3e} kernel {ms:.4f} ms  plain "
          f"{plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e9:.4f} GB, "
          f"{n_ops / 1e9:.3f} Gop)  library {lib_ms:.4f} ms")
    old = results.get(mode)
    if old is None or first:
        results[mode] = dict(max_abs_err=max(err, old["max_abs_err"] if old else 0.0),
                             ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib_ms)
    else:
        old["max_abs_err"] = max(old["max_abs_err"], err)


def phase_kernels(dev, plan, gen, widths, reps: int):
    """Band-cross kernels vs plain on the card; returns {mode: numbers}."""
    results = {}
    csr = band_csr(plan, dev)
    for (mode, label, kfn, pfn, scale_fn, nbytes, ops, unit,
         table) in kernel_cases(dev, plan, gen, widths):
        got, want = kfn(), pfn()
        sync(dev)
        err = (got.double() - want.double()).abs()
        tol = REL_TOL * scale_fn() + 1e-30
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite cross")
        check(bool((err <= tol).all()),
              f"{label}: kernel disagrees with plain (max err "
              f"{float(err.max()):.3e}, bound {float(tol.min()):.3e})")
        ms, plain_ms = event_ms(kfn, reps), event_ms(pfn, max(1, reps // 5))
        lib = library_ms(csr, table)
        report(results, mode, f"{label} (tolerance {REL_TOL:g}·Σ|terms|)",
               float(err.max()), ms, plain_ms, nbytes, ops, unit, lib,
               first=mode != "float" or label.startswith("bf16"))
    return results


def phase_lisa_kernels(dev, plan, gen, G: int, reps: int):
    """The LISA kernel's modes against its plain version on the card:
    counts and observed values must be equal. Returns {mode: numbers}."""
    nbk = plan.n_padded // B
    n = plan.n_padded
    wq, _, far_q = banded._full_row_codes(plan)
    li = plan.local_idx.to(torch.int32).contiguous()
    n_live = banded._n_live_far(plan)
    ptr = banded._row_ptr(plan.far_src, n_live, B, n)
    fq8 = far_q[:n_live].to(torch.int8).contiguous()
    src, dst = plan.far_src[:n_live] - B, plan.far_dst[:n_live]

    def codes(rows):
        return torch.randint(-127, 128, (rows, G), generator=gen, device=dev,
                             dtype=torch.int8)

    def dense(zp):
        layer = torch.zeros((n, G), dtype=torch.int32, device=dev)
        return layer.index_add_(0, src, zp[dst].to(torch.int32)
                                * far_q[:n_live].to(torch.int32)[:, None])

    zp, zf = codes(n + 2 * B), codes(n_live)
    rows_far = dict(far_row_ptr=ptr, far_q=fq8, Zf=zf)
    # observed values of another placement: draws that tie, win and lose
    obs = kern_lisa.lisa_observed_plain(li, wq, codes(n + 2 * B), B,
                                        far_row_ptr=ptr, far_q=fq8,
                                        Zf=codes(n_live))
    cases = [("lisa_win", "rows", torch.int8, rows_far),
             ("lisa_win", "rows", torch.int16, rows_far),
             ("lisa_dense", "dense", torch.int8, dict(far=dense(zp))),
             ("lisa_band", "none", torch.int8, {})]
    csr = band_csr(plan, dev)
    lib = library_ms(csr, zp)
    results = {}
    for mode, form, cdt, far in cases:
        cnt0 = torch.randint(0, 60, (n, G), generator=gen, device=dev).to(cdt)
        got = kern_lisa.lisa_count(li, wq, zp, B, obs, cnt0.clone(), **far)
        want = kern_lisa.lisa_count_plain(li, wq, zp, B, obs, cnt0.clone(), **far)
        sync(dev)
        err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        check(torch.equal(got, want), f"{mode} {cdt}: counts differ from plain "
              f"(max |diff| {err})")
        moved = (int((got != cnt0).sum()))
        check(0 < moved < got.numel(), f"{mode}: degenerate comparison case")
        scratch = cnt0.clone()
        ms = event_ms(lambda: kern_lisa.lisa_count(li, wq, zp, B, obs, scratch,
                                                   **far), reps)
        plain_ms = event_ms(lambda: kern_lisa.lisa_count_plain(
            li, wq, zp, B, obs, scratch, **far), max(1, reps // 10))
        report(results, mode, f"{mode} {str(cdt)[6:]} counters G={G} "
               f"({nbk} blocks, {moved:,} counts moved; equal)", err, ms,
               plain_ms, *lisa_work(plan, G, form, cnt0.element_size()), lib,
               first=cdt == torch.int8)
    got = kern_lisa.lisa_observed(li, wq, zp, B, **rows_far)
    want = kern_lisa.lisa_observed_plain(li, wq, zp, B, **rows_far)
    sync(dev)
    err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    check(torch.equal(got, want), f"lisa_obs: observed differs from plain ({err})")
    ms = event_ms(lambda: kern_lisa.lisa_observed(li, wq, zp, B, **rows_far), reps)
    plain_ms = event_ms(lambda: kern_lisa.lisa_observed_plain(
        li, wq, zp, B, **rows_far), max(1, reps // 10))
    report(results, "lisa_obs", f"lisa_obs G={G} ({nbk} blocks; equal)", err,
           ms, plain_ms, *lisa_work(plan, G, "rows", observed=True), lib)
    return results


def tail_operands(plan, gen, G: int, dev):
    """Operands of the geary and Getis entries on ``plan`` at G genes:
    full-row weight codes and the total weight code (geary), 0/1 codes and
    W (Getis), the far list as row pointers; random codes (non-negative
    for Getis), and an observed placement of other codes."""
    n = plan.n_padded
    li = plan.local_idx.to(torch.int32).contiguous()
    n_live = banded._n_live_far(plan)
    ptr = banded._row_ptr(plan.far_src, n_live, B, n)
    src = plan.far_src[:n_live] - B
    wq, _, far_q = banded._full_row_codes(plan)
    w_code = wq.to(torch.int32).sum(1, dtype=torch.int32).index_add_(
        0, src, far_q[:n_live].to(torch.int32))
    wb = (plan.w_local > 0).to(torch.int8)
    ones = torch.ones(n_live, dtype=torch.int32, device=dev)
    w_bin = wb.to(torch.int32).sum(1, dtype=torch.int32).index_add_(
        0, src, ones).to(torch.float32)

    def codes(rows, lo):
        return torch.randint(lo, 128, (rows, G), generator=gen, device=dev,
                             dtype=torch.int8)

    geary = dict(li=li, w=wq, zp=codes(n + 2 * B, -127), other=codes(n + 2 * B, -127),
                 far=dict(far_row_ptr=ptr, far_q=far_q[:n_live].to(torch.int8),
                          Zf=codes(n_live, -127)),
                 far_other=dict(far_row_ptr=ptr,
                                far_q=far_q[:n_live].to(torch.int8),
                                Zf=codes(n_live, -127)))
    getis = dict(li=li, w=wb, zp=codes(n + 2 * B, 0), other=codes(n + 2 * B, 0),
                 far=dict(far_row_ptr=ptr, far_q=ones.to(torch.int8),
                          Zf=codes(n_live, 0)),
                 far_other=dict(far_row_ptr=ptr, far_q=ones.to(torch.int8),
                                Zf=codes(n_live, 0)))
    return geary, w_code, getis, w_bin


def phase_tail_kernels(dev, plan, gen, G: int, reps: int):
    """The geary, getis_star and getis_g tails and the two observed
    entries against their plain versions on the card: counts and observed
    values must be equal (getis_star and getis_g under every alternative;
    the two-sided case gives the mode's times). Returns {mode: numbers}."""
    nbk = plan.n_padded // B
    n = plan.n_padded
    ge, w_code, gt, w_bin = tail_operands(plan, gen, G, dev)
    lib = library_ms(band_csr(plan, dev), ge["zp"])
    results = {}

    def equal(mode, label, got, want, first=True, moved=None):
        sync(dev)
        err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        check(torch.equal(got, want), f"{label}: differs from plain (max |diff| "
              f"{err})")
        if moved is not None:
            check(0 < moved < got.numel(), f"{label}: degenerate comparison case")
        return err

    def timed_pair(kfn, pfn):
        return event_ms(kfn, reps), event_ms(pfn, max(1, reps // 10))

    # geary: observed entry, then the draw step against another placement
    args = (ge["li"], ge["w"], ge["zp"], B)
    obs = kern_lisa.geary_observed_plain(ge["li"], ge["w"], ge["other"], B, w_code,
                                         **ge["far_other"])
    got = kern_lisa.geary_observed(*args, w_code, **ge["far"])
    want = kern_lisa.geary_observed_plain(*args, w_code, **ge["far"])
    err = equal("geary_obs", "geary_obs", got, want)
    ms, pms = timed_pair(lambda: kern_lisa.geary_observed(*args, w_code, **ge["far"]),
                         lambda: kern_lisa.geary_observed_plain(*args, w_code,
                                                                **ge["far"]))
    report(results, "geary_obs", f"geary_obs G={G} ({nbk} blocks; equal)", err,
           ms, pms, *tail_work(plan, G, "geary_obs"), lib)
    cnt0 = torch.randint(0, 60, (n, G), generator=gen, device=dev).to(torch.int8)
    got = kern_lisa.geary_count(*args, obs, cnt0.clone(), w_code, **ge["far"])
    want = kern_lisa.geary_count_plain(*args, obs, cnt0.clone(), w_code, **ge["far"])
    moved = int((got != cnt0).sum())
    err = equal("geary_win", "geary_win", got, want, moved=moved)
    scratch = cnt0.clone()
    ms, pms = timed_pair(
        lambda: kern_lisa.geary_count(*args, obs, scratch, w_code, **ge["far"]),
        lambda: kern_lisa.geary_count_plain(*args, obs, scratch, w_code, **ge["far"]))
    report(results, "geary_win", f"geary_win int8 counters G={G} ({nbk} blocks, "
           f"{moved:,} counts moved; equal)", err, ms, pms,
           *tail_work(plan, G, "geary_win"), lib)

    # Getis: the binary-lag observed entry, then Gi* and Gi draw steps
    args = (gt["li"], gt["w"], gt["zp"], B)
    got = kern_lisa.getis_lag(*args, **gt["far"])
    want = kern_lisa.getis_lag_plain(*args, **gt["far"])
    err = equal("getis_obs", "getis_obs", got, want)
    ms, pms = timed_pair(lambda: kern_lisa.getis_lag(*args, **gt["far"]),
                         lambda: kern_lisa.getis_lag_plain(*args, **gt["far"]))
    report(results, "getis_obs", f"getis_obs G={G} ({nbk} blocks; equal)", err,
           ms, pms, *tail_work(plan, G, "getis_obs"), lib)
    lag_o = kern_lisa.getis_lag_plain(gt["li"], gt["w"], gt["other"], B,
                                      **gt["far_other"])
    me_o = gt["other"][B:B + n].contiguous()
    codes = gt["zp"][B:B + plan.n].to(torch.int64)
    tot = codes.sum(0).to(torch.float32)
    sq = (codes * codes).sum(0).to(torch.float32)
    for star, mode, fn, pfn in (
            (True, "getis_star_win", kern_lisa.getis_star_count,
             kern_lisa.getis_star_count_plain),
            (False, "getis_g_win", kern_lisa.getis_g_count,
             kern_lisa.getis_g_count_plain)):
        inv_m = banded._inv_m(plan.n, star)
        for alt in ("two-sided", "greater", "less"):
            if star:
                obs = lag_o + me_o.to(torch.int32)
                kw = (dict(wp1=w_bin + 1.0, tm=tot * inv_m)
                      if alt == "two-sided" else {})
            else:
                obs = kern_lisa.gi_center(lag_o, me_o, w_bin, tot, sq, inv_m)
                kw = dict(w_row=w_bin, tot=tot, sq=sq, inv_m=inv_m, lag_o=lag_o,
                          me_o=me_o)
            got = fn(*args, obs, cnt0.clone(), alternative=alt, **gt["far"], **kw)
            want = pfn(*args, obs, cnt0.clone(), alternative=alt, **gt["far"], **kw)
            moved = int((got != cnt0).sum())
            err = equal(mode, f"{mode} {alt}", got, want, moved=moved)
            ms = pms = float("nan")
            if alt == "two-sided":
                scratch = cnt0.clone()
                ms, pms = timed_pair(
                    lambda: fn(*args, obs, scratch, alternative=alt, **gt["far"],
                               **kw),
                    lambda: pfn(*args, obs, scratch, alternative=alt,
                                **gt["far"], **kw))
            report(results, mode, f"{mode} {alt} int8 counters G={G} ({nbk} "
                   f"blocks, {moved:,} counts moved; equal)", err, ms, pms,
                   *tail_work(plan, G, mode), lib, first=alt == "two-sided")
    return results


# ---------------------------------------------------------------------------
# Phase 3: the headline workload through the ops entry points
# ---------------------------------------------------------------------------


def signal_genes(width: int, chunk: int = 1024) -> torch.Tensor:
    """Genes given a smooth spatial signal: the first eighth of each chunk."""
    cw = min(chunk, width)
    return (torch.arange(width) % cw) < cw // 8


def prep_tile(graph, coords, S0: float, width: int, gen, dev, chunk: int = 1024):
    """Random expression for one gene tile, prepped in 1024-gene chunks:
    int4 codes packed over the full tile (packed column j pairs genes j and
    j + width/2), f32 den = Σz², observed I, per-gene scale; also the int8
    codes of the tile for the band-only check. The first eighth of each
    chunk carries a smooth spatial signal."""
    cw = min(chunk, width)
    codes4, codes8, s8, dens, obs, s4 = [], [], [], [], [], []
    wave = torch.sin(coords[:, :1] / 300.0)
    for _ in range(width // cw):
        X = torch.randn((graph.n_cells, cw), generator=gen, device=dev)
        X[:, :cw // 8] += wave
        Z, _ = standardize(X)
        del X
        den = (Z * Z).sum(dim=0)
        dens.append(torch.where(den > 0, den, torch.ones_like(den)))
        obs.append(moran_observed(graph, Z, S0))
        c, s = banded._quantize_z4_codes(Z)
        codes4.append(c)
        s4.append(s)
        q8, sq8 = banded._quantize_z(Z)
        codes8.append(q8)
        s8.append(sq8)
        del Z
    return dict(Zpk=banded._pack_codes(torch.cat(codes4, dim=1)),
                den=torch.cat(dens), obs=torch.cat(obs), sz=torch.cat(s4),
                Zq8=torch.cat(codes8, dim=1), sz8=torch.cat(s8))


def phase_workload(dev, n_cells: int, n_genes: int, tile: int, n_perms: int,
                   chunk: int, gen):
    out = {}
    coords = uniform_coords(n_cells, SIDE, gen, dev)
    graph, t = timed(lambda: build_graph(coords, n_neighbors=K, device=dev), dev)
    out["graph_s"] = t
    plan, t = timed(lambda: build_null_plan(graph, coords, block=B), dev)
    out["plan_s"] = t
    print(f"[workload] {n_cells:,} cells k={K}: graph {out['graph_s']:.3f} s, "
          f"plan {out['plan_s']:.3f} s (far edges "
          f"{int(plan.far_starts[-1]):,}, far_bmax {plan.far_bmax})")
    S0 = float(n_cells)        # row-normalized kNN: every row sums to 1
    widths = tile_widths(n_genes, tile)
    for mode, G in (("int4_win", tile), ("int8_win", 1024), ("int8_band", tile),
                    ("bf16", 1024), ("f32", 1024)):
        b_ms, by = bound(*cross_work(plan, mode, G))
        print(f"[bound] {mode}, one draw of {G} genes at {n_cells:,} cells: "
              f"{b_ms:.4f} ms ({by})")
    p_all, draw_s, prep_s = [], 0.0, 0.0
    first = None
    for ti, width in enumerate(widths):
        prep, t = timed(lambda: prep_tile(graph, coords, S0, width, gen, dev), dev)
        prep_s += t
        counts = torch.zeros(width, device=dev)
        for off in range(0, n_perms, chunk):
            pc = min(chunk, n_perms - off)
            (p, mean, std), t = timed(lambda: banded_permutation_test(
                plan, prep["Zpk"], S0, prep["obs"], 0, pc, precision="int4",
                den=prep["den"], sz=prep["sz"], draw_offset=off), dev)
            draw_s += t
            counts += torch.round(p * (pc + 1) - 1)
            if ti == 0 and off == 0:
                first = (pc, p.clone())
        p_tile = (counts + 1) / (n_perms + 1)
        check(bool(((p_tile > 0) & (p_tile <= 1)).all()), "p outside (0, 1]")
        p_all.append(p_tile)
        if ti == 0:
            tile0 = prep
        else:
            del prep
    # bitwise reproducibility of one chunk
    pc, p_first = first
    p_again = banded_permutation_test(plan, tile0["Zpk"], S0, tile0["obs"], 0,
                                      pc, precision="int4", den=tile0["den"],
                                      sz=tile0["sz"], draw_offset=0)[0]
    check(torch.equal(p_again, p_first), "re-run chunk differs bitwise")
    # plain version, 2 draws on one tile, against the kernel's 2 draws
    (p_plain, _, _), t_plain = timed(lambda: banded_permutation_test(
        plan, tile0["Zpk"], S0, tile0["obs"], 0, 2, precision="int4",
        den=tile0["den"], sz=tile0["sz"], band_impl="xla"), dev)
    (p_k2, _, _), t_k2 = timed(lambda: banded_permutation_test(
        plan, tile0["Zpk"], S0, tile0["obs"], 0, 2, precision="int4",
        den=tile0["den"], sz=tile0["sz"]), dev)
    dc = (torch.round(p_plain * 3 - 1) - torch.round(p_k2 * 3 - 1)).abs()
    check(float(dc.max()) <= 1, "kernel and plain counts differ by > 1 draw")
    # int8 with exact far edges (band-only kernel) against int8 windowed far
    (p8x, _, _), t8x = timed(lambda: banded_permutation_test(
        plan, tile0["Zq8"], S0, tile0["obs"], 0, 4, precision="int8",
        den=tile0["den"], sz=tile0["sz8"], far_mode="exact"), dev)
    (p8w, _, _), t8w = timed(lambda: banded_permutation_test(
        plan, tile0["Zq8"], S0, tile0["obs"], 0, 4, precision="int8",
        den=tile0["den"], sz=tile0["sz8"], far_mode="win"), dev)
    dc8 = (torch.round(p8x * 5 - 1) - torch.round(p8w * 5 - 1)).abs()
    check(float(dc8.max()) <= 1, "int8 exact-far and windowed-far counts differ")
    p_cat = torch.cat(p_all)[:n_genes]
    mask = torch.cat([signal_genes(len(p)) for p in p_all]).to(dev)
    sig, noise = torch.cat(p_all)[mask], torch.cat(p_all)[~mask]
    p_min = 1.0 / (n_perms + 1) + 1e-6
    out.update(prep_s=prep_s, draw_s=draw_s, n_draw_calls=len(widths) * n_perms,
               gpps=n_genes * n_perms / draw_s,
               plain_draw_s=t_plain / 2, kernel_2draw_s=t_k2 / 2,
               int8_exact_draw_s=t8x / 4, int8_win_draw_s=t8w / 4)
    print(f"[workload] {n_genes:,} genes as tiles {widths} x {n_perms} draws "
          f"(chunks of {chunk}): prep {prep_s:.3f} s, draws {draw_s:.3f} s -> "
          f"{out['gpps']:.1f} genes*perms/s; per draw per tile "
          f"{draw_s / (len(widths) * n_perms) * 1e3:.2f} ms (call set-up "
          f"included)")
    print(f"[workload] one {widths[0]}-gene tile, 2 draws per call: kernel "
          f"{out['kernel_2draw_s'] * 1e3:.2f} ms/draw, plain "
          f"{out['plain_draw_s'] * 1e3:.2f} ms/draw; int8 4 draws: exact far "
          f"{out['int8_exact_draw_s'] * 1e3:.2f} ms/draw, windowed far "
          f"{out['int8_win_draw_s'] * 1e3:.2f} ms/draw (set-up included)")
    print(f"[workload] p in (0,1]: min {float(p_cat.min()):.4f} max "
          f"{float(p_cat.max()):.4f}; signal genes at p=1/(P+1): "
          f"{float((sig <= p_min).float().mean()):.3f}; noise genes mean p "
          f"{float(noise.mean()):.3f}; "
          f"re-run chunk bitwise equal")
    check(float((sig <= p_min).float().mean()) > 0.9,
          "spatially smooth genes not at the smallest p")
    return out


# ---------------------------------------------------------------------------
# Phase 4: the public API
# ---------------------------------------------------------------------------


def make_adata(n_cells: int, n_genes: int, gen, dev) -> SpatialData:
    coords = uniform_coords(n_cells, SIDE, gen, dev)
    X = torch.randn((n_cells, n_genes), generator=gen, device=dev)
    X[:, :n_genes // 8] += torch.sin(coords[:, :1] / 300.0)
    d = SpatialData(X=X)
    d.obsm["spatial"] = coords
    return d


def phase_public(dev, n_cells: int, n_genes: int, n_perms: int, gen):
    d = make_adata(n_cells, n_genes, gen, dev)
    out = {}
    for fn, kw, col in ((morans_i, dict(null_method="banded_int8"), "I"),
                        (gearys_c, dict(null_method="banded",
                                        use_existing_graph=True), "C")):
        _, t = timed(lambda: fn(d, n_permutations=n_perms, seed=1,
                                gene_batch_size=1024, device=dev, **kw), dev)
        df = d.uns[fn.__name__]
        check(len(df) == n_genes and list(df.columns)[1] == col, "output shape")
        check(bool(np.isfinite(df[col]).all() and np.isfinite(df["z_score"]).all()),
              "non-finite statistic")
        p = df["p_value"].to_numpy()
        check(bool(((p > 0) & (p <= 1)).all()), "p outside (0, 1]")
        sig = p[:n_genes // 8]
        check(float((sig <= 1 / (n_perms + 1) + 1e-9).mean()) > 0.9,
              f"{fn.__name__}: smooth genes not significant")
        out[fn.__name__] = t
        print(f"[public] {fn.__name__}({kw['null_method']}) {n_cells:,} cells x "
              f"{n_genes} genes x {n_perms} draws: {t:.3f} s; signal "
              f"{col} mean {df[col][:n_genes // 8].mean():.4f}, noise "
              f"{col} mean {df[col][n_genes // 8:].mean():.4f}, noise mean p "
              f"{p[n_genes // 8:].mean():.3f}")
    return out


def phase_small_reference(dev, gen):
    """Small input on the card against the port's CPU path (plain versions)."""
    d = make_adata(3000, 64, gen, dev)
    h = SpatialData(X=d.X.cpu())
    h.obsm["spatial"] = d.obsm["spatial"].cpu()
    for fn, nm in ((morans_i, "banded_int8"), (gearys_c, "banded")):
        fn(d, n_permutations=19, seed=2, null_method=nm, device=dev)
        fn(h, n_permutations=19, seed=2, null_method=nm, device="cpu")
        a, b = d.uns[fn.__name__], h.uns[fn.__name__]
        col = "I" if fn is morans_i else "C"
        check(np.allclose(a[col], b[col], rtol=1e-5, atol=1e-7),
              f"{fn.__name__} statistic differs from the CPU path")
        check(float(np.abs(a["p_value"] - b["p_value"]).max()) <= 0.05 + 1e-6,
              f"{fn.__name__} p differs from the CPU path by more than a draw")
    print("[public] 3,000 x 64 on the card equals the CPU path (I/C rtol 1e-5, "
          "p within one of 20 draws)")


# ---------------------------------------------------------------------------
# Phase 5: local Moran (LISA)
# ---------------------------------------------------------------------------


def lisa_adata(n_cells: int, n_genes: int, gen, dev) -> SpatialData:
    """1M-density uniform cells; the first eighth of the genes carry a
    strong smooth signal (8·sin(x/300) over unit noise)."""
    coords = uniform_coords(n_cells, SIDE * (n_cells / 1e6) ** 0.5, gen, dev)
    X = torch.randn((n_cells, n_genes), generator=gen, device=dev)
    X[:, :n_genes // 8] += 8.0 * torch.sin(coords[:, :1] / 300.0)
    d = SpatialData(X=X)
    d.obsm["spatial"] = coords
    return d


def phase_lisa_public(dev, n_cells: int, n_genes: int, n_perms: int, gen):
    """local_morans_i(banded_int8) in full, then compact, output mode."""
    d = lisa_adata(n_cells, n_genes, gen, dev)
    out = {}
    kw = dict(null_method="banded_int8", n_permutations=n_perms, seed=3,
              batch_size=n_genes, device=dev)
    _, out["full_s"] = timed(lambda: local_morans_i(d, output_mode="full", **kw),
                             dev)
    p, q = d.obsm["local_morans_p"], d.obsm["local_morans_quadrant"]
    check(isinstance(p, torch.Tensor) and p.device == torch.device(dev)
          and tuple(p.shape) == (n_cells, n_genes), "full p: a tensor on the card")
    check(bool(torch.isfinite(d.obsm["local_morans_I"]).all()), "non-finite I")
    check(bool(((p > 0) & (p <= 1)).all()), "LISA p outside (0, 1]")
    sig_share, noise_share = hh_ll_shares(q, n_genes // 8)
    print(f"[lisa] local_morans_i(banded_int8, full) {n_cells:,} cells x "
          f"{n_genes} genes x {n_perms} draws: {out['full_s']:.3f} s; HH/LL "
          f"after FDR: smooth genes {sig_share:.4f} of cells, noise genes "
          f"{noise_share:.6f}; p min {float(p.min()):.4f}")
    # the total-permutation null at k=6 caps the share below one half:
    # a cell needs z² well above its mean of 1 to reach p = 1/(P+1)
    check(sig_share > 0.3, "smooth genes: too few significant HH/LL cells")
    check(noise_share < 1e-3, "noise genes: significant cells after FDR")
    _, out["compact_s"] = timed(lambda: local_morans_i(
        d, output_mode="compact", key_added="lm_c", use_existing_graph=True,
        **kw), dev)
    full = {k: d.obsm.pop(f"local_morans_{k}") for k in
            ("I", "z", "lag", "p", "p_adj", "quadrant")}
    comp = {k: d.obsm.pop(f"lm_c_{k}") for k in ("I", "p", "p_adj", "quadrant")}
    check(comp["p"].dtype == torch.float16 and comp["I"].dtype == torch.bfloat16,
          "compact dtypes")
    for k in ("p", "p_adj"):
        check(torch.equal(comp[k], full[k].to(torch.float16)),
              f"compact {k} differs from the full run's float16 cast")
    check(torch.equal(comp["I"], full["I"].to(torch.bfloat16)),
          "compact I differs from the full run's bf16 cast")
    check(torch.equal(comp["quadrant"], full["quadrant"]), "compact quadrants")
    print(f"[lisa] output_mode='compact' (stored graph and plan): "
          f"{out['compact_s']:.3f} s; p, p_adj, I equal the full run's casts, "
          f"quadrants equal")
    del full, comp
    return d, out


def lisa_draw_split(dev, d, reps: int = 5):
    """One LISA draw at the public run's shape, part by part (CUDA events):
    Feistel rows, row gather, far gather, the draw-step kernel."""
    plan = d._null_plan_cache["value"]
    Zq = banded._quantize_z(standardize(d.X)[0])[0]
    G = Zq.shape[1]
    wq, _, far_q = banded._full_row_codes(plan)
    li = plan.local_idx.to(torch.int32).contiguous()
    n_live = banded._n_live_far(plan)
    far = dict(far_row_ptr=banded._row_ptr(plan.far_src, n_live, B, plan.n_padded),
               far_q=far_q[:n_live].to(torch.int8).contiguous())
    rows_idx = banded._padded_rows(plan, Zq.device)
    dst = plan.far_dst[:n_live]
    Zp0 = Zq[rows_idx]
    obs = kern_lisa.lisa_observed(li, wq, Zp0, B, Zf=Zp0[dst], **far)
    cnt = torch.zeros(obs.shape, dtype=torch.int8, device=Zq.device)
    base = key_for(3, "perm_feistel_local", 0)
    perm = feistel_apply(fold_in(base, 0), rows_idx, plan.n)
    Zp = Zq[perm]
    Zf = Zp[dst]
    split = dict(
        feistel=event_ms(lambda: feistel_apply(fold_in(base, 1), rows_idx, plan.n),
                         reps),
        row_gather=event_ms(lambda: Zq[perm], reps),
        far_gather=event_ms(lambda: Zp[dst], reps),
        kernel=event_ms(lambda: kern_lisa.lisa_count(li, wq, Zp, B, obs, cnt,
                                                     Zf=Zf, **far), reps),
        observed=event_ms(lambda: kern_lisa.lisa_observed(
            li, wq, Zp0, B, Zf=Zp0[dst], **far), 2))
    steps = iter(range(1, 1 << 20))

    def draw():
        zp = Zq[feistel_apply(fold_in(base, next(steps)), rows_idx, plan.n)]
        kern_lisa.lisa_count(li, wq, zp, B, obs, cnt, Zf=zp[dst], **far)

    split["whole_draw"] = event_ms(draw, reps)
    split["bound"], by = bound(*lisa_work(plan, G, "rows"))
    split["observed_bound"], _ = bound(*lisa_work(plan, G, "rows", observed=True))
    print(f"[lisa] one draw at {plan.n:,} cells x {G} genes (CUDA events, ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f" ({by}-bound); far edges {n_live:,}, far_bmax {plan.far_bmax}")
    return split


def hh_ll_shares(q: torch.Tensor, n_sig: int):
    """Share of cells at HH/LL among the smooth genes and the noise genes."""
    hl = (q == 1) | (q == 2)
    return float(hl[:, :n_sig].float().mean()), float(hl[:, n_sig:].float().mean())


def phase_lisa_vignette(dev, gen, n_cells: int = 366_938, k: int = 50,
                        n_genes: int = 128, n_perms: int = 99):
    """The reference vignette's shape (k=50, far_bmax > 1024 there), each
    route with launch counts of its own: local_morans_i's default route
    (null_method "auto" -> the float32 null in torch ops, no LISA kernel),
    then the int8 null's dense-far route (band_impl="pallas", K8's
    function) against its row-pointer route ("auto"), counts bitwise
    equal. Returns times, far_bmax and {band_impl: launch counts}."""
    d = lisa_adata(n_cells, n_genes, gen, dev)
    _, t_graph = timed(lambda: build_spatial_weights(d, n_neighbors=k,
                                                     device=dev), dev)
    kern_lisa.reset_launch_counts()
    _, t_f32 = timed(lambda: local_morans_i(
        d, n_neighbors=k, n_permutations=n_perms, seed=5, batch_size=n_genes,
        output_mode="full", use_existing_graph=True, device=dev), dev)
    f32_launches = dict(kern_lisa.LAUNCHES)
    check(d.uns["local_morans_params"]["null_precision"] == "f32",
          "null_method='auto' did not resolve to the float32 null at k=50")
    check(not any(f32_launches.values()),
          f"the float32 null launched an int8 LISA kernel: {f32_launches}")
    p = d.obsm["local_morans_p"]
    check(bool(torch.isfinite(d.obsm["local_morans_I"]).all()), "f32: non-finite I")
    check(bool(((p > 0) & (p <= 1)).all()), "f32: LISA p outside (0, 1]")
    sig, noise = hh_ll_shares(d.obsm["local_morans_quadrant"], n_genes // 8)
    check(sig > 0.3 and noise < 1e-3, f"f32: HH/LL shares {sig}, {noise}")
    for key in ("I", "z", "lag", "p", "p_adj", "quadrant"):
        del d.obsm[f"local_morans_{key}"]
    plan = d._null_plan_cache["value"]
    Z = standardize(d.X)[0]
    res, launches = {}, {}
    for impl, mode in (("pallas", "lisa_dense"), ("auto", "lisa_win")):
        kern_lisa.reset_launch_counts()
        res[impl] = timed(lambda: banded_local_moran_pvalues(
            plan, Z, 5, n_perms, band_impl=impl), dev)
        launches[impl] = dict(kern_lisa.LAUNCHES)
        check(launches[impl][mode] == n_perms,
              f"band_impl={impl!r} did not run the {mode} kernel per draw: "
              f"{launches[impl]}")
    check(torch.equal(res["pallas"][0], res["auto"][0]),
          "dense-far and row-pointer routes differ")
    print(f"[lisa] vignette shape {n_cells:,} cells k={k} (graph {t_graph:.3f} s, "
          f"far edges {banded._n_live_far(plan):,}, far_bmax {plan.far_bmax}), "
          f"{n_genes} genes x {n_perms} draws: local_morans_i('auto' -> float32 "
          f"null, torch ops; plan included) {t_f32:.3f} s, HH/LL smooth {sig:.4f} "
          f"noise {noise:.6f}; int8 dense far (band_impl='pallas') "
          f"{res['pallas'][1]:.3f} s, row-pointer far ('auto') "
          f"{res['auto'][1]:.3f} s; p bitwise equal")
    print(f"[path] vignette launches: float32 null {f32_launches}, "
          f"band_impl='pallas' {launches['pallas']}, 'auto' {launches['auto']}")
    return {"f32_s": t_f32, "dense_s": res["pallas"][1],
            "rows_s": res["auto"][1], "far_bmax": plan.far_bmax,
            "launches": launches}


def exact_pair(coords: np.ndarray, n_genes: int, seed: int, dev):
    """The same integer-valued input for the card and the CPU path.

    With 4,096 cells, integer coordinates below 2¹¹ and integer values
    whose columns sum to 0, every float32 mean and variance the pipeline
    takes is exact on both devices, whatever their summation order: the
    graphs, plans and z-scores are then bitwise equal, and so are the
    integer LISA counts."""
    rng = np.random.default_rng(seed)
    n = coords.shape[0]
    X = (np.round(3 * np.sin(coords[:, :1] / 40.0 + np.arange(n_genes)))
         + rng.integers(-2, 3, (n, n_genes))).astype(np.float32)
    X[-1] -= X.sum(axis=0)
    pair = []
    for where in (dev, "cpu"):
        d = SpatialData(X=torch.as_tensor(X).to(where))
        d.obsm["spatial"] = torch.as_tensor(coords).to(where)
        pair.append(d)
    return pair


def phase_lisa_vs_cpu(dev, label: str, coords: np.ndarray, n_genes: int,
                      seed: int, n_perms: int = 49):
    """local_morans_i on the card against the port's CPU path: p, p_adj and
    quadrants bitwise, I rtol 1e-5. Returns the card's SpatialData and the
    LISA launch counts of its run alone."""
    card, host = exact_pair(coords, n_genes, seed, dev)
    kw = dict(null_method="banded_int8", n_permutations=n_perms, seed=seed,
              batch_size=n_genes)
    kern_lisa.reset_launch_counts()
    local_morans_i(card, device=dev, **kw)
    sync(dev)
    launches = dict(kern_lisa.LAUNCHES)
    local_morans_i(host, device="cpu", **kw)
    got = {k: torch.as_tensor(card.obsm[f"local_morans_{k}"]).cpu().numpy()
           for k in ("I", "p", "p_adj", "quadrant")}
    want = {k: host.obsm[f"local_morans_{k}"] for k in got}
    for k in ("p", "p_adj", "quadrant"):
        check(np.array_equal(got[k], want[k]), f"{label}: card {k} differs "
              "from the CPU path")
    check(np.allclose(got["I"], want["I"], rtol=1e-5, atol=1e-7),
          f"{label}: card I differs from the CPU path")
    sig = float(((got["quadrant"] == 1) | (got["quadrant"] == 2)).mean())
    print(f"[lisa] {label}: card equals the CPU path (p, p_adj, quadrants "
          f"bitwise; I rtol 1e-5); HH/LL share {sig:.3f}; launches {launches}")
    return card, launches


def line_coords(n: int = 4096) -> np.ndarray:
    """Cells on a line at integer spacing, centred on 0: every kNN edge
    stays within the band, so the plan has no far edges."""
    x = np.arange(n, dtype=np.float32) - n // 2
    return np.stack([x, np.zeros_like(x)], axis=1)


def scattered_coords(n: int = 4096, seed: int = 0) -> np.ndarray:
    """Distinct integer points in [0, 2048)²."""
    flat = np.random.default_rng(seed).choice(2048 * 2048, n, replace=False)
    return np.stack([flat // 2048, flat % 2048], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# Phase 6: local Geary and Getis-Ord
# ---------------------------------------------------------------------------


def hot_adata(n_cells: int, n_genes: int, gen, dev) -> SpatialData:
    """1M-density uniform cells with raw, non-negative counts: Poisson(2)
    noise, and over the first eighth of the genes a smooth hot region
    (+round(12·max(sin(x/300), 0)); at half that, Gi's leave-one-out
    statistic puts too few cells at p = 1/(P+1) for BH to keep any)."""
    coords = uniform_coords(n_cells, SIDE * (n_cells / 1e6) ** 0.5, gen, dev)
    X = torch.poisson(torch.full((n_cells, n_genes), 2.0, device=dev),
                      generator=gen)
    X[:, :n_genes // 8] += torch.round(
        12.0 * torch.clamp_min(torch.sin(coords[:, :1] / 300.0), 0.0))
    d = SpatialData(X=X)
    d.obsm["spatial"] = coords
    return d


def compact_equals_full(d, key_full: str, key_comp: str, suffixes):
    """The compact run's planes equal the full run's casts (then both are
    dropped from ``d``)."""
    for sfx in suffixes:
        full = d.obsm.pop(f"{key_full}_{sfx}")
        comp = d.obsm.pop(f"{key_comp}_{sfx}")
        check(torch.equal(comp, full.to(comp.dtype)),
              f"compact {key_comp}_{sfx} differs from the full run's "
              f"{str(comp.dtype)[6:]} cast")


def phase_geary_public(dev, n_cells: int, n_genes: int, n_perms: int, gen):
    """local_gearys_c(null="total", banded_int8) in full, then compact,
    output mode, on a CUDA X (the LISA input: smooth genes and noise)."""
    d = lisa_adata(n_cells, n_genes, gen, dev)
    out = {}
    kw = dict(null="total", null_method="banded_int8", n_permutations=n_perms,
              seed=3, batch_size=n_genes, device=dev)
    _, out["full_s"] = timed(lambda: local_gearys_c(d, output_mode="full", **kw),
                             dev)
    C, p = d.obsm["local_geary_C"], d.obsm["local_geary_p"]
    pa = d.obsm["local_geary_p_adj"]
    check(isinstance(p, torch.Tensor) and p.device == torch.device(dev)
          and tuple(p.shape) == (n_cells, n_genes), "full p: a tensor on the card")
    check(bool(torch.isfinite(C).all()), "non-finite local C")
    check(bool(((p > 0) & (p <= 1)).all()), "local Geary p outside (0, 1]")
    sig = pa < 0.05
    smooth, noise = (float(sig[:, :n_genes // 8].float().mean()),
                     float(sig[:, n_genes // 8:].float().mean()))
    print(f"[geary] local_gearys_c(total, banded_int8, full) {n_cells:,} cells x "
          f"{n_genes} genes x {n_perms} draws: {out['full_s']:.3f} s; p_adj < "
          f"0.05: smooth genes {smooth:.4f} of cells, noise genes {noise:.6f}")
    check(smooth > 0.3, "smooth genes: too few significant local-Geary cells")
    check(noise < 1e-3, "noise genes: significant local-Geary cells after FDR")
    _, out["compact_s"] = timed(lambda: local_gearys_c(
        d, output_mode="compact", key_added="lg_c", use_existing_graph=True,
        **kw), dev)
    compact_equals_full(d, "local_geary", "lg_c", ("C", "p", "p_adj"))
    print(f"[geary] output_mode='compact' (stored graph and plan): "
          f"{out['compact_s']:.3f} s; C, p, p_adj equal the full run's casts")
    return d, out


def hot_shares(hot: torch.Tensor, n_sig: int):
    """Share of hot cells (code 1) among the hot-region genes, and of any
    nonzero code among the noise genes."""
    return (float((hot[:, :n_sig] == 1).float().mean()),
            float((hot[:, n_sig:] != 0).float().mean()))


def phase_getis_public(dev, n_cells: int, n_genes: int, n_perms: int, gen):
    """getis_ord_gi(banded_int8) with its defaults (Gi*, two-sided) in
    full, then compact, output mode, on raw non-negative CUDA X."""
    d = hot_adata(n_cells, n_genes, gen, dev)
    out = {}
    kw = dict(null_method="banded_int8", n_permutations=n_perms, seed=3,
              batch_size=n_genes, device=dev)
    _, out["full_s"] = timed(lambda: getis_ord_gi(d, output_mode="full", **kw),
                             dev)
    ps = d.obsm["getis_ord_p_sim"]
    check(isinstance(ps, torch.Tensor) and ps.device == torch.device(dev)
          and tuple(ps.shape) == (n_cells, n_genes),
          "full p_sim: a tensor on the card")
    for k in ("G", "z"):
        check(bool(torch.isfinite(d.obsm[f"getis_ord_{k}"]).all()),
              f"non-finite Getis {k}")
    check(bool(((ps > 0) & (ps <= 1)).all()), "p_sim outside (0, 1]")
    hot, noise = hot_shares(d.obsm["getis_ord_hotspot"], n_genes // 8)
    print(f"[getis] getis_ord_gi(Gi*, two-sided, banded_int8, full) {n_cells:,} "
          f"cells x {n_genes} genes x {n_perms} draws: {out['full_s']:.3f} s; "
          f"hot cells: hot-region genes {hot:.4f}, noise genes {noise:.6f}")
    check(hot > 0.1, "hot-region genes: too few hot cells")
    check(noise < 1e-3, "noise genes: hot or cold cells after FDR")
    _, out["compact_s"] = timed(lambda: getis_ord_gi(
        d, output_mode="compact", key_added="go_c", use_existing_graph=True,
        **kw), dev)
    compact_equals_full(d, "getis_ord", "go_c",
                        ("G", "z", "p", "p_sim", "p_adj", "hotspot"))
    print(f"[getis] output_mode='compact' (stored graph and plan): "
          f"{out['compact_s']:.3f} s; G, z, p, p_sim, p_adj, hotspot equal the "
          f"full run's casts")
    return d, out


def phase_gi_greater(dev, n_cells: int, n_genes: int, n_perms: int, gen):
    """Gi (star=False) with alternative="greater" through getis_ord_gi."""
    d = hot_adata(n_cells, n_genes, gen, dev)
    _, t = timed(lambda: getis_ord_gi(
        d, star=False, alternative="greater", null_method="banded_int8",
        n_permutations=n_perms, seed=4, batch_size=n_genes, output_mode="full",
        device=dev), dev)
    hot, noise = hot_shares(d.obsm["getis_ord_hotspot"], n_genes // 8)
    print(f"[getis] getis_ord_gi(Gi, greater, banded_int8) {n_cells:,} cells x "
          f"{n_genes} genes x {n_perms} draws: {t:.3f} s; hot cells: hot-region "
          f"genes {hot:.4f}, noise genes {noise:.6f}")
    check(hot > 0.1 and noise < 1e-3, f"Gi greater: hot shares {hot}, {noise}")
    return t


def phase_local_float_routes(dev, gen, n_cells: int = 200_000, k: int = 16,
                             n_genes: int = 128, n_perms: int = 99):
    """local_gearys_c(null="total") and getis_ord_gi(n_permutations > 0) at
    a shape where "auto" takes the float32 banded null (torch ops, no
    kernel); each with launch counts of its own."""
    out = {}
    for name, make, fn, kw, key in (
            ("local_gearys_c", lisa_adata, local_gearys_c, dict(null="total"),
             "local_geary"),
            ("getis_ord_gi", hot_adata, getis_ord_gi, {}, "getis_ord")):
        d = make(n_cells, n_genes, gen, dev)
        build_spatial_weights(d, n_neighbors=k, device=dev)
        kern_lisa.reset_launch_counts()
        _, t = timed(lambda: fn(d, n_neighbors=k, n_permutations=n_perms, seed=5,
                                batch_size=n_genes, output_mode="full",
                                use_existing_graph=True, device=dev, **kw), dev)
        launches = dict(kern_lisa.LAUNCHES)
        check(d.uns[f"{key}_params"]["null_method"] == "banded",
              f"{name}: 'auto' did not take the banded float32 null")
        check(not any(launches.values()),
              f"{name}: the float32 null launched a kernel: {launches}")
        p = d.obsm[f"{key}_p_sim" if key == "getis_ord" else f"{key}_p"]
        check(bool(((p > 0) & (p <= 1)).all()), f"{name}: p outside (0, 1]")
        low = p <= 1.0 / (n_perms + 1) + 1e-6
        sig, noise = (float(low[:, :n_genes // 8].float().mean()),
                      float(low[:, n_genes // 8:].float().mean()))
        check(sig > 5 * noise, f"{name}: smallest p not concentrated on the "
              f"signal genes ({sig}, {noise})")
        out[name] = t
        print(f"[float] {name}('auto' -> float32 banded null, torch ops) "
              f"{n_cells:,} cells k={k} x {n_genes} genes x {n_perms} draws: "
              f"{t:.3f} s (plan included); p at 1/(P+1): signal genes "
              f"{sig:.4f}, noise genes {noise:.4f}; launches {launches}")
        del d
    return out


def phase_local_vs_cpu(dev, coords: np.ndarray, n_genes: int, seed: int,
                       n_perms: int = 49):
    """local_gearys_c and getis_ord_gi (banded_int8) on the card against the
    port's CPU path on the same integer-valued input: p / p_sim, p_adj and
    hotspots bitwise; C, G, z rtol 1e-5. Returns each card run's launch
    counts."""
    launches = {}
    for name, fn, kw, key, exact, close in (
            ("local_gearys_c", local_gearys_c, dict(null="total"), "local_geary",
             ("p", "p_adj"), ("C",)),
            ("getis_ord_gi", getis_ord_gi, {}, "getis_ord",
             ("p_sim", "p_adj", "hotspot"), ("G", "z"))):
        card, host = exact_pair(coords, n_genes, seed, dev)
        run = dict(null_method="banded_int8", n_permutations=n_perms, seed=seed,
                   batch_size=n_genes, **kw)
        kern_lisa.reset_launch_counts()
        fn(card, device=dev, **run)
        sync(dev)
        launches[name] = dict(kern_lisa.LAUNCHES)
        fn(host, device="cpu", **run)
        for k in exact + close:
            got = torch.as_tensor(card.obsm[f"{key}_{k}"]).cpu().numpy()
            want = host.obsm[f"{key}_{k}"]
            ok = (np.array_equal(got, want) if k in exact else
                  np.allclose(got, want, rtol=1e-5, atol=1e-5))
            check(ok, f"{name}: card {k} differs from the CPU path")
        print(f"[local] {name} {coords.shape[0]:,} cells x {n_genes} genes: card "
              f"equals the CPU path ({', '.join(exact)} bitwise; "
              f"{', '.join(close)} rtol 1e-5); launches {launches[name]}")
    return launches


def tail_draw_split(dev, d, stat: str, reps: int = 5):
    """One draw of local Geary ("geary") or Gi* two-sided ("getis_star") at
    the public run's shape, part by part (CUDA events): Feistel rows, row
    gather, far gather, the draw-step kernel; the observed pass once."""
    plan = d._null_plan_cache["value"]
    n, n_pad = plan.n, plan.n_padded
    li = plan.local_idx.to(torch.int32).contiguous()
    n_live = banded._n_live_far(plan)
    ptr, dst = banded._rows_far(plan, n_live)
    src = plan.far_src[:n_live] - B
    rows_idx = banded._padded_rows(plan, d.X.device)
    if stat == "geary":
        Zq = banded._pad_cols4(banded._quantize_z(standardize(d.X)[0])[0])
        w, _, far_q = banded._full_row_codes(plan)
        fq = far_q[:n_live].to(torch.int8)
        w_code = w.to(torch.int32).sum(1, dtype=torch.int32).index_add_(
            0, src, fq.to(torch.int32))
        key = "perm_feistel_local_geary"

        def observed(Zp):
            return kern_lisa.geary_observed(li, w, Zp, B, w_code, far_row_ptr=ptr,
                                            far_q=fq, Zf=Zp[dst])
        obs = observed(Zq[rows_idx])

        def step(Zp, Zf, cnt):
            kern_lisa.geary_count(li, w, Zp, B, obs, cnt, w_code, far_row_ptr=ptr,
                                  far_q=fq, Zf=Zf)
    else:
        Zq = banded._pad_cols4(banded._quantize_x(d.X)[0])
        w = (plan.w_local > 0).to(torch.int8)
        fq = torch.ones(n_live, dtype=torch.int8, device=d.X.device)
        w_bin = w.to(torch.int32).sum(1, dtype=torch.int32).index_add_(
            0, src, fq.to(torch.int32)).to(torch.float32)
        tot, _ = banded._code_moments(Zq)
        inv_m = banded._inv_m(n, True)
        key = "perm_feistel_getis"

        def observed(Zp):
            return kern_lisa.getis_lag(li, w, Zp, B, far_row_ptr=ptr, far_q=fq,
                                       Zf=Zp[dst])
        Zp0 = Zq[rows_idx]
        obs = observed(Zp0) + Zp0[B:B + n_pad].to(torch.int32)
        del Zp0
        tail = dict(wp1=w_bin + 1.0, tm=tot * inv_m)

        def step(Zp, Zf, cnt):
            kern_lisa.getis_star_count(li, w, Zp, B, obs, cnt,
                                       alternative="two-sided", far_row_ptr=ptr,
                                       far_q=fq, Zf=Zf, **tail)
    G = Zq.shape[1]
    cnt = torch.zeros(obs.shape, dtype=torch.int8, device=d.X.device)
    base = key_for(3, key, 0)
    perm = feistel_apply(fold_in(base, 0), rows_idx, n)
    Zp = Zq[perm]
    Zf = Zp[dst]
    split = dict(
        feistel=event_ms(lambda: feistel_apply(fold_in(base, 1), rows_idx, n), reps),
        row_gather=event_ms(lambda: Zq[perm], reps),
        far_gather=event_ms(lambda: Zp[dst], reps),
        kernel=event_ms(lambda: step(Zp, Zf, cnt), reps),
        observed=event_ms(lambda: observed(Zq[rows_idx]), 2))
    steps = iter(range(1, 1 << 20))

    def draw():
        zp = Zq[feistel_apply(fold_in(base, next(steps)), rows_idx, n)]
        step(zp, zp[dst], cnt)

    split["whole_draw"] = event_ms(draw, reps)
    mode = "geary_win" if stat == "geary" else "getis_star_win"
    split["bound"], by = bound(*tail_work(plan, G, mode))
    split["observed_bound"], _ = bound(*tail_work(
        plan, G, "geary_obs" if stat == "geary" else "getis_obs"))
    print(f"[{stat}] one draw at {n:,} cells x {G} genes (CUDA events, ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f" ({by}-bound); far edges {n_live:,}")
    return split


# ---------------------------------------------------------------------------


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    # the plain versions' float32 matmuls must be exact (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    print(f"[device] {smi}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    _, t_build = timed(build.load_library, dev)
    log = [ln for ln in build.build_log().splitlines()
           if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    print(f"[build] nvcc {' '.join(build.NVCC_FLAGS)}: {t_build:.2f} s -> "
          f"{build.library_path().name}")
    for ln in log:
        print(f"[build] {ln.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)
    plan300 = real_plan(dev, 300, gen)
    kres = phase_kernels(dev, plan300, gen, {"int4_win": 4096, "int8_win": 4096,
                                             "int8_band": 4096, "bf16": 1024,
                                             "f32": 512}, reps=20)
    kres.update(phase_lisa_kernels(dev, plan300, gen, 1024, reps=20))
    kres.update(phase_tail_kernels(dev, plan300, gen, 1024, reps=20))
    del plan300

    # the global null's path
    kern.reset_launch_counts()
    kern_lisa.reset_launch_counts()
    phase_workload(dev, 1_000_000, 8192, 4096, 16, 16, gen)
    phase_public(dev, 1_000_000, 1024, 19, gen)
    launches = dict(kern.LAUNCHES)
    print(f"[path] band-cross launches in phases 3-4: {launches}")
    for mode in KERNELS:
        check(launches[mode] > 0, f"kernel mode {mode} never launched")
    phase_small_reference(dev, gen)
    torch.cuda.empty_cache()

    # the local Moran path: the counts are its own
    n_perms = 99
    kern_lisa.reset_launch_counts()
    d, _ = phase_lisa_public(dev, 1_000_000, 1024, n_perms, gen)
    main_lisa = dict(kern_lisa.LAUNCHES)
    print(f"[path] LISA launches of local_morans_i(banded_int8) full + "
          f"compact: {main_lisa}")
    check(main_lisa["lisa_win"] == 2 * n_perms and main_lisa["lisa_obs"] > 0,
          "the LISA main path did not run the row-pointer draw step per draw "
          "and the observed entry")
    lisa_draw_split(dev, d)
    del d
    torch.cuda.empty_cache()
    # the other routes, each with counts of its own
    vig = phase_lisa_vignette(dev, gen)
    card, line = phase_lisa_vs_cpu(dev, "4,096 cells on a line x 32 genes (no "
                                   "far edges)", line_coords(), 32, 7)
    check(banded._n_live_far(card._null_plan_cache["value"]) == 0,
          "the line's plan has far edges")
    check(line["lisa_band"] == 49, f"the line did not run the band-only draw "
          f"step per draw: {line}")
    phase_lisa_vs_cpu(dev, "4,096 scattered cells x 64 genes",
                      scattered_coords(), 64, 8)
    launches.update(lisa_win=main_lisa["lisa_win"],
                    lisa_obs=main_lisa["lisa_obs"],
                    lisa_dense=vig["launches"]["pallas"]["lisa_dense"],
                    lisa_band=line["lisa_band"])
    print("[path] launches in the kernels line: lisa_win and lisa_obs from "
          "the 1M-cell main path; lisa_dense from the vignette's "
          "band_impl='pallas' route; lisa_band from the line's run")
    del card
    torch.cuda.empty_cache()

    # local Geary's main path: the counts are its own
    kern_lisa.reset_launch_counts()
    d, _ = phase_geary_public(dev, 1_000_000, 1024, n_perms, gen)
    geary = dict(kern_lisa.LAUNCHES)
    print(f"[path] launches of local_gearys_c(banded_int8) full + compact: {geary}")
    check(geary["geary_win"] == 2 * n_perms and geary["geary_obs"] == 2
          and sum(geary.values()) == 2 * n_perms + 2,
          "the local Geary main path did not run the geary draw step once per "
          "draw and the observed entry once per call")
    tail_draw_split(dev, d, "geary")
    del d
    torch.cuda.empty_cache()
    # Getis-Ord Gi*'s main path
    kern_lisa.reset_launch_counts()
    d, _ = phase_getis_public(dev, 1_000_000, 1024, n_perms, gen)
    getis = dict(kern_lisa.LAUNCHES)
    print(f"[path] launches of getis_ord_gi(banded_int8) full + compact: {getis}")
    check(getis["getis_star_win"] == 2 * n_perms and getis["getis_obs"] == 2
          and sum(getis.values()) == 2 * n_perms + 2,
          "the Getis main path did not run the getis_star draw step once per "
          "draw and the observed entry once per call")
    tail_draw_split(dev, d, "getis_star")
    del d
    torch.cuda.empty_cache()
    # Gi with a one-sided alternative
    kern_lisa.reset_launch_counts()
    phase_gi_greater(dev, 1_000_000, 256, n_perms, gen)
    gi = dict(kern_lisa.LAUNCHES)
    print(f"[path] launches of getis_ord_gi(star=False, greater): {gi}")
    check(gi["getis_g_win"] == n_perms and gi["getis_obs"] == 1,
          f"the Gi run did not run the getis_g draw step per draw: {gi}")
    torch.cuda.empty_cache()
    # the float32 routes and the card-vs-CPU checks, each with counts of
    # their own
    phase_local_float_routes(dev, gen)
    vs_cpu = phase_local_vs_cpu(dev, scattered_coords(seed=1), 64, 9)
    check(vs_cpu["local_gearys_c"]["geary_win"] == 49
          and vs_cpu["getis_ord_gi"]["getis_star_win"] == 49,
          f"the 4,096-cell card runs did not run their draw steps: {vs_cpu}")
    launches.update(geary_win=geary["geary_win"], geary_obs=geary["geary_obs"],
                    getis_star_win=getis["getis_star_win"],
                    getis_obs=getis["getis_obs"], getis_g_win=gi["getis_g_win"])
    print("[path] launches in the kernels line: geary_win and geary_obs from "
          "local Geary's 1M-cell main path; getis_star_win and getis_obs from "
          "Getis-Ord's; getis_g_win from the Gi run")

    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[mode], **kres[mode]}
        for mode, (name, src, rep) in {**KERNELS, **LISA_KERNELS}.items()]}
    print(smi)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
