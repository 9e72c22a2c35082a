"""One run of the PyTorch port's main paths on one CUDA GPU.

    python3 chip_smoke.py

Phases (the script stops with a non-zero exit at the first failure):

1. Device and build: the card's name and power limit (nvidia-smi), and the
   nvcc build of ``spatialcore_tpu_torch/csrc/*.cu`` (one nvcc per source,
   in parallel) with its time; the local draw step's SASS by instance and
   opcode (``lisa_sass``); each kNN instance's registers, stack and spills
   and its SASS by opcode (``knn_sass``).
2. Each kernel against its plain PyTorch version, on the card, at B=256 on
   300 blocks of a real kNN plan at the 1M-cell density: the band-cross
   kernel (int4/int8 windowed far at G=4096 and int4 at a ragged G=1000,
   int8 band-only at G=4096, bf16 at G=1024 and at a ragged G=1000, f32 at
   G=512; agreement within 1e-5·Σ|terms|) and the
   local statistics' draw-step kernel at G=1024 (LISA: row-pointer far
   with int8 and int16 counters, dense far, band only, and the observed
   entry; the geary tail and its observed entry; the getis_star and
   getis_g tails under every alternative, and the Getis observed entry;
   counts and observed values equal; every K7/K8 entry also timed at other
   launch shapes, ``lisa_shapes``), and the dense-band kernels K5 and
   K6 (bf16 at G=1,024, f32 at G=512; within 1e-5·Σ|terms|; ``torch.bmm``
   of the dense band against the stacked windows, the lag alone, printed
   as a second yardstick; the share of the band's tiles they skip; every
   launch shape of ``kern.DENSE_SHAPES`` and the skip turned off, timed
   through ``kern.band_cross_dense_tiled`` / ``band_cross_rot4_tiled``).
   Each with its time, its plain version's time,
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
   port's CPU path. Proof of path: every compact-band kernel mode (K1–K4)
   launched during phases 3–4 (the dense-band K5 and K6 in phase 9).
   Then, outside the counted window, the integer kernel on phase 3's 1M
   plan and data (``hold_int_1m``): K1 at 4,096 int4 genes, K2 and K3 at
   1,024 int8 genes, on one Feistel draw's gathered rows, held against
   their plain versions within 1e-5·Σ|terms| and timed beside the plain
   version, the bound and ``torch.sparse.mm``; K1's other launch shapes;
   and one int4 draw split part by part (``int_draw_split``).
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
   ("auto"), counts bitwise equal, and K8 held against its plain version
   and timed there (``hold_k8``); a plan without far edges (cells on a
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
   ``alternative="greater"``) at 1M × 256 genes and its split, each draw
   step and observed entry held against its plain version at its path's
   own shape and timed beside its bound and ``torch.sparse.mm``
   (``hold_main``; LISA's too, in phase 5), both float32 routes at a
   shape where "auto" takes them (200,000 cells, k=16, 128 genes, no
   kernel), and 4,096 scattered cells on the card against the port's CPU
   path (p / p_sim, p_adj, hotspots bitwise).
7. Local Lee's L (phase 2 also holds the lee tail's draw step, observed
   entry and partial-only entry, and the kNN kernel at 66,536 cells, k=6
   and k=50, against their plain versions, at the chooser's launch shape
   and every shape of ``knn_shapes``, each timed, with the all-pairs
   bound and the exact-d2 scan's FP32 instruction floor; and k=130 and
   k=256 at 8,192 cells). The main path, with counts of its own: ``lees_l_local(null_method="banded_int8", n_permutations=99,
   compute_cell_pvalues=True)`` at 1,000,000 cells (CUDA X, k=6) over
   1,024 gene pairs in ``output_mode="compact"`` and 64 pairs in "full"
   (compact p / p_adj / L on the shared pairs equal to the full run's
   casts); the lee entries against their plain versions on that plan at
   one compact tile's 256 pairs, timed there; full mode's parts timed one
   by one;
   then ``lees_l`` at 1,024 pairs through "banded_int8" (the
   partial-only entry) and "auto" (the float32 null in torch ops, no
   kernel); the direct null (``jax.random.permutation``'s stream) through
   "auto" at 50,000 cells × 64 pairs; the per-draw split; 4,096 scattered
   cells on the card against the port's CPU path (p, p_adj, quadrants and
   the global p bitwise).
8. The graph path through the kNN kernel: ``build_graph(method="pallas")``
   at 1,000,000 cells (k=6) and at the vignette's 366,938 cells (k=50),
   timed; on the coordinates the call centres, the kernel against its
   plain version (every query at 366,938 cells, the first and last 4,096
   at 1M) and the graph against the kernel's output; the kernel alone at
   its chooser's and other launch shapes (each equal to the chooser's
   output), the all-pairs bound and the exact-d2 scan's FP32 instruction
   floor at both shapes, and ``torch.cdist`` + ``torch.topk`` at 366,938
   cells; the rows whose neighbour set differs from ``method="grid"``
   counted.
9. The global null's remaining routes, each with counts of its own:
   ``banded_permutation_test(precision="bf16")`` at 1,000,000 cells ×
   1,024 genes × 8 draws through "auto" (K4), "pallas" (K5, dense band)
   and "pallas_halo4" (K6, rotation-baked ring), counts within ±1 draw of
   K4's and null moments within rtol 1e-4, per-draw ms; K5 and K6 held
   against their plain versions on that call's table in bf16 (1,024 genes)
   and f32 (512), each timed beside its bound and ``torch.bmm`` of the
   dense band, with the share of tiles skipped and every launch shape
   timed; K4 held against its plain version there (bf16 at
   1,024 genes, f32 at 512), with its plain and ``torch.sparse.mm`` times,
   other launch shapes of it timed, and one bf16 draw split part by part
   (Feistel rows, row gather, K4, far-edge terms, Geary's Σ z1² term);
   ``streaming_moran_null(precision="int4",
   tile=4096)`` at 1M × 18,432 genes × 8 draws (data made per tile on the
   card from a seed; prep and draw time) and ``(precision="bf16",
   tile=2048, band_impl="pallas")`` at 1M × 4,096 × 8;
   ``global_autocorrelation(null_method="banded_int8")`` at 1M × 1,024 ×
   19 draws, p bitwise equal to separate ``morans_i`` / ``gearys_c``
   calls; the slot null: ``morans_i(null_method="slots")`` at 1M × 64 × 19
   and ``morans_i`` through "auto" at 50,000 × 128 × 99 (resolves to
   slots); ``perm_method="sort"`` f32 against ``permutation_test_global``
   at 1M × 64 × 19 (p within 0.02, means within 1e-5); 4,096 scattered
   cells on the card against the port's CPU path (the slot null's
   permutations bitwise, counts within ±1 draw).

10. The local slot nulls and the local "sort" streams, each call with
   counts of its own. On CUDA X, with every launch count at 0 and none
   allowed (the slot nulls are torch ops): ``local_morans_i`` with every
   default (P=10, k=6, "auto" -> the slot null, total) at 1,000,000 cells
   x 1,024 genes; ``local_morans_i(null="conditional", n_permutations=99)``,
   ``local_gearys_c`` with its defaults (conditional, P=99) and
   ``getis_ord_gi(null_method="direct", n_permutations=99)`` at 1M x 256;
   ``join_count_statistics`` and ``local_join_counts`` at 1M cells and
   ``local_gearys_c_multivariate`` at 1M x 16, P=99. One slot draw at 1M x
   100 genes split part by part (permutation, inverse, choice, the k slot
   gathers, the count update) for both nulls. The int8 banded LISA on the
   "sort" stream at 1M x 1,024 x 99 and local Geary, Gi* (two-sided) and
   Gi ("greater") at 1M x 256 x 99: K7's moran / geary / getis_star /
   getis_g tail once a draw and the observed entry once; each tail against
   its plain version on one sort draw's rows at 256 genes of that plan
   (counts equal). 4,096 scattered cells on the card against the port's
   CPU path: permutations and conditional draw indices, the slot nulls'
   p / p_adj, local join counts and the sort-stream LISA, bitwise.
11. Radius graphs, the correlogram, the bf16 stream and the point
   patterns, each call with counts of its own. At 1,000,000 cells of phase
   3's layout, radius 10.7047 (a mean degree of 10) and k_max 48:
   ``build_spatial_weights(radius=, k_max=)`` (no overflow; isolated cells
   counted), ``morans_i(null_method="banded_int8")`` at 1,024 genes × 99
   (K2), ``morans_i(null_method="banded")`` × 19 (K4) and
   ``local_morans_i(null_method="banded_int8", output_mode="compact")`` ×
   99 (K7 moran); then K2/K3, K4 and K7 moran (draw step and observed
   entry) held against their plain versions on that plan's own operands
   (the first gene tile, draw 0) and timed beside their bounds; a
   4,096-cell radius run on the card against the port's CPU path (graph,
   morans_i p, local_morans_i p / p_adj / quadrants bitwise).
   ``moran_correlogram`` at 1M × 64 genes, 5 default bands, k_max 128, at
   P = 0 and 19 (torch ops, no kernel), with one draw split (permutation,
   slot loop, moments). ``streaming_local_null(obs_dtype="bf16",
   tile=2048)`` at 1M × 4,096 × 99 (K7 once a draw and tile) against the
   float32-obs run on the first 2,048 genes: p and p_adj bitwise, peak
   device memory of each. At 1M cells (7/8 uniform, 1/8 in clumps, 8 cell
   types): ``clark_evans``, ``ripleys_k`` (20 radii up to 10× the mean NN
   distance, 19 CSR draws), ``cross_type_ripleys_k`` (19 label
   permutations) and ``co_occurrence`` (torch ops, no kernel), one pass of
   each kind timed; 20,000 cells on the card against the CPU path, counts
   and envelopes bitwise.
12. The niche and domain path (torch ops, no kernel; each call checked to
   launch none): ``simulate_xenium`` at 1,000,000 cells × 256 genes on a
   25,000 µm square (the default density; host time), the h5ad round trip
   where h5py imports (else one line says why not), ``normalize_log1p_
   from_raw``, ``neighborhood_enrichment`` (13 types, k = 6, 1,000 label
   permutations) with one draw split (permutation, pair counts),
   ``compute_neighborhood_profile`` (k = 15), ``identify_niches`` (6
   niches; mini-batch at 1M), ``identify_niches`` (full k-means) and
   ``niche_stability`` (k 4–8, 5 restarts) on a 100,000-cell subset,
   ``make_spatial_domains`` around B cells and epithelial cells (xenium)
   with each raster's H × W, pixel and connected-components iterations,
   ``calculate_domain_distances`` between them ("minimum" and "mean"),
   ``get_domain_summary`` and ``get_distance_matrix``; then 20,000 cells
   (30 label permutations) on the card against the CPU path (enrichment
   counts, profiles, raster masks and labels, domains and minimum
   distances bitwise; z and the null moments within rtol 1e-6, "mean"
   distances within 1e-5; niches equal up to renaming).
13. The statistics and the annotation scoring path (torch ops, no kernel;
   each call checked to launch none), at the size of a Xenium section:
   1,000,000 cells x 377 genes (the human multi-tissue panel's width), 20
   planted cell types with their canonical markers, log1p-normalized
   counts made on the card; two ``CellTypeModel`` s from seeded numpy
   arrays (class centroids as weights; one on 300 panel genes and 20 the
   panel lacks), published to ``.npz`` and resolved back through a
   registry. Timed: ``annotate_cells`` (the ensemble),
   ``filter_low_confidence``, ``filter_by_marker_validation`` (its
   confidence gate at 0.95, so that the marker GMM decides most cells),
   ``marker_quality_metrics``, ``benchmark_annotation``,
   ``rank_genes_groups`` over the planted types, ``classify_by_threshold``
   (ks and gmm, on three markers only B cells carry), ``run_nmf`` (10 programs),
   ``smooth_expression`` (3 steps, k = 6) and ``diffusion_map`` (10
   components, k = 15); outputs checked against the planted truth. Then
   20,000 cells on the card against the CPU: annotation labels, metagene
   scores, the normal draws and the DEG output bitwise; decision scores,
   confidences, the marker-validated labels, NMF, smoothing, the
   diffusion map and the benchmark within stated tolerances.
14. The training half of annotation, the pipeline and the command line
   (torch ops, no kernel; each call checked to launch none): two
   in-memory references of 250,000 cells x 500 genes (phase 13's 377 panel
   genes, other seeds, and 123 genes the panel lacks; raw counts as CSR;
   author-style labels and 1% junk labels; one lacks 5 panel genes, one
   names its genes by Ensembl ID) through ``train_and_annotate`` onto
   phase 13's 1M x 377 section with its defaults (5,000 cells a type, 30
   epochs, batch 1,024), each stage timed from the pipeline's log lines;
   ``train_cell_type_model`` on the section for 3 epochs (976 steps an
   epoch: s an epoch, ms a step, the host scaler timed apart); a
   checkpointed run resumed to the same epoch count against the
   uninterrupted one; accuracy against the planted types (floor 0.95).
   Then 20,000 cells on the card against the CPU (weights within 1e-4 of
   max|W|; labels, scaler, classes, predicted labels and CL IDs equal;
   thresholded labels on all but 0.1% of cells), and the command line:
   ``python -m spatialcore_tpu_torch info``, the YAML round trip where
   yaml imports and the h5ad commands where h5py imports (else one line
   says why not).

The last line is ``{"ok": true, "device": {...}}``; the line before it a
JSON summary of every kernel, and the one before that nvidia-smi's name
and power limit. Without a CUDA device the script raises.
"""

from __future__ import annotations

import cProfile
import gc
import json
import logging
import pstats
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

T_START = time.perf_counter()

import numpy as np
import pandas as pd
import torch

from spatialcore_tpu_torch import (SpatialData, build_spatial_weights,
                                   gearys_c, getis_ord_gi, global_autocorrelation,
                                   join_count_statistics, lees_l, lees_l_local,
                                   local_gearys_c, local_gearys_c_multivariate,
                                   local_join_counts, local_morans_i, morans_i)
from spatialcore_tpu_torch.core import rng
from spatialcore_tpu_torch.core.rng import (feistel_apply, fold_in, key_for,
                                            permutation)
from spatialcore_tpu_torch.kernels import band_cross as kern
from spatialcore_tpu_torch.kernels import build
from spatialcore_tpu_torch.kernels import knn as kern_knn
from spatialcore_tpu_torch.kernels import lisa_count as kern_lisa
from spatialcore_tpu_torch.kernels import sass
from spatialcore_tpu_torch.ops import banded, geometry, moran
from spatialcore_tpu_torch.ops.banded import (banded_local_moran_pvalues,
                                              banded_permutation_test,
                                              build_null_plan)
from spatialcore_tpu_torch.ops.fdr import apply_fdr
from spatialcore_tpu_torch.ops.graph import (build_graph, radius_neighbors,
                                             spatial_lag)
from spatialcore_tpu_torch.ops.knn_kernel import centred_xy
from spatialcore_tpu_torch.core.metadata import get_operations
from spatialcore_tpu_torch.ops.moran import (moran_observed,
                                             permutation_test_global, standardize)
from spatialcore_tpu_torch.ops.streaming import (device_local_sink,
                                                 streaming_local_null,
                                                 streaming_moran_null, tile_widths)
from spatialcore_tpu_torch.spatial import autocorrelation as acorr
from spatialcore_tpu_torch.spatial import domains as dom
from spatialcore_tpu_torch.spatial import nhood
from spatialcore_tpu_torch.spatial import (clark_evans, co_occurrence,
                                           cross_type_ripleys_k,
                                           moran_correlogram, ripleys_k)

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
    "dense": ("band_cross_dense (bf16/f32 dense band; K5)",
              "spatialcore_tpu_torch/csrc/band_cross_dense.cu",
              "spatialcore_tpu/ops/banded.py:385"),
    "rot4": ("band_cross_rot4 (bf16/f32 rotation-baked ring; K6)",
             "spatialcore_tpu_torch/csrc/band_cross_dense.cu",
             "spatialcore_tpu/ops/banded.py:557"),
}
#: the modes phases 3-4 launch (K5 and K6 run in phase 9)
GLOBAL_MODES = ("int4_win", "int8_win", "int8_band", "float")
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
    "lee_win": ("lee_count (draw step, row-pointer far; K7 lee tail)",
                LISA_SRC, "spatialcore_tpu/ops/banded.py:1511"),
    "lee_obs": ("lee_observed (observed |x*lag| and block partials; the XLA "
                "lees_q pass)", LISA_SRC, "spatialcore_tpu/ops/banded.py:2661"),
    "lee_partial": ("lee_partial (block partials of the global L; the "
                    "global-only XLA body)", LISA_SRC,
                    "spatialcore_tpu/ops/banded.py:2674"),
}
KNN_KERNELS = {
    "knn": ("knn_topk (exact 2D all-pairs kNN by (d2, id) keys; K9)",
            "spatialcore_tpu_torch/csrc/knn_topk.cu",
            "spatialcore_tpu/ops/pallas_knn.py:29"),
}
#: the card's published peaks (H100 SXM data sheet): HBM bytes/s, and
#: operations/s of the unit that could do each kernel's work
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bf16": 989e12, "f32": 67e12}
#: unfused FP32 instructions the H100 SXM runs a second: 132 SMs x 128
#: lanes x 1.98 GHz (the floor of a kNN that ranks every pair by its exact
#: d2, none of whose operations fuse)
F32_INSTR_RATE = 33.5e12


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


def hold_main(label, got, want, kernel_fn, plain_fn, work, csr, table,
              reps: int = 5) -> dict:
    """A local entry at a main path's own shape: ``got`` (the kernel's
    output, a tensor or a tuple) equal to ``want`` (its plain version's on
    the same inputs), then the kernel's time beside the plain version's,
    the bound of ``work`` and ``torch.sparse.mm`` of the band against the
    same table. Returns the numbers."""
    sync(table.device)
    gs, ws = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(gs, ws):
        check(torch.equal(g, w), f"{label}: differs from its plain version")
    ms, pms = event_ms(kernel_fn, reps), event_ms(plain_fn, 1)
    lib = library_ms(csr, table, 3)
    b_ms, by = bound(*work)
    print(f"[main] {label}: equal to plain; kernel {ms:.4f} ms  plain {pms:.4f} "
          f"ms  bound {b_ms:.4f} ms ({by})  library {lib:.4f} ms")
    return dict(ms=ms, plain_ms=pms, bound_ms=b_ms, library_ms=lib)


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
    """Operands of every band-cross kernel mode on ``plan``, for each
    (mode, G) pair of ``widths``. Yields
    (mode, label, kernel_fn, plain_fn, scale_fn, nbytes, ops, unit, table):
    scale_fn gives Σ_i |term_i| per gene for the tolerance; nbytes / ops
    are what one call must move and compute; table is the value table the
    library yardstick multiplies."""
    n_blocks = plan.n_padded // B
    n = plan.n_padded
    rows_idx = torch.arange((n_blocks + 2) * B, device=dev) - B
    rows_idx = plan.order[rows_idx.clamp(0, plan.n - 1)]
    li = plan.local_idx.to(torch.int32)
    for mode, G in widths:
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
               first=mode not in results)
    return results


def dense_work(A, zp):
    """(bytes, operations, unit) one dense-band call (K5 "dense" or K6
    "rot4") needs on the band ``A`` [nb, B, width·B] and the table ``zp``
    [(nb+2)·B, G]: A and zp read once, [G] written; 2·16·16·G operations
    for each 16×16 tile of A that holds a nonzero weight
    (``kern.nonzero_tiles``: the tiles the kernels multiply; K6's zero
    fourth column block holds none)."""
    G = zp.shape[1]
    return ((A.numel() + zp.numel()) * A.element_size() + 4 * G,
            2 * 16 * 16 * G * kern.nonzero_tiles(A),
            "bf16" if A.dtype == torch.bfloat16 else "f32")


def skip_share(A) -> str:
    """The share of A's 16×16 tiles the kernels skip, and of the 64×16
    tiles (a 64-row tile's k16 steps, whose window slices are not copied)."""
    nb, nr, KA = A.shape
    t16 = 1 - kern.nonzero_tiles(A) / (nb * (nr // 16) * (KA // 16))
    t64 = 1 - kern.nonzero_tiles(A, 64, 16) / (nb * -(-nr // 64) * (KA // 16))
    return (f"skipped: {100 * t16:.2f}% of the 16x16 tiles, {100 * t64:.2f}% "
            f"of the 64x16 tiles")


def dense_shapes(label: str, mode: str, A, zp, reps: int) -> None:
    """Time a dense-band kernel's launch shapes on (A, zp): every shape of
    ``kern.DENSE_SHAPES`` that fits, and the default with the skip turned
    off."""
    tiled = (kern.band_cross_dense_tiled if mode == "dense"
             else kern.band_cross_rot4_tiled)
    width, esz = A.shape[2] // B, A.element_size()
    shapes = {f"{shape}": kern.dense_tiles(B, width, esz, shape)
              for shape in kern.DENSE_SHAPES
              if kern.dense_smem_bytes(B, width, esz, *shape) <= kern.SMEM_LIMIT}
    shapes["skip off"] = kern.dense_tiles(B, width, esz, skip=False)
    for name, t in shapes.items():
        ms = event_ms(lambda: tiled(A, zp, B, t), reps)
        print(f"[dense] {label}, launch shape {name} {t}: {ms:.4f} ms")


def hold_dense(label: str, fn, plain, A, zp) -> float:
    """Hold one dense-band kernel against its plain version on (A, zp)
    within REL_TOL·Σ|terms| (the plain version on |A| and |zp|); returns
    the largest |error|."""
    got, want = fn(A, zp, B), plain(A, zp, B)
    sync(zp.device)
    err = (got.double() - want.double()).abs()
    tol = REL_TOL * plain(A.abs(), zp.abs(), B).double() + 1e-30
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite cross")
    check(bool((err <= tol).all()),
          f"{label}: kernel disagrees with plain (max err "
          f"{float(err.max()):.3e}, bound {float(tol.min()):.3e})")
    return float(err.max())


def stacked_windows(table, nb: int, width: int):
    """[nb, width·B, G] windows of the flat table (the dense kernels' right
    operands, materialised for the bmm yardstick): the three slabs from n
    for width 3, K6's ring order (slot s holds the slab ≡ s mod 4) for 4."""
    G = table.shape[1]
    if width == 3:
        return table.as_strided((nb, 3 * B, G), (B * G, G, 1)).contiguous()
    z3 = table.reshape(-1, B, G)
    z4 = torch.cat([z3, torch.zeros_like(z3[:1])])
    return z4[kern.rot4_slabs(nb, 0, nb, table.device)].reshape(nb, 4 * B, G)


def phase_dense_kernels(dev, plan, gen, widths, reps: int):
    """K5 and K6 against their plain versions on the card (bf16 and f32);
    returns {mode: numbers} with the bf16 case's times."""
    results = {}
    csr = band_csr(plan, dev)
    nb = plan.n_padded // B
    for dtype, G in widths.items():
        dt = torch.bfloat16 if dtype == "bf16" else torch.float32
        zp = torch.randn(((nb + 2) * B, G), generator=gen, device=dev).to(dt)
        lib = library_ms(csr, zp)
        for mode, build_fn, fn, plain in (
                ("dense", banded._build_band, kern.band_cross_dense,
                 kern.band_cross_dense_plain),
                ("rot4", banded._build_band_rot4, kern.band_cross_rot4,
                 kern.band_cross_rot4_plain)):
            A = build_fn(plan.local_idx, plan.w_local.to(dt), B, dt)
            label = f"{mode} {dtype} G={G}"
            err = hold_dense(label, fn, plain, A, zp)
            ms = event_ms(lambda: fn(A, zp, B), reps)
            plain_ms = event_ms(lambda: plain(A, zp, B), max(1, reps // 5))
            win = stacked_windows(zp, nb, 3 if mode == "dense" else 4)
            bmm_ms = event_ms(lambda: torch.bmm(A, win), max(1, reps // 5))
            del win
            report(results, mode, f"{label} (tolerance {REL_TOL:g}·Σ|terms|; "
                   f"bmm of the dense band {bmm_ms:.4f} ms; {skip_share(A)})",
                   err, ms, plain_ms, *dense_work(A, zp), lib,
                   first=dtype == "bf16")
            dense_shapes(label, mode, A, zp, reps)
            del A
    return results


#: far forms as the local draw step's chooser numbers them
FAR_FORMS = {"none": 0, "rows": 1, "dense": 2}


def lisa_shapes(mode: str, stat: str, form: str, cnt_bytes: int, G: int,
                n_blocks: int, fn, reps: int = 10) -> dict:
    """Time a local entry (``fn(tiles)``) at launch shapes beside the
    chooser's (tile, run, chunk, far_cap, stages): one and two rows a thread
    a chunk, a 64 KB ring (at most 64-gene tiles), 32-gene tiles, half the
    chunk in three stages, a run of 1 and of twice the chooser's, and
    (row-pointer far) half a chunk's far entries staged, or none. Shapes
    that do not fit the card's shared memory are left out."""
    f = FAR_FORMS[form]
    t = kern_lisa.lisa_tiles(B, K, stat, f, cnt_bytes, G, n_blocks)

    def other(**kw):
        return kern_lisa.lisa_tiles(B, K, stat, f, cnt_bytes, G, n_blocks, **kw)

    cands = {"chooser": t, "one_row": other(rows_a_thread=1),
             "two_rows": other(rows_a_thread=2), "ring64k": other(max_ring=64 << 10),
             "tile32": other(max_tile=32),
             "stages3": t._replace(chunk=max(1, t.chunk // 2), stages=3),
             "run1": t._replace(run=1), "run2x": t._replace(run=2 * t.run)}
    if form == "rows":
        cands["far_half"] = t._replace(far_cap=t.far_cap // 2)
        cands["no_far_staged"] = t._replace(far_cap=0)
    shapes = {}
    for name, ti in cands.items():
        smem = kern_lisa.lisa_smem_bytes(B, K, stat, f, cnt_bytes, ti.tile, ti.chunk,
                                         ti.far_cap, ti.stages)
        if (smem <= kern.SMEM_LIMIT and ti.stages <= 4
                and ti.stages - 1 <= -(-B // ti.chunk)):
            shapes[name] = ti._replace(smem=smem)
    times = {name: event_ms(lambda ti=ti: fn(ti), reps) for name, ti in shapes.items()}
    print(f"[shapes] {mode} G={G} (tile, run, chunk, far_cap, stages): " + ", ".join(
        f"{name} {tuple(shapes[name][:5])} {ms:.4f} ms" for name, ms in times.items()))
    return times


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
        if cdt == torch.int8:
            lisa_shapes(mode, "moran", form, 1, G, nbk, lambda tiles: kern_lisa.lisa_count(
                li, wq, zp, B, obs, scratch, tiles=tiles, **far))
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
    lisa_shapes("lisa_obs", "moran", "rows", 0, G, nbk, lambda tiles:
                kern_lisa.lisa_observed(li, wq, zp, B, tiles=tiles, **rows_far))
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
    lisa_shapes("geary_obs", "geary", "rows", 0, G, nbk, lambda tiles:
                kern_lisa.geary_observed(*args, w_code, tiles=tiles, **ge["far"]))
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
    lisa_shapes("geary_win", "geary", "rows", 1, G, nbk, lambda tiles:
                kern_lisa.geary_count(*args, obs, scratch, w_code, tiles=tiles,
                                      **ge["far"]))

    # Getis: the binary-lag observed entry, then Gi* and Gi draw steps
    args = (gt["li"], gt["w"], gt["zp"], B)
    got = kern_lisa.getis_lag(*args, **gt["far"])
    want = kern_lisa.getis_lag_plain(*args, **gt["far"])
    err = equal("getis_obs", "getis_obs", got, want)
    ms, pms = timed_pair(lambda: kern_lisa.getis_lag(*args, **gt["far"]),
                         lambda: kern_lisa.getis_lag_plain(*args, **gt["far"]))
    report(results, "getis_obs", f"getis_obs G={G} ({nbk} blocks; equal)", err,
           ms, pms, *tail_work(plan, G, "getis_obs"), lib)
    lisa_shapes("getis_obs", "getis_star", "rows", 0, G, nbk, lambda tiles:
                kern_lisa.getis_lag(*args, tiles=tiles, **gt["far"]))
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
            if alt == "two-sided":
                lisa_shapes(mode, mode[:-4], "rows", 1, G, nbk, lambda tiles: fn(
                    *args, obs, scratch, alternative=alt, tiles=tiles, **gt["far"],
                    **kw))
    return results


def lee_work(plan, G: int, mode: str, cnt_bytes: int = 1):
    """(bytes, {unit: operations}, "") of one Lee entry on ``plan`` at G
    pairs: gathered y codes, compact band, far row pointers and values, the
    fixed x codes and row scales read once; the draw step's int32 obs read
    and counters read and written, or the observed entry's int32 plane
    written; the [nb, G] f32 partials written. A multiply-add per band slot
    and live far edge, the x product and test per value (int), and the
    partial's multiply-add per value (f32)."""
    n, k = plan.local_idx.shape
    nnz = int((plan.w_local != 0).sum())
    n_live = banded._n_live_far(plan)
    common = ((n + 2 * B) * G + n * k * 5 + 4 * (n + 1) + n_live * (G + 1)
              + n * G + 4 * n + 4 * (n // B) * G)
    plane = {"lee_win": 4 * n * G + 2 * cnt_bytes * n * G,
             "lee_obs": 4 * n * G, "lee_partial": 0}[mode]
    ops = {"int8": 2 * (nnz + n_live) * G + (3 if mode == "lee_win" else 1) * n * G,
           "f32": 2 * n * G}
    return common + plane, ops, ""


def phase_lee_kernels(dev, plan, gen, G: int, reps: int):
    """The lee tail's draw step (int8 and int16 counters), observed entry
    and partial-only entry against their plain versions on the card:
    counts, observed values and the block partials must be equal. Returns
    {mode: numbers}."""
    nbk = plan.n_padded // B
    n = plan.n_padded
    wq, sw, far_q = banded._full_row_codes(plan)
    sw_row = sw.reshape(-1).contiguous()
    li = plan.local_idx.to(torch.int32).contiguous()
    n_live = banded._n_live_far(plan)
    ptr = banded._row_ptr(plan.far_src, n_live, B, n)
    fq8 = far_q[:n_live].to(torch.int8).contiguous()

    def codes(rows):
        return torch.randint(-127, 128, (rows, G), generator=gen, device=dev,
                             dtype=torch.int8)

    zp, zx = codes(n + 2 * B), codes(n)
    far = dict(far_row_ptr=ptr, far_q=fq8, Zf=codes(n_live))
    args = (li, wq, zp, B, zx, sw_row)
    # observed values of another placement: draws that tie, win and lose
    obs, _ = kern_lisa.lee_observed_plain(li, wq, codes(n + 2 * B), B, zx,
                                          sw_row, far_row_ptr=ptr, far_q=fq8,
                                          Zf=codes(n_live))
    lib = library_ms(band_csr(plan, dev), zp)
    results = {}

    def equal(label, got, want):
        sync(dev)
        err = float((got.double() - want.double()).abs().max())
        check(torch.equal(got, want), f"{label}: differs from plain (max |diff| "
              f"{err})")
        return err

    def timed_pair(kfn, pfn):
        return event_ms(kfn, reps), event_ms(pfn, max(1, reps // 10))

    for cdt in (torch.int8, torch.int16):
        cnt0 = torch.randint(0, 60, (n, G), generator=gen, device=dev).to(cdt)
        got_c, want_c = cnt0.clone(), cnt0.clone()
        got_p = kern_lisa.lee_count(*args, obs, got_c, **far)
        want_p = kern_lisa.lee_count_plain(*args, obs, want_c, **far)
        err = max(equal("lee_win counts", got_c, want_c),
                  equal("lee_win partials", got_p, want_p))
        moved = int((got_c != cnt0).sum())
        check(0 < moved < got_c.numel(), "lee_win: degenerate comparison case")
        ms = pms = float("nan")
        if cdt == torch.int8:
            scratch = cnt0.clone()
            ms, pms = timed_pair(
                lambda: kern_lisa.lee_count(*args, obs, scratch, **far),
                lambda: kern_lisa.lee_count_plain(*args, obs, scratch, **far))
        report(results, "lee_win", f"lee_win {str(cdt)[6:]} counters G={G} "
               f"({nbk} blocks, {moved:,} counts moved; counts and partials "
               f"equal)", err, ms, pms,
               *lee_work(plan, G, "lee_win", cnt0.element_size()), lib,
               first=cdt == torch.int8)
        if cdt == torch.int8:
            lisa_shapes("lee_win", "lee", "rows", 1, G, nbk, lambda tiles:
                        kern_lisa.lee_count(*args, obs, scratch, tiles=tiles, **far))
    got_o, got_p = kern_lisa.lee_observed(*args, **far)
    want_o, want_p = kern_lisa.lee_observed_plain(*args, **far)
    err = max(equal("lee_obs", got_o, want_o),
              equal("lee_obs partials", got_p, want_p))
    ms, pms = timed_pair(lambda: kern_lisa.lee_observed(*args, **far),
                         lambda: kern_lisa.lee_observed_plain(*args, **far))
    report(results, "lee_obs", f"lee_obs G={G} ({nbk} blocks; |Lq| and "
           f"partials equal)", err, ms, pms, *lee_work(plan, G, "lee_obs"), lib)
    lisa_shapes("lee_obs", "lee", "rows", 0, G, nbk, lambda tiles:
                kern_lisa.lee_observed(*args, tiles=tiles, **far))
    got_p = kern_lisa.lee_partial(*args, **far)
    err = equal("lee_partial", got_p, want_p)
    ms, pms = timed_pair(lambda: kern_lisa.lee_partial(*args, **far),
                         lambda: kern_lisa.lee_partial_plain(*args, **far))
    report(results, "lee_partial", f"lee_partial G={G} ({nbk} blocks; partials "
           f"equal)", err, ms, pms, *lee_work(plan, G, "lee_partial"), lib)
    lisa_shapes("lee_partial", "lee", "rows", 0, G, nbk, lambda tiles:
                kern_lisa.lee_partial(*args, tiles=tiles, **far))
    return results


def knn_library(xy: torch.Tensor, k: int, chunk: int = 4096) -> None:
    """torch.cdist + torch.topk over query chunks: the one-call yardstick
    of the kNN (self included and its distances through cuBLAS; its ties
    are not ordered by id)."""
    for q0 in range(0, xy.shape[0], chunk):
        torch.topk(torch.cdist(xy[q0:q0 + chunk], xy), k + 1, dim=1,
                   largest=False)


def knn_equal(label: str, got, want) -> float:
    """Check a kernel's (d2, ids) against its plain version's: ids and d2
    equal. Returns max |Δd2| (0.0 when equal), measured."""
    (got_d, got_i), (want_d, want_i) = got, want
    err = float((got_d.double() - want_d.double()).abs().max())
    rows = int((got_i != want_i).any(1).sum())
    check(rows == 0 and torch.equal(got_d, want_d), f"{label}: {rows} rows of "
          f"indices differ from plain, d2 by up to {err:.3e}")
    return err


def knn_floor_ms(n_pairs: float):
    """The FP32 instruction floor (ms) of an all-pairs kNN that ranks every
    pair by its exact d2: 5 and 6 unfused FP32 instructions a pair (2 FSUB,
    2 FMUL, 1 FADD, the compare) over F32_INSTR_RATE. K9 filters pairs
    more cheaply first, so this floors that design, not K9."""
    return 5 * n_pairs / F32_INSTR_RATE * 1e3, 6 * n_pairs / F32_INSTR_RATE * 1e3


def knn_bound_line(n: int, k: int) -> str:
    b_ms, b_by = bound(8 * n + 8 * n * k, 6 * n * n, "f32")
    lo, hi = knn_floor_ms(float(n) * n)
    return (f"all-pairs bound {b_ms:.4f} ms ({b_by}; 6 FP32 operations a pair over "
            f"67 TFLOP/s); exact-d2 scan's FP32 instruction floor {lo:.4f}-{hi:.4f} ms "
            f"(5-6 unfused instructions a pair over {F32_INSTR_RATE / 1e12:.1f} T/s)")


def knn_shapes(n: int, k: int, full: bool = True):
    """(label, KnnTiles) the phases time at (n, k): the chooser's shape and
    tiles of 512 and 1,024 points; with ``full`` also 2 and 4 ring stages
    and 128-thread CTAs."""
    t = kern_knn.knn_tiles(n, k)
    out = [("chooser", t)]
    out += [(f"tile {tl}", t._replace(tile=tl)) for tl in (512, 1024)]
    if full:
        out += [(f"{st} stages", t._replace(stages=st)) for st in (2, 4)]
        out.append(("128 threads", t._replace(threads=128)))
    return [(label, tiles) for i, (label, tiles) in enumerate(out)
            if tiles not in [x for _, x in out[:i]]]


def knn_split(xy: torch.Tensor, k: int, call_ms: float, reps: int) -> None:
    """One kNN call's time part by part (CUDA events): the wrapper's
    operands (Morton codes in torch ops, sorted; the gathered points and
    ids; the largest |coordinate|) and the kernel alone on them."""
    if xy.device.type != "cuda":        # a CPU rehearsal launches no kernel
        return
    tiles = kern_knn.knn_tiles(xy.shape[0], k)
    pre = event_ms(lambda: kern_knn.knn_operands(xy), reps)
    ops = kern_knn.knn_operands(xy)
    kernel = event_ms(lambda: kern_knn.knn_launch(*ops, k, False, tiles), reps)
    print(f"[knn-split] k={k} at {xy.shape[0]:,} cells: operands (Morton order, "
          f"gathered points and ids, max |coordinate|) {pre:.4f} ms, the kernel "
          f"alone {kernel:.4f} ms; the call {call_ms:.4f} ms")


def phase_knn_kernel(dev, gen, n: int = 66_536, ks=(6, 50), reps: int = 3,
                     holds=((6, 6000), (50, 6000), (130, 8192), (256, 8192))):
    """The kNN kernel against its plain version on the card at ``n``
    uniform cells (1M density; a multiple of neither a CTA's queries nor
    the candidate tile, so the last query tile has idle queries and the
    last candidate tile is partial) for each k: indices and squared
    distances equal, at the chooser's shape and at every shape of
    ``knn_shapes``, each timed. Then each (k, cells) of ``holds`` against
    its plain version at the chooser's shape. The first k gives the mode's
    times. Returns {"knn": numbers}."""
    xy = uniform_coords(n, SIDE * (n / 1e6) ** 0.5, gen, dev)
    xy = (xy - xy.mean(dim=0)).contiguous()
    results = {}
    for k in ks:
        want = kern_knn.knn_topk_plain(xy, k)
        err = knn_equal(f"knn k={k}", kern_knn.knn_topk(xy, k), want)
        ms = event_ms(lambda: kern_knn.knn_topk(xy, k), reps)
        pms = event_ms(lambda: kern_knn.knn_topk_plain(xy, k), 1)
        lms = event_ms(lambda: knn_library(xy, k), 1)
        report(results, "knn", f"knn k={k} at {n:,} cells (indices and d2 "
               f"equal; {kern_knn.knn_tiles(n, k)})", err, ms, pms,
               8 * n + 8 * n * k, 6 * n * n, "f32", lms, first=k == ks[0])
        print(f"[kernels] knn k={k} at {n:,} cells: {knn_bound_line(n, k)}")
        knn_split(xy, k, ms, reps)
        for label, tiles in knn_shapes(n, k):
            err = max(err, knn_equal(f"knn k={k} {label}", kern_knn.knn_topk_tiled(
                xy, k, False, tiles), want))
            t_ms = event_ms(lambda: kern_knn.knn_topk_tiled(xy, k, False, tiles), reps)
            print(f"[knn-shapes] k={k} {label}: {t_ms:.4f} ms ({tiles})")
        results["knn"]["max_abs_err"] = max(results["knn"]["max_abs_err"], err)
    for k, m in holds:
        xs = uniform_coords(m, SIDE * (m / 1e6) ** 0.5, gen, dev)
        xs = (xs - xs.mean(dim=0)).contiguous()
        for self_ in (False, True):
            err = knn_equal(f"knn k={k} at {m:,} cells", kern_knn.knn_topk(xs, k, self_),
                            kern_knn.knn_topk_plain(xs, k, self_))
            results["knn"]["max_abs_err"] = max(results["knn"]["max_abs_err"], err)
        t_ms = event_ms(lambda: kern_knn.knn_topk(xs, k), reps)
        print(f"[kernels] knn k={k} at {m:,} cells, with and without self: "
              f"indices and d2 equal to plain; {t_ms:.4f} ms "
              f"({kern_knn.knn_tiles(m, k)}); {knn_bound_line(m, k)}")
    return results


def knn_sass(listing: str) -> None:
    """Each kNN instance's registers, stack and spills (ptxas, from the
    build log) and SASS by opcode (the listing of the built library;
    ``python -m spatialcore_tpu_torch.kernels.sass --source
    spatialcore_tpu_torch/csrc/knn_topk.cu`` compiles the file alone)."""
    entry = None
    for ln in build.build_log().splitlines():
        if "Compiling entry" in ln:
            entry = (sass._demangle([ln.split("'")[1]])[0] if "knn_topk_cu" in ln
                     else None)
        elif entry and ("registers" in ln or "spill" in ln):
            print(f"[knn-build] {entry}: {ln.split(':', 1)[-1].strip()}")
    ops = ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "LDS", "LDGSTS", "SHFL", "VOTE",
           "ISETP", "SEL", "BRA", "BAR", "LDL", "STL")
    for name, c in sass.opcode_counts(listing).items():
        if "::knn_" in name:
            inst = name[name.index("::knn_") + 2:]
            inst = inst[:inst.find(">(") + 1] if ">(" in inst else inst[:inst.find("(")]
            print(f"[sass] {inst}: {sum(c.values())} instructions; "
                  + ", ".join(f"{op} {c[op]}" for op in ops if c[op]))


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
    return out, plan, tile0


def int_operands(plan, tile0, mode: str, G: int, step: int = 0):
    """The integer null's per-draw operands on the 1M plan, as
    ``banded_permutation_test`` makes them for draw ``step``: the int4
    (K1, windowed far) or int8 (K2 windowed far, K3 band only) codes of
    ``tile0``'s first G genes gathered by one Feistel draw. Returns
    (wrapper kwargs, gathered table, ops, timing pieces)."""
    packed = mode == "int4_win"
    dev = tile0["Zpk" if packed else "Zq8"].device
    if packed:
        check(G == 2 * tile0["Zpk"].shape[1], "K1 runs on the whole int4 tile")
        Ztab = tile0["Zpk"]
    else:
        Ztab = tile0["Zq8"][:, :G].contiguous()
    rows_idx = banded._padded_rows(plan, dev)
    ops, rif = banded._int_ops(plan, "int4" if packed else "int8",
                               "exact" if mode == "int8_band" else "win",
                               rows_idx, use_plain=False)
    idx_all = rows_idx if rif is None else torch.cat([rows_idx, rif])
    base = key_for(0, "perm_feistel", 0)
    perm_rows = feistel_apply(fold_in(base, step), idx_all, plan.n)
    L = rows_idx.shape[0]
    zp = Ztab[perm_rows[:L]]
    kw = dict(packed=packed)
    if ops.win:
        kw.update(far_row_ptr=ops.far_ptr, far_q=ops.win_ops[3].reshape(-1),
                  Zf=Ztab[perm_rows[L:]])
    args = (ops.local_idx32, ops.wq, ops.sw.reshape(-1).contiguous(), zp, B)
    return args, kw, dict(Ztab=Ztab, ops=ops, idx_all=idx_all, base=base, L=L)


def hold_int_1m(plan, tile0, modes=(("int4_win", 4096), ("int8_win", 1024),
                                    ("int8_band", 1024)), tag: str = "int"
                ) -> dict:
    """The integer kernel (``band_cross_int8``) at the main path's shapes
    on the 1M plan: K1 at 4,096 int4 genes, K2 and K3 at 1,024 int8 genes,
    each on one Feistel draw's gathered rows, held against its plain
    version within REL_TOL·Σ|terms| and timed beside its plain version,
    its bound and ``torch.sparse.mm`` of the band; then K1's other launch
    shapes (runs, tile widths) timed. Runs outside the counted window.
    ``modes`` and ``tag`` serve other plans (phase 11's radius plan).
    Returns {mode: max |error|}."""
    errs = {}
    nb, k = plan.n_padded // B, plan.local_idx.shape[1]
    csr = band_csr(plan, dev=next(iter(tile0.values())).device)
    for mode, G in modes:
        args, kw, _ = int_operands(plan, tile0, mode, G)
        packed = kw["packed"]
        li, wq, sw, zp, _ = args
        label = f"{mode} at {plan.n_padded:,} x {G:,}"

        def absc(t):
            return (banded._pack_codes(kern.unpack_nibbles(t).abs())
                    if packed else t.abs())

        got = kern.band_cross_int8(*args, **kw)
        want = kern.band_cross_int8_plain(*args, **kw)
        fabs = dict(kw, Zf=absc(kw["Zf"])) if "Zf" in kw else kw
        tol = REL_TOL * kern.band_cross_int8_plain(
            li, wq.to(torch.int16).abs(), sw, absc(zp), B, **fabs).double()
        err = (got.double() - want.double()).abs()
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite cross")
        check(bool((err <= tol + 1e-30).all()),
              f"{label}: kernel disagrees with plain (max err "
              f"{float(err.max()):.3e}, bound {float(tol.min()):.3e})")
        errs[mode] = float(err.max())
        del want, tol, fabs
        ms = event_ms(lambda: kern.band_cross_int8(*args, **kw), 5)
        plain_ms = event_ms(lambda: kern.band_cross_int8_plain(*args, **kw), 1)
        table = kern.unpack_nibbles(zp) if packed else zp
        lib = library_ms(csr, table, reps=3)
        del table
        torch.cuda.empty_cache()
        b_ms, b_by = bound(*cross_work(plan, mode, G))
        tiles = kern.int_tiles(B, k, packed, G, nb)
        print(f"[{tag}] {label}: max_abs_err={errs[mode]:.3e} (tolerance "
              f"{REL_TOL:g}·Σ|terms|) kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
              f"  bound {b_ms:.4f} ms ({b_by})  library {lib:.4f} ms; {tiles}")
        if mode == "int4_win":
            for name, t in (("run=1 (Zp read 3x)", tiles._replace(run=1)),
                            ("run=8", tiles._replace(run=8)),
                            ("run=16", tiles._replace(run=16)),
                            ("run=32", tiles._replace(run=32)),
                            ("run=64", tiles._replace(run=64)),
                            ("64-byte tiles",
                             kern.int_tiles(B, k, packed, G, nb, max_row_bytes=64))):
                vms = event_ms(lambda: kern.band_cross_int8_tiled(
                    li, wq, sw, zp, B, t, **kw), 5)
                print(f"[int] {label}, launch shape {name} {t}: {vms:.4f} ms")
        del args, kw, zp, li, wq, sw, got
        torch.cuda.empty_cache()
    return errs


def int_draw_split(plan, tile0, reps: int = 5):
    """One int4 global draw (K1, windowed far) at 1M × 4,096 part by part
    (CUDA events): Feistel rows (padded rows and far targets), the row
    gather, the far gather, K1, and the whole draw (Feistel rows and
    ``_banded_stat_int``, Moran)."""
    args, kw, p = int_operands(plan, tile0, "int4_win", 4096)
    Ztab, ops, idx_all, base, L = (p[k] for k in ("Ztab", "ops", "idx_all",
                                                  "base", "L"))
    perm_rows = feistel_apply(fold_in(base, 0), idx_all, plan.n)
    sz2 = tile0["sz"] * tile0["sz"]
    S0 = float(plan.n)
    steps = iter(range(1, 1 << 20))

    def draw():
        r = feistel_apply(fold_in(base, next(steps)), idx_all, plan.n)
        return banded._banded_stat_int(ops, plan.rc_sum, Ztab, sz2, tile0["den"],
                                       S0, r[:L], r[L:], n=plan.n, stat="moran",
                                       use_plain=False)

    split = dict(
        feistel=event_ms(lambda: feistel_apply(fold_in(base, 1), idx_all,
                                               plan.n), reps),
        row_gather=event_ms(lambda: Ztab[perm_rows[:L]], reps),
        far_gather=event_ms(lambda: Ztab[perm_rows[L:]], reps),
        kernel=event_ms(lambda: kern.band_cross_int8(*args, **kw), reps),
        whole_draw=event_ms(draw, reps))
    print(f"[int] one int4 draw (K1, windowed far, Moran) at {plan.n:,} x "
          f"4,096 (CUDA events, ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    return split


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


def lisa_draw_split(dev, d, reps: int = 5, tag: str = "lisa"):
    """One LISA draw at the public run's shape, part by part (CUDA events):
    Feistel rows, row gather, far gather, the draw-step kernel; then the
    draw step and the observed entry held against their plain versions on
    that plan (``hold_main``). Returns the split and the two holds."""
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
    print(f"[{tag}] one draw at {plan.n:,} cells x {G} genes (CUDA events, ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f" ({by}-bound); far edges {n_live:,}, far_bmax {plan.far_bmax}")
    # the draw step and the observed entry against their plain versions here
    csr = band_csr(plan, Zq.device)
    fwd, f0 = dict(Zf=Zf, **far), dict(Zf=Zp0[dst], **far)
    zero = torch.zeros_like(cnt)
    got = kern_lisa.lisa_count(li, wq, Zp, B, obs, zero.clone(), **fwd)
    want = kern_lisa.lisa_count_plain(li, wq, Zp, B, obs, zero.clone(), **fwd)
    check(int(got.sum(dtype=torch.int64)) > 0, "lisa_win at 1M: no count moved")
    shape = f"{plan.n:,} cells x {G} genes, k={plan.local_idx.shape[1]}"
    holds = {"lisa_win": hold_main(
        f"lisa_win at {shape}", got, want,
        lambda: kern_lisa.lisa_count(li, wq, Zp, B, obs, cnt, **fwd),
        lambda: kern_lisa.lisa_count_plain(li, wq, Zp, B, obs, cnt, **fwd),
        lisa_work(plan, G, "rows"), csr, Zp)}
    del got, want
    holds["lisa_obs"] = hold_main(
        f"lisa_obs at {shape}", kern_lisa.lisa_observed(li, wq, Zp0, B, **f0),
        kern_lisa.lisa_observed_plain(li, wq, Zp0, B, **f0),
        lambda: kern_lisa.lisa_observed(li, wq, Zp0, B, **f0),
        lambda: kern_lisa.lisa_observed_plain(li, wq, Zp0, B, **f0),
        lisa_work(plan, G, "rows", observed=True), csr, Zp0)
    return split, holds


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
    hold_k8(plan, Z)
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


def hold_k8(plan, Z) -> dict:
    """K8 (the dense-far draw step) at the vignette's own shape: one Feistel
    draw's gathered codes and dense far layer, as the "pallas" route builds
    them, held against the plain version and timed (``hold_main``)."""
    blk, n_pad = plan.block, plan.n_padded
    check(blk == B, f"the vignette's plan has B={blk}")
    Zq = banded._pad_cols4(banded._quantize_z(Z)[0])
    G = Zq.shape[1]
    wq, _, far_q = banded._full_row_codes(plan)
    li = plan.local_idx.to(torch.int32).contiguous()
    rows_idx = banded._padded_rows(plan, Zq.device)
    n_live = banded._n_live_far(plan)
    src, dst = plan.far_src[:n_live] - blk, plan.far_dst[:n_live]
    fq32 = far_q[:n_live].to(torch.int32)[:, None]

    def layer(Zp):
        out = torch.zeros((n_pad, G), dtype=torch.int32, device=Zq.device)
        return out.index_add_(0, src, Zp[dst].to(torch.int32) * fq32)

    Zp0 = Zq[rows_idx]
    obs = kern_lisa.lisa_observed(li, wq, Zp0, blk, far=layer(Zp0))
    Zp = Zq[feistel_apply(fold_in(key_for(5, "perm_feistel_local", 0), 0),
                          rows_idx, plan.n)]
    far = layer(Zp)
    cnt = torch.zeros(obs.shape, dtype=torch.int8, device=Zq.device)
    got = kern_lisa.lisa_count(li, wq, Zp, blk, obs, cnt.clone(), far=far)
    want = kern_lisa.lisa_count_plain(li, wq, Zp, blk, obs, cnt.clone(), far=far)
    check(int(got.sum(dtype=torch.int64)) > 0, "lisa_dense at the vignette: no "
          "count moved")
    return hold_main(f"lisa_dense (K8) at {plan.n:,} cells k={li.shape[1]} x {G} "
                     f"genes", got, want,
                     lambda: kern_lisa.lisa_count(li, wq, Zp, blk, obs, cnt, far=far),
                     lambda: kern_lisa.lisa_count_plain(li, wq, Zp, blk, obs, cnt,
                                                        far=far),
                     lisa_work(plan, G, "dense"), band_csr(plan, Zq.device), Zp)


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
    """Gi (star=False) with alternative="greater" through getis_ord_gi;
    returns the SpatialData."""
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
    return d


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
    """One draw of local Geary ("geary"), Gi* two-sided ("getis_star") or Gi
    "greater" ("getis_g") at the public run's shape, part by part (CUDA
    events): Feistel rows, row gather, far gather, the draw-step kernel; the
    observed pass once. Then the draw step and the observed entry held
    against their plain versions there (``hold_main``)."""
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
        obs_fns = (kern_lisa.geary_observed, kern_lisa.geary_observed_plain)

        def observed(Zp, fn=kern_lisa.geary_observed):
            return fn(li, w, Zp, B, w_code, far_row_ptr=ptr, far_q=fq, Zf=Zp[dst])
        obs = observed(Zq[rows_idx])

        def step(Zp, Zf, cnt, fn=kern_lisa.geary_count):
            return fn(li, w, Zp, B, obs, cnt, w_code, far_row_ptr=ptr, far_q=fq,
                      Zf=Zf)
        plain_step = kern_lisa.geary_count_plain
    else:
        star = stat == "getis_star"
        Zq = banded._pad_cols4(banded._quantize_x(d.X)[0])
        w = (plan.w_local > 0).to(torch.int8)
        fq = torch.ones(n_live, dtype=torch.int8, device=d.X.device)
        w_bin = w.to(torch.int32).sum(1, dtype=torch.int32).index_add_(
            0, src, fq.to(torch.int32)).to(torch.float32)
        tot, sq = banded._code_moments(Zq)
        inv_m = banded._inv_m(n, star)
        key = "perm_feistel_getis"
        obs_fns = (kern_lisa.getis_lag, kern_lisa.getis_lag_plain)

        def observed(Zp, fn=kern_lisa.getis_lag):
            return fn(li, w, Zp, B, far_row_ptr=ptr, far_q=fq, Zf=Zp[dst])
        Zp0 = Zq[rows_idx]
        lag_o = observed(Zp0)
        me_o = Zp0[B:B + n_pad].contiguous()
        del Zp0
        if star:
            obs = lag_o + me_o.to(torch.int32)
            del lag_o, me_o
            alt, fns = "two-sided", (kern_lisa.getis_star_count,
                                     kern_lisa.getis_star_count_plain)
            tail = dict(wp1=w_bin + 1.0, tm=tot * inv_m)
        else:
            obs = kern_lisa.gi_center(lag_o, me_o, w_bin, tot, sq, inv_m)
            alt, fns = "greater", (kern_lisa.getis_g_count,
                                   kern_lisa.getis_g_count_plain)
            tail = dict(w_row=w_bin, tot=tot, sq=sq, inv_m=inv_m, lag_o=lag_o,
                        me_o=me_o)

        def step(Zp, Zf, cnt, fn=fns[0]):
            return fn(li, w, Zp, B, obs, cnt, alternative=alt, far_row_ptr=ptr,
                      far_q=fq, Zf=Zf, **tail)
        plain_step = fns[1]
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
    mode = f"{stat}_win"
    obs_mode = "geary_obs" if stat == "geary" else "getis_obs"
    split["bound"], by = bound(*tail_work(plan, G, mode))
    split["observed_bound"], _ = bound(*tail_work(plan, G, obs_mode))
    print(f"[{stat}] one draw at {n:,} cells x {G} genes (CUDA events, ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f" ({by}-bound); far edges {n_live:,}")
    csr = band_csr(plan, Zq.device)
    zero = torch.zeros_like(cnt)
    got, want = step(Zp, Zf, zero.clone()), step(Zp, Zf, zero.clone(), fn=plain_step)
    check(int(got.sum(dtype=torch.int64)) > 0, f"{mode} at 1M: no count moved")
    hold_main(f"{mode} at {n:,} cells x {G} genes", got, want,
              lambda: step(Zp, Zf, cnt), lambda: step(Zp, Zf, cnt, fn=plain_step),
              tail_work(plan, G, mode), csr, Zp)
    del got, want
    Zp0 = Zq[rows_idx]
    hold_main(f"{obs_mode} at {n:,} cells x {G} genes", observed(Zp0),
              observed(Zp0, fn=obs_fns[1]), lambda: observed(Zp0),
              lambda: observed(Zp0, fn=obs_fns[1]), tail_work(plan, G, obs_mode),
              csr, Zp0)
    return split


# ---------------------------------------------------------------------------
# Phase 7: local Lee's L
# ---------------------------------------------------------------------------


def lee_adata(n_cells: int, n_pairs: int, gen, dev):
    """1M-density uniform cells and 2·``n_pairs`` genes, pair i = genes
    (2i, 2i+1); both genes of the first eighth of the pairs share a smooth
    signal. Values are small integers (noise in {−1, 0, 1}, signal
    round(3·sin(x/300))), and each column's sum is brought to 0 by moving
    |sum| of its cells one step (the first cells of one random order), so
    each column's mean (0) and sum of squares (< 2²⁴) are exact in float32
    in any order: the z-scores do not depend on how wide a batch of
    columns is, and the compact and full runs quantize the same codes.
    Returns (SpatialData, pairs, number of signal pairs)."""
    coords = uniform_coords(n_cells, SIDE * (n_cells / 1e6) ** 0.5, gen, dev)
    X = torch.randint(-1, 2, (n_cells, 2 * n_pairs), generator=gen,
                      device=dev).to(torch.float32)
    n_sig = max(1, n_pairs // 8)
    X[:, :2 * n_sig] += torch.round(3.0 * torch.sin(coords[:, :1] / 300.0))
    tot = X.sum(dim=0)                              # exact: |partials| < 2^24
    rank = torch.empty(n_cells, dtype=torch.int64, device=dev)
    rank[torch.randperm(n_cells, generator=gen, device=dev)] = torch.arange(
        n_cells, device=dev)
    X -= torch.sign(tot) * (rank[:, None] < tot.abs()[None, :])
    d = SpatialData(X=X)
    d.obsm["spatial"] = coords
    return d, [(str(2 * i), str(2 * i + 1)) for i in range(n_pairs)], n_sig


def phase_lee_public(dev, n_cells: int, n_pairs: int, n_full: int,
                     n_perms: int, gen):
    """lees_l_local(banded_int8, cell p-values) compact over ``n_pairs``,
    then full over the first ``n_full`` (its host obs columns); compact p,
    p_adj and L on the shared pairs equal the full run's casts."""
    d, pairs, n_sig = lee_adata(n_cells, n_pairs, gen, dev)
    out = {}
    kw = dict(null_method="banded_int8", n_permutations=n_perms, seed=3,
              compute_cell_pvalues=True, device=dev)
    _, out["compact_s"] = timed(lambda: lees_l_local(
        d, pairs, output_mode="compact", **kw), dev)
    comp = {k: d.obsm[f"lees_local_{k}"] for k in ("L", "p", "p_adj",
                                                   "quadrant")}
    check(comp["p"].dtype == torch.float16 and comp["p"].device == torch.device(dev)
          and tuple(comp["p"].shape) == (n_cells, n_pairs),
          "compact p: float16 [N, pairs] on the card")
    check(bool(torch.isfinite(comp["L"].float()).all()), "non-finite compact L")
    check(bool(((comp["p"] > 0) & (comp["p"] <= 1)).all()), "Lee p outside (0, 1]")
    sig = comp["p_adj"] < 0.05
    smooth = float(sig[:, :n_sig].float().mean())
    noise = float(sig[:, n_sig:].float().mean())
    print(f"[lee] lees_l_local(banded_int8, compact) {n_cells:,} cells x "
          f"{n_pairs} pairs x {n_perms} draws: {out['compact_s']:.3f} s; p_adj "
          f"< 0.05: signal pairs {smooth:.4f} of cells, noise pairs {noise:.6f}")
    check(smooth > 0.2, "signal pairs: too few significant Lee cells")
    check(noise < 1e-3, "noise pairs: significant Lee cells after FDR")
    _, out["full_s"] = timed(lambda: lees_l_local(
        d, pairs[:n_full], output_mode="full", use_existing_graph=True, **kw),
        dev)
    cols = [f"{gx}_{gy}" for gx, gy in pairs[:n_full]]
    p_full = torch.as_tensor(np.stack([d.obs[f"{c}_pvalue"].to_numpy()
                                       for c in cols], 1)).to(dev)
    L_full = torch.as_tensor(np.stack([d.obs[f"{c}_lees_l"].to_numpy()
                                       for c in cols], 1)).to(dev)
    check(torch.equal(comp["p"][:, :n_full], p_full.to(torch.float16)),
          "compact p differs from the full run's float16 cast")
    check(torch.equal(comp["p_adj"][:, :n_full], apply_fdr(
        p_full, "fdr_bh", axis=0, n_levels=n_perms + 1).to(torch.float16)),
        "compact p_adj differs from BH over the full run's p")
    check(torch.equal(comp["L"][:, :n_full], L_full.to(torch.bfloat16)),
          "compact L differs from the full run's bf16 cast")
    glob = [d.uns[f"{c}_lees_l_params"]["global_pvalue"] for c in cols]
    print(f"[lee] output_mode='full' over the first {n_full} pairs (stored graph "
          f"and plan): {out['full_s']:.3f} s; compact p, p_adj, L equal the "
          f"full run's casts; global p of the signal pairs "
          f"{max(glob[:max(1, n_full // 8)]):.4f} (max)")
    for c in cols:
        for sfx in ("lees_l", "quadrant", "pvalue"):
            del d.obs[f"{c}_{sfx}"]
    return d, pairs, n_sig, out


def lee_full_split(dev, d, pairs, n_perms: int, seed: int = 3):
    """lees_l_local's full mode over ``pairs`` part by part, in its order
    (host clock, each part synchronised): the stored graph, the
    standardized columns, the exact observed pass, the cached plan, the
    int8 null with cell p-values, the quadrants, the host copies, and the
    obs columns with their pandas join (built, not stored); then the whole
    call beside them, and once more under cProfile (its largest
    cumulative entries printed). Returns {part: seconds}."""
    split = {}

    def part(name, fn):
        out, split[name] = timed(fn, dev)
        return out

    graph = part("graph", lambda: acorr._get_graph(d, K, "spatial", True, dev))
    ok, Zx, Zy = part("columns", lambda: acorr._lees_columns(d, pairs, None, dev))
    res = part("observed", lambda: acorr.lees_l_pairs(graph, Zx, Zy, seed, 0))
    plan = part("plan", lambda: acorr._get_null_plan(d, graph, "spatial"))
    p_g, p_l = part("null", lambda: banded.banded_lees_l(
        plan, Zx, Zy, seed, n_perms, precision="int8",
        compute_cell_pvalues=True))
    quads = part("quadrants", lambda: acorr.classify_quadrants(
        Zx, res.lag_zy, None, 0.05))
    host = part("host_copies", lambda: [
        t.cpu().numpy() for t in (quads, res.L_local, res.L_global, p_g, p_l)])

    def obs_columns():
        q, L, _, _, pl = host
        cols = {}
        for i, (gx, gy) in enumerate(ok):
            cols[f"{gx}_{gy}_lees_l"] = L[:, i].astype(np.float32)
            cols[f"{gx}_{gy}_quadrant"] = pd.Categorical.from_codes(
                q[:, i].astype(np.int64), categories=acorr.LEE_QUADRANTS)
            cols[f"{gx}_{gy}_pvalue"] = pl[:, i].astype(np.float32)
        return pd.concat([d.obs, pd.DataFrame(cols, index=d.obs.index)], axis=1)

    part("obs_columns", obs_columns)
    print(f"[lee] lees_l_local full mode over {len(pairs)} pairs, part by part "
          f"(host clock, s): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                          split.items())
          + f"; sum {sum(split.values()):.3f}")
    # the whole call again beside its parts, then once under cProfile
    cols = [f"{gx}_{gy}_{sfx}" for gx, gy in pairs
            for sfx in ("lees_l", "quadrant", "pvalue")]
    kw = dict(null_method="banded_int8", n_permutations=n_perms, seed=seed,
              compute_cell_pvalues=True, output_mode="full",
              use_existing_graph=True, device=dev)
    _, split["whole_call"] = timed(lambda: lees_l_local(d, pairs, **kw), dev)
    d.obs = d.obs.drop(columns=cols)
    prof = cProfile.Profile()
    prof.enable()
    timed(lambda: lees_l_local(d, pairs, **kw), dev)
    prof.disable()
    d.obs = d.obs.drop(columns=cols)
    top = sorted((kv for kv in pstats.Stats(prof).stats.items()
                  if Path(kv[0][0]).name != Path(__file__).name),
                 key=lambda kv: -kv[1][3])
    print(f"[lee] the whole full-mode call again: {split['whole_call']:.3f} s; "
          f"under cProfile, cumulative s (own s): " + "; ".join(
              f"{fn} ({Path(f).name}:{ln}) {ct:.3f} ({tt:.3f})"
              for (f, ln, fn), (_, _, tt, ct, _) in top[:16]))
    return split


def phase_lee_global(dev, d, pairs, n_sig: int, n_perms: int):
    """lees_l at every pair through the int8 null (the partial-only entry)
    and through "auto" (the float32 null in torch ops at >= 100k cells),
    each with counts of its own."""
    out, launches = {}, {}
    for nm in ("banded_int8", "auto"):
        kern_lisa.reset_launch_counts()
        res, out[nm] = timed(lambda: lees_l(d, pairs, n_permutations=n_perms,
                                            seed=4, null_method=nm,
                                            use_existing_graph=True,
                                            device=dev), dev)
        launches[nm] = dict(kern_lisa.LAUNCHES)
        p = np.array([r["p_value"] for r in res])
        L = np.array([r["L"] for r in res])
        check(np.isfinite(L).all() and ((p > 0) & (p <= 1)).all(),
              f"lees_l({nm}): L or p out of range")
        check(float((p[:n_sig] <= 1 / (n_perms + 1) + 1e-9).mean()) > 0.9,
              f"lees_l({nm}): signal pairs not at the smallest p")
        print(f"[lee] lees_l({nm}) {d.n_obs:,} cells x {len(pairs)} pairs x "
              f"{n_perms} draws: {out[nm]:.3f} s; signal L mean "
              f"{L[:n_sig].mean():.1f}, noise L mean {L[n_sig:].mean():.2f}, "
              f"noise mean p {p[n_sig:].mean():.3f}; launches {launches[nm]}")
    check(launches["banded_int8"]["lee_partial"] == n_perms + 1
          and sum(launches["banded_int8"].values()) == n_perms + 1,
          "lees_l(banded_int8) did not run the partial-only entry per draw")
    check(not any(launches["auto"].values()),
          f"lees_l('auto') launched a kernel: {launches['auto']}")
    return out, launches


def phase_lee_direct(dev, gen, n_cells: int = 50_000, n_pairs: int = 64,
                     n_perms: int = 99):
    """The direct null (jax.random.permutation's stream on the card)
    through lees_l's "auto" below 100k cells."""
    d, pairs, n_sig = lee_adata(n_cells, n_pairs, gen, dev)
    kern_lisa.reset_launch_counts()
    res, t = timed(lambda: lees_l(d, pairs, n_permutations=n_perms, seed=5,
                                  device=dev), dev)
    p = np.array([r["p_value"] for r in res])
    check(((p > 0) & (p <= 1)).all(), "direct Lee p outside (0, 1]")
    check(float((p[:n_sig] <= 1 / (n_perms + 1) + 1e-9).mean()) > 0.9,
          "direct Lee null: signal pairs not at the smallest p")
    check(not any(kern_lisa.LAUNCHES.values()), "the direct null launched a "
          "kernel")
    print(f"[lee] lees_l('auto' -> direct null, permutation draws) {n_cells:,} "
          f"cells x {n_pairs} pairs x {n_perms} draws: {t:.3f} s (graph "
          f"included); noise mean p {p[n_sig:].mean():.3f}")
    return t


def lee_path_operands(dev, d, pairs):
    """The int8 Lee null's operands on the public run's plan for ``pairs``,
    built as ``banded._banded_lees_p_i8`` builds them: y codes, relabeled
    x codes, the weight codes and row scales, the row-pointer far edges,
    the padded identity rows, and the identity placement's observed |Lq|
    (the observed entry)."""
    plan = d._null_plan_cache["value"]
    names = list(d.var_names)
    ix = torch.as_tensor([names.index(g) for g, _ in pairs], device=dev)
    iy = torch.as_tensor([names.index(g) for _, g in pairs], device=dev)
    Zx = standardize(d.X.index_select(1, ix))[0]
    Zy = standardize(d.X.index_select(1, iy))[0]
    Yq = banded._pad_cols4(banded._quantize_z(Zy)[0])
    zx = banded._relabeled_x(plan, banded._pad_cols4(banded._quantize_z(Zx)[0]))
    del Zx, Zy
    wq, sw, far_q = banded._full_row_codes(plan)
    n_live = banded._n_live_far(plan)
    ptr, dst = banded._rows_far(plan, n_live)
    rows_idx = banded._padded_rows(plan, dev)
    o = dict(plan=plan, Yq=Yq, zx=zx, wq=wq, sw_row=sw.reshape(-1).contiguous(),
             li=plan.local_idx.to(torch.int32).contiguous(), n_live=n_live,
             dst=dst, rows_idx=rows_idx,
             far=dict(far_row_ptr=ptr, far_q=far_q[:n_live].to(torch.int8)))
    Yp0 = Yq[rows_idx]
    o["obs"], _ = kern_lisa.lee_observed(o["li"], wq, Yp0, B, zx, o["sw_row"],
                                         Zf=Yp0[dst], **o["far"])
    return o


def phase_lee_path_kernels(dev, d, pairs, seed: int = 3):
    """The lee entries against their plain versions at the main path's
    shape: the 1M-cell plan and one compact tile of ``len(pairs)`` pairs
    (the observed entry at the identity placement; the draw step and the
    partial-only entry at the first Feistel draw). Counts, |Lq| and
    partials equal. Returns {mode: max |diff|}."""
    o = lee_path_operands(dev, d, pairs)
    args = (o["li"], o["wq"])
    tail = (B, o["zx"], o["sw_row"])
    Yp0 = o["Yq"][o["rows_idx"]]
    rows = feistel_apply(fold_in(key_for(seed, "perm_feistel_lee", 0), 0),
                         o["rows_idx"], o["plan"].n)
    Yp = o["Yq"][rows]
    errs = {}

    def equal(label, got, want):
        err = float((got.double() - want.double()).abs().max())
        check(torch.equal(got, want), f"{label} at the main path's shape: "
              f"differs from plain (max |diff| {err})")
        errs[label] = err

    got_o, got_p = kern_lisa.lee_observed(*args, Yp0, *tail, Zf=Yp0[o["dst"]],
                                          **o["far"])
    want_o, want_p = kern_lisa.lee_observed_plain(*args, Yp0, *tail,
                                                  Zf=Yp0[o["dst"]], **o["far"])
    equal("lee_obs", got_o, want_o)
    equal("lee_obs partials", got_p, want_p)
    got_op, want_p0 = got_p, want_p
    got_c = torch.zeros(o["obs"].shape, dtype=torch.int8, device=dev)
    want_c = got_c.clone()
    Zf = Yp[o["dst"]]
    got_p = kern_lisa.lee_count(*args, Yp, *tail, o["obs"], got_c, Zf=Zf,
                                **o["far"])
    want_p = kern_lisa.lee_count_plain(*args, Yp, *tail, o["obs"], want_c, Zf=Zf,
                                       **o["far"])
    equal("lee_win counts", got_c, want_c)
    equal("lee_win partials", got_p, want_p)
    moved = int(got_c.sum(dtype=torch.int64))
    check(0 < moved < got_c.numel(), "lee_win at the main path's shape: "
          "degenerate case")
    equal("lee_partial", kern_lisa.lee_partial(*args, Yp, *tail, Zf=Zf,
                                               **o["far"]), want_p)
    # times at the tile's own width (hold_main checks the pairs again)
    G, plan, csr = o["Yq"].shape[1], o["plan"], band_csr(o["plan"], dev)
    cnt = got_c.clone()
    shape = f"{plan.n:,} cells x {G} pairs"
    hold_main(f"lee_win at {shape}", (got_c, got_p), (want_c, want_p),
              lambda: kern_lisa.lee_count(*args, Yp, *tail, o["obs"], cnt, Zf=Zf,
                                          **o["far"]),
              lambda: kern_lisa.lee_count_plain(*args, Yp, *tail, o["obs"], cnt,
                                                Zf=Zf, **o["far"]),
              lee_work(plan, G, "lee_win"), csr, Yp)
    f0 = dict(Zf=Yp0[o["dst"]], **o["far"])
    hold_main(f"lee_obs at {shape}", (got_o, got_op), (want_o, want_p0),
              lambda: kern_lisa.lee_observed(*args, Yp0, *tail, **f0),
              lambda: kern_lisa.lee_observed_plain(*args, Yp0, *tail, **f0),
              lee_work(plan, G, "lee_obs"), csr, Yp0)
    print(f"[lee] lee entries at the main path's shape ({o['plan'].n_padded:,} "
          f"rows x {o['Yq'].shape[1]} pairs, one draw, {moved:,} counts): "
          f"counts, |Lq| and partials equal their plain versions; max |diff| "
          f"{max(errs.values()):.3e}")
    return errs


def lee_draw_split(dev, d, pairs, reps: int = 5):
    """One int8 Lee draw at the public run's shape over every pair, part by
    part (CUDA events): Feistel rows, permutation rows (the "sort"
    stream), row gather, far gather, the draw-step kernel, the fixed-order
    reduction of the block partials; the observed entry once."""
    o = lee_path_operands(dev, d, pairs)
    plan, Yq, zx, wq, sw_row, li = (o[k] for k in ("plan", "Yq", "zx", "wq",
                                                   "sw_row", "li"))
    dst, rows_idx, far, obs = o["dst"], o["rows_idx"], o["far"], o["obs"]
    G = Yq.shape[1]
    Yp0 = Yq[rows_idx]
    cnt = torch.zeros(obs.shape, dtype=torch.int8, device=dev)
    base = key_for(3, "perm_feistel_lee", 0)
    sort_base = key_for(3, "perm_lee", 0)
    rows = feistel_apply(fold_in(base, 0), rows_idx, plan.n)
    Yp = Yq[rows]
    Zf = Yp[dst]
    part = kern_lisa.lee_count(li, wq, Yp, B, zx, sw_row, obs, cnt, Zf=Zf, **far)
    split = dict(
        feistel=event_ms(lambda: feistel_apply(fold_in(base, 1), rows_idx, plan.n),
                         reps),
        permutation=event_ms(lambda: permutation(fold_in(sort_base, 1), plan.n,
                                                 device=dev)[rows_idx], reps),
        row_gather=event_ms(lambda: Yq[rows], reps),
        far_gather=event_ms(lambda: Yp[dst], reps),
        kernel=event_ms(lambda: kern_lisa.lee_count(li, wq, Yp, B, zx, sw_row,
                                                    obs, cnt, Zf=Zf, **far), reps),
        partial_sum=event_ms(lambda: banded._tree_sum(part), reps),
        observed=event_ms(lambda: kern_lisa.lee_observed(
            li, wq, Yp0, B, zx, sw_row, Zf=Yp0[dst], **far), 2))
    steps = iter(range(1, 1 << 20))

    def draw():
        yp = Yq[feistel_apply(fold_in(base, next(steps)), rows_idx, plan.n)]
        banded._tree_sum(kern_lisa.lee_count(li, wq, yp, B, zx, sw_row, obs, cnt,
                                             Zf=yp[dst], **far))

    split["whole_draw"] = event_ms(draw, reps)
    split["bound"], by = bound(*lee_work(plan, G, "lee_win"))
    split["observed_bound"], _ = bound(*lee_work(plan, G, "lee_obs"))
    print(f"[lee] one draw at {plan.n:,} cells x {G} pairs (CUDA events, ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f" ({by}-bound); far edges {o['n_live']:,}")
    return split


def phase_lee_vs_cpu(dev, coords: np.ndarray, n_genes: int, seed: int,
                     n_perms: int = 49):
    """lees_l_local(banded_int8) on the card against the port's CPU path on
    the same integer-valued input: full mode (cell p, quadrants with the
    significance filter, global p) and compact mode (p_adj) bitwise.
    Returns the card runs' launch counts."""
    card, host = exact_pair(coords, n_genes, seed, dev)
    pairs = [(str(2 * i), str(2 * i + 1)) for i in range(n_genes // 2)]
    run = dict(null_method="banded_int8", n_permutations=n_perms, seed=seed,
               compute_cell_pvalues=True)
    kern_lisa.reset_launch_counts()
    lees_l_local(card, pairs, significance_filter=True, device=dev, **run)
    lees_l_local(card, pairs, output_mode="compact", device=dev, **run)
    sync(dev)
    launches = dict(kern_lisa.LAUNCHES)
    lees_l_local(host, pairs, significance_filter=True, device="cpu", **run)
    lees_l_local(host, pairs, output_mode="compact", device="cpu", **run)
    for gx, gy in pairs:
        key = f"{gx}_{gy}"
        for sfx in ("pvalue", "quadrant"):
            check(card.obs[f"{key}_{sfx}"].equals(host.obs[f"{key}_{sfx}"]),
                  f"Lee {key}: card {sfx} differs from the CPU path")
        a, b = card.uns[f"{key}_lees_l_params"], host.uns[f"{key}_lees_l_params"]
        check(a["global_pvalue"] == b["global_pvalue"]
              and a["quadrant_counts"] == b["quadrant_counts"],
              f"Lee {key}: card global p or quadrant counts differ")
    for k in ("p", "p_adj", "quadrant"):
        got = card.obsm[f"lees_local_{k}"]
        want = torch.as_tensor(host.obsm[f"lees_local_{k}"]).to(got.dtype)
        check(torch.equal(got.cpu(), want), f"Lee compact {k}: card differs "
              "from the CPU path")
    print(f"[lee] {coords.shape[0]:,} scattered cells x {len(pairs)} pairs: card "
          f"equals the CPU path (p, quadrants, global p, compact p / p_adj / "
          f"quadrants bitwise); launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 8: the graph path through the kNN kernel
# ---------------------------------------------------------------------------


def phase_graph_pallas(dev, gen, shapes=((1_000_000, 6, 4096, False),
                                          (366_938, 50, None, True))):
    """build_graph(method="pallas") at each (cells, k), timed, with the kNN
    launch count read around that call alone. Then, on the same
    host-centred coordinates the call gives the kernel, the kernel against
    its plain version (every query, or the first and last ``edge`` queries:
    the last query block and, for every query, the last candidate tile are
    partial at these sizes): indices and d2 equal, and the graph's
    neighbours and distances equal to the kernel's. Last, against
    method="grid": rows whose neighbour set differs are counted (expected
    0 away from distance ties at the k-th neighbour). Returns (kNN
    launches, {cells: (seconds, differing rows)})."""
    out, launches = {}, 0
    for n, k, edge, library in shapes:
        coords = uniform_coords(n, SIDE * (n / 1e6) ** 0.5, gen, dev)
        kern_knn.reset_launch_counts()
        gp, t = timed(lambda: build_graph(coords, n_neighbors=k, method="pallas",
                                          device=dev), dev)
        launches += kern_knn.LAUNCHES["knn"]
        xy = centred_xy(coords, dev)
        got_d, got_i = kern_knn.knn_topk(xy, k)
        for label, tiles in knn_shapes(n, k, full=False):
            knn_equal(f"knn at {n:,} cells k={k} {label}", kern_knn.knn_topk_tiled(
                xy, k, False, tiles), (got_d, got_i))
            t_ms = event_ms(lambda: kern_knn.knn_topk_tiled(xy, k, False, tiles), 1)
            print(f"[graph] kNN kernel at {n:,} cells k={k}, {label}: "
                  f"{t_ms:.4f} ms ({tiles})")
        print(f"[graph] kNN at {n:,} cells k={k}: {knn_bound_line(n, k)}")
        knn_split(xy, k, float("nan"), 1)
        if library:
            _, t_lib = timed(lambda: knn_library(xy, k), dev)
            print(f"[graph] torch.cdist + torch.topk at {n:,} cells k={k}: "
                  f"{t_lib * 1e3:.4f} ms (one call, host clock around a "
                  f"synchronised run)")
        check(torch.equal(gp.neighbor_idx, got_i)
              and torch.equal(gp.distances, torch.sqrt(got_d)),
              "build_graph(method='pallas') differs from the kernel's output")
        q = (None if edge is None else
             torch.cat([torch.arange(edge), torch.arange(n - edge, n)]).to(dev))
        (want_d, want_i), tp = timed(lambda: kern_knn.knn_topk_plain(
            xy, k, queries=q), dev)
        if q is not None:
            got_d, got_i = got_d[q], got_i[q]
        err = knn_equal(f"knn at {n:,} cells k={k}", (got_d, got_i),
                        (want_d, want_i))
        print(f"[graph] kNN kernel at {n:,} cells k={k} equals its plain version "
              f"on the graph call's centred coordinates over "
              f"{'every query' if q is None else f'the first and last {edge:,} queries'}"
              f" (max |d2 diff| {err:.3e}; plain {tp:.3f} s)")
        del got_d, got_i, want_d, want_i, xy
        gg, tg = timed(lambda: build_graph(coords, n_neighbors=k, method="grid",
                                           device=dev), dev)
        same = (torch.sort(gp.neighbor_idx, 1).values
                == torch.sort(gg.neighbor_idx, 1).values).all(1)
        n_diff = int((~same).sum())
        # a differing row must be a tie at float32 resolution: the kernel
        # ranks distances of coordinates centred on the host (each rounded
        # to the centred value's ulp), the grid search uncentred ones, so
        # distances may part by a few ulps of the coordinate scale
        tol = 4 * float(np.spacing(np.float32(float(coords.abs().max()))))
        gap = (float((gp.distances[~same] - gg.distances[~same]).abs().max())
               if n_diff else 0.0)
        check(n_diff <= n // 1000 and gap <= tol,
              f"{n_diff} rows differ from the grid search, distances by up to "
              f"{gap:.3e} (ties allow {tol:.3e})")
        check(bool(torch.isfinite(gp.distances).all()), "non-finite distances")
        out[n] = (t, n_diff)
        print(f"[graph] build_graph(method='pallas') {n:,} cells k={k}: "
              f"{t:.3f} s (grid {tg:.3f} s); rows differing from the grid "
              f"search: {n_diff}, their distances within {gap:.3e} (a tie at "
              f"float32 resolution; {tol:.3e} allowed)")
        del gp, gg, coords
    return launches, out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 9: the global null's remaining routes
# ---------------------------------------------------------------------------


def phase_dense_routes(dev, gen, n_cells: int = 1_000_000, n_genes: int = 1024,
                       n_perms: int = 8):
    """banded_permutation_test(bf16) through "auto" (K4), "pallas" (K5) and
    "pallas_halo4" (K6) on one 1M-cell plan: each route's launch counts of
    its own, counts within ±1 draw of K4's, null mean / std within rtol
    1e-4; per-draw ms (call set-up included); K5 and K6 held against their
    plain versions on one gathered table at this shape in bf16 and (at 512
    genes) f32, each timed beside its bound, ``torch.bmm`` of the dense
    band against the stacked windows and its other launch shapes, with the
    share of tiles skipped; K4 held against its plain version there in
    bf16 and f32. Returns ({route: launches}, {mode: max |error|})."""
    coords = uniform_coords(n_cells, SIDE, gen, dev)
    graph = build_graph(coords, n_neighbors=K, device=dev)
    plan = build_null_plan(graph, coords, block=B)
    X = torch.randn((n_cells, n_genes), generator=gen, device=dev)
    X[:, :n_genes // 8] += torch.sin(coords[:, :1] / 300.0)
    Z, _ = standardize(X)
    del X
    S0 = float(n_cells)
    obs = moran_observed(graph, Z, S0)
    Zb = Z.to(torch.bfloat16)
    Z32 = Z[:, :n_genes // 2].contiguous()
    den = (Z * Z).sum(dim=0)
    del Z
    routes = {"auto": "float", "pallas": "dense", "pallas_halo4": "rot4"}
    res, launches = {}, {}
    for impl, mode in routes.items():
        kern.reset_launch_counts()
        res[impl], t = timed(lambda: banded_permutation_test(
            plan, Zb, S0, obs, 3, n_perms, precision="bf16", band_impl=impl,
            den=den), dev)
        launches[impl] = dict(kern.LAUNCHES)
        check(launches[impl][mode] == n_perms
              and sum(launches[impl].values()) == n_perms,
              f"band_impl={impl!r} did not launch {mode} once per draw: "
              f"{launches[impl]}")
        print(f"[dense] banded_permutation_test(bf16, band_impl={impl!r}) "
              f"{n_cells:,} x {n_genes} x {n_perms}: {t:.3f} s, "
              f"{t / n_perms * 1e3:.2f} ms/draw (set-up included); launches "
              f"{launches[impl]}")
    p0, m0, s0 = res["auto"]
    for impl in ("pallas", "pallas_halo4"):
        p, m, sd = res[impl]
        dc = (torch.round(p * (n_perms + 1) - 1)
              - torch.round(p0 * (n_perms + 1) - 1)).abs()
        check(float(dc.max()) <= 1, f"{impl}: counts differ from K4's by > 1")
        check(torch.allclose(m, m0, rtol=1e-4, atol=1e-4 * float(m0.abs().max()))
              and torch.allclose(sd, s0, rtol=1e-4, atol=1e-4 * float(s0.max())),
              f"{impl}: null mean / std differ from K4's")
        print(f"[dense] {impl}: counts within {int(dc.max())} draw of K4's, "
              f"null mean / std within rtol 1e-4")
    # the three kernels on one gathered table at this shape
    nb = plan.n_padded // B
    rows = banded._padded_rows(plan, dev)
    zp = Zb[rows]
    w = plan.w_local.to(torch.bfloat16)
    li = plan.local_idx.to(torch.int32)
    zp32 = Z32[rows]
    del Z32
    errs = {"float": hold_float_1m(plan, li, zp32, n_genes // 2)}
    errs["float"] = max(errs["float"], hold_float_1m(plan, li, zp, n_genes))
    float_draw_split(plan, Zb, den, S0)
    times = {}
    for mode, build_fn, fn, plain in (
            ("dense", banded._build_band, kern.band_cross_dense,
             kern.band_cross_dense_plain),
            ("rot4", banded._build_band_rot4, kern.band_cross_rot4,
             kern.band_cross_rot4_plain)):
        for table in (zp, zp32):
            dt = table.dtype
            dtype = "bf16" if dt == torch.bfloat16 else "f32"
            label = f"{mode} {dtype} at {n_cells:,} x {table.shape[1]:,}"
            A = build_fn(plan.local_idx, plan.w_local.to(dt), B, dt)
            err = hold_dense(label, fn, plain, A, table)
            errs[mode] = max(errs.get(mode, 0.0), err)
            print(f"[dense] {label}: max_abs_err={err:.3e} against its plain "
                  f"version (tolerance {REL_TOL:g}·Σ|terms|); {skip_share(A)}")
            ms = event_ms(lambda: fn(A, table, B), 5)
            win = stacked_windows(table, nb, 3 if mode == "dense" else 4)
            bmm_ms = event_ms(lambda: torch.bmm(A, win), 3)
            del win
            torch.cuda.empty_cache()
            times[label] = (ms, *bound(*dense_work(A, table)), bmm_ms)
            dense_shapes(label, mode, A, table, 5)
            del A
            torch.cuda.empty_cache()
    for label, (ms, b_ms, by, bmm_ms) in times.items():
        print(f"[dense] {label} ({nb} blocks), one draw: kernel {ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({by}), bmm of the dense band {bmm_ms:.4f} ms")
    return launches, errs


def float_draw_split(plan, Zb, den, S0: float, reps: int = 5):
    """One bf16 global draw through "auto" (K4) at the phase's shape, part
    by part (CUDA events): Feistel rows, the row gather, K4, the far-edge
    terms, Geary's Σ z1² term (only ``stat="geary"`` pays it), and the
    whole Moran draw (Feistel rows and ``_banded_stat_float``)."""
    li = plan.local_idx.to(torch.int32)
    w = plan.w_local.to(torch.bfloat16)
    rows_idx = banded._padded_rows(plan, Zb.device)
    base = key_for(3, "perm_feistel", 0)
    rows = feistel_apply(fold_in(base, 0), rows_idx, plan.n)
    zp = Zb[rows]
    fw = plan.far_w.to(torch.bfloat16).to(torch.float32)
    nb = plan.n_padded // B

    def far_terms():
        return (fw[:, None] * zp[plan.far_src].to(torch.float32)
                * zp[plan.far_dst].to(torch.float32)).sum(dim=0)

    def geary_sq():
        z1 = zp[B:B + nb * B].to(torch.float32)
        return plan.rc_sum @ (z1 * z1)

    steps = iter(range(1, 1 << 20))

    def draw():
        r = feistel_apply(fold_in(base, next(steps)), rows_idx, plan.n)
        return banded._banded_stat_float(
            li, w, None, plan.far_src, plan.far_dst, plan.far_w, plan.rc_sum,
            Zb, den, S0, r, block=B, n=plan.n, stat="moran", band_impl="auto")

    split = dict(
        feistel=event_ms(lambda: feistel_apply(fold_in(base, 1), rows_idx,
                                               plan.n), reps),
        row_gather=event_ms(lambda: Zb[rows], reps),
        kernel=event_ms(lambda: kern.band_cross_float(li, w, zp, B), reps),
        far_terms=event_ms(far_terms, reps),
        geary_sq=event_ms(geary_sq, reps),
        whole_draw=event_ms(draw, reps))
    print(f"[dense] one bf16 draw ('auto' -> K4, Moran) at {plan.n:,} x "
          f"{Zb.shape[1]:,} (CUDA events, ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    return split


def hold_float_1m(plan, li, zp, G: int, tag: str = "dense") -> float:
    """K4 (``band_cross_float``) on ``zp`` at the 1M plan's shape: held
    against its plain version within REL_TOL·Σ|terms|, timed beside its
    plain version, its bound and ``torch.sparse.mm`` of the band; then
    other launch shapes (runs, ring widths) of the same kernel timed.
    Returns the max |error|."""
    mode = "bf16" if zp.dtype == torch.bfloat16 else "f32"
    w = plan.w_local.to(zp.dtype)
    label = f"K4 {mode} at {plan.n_padded:,} x {G:,}"
    got = kern.band_cross_float(li, w, zp, B)
    want = kern.band_cross_float_plain(li, w, zp, B)
    tol = REL_TOL * kern.band_cross_float_plain(li, w.abs(), zp.abs(), B).double()
    err = (got.double() - want.double()).abs()
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite cross")
    check(bool((err <= tol + 1e-30).all()),
          f"{label}: kernel disagrees with plain (max err "
          f"{float(err.max()):.3e}, bound {float(tol.min()):.3e})")
    del want, tol
    ms = event_ms(lambda: kern.band_cross_float(li, w, zp, B), 5)
    plain_ms = event_ms(lambda: kern.band_cross_float_plain(li, w, zp, B), 1)
    lib = library_ms(band_csr(plan, dev=zp.device), zp, reps=5)
    b_ms, b_by = bound(*cross_work(plan, mode, G))
    nb, k = plan.n_padded // B, li.shape[1]
    tiles = kern.float_tiles(B, k, zp.element_size(), G, nb)
    print(f"[{tag}] {label}: max_abs_err={float(err.max()):.3e} (tolerance "
          f"{REL_TOL:g}·Σ|terms|) kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
          f"bound {b_ms:.4f} ms ({b_by})  library {lib:.4f} ms; {tiles}")
    for name, t in (("run=1 (Zp read 3x)", tiles._replace(run=1)),
                    ("run=8", tiles._replace(run=8)),
                    ("run=16", tiles._replace(run=16)),
                    ("run=64", tiles._replace(run=64)),
                    ("64-byte ring rows",
                     kern.float_tiles(B, k, zp.element_size(), G, nb,
                                      max_row_bytes=64))):
        vms = event_ms(lambda: kern.band_cross_float_tiled(li, w, zp, B, t), 5)
        print(f"[{tag}] {label}, launch shape {name} {t}: {vms:.4f} ms")
    torch.cuda.empty_cache()
    return float(err.max())


class DrawTimer:
    """Times every banded_permutation_test call (synchronised) while
    active, so a streaming run splits into draws and the rest (prep)."""

    def __init__(self, dev):
        self.dev, self.seconds, self.calls = dev, 0.0, 0
        self._orig = banded.banded_permutation_test

    def __enter__(self):
        def wrapped(*args, **kw):
            out, t = timed(lambda: self._orig(*args, **kw), self.dev)
            self.seconds += t
            self.calls += 1
            return out
        banded.banded_permutation_test = wrapped
        return self

    def __exit__(self, *exc):
        banded.banded_permutation_test = self._orig


def phase_streaming(dev, n_cells: int = 1_000_000, n_perms: int = 8,
                    int4_genes: int = 18_432, bf16_genes: int = 4096):
    """streaming_moran_null at the north-star shape (int4, 1M × 18,432, tile
    4096) and through K5 (bf16, 1M × 4,096, tile 2048, band_impl="pallas"),
    data made per tile on the card from a seed (the first eighth of each
    tile smooth). Returns each run's launch counts."""
    gen = torch.Generator(device=dev).manual_seed(9)
    coords = uniform_coords(n_cells, SIDE, gen, dev)
    graph = build_graph(coords, n_neighbors=K, device=dev)
    plan = build_null_plan(graph, coords, block=B)
    wave = torch.sin(coords[:, :1] / 300.0)

    def get_tile(start, width, ci):
        g = torch.Generator(device=dev).manual_seed(1000 + start)
        X = torch.randn((n_cells, width), generator=g, device=dev)
        X[:, :width // 8] += wave
        return X

    out = {}
    for label, n_genes, kw in (
            ("int4", int4_genes, dict(precision="int4", tile=4096)),
            ("bf16 pallas", bf16_genes, dict(precision="bf16", tile=2048,
                                             band_impl="pallas"))):
        kern.reset_launch_counts()
        with DrawTimer(dev) as dt:
            (I, p, m, sd), t = timed(lambda: streaming_moran_null(
                graph, plan, get_tile, n_genes, float(n_cells), seed=5,
                n_permutations=n_perms, chunk=n_perms, device=dev, **kw), dev)
        out[label] = dict(kern.LAUNCHES)
        check(I.shape == p.shape == (n_genes,) and bool(np.isfinite(I).all())
              and bool(np.isfinite(m).all()), f"streaming {label}: bad output")
        check(bool(((p > 0) & (p <= 1)).all()), f"streaming {label}: p outside (0, 1]")
        # get_tile's smooth genes: the first eighth of each prep chunk
        smooth = np.zeros(n_genes, bool)
        for s0 in range(0, n_genes, 1024):
            smooth[s0:s0 + min(1024, n_genes - s0) // 8] = True
        sig = p[smooth]
        check(float((sig <= 1 / (n_perms + 1) + 1e-6).mean()) > 0.9,
              f"streaming {label}: smooth genes not at the smallest p")
        print(f"[stream] streaming_moran_null({label}, tile={kw['tile']}) "
              f"{n_cells:,} x {n_genes:,} genes x {n_perms} draws: {t:.3f} s = "
              f"draws {dt.seconds:.3f} s ({dt.calls} calls, "
              f"{dt.seconds / (dt.calls * n_perms) * 1e3:.2f} ms per tile-draw) "
              f"+ prep {t - dt.seconds:.3f} s; {n_genes * n_perms / t:.1f} "
              f"genes*perms/s; launches {out[label]}")
    check(out["int4"]["int4_win"] == len(tile_widths(int4_genes, 4096))
          * (n_perms + 1),
          f"the int4 streaming run did not launch K1 per draw and observed "
          f"value: {out['int4']}")
    check(out["bf16 pallas"]["dense"] == len(tile_widths(bf16_genes, 2048))
          * n_perms,
          f"streaming through band_impl='pallas' did not launch K5 per draw: "
          f"{out['bf16 pallas']}")
    return out


def phase_global_public(dev, gen, n_cells: int = 1_000_000):
    """global_autocorrelation (fused) against separate calls at 1M × 1,024;
    the "sort" stream against permutation_test_global and the slot null at
    1M × 64; "auto" -> slots at 50,000 × 128."""
    d = make_adata(n_cells, 1024, gen, dev)
    kw = dict(n_permutations=19, seed=4, null_method="banded_int8",
              gene_batch_size=1024, device=dev)
    kern.reset_launch_counts()
    _, t_f = timed(lambda: global_autocorrelation(d, keys_added=("mi", "gc"),
                                                  **kw), dev)
    fused = dict(kern.LAUNCHES)
    _, t_m = timed(lambda: morans_i(d, use_existing_graph=True, **kw), dev)
    _, t_g = timed(lambda: gearys_c(d, use_existing_graph=True, **kw), dev)
    for a, b in (("mi", "morans_i"), ("gc", "gearys_c")):
        check(np.array_equal(d.uns[a]["p_value"].to_numpy(),
                             d.uns[b]["p_value"].to_numpy()),
              f"global_autocorrelation {a} p differs from {b}'s")
    p = d.uns["mi"]["p_value"].to_numpy()
    check(float((p[:128] <= 1 / 20 + 1e-9).mean()) > 0.9,
          "global_autocorrelation: smooth genes not significant")
    print(f"[global] global_autocorrelation(banded_int8) {n_cells:,} x 1,024 x 19: "
          f"{t_f:.3f} s (launches {fused}); morans_i {t_m:.3f} s + gearys_c "
          f"{t_g:.3f} s; p bitwise equal to the separate calls")
    check(fused["int8_win"] == 20, f"the fused pass did not launch one int8 "
          f"kernel per draw and one for the observed value: {fused}")
    del d
    torch.cuda.empty_cache()

    d = make_adata(n_cells, 64, gen, dev)
    _, t_s = timed(lambda: morans_i(d, n_permutations=19, seed=2,
                                    null_method="slots", device=dev), dev)
    df = d.uns["morans_i"]
    check(float((df["p_value"][:8] <= 1 / 20 + 1e-9).mean()) > 0.9
          and bool(np.isfinite(df["I"]).all()), "slot null: bad output")
    # the "sort" stream draws the slot null's permutations
    graph = acorr._load_stored_graph(d, dev)
    plan = build_null_plan(graph, d.obsm["spatial"], block=B)
    Z, _ = standardize(d.X)
    S0 = float(n_cells)
    obs = moran_observed(graph, Z, S0)
    (p_s, m_s, _), t_sort = timed(lambda: banded_permutation_test(
        plan, Z, S0, obs, 6, 19, precision="f32", perm_method="sort"), dev)
    (p_g, m_g, _), t_glob = timed(lambda: permutation_test_global(
        graph, Z, S0, obs, 6, 19), dev)
    dp = float((p_s - p_g).abs().max())
    dm = float((m_s - m_g).abs().max())
    check(dp <= 0.02 and dm <= 1e-5, f"sort stream vs slot null: p {dp:.3g}, "
          f"mean {dm:.3g}")
    print(f"[global] morans_i(slots) {n_cells:,} x 64 x 19: {t_s:.3f} s; "
          f"banded_permutation_test(f32, sort) {t_sort:.3f} s vs "
          f"permutation_test_global {t_glob:.3f} s on the same draws: p within "
          f"{dp:.3g}, means within {dm:.3g}")
    del d, Z, graph, plan
    torch.cuda.empty_cache()

    d = make_adata(50_000, 128, gen, dev)
    _, t_a = timed(lambda: morans_i(d, n_permutations=99, seed=1, device=dev), dev)
    nm = get_operations(d)[-1]["parameters"]["null_method"]
    check(nm == "slots", f"'auto' at 50,000 cells resolved to {nm!r}")
    print(f"[global] morans_i('auto' -> {nm}) 50,000 x 128 x 99: {t_a:.3f} s")


def phase_slots_vs_cpu(dev, coords: np.ndarray, n_genes: int, seed: int,
                       n_perms: int = 49):
    """The slot null on the card against the port's CPU path at 4,096
    cells: permutations bitwise, counts within ±1 draw."""
    base = key_for(seed, "perm_global", 0)
    for d in (0, 1, n_perms - 1):
        k = fold_in(base, d)
        check(torch.equal(permutation(k, coords.shape[0], device=dev).cpu(),
                          permutation(k, coords.shape[0], device="cpu")),
              f"draw {d}: the card's permutation differs from the CPU's")
    card, host = exact_pair(coords, n_genes, seed, dev)
    for fn in (morans_i, gearys_c):
        for d, where in ((card, dev), (host, "cpu")):
            fn(d, n_permutations=n_perms, seed=seed, null_method="slots",
               device=where)
        a, b = card.uns[fn.__name__], host.uns[fn.__name__]
        dc = np.abs(np.round(a["p_value"].to_numpy() * (n_perms + 1))
                    - np.round(b["p_value"].to_numpy() * (n_perms + 1)))
        check(float(dc.max()) <= 1, f"{fn.__name__}(slots): card counts differ "
              "from the CPU path's by more than one draw")
    print(f"[global] slot null at {coords.shape[0]:,} scattered cells: card "
          f"permutations equal the CPU's; counts within one draw")


# ---------------------------------------------------------------------------
# Phase 10: the local slot nulls, join counts and the local "sort" streams
# ---------------------------------------------------------------------------


def release() -> None:
    """Collect unreachable objects (a SpatialData and its AlignedDicts refer
    to each other, so ``del`` alone frees no plane of theirs) and return
    the freed blocks to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def reset_all_launches() -> None:
    kern.reset_launch_counts()
    kern_lisa.reset_launch_counts()
    kern_knn.reset_launch_counts()


def no_kernel(dev, label: str, fn) -> float:
    """Wall seconds of ``fn`` (synchronised), run with every launch count
    at 0; fails if it launched any kernel (the slot nulls are torch ops)."""
    reset_all_launches()
    _, t = timed(fn, dev)
    launched = {k: v for k, v in {**kern.LAUNCHES, **kern_lisa.LAUNCHES,
                                  **kern_knn.LAUNCHES}.items() if v}
    check(not launched, f"{label} launched kernels: {launched}")
    return t


def smooth_adata(n_cells: int, n_genes: int, gen, dev) -> SpatialData:
    """1M-density uniform cells; every gene carries the smooth signal
    8·sin(x/300) over unit noise."""
    coords = uniform_coords(n_cells, SIDE * (n_cells / 1e6) ** 0.5, gen, dev)
    X = torch.randn((n_cells, n_genes), generator=gen, device=dev)
    X += 8.0 * torch.sin(coords[:, :1] / 300.0)
    d = SpatialData(X=X)
    d.obsm["spatial"] = coords
    return d


def sig_shares(pa: torch.Tensor, n_sig: int, alpha: float = 0.05):
    """Share of p_adj < alpha among the first ``n_sig`` genes and the rest."""
    sig = pa < alpha
    return (float(sig[:, :n_sig].float().mean()),
            float(sig[:, n_sig:].float().mean()))


def phase_slot_public(dev, gen, smi: str, n_cells: int = 1_000_000):
    """The public routes that run the local slot nulls, each on a CUDA X
    with every launch count at 0 (they are torch ops: no kernel may
    launch). Returns {call: wall seconds}."""
    release()
    out = {}
    d = lisa_adata(n_cells, 1024, gen, dev)
    label = f"local_morans_i(defaults) {n_cells:,} x 1,024 x 10"
    out[label] = no_kernel(dev, label, lambda: local_morans_i(d, device=dev))
    prm = d.uns["local_morans_params"]
    check(prm["null_method"] == "slots" and prm["null"] == "total"
          and prm["n_permutations"] == 10, f"defaults resolved to {prm}")
    p = d.obsm["local_morans_p"]
    check(isinstance(p, torch.Tensor) and p.device == torch.device(dev)
          and tuple(p.shape) == (n_cells, 1024), "LISA p: a tensor on the card")
    check(bool(torch.isfinite(d.obsm["local_morans_I"]).all()), "non-finite I")
    check(bool(((p > 0) & (p <= 1)).all()), "LISA p outside (0, 1]")
    sm, nz = float(p[:, :128].mean()), float(p[:, 128:].mean())
    print(f"[slots] {label}: {out[label]:.3f} s [{smi}]; mean p smooth genes "
          f"{sm:.4f}, noise genes {nz:.4f}; no kernel launched")
    check(sm < nz - 0.1, "slot LISA: smooth genes not below the noise genes")
    del d, p
    release()

    d = lisa_adata(n_cells, 256, gen, dev)
    for label, fn, kw, key in (
            (f"local_morans_i(conditional, P=99) {n_cells:,} x 256",
             local_morans_i, dict(null="conditional", n_permutations=99),
             "local_morans"),
            (f"local_gearys_c(defaults: conditional, P=99) {n_cells:,} x 256",
             local_gearys_c, dict(use_existing_graph=True), "local_geary")):
        out[label] = no_kernel(dev, label, lambda: fn(d, seed=3, device=dev,
                                                      **kw))
        pa = d.obsm[f"{key}_p_adj"]
        check(bool(((pa > 0) & (pa <= 1)).all()), f"{label}: p_adj outside (0, 1]")
        smooth, noise = sig_shares(pa, 32)
        print(f"[slots] {label}: {out[label]:.3f} s [{smi}]; p_adj < 0.05: "
              f"smooth genes {smooth:.4f} of cells, noise genes {noise:.6f}")
        # the conditional LISA null keeps cells whose own z is near 0 out
        # (about a fifth significant at 20,000 cells on the CPU)
        check(smooth > 0.1, f"{label}: too few significant smooth cells")
        check(noise < 1e-3, f"{label}: significant noise cells after FDR")
    del d
    release()

    d = hot_adata(n_cells, 256, gen, dev)
    label = f"getis_ord_gi(direct, P=99) {n_cells:,} x 256"
    out[label] = no_kernel(dev, label, lambda: getis_ord_gi(
        d, n_permutations=99, null_method="direct", seed=3, device=dev))
    ps = d.obsm["getis_ord_p_sim"]
    check(bool(((ps > 0) & (ps <= 1)).all()), "Getis p_sim outside (0, 1]")
    check(bool(torch.isfinite(d.obsm["getis_ord_z"]).all()), "non-finite Gi* z")
    hot, noise = hot_shares(d.obsm["getis_ord_hotspot"], 32)
    print(f"[slots] {label}: {out[label]:.3f} s [{smi}]; hot cells: hot-region "
          f"genes {hot:.4f}, noise genes {noise:.6f}")
    check(hot > 0.1 and noise < 1e-3, f"Getis direct: hot shares {hot}, {noise}")
    # a binary label over the same cells: bands along x, a fifth of the cells
    xs = d.obsm["spatial"][:, 0]
    d.obs["band"] = (torch.sin(xs / 300.0) > 0.8).cpu().numpy()
    label = f"join_count_statistics(P=99) {n_cells:,} cells"
    out[label] = no_kernel(dev, label, lambda: join_count_statistics(
        d, "band", n_permutations=99, seed=3, use_existing_graph=True,
        device=dev))
    jc = d.uns["join_counts"]
    print(f"[slots] {label}: {out[label]:.3f} s [{smi}]; BB {jc['BB']:.0f} "
          f"WW {jc['WW']:.0f} BW {jc['BW']:.0f}, p_BB {jc['p_BB']:.4f}")
    check(jc["BB"] + jc["WW"] + jc["BW"] == n_cells * K
          and jc["p_BB"] <= 1 / 100 + 1e-9, f"join counts: {jc}")
    label = f"local_join_counts(P=99) {n_cells:,} cells"
    out[label] = no_kernel(dev, label, lambda: local_join_counts(
        d, "band", n_permutations=99, seed=3, use_existing_graph=True,
        device=dev))
    pos = d.obs["band"].to_numpy()
    lp = d.obs["band_local_jc_p"].to_numpy()
    share = float((lp[pos] <= 0.05).mean())
    print(f"[slots] {label}: {out[label]:.3f} s [{smi}]; positive cells at "
          f"p <= 0.05: {share:.4f}")
    check(share > 0.5 and bool((lp[~pos] == 1).all()), "local join counts")
    del d
    release()

    d = smooth_adata(n_cells, 16, gen, dev)
    label = f"local_gearys_c_multivariate(P=99) {n_cells:,} x 16"
    out[label] = no_kernel(dev, label, lambda: local_gearys_c_multivariate(
        d, n_permutations=99, seed=3, device=dev))
    c = d.obs["local_geary_mv"].to_numpy()
    mp = d.obs["local_geary_mv_p"].to_numpy()
    share = float((mp <= 0.05).mean())
    print(f"[slots] {label}: {out[label]:.3f} s [{smi}]; cells at p <= 0.05: "
          f"{share:.4f}")
    check(bool(np.isfinite(c).all()) and share > 0.5, "multivariate Geary")
    del d
    release()
    return out


def slot_draw_split(dev, smi: str, n_cells: int = 1_000_000,
                    n_genes: int = 100, reps: int = 5, gen=None):
    """One slot draw at 1M × 100 genes (one gene batch), part by part by
    CUDA events: the permutation, the inverse, the choice of the k slot
    offsets, the k slot gathers (with their weighted sum) and the count
    update, for the total and the conditional null; then the whole draw."""
    d = lisa_adata(n_cells, n_genes, gen, dev)
    graph = build_graph(d.obsm["spatial"], n_neighbors=K, device=dev)
    Z = standardize(d.X)[0]
    del d
    n, k = Z.shape[0], graph.neighbor_idx.shape[1]
    abs_obs = (Z * spatial_lag(graph, Z)).abs()
    cnt = torch.zeros(Z.shape, dtype=torch.int16, device=dev)
    key = fold_in(key_for(3, "perm_local", 0), 0)
    perm = permutation(key, n, dev)
    ar = torch.arange(n, device=dev)
    inv = torch.empty_like(perm)
    inv[perm] = ar
    pos = inv + 1
    u = rng._choice(fold_in(key, 1), n - 1, k, dev)
    draws = [perm[(pos + u[j]) % n] for j in range(k)]
    Zp = Z[perm]
    lag_t = spatial_lag(graph, Zp)
    lag_c = moran._slot_sum(graph, (Z[i] for i in draws))

    def count(I):
        cnt.add_((I.abs() >= abs_obs).to(torch.int16))

    def total_draw():
        zp = Z[permutation(key, n, dev)]
        count(zp * spatial_lag(graph, zp))

    total = dict(
        permutation=event_ms(lambda: permutation(key, n, dev), reps),
        row_gather=event_ms(lambda: Z[perm], reps),
        slot_gathers=event_ms(lambda: spatial_lag(graph, Zp), reps),
        count_update=event_ms(lambda: count(Zp * lag_t), reps),
        whole_draw=event_ms(lambda: total_draw(), reps))

    def inverse():
        inv[perm] = ar

    def conditional_draw():
        ds = moran._conditional_draw_indices(key, n, k, dev)
        count(Z * moran._slot_sum(graph, (Z[i] for i in ds)))

    cond = dict(
        permutation=total["permutation"],
        inverse=event_ms(inverse, reps),
        choice=event_ms(lambda: rng._choice(fold_in(key, 1), n - 1, k, dev),
                        reps),
        slot_indices=event_ms(lambda: [perm[(pos + u[j]) % n]
                                       for j in range(k)], reps),
        slot_gathers=event_ms(lambda: moran._slot_sum(
            graph, (Z[i] for i in draws)), reps),
        count_update=event_ms(lambda: count(Z * lag_c), reps),
        whole_draw=event_ms(conditional_draw, reps))
    # the least bytes a draw must move: Z and |I_obs| read once (float32),
    # the int16 counts read and written once
    b_ms, _ = bound(n * n_genes * (4 + 4 + 2 + 2), 0, "f32")
    for name, split in (("total", total), ("conditional", cond)):
        print(f"[slots] one {name} slot draw at {n:,} cells x {n_genes} genes "
              f"(CUDA events, ms) [{smi}]: "
              + ", ".join(f"{a} {v:.3f}" for a, v in split.items())
              + f"; byte bound {b_ms:.3f}")
    del Z, abs_obs, cnt, Zp, lag_t, lag_c, draws
    release()
    return total, cond


def sort_operands(plan, stat: str, T: torch.Tensor):
    """The K7 tail's fixed operands on ``plan`` for the int8 table ``T``
    (codes padded to 4 columns), as ``ops.banded`` builds them: returns
    (observed fn, draw-step fn taking (Zp, counts, fn)) and the plain
    draw-step function."""
    li = plan.local_idx.to(torch.int32).contiguous()
    n_live = banded._n_live_far(plan)
    ptr, dst = banded._rows_far(plan, n_live)
    src = plan.far_src[:n_live] - B
    rows_idx = banded._padded_rows(plan, T.device)
    if stat in ("moran", "geary"):
        w, _, far_q = banded._full_row_codes(plan)
        fq = far_q[:n_live].to(torch.int8)
    else:
        w = (plan.w_local > 0).to(torch.int8)
        fq = torch.ones(n_live, dtype=torch.int8, device=T.device)
    far = lambda Zp: dict(far_row_ptr=ptr, far_q=fq, Zf=Zp[dst])
    Zp0 = T[rows_idx]
    if stat == "moran":
        obs = kern_lisa.lisa_observed(li, w, Zp0, B, **far(Zp0))
        fns = (kern_lisa.lisa_count, kern_lisa.lisa_count_plain)
        step = lambda Zp, c, fn: fn(li, w, Zp, B, obs, c, **far(Zp))
    elif stat == "geary":
        w_code = w.to(torch.int32).sum(1, dtype=torch.int32).index_add_(
            0, src, fq.to(torch.int32))
        obs = kern_lisa.geary_observed(li, w, Zp0, B, w_code, **far(Zp0))
        fns = (kern_lisa.geary_count, kern_lisa.geary_count_plain)
        step = lambda Zp, c, fn: fn(li, w, Zp, B, obs, c, w_code, **far(Zp))
    else:
        star = stat == "getis_star"
        w_bin = w.to(torch.int32).sum(1, dtype=torch.int32).index_add_(
            0, src, fq.to(torch.int32)).to(torch.float32)
        tot, sq = banded._code_moments(T)
        inv_m = banded._inv_m(plan.n, star)
        lag_o = kern_lisa.getis_lag(li, w, Zp0, B, **far(Zp0))
        me_o = Zp0[B:B + plan.n_padded].contiguous()
        if star:
            obs, alt = lag_o + me_o.to(torch.int32), "two-sided"
            tail = dict(wp1=w_bin + 1.0, tm=tot * inv_m)
            fns = (kern_lisa.getis_star_count, kern_lisa.getis_star_count_plain)
        else:
            obs = kern_lisa.gi_center(lag_o, me_o, w_bin, tot, sq, inv_m)
            alt = "greater"
            tail = dict(w_row=w_bin, tot=tot, sq=sq, inv_m=inv_m, lag_o=lag_o,
                        me_o=me_o)
            fns = (kern_lisa.getis_g_count, kern_lisa.getis_g_count_plain)
        step = lambda Zp, c, fn: fn(li, w, Zp, B, obs, c, alternative=alt,
                                    **far(Zp), **tail)
    return obs, step, fns, rows_idx


SORT_STREAMS = {"moran": ("lisa_win", "lisa_obs", "perm_local"),
                "geary": ("geary_win", "geary_obs", "perm_local_geary"),
                "getis_star": ("getis_star_win", "getis_obs", "perm_getis"),
                "getis_g": ("getis_g_win", "getis_obs", "perm_getis")}


def phase_sort_streams(dev, gen, smi: str, n_cells: int = 1_000_000,
                       n_perms: int = 99, tile: int = 256):
    """The int8 banded local nulls on the "sort" stream (the slot nulls'
    ``jax.random.permutation`` draws) through K7: LISA at 1M × 1,024, local
    Geary and Gi* (two-sided) / Gi ("greater") at 1M × 256, each with
    counts of its own (the tail once a draw, the observed entry once a
    call). Then each tail against its plain version on one sort draw's rows
    at one 256-gene tile of that plan: counts equal. Returns {stat: the
    launch counts of its call}."""
    release()
    d = lisa_adata(n_cells, 1024, gen, dev)
    coords = d.obsm["spatial"]
    graph = build_graph(coords, n_neighbors=K, device=dev)
    plan = build_null_plan(graph, coords, block=B)
    Z = standardize(d.X)[0]
    del d
    xs = coords[:, :1]
    Xh = torch.poisson(torch.full((n_cells, tile), 2.0, device=dev), generator=gen)
    Xh[:, :tile // 8] += torch.round(12.0 * torch.clamp_min(
        torch.sin(xs / 300.0), 0.0))
    # 32 smooth genes (96-127) and 224 noise genes, the Getis tile's mix
    Zt = Z[:, 96:96 + tile].contiguous()
    runs = {
        "moran": lambda: banded.banded_local_moran(
            plan, graph, Z, 3, n_perms, precision="int8",
            perm_method="sort").p_value,
        "geary": lambda: banded.banded_local_geary(
            plan, Zt, 3, n_perms, precision="int8", perm_method="sort")[1],
        "getis_star": lambda: banded.banded_getis(
            plan, Xh, 3, n_perms, star=True, alternative="two-sided",
            precision="int8", perm_method="sort"),
        "getis_g": lambda: banded.banded_getis(
            plan, Xh, 3, n_perms, star=False, alternative="greater",
            precision="int8", perm_method="sort")}
    out = {}
    for stat, run in runs.items():
        win, obs_mode, _ = SORT_STREAMS[stat]
        kern_lisa.reset_launch_counts()
        p, t = timed(run, dev)
        out[stat] = dict(kern_lisa.LAUNCHES)
        G = p.shape[1]
        check(out[stat][win] == n_perms and out[stat][obs_mode] == 1
              and sum(out[stat].values()) == n_perms + 1,
              f"sort stream {stat}: launches {out[stat]}")
        check(bool(((p > 0) & (p <= 1)).all()), f"sort stream {stat}: p range")
        # one-sided Gi puts the cold half of a hot gene near p = 1, so the
        # share at p <= 0.05 (not the mean p) tells the signal genes apart
        low = float((p[:, :G // 8] <= 0.05).float().mean())
        rest = float((p[:, G // 8:] <= 0.05).float().mean())
        print(f"[sort] {stat} int8 sort stream {n_cells:,} x {G} x {n_perms}: "
              f"{t:.3f} s [{smi}]; p <= 0.05: signal genes {low:.4f}, noise "
              f"genes {rest:.4f}; launches {win} {out[stat][win]}, {obs_mode} "
              f"{out[stat][obs_mode]}")
        check(low > rest, f"sort stream {stat}: signal genes not apart")
        del p
    # each tail against its plain version on one sort draw's rows, one tile
    for stat in runs:
        _, _, stream = SORT_STREAMS[stat]
        T = banded._pad_cols4(banded._quantize_x(Xh)[0] if stat.startswith(
            "getis") else banded._quantize_z(Zt)[0])
        obs, step, fns, rows_idx = sort_operands(plan, stat, T)
        Zp = T[banded._draw_rows("sort", 3, rows_idx, plan.n, stream)(0)]
        zero = torch.zeros(obs.shape, dtype=torch.int8, device=dev)
        got, want = step(Zp, zero.clone(), fns[0]), step(Zp, zero.clone(), fns[1])
        sync(dev)
        moved = int(got.sum(dtype=torch.int64))
        check(torch.equal(got, want) and moved > 0,
              f"sort stream {stat}: the tail differs from its plain version")
        print(f"[sort] {SORT_STREAMS[stat][0]} on sort draw 0's rows at "
              f"{plan.n:,} cells x {tile} genes: equal to plain ({moved:,} "
              f"counts moved)")
        del obs, Zp, got, want, T
    del Z, Zt, Xh, plan, graph
    release()
    return out


def phase_slots_local_vs_cpu(dev, coords: np.ndarray, n_genes: int, seed: int,
                             n_perms: int = 49):
    """The slot nulls and the int8 sort-stream LISA on the card against
    the port's CPU path at 4,096 cells: permutations and conditional draw
    indices bitwise; slot LISA (total, conditional), local Geary
    (conditional), Getis (direct) p and p_adj, local join counts, and the
    sort-stream LISA counts bitwise (integer data standardized exactly)."""
    n = coords.shape[0]
    base = key_for(seed, "perm_local", 0)
    for step in (0, 1, n_perms - 1):
        key = fold_in(base, step)
        check(torch.equal(permutation(key, n, device=dev).cpu(),
                          permutation(key, n, device="cpu")),
              f"draw {step}: the card's permutation differs from the CPU's")
        for a, b in zip(moran._conditional_draw_indices(key, n, K, dev),
                        moran._conditional_draw_indices(key, n, K, "cpu")):
            check(torch.equal(a.cpu(), b), f"draw {step}: conditional draw "
                  "indices differ from the CPU's")
    card, host = exact_pair(coords, n_genes, seed, dev)
    band = np.sin(coords[:, 0] / 40.0) > 0.3
    for d in (card, host):
        d.obs["band"] = band
    for label, fn, kw, key, ps in (
            ("local_morans_i(slots, total)", local_morans_i,
             dict(null_method="slots"), "local_morans", ("p", "p_adj", "quadrant")),
            ("local_morans_i(conditional)", local_morans_i,
             dict(null="conditional"), "local_morans", ("p", "p_adj", "quadrant")),
            ("local_gearys_c(conditional)", local_gearys_c, {}, "local_geary",
             ("p", "p_adj")),
            ("getis_ord_gi(direct)", getis_ord_gi, dict(null_method="direct"),
             "getis_ord", ("p_sim", "p_adj", "hotspot"))):
        run = dict(n_permutations=n_perms, seed=seed, batch_size=n_genes, **kw)
        no_kernel(dev, label, lambda: fn(card, device=dev, **run))
        fn(host, device="cpu", **run)
        for k in ps:
            got = torch.as_tensor(card.obsm[f"{key}_{k}"]).cpu().numpy()
            check(np.array_equal(got, host.obsm[f"{key}_{k}"]),
                  f"{label}: card {k} differs from the CPU path")
    no_kernel(dev, "local_join_counts", lambda: local_join_counts(
        card, "band", n_permutations=n_perms, seed=seed, device=dev))
    local_join_counts(host, "band", n_permutations=n_perms, seed=seed,
                      device="cpu")
    for col in ("band_local_jc_BB", "band_local_jc_p"):
        check(np.array_equal(card.obs[col].to_numpy(), host.obs[col].to_numpy()),
              f"local join counts: card {col} differs from the CPU path")
    # the int8 sort-stream LISA through K7
    res = []
    for d, where in ((card, dev), (host, "cpu")):
        graph = build_graph(d.obsm["spatial"], n_neighbors=K, device=where)
        plan = build_null_plan(graph, d.obsm["spatial"], block=B)
        kern_lisa.reset_launch_counts()
        res.append(banded_local_moran_pvalues(plan, standardize(d.X)[0], seed,
                                              n_perms, perm_method="sort"))
        if where == dev:
            sync(dev)
            sort_launch = kern_lisa.LAUNCHES["lisa_win"]
    check(sort_launch == n_perms, f"sort-stream LISA launched {sort_launch}")
    check(torch.equal(res[0].cpu(), res[1]), "sort-stream LISA: card counts "
          "differ from the CPU path")
    print(f"[slots] {n:,} scattered cells x {n_genes} genes, card vs CPU: "
          "permutations and conditional draws bitwise; slot LISA (total, "
          "conditional), local Geary (conditional), Getis (direct) p / p_adj, "
          "local join counts and the int8 sort-stream LISA bitwise; no kernel "
          f"on the slot routes, lisa_win {sort_launch} on the sort stream")


# ---------------------------------------------------------------------------
# Phase 11: radius graphs, the correlogram, the bf16 stream, point patterns
# ---------------------------------------------------------------------------

#: the radius of a mean degree of 10 at the 1M-cell density (π r² n / SIDE²
#: = 10) and its degree cap
RADIUS = float(np.sqrt(10.0 * SIDE * SIDE / (np.pi * 1e6)))
RADIUS_KMAX = 48
#: phase 11's main-path kernel modes, as the kernels line names them
RADIUS_MODES = ("int8_win", "int8_band", "float", "lisa_win", "lisa_obs")


def launched() -> dict:
    return {k: v for k, v in {**kern.LAUNCHES, **kern_lisa.LAUNCHES,
                              **kern_knn.LAUNCHES}.items() if v}


def counted(dev, tag: str, label: str, fn):
    """``fn`` run with every launch count at 0 just before it and read just
    after: (result, wall seconds, the kernels it launched)."""
    reset_all_launches()
    out, t = timed(fn, dev)
    got = launched()
    print(f"[{tag}] {label}: {t:.3f} s; launches {got}")
    return out, t, got


def phase_radius(dev, gen, smi: str, n_cells: int = 1_000_000,
                 n_genes: int = 1024, n_perms: int = 99):
    """The radius route at 1M cells (phase 3's layout; mean degree 10,
    k_max 48), each call with counts of its own: the graph, morans_i
    through "banded_int8" (K2/K3) and "banded" (K4), local_morans_i
    "banded_int8" compact (K7 moran). Then, outside the counted window,
    K2/K3, K4 and K7 moran (draw step and observed entry) held against
    their plain versions on the radius plan's own operands and timed.
    Returns (the path's launches, {mode: max |error|})."""
    release()
    d = lisa_adata(n_cells, n_genes, gen, dev)
    label = (f"build_spatial_weights(radius={RADIUS:.4f}, k_max={RADIUS_KMAX}) "
             f"at {n_cells:,} cells")
    g, _, got = counted(dev, "radius", label, lambda: build_spatial_weights(
        d, radius=RADIUS, k_max=RADIUS_KMAX, device=dev))
    check(not got, f"the radius graph launched kernels: {got}")
    deg = g.valid.sum(dim=1)
    n_iso, max_deg = int((deg == 0).sum()), int(deg.max())
    check(g.neighbor_idx.shape[1] == RADIUS_KMAX and max_deg <= RADIUS_KMAX
          and 0 < n_iso < 1000, f"radius graph: max degree {max_deg}, "
          f"{n_iso} isolated cells")
    print(f"[radius] degree mean {float(deg.float().mean()):.3f}, max "
          f"{max_deg} of k_max {RADIUS_KMAX}; {n_iso} isolated cells; "
          f"dead slots {1 - float(g.valid.float().mean()):.3f}")
    del g, deg
    n_sig = n_genes // 8
    path = {}
    for name, fn, kw, want in (
            ("morans_i(banded_int8)", morans_i,
             dict(null_method="banded_int8", n_permutations=n_perms,
                  gene_batch_size=n_genes), {"int8_win": n_perms}),
            ("morans_i(banded)", morans_i,
             dict(null_method="banded", n_permutations=19,
                  gene_batch_size=n_genes), {"float": 19}),
            ("local_morans_i(banded_int8, compact)", local_morans_i,
             dict(null_method="banded_int8", n_permutations=n_perms,
                  output_mode="compact", batch_size=n_genes),
             {"lisa_win": n_perms})):
        P = kw["n_permutations"]
        _, t, got = counted(dev, "radius", f"{name} {n_cells:,} x {n_genes:,} x "
                            f"{P} [{smi}]", lambda: fn(
                                d, use_existing_graph=True, seed=1, device=dev,
                                **kw))
        for mode, n in want.items():
            check(got.get(mode, 0) >= n, f"{name} on the radius graph did not "
                  f"launch {mode} once per draw: {got}")
        for mode, n in got.items():
            path[mode] = path.get(mode, 0) + n
        if fn is morans_i:
            p = d.uns["morans_i"]["p_value"].to_numpy()
            check(float((p[:n_sig] <= 1 / (P + 1) + 1e-6).mean()) > 0.9,
                  f"{name}: smooth genes not significant on the radius graph")
            print(f"[radius] {name}: smooth genes at p = 1/{P + 1}: "
                  f"{float((p[:n_sig] <= 1 / (P + 1) + 1e-6).mean()):.3f}; "
                  f"noise mean p {p[n_sig:].mean():.3f}")
        else:
            q = torch.as_tensor(d.obsm["local_morans_quadrant"])
            sig, noise = hh_ll_shares(q, n_sig)
            check(sig > 5 * noise, f"radius LISA: HH/LL share {sig:.3f} on "
                  f"smooth genes against {noise:.3f} on noise")
            print(f"[radius] {name}: HH/LL share smooth {sig:.3f}, noise "
                  f"{noise:.3f}")
    # the kernels on the radius plan's own operands: the first gene tile,
    # draw 0, at each kernel's tolerance
    plan = d._null_plan_cache["value"]
    Z = standardize(d.X)[0]
    errs = hold_int_1m(plan, {"Zq8": banded._quantize_z(Z)[0]},
                       modes=(("int8_win", n_genes), ("int8_band", n_genes)),
                       tag="radius")
    zp = Z.to(torch.bfloat16)[banded._padded_rows(plan, dev)]
    errs["float"] = hold_float_1m(plan, plan.local_idx.to(torch.int32), zp,
                                  n_genes, tag="radius")
    del Z, zp
    torch.cuda.empty_cache()
    _, holds = lisa_draw_split(dev, d, tag="radius")
    del d, plan
    release()
    return path, errs, holds


def phase_radius_vs_cpu(dev, coords: np.ndarray, n_genes: int, seed: int,
                        radius: float = 56.5, n_perms: int = 49):
    """A 4,096-cell radius run on the card against the port's CPU path on
    integer coordinates (every d² an exact integer, never r²): the graphs'
    indices, weights and masks equal (distances within an ulp),
    local_morans_i's p / p_adj / quadrants and morans_i's int8 p bitwise
    (the observed I within rtol 1e-5)."""
    card, host = exact_pair(coords, n_genes, seed, dev)
    graphs = [build_spatial_weights(x, radius=radius, k_max=RADIUS_KMAX,
                                    device=where)
              for x, where in ((card, dev), (host, "cpu"))]
    for f in ("neighbor_idx", "neighbor_w", "valid"):
        check(torch.equal(getattr(graphs[0], f).cpu(), getattr(graphs[1], f)),
              f"radius graph {f}: the card's differs from the CPU's")
    # the distances: one float32 sqrt of the same exact integer d², within
    # an ulp (the card's and the CPU's sqrt may round apart)
    live = graphs[1].valid
    dc, dh = graphs[0].distances.cpu()[live], graphs[1].distances[live]
    ulps = int((dc.view(torch.int32) - dh.view(torch.int32)).abs().max())
    check(ulps <= 1, f"radius graph distances {ulps} ulp from the CPU's")
    iso = int((graphs[1].valid.sum(dim=1) == 0).sum())
    reset_all_launches()
    for x, where in ((card, dev), (host, "cpu")):
        morans_i(x, null_method="banded_int8", n_permutations=n_perms,
                 seed=seed, use_existing_graph=True, device=where)
        local_morans_i(x, null_method="banded_int8", n_permutations=n_perms,
                       seed=seed, use_existing_graph=True, batch_size=n_genes,
                       device=where)
        sync(dev)
        if where is dev:
            got = launched()
    a, b = card.uns["morans_i"], host.uns["morans_i"]
    check(np.array_equal(a["p_value"], b["p_value"]),
          "radius morans_i(banded_int8): the card's p differs from the CPU's")
    check(np.allclose(a["I"], b["I"], rtol=1e-5, atol=1e-7),
          "radius morans_i: the card's I differs from the CPU's")
    for k in ("p", "p_adj", "quadrant"):
        check(np.array_equal(
            torch.as_tensor(card.obsm[f"local_morans_{k}"]).cpu().numpy(),
            host.obsm[f"local_morans_{k}"]),
            f"radius local_morans_i: the card's {k} differs from the CPU's")
    check(got.get("lisa_win", 0) == n_perms and got.get("int8_win", 0) >= n_perms,
          f"the 4,096-cell radius run did not run its kernels: {got}")
    print(f"[radius] {coords.shape[0]:,} scattered cells, radius {radius}: "
          f"the card's graph (distances within {ulps} ulp), morans_i p and "
          f"local_morans_i p / p_adj / quadrants equal the CPU path's "
          f"bitwise; {iso} isolated cells; launches {got}")


def phase_correlogram(dev, gen, smi: str, n_cells: int = 1_000_000,
                      n_genes: int = 64, n_perms: int = 19):
    """moran_correlogram at 1M cells x 64 genes, 5 default bands, k_max 128,
    at P = 0 and P = 19 (no kernel: torch ops), and one draw split part by
    part (permutation, the slot loop, the band moments)."""
    release()
    d = make_adata(n_cells, n_genes, gen, dev)
    n_sig = n_genes // 8
    for P in (0, n_perms):
        t = no_kernel(dev, "moran_correlogram", lambda: moran_correlogram(
            d, n_permutations=P, seed=3, device=dev))
        df = d.uns["moran_correlogram"]
        bands = d.uns["moran_correlogram_params"]["bands"]
        check(len(df) == 5 * n_genes and bool(np.isfinite(df["I"]).all()),
              f"correlogram P={P}: {len(df)} rows")
        first = df[df["band_lo"] == bands[0]]
        sig, noise = first["I"].iloc[:n_sig], first["I"].iloc[n_sig:]
        check(float(sig.min()) > float(noise.max()),
              "correlogram: smooth genes not above the noise in band 0")
        if P:
            check(bool((first["p_sim"].iloc[:n_sig] <= 1 / (P + 1) + 1e-6).all()),
                  "correlogram: smooth genes' p_sim not at 1/(P+1)")
        print(f"[correlogram] moran_correlogram {n_cells:,} x {n_genes} x 5 "
              f"bands up to {bands[-1]:.3f}, k_max 128, P={P}: {t:.3f} s "
              f"[{smi}]; band-0 I smooth {sig.mean():.4f} noise "
              f"{noise.mean():.4f}")
    coords = d.obsm["spatial"]
    idx, dist, valid = radius_neighbors(coords, bands[-1], 128)
    Z = standardize(d.X)[0]
    edges = torch.tensor(bands, dtype=torch.float32, device=dev)
    bd = moran.correlogram_bands(idx, dist, valid, edges)
    base = key_for(3, "perm_global", 0)
    perm = permutation(fold_in(base, 0), n_cells, device=dev)
    Zp = Z[perm]
    split = dict(
        radius_search_s=timed(lambda: radius_neighbors(coords, bands[-1], 128),
                              dev)[1],
        permutation=event_ms(lambda: permutation(fold_in(base, 1), n_cells,
                                                 device=dev), 3),
        slot_loop=event_ms(lambda: moran.correlogram_band_num(
            bd, Zp, lambda ik: Z[perm[ik]]), 3),
        moments=event_ms(lambda: moran.correlogram_bands(idx, dist, valid,
                                                         edges), 3))
    print(f"[correlogram] one draw at {n_cells:,} x {n_genes} (CUDA events, "
          f"ms; the search in s): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f"; live slots {bd.idx.shape[1]} of 128, {bd.idx.shape[1]} "
          f"[N, G] gathers a draw")
    del d, Z, Zp, idx, dist, valid, bd
    release()
    return split


def phase_bf16_stream(dev, smi: str, n_cells: int = 1_000_000,
                      n_genes: int = 4096, n_perms: int = 99,
                      tile: int = 2048):
    """streaming_local_null(obs_dtype="bf16", tile=2048) at 1M x 4,096 x 99
    (keys I, p, p_adj, quadrant; device sink), with counts of its own, and
    the float32-obs run on the first 2,048 genes: p and p_adj bitwise, the
    peak of torch.cuda.max_memory_allocated for each. Returns the peaks and
    the bf16 run's launches."""
    release()
    g0 = torch.Generator(device=dev).manual_seed(21)
    coords = uniform_coords(n_cells, SIDE, g0, dev)
    graph = build_graph(coords, n_neighbors=K, device=dev)
    plan = build_null_plan(graph, coords, block=B)
    wave = 8.0 * torch.sin(coords[:, :1] / 300.0)
    keys = ("I", "p", "p_adj", "quadrant")

    def block(b):                        # 512 genes, the same at any split
        g = torch.Generator(device=dev).manual_seed(2000 + b)
        X = torch.randn((n_cells, 512), generator=g, device=dev)
        X[:, :64] += wave
        return X

    def get_tile(start, width):
        return torch.cat([block(b) for b in range(start // 512,
                                                  (start + width) // 512)], 1)

    out, peak = {}, {}
    for dt, G in (("bf16", n_genes), ("f32", tile)):
        release()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        sink, fin = device_local_sink(G, keys)
        _, t, got = counted(dev, "stream", f"streaming_local_null(obs_dtype="
                            f"{dt!r}, tile={tile}) {n_cells:,} x {G:,} x "
                            f"{n_perms} [{smi}]", lambda: streaming_local_null(
                                graph, plan, get_tile, G, sink, seed=5,
                                n_permutations=n_perms, tile=tile, keys=keys,
                                obs_dtype=dt, device=dev))
        tiles = -(-G // tile)
        check(got.get("lisa_win", 0) == tiles * n_perms
              and got.get("lisa_obs", 0) == tiles,
              f"the {dt} stream did not run K7 once per draw and tile: {got}")
        out[dt] = fin()
        peak[dt] = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
        if dt == "bf16":
            path = got
        print(f"[stream] {dt}: peak device memory above the plan "
              f"{peak[dt]:.3f} GiB; {G * n_perms / t:.1f} genes*perms/s")
    for k in ("p", "p_adj"):
        check(torch.equal(out["bf16"][k][:, :tile], out["f32"][k]),
              f"bf16 stream {k} differs from the f32-obs run's")
    q = out["bf16"]["quadrant"][:, :512]           # block 0: 64 smooth genes
    sig, noise = hh_ll_shares(q, 64)
    check(sig > 10 * noise, f"bf16 stream: HH/LL share {sig:.3f} on smooth "
          f"genes against {noise:.3f} on noise")
    print(f"[stream] bf16 p and p_adj equal the f32-obs run's bitwise on the "
          f"first {tile:,} genes; HH/LL share smooth {sig:.3f}, noise "
          f"{noise:.3f}")
    del out, graph, plan
    release()
    return peak, path


def pattern_coords(n: int, seed: int, n_types: int = 8):
    """A section's layout at the 1M-cell density: 7/8 of the cells uniform,
    1/8 in 200 Gaussian clumps (sd 30); the clumped cells take types 1..7
    by clump, the uniform ones any of the ``n_types``."""
    r = np.random.default_rng(seed)
    side = SIDE * (n / 1e6) ** 0.5
    m = n // 8
    centres = r.uniform(0, side, (200, 2))
    which = r.integers(0, 200, m)
    pts = np.concatenate([centres[which] + r.normal(0, 30.0, (m, 2)),
                          r.uniform(0, side, (n - m, 2))]).astype(np.float32)
    codes = np.concatenate([1 + which % (n_types - 1),
                            r.integers(0, n_types, n - m)]).astype(np.int32)
    return pts, codes


def phase_point_patterns(dev, smi: str, n_cells: int = 1_000_000,
                         n_draws: int = 19):
    """clark_evans, ripleys_k (20 radii up to 10x the mean NN distance, 19
    CSR simulations), cross_type_ripleys_k (8 types, 19 label permutations)
    and co_occurrence (8 types, the same radii) at 1M cells, no kernel
    (torch ops); one envelope draw of each kind timed; then a 20,000-cell
    run on the card against the port's CPU path, counts bitwise."""
    from spatialcore_tpu_torch.ops import ripley as rip
    release()
    xy, codes = pattern_coords(n_cells, 5)
    d = SpatialData(X=np.zeros((n_cells, 1), np.float32),
                    obs=pd.DataFrame({"cell_type": pd.Categorical(
                        np.array(list("ABCDEFGH"))[codes])}))
    d.obsm["spatial"] = xy
    times = {"clark_evans": no_kernel(dev, "clark_evans",
                                      lambda: clark_evans(d, device=dev))}
    ce = d.uns["clark_evans"]
    radii = np.linspace(0.5, 10.0, 20) * ce["mean_nn_distance"]
    for name, fn, kw in (
            ("ripleys_k", ripleys_k, dict(n_simulations=n_draws)),
            ("cross_type_ripleys_k", cross_type_ripleys_k,
             dict(cluster_key="cell_type", n_permutations=n_draws)),
            ("co_occurrence", co_occurrence, dict(cluster_key="cell_type"))):
        times[name] = no_kernel(dev, name, lambda: fn(d, radii=radii,
                                                      device=dev, **kw))
    rk, kx = d.uns["ripley_k"], d.uns["ripley_k_cross"]
    check(ce["R"] < 1 and bool(np.all(np.array(rk["K"][-5:])
                                      > np.array(rk["K_env_hi"][-5:]))),
          "point patterns: the clumped section is not clustered")
    check(bool(np.isfinite(np.array(kx["K_cross"])).all())
          and bool(np.isfinite(d.uns["co_occurrence"]["score"]).any()),
          "point patterns: non-finite cross-type K or co-occurrence")
    # one envelope draw of each kind, on the card
    spec = rip.make_grid_spec(xy, float(radii.max()), capacity_slack=2.0)
    mins, span = (torch.as_tensor(a, device=dev) for a in (spec.mins, spec.span))
    rsq = torch.as_tensor(radii.astype(np.float32) ** 2, device=dev)
    ct = torch.as_tensor(codes.astype(np.int64), device=dev)
    xy_t = torch.as_tensor(xy, device=dev)
    base = key_for(0, "ripley_csr")
    table, bx, by, _ = rip._bin_points(xy_t, mins, span, spec.nbx, spec.nby,
                                       spec.capacity)
    occ = (table >= 0).sum(dim=1)
    split = dict(
        csr_draw=event_ms(lambda: rip._counts_pass(
            rip.csr_points(base, 0, mins, span, n_cells), spec, rsq, None, 1,
            mins, span), 2),
        binning=event_ms(lambda: rip._bin_points(xy_t, mins, span, spec.nbx,
                                                 spec.nby, spec.capacity), 2),
        pair_counts=event_ms(lambda: rip._pair_counts(
            xy_t, table, bx, by, rsq, None, spec.nbx, spec.nby, spec.window),
            2),
        label_draw=event_ms(lambda: rip._pair_counts(
            xy_t, table, bx, by, rsq,
            ct[permutation(fold_in(base, 0), n_cells, device=dev)], spec.nbx,
            spec.nby, spec.window, 8), 2))
    cand = 0                             # candidate pairs a pass scores
    for dx in range(-spec.window, spec.window + 1):
        for dy in range(-spec.window, spec.window + 1):
            gx, gy = bx + dx, by + dy
            ok = (gx >= 0) & (gx < spec.nbx) & (gy >= 0) & (gy < spec.nby)
            cand += int(occ[(gx * spec.nby + gy)[ok]].sum())
    print(f"[points] {n_cells:,} cells [{smi}]: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in times.items())
        + f"; Clark-Evans R {ce['R']:.4f}; one pass (CUDA events, ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; grid {spec.nbx}x{spec.nby}, window {spec.window}, capacity "
        f"{spec.capacity}, ~{cand / 1e6:.1f}M candidate pairs a pass")
    del d, table, bx, by, occ, xy_t, ct
    release()
    # 20,000 cells on the card against the CPU path
    xy, codes = pattern_coords(20_000, 6)
    r = radii.astype(np.float32)         # the same density: the same radii
    for name, fn in (
            ("ripley_k", lambda where: rip.ripley_k(xy, r, n_simulations=4,
                                                    seed=2, device=where)),
            ("cross_type_k", lambda where: rip.cross_type_k(
                xy, codes, 8, r, n_permutations=4, seed=2, device=where)),
            ("co_occurrence_counts", lambda where: {"ct": rip.co_occurrence_counts(
                xy, codes, 8, r, device=where)})):
        a, b = fn(dev), fn("cpu")
        for k in b:
            check(np.array_equal(np.asarray(a[k]), np.asarray(b[k])),
                  f"{name} {k}: the card's differs from the CPU's")
    print("[points] 20,000 cells: ripley_k (4 CSR draws), cross_type_k (4 "
          "label permutations) and co_occurrence_counts on the card equal "
          "the CPU path's bitwise")
    return times, split


# Phase 12: the niche and domain path
# ---------------------------------------------------------------------------

#: the simulator's default density (40,000 cells on 5,000 µm), at 1M cells
NICHE_CELLS = 1_000_000
NICHE_EXTENT = 25_000.0
#: the two cell populations the domains are drawn around (source, target)
DOMAIN_TYPES = (("B cell", "domain_b"), ("Epithelial", "domain_epi"))


def h5ad_round_trip(d) -> None:
    """``write_h5ad`` then ``read_h5ad`` of ``d`` in a temporary directory,
    timed, with the file's size; where h5py does not import, one line says
    that the round trip was not run (the CPU tests hold its parity)."""
    try:
        import h5py  # noqa: F401
    except ImportError as e:
        print(f"[niches] h5ad round trip not run: h5py does not import on "
              f"this machine ({e}); tests/test_torch_core_io.py holds the "
              f"two packages' files equal on the CPU")
        return
    from spatialcore_tpu_torch import read_h5ad, write_h5ad
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "section.h5ad"
        _, t_w = timed(lambda: write_h5ad(d, path), "cpu")
        size = path.stat().st_size
        back, t_r = timed(lambda: read_h5ad(path), "cpu")
    check(back.shape == d.shape and (back.X != d.X).nnz == 0
          and back.obs.equals(d.obs), "the h5ad round trip changed the data")
    print(f"[niches] write_h5ad {t_w:.2f} s, read_h5ad {t_r:.2f} s, "
          f"{size / 2 ** 20:.1f} MiB")


def niche_path(d, dev, n_perms: int, subset=None, domain_cols=DOMAIN_TYPES):
    """The path's public calls on ``d`` (on ``dev``), each timed and run
    with every launch count at 0 (torch ops, no kernel); returns the times
    and, with ``subset``, the container of the full k-means run and its
    stability on the first ``subset`` cells."""
    from spatialcore_tpu_torch.core import normalize_log1p_from_raw
    from spatialcore_tpu_torch.spatial import (calculate_domain_distances,
                                               compute_neighborhood_profile,
                                               identify_niches,
                                               make_spatial_domains,
                                               neighborhood_enrichment,
                                               niche_stability)
    times = {"normalize_log1p_from_raw": timed(
        lambda: normalize_log1p_from_raw(d), "cpu")[1]}
    calls = [
        ("neighborhood_enrichment", lambda: neighborhood_enrichment(
            d, "true_type", n_permutations=n_perms, device=dev)),
        ("compute_neighborhood_profile", lambda: compute_neighborhood_profile(
            d, "true_type", k=15, device=dev)),
        ("identify_niches", lambda: identify_niches(d, n_niches=6, device=dev))]
    for name, fn in calls:
        times[name] = no_kernel(dev, name, fn)
    sub = None
    if subset:
        sub = SpatialData(obs=d.obs.iloc[:subset][["true_type"]].copy())
        sub.obsm["neighborhood_profile"] = d.obsm["neighborhood_profile"][:subset]
        times[f"identify_niches {subset:,}"] = no_kernel(
            dev, "identify_niches (subset)",
            lambda: identify_niches(sub, n_niches=6, device=dev))
        times[f"niche_stability {subset:,}"] = no_kernel(
            dev, "niche_stability", lambda: niche_stability(
                sub, n_niches_range=range(4, 9), n_restarts=5, device=dev))
    for ct, col in domain_cols:
        times[f"make_spatial_domains {ct}"] = no_kernel(
            dev, "make_spatial_domains", lambda: make_spatial_domains(
                d, f"true_type == '{ct}'", output_column=col,
                platform="xenium", device=dev))
    (_, src), (_, tgt) = domain_cols
    for metric in ("minimum", "mean"):
        times[f"calculate_domain_distances {metric}"] = no_kernel(
            dev, "calculate_domain_distances",
            lambda: calculate_domain_distances(
                d, src, tgt, distance_metric=metric,
                output_distance_column=f"dist_{metric}",
                output_nearest_column=f"near_{metric}", device=dev))
    return times, sub


def raster_only(d, ct: str, dev):
    """The raster pipeline of ``make_spatial_domains(platform="xenium")``
    alone, for ``ct``'s cells: (its result, CC iterations, H × W, pixel,
    the radii, whether the CC loop stopped at its cap with labels still
    changing)."""
    coords = np.asarray(d.obsm["spatial"], np.float64)
    lo, pixel, shape, rb, rs = dom.raster_grid(coords, 50.0, 25.0, 2048, 8)
    mask = (d.obs["true_type"] == ct).to_numpy()
    res, iters, capped = geometry._buffer_union_shrink(
        dom.to_pixels(coords[mask], lo, pixel, shape),
        dom.to_pixels(coords, lo, pixel, shape), shape, rb, rs, dev)
    return res, iters, shape, pixel, (rb, rs), capped


def phase_niches(dev, smi: str, n_cells: int = NICHE_CELLS,
                 extent: float = NICHE_EXTENT, n_perms: int = 1000,
                 subset: int = 100_000):
    """The niche and domain path at 1M cells on the card: the simulated
    section (host time), the h5ad round trip where h5py imports,
    normalization, enrichment with 1,000 label permutations (k = 6) and its
    per-draw split, profiles (k = 15), niches (mini-batch at 1M, full
    k-means and its stability on a 100,000-cell subset), domains around
    two populations with their rasters, and the distances between them."""
    from spatialcore_tpu_torch.spatial import (get_distance_matrix,
                                               get_domain_summary)
    from spatialcore_tpu_torch.spatial.neighborhoods import adjusted_rand_score
    from spatialcore_tpu_torch.utils import simulate_xenium
    release()
    t0 = time.perf_counter()
    (d, _), t_sim = timed(lambda: simulate_xenium(
        n_cells=n_cells, n_genes=256, extent=extent), "cpu")
    print(f"[niches] simulate_xenium {n_cells:,} cells x 256 genes on "
          f"{extent:,.0f} um square: {t_sim:.2f} s on the host; "
          f"{d.X.nnz:,} nonzero counts, 13 cell types")
    h5ad_round_trip(d)
    times, sub = niche_path(d, dev, n_perms, subset)
    times = {"simulate_xenium (host)": t_sim, **times}
    ne = d.uns["true_type_nhood_enrichment"]
    check(float(ne["count"].sum()) == 6 * n_cells
          and bool(np.isfinite(ne["zscore"]).all())
          and bool((ne["null_std"] > 0).all()),
          "neighborhood_enrichment: counts or z not as expected")
    prof = d.obsm["neighborhood_profile"]
    check(prof.shape == (n_cells, 13) and np.allclose(prof.sum(1), 1.0,
                                                      atol=1e-5),
          "the neighbourhood profiles do not sum to 1")
    auto = "minibatch_kmeans" if n_cells > 100_000 else "kmeans"
    check(d.uns["niche_params"]["method"] == auto
          and sub.uns["niche_params"]["method"] == "kmeans",
          "identify_niches' 'auto' took the wrong method")
    stab = sub.uns["niche_stability"]
    check(len(stab) == 5 and all(-1 <= r["ari_mean"] <= 1 for r in stab),
          "niche_stability rows")
    # the per-draw split of the enrichment null
    graph = acorr._load_stored_graph(d, dev)
    types = ne["types"]
    codes = torch.tensor(d.obs["true_type"].astype(str).map(
        {t: i for i, t in enumerate(types)}).to_numpy(np.int64), device=dev)
    base = key_for(0, "nhood_perm", 0)
    perm = permutation(fold_in(base, 0), n_cells, device=dev)
    split = dict(
        permutation=event_ms(lambda: permutation(fold_in(base, 0), n_cells,
                                                 device=dev), 5),
        pair_counts=event_ms(lambda: nhood.pair_counts(
            graph.neighbor_idx, graph.valid, codes[perm], len(types)), 5),
        whole_draw=event_ms(lambda: nhood.null_moments(
            graph.neighbor_idx, graph.valid, codes, len(types), 0, 1), 5))
    print(f"[niches] enrichment null, one draw at {n_cells:,} cells, k = 6, "
          f"{len(types)} types (CUDA events, ms) [{smi}]: "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
          + " (whole_draw: the observed counts and one draw)")
    for ct, col in DOMAIN_TYPES:
        (res, iters, shape, pixel, radii, capped), t_r = timed(
            lambda: raster_only(d, ct, dev), dev)
        p = d.uns[f"{col}_params"]
        check(p["n_domains"] >= 1 and int(res.mask.sum()) > 0,
              f"no domain around {ct}")
        print(f"[niches] domains around {ct}: raster {shape[0]} x {shape[1]}, "
              f"pixel {pixel:.4f} um, r_buffer / r_shrink {radii} px, "
              f"connected_components {iters} iterations (cap "
              f"{geometry.CC_MAX_ITER}, the cap's warning "
              f"{'fired' if capped else 'did not fire'}), raster pipeline "
              f"alone {t_r:.3f} s; {p['n_domains']} domains, "
              f"{p['n_target_cells']:,} target and {p['n_assigned_cells']:,} "
              f"assigned cells")
    (_, src), (_, tgt) = DOMAIN_TYPES
    n_src, n_tgt = int(d.obs[src].notna().sum()), int(d.obs[tgt].notna().sum())
    summary = get_domain_summary(d, src)
    matrix = get_distance_matrix(d)
    check(bool(np.isfinite(matrix.to_numpy()).all())
          and int(summary["n_cells"].sum()) == n_src,
          "domain distances or summary not as expected")
    dmin = d.obs["dist_minimum"].to_numpy()
    dmean = d.obs["dist_mean"].to_numpy()
    sel = ~np.isnan(dmin)
    check(bool((dmin[sel] <= dmean[sel] * (1 + 1e-6)).all()),
          "a cell's minimum distance exceeds its mean")
    total = time.perf_counter() - t0
    print(f"[niches] {n_cells:,} cells [{smi}]: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in times.items())
        + f"; {n_src:,} source x {n_tgt:,} target cells = "
        f"{n_src * n_tgt:,} pairs; niches vs true niches ARI "
        f"{adjusted_rand_score(d.obs['true_niche'], d.obs['niche']):.4f}; "
        f"stability ARI by k "
        + ", ".join(f"{r['n_niches']}: {r['ari_mean']:.4f}" for r in stab)
        + f"; phase 12 at 1M took {total:.1f} s")
    del d, sub, graph, codes, perm
    release()
    return times, split


def phase_niches_vs_cpu(dev, n_cells: int = 20_000, n_perms: int = 30):
    """The same path at 20,000 cells (the 1M density) on the card and on
    the CPU: counts, profiles, raster masks and labels, domain assignments
    and minimum distances bitwise; z and the null moments within rtol 1e-6
    and "mean" distances within rtol 1e-5; niche labels equal up to
    renaming."""
    from spatialcore_tpu_torch.spatial.neighborhoods import adjusted_rand_score
    from spatialcore_tpu_torch.utils import simulate_xenium
    extent = NICHE_EXTENT * (n_cells / NICHE_CELLS) ** 0.5
    runs = {}
    for where in (dev, "cpu"):
        d, _ = simulate_xenium(n_cells=n_cells, n_genes=256, extent=extent,
                               seed=3)
        niche_path(d, where, n_perms)
        runs[str(where)] = (d, raster_only(d, DOMAIN_TYPES[0][0], where)[0])
    (card, rc), (cpu, rp) = runs[str(dev)], runs["cpu"]
    ua = card.uns["true_type_nhood_enrichment"]
    ub = cpu.uns["true_type_nhood_enrichment"]
    check(np.array_equal(ua["count"], ub["count"]), "enrichment counts differ")
    worst = max(float(np.max(np.abs(ua[k] - ub[k]) / np.maximum(np.abs(ub[k]),
                                                                  1e-30)))
                for k in ("zscore", "null_mean", "null_std"))
    check(worst <= 1e-6, f"enrichment z / null moments differ by {worst}")
    check(np.array_equal(card.obsm["neighborhood_profile"],
                         cpu.obsm["neighborhood_profile"]), "profiles differ")
    check(np.array_equal(rc.mask.cpu().numpy(), rp.mask.numpy())
          and np.array_equal(rc.labels.cpu().numpy(), rp.labels.numpy()),
          "raster masks or component labels differ")
    for _, col in DOMAIN_TYPES:
        check(card.obs[col].astype(str).equals(cpu.obs[col].astype(str)),
              f"domain assignments {col} differ")
    check(np.array_equal(card.obs["dist_minimum"].to_numpy(),
                         cpu.obs["dist_minimum"].to_numpy(), equal_nan=True),
          "minimum distances differ")
    m_card = card.obs["dist_mean"].to_numpy()
    m_cpu = cpu.obs["dist_mean"].to_numpy()
    sel = ~np.isnan(m_cpu)
    mean_err = float(np.max(np.abs(m_card[sel] - m_cpu[sel]) / m_cpu[sel]))
    check(mean_err <= 1e-5, f"mean distances differ by {mean_err}")
    ari = adjusted_rand_score(card.obs["niche"], cpu.obs["niche"])
    check(ari == 1.0, f"niche labels differ beyond renaming (ARI {ari})")
    print(f"[niches] {n_cells:,} cells, card against CPU: enrichment counts, "
          f"profiles, raster masks and labels, domains and minimum distances "
          f"bitwise; z / null moments max rel diff {worst:.3g} (bitwise: "
          f"{worst == 0}); mean distances {mean_err:.3g}; niche ARI {ari}")


# Phase 13: the statistics and the annotation scoring path
# ---------------------------------------------------------------------------

#: a Xenium section: the human multi-tissue panel's 377 genes
ANNOT_CELLS = 1_000_000
ANNOT_GENES = 377
#: planted cell types, each with its canonical markers in the panel
ANNOT_TYPES = ("B cell", "T cell", "CD4-positive, alpha-beta T cell",
               "CD8-positive, alpha-beta T cell", "natural killer cell",
               "plasma cell", "monocyte", "macrophage", "dendritic cell",
               "mast cell", "neutrophil", "endothelial cell",
               "lymphatic endothelial cell", "fibroblast",
               "smooth muscle cell", "pericyte", "epithelial cell",
               "basal cell", "goblet cell", "adipocyte")


def annotation_panel(n_types: int = len(ANNOT_TYPES), n_genes: int = ANNOT_GENES,
                     seed: int = 0):
    """(types, genes, expected log1p profile [T, G], markers): the planted
    types' canonical markers first, then filler genes up to the panel's
    width; numpy, from ``seed``."""
    from spatialcore_tpu_torch.annotation import load_canonical_markers
    markers = load_canonical_markers()
    types = list(ANNOT_TYPES[:n_types])
    genes = sorted({g for t in types for g in markers[t]})
    genes += [f"PANEL{i:03d}" for i in range(n_genes - len(genes))]
    gi = {g: i for i, g in enumerate(genes)}
    rng = np.random.default_rng(seed)
    base = rng.gamma(2.0, 0.15, n_genes)
    n_mark = n_genes - sum(g.startswith("PANEL") for g in genes)
    base[:n_mark] *= 0.1            # a marker is near silent off its types
    mu = np.tile(base, (n_types, 1))
    for t, ty in enumerate(types):
        for g in markers[ty]:
            mu[t, gi[g]] += 2.5
    return types, genes, mu.astype(np.float32), markers


def annotation_section(dev, n_cells: int = ANNOT_CELLS, seed: int = 0):
    """A SpatialData on ``dev``: Poisson counts of the planted profiles,
    log1p-normalized (10⁴ per cell) as float32 X, cells uniform at the 1M
    density of phase 3 (coordinates on the card), and the true types."""
    types, genes, mu, markers = annotation_panel(seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lab = torch.randint(0, len(types), (n_cells,), generator=gen, device=dev)
    counts = torch.poisson(torch.as_tensor(mu, device=dev)[lab], generator=gen)
    X = torch.log1p(counts / counts.sum(1, keepdim=True).clamp_min(1) * 1e4)
    del counts
    side = SIDE * (n_cells / 1e6) ** 0.5
    d = SpatialData(X=X, obs=pd.DataFrame({"truth": pd.Categorical.from_codes(
        lab.cpu().numpy(), types)}), var=pd.DataFrame(index=genes))
    d.obsm["spatial"] = uniform_coords(n_cells, side, gen, dev)
    return d, types, genes, mu, markers


def annotation_models(types, genes, mu, seed: int = 0):
    """Two CellTypeModels from seeded numpy arrays: the panel model (the
    standardized class centroids of 200 numpy-drawn cells a type as
    weights, their mean and std as the scaler) and a partial one (300 of
    the panel's genes and 20 genes the panel lacks)."""
    from spatialcore_tpu_torch.annotation import CellTypeModel
    rng = np.random.default_rng(seed + 1)
    lab = np.repeat(np.arange(len(types)), 200)
    c = rng.poisson(mu[lab]).astype(np.float64)
    x = np.log1p(c / np.maximum(c.sum(1, keepdims=True), 1) * 1e4)
    cent = np.stack([x[lab == t].mean(0) for t in range(len(types))])
    mean, std = x.mean(0), x.std(0) + 1e-3
    W = ((cent - mean) / std).T.astype(np.float32)
    full = CellTypeModel(list(genes), list(types), W,
                         np.zeros(len(types), np.float32),
                         mean.astype(np.float32), std.astype(np.float32),
                         {"model_name": "panel"})
    keep = np.sort(rng.choice(len(genes), 300, replace=False))
    absent = [f"OTHER{i:02d}" for i in range(20)]
    part = CellTypeModel(
        [genes[i] for i in keep] + absent, list(types),
        np.vstack([W[keep] * 1.2, rng.normal(0, 0.5, (20, len(types)))]
                  ).astype(np.float32),
        rng.normal(0, 0.1, len(types)).astype(np.float32),
        np.concatenate([mean[keep], np.ones(20)]).astype(np.float32),
        np.concatenate([std[keep], np.ones(20)]).astype(np.float32),
        {"model_name": "partial"})
    return full, part


def own_markers(markers, types, ct: str, n: int = 3):
    """The first ``n`` canonical markers of ``ct`` that no other planted
    type carries."""
    others = {g for t in types if t != ct for g in markers[t]}
    return [g for g in markers[ct] if g not in others][:n]


def annotation_path(d, dev, models, markers, b_markers):
    """The slice's calls on ``d`` (on ``dev``), each timed and run with
    every launch count at 0 (torch ops, no kernel): the scoring path in
    order, then DEG, classification, NMF, smoothing and the diffusion map.
    Returns the times."""
    from spatialcore_tpu_torch.annotation import (annotate_cells,
                                                  benchmark_annotation,
                                                  filter_by_marker_validation,
                                                  filter_low_confidence,
                                                  marker_quality_metrics)
    from spatialcore_tpu_torch.diffusion import diffusion_map, smooth_expression
    from spatialcore_tpu_torch.nmf import run_nmf
    from spatialcore_tpu_torch.stats import (classify_by_threshold,
                                             rank_genes_groups)
    calls = [
        ("annotate_cells (2 models)", lambda: annotate_cells(
            d, models, device=dev)),
        ("filter_low_confidence", lambda: filter_low_confidence(
            d, threshold=0.5)),
        ("filter_by_marker_validation", lambda: filter_by_marker_validation(
            d, markers=markers, confidence_threshold=0.95, device=dev)),
        ("marker_quality_metrics", lambda: marker_quality_metrics(
            d, markers=markers, device=dev)),
        ("benchmark_annotation", lambda: benchmark_annotation(
            d, markers=markers, model_genes=models[1].genes,
            confidence_column="cell_type_confidence", device=dev)),
        ("rank_genes_groups", lambda: rank_genes_groups(
            d, "truth", n_genes=20, device=dev)),
        ("classify_by_threshold ks", lambda: classify_by_threshold(
            d, b_markers, threshold_method="ks", column_prefix="b_ks",
            plot=False, device=dev)),
        ("classify_by_threshold gmm", lambda: classify_by_threshold(
            d, b_markers, threshold_method="gmm", column_prefix="b_gmm",
            plot=False, device=dev)),
        ("run_nmf (10 programs)", lambda: run_nmf(
            d, n_components=10, device=dev)),
        ("smooth_expression (3 steps, k = 6)", lambda: smooth_expression(
            d, n_steps=3, n_neighbors=6, device=dev)),
        ("diffusion_map (10 components, k = 15)", lambda: diffusion_map(
            d, n_components=10, n_neighbors=15, device=dev)),
    ]
    times = {}
    for name, fn in calls:
        if name.startswith("diffusion_map"):
            d.uns.pop(acorr.GRAPH_UNS_KEY, None)    # the k = 6 graph
        times[name] = no_kernel(dev, name, fn)
    return times


def phase_annotation(dev, smi: str, n_cells: int = ANNOT_CELLS):
    """The statistics and the annotation scoring path at the size of a
    Xenium section on the card: 1M cells x 377 genes, 20 planted types;
    two models saved to .npz and resolved back through a registry, then
    every call of :func:`annotation_path`, each timed, and its output
    checked against the planted truth."""
    from spatialcore_tpu_torch.annotation import (publish_model,
                                                  resolve_model)
    release()
    t0 = time.perf_counter()
    (d, types, genes, mu, markers), t_data = timed(
        lambda: annotation_section(dev, n_cells), dev)
    full, part = annotation_models(types, genes, mu)
    with tempfile.TemporaryDirectory() as tmp:
        reg = Path(tmp) / "registry.json"
        for m in (full, part):
            publish_model(m, m.metadata["model_name"], models_dir=tmp,
                          registry_path=reg)
        models, t_res = timed(lambda: [resolve_model(
            name, models_dir=Path(tmp) / "none", registry_path=reg)
            for name in ("panel", "partial")], "cpu")
    check(all(np.array_equal(a.W, b.W) for a, b in zip(models, (full, part))),
          "the resolved models differ from the saved ones")
    print(f"[annot] {n_cells:,} cells x {len(genes)} genes, {len(types)} "
          f"planted types: made on the card in {t_data:.3f} s; two models "
          f"saved and resolved through a registry in {t_res:.3f} s")
    times = annotation_path(d, dev, models, markers,
                            own_markers(markers, types, "B cell"))
    truth = d.obs["truth"].astype(str).to_numpy()
    pred = d.obs["cell_type_predicted"].astype(str).to_numpy()
    acc = float((pred == truth).mean())
    conf = d.obs["cell_type_confidence"].to_numpy()
    check(acc > 0.9 and np.isfinite(conf).all(),
          f"annotate_cells: accuracy {acc:.4f} against the planted types")
    scores = torch.as_tensor(d.obsm["cell_type_decision_scores"])
    check(scores.device.type == dev.type
          and tuple(scores.shape) == (n_cells, len(types))
          and bool(torch.isfinite(scores).all()),
          "the decision scores are not a finite [N, C] tensor on the card")
    un = float((d.obs["cell_type"] == "Unassigned").mean())
    summ = d.uns["annotation_benchmark"]["summary"]
    check(all(np.isfinite(v) for v in summ.values()) and un < 0.2,
          f"benchmark summary {summ}, unassigned {un:.4f}")
    rg = d.uns["rank_genes_groups"]
    hits = np.mean([rg["names"][t][0] in markers[t] for t in types])
    check(hits >= 0.9, f"top DEG is a canonical marker for {hits:.2%} of types")
    is_b = truth == "B cell"
    n_b = int(is_b.sum())
    found = {}
    for pre in ("b_ks", "b_gmm"):
        high = d.obs[f"{pre}_cluster"].to_numpy() == 1
        recall = float(high[is_b].mean())
        enrich = float(is_b[high].mean() / is_b.mean())
        found[pre] = f"{int(high.sum()):,} high, recall {recall:.4f}, " \
            f"B cells enriched {enrich:.1f}x"
        # a 2-component GMM of a zero-inflated metagene may split the B
        # cells' own mode; the high cluster must still be mostly theirs
        check(recall >= 0.7 and enrich >= 5,
              f"classify_by_threshold {pre}: {found[pre]}")
    nmf = d.uns["nmf_params"]
    check(0 < nmf["final_relative_loss"] < 1, f"NMF loss {nmf}")
    sm = torch.as_tensor(d.layers["diffused"])
    check(sm.device.type == dev.type and bool(torch.isfinite(sm).all()),
          "smoothing output")
    ev = np.asarray(d.uns["X_diffmap_evals"])
    check(bool(np.all(np.isfinite(ev)) and np.all(np.abs(ev) <= 1 + 1e-3)),
          f"diffusion eigenvalues {ev}")
    total = time.perf_counter() - t0
    print(f"[annot] {n_cells:,} cells [{smi}]: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in times.items())
        + f"; accuracy {acc:.4f}, unassigned after the filters {un:.4f}, "
        f"benchmark " + ", ".join(f"{k} {v:.4f}" for k, v in summ.items())
        + f"; top DEG a marker for {hits:.0%} of types; {n_b:,} B cells, "
        f"ks {found['b_ks']}, gmm {found['b_gmm']}; NMF loss "
        f"{nmf['final_relative_loss']:.4f} in {nmf['n_iter']} steps; "
        f"diffusion eigenvalues {ev[:3].round(5).tolist()}...; "
        f"phase 13 at {n_cells:,} took {total:.1f} s")
    del d, scores, sm
    release()
    return times


def phase_annotation_vs_cpu(dev, n_cells: int = 20_000):
    """The same path at 20,000 cells (the same panel, the 1M density) on the
    card and on the CPU: what is bitwise, and what within a tolerance
    (decision scores 1e-6 of the largest |score|, confidences 1e-5, NMF
    loss rtol 1e-4 at 30 fixed steps and 1e-3 with the stop within a step,
    smoothing 1e-6, diffusion eigenvalues 1e-5 and embedding 1e-4 up to
    sign, log fold changes and the benchmark 1e-4, labels after the marker
    validation on all but 0.1% of cells)."""
    from spatialcore_tpu_torch.core import rng as prng
    from spatialcore_tpu_torch.stats.thresholding import compute_metagene_score
    runs = []
    for where in (dev, torch.device("cpu")):
        d, types, genes, mu, markers = annotation_section(dev, n_cells, seed=5)
        d.X = d.X.to(where)
        d.obsm["spatial"] = d.obsm["spatial"].to(where)
        models = annotation_models(types, genes, mu, seed=5)
        annotation_path(d, where, models, markers,
                        own_markers(markers, types, "B cell"))
        runs.append(d)
    card, cpu = runs
    same = {}
    for c in ("cell_type_predicted", "truth"):
        same[c] = card.obs[c].astype(str).equals(cpu.obs[c].astype(str))
    check(same["cell_type_predicted"], "annotate_cells labels differ")
    sc_cpu = torch.as_tensor(cpu.obsm["cell_type_decision_scores"])
    # float32 products in another order: relative to the largest |score|
    ds = float((torch.as_tensor(card.obsm["cell_type_decision_scores"]).cpu()
                - sc_cpu).abs().max() / sc_cpu.abs().max())
    dc = float(np.abs(card.obs["cell_type_confidence"].to_numpy()
                      - cpu.obs["cell_type_confidence"].to_numpy()).max())
    check(ds <= 1e-6 and dc <= 1e-5, f"decision scores {ds} (relative), "
          f"confidence {dc}")
    lab_diff = int((card.obs["cell_type"].astype(str)
                    != cpu.obs["cell_type"].astype(str)).sum())
    check(lab_diff <= n_cells // 1000, f"{lab_diff} labels differ after the "
          "marker validation")
    X = cpu.X[:, :5]
    meta = compute_metagene_score(X.to(dev), device=dev).cpu()
    same["metagene"] = torch.equal(meta, compute_metagene_score(X, device="cpu"))
    k = prng.key_for(0, "diffmap")
    same["normal"] = torch.equal(prng.normal(k, (n_cells, 10), device=dev).cpu(),
                                 prng.normal(k, (n_cells, 10)))
    ra, rb = card.uns["rank_genes_groups"], cpu.uns["rank_genes_groups"]
    same["deg"] = all(ra[f] == rb[f] for f in ("names", "scores", "pvals",
                                               "pvals_adj"))
    lfc = max(float(np.max(np.abs(np.subtract(ra["logfoldchanges"][t],
                                              rb["logfoldchanges"][t]))))
              for t in ra["names"])
    check(same["metagene"] and same["deg"] and lfc <= 1e-4,
          f"card against CPU: metagene bitwise {same['metagene']}, DEG "
          f"bitwise {same['deg']}, log fold changes {lfc}")
    for pre in ("b_ks", "b_gmm"):
        same[pre] = card.obs[f"{pre}_cluster"].equals(cpu.obs[f"{pre}_cluster"])
    # run_nmf stops where two successive losses lie within 1e-4 of each
    # other, so float32 products in another order can move the stop by a
    # step on a slow plateau; at a fixed count of steps the losses agree
    na, nb = card.uns["nmf_params"], cpu.uns["nmf_params"]
    nmf_rel = abs(na["final_relative_loss"] / nb["final_relative_loss"] - 1)
    check(nmf_rel <= 1e-3 and abs(na["n_iter"] - nb["n_iter"]) <= 1,
          f"NMF: {na['final_relative_loss']} in {na['n_iter']} steps against "
          f"{nb['final_relative_loss']} in {nb['n_iter']}")
    from spatialcore_tpu_torch.nmf import nmf_fit
    fixed = [float(nmf_fit(d.X, 10, max_iter=30, tol=0.0).loss)
             for d in (card, cpu)]
    fixed_rel = abs(fixed[0] / fixed[1] - 1)
    check(fixed_rel <= 1e-4, f"NMF at 30 fixed steps: loss {fixed}")
    sm_card = torch.as_tensor(card.layers["diffused"]).cpu()
    sm_cpu = torch.as_tensor(cpu.layers["diffused"])
    same["smooth"] = torch.equal(sm_card, sm_cpu)
    sm = float((sm_card - sm_cpu).abs().max())
    ea, eb = card.obsm["X_diffmap"], cpu.obsm["X_diffmap"]
    sign = np.sign((ea * eb).sum(axis=0))
    emb = float(np.abs(ea * sign - eb).max())
    evd = float(np.abs(np.subtract(card.uns["X_diffmap_evals"],
                                   cpu.uns["X_diffmap_evals"])).max())
    check(sm <= 1e-6 and evd <= 1e-5 and emb <= 1e-4,
          f"smoothing {sm}, diffusion eigenvalues {evd}, embedding {emb}")
    sa = card.uns["annotation_benchmark"]["summary"]
    sb = cpu.uns["annotation_benchmark"]["summary"]
    bd = max(abs(sa[k] - sb[k]) for k in sa if np.isfinite(sb[k]))
    check(bd <= 1e-4, f"benchmark summaries differ by {bd}")
    print(f"[annot] {n_cells:,} cells, card against CPU: bitwise "
          + ", ".join(k for k, v in same.items() if v)
          + (f"; not bitwise {[k for k, v in same.items() if not v]}"
             if not all(same.values()) else "")
          + f"; decision scores {ds:.3g} of the largest, confidence {dc:.3g}, "
          f"labels after "
          f"the marker validation differ for {lab_diff} cells, log fold "
          f"changes {lfc:.3g}, run_nmf loss rel {nmf_rel:.3g} ({na['n_iter']} "
          f"against {nb['n_iter']} steps) and {fixed_rel:.3g} at 30 fixed "
          f"steps, smoothing {sm:.3g}, diffusion eigenvalues {evd:.3g}, "
          f"embedding {emb:.3g} up to sign, benchmark {bd:.3g}")


# ---------------------------------------------------------------------------
# Phase 14: the training half of annotation, the pipeline and the CLI
# ---------------------------------------------------------------------------

#: the references' author-style labels of the planted types
REF_LABELS = {
    "B cell": "B cells", "T cell": "T cells",
    "CD4-positive, alpha-beta T cell": "CD4+ T cells",
    "CD8-positive, alpha-beta T cell": "CD8+ T cells",
    "natural killer cell": "NK cells", "plasma cell": "Plasma cells",
    "monocyte": "Monocytes", "macrophage": "Macrophages",
    "dendritic cell": "Dendritic cells", "mast cell": "Mast cells",
    "neutrophil": "Neutrophils", "endothelial cell": "Endothelial cells",
    "lymphatic endothelial cell": "Lymphatic endothelial cells",
    "fibroblast": "Fibroblasts", "smooth muscle cell": "Smooth muscle cells",
    "pericyte": "Pericytes", "epithelial cell": "Epithelial cells",
    "basal cell": "Basal cells", "goblet cell": "Goblet cells",
    "adipocyte": "Adipocytes"}
#: labels that ``DEFAULT_EXCLUDE_LABELS`` drops, on 1% of the cells
REF_JUNK = ("Unknown", "doublet", "low quality")
REF_CELLS = 250_000
REF_GENES = 500
#: filler panel genes the first reference lacks (the inner join drops them)
REF_MISSING = 5


def annotation_references(dev, n_cells: int = REF_CELLS, seeds=(1, 2)):
    """Two reference containers on the host, each ``n_cells`` x 500 genes:
    the panel's 377 genes (phase 13's profiles, other seeds) and 123 the
    panel lacks; raw Poisson counts drawn on ``dev`` and kept as CSR in X
    and ``layers["counts"]``; author-style labels (``REF_LABELS``) and 1%
    junk labels. The first lacks ``REF_MISSING`` filler panel genes, the
    second names its genes by Ensembl ID where the bundled mapping has one.
    """
    import scipy.sparse as sp
    from spatialcore_tpu_torch.core.genes import load_ensembl_to_hugo_mapping
    types, genes, mu, _ = annotation_panel(seed=0)
    rng = np.random.default_rng(seeds[0])
    extra = [f"OFFPANEL{i:03d}" for i in range(REF_GENES - len(genes))]
    mu_all = np.hstack([mu, rng.gamma(2.0, 0.3, (len(types), len(extra)))]
                       ).astype(np.float32)
    names = np.array(genes + extra, dtype=object)
    hugo_to_ens = {}
    for ens, hugo in load_ensembl_to_hugo_mapping().items():
        hugo_to_ens.setdefault(hugo, ens)
    labels = np.array([REF_LABELS[t] for t in types] + list(REF_JUNK),
                      dtype=object)
    refs = []
    for r, seed in enumerate(seeds):
        gen = torch.Generator(device=dev).manual_seed(seed)
        lab = torch.randint(0, len(types), (n_cells,), generator=gen,
                            device=dev)
        counts = torch.poisson(torch.as_tensor(mu_all, device=dev)[lab],
                               generator=gen)
        csr = counts.to_sparse_csr()
        X = sp.csr_matrix((csr.values().cpu().numpy(),
                           csr.col_indices().to(torch.int32).cpu().numpy(),
                           csr.crow_indices().to(torch.int32).cpu().numpy()),
                          shape=tuple(counts.shape))
        del counts, csr
        codes = lab.cpu().numpy()
        junk = np.random.default_rng(seed).random(n_cells) < 0.01
        codes[junk] = len(types) + np.arange(int(junk.sum())) % len(REF_JUNK)
        var_names = names.copy()
        keep = np.arange(len(names))
        if r == 0:      # the last filler panel genes absent here
            keep = np.delete(keep, np.arange(len(genes) - REF_MISSING,
                                             len(genes)))
            X, var_names = X[:, keep], names[keep]
        else:
            var_names = np.array([hugo_to_ens.get(g, g) for g in names],
                                 dtype=object)
        d = SpatialData(X=X, obs=pd.DataFrame(
            {"cell_type": labels[codes]},
            index=[f"ref{r}_{i}" for i in range(n_cells)]),
            var=pd.DataFrame(index=pd.Index(var_names)))
        d.layers["counts"] = X
        d.uns["reference_name"] = f"ref{r}"
        refs.append(d)
    return refs


class StageClock(logging.Handler):
    """Host timestamps of a logger's messages (the pipeline's "Stage N"
    lines, the trainer's epochs): each stage runs from its line to the
    next."""

    def __init__(self, name: str):
        super().__init__(logging.INFO)
        self.log = logging.getLogger(name)
        self.marks = []

    def __enter__(self):
        self.log.addHandler(self)
        return self

    def __exit__(self, *exc):
        self.log.removeHandler(self)
        self.marks.append((time.perf_counter(), "end"))

    def emit(self, record):
        self.marks.append((time.perf_counter(), record.getMessage()))

    def spans(self, prefix: str):
        """(message, seconds to the next mark) for marks starting with
        ``prefix``."""
        return [(m, t1 - t0) for (t0, m), (t1, _) in
                zip(self.marks, self.marks[1:]) if m.startswith(prefix)]


def planted_accuracy(d, column: str) -> float:
    """Share of cells whose ``column`` label is their planted type's
    author-style label."""
    want = np.array([REF_LABELS[t] for t in d.obs["truth"].astype(str)])
    return float((d.obs[column].astype(str).to_numpy() == want).mean())


def phase_training(dev, smi: str, n_cells: int = ANNOT_CELLS,
                   ref_cells: int = REF_CELLS):
    """The training path at full width on the card: ``train_and_annotate``
    from two 250,000-cell references (in memory) onto phase 13's 1M x 377
    section with its defaults (5,000 cells a type, 30 epochs, batch
    1,024), each stage timed; ``train_cell_type_model`` on the section for
    3 epochs (976 steps an epoch); a checkpointed run resumed to the same
    epoch count against the uninterrupted one; accuracy against the
    planted types. Every call is checked to launch no kernel."""
    from spatialcore_tpu_torch.annotation import (train_and_annotate,
                                                  train_cell_type_model)
    release()
    t0 = time.perf_counter()
    refs, t_refs = timed(lambda: annotation_references(dev, ref_cells), dev)
    (d, types, genes, _, _), t_q = timed(
        lambda: annotation_section(dev, n_cells), dev)
    print(f"[train] two references of {ref_cells:,} cells x {REF_GENES} "
          f"genes (raw counts as CSR on the host; {refs[0].X.nnz:,} and "
          f"{refs[1].X.nnz:,} nonzeros) made in {t_refs:.3f} s; the "
          f"{n_cells:,}-cell query in {t_q:.3f} s")
    with tempfile.TemporaryDirectory() as tmp, \
            StageClock("spatialcore_tpu_torch.annotation.pipeline") as clock:
        (d, model), t_pipe, got = counted(
            dev, "train", f"train_and_annotate onto {n_cells:,} cells",
            lambda: train_and_annotate(d, references=refs, device=dev,
                                       output_dir=tmp, make_plots=False,
                                       model_name="phase14"))
        saved = sorted(p.name for p in Path(tmp).iterdir())
    check(not got, f"train_and_annotate launched kernels: {got}")
    stages = clock.spans("Stage")
    acc = planted_accuracy(d, "cell_type_predicted")
    ann = d.uns["spatialcore_annotation"]
    ids = d.obs["cell_type_ontology_term_id"].astype(str)
    check(acc >= 0.95 and ids.str.startswith("CL:").all()
          and ann["n_types"] == len(types)
          # 5,000 a type; a type's proportional source shares round up
          and min(len(types) * 5000, int(1.96 * ref_cells))
          <= ann["n_training_cells"] <= len(types) * 5001
          and "phase14.npz" in saved,
          f"train_and_annotate: accuracy {acc:.4f}, {ann['n_types']} types, "
          f"{ann['n_training_cells']} training cells, files {saved}")
    print(f"[train] train_and_annotate {n_cells:,} cells [{smi}]: "
          f"{t_pipe:.3f} s; " + ", ".join(f"{m.split(':')[0]} {t:.3f} s"
                                         for m, t in stages)
          + f"; {ann['n_training_cells']:,} training cells, "
          f"{len(model.genes)} genes (the inner join), {ann['n_types']} "
          f"types; accuracy {acc:.4f} against the planted types, "
          f"{ann['n_unassigned']:,} unassigned ({ann['unassigned_pct']}%)")
    del refs
    release()

    # the trainer alone on the section: 3 epochs of 976 steps
    _, t_scaler = timed(lambda: (lambda h: (h.mean(0), h.std(0)))(
        d.X.cpu().numpy()), "cpu")
    with StageClock("spatialcore_tpu_torch.annotation.training") as clock:
        full, t_train, got = counted(
            dev, "train", f"train_cell_type_model {n_cells:,} cells x 3 "
            "epochs", lambda: train_cell_type_model(d, "truth", epochs=3,
                                                    device=dev))
    check(not got, f"train_cell_type_model launched kernels: {got}")
    epochs = [t for m, t in clock.spans("  epoch")]
    steps = n_cells // 1024
    per_epoch = float(np.mean(epochs[:-1])) if len(epochs) > 1 else epochs[0]
    pred, _ = full.predict(d.X, device=dev)
    acc1m = float((pred == d.obs["truth"].astype(str).to_numpy()).mean())
    check(acc1m >= 0.95 and np.isfinite(full.W).all(),
          f"the 1M-trained model's accuracy {acc1m:.4f}")
    with tempfile.TemporaryDirectory() as ck:
        part, t_part, got1 = counted(
            dev, "train", "2 epochs, checkpointed each", lambda:
            train_cell_type_model(d, "truth", epochs=2, checkpoint_dir=ck,
                                  checkpoint_every=1, device=dev))
        resumed, t_res, got2 = counted(
            dev, "train", "resumed to 3 epochs", lambda:
            train_cell_type_model(d, "truth", epochs=3, checkpoint_dir=ck,
                                  checkpoint_every=1, device=dev))
        kept = sorted(int(p.name) for p in Path(ck).iterdir())
    check(not got1 and not got2 and kept == [1, 2],
          f"checkpointed runs: launches {got1} {got2}, kept {kept}")
    same = np.array_equal(resumed.W, full.W) and np.array_equal(resumed.b,
                                                                full.b)
    gap = float(max(np.abs(resumed.W - full.W).max(),
                    np.abs(resumed.b - full.b).max()))
    print(f"[train] train_cell_type_model {n_cells:,} cells x {len(genes)} "
          f"genes, 20 classes, 3 epochs of {steps} steps (batch 1,024) "
          f"[{smi}]: {t_train:.3f} s; epochs 2 and 3 (host clock between "
          f"the trainer's epoch lines) "
          + ", ".join(f"{t:.3f}" for t in epochs[:-1])
          + f" s, so {per_epoch:.3f} s an epoch and "
          f"{1e3 * per_epoch / steps:.4f} ms a step; the host scaler "
          f"(read back, numpy float32 mean and std) {t_scaler:.3f} s; "
          f"accuracy {acc1m:.4f}; checkpointed 2 epochs {t_part:.3f} s, "
          f"resumed to 3 {t_res:.3f} s: "
          + ("bitwise the uninterrupted run" if same else
             f"differs from the uninterrupted run by {gap:.3g}"))
    check(same or gap <= 1e-6, f"resumed run differs by {gap}")
    print(f"[train] phase 14's training path at full width took "
          f"{time.perf_counter() - t0:.1f} s")
    del d
    release()
    return {"train_and_annotate": t_pipe, "epoch": per_epoch,
            "ms_per_step": 1e3 * per_epoch / steps}


def phase_training_vs_cpu(dev, n_cells: int = 20_000):
    """The trainer and the pipeline at 20,000 cells on the card and on the
    CPU: ``train_cell_type_model`` (5 epochs) weights within 1e-4 of
    max|W|, labels, scaler and classes equal; ``train_and_annotate`` from
    two 20,000-cell references: predicted labels and CL IDs equal, the
    thresholded labels on all but 0.1% of cells."""
    from spatialcore_tpu_torch.annotation import (train_and_annotate,
                                                  train_cell_type_model)
    cpu = torch.device("cpu")
    models, preds, piped = [], [], []
    refs = annotation_references(dev, n_cells, seeds=(3, 4))
    for where in (dev, cpu):
        d, *_ = annotation_section(dev, n_cells, seed=6)
        d.X = d.X.to(where)
        m, _, got = counted(dev, "train", f"train_cell_type_model on {where}",
                            lambda: train_cell_type_model(
                                d, "truth", epochs=5, device=where))
        check(not got, f"launched {got}")
        models.append(m)
        preds.append(m.predict(d.X, device=where)[0])
        q, *_ = annotation_section(dev, n_cells, seed=7)
        q.X = q.X.to(where)
        (q, _), _, got = counted(dev, "train", f"train_and_annotate on {where}",
                                 lambda: train_and_annotate(
                                     q, references=refs, device=where,
                                     make_plots=False))
        check(not got, f"launched {got}")
        piped.append(q)
    (mc, mh), (qc, qh) = models, piped
    dw = float(np.abs(mc.W - mh.W).max() / np.abs(mh.W).max())
    same = {"labels": np.array_equal(*preds),
            "scaler": np.array_equal(mc.scaler_mean, mh.scaler_mean)
            and np.array_equal(mc.scaler_std, mh.scaler_std),
            "classes": mc.classes == mh.classes}
    for col in ("cell_type_predicted", "cell_type_ontology_term_id"):
        same[col] = qc.obs[col].astype(str).equals(qh.obs[col].astype(str))
    n_diff = int((qc.obs["cell_type"].astype(str)
                  != qh.obs["cell_type"].astype(str)).sum())
    check(dw <= 1e-4 and all(same.values()) and n_diff <= n_cells // 1000,
          f"card against CPU: W {dw}, equal {same}, thresholded labels "
          f"differ on {n_diff} cells")
    print(f"[train] {n_cells:,} cells, card against CPU: W within {dw:.3g} "
          f"of max|W| (b {float(np.abs(mc.b - mh.b).max()):.3g}); equal: "
          + ", ".join(same) + f"; thresholded labels differ on {n_diff} cells")


def phase_cli(dev) -> None:
    """The command line and the YAML config where the script runs:
    ``python -m spatialcore_tpu_torch info`` as a subprocess always; the
    YAML round trip where yaml imports; ``moran`` and ``benchmark`` on an
    h5ad with ``--device`` set to ``dev``'s type where h5py imports (else
    one line says why that part did not run)."""
    import importlib.util
    import os
    from spatialcore_tpu_torch.annotation import TrainingConfig
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r, t = timed(lambda: subprocess.run(
        [sys.executable, "-m", "spatialcore_tpu_torch", "info"],
        capture_output=True, text=True, timeout=300, env=env), "cpu")
    check(r.returncode == 0 and "annotation   ok" in r.stdout,
          f"python -m spatialcore_tpu_torch info: {r.stderr[-400:]}")
    print(f"[cli] python -m spatialcore_tpu_torch info ({t:.2f} s): "
          + "; ".join(ln.strip() for ln in r.stdout.splitlines()))
    with tempfile.TemporaryDirectory() as tmp:
        if importlib.util.find_spec("yaml") is None:
            print("[cli] the YAML round trip did not run: yaml is not "
                  "installed")
        else:
            cfg = TrainingConfig(references=["a.h5ad"], epochs=7)
            back = TrainingConfig.from_yaml(cfg.to_yaml(Path(tmp) / "c.yaml"))
            check(back == cfg, "the YAML round trip changed the config")
            print("[cli] TrainingConfig YAML round trip: equal")
        if importlib.util.find_spec("h5py") is None:
            print("[cli] the CLI's h5ad commands (moran, benchmark, domains, "
                  "pipeline) did not run: h5py is not installed")
            return
        from spatialcore_tpu_torch import write_h5ad
        d, *_ = annotation_section(dev, 20_000, seed=8)
        d.obs["cell_type"] = d.obs["truth"]
        write_h5ad(d, Path(tmp) / "q.h5ad")
        for args in (["moran", "--genes", "CD79A,MS4A1,PANEL000",
                      "--permutations", "19", "--top", "3"],
                     ["benchmark", "--columns", "cell_type"]):
            argv = [sys.executable, "-m", "spatialcore_tpu_torch", "--device",
                    torch.device(dev).type, args[0], str(Path(tmp) / "q.h5ad"),
                    *args[1:]]
            r, t = timed(lambda: subprocess.run(
                argv, capture_output=True, text=True, timeout=300, env=env),
                "cpu")
            check(r.returncode == 0, f"{args[0]}: {r.stderr[-400:]}")
            print(f"[cli] {args[0]} --device {torch.device(dev).type} "
                  f"({t:.2f} s): "
                  + " | ".join(r.stdout.strip().splitlines()[-3:]))


def lisa_sass(listing: str) -> None:
    """The local draw step's SASS by instance (template arguments: STAT,
    FAR, COUNT, counter type, k unrolled): instructions in all and the
    opcodes of its inner loop, from the built library (``python -m
    spatialcore_tpu_torch.kernels.sass --match lisa_kernel`` prints every
    opcode)."""
    ops = ("IDP", "PRMT", "IMAD", "LDS", "LDGSTS", "LDG", "STG", "MUFU", "BAR")
    for name, c in sass.opcode_counts(listing).items():
        if "lisa_kernel<" in name:
            inst = name[name.index("lisa_kernel<"):]
            inst = inst[:inst.find(">(") + 1 or None]
            print(f"[sass] {inst}: {sum(c.values())} instructions; "
                  + ", ".join(f"{op} {c[op]}" for op in ops if c[op]))


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
    listing = sass._listing(None)
    lisa_sass(listing)
    knn_sass(listing)
    del listing

    gen = torch.Generator(device=dev).manual_seed(0)
    plan300 = real_plan(dev, 300, gen)
    kres = phase_kernels(dev, plan300, gen, [
        ("int4_win", 4096), ("int8_win", 4096), ("int8_band", 4096),
        ("bf16", 1024), ("f32", 512), ("bf16", 1000), ("int4_win", 1000)],
        reps=20)
    kres.update(phase_lisa_kernels(dev, plan300, gen, 1024, reps=20))
    kres.update(phase_tail_kernels(dev, plan300, gen, 1024, reps=20))
    kres.update(phase_lee_kernels(dev, plan300, gen, 1024, reps=20))
    kres.update(phase_dense_kernels(dev, plan300, gen, {"bf16": 1024, "f32": 512},
                                    reps=20))
    del plan300
    kres.update(phase_knn_kernel(dev, gen))

    # the global null's path
    kern.reset_launch_counts()
    kern_lisa.reset_launch_counts()
    _, plan1m, tile0 = phase_workload(dev, 1_000_000, 8192, 4096, 16, 16, gen)
    phase_public(dev, 1_000_000, 1024, 19, gen)
    launches = dict(kern.LAUNCHES)
    print(f"[path] band-cross launches in phases 3-4: {launches}")
    for mode in GLOBAL_MODES:
        check(launches[mode] > 0, f"kernel mode {mode} never launched")
    for mode, err in hold_int_1m(plan1m, tile0).items():
        kres[mode]["max_abs_err"] = max(kres[mode]["max_abs_err"], err)
    int_draw_split(plan1m, tile0)
    del plan1m, tile0
    torch.cuda.empty_cache()
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
    d = phase_gi_greater(dev, 1_000_000, 256, n_perms, gen)
    gi = dict(kern_lisa.LAUNCHES)
    print(f"[path] launches of getis_ord_gi(star=False, greater): {gi}")
    check(gi["getis_g_win"] == n_perms and gi["getis_obs"] == 1,
          f"the Gi run did not run the getis_g draw step per draw: {gi}")
    tail_draw_split(dev, d, "getis_g")
    del d
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
    torch.cuda.empty_cache()

    # local Lee's L: the main path's counts are its own
    n_pairs, n_full, tile = 1024, 64, 256
    kern_lisa.reset_launch_counts()
    d, pairs, n_sig, _ = phase_lee_public(dev, 1_000_000, n_pairs, n_full,
                                          n_perms, gen)
    lee = dict(kern_lisa.LAUNCHES)
    print(f"[path] launches of lees_l_local(banded_int8) compact ({n_pairs} "
          f"pairs, {n_pairs // tile} tiles) + full ({n_full} pairs): {lee}")
    check(lee["lee_win"] == (n_pairs // tile + 1) * n_perms
          and lee["lee_obs"] == n_pairs // tile + 1
          and sum(lee.values()) == (n_pairs // tile + 1) * (n_perms + 1),
          "the Lee main path did not run the lee draw step once per draw and "
          "tile and the observed entry once per tile")
    phase_lee_path_kernels(dev, d, pairs[:tile])
    lee_full_split(dev, d, pairs[:n_full], n_perms)
    _, lee_glob = phase_lee_global(dev, d, pairs, n_sig, n_perms)
    lee_draw_split(dev, d, pairs)
    del d
    torch.cuda.empty_cache()
    phase_lee_direct(dev, gen)
    vs_lee = phase_lee_vs_cpu(dev, scattered_coords(seed=2), 64, 11)
    check(vs_lee["lee_win"] == 2 * 49, f"the 4,096-cell Lee card runs did not "
          f"run the draw step per draw: {vs_lee}")
    launches.update(lee_win=lee["lee_win"], lee_obs=lee["lee_obs"],
                    lee_partial=lee_glob["banded_int8"]["lee_partial"])
    print("[path] launches in the kernels line: lee_win and lee_obs from the "
          "1M-cell lees_l_local main path; lee_partial from lees_l(banded_int8)")
    torch.cuda.empty_cache()

    # the graph path through the kNN kernel: counts of its own
    knn_launches, _ = phase_graph_pallas(dev, gen)
    print(f"[path] kNN launches of build_graph(method='pallas') x 2: "
          f"{knn_launches}")
    check(knn_launches == 2, "build_graph(method='pallas') did not launch the "
          "kNN kernel once per call")
    launches["knn"] = knn_launches
    torch.cuda.empty_cache()

    # the global null's remaining routes, each with counts of its own
    t9 = time.perf_counter()
    dense, dense_err = phase_dense_routes(dev, gen)
    launches.update(dense=dense["pallas"]["dense"],
                    rot4=dense["pallas_halo4"]["rot4"])
    for mode, err in dense_err.items():
        kres[mode]["max_abs_err"] = max(kres[mode]["max_abs_err"], err)
    torch.cuda.empty_cache()
    phase_streaming(dev)
    torch.cuda.empty_cache()
    phase_global_public(dev, gen)
    phase_slots_vs_cpu(dev, scattered_coords(seed=3), 16, 12)
    print(f"[path] launches in the kernels line: dense and rot4 from "
          f"banded_permutation_test's 'pallas' and 'pallas_halo4' routes at 1M "
          f"x 1,024 x 8; phase 9 took {time.perf_counter() - t9:.1f} s")
    torch.cuda.empty_cache()

    # the local slot nulls (no kernel) and the local "sort" streams through
    # K7, each call with counts of its own
    t10 = time.perf_counter()
    phase_slot_public(dev, gen, smi)
    slot_draw_split(dev, smi, gen=gen)
    sort = phase_sort_streams(dev, gen, smi)
    phase_slots_local_vs_cpu(dev, scattered_coords(seed=4), 16, 13)
    for stat, (win, obs_mode, _) in SORT_STREAMS.items():
        launches[win] += sort[stat][win]
        launches[obs_mode] += sort[stat][obs_mode]
    print(f"[path] launches in the kernels line: lisa_win / lisa_obs, "
          f"geary_win / geary_obs, getis_star_win, getis_g_win and getis_obs "
          f"add the int8 sort streams' calls (99 draws and one observed pass "
          f"each) to their phase 5-6 main paths; phase 10 took "
          f"{time.perf_counter() - t10:.1f} s [{smi}]")
    release()

    # radius graphs, the correlogram, the bf16 stream and the point
    # patterns, each call with counts of its own
    t11 = time.perf_counter()
    radius, radius_err, _ = phase_radius(dev, gen, smi)
    for mode, err in radius_err.items():
        kres[mode]["max_abs_err"] = max(kres[mode]["max_abs_err"], err)
    for mode in ("int8_win", "float", "lisa_win", "lisa_obs"):
        check(radius.get(mode, 0) > 0, f"the radius route never launched {mode}")
    phase_radius_vs_cpu(dev, scattered_coords(seed=5), 16, 14)
    phase_correlogram(dev, gen, smi)
    _, stream = phase_bf16_stream(dev, smi)
    phase_point_patterns(dev, smi)
    for mode in RADIUS_MODES:
        launches[mode] += radius.get(mode, 0) + stream.get(mode, 0)
    print(f"[path] launches in the kernels line: int8_win, int8_band, float, "
          f"lisa_win and lisa_obs add the radius route's calls {radius} and "
          f"the bf16 stream's {stream}; phase 11 took "
          f"{time.perf_counter() - t11:.1f} s [{smi}]")

    # the niche and domain path (torch ops, no kernel; each call checked to
    # launch none)
    t12 = time.perf_counter()
    phase_niches(dev, smi)
    phase_niches_vs_cpu(dev)
    print(f"[path] phase 12 (niches and domains) took "
          f"{time.perf_counter() - t12:.1f} s [{smi}]")

    # the statistics and the annotation scoring path (torch ops, no kernel;
    # each call checked to launch none)
    t13 = time.perf_counter()
    phase_annotation(dev, smi)
    phase_annotation_vs_cpu(dev)
    print(f"[path] phase 13 (statistics and annotation scoring) took "
          f"{time.perf_counter() - t13:.1f} s [{smi}]")

    # the training half of annotation, the pipeline and the CLI (torch ops,
    # no kernel; each call checked to launch none)
    t14 = time.perf_counter()
    phase_training(dev, smi)
    phase_training_vs_cpu(dev)
    phase_cli(dev)
    print(f"[path] phase 14 (training, the pipeline and the CLI) took "
          f"{time.perf_counter() - t14:.1f} s [{smi}]")
    print(f"[path] the whole script took {time.perf_counter() - T_START:.1f} s "
          f"[{smi}]")

    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[mode], **kres[mode]}
        for mode, (name, src, rep) in {**KERNELS, **LISA_KERNELS,
                                       **KNN_KERNELS}.items()]}
    print(smi)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
