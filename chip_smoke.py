"""One run of the PyTorch port's main path on one CUDA GPU.

    python3 chip_smoke.py

Phases (the script stops with a non-zero exit at the first failure):

1. Device and build: the card's name and power limit (nvidia-smi), and the
   nvcc build of ``spatialcore_tpu_torch/csrc/*.cu`` with its time.
2. Each band-cross kernel against its plain PyTorch version, on the card,
   at B=256 on 300 blocks of a real kNN plan (int4/int8 windowed far at
   G=4096, int8 band-only at G=4096, bf16 at G=1024, f32 at G=512), with
   both times.
3. The headline workload through the ops entry points: 1,000,000 cells
   uniform on [0, 6000]², k=6, B=256; graph, null plan, standardize,
   observed I, int4 quantization and packing; then
   ``banded_permutation_test(precision="int4")`` over 8,192 genes as two
   4,096-gene tiles with draws chunked through ``draw_offset``, the plain
   version for 2 draws on one tile, a bitwise re-run of one chunk, and one
   int8 exact-far chunk (the band-only kernel).
4. The public API: ``morans_i(null_method="banded_int8")`` and
   ``gearys_c(null_method="banded")`` on a SpatialData of 1,000,000 cells ×
   1,024 genes whose X is a CUDA tensor; and a small input against the
   port's CPU path, which the CPU tests hold against the JAX package.
5. Proof of path: every kernel launched during phases 3–4.

The last line is ``{"ok": true, "device": {...}}``; the line before it a
JSON summary of every kernel, and the one before that nvidia-smi's name
and power limit. Without a CUDA device the script raises.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from spatialcore_tpu_torch import SpatialData, gearys_c, morans_i
from spatialcore_tpu_torch.kernels import band_cross as kern
from spatialcore_tpu_torch.kernels import build
from spatialcore_tpu_torch.ops import banded
from spatialcore_tpu_torch.ops.banded import banded_permutation_test, build_null_plan
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
    """Mean milliseconds per call by CUDA events, after two warm-up calls."""
    for _ in range(2):
        fn()
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


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_cases(dev, n_blocks: int, gen, widths):
    """Operands of every kernel mode on a real plan of ``n_blocks`` blocks
    at the 1M-cell density. Yields (mode, label, kernel_fn, plain_fn,
    scale_fn): scale_fn gives Σ_i |term_i| per gene for the tolerance."""
    n = n_blocks * B
    coords = uniform_coords(n, SIDE * (n / 1e6) ** 0.5, gen, dev)
    plan = build_null_plan(build_graph(coords, n_neighbors=K, device=dev),
                           coords, block=B)
    rows_idx = torch.arange((n_blocks + 2) * B, device=dev) - B
    rows_idx = plan.order[rows_idx.clamp(0, n - 1)]
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
                   scale)
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

        yield (mode, f"{mode} G={G}",
               lambda zp=zp, far=far, sw=sw, packed=packed: kern.band_cross_int8(
                   li, ops.wq, sw, zp, B, packed=packed, **far),
               lambda zp=zp, far=far, sw=sw, packed=packed: kern.band_cross_int8_plain(
                   li, ops.wq, sw, zp, B, packed=packed, **far),
               scale)


def phase_kernels(dev, n_blocks: int, gen, widths, reps: int):
    """Kernel vs plain on the card; returns {mode: (err, ms, plain_ms)}."""
    results = {}
    for mode, label, kfn, pfn, scale_fn in kernel_cases(dev, n_blocks, gen, widths):
        got, want = kfn(), pfn()
        sync(dev)
        err = (got.double() - want.double()).abs()
        bound = REL_TOL * scale_fn() + 1e-30
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite cross")
        check(bool((err <= bound).all()),
              f"{label}: kernel disagrees with plain (max err "
              f"{float(err.max()):.3e}, bound {float(bound.min()):.3e})")
        if torch.device(dev).type == "cuda":
            ms, plain_ms = event_ms(kfn, reps), event_ms(pfn, max(1, reps // 5))
        else:
            ms = plain_ms = float("nan")
        print(f"[kernels] {label}: max_abs_err={float(err.max()):.3e} "
              f"(bound {REL_TOL:g}·Σ|terms|, min {float(bound.min()):.3e}) "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"({n_blocks} blocks, B={B})")
        old = results.get(mode)
        if old is None or mode != "float" or label.startswith("bf16"):
            results[mode] = (max(float(err.max()), old[0] if old else 0.0),
                             ms, plain_ms)
        else:
            results[mode] = (max(old[0], float(err.max())), old[1], old[2])
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
    kres = phase_kernels(dev, 300, gen, {"int4_win": 4096, "int8_win": 4096,
                                         "int8_band": 4096, "bf16": 1024,
                                         "f32": 512}, reps=20)

    kern.reset_launch_counts()
    phase_workload(dev, 1_000_000, 8192, 4096, 32, 16, gen)
    phase_public(dev, 1_000_000, 1024, 19, gen)
    launches = dict(kern.LAUNCHES)
    print(f"[path] kernel launches in phases 3-4: {launches}")
    for mode in KERNELS:
        check(launches[mode] > 0, f"kernel mode {mode} never launched")
    phase_small_reference(dev, gen)

    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[mode], "max_abs_err": kres[mode][0],
         "ms": kres[mode][1], "plain_ms": kres[mode][2]}
        for mode, (name, src, rep) in KERNELS.items()]}
    print(smi)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
