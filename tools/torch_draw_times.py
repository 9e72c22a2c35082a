"""Per-draw times of the port's global nulls on one CUDA card.

Times ``ops.moran.permutation_test_global`` (the slot null) and
``ops.banded.banded_permutation_test`` at int4, int8 and bf16 on a 1M-cell
uniform layout (k = 6, B = 256, the layout of ``chip_smoke.py`` phase 3).
A draw's time is (t(P = hi) − t(P = lo)) / (hi − lo) over calls with the
same inputs, so the once-a-call work (Σz², the observed pass, quantizing)
cancels. Where ``banded_permutation_test`` takes ``launch_genes``, one
gene shard of a (1 × 4) mesh is also timed both ways: launched at the
shard's own shape and at the whole table's; and where
``kernels/band_cross.tree_sum`` exists, the bf16 draw's far-edge terms
are summed both by it and by one ``sum(dim=0)``.

Run from anywhere; ``--root`` names the checkout whose
``spatialcore_tpu_torch`` is imported, so two trees can be compared on
one card in turns (parent, change, change, parent)::

    python tools/torch_draw_times.py --root . --tag change \\
        --out draw_times_change.json

Every line printed is one JSON object; the last one lists them all.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.join(os.path.dirname(__file__), ".."))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cells", type=int, default=1_000_000)
    ap.add_argument("--lo", type=int, default=2)
    ap.add_argument("--hi", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cpu: a rehearsal at a small --cells")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    from spatialcore_tpu_torch.kernels import build
    from spatialcore_tpu_torch.ops.banded import (banded_permutation_test,
                                                  build_null_plan)
    from spatialcore_tpu_torch.ops.graph import build_graph
    from spatialcore_tpu_torch.ops.moran import (moran_observed,
                                                 permutation_test_global,
                                                 standardize)

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("torch_draw_times: no CUDA card")
        torch.backends.cuda.matmul.allow_tf32 = False
        import subprocess
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60).stdout.strip()
        build.load_library()
    else:
        smi = "cpu rehearsal"
    rows = []

    def emit(**kw):
        row = dict(tag=args.tag, card=smi, **kw)
        rows.append(row)
        print(json.dumps(row), flush=True)

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def wall(fn) -> float:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return time.perf_counter() - t0

    def per_draw(name: str, call, **extra) -> None:
        call(1)                                         # warm
        samples = []
        for _ in range(args.reps):
            t_lo, t_hi = wall(lambda: call(args.lo)), wall(lambda: call(args.hi))
            samples.append((t_hi - t_lo) / (args.hi - args.lo) * 1e3)
        emit(name=name, draw_ms=sorted(samples)[len(samples) // 2],
             draw_ms_samples=samples, **extra)

    n = args.cells
    gen = torch.Generator(device=dev).manual_seed(17)
    coords = torch.rand((n, 2), generator=gen, device=dev) * 6000.0
    graph = build_graph(coords, n_neighbors=6, device=dev)
    plan = build_null_plan(graph, coords, block=256)
    S0 = float(n)
    wave = torch.sin(coords[:, :1] / 300.0)

    def table(G: int) -> torch.Tensor:
        X = torch.randn((n, G), generator=gen, device=dev)
        X[:, :G // 8] += wave
        return standardize(X)[0]

    Z = table(1024)
    obs = moran_observed(graph, Z, S0)
    per_draw("slots f32 1,024 genes",
             lambda P: permutation_test_global(graph, Z, S0, obs, 0, P),
             genes=1024)
    for prec in ("int8", "bf16"):
        per_draw(f"banded {prec} 1,024 genes",
                 lambda P, p=prec: banded_permutation_test(plan, Z, S0, obs, 0,
                                                           P, precision=p),
                 genes=1024)
    sharded = "launch_genes" in inspect.signature(banded_permutation_test).parameters
    if sharded:
        Zc, oc = Z[:, :256], obs[:256]
        for prec in ("int8", "bf16"):
            for lg in (None, 1024):
                per_draw(f"banded {prec} gene shard 256 of 1,024",
                         lambda P, p=prec, lg=lg: banded_permutation_test(
                             plan, Zc, S0, oc, 0, P, precision=p,
                             launch_genes=lg), genes=256, launch_genes=lg)
    from spatialcore_tpu_torch.kernels import band_cross as kern
    if hasattr(kern, "tree_sum"):
        # the bf16 draw's far-edge terms [F, G], summed over the edges both ways
        Zp = torch.randn(((plan.n_padded // 256) + 2) * 256, 1024,
                         generator=gen, device=dev).bfloat16()
        fs, ft = Zp[plan.far_src].float(), Zp[plan.far_dst].float()
        part = plan.far_w.bfloat16().float()[:, None] * fs * ft
        del fs, ft, Zp
        for name, fn in (("sum(dim=0)", lambda: part.sum(dim=0)),
                         ("tree_sum", lambda: kern.tree_sum(part))):
            fn()
            emit(name=f"far-edge terms {tuple(part.shape)}: {name}",
                 call_ms=wall(lambda: [fn() for _ in range(20)]) / 20 * 1e3)
        del part
    del Z, obs
    Z = table(4096)
    zeros = torch.zeros(4096, device=dev)
    per_draw("banded int4 4,096 genes",
             lambda P: banded_permutation_test(plan, Z, S0, zeros, 0, P,
                                               precision="int4"), genes=4096)
    if sharded:
        Zc = Z[:, :1024]
        for lg in (None, 4096):
            per_draw("banded int4 gene shard 1,024 of 4,096",
                     lambda P, lg=lg: banded_permutation_test(
                         plan, Zc, S0, zeros[:1024], 0, P, precision="int4",
                         launch_genes=lg), genes=1024, launch_genes=lg)
    print(json.dumps({"tag": args.tag, "rows": rows}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
