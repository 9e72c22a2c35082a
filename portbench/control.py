"""The readings that the correctness limits are set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 [--program 1]

For each seed: the cell's section; with ``--program 1`` one call of the
program's entry at the cell's size (set-up and warm-up as a run makes
them) and its readings against the reference (the lower readings); the
control, the reference one precision step below what the traffic states
(``reference.stats.LOWER``) put in the program's place, and its readings
(the upper readings); and, where the traffic names ``control_args``, the
program's own lower-precision path (the entry called with those
arguments) and its readings. One JSON line a seed. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings_for(root, cell_name: str, seed: int, program: bool,
                 device=None) -> dict:
    import torch

    from portbench.harness import section as section_mod
    from portbench.harness import spec

    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, cell_name)
    cfg = spec.config(root, bench, cell["config"])
    traffic = spec.traffic(root, cell["traffic"])
    entry = spec.entry(root, traffic["entry"])
    ref = spec.reference(root, traffic["entry"])
    device = device or "cuda"
    sec = section_mod.make(cfg, seed, device)
    n_call = int(traffic.get("genes") or cfg["n_genes"])
    sec.update(k=int(cfg["n_neighbors"]), null_seed=seed & 0x7FFFFFFF,
               genes=list(range(n_call)))
    smp = ref.sample(int(cfg["n_cells"]), n_call, seed, traffic)
    rec = {"cell": cell_name, "seed": seed}
    outs = {}
    runs = [("program", {})] if program else []
    if "control_args" in traffic:
        runs.append(("program_control", traffic["control_args"]))
    for label, extra in runs:
        t = time.perf_counter()
        tr = dict(traffic, args=dict(traffic.get("args", {}), **extra))
        st = entry.setup(sec, tr, device)
        entry.call(st)
        outs[label] = entry.outputs(st, smp)
        del st
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        rec[f"{label}_s"] = time.perf_counter() - t
    t = time.perf_counter()
    exp = ref.expected(sec, traffic, seed, smp)
    outs["control"] = ref.expected(sec, traffic, seed, smp, lower=True)
    rec["reference_s"] = time.perf_counter() - t
    for label, out in outs.items():
        rec[label] = ref.readings(out, exp, sec, smp, traffic)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    from spatialcore_tpu_torch.kernels import build

    build.load_library()
    for s in args.seeds.split(","):
        rec = readings_for(ROOT, args.workload, int(s), bool(args.program))
        print(json.dumps(rec))
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
