"""Run one cell of the benchmark of spatialcore_tpu_torch once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. Set-up builds
(or loads) the kernels, makes the cell's section on the card from the
seed, and lets the entry build its graph and warm up; the window then
calls the entry back to back, starting a call only while the window is
under ``--seconds``, and ends when the last call has finished. Afterwards
the reference judges the last call's answers, and the last line of
standard output is one JSON object: ``correct``, ``attempted`` (calls),
``failed`` (calls that raised: a call that raises ends the run), the
metrics (``--trace 0``: the cell's end-to-end metrics; ``--trace 1``:
its per-layer metrics), the device, a ``breakdown`` of the traced run,
and, last, ``checks``: each number compared with its limit, which also
end standard error.

Without a CUDA card, or with fewer than the cell asks for, or where the
program package is not this checkout's, the run fails and prints no
result; so does a run after which ``jax``, ``jaxlib``, ``flax`` or the
JAX package is loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "spatialcore_tpu")
PROGRAM = "spatialcore_tpu_torch"


def loaded_forbidden() -> list:
    """Modules loaded whose whole top-level name is forbidden (the port's
    own name begins with the JAX package's, so names are compared whole)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return code


def main(argv=None, *, device=None, root: Path = ROOT) -> int:
    """Run a cell; ``device`` other than None skips the look for a card
    (the CPU tests drive a whole run at a tiny size this way)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    from portbench.entries._public import sync
    from portbench.harness import spec
    from portbench.harness import section as section_mod

    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, args.workload)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return _fail("no CUDA device: this benchmark runs on the card only", 2)
        if torch.cuda.device_count() < int(cell["chips"]):
            return _fail(f"the cell asks for {cell['chips']} cards, "
                         f"{torch.cuda.device_count()} present", 2)
        device = "cuda"
        try:
            import spatialcore_tpu_torch as program
        except ImportError as e:
            return _fail(f"the program does not import: {e}", 3)
        if not Path(program.__file__).resolve().is_relative_to(
                Path(root).resolve()):
            return _fail(f"{PROGRAM} imports from {program.__file__}, not "
                         f"from this checkout", 3)
    torch.set_num_threads(4)
    if torch.device(device).type == "cuda":
        from spatialcore_tpu_torch.kernels import build

        build.load_library()             # nvcc on a checkout's first run
    cfg = spec.config(root, bench, cell["config"])
    traffic = spec.traffic(root, cell["traffic"])
    entry = spec.entry(root, traffic["entry"])
    ref = spec.reference(root, traffic["entry"])

    sec = section_mod.make(cfg, args.seed, device)
    n_call = int(traffic.get("genes") or cfg["n_genes"])
    sec.update(k=int(cfg["n_neighbors"]), null_seed=args.seed & 0x7FFFFFFF,
               genes=list(range(n_call)))
    state = entry.setup(sec, traffic, device)
    sync(device)

    tracer = None
    if args.trace:
        from portbench.harness.trace import Tracer

        tracer = Tracer(**traffic.get("trace", {}))
        tracer.__enter__()
    calls = 0
    t_start = time.perf_counter()
    setup_s = t_start - T0
    try:
        while True:
            entry.call(state)
            sync(device)
            calls += 1
            if time.perf_counter() - t_start >= args.seconds:
                break
        window_s = time.perf_counter() - t_start
    finally:
        if tracer is not None:
            tracer.__exit__(None, None, None)
    peak = (torch.cuda.max_memory_allocated() if torch.device(device).type
            == "cuda" else 0)

    smp = ref.sample(int(cfg["n_cells"]), n_call, args.seed, traffic)
    out = entry.outputs(state, smp)
    work = {k: v * calls for k, v in entry.work(state).items()}
    spans = dict(state.get("spans", {}))
    del state
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    expected = ref.expected(sec, traffic, args.seed, smp)
    nums = ref.readings(out, expected, sec, smp, traffic)
    lim = spec.limits(root, cell["name"])
    # the cell's limits name the numbers it compares
    checks = {k: {"value": nums[k], "limit": v} for k, v in lim.items()
              if k in nums}
    missing = sorted(set(lim) - set(nums))
    correct = not missing and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    for c in checks.values():       # a reading that is no number fails
        if not math.isfinite(c["value"]):
            c["value"] = str(c["value"])

    ctx = {"setup_s": setup_s, "window_s": window_s, "work": work,
           "spans": spans, "tracer": tracer,
           "trace": tracer.summary if tracer is not None else None,
           "traffic": traffic, "config": cfg, "cell": cell,
           "n_cells": int(cfg["n_cells"]), "k": int(cfg["n_neighbors"])}
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(bench, cell["name"], kind):
        v = spec.metric_reader(root, m["name"]).read(ctx)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if torch.device(device).type == "cuda":
        dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                    "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    else:
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 0,
                    "memory_peak_bytes": 0}
    result = {"correct": bool(correct), "attempted": calls, "failed": 0,
              "metrics": metrics, "device": dev_info}
    if tracer is not None and tracer.summary:
        dev_info["busy_s"] = tracer.summary["busy_s"]
        dev_info["window_s"] = tracer.summary["window_s"]
        result["breakdown"] = tracer.breakdown or tracer.summary["breakdown"]
    result["checks"] = checks

    bad = loaded_forbidden()
    if bad:
        return _fail(f"loaded after the window: {', '.join(bad)}", 4)
    print(json.dumps(result))
    sys.stdout.flush()
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    if missing:
        print(f"check numbers without a reading: {missing}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
