"""The float local Moran draw step's share of its roofline: the least time
of one launch from ``work/lisa_float.py`` at the problem's sizes (the
traffic's genes, its null precision's table bytes, int16 counters up to
32,767 draws), over the profiler's mean device time per
``lisa_float_kernel`` launch."""

from portbench.work import lisa_float


def read(ctx):
    s = ctx.get("trace")
    times = [t for k, v in (s or {}).get("kernels", {}).items()
             if "lisa_float_kernel" in k for t in v]
    if not times:
        return None
    tr = ctx["traffic"]
    table = 2 if tr["precision"]["null"] == "bf16" else 4
    counter = 2 if int(tr["n_permutations"]) <= 32767 else 4
    least = lisa_float.seconds(ctx["n_cells"], ctx["k"], int(tr["genes"]), table,
                               counter)
    return 100.0 * least / (sum(times) / len(times))
