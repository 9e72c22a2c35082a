"""The band cross's share of its roofline (K1-K3 for an integer null, K4
for a float one): the least time of one launch from ``work/band_cross.py``
at the problem's sizes, over the profiler's mean device time per launch of
the kernel, matched by name."""

from portbench.work import band_cross


def read(ctx):
    s = ctx.get("trace")
    prec = ctx["traffic"]["precision"]["null"]
    name = ("band_cross_int_kernel" if prec in ("int4", "int8")
            else "band_cross_float_kernel")
    times = [t for k, v in (s or {}).get("kernels", {}).items() if name in k
             for t in v]
    if not times:
        return None
    least = band_cross.seconds(ctx["n_cells"], ctx["k"],
                               ctx["traffic"]["kernel_genes"], prec)
    return 100.0 * least / (sum(times) / len(times))
