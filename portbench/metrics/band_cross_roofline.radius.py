"""The band cross's share of its roofline on a radius graph's plan (K4 for
a float null, K1-K3 for an integer one): the least time of one launch from
``work/band_cross.py`` at the plan's live mean degree (the program's
counters ``plan.live_slots`` over ``plan.rows``), over the profiler's mean
device time per launch of the kernel, matched by name. Only live edges
count as work, so the slots past a cell's degree show as lost share. None
where the program keeps no plan counters."""

from portbench.work import band_cross


def read(ctx):
    s = ctx.get("trace")
    prec = ctx["traffic"]["precision"]["null"]
    name = ("band_cross_int_kernel" if prec in ("int4", "int8")
            else "band_cross_float_kernel")
    times = [t for k, v in (s or {}).get("kernels", {}).items() if name in k
             for t in v]
    try:
        from spatialcore_tpu_torch.utils import profiling
    except ImportError:
        return None
    counters = getattr(profiling, "counters", None)
    c = counters() if counters is not None else {}
    rows, live = c.get("plan.rows"), c.get("plan.live_slots")
    if not times or not rows or live is None:
        return None
    least = band_cross.seconds(ctx["n_cells"], live / rows,
                               ctx["traffic"]["kernel_genes"], prec)
    return 100.0 * least / (sum(times) / len(times))
