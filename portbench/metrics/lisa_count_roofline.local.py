"""The local draw step's share of its roofline (K7's moran tail, counting
instances only): the least time of one launch from
``work/lisa_count.py`` at the problem's sizes, over the profiler's mean
device time per launch."""

from portbench.work import lisa_count


def read(ctx):
    s = ctx.get("trace")
    times = [t for k, v in (s or {}).get("kernels", {}).items()
             if "lisa_kernel<" in k and ", true," in k for t in v]
    if not times:
        return None
    least = lisa_count.seconds(ctx["n_cells"], ctx["k"],
                               ctx["traffic"]["kernel_genes"],
                               ctx["traffic"].get("counter_bytes", 1))
    return 100.0 * least / (sum(times) / len(times))
