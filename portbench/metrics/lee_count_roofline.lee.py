"""The Lee draw step's share of its roofline (K7's lee tail, counting
instances only: the template instance whose first argument is the Lee
statistic and whose counting flag is set): the least time of one launch
from ``work/lee_count.py`` at the problem's sizes, over the profiler's mean
device time per launch."""

import re

from portbench.work import lee_count

#: ``lisa_kernel<STAT, FAR, COUNT, ...>`` with STAT 4 (Lee) and COUNT true
LEE_COUNT = re.compile(r"lisa_kernel<4,\s*\d+,\s*true,")


def read(ctx):
    s = ctx.get("trace")
    times = [t for k, v in (s or {}).get("kernels", {}).items()
             if LEE_COUNT.search(k) for t in v]
    if not times:
        return None
    least = lee_count.seconds(ctx["n_cells"], ctx["k"],
                              ctx["traffic"]["kernel_genes"],
                              ctx["traffic"].get("counter_bytes", 1))
    return 100.0 * least / (sum(times) / len(times))
