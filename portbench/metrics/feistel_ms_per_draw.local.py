"""Host milliseconds of the Feistel row stream a draw
(``ops.banded.feistel_apply``, one call a draw and gene tile), over the
traced run's draws outside the profiled stretch: each timed from a
drained device to the stream's last read-back (``harness/trace.py``)."""


def read(ctx):
    t = ctx.get("tracer")
    if t is None or t.calls == 0:
        return None
    return 1e3 * t.host_s / t.calls
