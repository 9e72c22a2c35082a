"""Host milliseconds a draw spends blocked on the card: the mean total
``wait_ns`` (its own read-backs and its descendants') of the program's
``draw`` spans recorded in the traced run's first stretch, the first
``tracer.active`` of them by start time
(``spatialcore_tpu_torch.utils.profiling.spans``; spans record while the
profiler does). None where the program records no ``draw`` span."""


def read(ctx):
    t = ctx.get("tracer")
    try:
        from spatialcore_tpu_torch.utils import profiling
    except ImportError:
        return None
    spans = getattr(profiling, "spans", None)
    if t is None or spans is None:
        return None
    draws = sorted((s for s in spans() if s["name"] == "draw"
                    and s["end_ns"] is not None),
                   key=lambda s: s["start_ns"])[:t.active]
    if not draws:
        return None
    return 1e-6 * sum(s["total_wait_ns"] for s in draws) / len(draws)
