"""Share of the null plan's neighbour slots that hold no edge:
100 * (1 - ``plan.live_slots`` / ``plan.slots``), the program's counters
of the last plan built (a radius graph's slots past a cell's degree, up to
its cap). None where the program keeps no plan counters."""


def read(ctx):
    try:
        from spatialcore_tpu_torch.utils import profiling
    except ImportError:
        return None
    counters = getattr(profiling, "counters", None)
    c = counters() if counters is not None else {}
    slots, live = c.get("plan.slots"), c.get("plan.live_slots")
    if not slots or live is None:
        return None
    return 100.0 * (1.0 - live / slots)
