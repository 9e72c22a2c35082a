"""Far edges of the null plan a cell: the program's counters
``plan.far_edges`` over ``plan.rows`` of the last plan built (edges that
leave a cell's three-block window and run as the torch-op far-edge terms
of every draw). None where the program keeps no plan counters."""


def read(ctx):
    try:
        from spatialcore_tpu_torch.utils import profiling
    except ImportError:
        return None
    counters = getattr(profiling, "counters", None)
    c = counters() if counters is not None else {}
    rows, far = c.get("plan.rows"), c.get("plan.far_edges")
    if not rows or far is None:
        return None
    return far / rows
