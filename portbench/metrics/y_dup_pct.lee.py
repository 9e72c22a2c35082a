"""Share of the Lee pair columns whose y gene repeats one already in its
set of pair columns (a tile of the compact route, the whole call
otherwise): 100 * (1 - ``lee.y_genes`` / ``lee.pairs``), the program's
counters over the whole process. Each such column is gathered again every
draw. None where the program keeps no such counters."""


def read(ctx):
    try:
        from spatialcore_tpu_torch.utils import profiling
    except ImportError:
        return None
    counters = getattr(profiling, "counters", None)
    c = counters() if counters is not None else {}
    pairs, y = c.get("lee.pairs"), c.get("lee.y_genes")
    if not pairs or y is None:
        return None
    return 100.0 * (1.0 - y / pairs)
