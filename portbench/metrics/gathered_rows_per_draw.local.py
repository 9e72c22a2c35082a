"""Value-table rows the program's draw loop writes a draw: its counter
``ops.banded.gather_rows`` (the rows of every row gather ``table[rows]``
and far gather it makes, sizes known on the host) over ``draws``, over
the whole process (``spatialcore_tpu_torch.utils.profiling.counters``).
0 where the draw steps read the table through the draw's rows and copy
nothing first. None where the program keeps no such counter."""


def read(ctx):
    try:
        from spatialcore_tpu_torch.utils import profiling
    except ImportError:
        return None
    counters = getattr(profiling, "counters", None)
    c = counters() if counters is not None else {}
    draws, rows = c.get("draws"), c.get("ops.banded.gather_rows")
    if not draws or rows is None:
        return None
    return rows / draws
