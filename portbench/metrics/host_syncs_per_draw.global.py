"""The program's read-backs and waits on the card a draw: its counter
``host_syncs`` over ``draws``, over the whole process, set-up and every
call (``spatialcore_tpu_torch.utils.profiling.counters``). None where the
program keeps no such counters."""


def read(ctx):
    try:
        from spatialcore_tpu_torch.utils import profiling
    except ImportError:
        return None
    counters = getattr(profiling, "counters", None)
    c = counters() if counters is not None else {}
    draws, syncs = c.get("draws"), c.get("host_syncs")
    if not draws or syncs is None:
        return None
    return syncs / draws
