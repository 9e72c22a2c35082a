"""Cycle-walk passes of the Feistel row stream a draw: the program's
counter ``rng.feistel_passes`` (one a Feistel evaluation) over
``rng.feistel_calls`` (one a draw and gene tile), over the whole process
(``spatialcore_tpu_torch.utils.profiling.counters``). None where the
program keeps no such counters."""


def read(ctx):
    try:
        from spatialcore_tpu_torch.utils import profiling
    except ImportError:
        return None
    counters = getattr(profiling, "counters", None)
    c = counters() if counters is not None else {}
    calls, passes = c.get("rng.feistel_calls"), c.get("rng.feistel_passes")
    if not calls or passes is None:
        return None
    return passes / calls
