"""All the window's work in the entry's unit for ``local_cgpps``, divided by
the window's seconds (host clock, the last call synchronized)."""


def read(ctx):
    work = ctx["work"].get("local_cgpps")
    return None if work is None else work / ctx["window_s"]
