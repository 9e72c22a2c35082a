"""Seconds of the set-up's kNN graph build: the harness's span around the
entry's graph call, synchronized (host clock)."""


def read(ctx):
    return ctx["spans"].get("graph_build_s")
