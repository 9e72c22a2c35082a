"""Share of the traced draws' window in which no kernel, copy or set ran
on the device: 100 * (1 - union of device activity / window)."""


def read(ctx):
    s = ctx.get("trace")
    if not s or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
