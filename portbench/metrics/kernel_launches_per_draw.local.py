"""Device kernels in the traced window divided by the draws traced."""


def read(ctx):
    s = ctx.get("trace")
    if not s or not s["steps"]:
        return None
    return s["n_kernels"] / s["steps"]
