"""Device milliseconds a draw of the float global null's far-edge and
degree-term kernel (``kernels.global_terms``): the summed device time of
the ``global_terms_kernel`` launches in the traced stretch over its draws
(one launch a draw and gene tile where the null runs it)."""


def read(ctx):
    s = ctx.get("trace")
    times = [t for k, v in (s or {}).get("kernels", {}).items()
             if "global_terms_kernel" in k for t in v]
    if not times or not s.get("steps"):
        return None
    return 1e3 * sum(times) / s["steps"]
