"""The whole step's share of the HBM roofline, in %: the collective's
own bytes (2*W*n*b a call, whatever kernels do the work) at 3.35 TB/s,
over the window's wall time."""

from cardbench.yardstick import roofline_pct


def read(ctx):
    if not ctx.steps:
        return None
    return roofline_pct(ctx.steps * ctx.step_bytes, ctx.window_s)
