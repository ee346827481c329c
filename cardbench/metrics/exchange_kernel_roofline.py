"""The slot-driven row exchange's share of the HBM roofline, in %: the
bytes its dispatch and combine kernels move in the traced steps
(cardbench/moe_yardstick.py, from the program's routing counters) at
3.35 TB/s, over the device time of every `moe_dispatch_rows_kernel`
and `moe_combine_rows_kernel` in the trace. Nothing when the kernels or
the counters are absent."""

from cardbench import moe_yardstick as my
from cardbench.yardstick import roofline_pct

KERNELS = ("moe_dispatch_rows_kernel", "moe_combine_rows_kernel")


def read(ctx):
    c = my.per_step(ctx.spans)
    if ctx.trace is None or c is None:
        return None
    seconds = count = 0
    for name in KERNELS:
        s, n = ctx.trace.kernel_seconds(name)
        seconds, count = seconds + s, count + n
    if not count:
        return None
    hidden, _ = my.widths(ctx.config, ctx.shrink)
    world = ctx.config["deployment"]["world"]
    token_rows = world * sum(ctx.counts) // hidden
    return roofline_pct(
        ctx.trace.steps * my.exchange_bytes(c, hidden, token_rows), seconds)
