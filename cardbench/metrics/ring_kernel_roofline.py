"""Kernel 1's share of its HBM roofline, in %: the bytes of every
allreduce the traced steps made (2*W*n*b a call: kernel 1 carries all of
an exact-wire call on these cells) at 3.35 TB/s, over the device time of
every `ring_allreduce_kernel` in the trace. Nothing when the kernel is
not in the trace."""

from cardbench.yardstick import roofline_pct

KERNEL = "ring_allreduce_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    seconds, count = ctx.trace.kernel_seconds(KERNEL)
    if not count:
        return None
    return roofline_pct(ctx.trace.steps * ctx.step_bytes, seconds)
