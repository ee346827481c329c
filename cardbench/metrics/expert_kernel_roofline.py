"""The grouped SwiGLU expert kernel's share of its roofline, in %: the
least time of the traced steps' expert work (cardbench/moe_yardstick.py:
the larger of its bytes over 3.35 TB/s and its flops over 67 TFLOP/s of
FP32, from the program's routing counters) over the device time of
every `moe_expert_gemm_kernel` in the trace. Nothing when the kernel or
the counters are absent."""

from cardbench import moe_yardstick as my

KERNEL = "moe_expert_gemm_kernel"


def read(ctx):
    c = my.per_step(ctx.spans)
    if ctx.trace is None or c is None:
        return None
    seconds, count = ctx.trace.kernel_seconds(KERNEL)
    if not count or seconds <= 0:
        return None
    hidden, width = my.widths(ctx.config, ctx.shrink)
    least = ctx.trace.steps * my.expert_least_s(c, hidden, width)
    return 100.0 * least / seconds
