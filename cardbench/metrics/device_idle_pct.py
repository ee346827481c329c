"""Share of the traced window, in %, in which no kernel, copy or fill
ran on the card (the profiler's device timeline)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0 or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
