"""Host-side launches a step: the sum over the program's kernel wrappers
of their `launches` counters' growth over the window, plus one for each
graph replay (a captured graph's kernels tick no counter at replay),
over the steps of the window."""


def read(ctx):
    if not ctx.steps:
        return None
    return (ctx.launches + ctx.replays) / ctx.steps
