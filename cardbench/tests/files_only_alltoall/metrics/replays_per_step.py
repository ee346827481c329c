"""Graph replays a step of the files-only alltoall test cell."""


def read(ctx):
    return ctx.replays / ctx.steps if ctx.steps else None
