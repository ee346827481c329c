"""Elements a step of the files-only alltoall test cell sends from one
rank to another: every slot but each rank's own, from the
configuration's world and the step's (shrunk) buffers."""


def read(ctx):
    world = ctx.config["deployment"]["world"]
    return sum(n * (world - 1) for n in ctx.counts)
