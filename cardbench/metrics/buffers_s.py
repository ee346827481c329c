"""Seconds of the set-up spent in the program's `ACCL.create_buffer` for
the cell's send and receive buffers (each zero-fills a host mirror and
copies it to the card), on the host clock."""


def read(ctx):
    return ctx.phases.get("buffers")
