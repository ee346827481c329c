"""Rows a step's slot-driven exchange moves from one rank to another,
dispatch and combine together (the program's `moe_moved_rows` counter,
read back after each traced step), the mean over the window's steps."""

from cardbench import moe_yardstick as my


def read(ctx):
    c = my.per_step(ctx.spans)
    return None if c is None else c["moe_moved_rows"]
