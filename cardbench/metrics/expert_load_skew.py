"""How unevenly a step loads the held experts: each layer's hottest held
expert's rows, summed over the layers (`moe_rows_max`), over the mean
rows a held expert computes times the layers (`moe_rows` over the held
experts), from the program's routing counters; the mean over the
window's steps. 1 is an even load."""

from cardbench import moe_yardstick as my


def read(ctx):
    c = my.per_step(ctx.spans)
    if c is None or not c["moe_rows"]:
        return None
    held = ctx.config["deployment"]["held_experts"]
    return c["moe_rows_max"] * held / c["moe_rows"]
