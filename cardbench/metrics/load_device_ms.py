"""Median device milliseconds of the program's `load` layer span (track
`layer`, args `device_ns`): the CUDA event pair from before the load
(before the host builds the address table's rows) to the replay's start,
read at the request's completion. It holds the table's pinned write and
any staged copies, and the card's wait for the host while it builds the
rows. Off the card, and in a program without the span, it reads
nothing."""

import statistics


def read(ctx):
    ns = [ev["args"]["device_ns"] for ev in ctx.spans
          if ev.get("track") == "layer" and ev.get("name") == "load"
          and "device_ns" in ev.get("args", {})]
    return statistics.median(ns) / 1e6 if ns else None
