"""Device copies a step of the prepared sequence: the `copies` of its
dispatch's `load` (into the graph's inputs) and `results` (out of its
pool) layer spans, summed per dispatch (the two name the same `dispatch`
span as their cause), the median over the window's dispatches, so that
a span the ring dropped cannot bias it. A program without the spans
reads nothing."""

import statistics
from collections import defaultdict


def read(ctx):
    per = defaultdict(int)
    for ev in ctx.spans:
        args = ev.get("args", {})
        if (ev.get("track") == "layer"
                and ev.get("name") in ("load", "results")
                and "copies" in args):
            per[(args.get("parent"), args.get("parent_ts_ns"))] += \
                args["copies"]
    return statistics.median(per.values()) if per else None
