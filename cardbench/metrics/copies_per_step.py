"""Device copies a step of the prepared sequence: the `copies` of its
dispatch's `load` (buffers copied into the graph's static inputs; the
address table's write is none) and `results` (clones out of the graph's
pool; a fresh result written in place is none) layer spans, summed per
dispatch (the two name the same `dispatch` span as their cause), the
median over the window's dispatches, so that a span the ring dropped
cannot bias it. 0 where every step runs in place. A program without the
spans reads nothing."""

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
