"""Median host microseconds of the program's `results` layer span (track
`layer`) a dispatch of the prepared sequence, one span of two entries:
the allocation of a fresh result for each step run in place, before the
replay (SequenceGraph.allocate), and the clone of each result left in
the graph's pool, after it (SequenceGraph.results; none where every step
runs in place). The spans exist while the program's tracer collects; a
program without them reads nothing."""

import statistics


def read(ctx):
    durs = [ev["dur_ns"] for ev in ctx.spans
            if ev.get("track") == "layer" and ev.get("name") == "results"]
    return statistics.median(durs) / 1e3 if durs else None
