"""Median host microseconds of the program's `load` layer span (track
`layer`) a dispatch of the prepared sequence (SequenceGraph.load): the
host building the rows of the graph's address table and enqueuing their
one pinned host-to-device write, plus the copy of each buffer that a
staged step reads into the graph's static inputs (none where every step
runs in place). The spans exist while the program's tracer collects; a
program without them reads nothing."""

import statistics


def read(ctx):
    durs = [ev["dur_ns"] for ev in ctx.spans
            if ev.get("track") == "layer" and ev.get("name") == "load"]
    return statistics.median(durs) / 1e3 if durs else None
