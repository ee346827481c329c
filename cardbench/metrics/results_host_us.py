"""Median host microseconds of the program's `results` layer span (track
`layer`) a dispatch of the prepared sequence: the clones of the written
buffers out of the graph's pool (SequenceGraph.results), enqueued. The
spans exist while the program's tracer collects; a program without them
reads nothing."""

import statistics


def read(ctx):
    durs = [ev["dur_ns"] for ev in ctx.spans
            if ev.get("track") == "layer" and ev.get("name") == "results"]
    return statistics.median(durs) / 1e3 if durs else None
