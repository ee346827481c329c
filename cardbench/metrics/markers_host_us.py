"""Median host microseconds of the program's `markers` layer span (track
`layer`) a dispatch of the prepared sequence: the per-step instant
markers of the always-on layer, one a recorded call, each with its
timing.predict estimate, after the replay is enqueued. The spans exist
while the program's tracer collects; a program without them reads
nothing."""

import statistics


def read(ctx):
    durs = [ev["dur_ns"] for ev in ctx.spans
            if ev.get("track") == "layer" and ev.get("name") == "markers"]
    return statistics.median(durs) / 1e3 if durs else None
