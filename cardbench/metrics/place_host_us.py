"""Median host microseconds of the program's `place` layer span (track
`layer`) a dispatch of the prepared sequence: placing each result into
its buffer at the request's completion (GPUDevice._place), inside
ACCL.wait. The spans exist while the program's tracer collects; a
program without them reads nothing."""

import statistics


def read(ctx):
    durs = [ev["dur_ns"] for ev in ctx.spans
            if ev.get("track") == "layer" and ev.get("name") == "place"]
    return statistics.median(durs) / 1e3 if durs else None
