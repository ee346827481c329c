"""Median host microseconds of the program's `bind` layer span (track
`layer`) a dispatch of the prepared sequence: the buffers' current
device images gathered for the copy-in (GPUDevice._bound_tensors). The
spans exist while the program's tracer collects; a program without them
reads nothing."""

import statistics


def read(ctx):
    durs = [ev["dur_ns"] for ev in ctx.spans
            if ev.get("track") == "layer" and ev.get("name") == "bind"]
    return statistics.median(durs) / 1e3 if durs else None
