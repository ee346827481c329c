"""Median host microseconds of a facade span: `ACCL._execute`'s `call`
span of each eager call, or `SequenceProgram.run`'s `sequence` span of
each replay, as the program's tracer records them (track `facade`). The
cells dispatch asynchronously, so a span covers the host's work for the
call and closes at dispatch."""

import statistics


def read(ctx):
    durs = [ev["dur_ns"] for ev in ctx.spans if ev.get("track") == "facade"]
    return statistics.median(durs) / 1e3 if durs else None
