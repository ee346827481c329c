"""Median device milliseconds of one graph replay: the CUDA event pair
the program records around the replay (its SequenceRequest's
duration). The copies into the graph's inputs and the clones of its
results lie outside the pair."""

import statistics


def read(ctx):
    return statistics.median(ctx.replay_ns) / 1e6 if ctx.replay_ns else None
