"""The benchmark's frozen arithmetic: bytes, bus bandwidth, rooflines,
the tail percentile.

Nothing here reads the program. A change to accl_tpu_torch cannot move
these numbers; only a benchmark change can.

- Peak: one NVIDIA H100 SXM, 3.35 TB/s of HBM3 (the data sheet), the
  rate every roofline share here is taken against.
- An allreduce of n elements of b bytes on each of W ranks needs at
  least 2*W*n*b bytes of device traffic on one card: every rank's
  operand read once and every rank's result written once.
- Bus bandwidth is nccl-tests' definition for allreduce:
  busbw = 2*(W-1)/W * n*b / t.
- A tail is the inclusive 95th percentile of every step in the window.
"""

from __future__ import annotations

import statistics

HBM_BYTES_PER_S = 3.35e12
GIB = float(1 << 30)


def allreduce_bytes(world: int, count: int, elem_bytes: int) -> int:
    """Least device bytes of one allreduce on one card."""
    return 2 * world * count * elem_bytes


def allreduce_bus_bytes(world: int, count: int, elem_bytes: int) -> float:
    """The numerator of nccl-tests' allreduce bus bandwidth."""
    return 2.0 * (world - 1) / world * count * elem_bytes


def step_bytes(world: int, counts: list[int], elem_bytes: int) -> int:
    return sum(allreduce_bytes(world, n, elem_bytes) for n in counts)


def step_bus_bytes(world: int, counts: list[int], elem_bytes: int) -> float:
    return sum(allreduce_bus_bytes(world, n, elem_bytes) for n in counts)


def roofline_pct(nbytes: float, seconds: float) -> float | None:
    """Share of the HBM roofline, in %: the least time `nbytes` can
    take at the peak rate over the time they took. None when nothing
    was timed."""
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / seconds


def p95(values: list[float]) -> float:
    """95th percentile, inclusive method (statistics.quantiles)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]
