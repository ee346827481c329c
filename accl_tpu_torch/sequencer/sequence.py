"""Operand widths of a call's steps.

Counterpart of the width rules of accl_tpu/sequencer/sequence.py (the
rest of that module, call sequences, is a later slice of the port). One
source for the device's launch and, later, a sequence's data flow.
"""

from __future__ import annotations

from ..constants import Operation

# ops that read `count * world` elements per rank (stacked chunk inputs)
_WIDE_IN = (Operation.scatter, Operation.reduce_scatter, Operation.alltoall)
# ops whose per-rank result is `count * world` elements
_WIDE_OUT = (Operation.gather, Operation.allgather, Operation.alltoall)


def step_in_elems(options, world: int) -> int:
    return options.count * world if options.scenario in _WIDE_IN \
        else options.count


def step_out_elems(options, world: int) -> int:
    return options.count * world if options.scenario in _WIDE_OUT \
        else options.count
