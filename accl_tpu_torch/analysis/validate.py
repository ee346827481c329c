"""Per-descriptor validation: the linter's ACCL4xx structural checks.

Counterpart of accl_tpu/analysis/validate.py. The facade's `_prepare`
raises typed errors (errors.py) for calls built through the driver API;
descriptors can also enter as raw word streams
(`SequenceDescriptor.from_words`) that no facade saw. This pass
re-derives every host-side precondition from the descriptor alone, so
both entry paths are gated alike; each check names the typed error that
guards the same invariant at call time.
"""

from __future__ import annotations

from ..constants import DataType, Operation
from ..sequencer.sequence import SEQUENCE_OPS
from .diagnostics import Diagnostic, make

# ops whose root_src_dst is a single communicator-relative root
_ROOTED = (Operation.bcast, Operation.scatter, Operation.gather,
           Operation.reduce)
# ops that move payload and therefore need a positive count and a dtype
_DATA = SEQUENCE_OPS + (Operation.send, Operation.recv)


def validate_steps(steps, world: int, *,
                   sequence: bool = True) -> list[Diagnostic]:
    """Structural checks over a batch of CallOptions. `sequence=True`
    additionally enforces the fused-batch contract (one communicator,
    sequenceable kinds, operand/result buffers present)."""
    diags: list[Diagnostic] = []
    steps = list(steps)
    if sequence and steps:
        comm = steps[0].comm_addr
        for k, opts in enumerate(steps):
            if opts.comm_addr != comm:
                diags.append(make(
                    "ACCL403",
                    f"step {k} addresses communicator "
                    f"{opts.comm_addr:#x} but the batch opened on "
                    f"{comm:#x}", step=k))
    for k, opts in enumerate(steps):
        scen = opts.scenario
        if sequence and scen not in SEQUENCE_OPS:
            diags.append(make(
                "ACCL404",
                f"{scen.name} cannot ride a call sequence (host-paired "
                "or payload-free descriptor)", step=k))
            continue
        if scen in _DATA:
            if opts.count <= 0:
                # host-side twin: errors.ZeroLengthBufferError
                diags.append(make(
                    "ACCL401",
                    f"{scen.name} with count {opts.count}: zero-length "
                    "payloads compile shape-degenerate schedules",
                    step=k))
            if opts.data_type == DataType.none:
                diags.append(make(
                    "ACCL401",
                    f"{scen.name} carries no payload dtype", step=k))
        if scen in _ROOTED and not 0 <= opts.root_src_dst < world:
            # host-side twin: errors.InvalidRootError
            diags.append(make(
                "ACCL402",
                f"{scen.name} root {opts.root_src_dst} outside "
                f"communicator of {world}", step=k))
        if scen in (Operation.send, Operation.recv):
            src = opts.root_src_dst & 0xFFFF
            dst = (opts.root_src_dst >> 16) & 0xFFFF
            if src >= world or dst >= world:
                diags.append(make(
                    "ACCL402",
                    f"{scen.name} src/dst ({src},{dst}) outside "
                    f"communicator of {world}", step=k))
        if sequence and scen in SEQUENCE_OPS:
            if opts.addr_0 == 0 or opts.addr_2 == 0:
                diags.append(make(
                    "ACCL401",
                    f"sequence step {scen.name} needs operand and "
                    "result buffers", step=k))
            if scen == Operation.combine and opts.addr_1 == 0:
                diags.append(make(
                    "ACCL401",
                    "combine step needs a second operand", step=k))
    return diags
