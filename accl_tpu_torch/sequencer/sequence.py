"""Call sequences: one prepared program per recorded descriptor batch.

Counterpart of accl_tpu/sequencer/sequence.py. A SequencePlan resolves a
recorded batch of call descriptors (SequenceDescriptor) against per-step
Plans and composes the same schedule bodies the per-call path runs into
one callable over the batch's buffer table. On the card that callable is
captured once as a CUDA graph (sequencer/lowering.SequenceGraph), so a
dispatch of the whole chain is one graph replay; on the CPU it runs
eagerly.

Dataflow: every buffer the batch references is an input (one per unique
address, full buffer width); an environment threads each step's result
to later operands by address, as chained eager calls with
from_device/to_device would see it, so a recorded sequence is bitwise
the same as the same calls issued eagerly. The reference orders its
slot-keyed Pallas ring steps with explicit barriers; here one CUDA
stream runs the steps in order, so no such edge is needed.

Placement (`SequencePlan.placement`): in a captured graph on the default
world, a step whose body is kernel 1 on the exact wire reads its operand
where it lies and writes a fresh result through the kernel's indirect
entry, and only the buffers a staged step reads are copied into the
graph; lowering.SequenceGraph carries it out.

The width rules (`step_in_elems`, `step_out_elems`) are shared with the
device's per-call launch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..constants import Operation
from ..descriptor import SequenceDescriptor

# ops that read `count * world` elements per rank (stacked chunk inputs)
_WIDE_IN = (Operation.scatter, Operation.reduce_scatter, Operation.alltoall)
# ops whose per-rank result is `count * world` elements
_WIDE_OUT = (Operation.gather, Operation.allgather, Operation.alltoall)

# the descriptor kinds a sequence can carry: data-plane steps with static
# operand/result addresses. send/recv pair through the host and barrier
# carries no payload: none of them belongs in a data-flow program.
SEQUENCE_OPS = (
    Operation.copy,
    Operation.combine,
    Operation.bcast,
    Operation.scatter,
    Operation.gather,
    Operation.allgather,
    Operation.reduce,
    Operation.allreduce,
    Operation.reduce_scatter,
    Operation.alltoall,
)


def step_in_elems(options, world: int) -> int:
    layout = getattr(options, "row_layout", None)
    if layout is not None:  # a slot-driven alltoallv: rows of `count`
        return options.count * layout.in_rows
    return options.count * world if options.scenario in _WIDE_IN \
        else options.count


def step_out_elems(options, world: int) -> int:
    layout = getattr(options, "row_layout", None)
    if layout is not None:
        return options.count * layout.out_rows
    return options.count * world if options.scenario in _WIDE_OUT \
        else options.count


def step_accesses(
    options: Any, world: int
) -> tuple[list[tuple[int, int]], list[tuple[int, int]]]:
    """(reads, writes) of one step as (address, prefix elems) pairs: the
    access model the hazard pass reasons over (every sequence-able op
    touches a prefix region at offset 0; the wide in/out rule above is
    the only width variation)."""
    reads: list[tuple[int, int]] = []
    if options.addr_0:
        reads.append((options.addr_0, step_in_elems(options, world)))
    if options.addr_1:
        reads.append((options.addr_1, options.count))
    writes: list[tuple[int, int]] = []
    if options.addr_2:
        writes.append((options.addr_2, step_out_elems(options, world)))
    return reads, writes


def slice_to(t: torch.Tensor, n: int) -> torch.Tensor:
    """A step's operand: the first n elements of every rank's buffer."""
    return t if t.shape[-1] == n else t[..., :n]


def place_into(dst: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """A step's result written into its (possibly wider) result buffer: a
    full-width result replaces the buffer's value, a partial-width one
    writes a prefix of a copy and keeps the tail."""
    if dst.shape == out.shape:
        return out
    dst = dst.clone()
    dst[..., : out.shape[-1]] = out.to(dst.dtype)
    return dst


@dataclasses.dataclass(frozen=True)
class InPlaceStep:
    """A step a captured graph runs as kernel-1 launches through the
    kernel's indirect entry (SequencePlan.placement): `n` columns of
    `dtype` folded as `ring` (lowering.RingGeometry) cuts them. `source`
    is where its operand lies at a dispatch: ("bound", buffer), the bound
    tensor itself; ("fresh", step) or ("kept", step), an earlier in-place
    step's result. `fresh`: its result is a tensor allocated for each
    dispatch; else the graph keeps it in memory of its own, for a staged
    step that reads it."""

    step: int
    ring: Any
    n: int
    dtype: torch.dtype
    source: tuple[str, int]
    fresh: bool


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a captured graph reads and writes (SequencePlan.placement):
    `steps`, the in-place steps in batch order; `loaded[i]`, whether
    buffer i is copied into a static input at each dispatch (a staged
    step reads its bound value); `finals[k]`, the step whose result is
    output k of the batch."""

    steps: tuple[InPlaceStep, ...]
    loaded: tuple[bool, ...]
    finals: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class _Step:
    """One lowered stage: its descriptor and plan plus the resolved
    dataflow (buffer-table indices and static element counts)."""

    options: Any  # CallOptions
    plan: Any  # Plan
    in_idx: tuple[int, ...]
    res_idx: int
    in_elems: int
    out_elems: int
    producer: Callable | None
    consumer: Callable | None


class SequencePlan:
    """The lowered form of a recorded descriptor batch.

    Construction resolves the batch's dataflow (which addresses feed
    which steps) against per-step Plans; `build()` composes the per-step
    schedule bodies into one callable over the buffer table, and
    `cache_key()` is the composite signature the ScheduleCompiler caches
    it under, beside its per-call entries.
    """

    def __init__(
        self,
        descriptor: SequenceDescriptor,
        plans: list,
        world: int,
        endpoints: list[tuple[Callable | None, Callable | None]] | None = None,
    ):
        if len(plans) != len(descriptor.steps):
            raise ValueError("one Plan per descriptor step required")
        if endpoints is None:
            endpoints = [(None, None)] * len(descriptor.steps)
        self.descriptor = descriptor
        self.world = world
        addr_order: dict[int, int] = {}

        def idx(addr: int) -> int:
            return addr_order.setdefault(addr, len(addr_order))

        steps: list[_Step] = []
        written: list[int] = []
        for opts, plan, (prod, cons) in zip(descriptor.steps, plans,
                                            endpoints):
            if opts.scenario not in SEQUENCE_OPS:
                raise ValueError(
                    f"{opts.scenario.name} cannot ride a call sequence "
                    "(host-paired or payload-free descriptor)")
            if opts.addr_0 == 0 or opts.addr_2 == 0:
                raise ValueError(
                    f"sequence step {opts.scenario.name} needs operand and "
                    "result buffers")
            in_idx = [idx(opts.addr_0)]
            if opts.scenario == Operation.combine:
                if opts.addr_1 == 0:
                    raise ValueError("combine step needs a second operand")
                in_idx.append(idx(opts.addr_1))
            res_idx = idx(opts.addr_2)
            if res_idx not in written:
                written.append(res_idx)
            steps.append(_Step(
                options=opts,
                plan=plan,
                in_idx=tuple(in_idx),
                res_idx=res_idx,
                in_elems=step_in_elems(opts, world),
                out_elems=step_out_elems(opts, world),
                producer=prod,
                consumer=cons,
            ))
        self.steps = tuple(steps)
        # buffer table: unique addresses in first-appearance order (the
        # same canonical order descriptor.signature() renames by)
        self.buffer_addrs = tuple(addr_order)
        # program outputs: every written buffer, in first-write order
        self.out_idx = tuple(written)
        self.out_addrs = tuple(self.buffer_addrs[i] for i in written)

    def min_widths(self) -> dict[int, int]:
        """Per-address minimum buffer width (elements) the batch needs:
        prepare-time validation against the registered buffers."""
        need: dict[int, int] = {}
        for st in self.steps:
            for i in st.in_idx:
                a = self.buffer_addrs[i]
                need[a] = max(need.get(a, 0), st.in_elems)
            a = self.buffer_addrs[st.res_idx]
            need[a] = max(need.get(a, 0), st.out_elems)
        return need

    def cache_key(self, use_ring_kernel: bool) -> tuple:
        # endpoint callables ride the key by identity, with strong refs
        # held, so a re-registered endpoint never meets a stale program
        eps = tuple((st.producer, st.consumer) for st in self.steps)
        return (
            self.descriptor.signature(),
            tuple(st.plan for st in self.steps),
            eps,
            use_ring_kernel,
        )

    def placement(self, compiler, layout) -> Placement:
        """Which steps a captured graph runs in place and which buffers it
        must load, from what the batch shows: pure Python over the steps,
        their plans and `layout`, the (width, dtype) of each buffer of
        the table. The caller decides where a placement applies (the
        default world, a captured graph).

        A step runs in place when the body `compiler.lower_step` built for
        it is kernel 1 on the exact wire (it carries its launches as
        `ring`, lowering.RingGeometry), it has no stream endpoint, its
        result is full width (so `place_into` hands the result itself
        on), and its operand is the bound value of a buffer or an earlier
        in-place step's result. Its result is fresh unless a staged step
        reads it. A buffer is loaded when a staged step reads its bound
        value; a partial-width write reads the value it keeps the tail
        of."""
        version: list[int | None] = [None] * len(self.buffer_addrs)
        reads = []  # per step: (buffer, the step it holds the result of)
        readers: dict[int, list[int]] = {}
        placed: dict[int, InPlaceStep] = {}
        for s, st in enumerate(self.steps):
            width = layout[st.res_idx][0]
            read = [(i, version[i]) for i in st.in_idx]
            ring = None
            if (st.producer is None and st.consumer is None
                    and st.out_elems == width):
                ring = getattr(compiler.lower_step(st.options, st.plan),
                               "ring", None)
            if ring is not None:
                (i, v), = read
                # the kernel runs in its operand's dtype, as the body does
                dtype = layout[i][1] if v is None else (
                    placed[v].dtype if v in placed else None)
                if dtype is not None:
                    placed[s] = InPlaceStep(
                        step=s, ring=ring, n=st.in_elems, dtype=dtype,
                        source=("bound", i) if v is None else ("fresh", v),
                        fresh=True)
            if s not in placed and st.out_elems < width:
                read.append((st.res_idx, version[st.res_idx]))
            reads.append(read)
            for _, v in read:
                if v is not None:
                    readers.setdefault(v, []).append(s)
            version[st.res_idx] = s
        kept = {s for s in placed
                if any(r not in placed for r in readers.get(s, ()))}
        steps = tuple(dataclasses.replace(
            p, fresh=p.step not in kept,
            source=("kept", p.source[1]) if p.source[0] == "fresh"
            and p.source[1] in kept else p.source)
            for p in placed.values())
        loaded = [False] * len(self.buffer_addrs)
        for s, read in enumerate(reads):
            if s not in placed:
                for i, v in read:
                    loaded[i] = loaded[i] or v is None
        return Placement(steps, tuple(loaded),
                         tuple(version[i] for i in self.out_idx))

    # -- construction ------------------------------------------------------

    def build(self, compiler) -> Callable:
        """Compose the per-step schedule bodies into one callable:
        (stacked buffer tensors...) -> (written buffer tensors...). Each
        step runs the very closure the per-call path caches for its
        descriptor (ScheduleCompiler.lower_step / lower_streamed)."""
        bodies = []
        for st in self.steps:
            if st.producer is None and st.consumer is None:
                bodies.append(compiler.lower_step(st.options, st.plan))
            else:
                bodies.append(compiler.lower_streamed(
                    st.options, st.plan, st.producer, st.consumer))
        steps = self.steps
        out_idx = self.out_idx

        def fused(*bufs, table=None):
            # `table`: the launch of each in-place step, by step index
            # (SequenceGraph): it takes the operand and returns what the
            # result buffer holds after it
            env = list(bufs)
            for s, (st, body) in enumerate(zip(steps, bodies)):
                run = table.get(s) if table else None
                if run is not None:
                    env[st.res_idx] = run(slice_to(env[st.in_idx[0]],
                                                   st.in_elems))
                    continue
                out = body(*(slice_to(env[i], st.in_elems)
                             for i in st.in_idx))
                env[st.res_idx] = place_into(env[st.res_idx], out)
            return tuple(env[i] for i in out_idx)

        return fused
