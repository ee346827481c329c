"""Lowering: call descriptor + plan -> a callable schedule body.

Counterpart of accl_tpu/sequencer/lowering.py. Where the reference
traces a schedule once per descriptor signature and compiles it with XLA
into one device program over the mesh, the port builds the schedule
closure once per signature and runs it eagerly on the stacked (world, n)
operands: row r is rank r's buffer. Every one-call collective, a paired
send/recv and alltoall(v) lower to the reference's schedule for their
plan; a SYNTHESIZED plan to its library hop-DAG (synthesis.lower_plan),
a HIER_RS_AR_AG plan to the striped two-tier allreduce
(hierarchical.py). The allreduce branch picks one of the reference's two
ring bodies: the torch-op ring over `Wire`
(schedules.allreduce_ring_schedule), or — on the card — the fused ring
kernel per 4 MiB segment, double-slotted like the reference's; a
stripe-overlapped plan (Plan.stripes > 1) runs one such chain per
stripe. The
blockwise-int8 wire takes, on the card, the closed-form quantized ring
kernel over the plan's segments (ops/quant_kernels.quant_ring_allreduce),
and off it the torch-op ring, per plan segment, whose per-hop quantize /
fused combine steps are kernels of their own.

Streamed operands splice a producer/consumer into the body
(`lower_streamed`). A call sequence composes the per-call bodies of its
steps (`compile_sequence`), and on the card runs them as one captured
CUDA graph (`SequenceGraph`): the counterpart of the reference's one
jit(shard_map) program per recorded batch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from ..arithconfig import DEFAULT_ARITH_CONFIG, ArithConfig
from ..constants import (
    CompressionFlags,
    DataType,
    Operation,
    ReduceFunction,
    dtype_nbytes,
    to_torch_dtype,
)
from ..descriptor import CallOptions
from ..ops.compression import wire_dtype
from ..ops.lane_kernels import cast
from . import schedules
from .plan import Algorithm, Plan
from .sequence import step_in_elems


@dataclasses.dataclass(frozen=True)
class RingGeometry:
    """How an allreduce's kernel-1 body cuts its columns into launches:
    `seg_elems`-element (4 MiB) segments within each stripe of `stripe`
    elements (None: one stripe), each launch folding with `func`."""

    seg_elems: int
    stripe: int | None
    func: ReduceFunction

    def launches(self, n: int) -> list[tuple[int, int]]:
        """The (lo, hi) column range of each launch over n columns."""
        step = self.stripe or n
        out = []
        for s_lo in range(0, n, step):
            s_hi = min(s_lo + step, n)
            out += [(lo, min(lo + self.seg_elems, s_hi))
                    for lo in range(s_lo, s_hi, self.seg_elems)]
        return out


class ScheduleCompiler:
    """Builds and caches collective bodies for one world of virtual ranks.

    The cache key is the descriptor's static signature + the plan (+ the
    kernel switch), as in the reference. `use_ring_kernel` defaults to
    whether the ranks live on a CUDA device: the fused Hopper ring there,
    the torch-op ring on the CPU."""

    # Per-launch payload ceiling (bytes per rank) of the fused ring kernel;
    # larger buffers run it per segment.
    RING_KERNEL_MAX_BYTES = 4 * 1024 * 1024

    def __init__(self, world: int, torch_device: torch.device,
                 arith_table: dict | None = None,
                 use_ring_kernel: bool | None = None):
        self.world = world
        self.torch_device = torch_device
        self.arith_table = arith_table or DEFAULT_ARITH_CONFIG
        if use_ring_kernel is None:
            use_ring_kernel = torch_device.type == "cuda"
        self.use_ring_kernel = use_ring_kernel
        self._cache: dict = {}

    def _wire(
        self,
        options: CallOptions,
        arithcfg: ArithConfig | None,
        func: ReduceFunction | None,
        compressed_domain: bool,
    ) -> schedules.Wire:
        """The wire a flat body takes (`flat_wire`) for the call's
        datapath config (`_wire_config`)."""
        return self.flat_wire(*self._wire_config(options, arithcfg, func,
                                                 compressed_domain))

    def flat_wire(self, cfg=None,
                  arith_lane: int | None = None) -> schedules.Wire:
        """The Wire of this compiler's flat bodies: every rank's row on
        one card here (the multi-process DCN compiler's carries the hops
        that leave its process)."""
        return schedules.Wire(cfg, arith_lane)

    def rank_rows(self) -> range:
        """The ranks whose rows a flat body is given: every rank here."""
        return range(self.world)

    def _wire_config(
        self,
        options: CallOptions,
        arithcfg: ArithConfig | None,
        func: ReduceFunction | None,
        compressed_domain: bool,
    ) -> tuple:
        """Resolve the datapath config: which compression lanes wrap each
        hop and which arith lane reductions use, as (cfg, arith_lane)."""
        arith_lane = None
        if arithcfg is not None and func is not None:
            arith_lane = arithcfg.arith_lanes[int(func)]
        eth = (
            arithcfg is not None
            and options.compression_flags & CompressionFlags.ETH_COMPRESSED
            and wire_dtype(arithcfg) is not None
        )
        # in compressed-domain execution the operand is cast once up
        # front, so per-hop lanes are disabled
        cfg = arithcfg if (eth and not compressed_domain) else None
        return cfg, arith_lane

    def compile(
        self,
        options: CallOptions,
        plan: Plan,
        arithcfg: ArithConfig | None = None,
    ) -> Callable:
        key = (options.signature(), plan, self.use_ring_kernel)
        fn = self._cache.get(key)
        if fn is None:
            from ..utils.logging import Log

            Log.info("building %s: %s/%s world=%d count=%d",
                     options.scenario.name, plan.protocol.name,
                     plan.algorithm.name, self.world, options.count)
            fn = self._build(options, plan, arithcfg)
            self._cache[key] = fn
        return fn

    def _build(self, options: CallOptions, plan: Plan,
               arithcfg) -> Callable:
        """The body a call runs: its schedule body (`_body`). A compiler
        that lowers some calls otherwise (the two-tier compositions of
        device/dcn_device.DCNCompiler) overrides this seam; streamed
        operands and call sequences keep `_body`'s form through
        `lower_step`, as the reference's lower_streamed and
        compile_sequence take its _body."""
        return self._body(options, plan, arithcfg)

    def _body(self, options: CallOptions, plan: Plan, arithcfg) -> Callable:
        op = options.scenario
        world = self.world
        root = options.root_src_dst
        if plan.algorithm == Algorithm.SYNTHESIZED:
            # the library entry's hop-DAG at this call's count; an int8
            # entry carries its encode/decode nodes, so no per-hop wire
            from . import synthesis

            return synthesis.lower_plan(plan, options, world,
                                        permute=self.flat_wire().permute,
                                        ranks=self.rank_rows())
        if plan.algorithm == Algorithm.HIER_RS_AR_AG:
            return self._hier_body(options, plan, arithcfg)
        func = ReduceFunction(options.function) if op in (
            Operation.combine,
            Operation.reduce,
            Operation.allreduce,
            Operation.reduce_scatter,
        ) else None
        # reductions whose arithconfig reduces in the compressed domain cast
        # the operand to the wire dtype once and run the whole schedule there
        compressed_domain = bool(
            func is not None
            and arithcfg is not None
            and options.compression_flags & CompressionFlags.ETH_COMPRESSED
            and arithcfg.arith_is_compressed
            and wire_dtype(arithcfg) is not None
        )
        wire = self._wire(options, arithcfg, func, compressed_domain)
        common = dict(world=world, wire=wire)

        body: Callable
        if op == Operation.copy:
            body = functools.partial(schedules.copy_schedule, **common)
        elif op == Operation.combine:
            body = functools.partial(schedules.combine_schedule, func=func,
                                     **common)
        elif op in (Operation.send, Operation.recv):
            # a paired send/recv runs as one sendrecv over the whole world
            # (src and dst from the descriptor)
            body = functools.partial(
                schedules.sendrecv_schedule, src=root & 0xFFFF,
                dst=(root >> 16) & 0xFFFF, **common)
        elif op == Operation.bcast:
            if plan.algorithm == Algorithm.RNDZV_BIN_TREE:
                body = functools.partial(schedules.bcast_bin_tree_schedule,
                                         root=root, **common)
            else:
                body = functools.partial(schedules.bcast_flat_schedule,
                                         root=root, **common)
        elif op == Operation.scatter:
            body = functools.partial(schedules.scatter_schedule, root=root,
                                     **common)
        elif op == Operation.gather:
            if plan.algorithm == Algorithm.EAGER_RING:
                body = functools.partial(schedules.gather_ring_schedule,
                                         root=root, **common)
            else:
                body = functools.partial(schedules.gather_flat_schedule,
                                         root=root, fanin=plan.tree_fanin,
                                         **common)
        elif op == Operation.allgather:
            body = functools.partial(schedules.allgather_ring_schedule,
                                     **common)
        elif op == Operation.reduce:
            body = self._reduce_body(plan, root, func, common)
        elif op == Operation.reduce_scatter:
            if plan.algorithm == Algorithm.RNDZV_REDUCE_SCATTER:
                # composition: reduce(count*world) to rank 0, then scatter;
                # the reduce stage's tree shape comes from plan.stages
                reduce_body = self._reduce_body(plan.stages[0], 0, func,
                                                common)

                def _rs_composed(x, _c=common, _rb=reduce_body):
                    return schedules.scatter_schedule(_rb(x), root=0, **_c)

                body = _rs_composed
            else:
                # XLA keeps the reference's last bf16 fold in float32 when
                # the compressed-domain result is cast straight back (its
                # excess-precision rule drops the bf16 round trip), so the
                # port's last fold emits the uncompressed dtype directly;
                # XLA computes fp16 natively and rounds it
                last = None
                if compressed_domain and wire_dtype(arithcfg) == torch.bfloat16:
                    last = to_torch_dtype(options.data_type)
                body = functools.partial(
                    schedules.reduce_scatter_ring_schedule, func=func,
                    out_dtype=last, **common)
        elif op == Operation.allreduce:
            body = self._allreduce_body(options, plan, arithcfg, func, wire,
                                        compressed_domain)
        elif op == Operation.alltoall:
            if options.row_layout is not None:
                body = functools.partial(schedules.slot_alltoallv_schedule,
                                         layout=options.row_layout, **common)
            elif plan.algorithm == Algorithm.FLAT_ALLTOALLV:
                body = functools.partial(schedules.alltoallv_schedule,
                                         peer_counts=plan.peer_counts,
                                         **common)
            else:
                body = functools.partial(schedules.alltoall_schedule,
                                         **common)
        elif op == Operation.barrier:
            body = functools.partial(schedules.barrier_schedule, **common)
        else:
            raise ValueError(f"cannot lower scenario {op!r}")

        if compressed_domain:
            inner, wd = body, wire_dtype(arithcfg)

            def _domain_cast_body(*args, _inner=inner, _wd=wd):
                orig = args[0].dtype
                return cast(_inner(*(cast(a, _wd) for a in args)), orig)

            body = _domain_cast_body
        return body

    def _hier_body(self, options: CallOptions, plan: Plan,
                   arithcfg) -> Callable:
        """The striped two-tier allreduce, its tier wires resolved from
        the plan's frozen tier dtypes against the arith table as the
        reference resolves them: an exact tier carries no wire config,
        and folds run through the call's own arith lane."""
        from . import hierarchical

        func = ReduceFunction(options.function)
        lane = (arithcfg.arith_lanes[int(func)] if arithcfg is not None
                else None)

        def tier_wire(dt: DataType) -> schedules.Wire:
            cfg = (self.arith_table.get((options.data_type, dt))
                   if dt not in (DataType.none, options.data_type)
                   else None)
            return schedules.Wire(cfg, lane)

        return functools.partial(
            hierarchical.hierarchical_allreduce_striped_schedule,
            func=func,
            rankmap=hierarchical.RankMap(plan.inner_world,
                                         plan.outer_world, "outer_major"),
            wire=hierarchical.TierWire(tier_wire(plan.inner_wire_dtype),
                                       tier_wire(plan.outer_wire_dtype)),
            stripes=plan.stripes, tiers=self._hier_tiers())

    def _hier_tiers(self):
        """The (inner, outer) tiers of the striped two-tier allreduce;
        None: the plan's RankMap over the stacked rows of every rank."""
        return None

    def _reduce_body(self, stage_plan: Plan, root: int, func, common):
        """The reduce schedule of a plan (a reduce call or the reduce stage
        of a composition): flat tree, binomial tree or eager ring."""
        if stage_plan.algorithm == Algorithm.RNDZV_BIN_TREE:
            schedule = schedules.reduce_bin_tree_schedule
        elif stage_plan.algorithm == Algorithm.EAGER_RING:
            schedule = schedules.reduce_ring_schedule
        else:
            schedule = schedules.reduce_flat_schedule
        return functools.partial(schedule, root=root, func=func, **common)

    def _allreduce_body(self, options: CallOptions, plan: Plan, arithcfg,
                        func, wire, compressed_domain: bool) -> Callable:
        world = self.world
        if plan.algorithm == Algorithm.RNDZV_REDUCE_BCAST:
            # composition: reduce to rank 0, then broadcast; both stage
            # shapes were re-selected by plan.py with the live registers
            common = dict(world=world, wire=wire)
            reduce_body = self._reduce_body(plan.stages[0], 0, func, common)
            bcast = (schedules.bcast_bin_tree_schedule
                     if plan.stages[1].algorithm == Algorithm.RNDZV_BIN_TREE
                     else schedules.bcast_flat_schedule)

            def _ar_composed(x, _c=common, _rb=reduce_body, _bc=bcast):
                return _bc(_rb(x), root=0, **_c)

            return _ar_composed
        if plan.live_ranks:
            # the degraded live-subset mode runs the torch-op ring, where
            # the source mask is part of the body the certifier lifts (the
            # ring kernel has no masked form); its folds are lane kernels
            return functools.partial(
                schedules.allreduce_ring_schedule,
                func=func, world=world, wire=wire, seg_count=plan.seg_count,
                live_ranks=plan.live_ranks)
        eth_active = bool(
            arithcfg is not None
            and options.compression_flags & CompressionFlags.ETH_COMPRESSED
            and wire_dtype(arithcfg) is not None
        )
        if self.use_ring_kernel and wire.quantized:
            # the blockwise-int8 wire: the whole quantized ring of every
            # plan segment in closed form, one result for the call
            from ..ops.quant_kernels import quant_ring_allreduce

            return functools.partial(
                quant_ring_allreduce, world=world,
                func_op=schedules.quant_op(func), seg_count=plan.seg_count)
        # per-hop compression with uncompressed-domain arithmetic cannot be
        # fused into the single-dtype ring kernel: the torch-op ring (also
        # the int8 wire's off the card, the reference's schedule hop by hop)
        if not (self.use_ring_kernel and (not eth_active or compressed_domain)):
            return functools.partial(
                schedules.allreduce_ring_schedule,
                func=func, world=world, wire=wire, seg_count=plan.seg_count)
        from ..ops.ring_allreduce import NUM_RING_SLOTS, ring_allreduce_bidir

        # elements per segment in the dtype the kernel runs in (the
        # descriptor's: the compressed domain keeps the segmentation of
        # the uncompressed payload, as in the reference); a
        # stripe-overlapped plan's chains are its stripes: each runs the
        # kernel over its own columns, in 4 MiB segments
        elem_bytes = (dtype_nbytes(options.data_type)
                      if options.data_type != DataType.none else 1)
        geometry = RingGeometry(
            seg_elems=max(self.RING_KERNEL_MAX_BYTES // elem_bytes, 1),
            stripe=plan.seg_count if plan.stripes > 1 else None,
            func=func)

        def _ring_kernel_body(x, _wire=wire, _geo=geometry):
            # one result for the call; launch i (in slot i % 2, as the
            # reference double-buffers its segments) writes its column view
            y = _wire.send(x)
            out = torch.empty(y.shape, dtype=y.dtype, device=y.device)
            for i, (lo, hi) in enumerate(_geo.launches(y.shape[-1])):
                ring_allreduce_bidir(y[:, lo:hi], world, func,
                                     slot=i % NUM_RING_SLOTS,
                                     out=out[:, lo:hi])
            return _wire.recv(out, x.dtype)

        if not eth_active:
            # kernel 1 on the exact wire: a captured sequence may run this
            # step through the kernel's indirect entry
            # (SequencePlan.placement reads the launches off the body)
            _ring_kernel_body.ring = geometry
        return _ring_kernel_body

    def lower(self, options: CallOptions, plan: Plan) -> Callable:
        arithcfg = None
        if options.data_type != DataType.none:
            arithcfg = _arithcfg_for(self.arith_table, options)
        return self.compile(options, plan, arithcfg)

    def lower_step(self, options: CallOptions, plan: Plan) -> Callable:
        """The body of one step of a call sequence, or of a streamed call
        before its endpoints are spliced in: the per-call body itself
        (`lower`), so a sequence runs what eager calls run."""
        return self.lower(options, plan)

    def lower_streamed(
        self,
        options: CallOptions,
        plan: Plan,
        producer: Callable | None = None,
        consumer: Callable | None = None,
    ) -> Callable:
        """Streamed-operand collective (the reference's OP0_STREAM /
        RES_STREAM routing through any collective): the operand comes
        from a producer and/or the result passes through a consumer,
        spliced into the same body (ops/streams.py has the calling
        convention)."""
        from ..ops.streams import splice_consumer, splice_producer

        # the endpoint callables are part of the key: the strong
        # reference prevents id reuse after GC from resurrecting a stale
        # body when an endpoint is re-registered
        key = (options.signature(), plan, self.use_ring_kernel, "streamed",
               producer, consumer)
        fn = self._cache.get(key)
        if fn is None:
            body = self.lower_step(options, plan)
            if producer is not None:
                if options.scenario == Operation.combine:
                    raise ValueError(
                        f"OP0_STREAM unsupported for {options.scenario.name}")
                body = splice_producer(body, producer,
                                       step_in_elems(options, self.world),
                                       self.rank_rows())
            if consumer is not None:
                body = splice_consumer(body, consumer)
            fn = self._cache[key] = body
        return fn

    # -- call sequences ----------------------------------------------------

    def compile_sequence(self, seq) -> Callable:
        """The composed body of a SequencePlan: every step's schedule body
        over the batch's buffer table, cached under the batch's composite
        signature beside the per-call entries, so re-recording the same
        shapes and dataflow builds nothing."""
        key = seq.cache_key(self.use_ring_kernel)
        fn = self._cache.get(key)
        if fn is None:
            from ..utils.logging import Log

            Log.info("building sequence of %d steps: %s world=%d",
                     len(seq.steps),
                     "+".join(s.options.scenario.name for s in seq.steps),
                     self.world)
            fn = self._cache[key] = self._finalize_sequence(seq.build(self))
        return fn

    def _finalize_sequence(self, body: Callable) -> Callable:
        # kept as a distinct seam (tests pin it to detect re-builds)
        return body

    def sequence_graph(self, seq, body: Callable,
                       inputs: list[torch.Tensor],
                       in_place: bool = False) -> "SequenceGraph":
        """The executable form of a composed body for buffers shaped like
        `inputs` (the batch's buffer table): on the card a CUDA graph
        captured once, cached with the body under the composite
        signature plus the buffer table's widths and dtypes. With
        `in_place` (the device's default world) a graph captured on the
        card follows the batch's placement (SequencePlan.placement);
        otherwise every step is staged."""
        layout = tuple((tuple(t.shape), t.dtype) for t in inputs)
        key = ("graph", seq.cache_key(self.use_ring_kernel), layout)
        graph = self._cache.get(key)
        if graph is None:
            placement = None
            if in_place and inputs[0].device.type == "cuda":
                placement = seq.placement(
                    self, [(shape[-1], dtype) for shape, dtype in layout])
            graph = self._cache[key] = SequenceGraph(body, inputs,
                                                     placement=placement)
        return graph


def analysis_body(options: CallOptions, plan: Plan, world: int,
                  axis_name: str = "ccl",
                  arith_table: dict | None = None) -> tuple[Callable, int]:
    """The IR-extraction hook for the static analyzers: the SAME schedule
    body `ScheduleCompiler._body` builds for the call (nothing
    re-modelled) and its operand count. The ring kernel is off, as the
    reference forces Pallas off: the torch-op ring expresses the wire
    pattern hop by hop, which is what the analyses read. The compiler is
    a CPU one and building the body touches no device; the analysis
    lifter (analysis/semantics.py) evaluates it over symbolic operands.
    `axis_name` is the reference's mesh axis, kept for its signature."""
    comp = ScheduleCompiler(world, torch.device("cpu"),
                            arith_table=arith_table, use_ring_kernel=False)
    arithcfg = None
    if options.data_type != DataType.none:
        arithcfg = _arithcfg_for(comp.arith_table, options)
    n_in = 2 if options.scenario == Operation.combine else 1
    return comp._body(options, plan, arithcfg), n_in


def _arithcfg_for(table, options: CallOptions):
    dt = options.data_type
    if options.compress_dtype != DataType.none:
        # the caller named a wire dtype: the row must match exactly
        return table.get((dt, options.compress_dtype))
    if options.compression_flags & CompressionFlags.ETH_COMPRESSED:
        for (unc, cmp_), cfg in table.items():
            if unc == dt and unc != cmp_:
                return cfg
    return table.get((dt, dt))


class _Binding:
    """One dispatch's buffers (SequenceGraph.bind): `bound`, the bound
    tensors, held until the request completes; `copies`, the (static
    input, bound tensor) pairs `load` copies, of `nbytes` device bytes
    read and written; `fresh`, the results `allocate` made; `ptrs`, the
    table's slots: 0, the address each in-place read takes (the bound
    tensor's, or its staged copy's), then each fresh result's; `in_place`
    and `staged`, how many of the table's buffers the replay takes where
    they lie (or never reads) and how many are copied into the graph's
    inputs."""

    __slots__ = ("bound", "copies", "nbytes", "fresh", "ptrs", "in_place",
                 "staged")


class SequenceGraph:
    """One prepared batch's executable form. A dispatch runs `bind` (the
    batch's buffer table: the bound buffers' current device images),
    `allocate` (its fresh results), `load` (what the graph cannot read in
    place), `replay` (the batch) and `results` (the written buffers'
    values, as tensors no later dispatch touches).

    On a CUDA device the body is captured once as a CUDA graph and
    `replay` is one graph launch. The body first runs once eagerly on a
    side stream (building and loading the kernels, filling the schedules'
    index caches: nothing that must not happen under capture), then is
    captured; every kernel wrapper takes the current stream at call
    time, so under capture it launches on the capture stream. Launch
    counters tick on the host, at that warm-up run and at capture, never
    at replay. A failed capture raises; nothing falls back to the eager
    body.

    Where the graph reads and writes follows the batch's `placement`
    (sequence.SequencePlan.placement). A step placed in place is
    captured as kernel-1 launches through the kernel's indirect entry
    (ops/ring_allreduce.ring_allreduce_indirect), each with its own row
    of a device table: the launch reads its operand where it lies (the
    bound tensor, or an earlier in-place step's result) and writes a
    fresh result, allocated for the dispatch on the replay's stream, or,
    where a staged step reads that result, memory the graph owns. `load`
    writes the table's rows for the dispatch with one host-to-device
    copy from pinned memory, on the replay's stream before it, and copies
    into static inputs only the buffers whose bound value a staged step
    reads: a buffer that is only written is never loaded. A bound
    tensor read in place whose layout is not the captured one
    (contiguous rows, a 16-byte base) is copied for that dispatch into a
    static input of its own, and the row points there. Every other step
    runs as captured over static inputs, its outputs in the graph's
    private memory pool, which the next replay overwrites: `results`
    clones out what the graph's memory holds and hands out the fresh
    results themselves.

    On the CPU, with `capture=False` (a body whose hops stage through the
    host), or without an in-place step, every step is staged: every buffer is
    loaded, every output cloned, and without a graph the body runs
    eagerly on the static inputs at each `replay`."""

    def __init__(self, body: Callable, inputs: list[torch.Tensor],
                 capture: bool = True, placement=None):
        device = inputs[0].device
        capture = capture and device.type == "cuda"
        if not (capture and placement and placement.steps):
            placement = None
        self.body = body
        self.graph = None
        self.placement = placement
        self.outputs: tuple[torch.Tensor, ...] = ()
        # host seconds of the eager warm-up run and of the capture
        self.warmup_s = self.capture_s = 0.0
        loaded = placement.loaded if placement else [True] * len(inputs)
        self._static = [
            torch.empty(t.shape, dtype=t.dtype, device=t.device) if ld
            else None for t, ld in zip(inputs, loaded)]
        self.inputs = [t for t in self._static if t is not None]
        self.load_bytes = 2 * sum(t.numel() * t.element_size()
                                  for t in self.inputs)
        self._finals: list | None = None
        self._reads: list[tuple] = []  # (buffer, shape, dtype)
        # a fresh result's shape and dtype, as a view of one element:
        # empty_like of it costs the host half what empty(shape) does
        self._fresh: list[torch.Tensor] = []
        self._fallback: dict[int, torch.Tensor] = {}
        self._kept: dict[int, torch.Tensor] = {}
        self._device = device
        self._index = device.index if device.type == "cuda" else -1
        self._table: torch.Tensor | None = None
        self._launches: dict = {}
        if placement is not None:
            self._lay_out_rows(inputs, placement)
        for dst, src in self.bind(inputs).copies:
            dst.copy_(src)
        if not capture:
            return
        import time

        env = [t if t is not None else
               torch.empty(u.shape, dtype=u.dtype, device="meta")
               for t, u in zip(self._static, inputs)]
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self._run_body(env, warm=True)
        main.wait_stream(side)
        torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = self._run_body(env, warm=False)
        self.graph = graph
        self.warmup_s, self.capture_s = t1 - t0, time.perf_counter() - t1
        if placement is None:
            self.outputs = outs
            return
        fresh = {p.step: j for j, p in enumerate(
            p for p in placement.steps if p.fresh)}
        self._finals = [(fresh.get(w), None if w in fresh else out)
                        for w, out in zip(placement.finals, outs)]
        self.outputs = tuple(out for j, out in self._finals if j is None)

    def _lay_out_rows(self, inputs, placement) -> None:
        """The table's rows, one a kernel-1 launch of the in-place steps:
        per row the (slot, offset) of its operand's and its result's base
        pointer, a slot naming the dispatch's bound source of a buffer
        or fresh result of a step (slot 0: an absolute address, memory
        the graph owns)."""
        world, device = inputs[0].shape[0], self._device
        steps = {p.step: p for p in placement.steps}
        reads = sorted({p.source[1] for p in placement.steps
                        if p.source[0] == "bound"})
        slot = {("bound", i): 1 + k for k, i in enumerate(reads)}
        one = {p.dtype: torch.empty((), dtype=p.dtype, device=device)
               for p in placement.steps}
        for p in placement.steps:
            if p.fresh:
                slot[("fresh", p.step)] = 1 + len(reads) + len(self._fresh)
                self._fresh.append(one[p.dtype].expand(world, p.n))
        self._reads = [(i, inputs[i].shape, inputs[i].dtype) for i in reads]
        # results a staged step reads: memory the graph owns
        self._kept = {p.step: torch.empty((world, p.n), dtype=p.dtype,
                                          device=device)
                      for p in placement.steps if not p.fresh}
        pairs: list[tuple[int, int]] = []
        for p in placement.steps:
            kind, ref = p.source
            isz = p.dtype.itemsize
            ld_in = (inputs[ref].shape[-1] if kind == "bound"
                     else steps[ref].n)
            if kind == "kept":
                x_slot, x_base = 0, self._kept[ref].data_ptr()
            else:
                x_slot, x_base = slot[(kind, ref)], 0
            if p.fresh:
                o_slot, o_base = slot[("fresh", p.step)], 0
            else:
                o_slot, o_base = 0, self._kept[p.step].data_ptr()
            rows = []
            for lo, hi in p.ring.launches(p.n):
                off = lo * isz
                vec = (off % 16 == 0 and ld_in * isz % 16 == 0
                       and p.n * isz % 16 == 0)
                rows.append((len(pairs), hi - lo, vec))
                pairs += [(x_slot, x_base + off), (o_slot, o_base + off)]
            self._launches[p.step] = (p, ld_in, rows)
        self._slots = np.array([a for a, _ in pairs], dtype=np.intp)
        self._offsets = np.array([b for _, b in pairs], dtype=np.int64)
        self._table = torch.zeros((len(pairs),), dtype=torch.int64,
                                  device=device)

    def _run_body(self, env, warm: bool):
        if not self._launches:
            return self.body(*env)
        from ..ops.ring_allreduce import ring_allreduce_indirect

        world = env[0].shape[0]
        table = self._table.data_ptr()

        def launcher(p, ld_in, rows):
            def run(src):
                # the operand as the body would hand it to the direct
                # entry: its layout is what the rows were laid out for
                if src.dtype != p.dtype or src.stride(0) != ld_in or (
                        src.shape[-1] > 1 and src.stride(1) != 1):
                    raise RuntimeError(
                        f"in-place step {p.step}: operand {src.dtype} "
                        f"strides {src.stride()}, laid out for {p.dtype} "
                        f"rows {ld_in} apart")
                for pair, n, vec in rows:
                    ring_allreduce_indirect(
                        table + 8 * pair, self._device, p.dtype,
                        world, 0 if warm else n, ld_in, p.n, vec,
                        p.ring.func)
                kept = self._kept.get(p.step)
                if kept is not None:
                    return kept
                return torch.empty((world, p.n), dtype=p.dtype,
                                   device="meta")
            return run

        return self.body(*env, table={s: launcher(*v) for s, v in
                                      self._launches.items()})

    def bind(self, tensors) -> _Binding:
        """The dispatch's buffers: which are copied into static inputs
        (every one some staged step reads, and each bound tensor read in
        place whose layout is not the captured one) and which are read
        where they lie. Enqueues nothing."""
        b = _Binding()
        b.bound = tensors
        b.copies = [(dst, t) for dst, t in zip(self._static, tensors)
                    if dst is not None]
        b.nbytes = self.load_bytes
        b.ptrs = [0]
        b.fresh = []
        for i, shape, dtype in self._reads:
            t = tensors[i]
            ptr = t.data_ptr()
            if (ptr % 16 == 0 and t.dtype is dtype and t.shape == shape
                    and t.is_contiguous() and t.get_device() == self._index):
                b.ptrs.append(ptr)
                continue
            dst = self._static[i]
            if dst is None:
                dst = self._fallback.get(i)
                if dst is None:
                    dst = self._fallback[i] = torch.empty(
                        shape, dtype=dtype, device=self._device)
                b.copies.append((dst, t))
                b.nbytes += 2 * dst.numel() * dst.element_size()
            b.ptrs.append(dst.data_ptr())
        b.staged = len(b.copies)
        b.in_place = len(tensors) - b.staged
        return b

    def allocate(self, b: _Binding) -> None:
        """The dispatch's fresh results, on the current (the replay's)
        stream: one a result written in place."""
        b.fresh = [torch.empty_like(t) for t in self._fresh]
        b.ptrs += [t.data_ptr() for t in b.fresh]

    def load(self, b: _Binding) -> None:
        """Copy the staged buffers into the graph's static inputs and
        write the table's rows for this dispatch: one host-to-device copy
        from pinned memory, which the caching host allocator keeps until
        the copy has run, so a dispatch enqueued behind an earlier one
        never rewrites the earlier one's rows."""
        for dst, src in b.copies:
            dst.copy_(src)
        if self._table is not None:
            rows = torch.from_numpy(
                np.asarray(b.ptrs, dtype=np.int64)[self._slots]
                + self._offsets).pin_memory()
            self._table.copy_(rows, non_blocking=True)

    @property
    def results_bytes(self) -> int:
        """Device bytes `results` clones per dispatch (read and written)."""
        return 2 * sum(t.numel() * t.element_size() for t in self.outputs)

    def replay(self) -> None:
        if self.graph is not None:
            self.graph.replay()
        else:
            self.outputs = self.body(*self.inputs)

    def results(self, b: _Binding) -> list[torch.Tensor]:
        """The written buffers' values, in the batch's output order: the
        fresh results themselves, clones of what the graph's memory
        holds."""
        if self._finals is None:
            return [t.clone() for t in self.outputs]
        return [b.fresh[j] if j is not None else out.clone()
                for j, out in self._finals]
