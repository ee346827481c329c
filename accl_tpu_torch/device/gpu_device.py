"""GPUDevice: descriptor execution over virtual ranks on one card.

Counterpart of accl_tpu/device/tpu_device.py. TPUDevice resolves a
descriptor's buffers, selects a plan and launches the cached compiled
program over a mesh of chips. GPUDevice does the same for W virtual
ranks on one CUDA device (or on the CPU when the caller asks for it):
every buffer is a stacked (world, n) tensor, and one call executes the
collective for every rank. Completion is a CUDA event recorded after the
call's kernels instead of XLA's block_until_ready.

Every one-call collective is ported (copy, combine, bcast, scatter,
gather, allgather, reduce, allreduce, reduce_scatter, alltoall(v),
barrier), with streamed operands (a registered producer/consumer spliced
into the body), and so are call sequences: a recorded batch is prepared
once (plans, the lint gate, the composed body, on the card one captured
CUDA graph) and dispatched as one graph replay. Point-to-point send/recv
pairs on the host: a send parks its descriptor until its recv arrives
(or the other way round), and the pair then runs as one sendrecv call;
`stream_put` is a producer -> sendrecv -> consumer call. A descriptor
addressing a sub-communicator runs over the member rows only: they are
gathered into a (group, n) operand and the result is scattered back into
them, every other row left as it was. A device that declares its
two-tier shape (`hier_topology=(inner, outer)`) runs the full world's
allreduces in the HIER_ALLREDUCE_MIN_COUNT window on the striped
two-tier schedule, with the tier wires ACCL.autotune sets in
`hier_wires`.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import threading
import time
from typing import Any

import torch

from ..constants import (
    DEFAULT_EAGER_RX_BUF_SIZE,
    DEFAULT_MAX_EAGER_SIZE,
    DEFAULT_MAX_RENDEZVOUS_SIZE,
    CfgFunc,
    CompressionFlags,
    DataType,
    ErrorCode,
    Operation,
    StreamFlags,
    TAG_ANY,
    TuningParams,
    dtype_nbytes,
)
from ..descriptor import CallOptions, SequenceDescriptor
from ..ops.streams import StreamRegistry, splice_consumer, splice_producer
from ..request import (
    BaseRequest,
    GPURequest,
    ParkedRecvRequest,
    SequenceRequest,
)
from ..sequencer import schedules
from ..sequencer.lowering import ScheduleCompiler
from ..sequencer.plan import select_algorithm
from ..sequencer.sequence import (
    SequencePlan,
    place_into,
    slice_to,
    step_in_elems,
)
from ..telemetry import get_tracer
from .base import STATS2_FIELDS, CCLOAddr, CCLODevice


class GPUDevice(CCLODevice):
    # the blockwise int8 wire runs the quantized torch-op ring, whose
    # per-hop steps are the kernels of ops/quant_kernels.py on the card
    supports_quantized_wire = True
    # the capacity-masked alltoallv rotation (schedules.alltoallv_schedule)
    supports_alltoallv = True
    # the slot-driven alltoallv over a device layout written on the card
    # (schedules.slot_alltoallv_schedule, ops/moe_kernels.py)
    supports_slot_alltoallv = True
    # the degraded live-subset allreduce: the torch-op ring with its
    # survivor mask at the source (schedules.allreduce_ring_schedule)
    supports_live_subset = True
    # the ALLTOALL_COMPRESS_MIN_COUNT register applies the int8 wire to
    # eligible fp32 alltoall(v) calls (_apply_alltoall_wire)
    auto_alltoall_wire = True
    # a send/recv backlog beyond this many parked sends fails the send
    # (the reference's 512-notification park limit)
    MAX_PARKED_SENDS = 512

    def __init__(self, world: int, torch_device: torch.device | str = "cuda",
                 hier_topology: tuple[int, int] | None = None):
        super().__init__()
        torch_device = torch.device(torch_device)
        if torch_device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("GPUDevice on cuda needs a CUDA device")
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self._world = world
        self.torch_device = torch_device
        self.compiler = ScheduleCompiler(world, torch_device)
        # the two-tier (inner_world, outer_world) shape of the world for
        # the hierarchical allreduce (None: flat); its plans stay
        # unreachable until the HIER_ALLREDUCE_MIN_COUNT register opens
        self.hier_topology = hier_topology
        # the per-tier wire dtypes of hierarchical plans, set by
        # ACCL.autotune (plan.select_tier_wires) for fp32 calls
        self.hier_wires: tuple[DataType, DataType] = (DataType.none,
                                                      DataType.none)
        self.buffers: dict[int, Any] = {}  # address -> GPUBuffer
        self.timeout = 1_000_000
        self.max_eager_size = DEFAULT_MAX_EAGER_SIZE
        self.max_rendezvous_size = DEFAULT_MAX_RENDEZVOUS_SIZE
        self.eager_rx_buf_size = DEFAULT_EAGER_RX_BUF_SIZE
        self.pkt_enabled = False
        # one collective in flight at a time: the emulated CCLO has a
        # single sequencer, so concurrent callers interleave at call
        # granularity
        self._launch_mu = threading.Lock()
        # send/recv pairing: sends parked until their recv arrives and
        # recvs parked until their send does, each signature (comm_addr,
        # src, dst, tag) keying a FIFO; a TAG_ANY match takes the oldest
        # across every matching signature (arrival order). _recv_mu guards
        # both maps and the counters, and is never held across a launch.
        self._recv_mu = threading.Lock()
        self._pending_sends: dict[tuple, list[tuple[int, CallOptions]]] = {}
        self._pending_recvs: dict[tuple, list[ParkedRecvRequest]] = {}
        self._park_seq = 0
        self._parked_send_count = 0
        # comm_addr -> resolved communicator context; a cached table's
        # extent, so a write into it drops the entry; member rows ->
        # context, so identical groups share one compiler
        self._comm_cache: dict[int, _CommCtx] = {}
        self._comm_extents: dict[int, int] = {}
        self._group_cache: dict[tuple[int, ...], _CommCtx] = {}
        # kernel-stream endpoints (OP0_STREAM / RES_STREAM)
        self.streams = StreamRegistry()
        self._stream_cache: dict[tuple, Any] = {}
        # lint verdicts of call sequences, by composite signature
        self._lint_cache: dict[tuple, tuple] = {}
        # traced dispatches' `results` layer spans waiting for the card to
        # pass the event after their clones, oldest first, with that
        # event pair (dispatch_sequence); _copies_mu guards the list
        self._copies_out: list[tuple] = []
        self._copies_mu = threading.Lock()

    # -- registry ---------------------------------------------------------

    @property
    def world(self) -> int:
        return self._world

    def register_buffer(self, buf) -> None:
        self.buffers[buf.address] = buf

    def unregister_buffer(self, buf) -> None:
        self.buffers.pop(buf.address, None)

    def _buf(self, addr: int):
        if addr == 0:
            return None
        try:
            return self.buffers[addr]
        except KeyError:
            raise KeyError(f"no buffer registered at address {addr:#x}") from None

    # -- tuning registers (exchange-memory backed) ------------------------

    def tuning(self) -> TuningParams:
        rd = self.read
        defaults = TuningParams.default(self.max_rendezvous_size)
        return TuningParams(
            gather_flat_tree_max_fanin=rd(CCLOAddr.GATHER_FLAT_TREE_MAX_FANIN)
            or defaults.gather_flat_tree_max_fanin,
            gather_flat_tree_max_count=rd(CCLOAddr.GATHER_FLAT_TREE_MAX_COUNT)
            or defaults.gather_flat_tree_max_count,
            bcast_flat_tree_max_ranks=rd(CCLOAddr.BCAST_FLAT_TREE_MAX_RANKS)
            or defaults.bcast_flat_tree_max_ranks,
            reduce_flat_tree_max_ranks=rd(CCLOAddr.REDUCE_FLAT_TREE_MAX_RANKS)
            or defaults.reduce_flat_tree_max_ranks,
            reduce_flat_tree_max_count=rd(CCLOAddr.REDUCE_FLAT_TREE_MAX_COUNT)
            or defaults.reduce_flat_tree_max_count,
            # 0 is each of these registers' meaningful default (off)
            allreduce_composition_max_count=rd(
                CCLOAddr.ALLREDUCE_COMPOSITION_MAX_COUNT),
            synth_allreduce_max_count=rd(
                CCLOAddr.SYNTH_ALLREDUCE_MAX_COUNT),
            synth_allgather_max_count=rd(
                CCLOAddr.SYNTH_ALLGATHER_MAX_COUNT),
            synth_reduce_scatter_max_count=rd(
                CCLOAddr.SYNTH_REDUCE_SCATTER_MAX_COUNT),
            hier_allreduce_min_count=rd(
                CCLOAddr.HIER_ALLREDUCE_MIN_COUNT),
            alltoall_compress_min_count=rd(
                CCLOAddr.ALLTOALL_COMPRESS_MIN_COUNT),
            overlap_min_count=rd(CCLOAddr.OVERLAP_MIN_COUNT),
            synth_latency_max_count=rd(
                CCLOAddr.SYNTH_LATENCY_MAX_COUNT),
        )

    # -- communicator resolution ------------------------------------------

    def _comm_ctx(self, comm_addr: int) -> "_CommCtx":
        """Resolve a descriptor's comm_addr into an execution context by
        reading the rank table back from exchange memory, as the
        reference's firmware does per call. comm_addr 0 or a full-world
        identity table is the default world; any other member set is a
        sub-communicator over those rows."""
        ctx = self._comm_cache.get(comm_addr)
        if ctx is not None:
            return ctx
        rows = None
        if comm_addr != 0:
            from ..communicator import Communicator

            size = self.read(comm_addr)
            if not 0 < size <= self.world:
                raise ValueError(
                    f"invalid communicator at {comm_addr:#x}: size={size}")
            nwords = 2 + size * Communicator.WORDS_PER_RANK
            words = [self.read(comm_addr + 4 * i) for i in range(nwords)]
            comm = Communicator.from_exchmem_words(words, comm_addr)
            members = tuple(r.device_index for r in comm.ranks)
            if any(not 0 <= d < self.world for d in members):
                raise ValueError(
                    f"communicator at {comm_addr:#x} references device "
                    f"indices {members} outside world {self.world}")
            if len(set(members)) != len(members):
                raise ValueError(
                    f"communicator at {comm_addr:#x} has duplicate "
                    f"members {members}")
            if members != tuple(range(self.world)):
                rows = members
            self._comm_extents[comm_addr] = comm_addr + 4 * nwords
        if rows is None:
            ctx = _CommCtx(self.world, self.compiler, None, None)
        else:
            # identical member sets at different table addresses share one
            # context, so re-splits reuse the built schedules
            ctx = self._group_cache.get(rows)
            if ctx is None:
                compiler = self._group_compiler(rows)
                index = torch.tensor(rows, dtype=torch.int64,
                                     device=self.torch_device)
                ctx = self._group_cache[rows] = _CommCtx(
                    len(rows), compiler, rows, index)
        self._comm_cache[comm_addr] = ctx
        return ctx

    def _group_compiler(self, rows: tuple[int, ...]) -> ScheduleCompiler:
        """The schedule compiler of a sub-communicator over `rows`: a flat
        world of len(rows) ranks with the device's arithmetic table and
        kernel switch."""
        return ScheduleCompiler(
            len(rows), self.torch_device,
            arith_table=self.compiler.arith_table,
            use_ring_kernel=self.compiler.use_ring_kernel)

    def _operand_rows(self, ctx: "_CommCtx") -> int:
        """The rank rows a call's body takes here: every member of the
        communicator, all of them on this card."""
        return ctx.world

    def write(self, addr: int, value: int) -> None:
        # a write into a cached communicator table drops that entry (the
        # cache must not outlive the table it mirrors)
        for start, end in list(self._comm_extents.items()):
            if start <= addr < end:
                self._comm_cache.pop(start, None)
                self._comm_extents.pop(start, None)
        super().write(addr, value)

    def validate_split(self, rows: tuple) -> None:
        """Reject an unsupported rank group before the facade allocates
        exchange memory for it: one card holds every rank, so any subset
        is accepted."""

    @staticmethod
    def _member_rows(t: torch.Tensor, ctx: "_CommCtx",
                     n: int) -> torch.Tensor:
        """The first n elements of every member row of a full-world
        stacked tensor, as a (group, n) tensor of its own (a gather by the
        context's device index, never a host list)."""
        t = slice_to(t, n)
        return t if ctx.rows is None else t.index_select(0, ctx.index)

    @staticmethod
    def _place(full: torch.Tensor, ctx: "_CommCtx",
               out: torch.Tensor) -> torch.Tensor:
        """A result written into a full-world buffer's image: the whole
        buffer (or its prefix) on the default world; on a sub-communicator
        the member rows only, every other row bitwise as it was."""
        if ctx.rows is None:
            return place_into(full, out)
        full = full.clone()
        full[:, :out.shape[-1]].index_copy_(0, ctx.index,
                                             out.to(full.dtype))
        return full

    # -- execution --------------------------------------------------------

    def start(self, options: CallOptions) -> BaseRequest:
        if options.scenario == Operation.config:
            return self._config(options)
        if options.scenario == Operation.nop:
            req = BaseRequest("nop")
            req.running()
            req.complete(0)
            return req
        if options.scenario == Operation.send:
            return self._enqueue_send(options)
        if options.scenario == Operation.recv:
            return self._match_recv(options)
        return self._launch(options)

    def _apply_alltoall_wire(self, options: CallOptions,
                             tuning: TuningParams) -> CallOptions:
        """The ALLTOALL_COMPRESS_MIN_COUNT register, applied per
        descriptor in front of plan selection, on the eager path and the
        call-sequence path alike: an uncompressed fp32 alltoall(v) whose
        hop payload reaches the register ships the blockwise int8 wire
        (compress_dtype int8 + ETH_COMPRESSED, the descriptor the facade's
        `compress_dtype=` would have made). The hop payload is the slot
        for alltoall and max(peer_counts) elements for alltoallv. Register
        0, the default, returns the descriptor untouched."""
        reg = tuning.alltoall_compress_min_count
        if (reg <= 0
                or options.scenario != Operation.alltoall
                or options.row_layout is not None
                or options.data_type != DataType.float32
                or options.compress_dtype != DataType.none
                or int(options.compression_flags) != 0
                or not self.auto_alltoall_wire
                or not self.supports_quantized_wire):
            return options
        hop_elems = (max(options.peer_counts) if options.peer_counts
                     else options.count)
        if hop_elems * dtype_nbytes(options.data_type) < reg:
            return options
        if (DataType.float32, DataType.int8) not in self.compiler.arith_table:
            return options
        return dataclasses.replace(
            options, compress_dtype=DataType.int8,
            compression_flags=CompressionFlags.ETH_COMPRESSED)

    def _resolve_step(self, options: CallOptions, ctx: "_CommCtx",
                      tuning: TuningParams | None = None):
        """Per-descriptor plan selection and stream-endpoint resolution:
        the one source for both the eager path and call sequences, so a
        sequence can never run other than what eager execution would.
        Selection sees the communicator's world; the two-tier topology
        applies to the full world only (a sub-communicator is its own flat
        world), and the tier wires to fp32 calls only (the dtype they were
        arbitrated for). Returns (plan, producer, consumer)."""
        topo = self.hier_topology if ctx.rows is None else None
        plan = select_algorithm(
            options.scenario,
            options.count,
            dtype_nbytes(options.data_type),
            ctx.world,
            options.compression_flags,
            options.stream_flags,
            max_eager_size=self.max_eager_size,
            eager_rx_buf_size=self.eager_rx_buf_size,
            tuning=tuning if tuning is not None else self.tuning(),
            compress_dtype=options.compress_dtype,
            topology=topo,
            tier_wires=(self.hier_wires
                        if options.data_type == DataType.float32
                        else (DataType.none, DataType.none)),
            peer_counts=options.peer_counts,
            live_ranks=options.live_ranks,
        )
        # stream ids ride dedicated descriptor bytes (word 8), so the tag
        # stays free for matching
        producer = consumer = None
        if options.stream_flags & StreamFlags.OP0_STREAM:
            producer = self.streams.producer(options.op0_stream_id)
        if options.stream_flags & StreamFlags.RES_STREAM:
            consumer = self.streams.consumer(options.res_stream_id,
                                             strict=True)
        return plan, producer, consumer

    def _launch(self, options: CallOptions) -> GPURequest:
        ctx = self._comm_ctx(options.comm_addr)
        tracer = get_tracer()
        # send/recv arrive here paired (start() routes the raw halves
        # through the parking maps; _pair merged them)
        with tracer.layer("resolve") as sp:
            tuning = self.tuning()
            options = self._apply_alltoall_wire(options, tuning)
            plan, producer, consumer = self._resolve_step(options, ctx,
                                                          tuning)
            if options.stream_flags:
                fn = ctx.compiler.lower_streamed(options, plan, producer,
                                                 consumer)
            else:
                fn = ctx.compiler.lower(options, plan)
            if sp:
                sp.set(algorithm=plan.algorithm.name)
        scen = options.scenario
        res = self._buf(options.addr_2)
        if scen == Operation.barrier:
            # the zero-payload notifications ride a one-element token
            args = [torch.ones((self._operand_rows(ctx), 1),
                               dtype=torch.float32, device=self.torch_device)]
        else:
            in_n = step_in_elems(options, ctx.world)
            args = [self._member_rows(self._buf(options.addr_0).device, ctx,
                                      in_n)]
            if scen == Operation.combine:
                args.append(self._member_rows(
                    self._buf(options.addr_1).device, ctx, in_n))
        out, events, t0 = self._run(fn, args)

        def place(req):
            if res is not None and scen != Operation.barrier:
                if res.device is None:  # host-only result: materialize first
                    res.sync_to_device()
                res.device = self._place(res.device, ctx, out)

        req = self._request(options.scenario.name, out, events, t0, place,
                            plan)
        if tracer.active:
            # the facade span reads it where something consumes it (the
            # ring, or the drift sentinel of a synchronous call): the
            # timing.predict estimate beside the measured duration, made
            # at that read
            req._predict = functools.partial(self._predict_call, options,
                                             plan, ctx.world)
        return req

    def _predict_call(self, options: CallOptions, plan,
                      world: int) -> float | None:
        """timing.predict estimate for one resolved call under the
        shipped default link (telemetry.feedback.default_link, the
        calibration autotune consults), in the aggregate cost shape the
        shipped fit calibrates; None when no timing model is shipped or
        the plan has no cost shape. Host arithmetic only: it reads no
        device tensor."""
        from ..sequencer.timing import predict
        from ..telemetry.feedback import default_link

        link = default_link()
        if link is None or plan is None:
            return None
        try:
            return predict(link, options.scenario, plan, options.count,
                           dtype_nbytes(options.data_type), world,
                           rx_buf_bytes=self.eager_rx_buf_size,
                           aggregate=True)
        except (ValueError, KeyError, ZeroDivisionError):
            return None

    @staticmethod
    def _request(name, out, events, t0, place, plan=None) -> GPURequest:
        req = GPURequest(name, [out], events, on_complete=place)
        if events is None:
            req._start_time = t0  # host clock around the eager CPU run
        req.plan = plan
        return req

    def _run(self, fn, args):
        """Run a body with one collective in flight, between two CUDA
        events on the card; returns (out, events, host start ns)."""
        events = None
        launch = get_tracer().layer("launch")
        with self._launch_mu:
            t0 = time.perf_counter_ns()
            if self.torch_device.type == "cuda":
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
                with launch:
                    out = fn(*args)
                events[1].record()
            else:
                with launch:
                    out = fn(*args)
        return out, events, t0

    # -- send/recv pairing -------------------------------------------------

    def _enqueue_send(self, options: CallOptions) -> BaseRequest:
        """A send parks its descriptor until the matching recv arrives
        (the role each rank's eager rx-ring notification queue plays in
        the reference); a recv already parked for it is claimed and the
        pair launched at once, outside the lock. Only the descriptor
        parks: the send's operand is read when the pair launches."""
        src = options.root_src_dst & 0xFFFF
        dst = (options.root_src_dst >> 16) & 0xFFFF
        req = BaseRequest("send")
        req.running()
        parked = None
        with self._recv_mu:  # match-or-enqueue is one atomic step
            while parked is None:
                # the oldest parked recv across every matching signature
                # (each queue's head is its oldest)
                best = None
                for key, queue in self._pending_recvs.items():
                    if self._matches(key, options, src, dst) and (
                            best is None or queue[0]._park_seq
                            < self._pending_recvs[best][0]._park_seq):
                        best = key
                if best is None:
                    break
                queue = self._pending_recvs[best]
                candidate = queue.pop(0)
                if not queue:
                    self._pending_recvs.pop(best, None)
                if candidate.claim():  # skip one that already timed out
                    parked = candidate
            if parked is None:
                if self._parked_send_count >= self.MAX_PARKED_SENDS:
                    # the backlog is full: fail instead of growing
                    req.complete(int(
                        ErrorCode.DEQUEUE_BUFFER_SPARE_BUFFER_STATUS_ERROR))
                    return req
                self._park_seq += 1
                self._parked_send_count += 1
                self._pending_sends.setdefault(
                    (options.comm_addr, src, dst, options.tag), []
                ).append((self._park_seq, options))
        if parked is not None:
            parked.resolve(self._launch(self._pair(parked.options, options)))
        req.complete(0)
        return req

    @staticmethod
    def _matches(key: tuple, options: CallOptions, src: int,
                 dst: int) -> bool:
        comm_addr, s, d, tag = key
        return (comm_addr == options.comm_addr and s == src and d == dst
                and (tag == options.tag or TAG_ANY in (tag, options.tag)))

    @staticmethod
    def _pair(recv_opts: CallOptions, send_opts: CallOptions) -> CallOptions:
        """The one sendrecv descriptor of a matched pair: the recv's count,
        communicator and wire, the send's operand (addr_0) and the recv's
        result buffer (addr_2). Stream endpoints merge from the side that
        owns them: OP0 from the send (a producer may make its payload),
        RES from the recv (a consumer may take its result).

        The recv's wire (compress_dtype, arithcfg_addr) rides the pair.
        The reference's pair keeps only the compression flag, so its
        lowering takes the first compressed row of the dtype's table (the
        fp16 wire for fp32) whatever wire the caller named."""
        flags = StreamFlags.NO_STREAM
        op0_id = res_id = 0
        if send_opts.stream_flags & StreamFlags.OP0_STREAM:
            flags |= StreamFlags.OP0_STREAM
            op0_id = send_opts.op0_stream_id
        if recv_opts.stream_flags & StreamFlags.RES_STREAM:
            flags |= StreamFlags.RES_STREAM
            res_id = recv_opts.res_stream_id
        return CallOptions(
            scenario=Operation.send,
            count=recv_opts.count,
            comm_addr=recv_opts.comm_addr,
            root_src_dst=recv_opts.root_src_dst,
            tag=send_opts.tag,
            arithcfg_addr=recv_opts.arithcfg_addr,
            compression_flags=recv_opts.compression_flags,
            stream_flags=flags,
            op0_stream_id=op0_id,
            res_stream_id=res_id,
            data_type=recv_opts.data_type,
            compress_dtype=recv_opts.compress_dtype,
            addr_0=send_opts.addr_0,
            addr_2=recv_opts.addr_2,
        )

    def _match_recv(self, options: CallOptions) -> BaseRequest:
        """A recv takes the oldest parked send of a matching signature and
        launches the pair, or parks until one arrives or the timeout
        (`self.timeout`, microseconds) lapses."""
        src = options.root_src_dst & 0xFFFF
        dst = (options.root_src_dst >> 16) & 0xFFFF
        with self._recv_mu:  # match-or-park is one atomic step
            match = None
            for key, queue in self._pending_sends.items():
                if self._matches(key, options, src, dst) and (
                        match is None
                        or queue[0][0] < self._pending_sends[match][0][0]):
                    match = key
            if match is None:
                req = ParkedRecvRequest(options, self.timeout / 1e6)
                self._park_seq += 1
                req._park_seq = self._park_seq
                key = (options.comm_addr, src, dst, options.tag)
                self._pending_recvs.setdefault(key, []).append(req)

                def unpark(_key=key, _req=req):
                    with self._recv_mu:
                        queue = self._pending_recvs.get(_key)
                        if queue is not None and _req in queue:
                            queue.remove(_req)
                            if not queue:
                                self._pending_recvs.pop(_key, None)

                req._unpark = unpark
                return req
            queue = self._pending_sends[match]
            _, send_opts = queue.pop(0)
            self._parked_send_count -= 1
            if not queue:
                self._pending_sends.pop(match, None)
        return self._launch(self._pair(options, send_opts))

    # -- kernel streams ------------------------------------------------------

    def stream_put(self, options: CallOptions) -> GPURequest:
        """The device-autonomous send: the stream producer registered under
        the descriptor's op0_stream_id makes the operand, a sendrecv over
        the exact wire moves rank src's row to dst, and the stream's
        consumer (identity when none is registered) maps the result, which
        lands in the result buffer (every row: dst's from src, the others
        their own produced rows)."""
        sid = options.op0_stream_id
        src = options.root_src_dst & 0xFFFF
        dst = (options.root_src_dst >> 16) & 0xFFFF
        res = self._buf(options.addr_2)
        prod = self.streams.producer(sid)
        cons = self.streams.consumer(sid)
        key = (sid, options.count, options.root_src_dst, options.data_type,
               id(prod), id(cons))
        fn = self._stream_cache.get(key)
        if fn is None:
            body = functools.partial(
                schedules.sendrecv_schedule, src=src, dst=dst,
                world=self.world, wire=self.compiler.flat_wire())
            body = splice_producer(body, prod, options.count,
                                   self.compiler.rank_rows())
            fn = self._stream_cache[key] = splice_consumer(body, cons)
        if res.device is None:  # host-only result: materialize first
            res.sync_to_device()
        ctx = self._comm_ctx(0)
        out, events, t0 = self._run(fn, [self._member_rows(
            res.device, ctx, options.count)])

        def place(req):
            res.device = self._place(res.device, ctx, out)

        return self._request("stream_put", out, events, t0, place)

    def dump_eager_rx_buffers(self) -> str:
        """The counterpart of the reference's rx-ring dump: this backend
        has no spare-buffer ring, so its eager state is the parked recv
        and send queues."""
        with self._recv_mu:
            lines = [
                f"eager rx (GPU executor): buf_size {self.eager_rx_buf_size}"
                f", parked sends {self._parked_send_count}"
                f"/{self.MAX_PARKED_SENDS}"
            ]
            for (ca, s, d, tag), q in sorted(self._pending_recvs.items()):
                for parked in q:
                    lines.append(
                        f"parked recv: comm {ca:#x} src {s} dst {d} "
                        f"tag {tag} seq {parked._park_seq}")
            for (ca, s, d, tag), q in sorted(self._pending_sends.items()):
                for seq, opts in q:
                    lines.append(
                        f"parked send: comm {ca:#x} src {s} dst {d} "
                        f"tag {tag} seq {seq} count {opts.count}")
        return "\n".join(lines)

    def predict_sequence_cost(self, prepared) -> float | None:
        """Predicted seconds for one dispatch of a prepared batch under
        the shipped default link (timing.predict_prepared over its frozen
        steps and plans, aggregate cost shape): the price a scheduler
        budgets a batch at. The link is the copied emulator fit, not a
        measurement of this card. None when no calibration is shipped or
        no step is priceable."""
        from ..sequencer.timing import predict_prepared
        from ..telemetry.feedback import default_link

        link = default_link()
        if link is None:
            return None
        try:
            return predict_prepared(
                link, prepared.desc.steps, prepared.plans,
                prepared.ctx.world,
                rx_buf_bytes=self.eager_rx_buf_size, aggregate=True)
        except (ValueError, KeyError, ZeroDivisionError):
            return None

    # -- call sequences ------------------------------------------------------

    def start_sequence(self, options_list, lint: str = "error",
                       persistent=frozenset()) -> SequenceRequest:
        """Execute a recorded batch of call descriptors as one prepared
        program: `prepare_sequence` then one `dispatch_sequence`.

        `lint` gates the batch through the static analyzer (analysis/)
        before anything is built: "error" rejects hazardous batches with
        a typed LintError, "warn" logs the diagnostics and proceeds,
        "off" skips the stage; "deep" adds the exhaustive-interleaving
        tier and enforces like "error". Verdicts are cached under the
        composite signature, so a re-recorded batch re-lints nothing.

        `persistent` (buffer addresses) declares device-resident state
        the batch refreshes partial-width by design: the hazard pass
        waives ACCL101 for those buffers only."""
        return self.dispatch_sequence(
            self.prepare_sequence(options_list, lint,
                                  persistent=persistent))

    def prepare_sequence(self, options_list, lint: str = "error",
                         persistent=frozenset()) -> "_PreparedSequence":
        """The resolve half of `start_sequence`: per-step plan selection
        with the live registers (read once for the batch), the lint gate,
        the dataflow resolution, the composed body and, on the card, its
        CUDA graph, captured over the bound buffers' current device
        images, and the batch's interference footprint. The handle pins
        the registers it was resolved under: re-prepare after retuning. A
        batch on a sub-communicator runs its steps over the member rows:
        its context's compiler and world."""
        desc = SequenceDescriptor(tuple(options_list))
        ctx = self._comm_ctx(desc.comm_addr)
        tuning = self.tuning()
        # the alltoall wire register rewrites descriptors before the
        # signature, lint and build see them, so all three key on what runs
        steps = tuple(self._apply_alltoall_wire(o, tuning)
                      for o in desc.steps)
        if steps != desc.steps:
            desc = SequenceDescriptor(steps)
        tracer = get_tracer()
        # a content digest of the composite signature, stable across runs
        # (enum hashes are salted per process); it tags every phase and
        # step span, so one batch's record -> lint -> compile -> dispatch
        # pipeline can be followed across tracks
        sig = hashlib.sha256(repr(desc.signature()).encode()).hexdigest()[:16]
        with tracer.span("record", cat="phase", track="device") as sp:
            sp.set(signature=sig, n_steps=len(desc.steps))
            plans, endpoints = [], []
            for opts in desc.steps:
                plan, producer, consumer = self._resolve_step(opts, ctx,
                                                              tuning)
                plans.append(plan)
                endpoints.append((producer, consumer))
        if lint != "off":
            with tracer.span("lint", cat="phase", track="device") as sp:
                sp.set(signature=sig, tier=lint)
                self._lint_batch(desc, tuple(plans), ctx, lint,
                                 persistent=frozenset(persistent))
        # compile covers the composed body and, on the card, its warm-up
        # run and CUDA-graph capture
        with tracer.span("compile", cat="phase", track="device") as sp:
            sp.set(signature=sig)
            seq = SequencePlan(desc, plans, ctx.world, endpoints)
            bufs = {addr: self._buf(addr) for addr in seq.buffer_addrs}
            for addr, need in seq.min_widths().items():
                have = bufs[addr].shape[-1]
                if have < need:
                    raise ValueError(
                        f"sequence needs {need} elements in buffer "
                        f"{addr:#x}, which holds {have}")
            fn = ctx.compiler.compile_sequence(seq)
            with self._launch_mu:
                # kernel-1 steps read and write in place on the default
                # world only (a sub-communicator's rows are a gather of
                # their own)
                graph = ctx.compiler.sequence_graph(
                    seq, fn, self._bound_tensors(seq, bufs, ctx),
                    in_place=ctx.rows is None)
        prepared = _PreparedSequence(desc=desc, plans=tuple(plans), seq=seq,
                                     graph=graph, bufs=bufs, ctx=ctx, sig=sig)
        # the interference summary rides every prepared program: pure
        # Python over the descriptors (the exact-event thunk defers any
        # lift to an escalated pair); the port's ring holds no slots
        from ..analysis.interference import footprint_from_steps

        prepared.footprint = footprint_from_steps(
            desc.steps, ctx.world, persistent=frozenset(persistent),
            use_pallas_ring=False, plans=tuple(plans), signature=sig)
        return prepared

    def _bound_tensors(self, seq, bufs, ctx) -> list[torch.Tensor]:
        """The current device image of every buffer of the batch's table
        (a host-only buffer is staged first), its member rows on a
        sub-communicator."""
        tensors = []
        for addr in seq.buffer_addrs:
            buf = bufs[addr]
            if buf.device is None:
                buf.sync_to_device()
            tensors.append(self._member_rows(buf.device, ctx,
                                             buf.device.shape[-1]))
        return tensors

    def dispatch_sequence(self, prepared: "_PreparedSequence"
                          ) -> SequenceRequest:
        """The dispatch half of `start_sequence`: bind the buffers'
        current device images, allocate the fresh results of the steps
        that write in place, stage what the graph cannot read in place
        and write its address table (SequenceGraph.load), replay it once
        (between two CUDA events on the card), clone what staged steps
        left in the graph's memory, and place the results at completion.
        Safe to call repeatedly on one handle, also before waiting on an
        earlier call: each is an independent request, whose bound
        tensors and results it holds until it completes.

        With the layer gate open (tracer.layering) the parts are layer
        spans: `bind` (args `n`, and `in_place` and `staged`: how many
        of the table's buffers the replay takes where they lie or never
        reads, and how many are copied in), `load` (the staged copies
        and the table write), `results` (the fresh allocations before
        the load and the clones after the replay, one span of their
        summed host time) and `markers` here, `place` at completion.
        `load` and `results` carry `copies` and `bytes`: device copies
        only, so the table write counts none. On the card they also carry
        their device time (`device_ns`), from one more CUDA event before
        the load (before the host builds the table's rows) and one after
        the clones, paired with the replay's own.
        Completion still waits on the replay's end alone, so the host's
        next dispatch overlaps the clones as it does untraced: `load` is
        emitted at completion, `results` at the first completion on this
        device after the card has passed its clones (in a closed loop,
        the next dispatch's). With the gate closed the dispatch records
        the replay's pair alone."""
        seq, graph, ctx = prepared.seq, prepared.graph, prepared.ctx
        tracer = get_tracer()
        on_card = graph.graph is not None
        timed = on_card and tracer.layering
        # on the card this span times the host seam: the replay is
        # enqueued and the span closes without waiting for it (the
        # request's CUDA events time the replay itself)
        with tracer.span("dispatch", cat="phase", track="device") as dispatch:
            dispatch.set(signature=prepared.sig)
            if prepared.cert is not None:
                # a certify_concurrent-stamped tenant: the flight recorder
                # can name the admitted set a wedged dispatch belonged to
                dispatch.set(interference_cert=prepared.cert)
            with tracer.layer("bind", n=len(seq.buffer_addrs)) as bind:
                binding = graph.bind(
                    self._bound_tensors(seq, prepared.bufs, ctx))
                bind.set(in_place=binding.in_place, staged=binding.staged)
            events = head = tail = None
            load = tracer.layer("load", deferred=True)
            results = tracer.layer("results", deferred=True)
            with self._launch_mu:
                t0 = time.perf_counter_ns()
                if on_card:
                    events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                with results:
                    graph.allocate(binding)
                if timed:
                    head = torch.cuda.Event(enable_timing=True)
                    head.record()
                with load:
                    graph.load(binding)
                if on_card:
                    events[0].record()
                    graph.replay()
                    events[1].record()
                else:
                    graph.replay()
                with results:
                    outs = graph.results(binding)
                if timed:
                    tail = torch.cuda.Event(enable_timing=True)
                    tail.record()
        out_bufs = [prepared.bufs[a] for a in seq.out_addrs]

        def place(req):
            nonlocal binding
            if load:
                load.set(copies=binding.staged, bytes=binding.nbytes)
                results.set(copies=len(graph.outputs),
                            bytes=graph.results_bytes)
                if head is None:
                    load.emit()
                    results.emit()
                else:
                    # the load's device time: before load to the
                    # replay's start, both passed at completion
                    load.set(device_ns=int(
                        head.elapsed_time(events[0]) * 1e6))
                    load.emit()
                    with self._copies_mu:
                        self._copies_out.append((results, events[1], tail))
            binding = None  # the bound tensors, held until now
            if self._copies_out:
                self._emit_copies_out()
            with tracer.layer("place", cause=dispatch, n=len(out_bufs)):
                for buf, out in zip(out_bufs, outs):
                    if buf.device is None:  # host-only result: materialize
                        buf.sync_to_device()
                    buf.device = self._place(buf.device, ctx, out)

        req = SequenceRequest(outs, prepared.plans, events,
                              on_complete=place)
        if events is None:
            req._start_time = t0  # host clock around the eager CPU run
        req.signature = prepared.sig
        if prepared.cert is not None:
            req.interference_cert = prepared.cert
        if tracer.active:
            # per-step instant markers: the steps run inside one dispatch,
            # so each carries its timing.predict estimate and the batch
            # signature, not a duration of its own. Predictions are a pure
            # function of the frozen (steps, plans): computed once a handle
            with tracer.layer("markers", n=len(prepared.plans)):
                if prepared.preds is None:
                    prepared.preds = [
                        self._predict_call(o, p, ctx.world)
                        for o, p in zip(prepared.desc.steps,
                                        prepared.plans)]
                preds = prepared.preds
                known = [p for p in preds if p is not None]
                req.predicted_s = sum(known) if known else None
                now = time.perf_counter_ns()
                for i, (o, p, pred) in enumerate(zip(prepared.desc.steps,
                                                     prepared.plans, preds)):
                    step_args = {
                        "op": o.scenario.name,
                        "count": o.count,
                        "step": i,
                        "world": ctx.world,
                        "algorithm": p.algorithm.name,
                        "protocol": p.protocol.name,
                        "signature": prepared.sig,
                    }
                    if pred is not None:
                        step_args["predicted_s"] = pred
                    tracer.emit(f"step{i}:{o.scenario.name}", "step",
                                "device", ts_ns=now, dur_ns=0,
                                args=step_args)
        return req

    def _emit_copies_out(self) -> None:
        """Emit, oldest first, each waiting `results` span whose clones
        the card has passed, with their device time (the replay's end to
        the event after the clones); one still running stops the walk.
        Nothing waits on the card."""
        with self._copies_mu:
            while self._copies_out and self._copies_out[0][2].query():
                span, start, end = self._copies_out.pop(0)
                span.set(device_ns=int(start.elapsed_time(end) * 1e6))
                span.emit()

    def _lint_batch(self, desc, plans, ctx, mode: str,
                    persistent: frozenset = frozenset()) -> None:
        """The static gate in front of compile_sequence. Diagnostics are
        cached by the batch's composite signature (the canonical renaming
        the compile cache keys on) with the registered widths and the
        persistent set in canonical order, and the arithmetic table's
        lanes (ACCL406 reads them), so steady state pays a dict lookup.
        Buffer widths come from the registry, enabling the static
        underflow check; the batch is linted at its communicator's world,
        with its plans (the semantic pass; "deep" adds the interleaving
        tier)."""
        from ..analysis.diagnostics import enforce
        from ..analysis.linter import SequenceLinter

        widths = {}
        canon: list[int] = []  # widths in canonical (renamed) order, so
        # the cache can never alias two batches whose buffers differ
        rename: dict[int, int] = {}  # addr -> canonical index, for the
        # persistent part of the key (addresses are arena-unique, so the
        # raw set would defeat cache hits across buffers)
        for opts in desc.steps:
            for addr in (opts.addr_0, opts.addr_1, opts.addr_2):
                if addr and addr not in rename:
                    rename[addr] = len(rename)
                buf = self.buffers.get(addr)
                if addr and buf is not None and addr not in widths:
                    widths[addr] = buf.shape[-1]
                    canon.append(widths[addr])
        canon_persist = tuple(sorted(
            rename[a] for a in persistent if a in rename))
        table = ctx.compiler.arith_table
        deep = mode == "deep"
        key = (desc.signature(), plans, ctx.world, tuple(canon),
               canon_persist, frozenset(table), deep)
        diags = self._lint_cache.get(key)
        if diags is None:
            # lint against the lanes this device lowers with: a custom
            # arith_config's rows reach the certifier's lift too
            linter = SequenceLinter(ctx.world, arith_table=table, deep=deep)
            diags = tuple(linter.lint(desc.steps, plans,
                                      buffer_widths=widths,
                                      persistent_addrs=persistent))
            self._lint_cache[key] = diags
        enforce(diags, mode)

    def wire_stats(self) -> dict:
        """The stats2 counter surface (STATS2_FIELDS), every field zero:
        one card has no native wire, so there are no wire faults to
        count, but consumers (telemetry.export.wire_health_report) read
        one dict shape across device kinds."""
        return {name: 0 for name in STATS2_FIELDS}

    # -- config calls ------------------------------------------------------

    def _config(self, options: CallOptions) -> BaseRequest:
        req = BaseRequest(f"config/{CfgFunc(options.function).name}")
        req.running()
        fn = CfgFunc(options.function)
        if fn == CfgFunc.reset_periph:
            # drain the parking maps: every parked recv times out
            with self._recv_mu:
                self._pending_sends.clear()
                self._parked_send_count = 0
                queues = list(self._pending_recvs.values())
                self._pending_recvs.clear()
            for queue in queues:
                for parked in queue:
                    if parked.claim():
                        parked._timeout_fire()
            self.compiler._cache.clear()
            self._lint_cache.clear()
            self._comm_cache.clear()
            self._comm_extents.clear()
            self._group_cache.clear()
        elif fn == CfgFunc.enable_pkt:
            self.pkt_enabled = True
        elif fn == CfgFunc.set_timeout:
            self.timeout = options.count
        elif fn == CfgFunc.set_max_eager_msg_size:
            # value arrives in the count field
            if options.count > self.eager_rx_buf_size:
                req.complete(int(ErrorCode.EAGER_THRESHOLD_INVALID))
                return req
            self.max_eager_size = options.count
        elif fn == CfgFunc.set_max_rendezvous_msg_size:
            self.max_rendezvous_size = options.count
        req.complete(0)
        return req



class _PreparedSequence:
    """A resolved and prepared descriptor batch, ready to dispatch any
    number of times (GPUDevice.prepare_sequence / dispatch_sequence):
    the batch, its per-step plans, the SequencePlan, the SequenceGraph
    of its composed body (on the card the captured CUDA graph), the
    bound buffer objects, re-read at every dispatch so their current
    device images flow in, and the communicator context it runs on.

    `preds` holds the per-step timing.predict estimates of a traced
    dispatch, computed at the first one. `footprint` is the batch's
    cross-program interference summary (analysis/interference.py) and
    `cert` the certificate of the certify_concurrent set it was last
    admitted into (None until then), which its dispatch spans carry."""

    __slots__ = ("desc", "plans", "seq", "graph", "bufs", "ctx", "sig",
                 "preds", "footprint", "cert")

    def __init__(self, desc, plans, seq, graph, bufs, ctx, sig):
        self.desc = desc
        self.plans = plans
        self.seq = seq
        self.graph = graph
        self.bufs = bufs
        self.ctx = ctx
        self.sig = sig
        self.preds = None
        self.footprint = None
        self.cert = None


class _CommCtx:
    """A resolved communicator: its size, its schedule compiler, and the
    member rows of full-world buffers with their device index tensor
    (both None for the default full-world communicator)."""

    __slots__ = ("world", "compiler", "rows", "index")

    def __init__(self, world: int, compiler: ScheduleCompiler,
                 rows: tuple[int, ...] | None,
                 index: torch.Tensor | None):
        self.world = world
        self.compiler = compiler
        self.rows = rows
        self.index = index
