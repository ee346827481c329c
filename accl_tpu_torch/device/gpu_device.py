"""GPUDevice: descriptor execution over virtual ranks on one card.

Counterpart of accl_tpu/device/tpu_device.py. TPUDevice resolves a
descriptor's buffers, selects a plan and launches the cached compiled
program over a mesh of chips. GPUDevice does the same for W virtual
ranks on one CUDA device (or on the CPU when the caller asks for it):
every buffer is a stacked (world, n) tensor, and one call executes the
collective for every rank. Completion is a CUDA event recorded after the
call's kernels instead of XLA's block_until_ready.

Every one-call collective is ported (copy, combine, bcast, scatter,
gather, allgather, reduce, allreduce, reduce_scatter, barrier), with
streamed operands (a registered producer/consumer spliced into the
body), and so are call sequences: a recorded batch is prepared once
(plans, the lint gate, the composed body, on the card one captured CUDA
graph) and dispatched as one graph replay. Point-to-point send/recv,
alltoall and sub-communicators raise NotImplementedError naming the
slice of the port that brings them.
"""

from __future__ import annotations

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
    ErrorCode,
    Operation,
    StreamFlags,
    TuningParams,
    dtype_nbytes,
)
from ..descriptor import CallOptions, SequenceDescriptor
from ..errors import not_ported
from ..ops.streams import StreamRegistry
from ..request import BaseRequest, GPURequest, SequenceRequest
from ..sequencer.lowering import ScheduleCompiler
from ..sequencer.plan import select_algorithm
from ..sequencer.sequence import (
    SequencePlan,
    place_into,
    slice_to,
    step_in_elems,
)
from .base import CCLOAddr, CCLODevice


class GPUDevice(CCLODevice):
    # the blockwise int8 wire runs the quantized torch-op ring, whose
    # per-hop steps are the kernels of ops/quant_kernels.py on the card
    supports_quantized_wire = True

    def __init__(self, world: int, torch_device: torch.device | str = "cuda"):
        super().__init__()
        torch_device = torch.device(torch_device)
        if torch_device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("GPUDevice on cuda needs a CUDA device")
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self._world = world
        self.torch_device = torch_device
        self.compiler = ScheduleCompiler(world, torch_device)
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
        # comm_addr -> validated full-world communicator table end
        self._comm_cache: dict[int, int] = {}
        # kernel-stream endpoints (OP0_STREAM / RES_STREAM)
        self.streams = StreamRegistry()
        # lint verdicts of call sequences, by composite signature
        self._lint_cache: dict[tuple, tuple] = {}

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

    def _comm_ctx(self, comm_addr: int) -> None:
        """Validate a descriptor's comm_addr against the rank table in
        exchange memory: comm_addr 0 or a full-world identity table is the
        default world. A sub-communicator raises until its slice."""
        if comm_addr == 0 or comm_addr in self._comm_cache:
            return
        from ..communicator import Communicator

        size = self.read(comm_addr)
        if not 0 < size <= self.world:
            raise ValueError(
                f"invalid communicator at {comm_addr:#x}: size={size}")
        nwords = 2 + size * Communicator.WORDS_PER_RANK
        words = [self.read(comm_addr + 4 * i) for i in range(nwords)]
        comm = Communicator.from_exchmem_words(words, comm_addr)
        members = tuple(r.device_index for r in comm.ranks)
        if members != tuple(range(self.world)):
            raise not_ported(
                f"the sub-communicator at {comm_addr:#x} (members "
                f"{members})", "communicators")
        self._comm_cache[comm_addr] = comm_addr + 4 * nwords

    def write(self, addr: int, value: int) -> None:
        # a write into a validated communicator table drops the cached
        # verdict (the table must be re-read per call once it changes)
        for start, end in list(self._comm_cache.items()):
            if start <= addr < end:
                self._comm_cache.pop(start, None)
        super().write(addr, value)

    # -- execution --------------------------------------------------------

    def start(self, options: CallOptions) -> BaseRequest:
        if options.scenario == Operation.config:
            return self._config(options)
        if options.scenario == Operation.nop:
            req = BaseRequest("nop")
            req.running()
            req.complete(0)
            return req
        if options.scenario in (Operation.send, Operation.recv):
            raise not_ported("send/recv matching", "point-to-point")
        return self._launch(options)

    def _resolve_step(self, options: CallOptions,
                      tuning: TuningParams | None = None):
        """Per-descriptor plan selection and stream-endpoint resolution:
        the one source for both the eager path and call sequences, so a
        sequence can never run other than what eager execution would.
        Returns (plan, producer, consumer)."""
        plan = select_algorithm(
            options.scenario,
            options.count,
            dtype_nbytes(options.data_type),
            self.world,
            options.compression_flags,
            options.stream_flags,
            max_eager_size=self.max_eager_size,
            eager_rx_buf_size=self.eager_rx_buf_size,
            tuning=tuning if tuning is not None else self.tuning(),
            compress_dtype=options.compress_dtype,
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
        self._comm_ctx(options.comm_addr)
        plan, producer, consumer = self._resolve_step(options, self.tuning())
        if options.stream_flags:
            fn = self.compiler.lower_streamed(options, plan, producer,
                                              consumer)
        else:
            fn = self.compiler.lower(options, plan)
        scen = options.scenario
        res = self._buf(options.addr_2)
        if scen == Operation.barrier:
            # the zero-payload notifications ride a one-element token
            args = [torch.ones((self.world, 1), dtype=torch.float32,
                               device=self.torch_device)]
        else:
            in_n = step_in_elems(options, self.world)
            args = [slice_to(self._buf(options.addr_0).device, in_n)]
            if scen == Operation.combine:
                args.append(slice_to(self._buf(options.addr_1).device, in_n))

        events = None
        with self._launch_mu:  # one collective in flight
            t0 = time.perf_counter_ns()
            if self.torch_device.type == "cuda":
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
                out = fn(*args)
                events[1].record()
            else:
                out = fn(*args)

        def place(req):
            if res is not None and scen != Operation.barrier:
                if res.device is None:  # host-only result: materialize first
                    res.sync_to_device()
                res.device = place_into(res.device, out)

        req = GPURequest(options.scenario.name, [out], events,
                         on_complete=place)
        if events is None:
            req._start_time = t0  # host clock around the eager CPU run
        req.plan = plan
        return req

    # -- call sequences ------------------------------------------------------

    def start_sequence(self, options_list, lint: str = "error",
                       persistent=frozenset()) -> SequenceRequest:
        """Execute a recorded batch of call descriptors as one prepared
        program: `prepare_sequence` then one `dispatch_sequence`.

        `lint` gates the batch through the static analyzer (analysis/)
        before anything is built: "error" rejects hazardous batches with
        a typed LintError, "warn" logs the diagnostics and proceeds,
        "off" skips the stage; "deep" (the reference's interleaving
        tier) raises not_ported. Verdicts are cached under the composite
        signature, so a re-recorded batch re-lints nothing.

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
        images. The handle pins the registers it was resolved under:
        re-prepare after retuning."""
        if lint == "deep":
            raise not_ported("the deep lint tier", "analysis")
        desc = SequenceDescriptor(tuple(options_list))
        self._comm_ctx(desc.comm_addr)
        tuning = self.tuning()
        # a content digest of the composite signature, stable across runs
        # (enum hashes are salted per process)
        sig = hashlib.sha256(repr(desc.signature()).encode()).hexdigest()[:16]
        plans, endpoints = [], []
        for opts in desc.steps:
            plan, producer, consumer = self._resolve_step(opts, tuning)
            plans.append(plan)
            endpoints.append((producer, consumer))
        if lint != "off":
            self._lint_batch(desc, tuple(plans), lint,
                             persistent=frozenset(persistent))
        seq = SequencePlan(desc, plans, self.world, endpoints)
        bufs = {addr: self._buf(addr) for addr in seq.buffer_addrs}
        for addr, need in seq.min_widths().items():
            have = bufs[addr].shape[-1]
            if have < need:
                raise ValueError(
                    f"sequence needs {need} elements in buffer "
                    f"{addr:#x}, which holds {have}")
        fn = self.compiler.compile_sequence(seq)
        with self._launch_mu:
            graph = self.compiler.sequence_graph(
                seq, fn, self._bound_tensors(seq, bufs))
        return _PreparedSequence(desc=desc, plans=tuple(plans), seq=seq,
                                 graph=graph, bufs=bufs, sig=sig)

    @staticmethod
    def _bound_tensors(seq, bufs) -> list[torch.Tensor]:
        """The current device image of every buffer of the batch's table
        (a host-only buffer is staged first)."""
        tensors = []
        for addr in seq.buffer_addrs:
            buf = bufs[addr]
            if buf.device is None:
                buf.sync_to_device()
            tensors.append(buf.device)
        return tensors

    def dispatch_sequence(self, prepared: "_PreparedSequence"
                          ) -> SequenceRequest:
        """The dispatch half of `start_sequence`: copy the bound buffers'
        current device images into the prepared graph's inputs, replay it
        once (between two CUDA events on the card), take the written
        buffers' values out of the graph's pool, and place them at
        completion. Safe to call repeatedly on one handle: each call is
        an independent request."""
        seq, graph = prepared.seq, prepared.graph
        tensors = self._bound_tensors(seq, prepared.bufs)
        events = None
        with self._launch_mu:
            t0 = time.perf_counter_ns()
            graph.load(tensors)
            if graph.graph is not None:
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
                graph.replay()
                events[1].record()
            else:
                graph.replay()
            outs = graph.results()
        out_bufs = [prepared.bufs[a] for a in seq.out_addrs]

        def place(req):
            for buf, out in zip(out_bufs, outs):
                if buf.device is None:  # host-only result: materialize
                    buf.sync_to_device()
                buf.device = place_into(buf.device, out)

        req = SequenceRequest(outs, prepared.plans, events,
                              on_complete=place)
        if events is None:
            req._start_time = t0  # host clock around the eager CPU run
        req.signature = prepared.sig
        return req

    def _lint_batch(self, desc, plans, mode: str,
                    persistent: frozenset = frozenset()) -> None:
        """The static gate in front of compile_sequence. Diagnostics are
        cached by the batch's composite signature (the canonical renaming
        the compile cache keys on) with the registered widths and the
        persistent set in canonical order, and the arithmetic table's
        lanes (ACCL406 reads them), so steady state pays a dict lookup.
        Buffer widths come from the registry, enabling the static
        underflow check."""
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
        table = self.compiler.arith_table
        key = (desc.signature(), plans, self.world, tuple(canon),
               canon_persist, frozenset(table))
        diags = self._lint_cache.get(key)
        if diags is None:
            linter = SequenceLinter(self.world, arith_table=table)
            diags = tuple(linter.lint(desc.steps, buffer_widths=widths,
                                      persistent_addrs=persistent))
            self._lint_cache[key] = diags
        enforce(diags, mode)

    # -- config calls ------------------------------------------------------

    def _config(self, options: CallOptions) -> BaseRequest:
        req = BaseRequest(f"config/{CfgFunc(options.function).name}")
        req.running()
        fn = CfgFunc(options.function)
        if fn == CfgFunc.reset_periph:
            self.compiler._cache.clear()
            self._comm_cache.clear()
            self._lint_cache.clear()
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
    of its composed body (on the card the captured CUDA graph) and the
    bound buffer objects, re-read at every dispatch so their current
    device images flow in.

    The reference's handle also carries `preds` (per-step timing.predict
    estimates for traced dispatches: the cost model and telemetry,
    ROADMAP items 9 and 13), `footprint` (the cross-program interference
    summary, item 15's interference pass) and `cert` (the certificate of
    a certify_concurrent set, which the scheduler admits against, item
    17). They stay None here until those slices."""

    __slots__ = ("desc", "plans", "seq", "graph", "bufs", "sig", "preds",
                 "footprint", "cert")

    def __init__(self, desc, plans, seq, graph, bufs, sig):
        self.desc = desc
        self.plans = plans
        self.seq = seq
        self.graph = graph
        self.bufs = bufs
        self.sig = sig
        self.preds = None
        self.footprint = None
        self.cert = None
