"""The ACCL facade of the PyTorch/CUDA port.

Counterpart of accl_tpu/accl.py. One controller drives a communicator of
`world` virtual ranks on one card: buffers are stacked (world, n)
tensors, and one call runs the collective for every rank.
`from_device`/`to_device` skip the host<->device syncs so chained calls
stay on the card, as in the reference.

The facade runs on the card unless the caller asks for the CPU:
`ACCL(world=8)` needs a CUDA device and raises without one;
`ACCL(world=8, torch_device="cpu")` runs every schedule's plain PyTorch
form on the CPU (what the tests use). The whole MPI-style surface is
ported: send/recv (paired on the host, in either order, by tag or
TAG_ANY), `stream_put`, copy, combine, bcast, scatter, gather,
allgather, reduce, allreduce, reduce_scatter, alltoall(v) and barrier,
on the exact, fp16/bf16 and blockwise-int8 wires, with streamed operands
(`op0_stream`/`res_stream` and the copy_*_stream forms over registered
producers and consumers), on the whole world or on a sub-communicator
(`split()`, then `comm=`), and call sequences (`sequence()`: record a
batch, compile it once, run it as one CUDA-graph replay on the card).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .arithconfig import DEFAULT_ARITH_CONFIG, validate_arith_config
from .buffers import BaseBuffer, DummyBuffer, GPUBuffer
from .communicator import Communicator, Rank
from .constants import (
    DEFAULT_EAGER_RX_BUF_SIZE,
    DEFAULT_MAX_EAGER_SIZE,
    DEFAULT_MAX_RENDEZVOUS_SIZE,
    DEFAULT_NUM_EAGER_RX_BUFS,
    CfgFunc,
    CompressionFlags,
    DataType,
    HostFlags,
    Operation,
    ReduceFunction,
    StreamFlags,
    TAG_ANY,
    TuningParams,
    dtype_nbytes,
    to_torch_dtype,
)
from .descriptor import CallOptions, normalize_live_ranks
from .device.base import CCLOAddr
from .device.gpu_device import GPUDevice
from .errors import (
    DtypeMismatchError,
    InvalidRootError,
    SequenceReuseError,
    ZeroLengthBufferError,
)
from .interop import tensor_from_numpy
from .request import BaseRequest
from .telemetry import get_tracer
from .sequencer.schedules import SlotRows
from .utils.logging import Log


class ACCL:
    """Driver facade over a device backend (reference ACCL class)."""

    def __init__(
        self,
        world: int | None = None,
        torch_device: torch.device | str | None = None,
        device=None,
        n_egr_rx_bufs: int = DEFAULT_NUM_EAGER_RX_BUFS,
        egr_rx_buf_size: int = DEFAULT_EAGER_RX_BUF_SIZE,
        max_eager_size: int = DEFAULT_MAX_EAGER_SIZE,
        max_rendezvous_size: int = DEFAULT_MAX_RENDEZVOUS_SIZE,
        arith_config: dict | None = None,
    ):
        if device is None:
            if world is None:
                raise ValueError("provide a world size or an explicit device backend")
            if torch_device is None:
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        "ACCL runs on a CUDA device and none is available; "
                        "pass torch_device='cpu' to run on the CPU")
                torch_device = "cuda"
            device = GPUDevice(world, torch_device)
        self.cclo = device
        self.arith_config = validate_arith_config(arith_config or DEFAULT_ARITH_CONFIG)
        self._config = dict(
            n_egr_rx_bufs=n_egr_rx_bufs,
            egr_rx_buf_size=egr_rx_buf_size,
            max_eager_size=max_eager_size,
            max_rendezvous_size=max_rendezvous_size,
        )
        self.communicators: list[Communicator] = []
        self._initialized = False
        self._last_request: BaseRequest | None = None
        # placeholder buffers of the buffer-less stream forms, by shape
        self._stream_scratch: dict = {}
        # the long-lived pairwise verdict cache of certify_concurrent (the
        # scheduler's admission shares it)
        self._interference = None
        # an armed resilience.ResilienceManager: every synchronous
        # data-plane call is checked against its derived deadline after it
        # completes (None: one attribute check a call)
        self._resilience = None
        self.initialize()

    # ------------------------------------------------------------------ #
    # bring-up
    # ------------------------------------------------------------------ #

    def initialize(self):
        if self._initialized:
            raise RuntimeError("ACCL already initialized (CFGRDY set)")
        cfg = self._config
        dev = self.cclo
        # rx-ring + threshold config words
        dev.write(CCLOAddr.EGR_RX_BUF_SIZE, cfg["egr_rx_buf_size"])
        dev.write(CCLOAddr.NUM_EGR_RX_BUFS, cfg["n_egr_rx_bufs"])
        dev.eager_rx_buf_size = cfg["egr_rx_buf_size"]
        # default communicator over the whole world; re-initialization
        # drops every earlier handle (their tables are laid out anew)
        self.communicators.clear()
        self._split_cache: dict[tuple[int, ...], Communicator] = {}
        world = dev.world
        ranks = [Rank(device_index=i, session_id=i) for i in range(world)]
        self.communicators.append(Communicator(ranks, 0, CCLOAddr.DYNAMIC_BASE))
        self._write_communicator(self.communicators[0])
        # arithmetic configs -> exchange memory
        addr = CCLOAddr.DYNAMIC_BASE + 4 * (2 + world * Communicator.WORDS_PER_RANK)
        for ac in self.arith_config.values():
            ac.set_exchmem(addr)
            for i, w in enumerate(ac.exchmem_words()):
                dev.write(addr + 4 * i, w)
            addr += 4 * ac.WORDS_PER_ROW
        # the dynamic region's allocation tail: split() lays out later
        # communicators from here
        self._exchmem_alloc = addr
        self.configure_tuning_parameters(
            TuningParams.default(cfg["max_rendezvous_size"]))
        # thresholds via config calls
        self._config_call(CfgFunc.set_max_eager_msg_size, cfg["max_eager_size"])
        self._config_call(CfgFunc.set_max_rendezvous_msg_size, cfg["max_rendezvous_size"])
        self._config_call(CfgFunc.enable_pkt, 0)
        dev.write(CCLOAddr.CFGRDY, 1)
        self._initialized = True

    def _config_call(self, fn: CfgFunc, value: int):
        req = self.cclo.call(
            CallOptions(scenario=Operation.config, function=int(fn), count=value)
        )
        req.check()

    def deinit(self):
        self._config_call(CfgFunc.reset_periph, 0)
        self.cclo.write(CCLOAddr.CFGRDY, 0)
        self._initialized = False

    def _write_communicator(self, comm: Communicator):
        for i, w in enumerate(comm.exchmem_words()):
            self.cclo.write(comm.exchmem_addr + 4 * i, w)

    def configure_tuning_parameters(self, tuning: TuningParams):
        """Write the algorithm-tuning registers to exchange memory; the
        device reads them back per call."""
        dev = self.cclo
        dev.write(CCLOAddr.GATHER_FLAT_TREE_MAX_FANIN,
                  tuning.gather_flat_tree_max_fanin)
        dev.write(CCLOAddr.GATHER_FLAT_TREE_MAX_COUNT,
                  tuning.gather_flat_tree_max_count)
        dev.write(CCLOAddr.BCAST_FLAT_TREE_MAX_RANKS,
                  tuning.bcast_flat_tree_max_ranks)
        dev.write(CCLOAddr.REDUCE_FLAT_TREE_MAX_RANKS,
                  tuning.reduce_flat_tree_max_ranks)
        dev.write(CCLOAddr.REDUCE_FLAT_TREE_MAX_COUNT,
                  tuning.reduce_flat_tree_max_count)
        dev.write(CCLOAddr.ALLREDUCE_COMPOSITION_MAX_COUNT,
                  tuning.allreduce_composition_max_count)
        dev.write(CCLOAddr.SYNTH_ALLREDUCE_MAX_COUNT,
                  tuning.synth_allreduce_max_count)
        dev.write(CCLOAddr.SYNTH_ALLGATHER_MAX_COUNT,
                  tuning.synth_allgather_max_count)
        dev.write(CCLOAddr.SYNTH_REDUCE_SCATTER_MAX_COUNT,
                  tuning.synth_reduce_scatter_max_count)
        dev.write(CCLOAddr.HIER_ALLREDUCE_MIN_COUNT,
                  tuning.hier_allreduce_min_count)
        dev.write(CCLOAddr.ALLTOALL_COMPRESS_MIN_COUNT,
                  tuning.alltoall_compress_min_count)
        dev.write(CCLOAddr.OVERLAP_MIN_COUNT, tuning.overlap_min_count)
        dev.write(CCLOAddr.SYNTH_LATENCY_MAX_COUNT,
                  tuning.synth_latency_max_count)

    def autotune(self, link=None, timing_model_path=None,
                 tier: str = "emulator",
                 wire_dtype: DataType = DataType.none,
                 tier_links=None, compute_fit=None) -> TuningParams:
        """Derive the tuning registers from the timing model and apply
        them, as the reference does: the flat switch points, the
        synthesized and latency-grid windows, the quantized-alltoall and
        overlap windows, and, on a device that declares a two-tier
        topology (GPUDevice(hier_topology=...)), the hierarchical window
        with its per-tier wire arbitration (`hier_wires`, for fp32 calls).

        `link` is a timing.LinkParams; absent, it is the emulator link of
        the model at `timing_model_path` (default: the port's copy of the
        shipped model, accl_tpu_torch/data/timing_model.json). That model
        was fitted on the reference's native emulator and a CPU mesh, so
        the windows it opens are the reference's, not measurements of
        this card. tier="tpu" reads the model's on-chip section
        (`tpu_tier`: the dispatch alpha and HBM stream rate), which the
        shipped copy does not carry: `python -m
        accl_tpu_torch.tools.timing_model --profile PROFILE.csv` fits it
        from a profile of the card (chip_smoke.py measures one), and a
        model without it raises ValueError. `wire_dtype` tunes for a workload on that
        compression lane (the byte registers stretch by the compression
        ratio). `tier_links` and `compute_fit` override the model's
        per-tier and compute calibrations. Returns the applied
        TuningParams."""
        import json
        import pathlib

        from .sequencer.timing import (
            LinkParams,
            emulator_link,
            tuning_crossovers,
        )
        from .telemetry.feedback import (
            MODEL_PATH,
            default_compute_fit,
            default_tier_links,
        )

        if tier not in ("emulator", "tpu"):
            raise ValueError(f"unknown autotune tier {tier!r}")
        if link is not None and tier != "emulator":
            raise ValueError("pass either link= or tier=, not both")
        if link is None:
            path = pathlib.Path(timing_model_path or MODEL_PATH)
            model = json.loads(path.read_text())
            if tier == "tpu":
                t = model.get("tpu_tier")
                if not t or not t.get("hbm_stream_gbps"):
                    raise ValueError(
                        "timing model has no usable tpu_tier; re-run "
                        "python -m accl_tpu_torch.tools.timing_model "
                        "--profile <the card's profile.csv>")
                link = LinkParams(alpha=t["dispatch_alpha_us"] * 1e-6,
                                  beta=t["hbm_stream_gbps"] * 1e9)
            else:
                link = emulator_link(model)
        topology = getattr(self.cclo, "hier_topology", None)
        if tier_links is None:
            tier_links = default_tier_links(timing_model_path)
        if compute_fit is None:
            compute_fit = default_compute_fit(timing_model_path)
        cross = tuning_crossovers(link, world=self.world,
                                  wire_dtype=wire_dtype,
                                  tier_links=tier_links,
                                  topology=topology,
                                  compute_fit=compute_fit)
        tuning = TuningParams.from_crossovers(cross)
        self.configure_tuning_parameters(tuning)
        # the tier wires ride the same tune: arbitrated at a clearly
        # bandwidth-bound payload (>= 1 MiB, never below the window's
        # floor) of fp32, the dtype the device applies them to
        if (tuning.hier_allreduce_min_count > 0 and topology is not None
                and tier_links is not None
                and hasattr(self.cclo, "hier_wires")):
            from .sequencer.plan import select_tier_wires

            cnt = max(tuning.hier_allreduce_min_count, 1 << 20) // 4
            self.cclo.hier_wires = select_tier_wires(
                cnt, DataType.float32, topology, tier_links,
                arith_table=self.arith_config,
                quantized_ok=getattr(self.cclo,
                                     "supports_quantized_wire", False))
        return tuning

    # ------------------------------------------------------------------ #
    # buffers
    # ------------------------------------------------------------------ #

    @property
    def world(self) -> int:
        return self.cclo.world

    def create_buffer(
        self, count: int, dtype: torch.dtype | DataType = torch.float32,
        data: torch.Tensor | np.ndarray | None = None, host_only: bool = False,
    ) -> GPUBuffer:
        """Allocate a stacked (world, count) rank buffer on the device.
        `data` (a tensor, or a numpy array as the reference's callers pass)
        is copied into the host mirror. host_only buffers live in host
        memory and are staged to the device around each call."""
        if isinstance(dtype, DataType):
            dtype = to_torch_dtype(dtype)
        if data is None:
            host = torch.zeros((self.world, count), dtype=dtype)
        else:
            if isinstance(data, np.ndarray):
                data = tensor_from_numpy(data)
            # always copy: the buffer owns its memory
            host = data.to("cpu", dtype).reshape(self.world, count).clone()
        buf_cls = getattr(self.cclo, "buffer_class", GPUBuffer)
        buf = buf_cls(host, self.cclo.torch_device, host_only=host_only)
        self.cclo.register_buffer(buf)
        return buf

    def free_buffer(self, buf: BaseBuffer):
        self.cclo.unregister_buffer(buf)

    # ------------------------------------------------------------------ #
    # prepare_call: dtype/compression resolution
    # ------------------------------------------------------------------ #

    def _prepare(
        self,
        scenario: Operation,
        op0: BaseBuffer | None,
        op1: BaseBuffer | None,
        res: BaseBuffer | None,
        count: int,
        root_src_dst: int = 0,
        function: int = 0,
        tag: int = TAG_ANY,
        compress_dtype: DataType | None = None,
        comm: Communicator | None = None,
    ) -> CallOptions:
        if comm is None:
            comm = self.communicators[0]
        elif comm not in self.communicators:
            raise ValueError("communicator does not belong to this ACCL")
        # roots and src/dst ranks are communicator-relative
        if scenario in (Operation.bcast, Operation.scatter, Operation.gather,
                        Operation.reduce):
            if not 0 <= root_src_dst < comm.size:
                raise InvalidRootError(
                    f"root {root_src_dst} outside communicator of {comm.size}")
        elif scenario in (Operation.send, Operation.recv):
            src, dst = root_src_dst & 0xFFFF, (root_src_dst >> 16) & 0xFFFF
            if src >= comm.size or dst >= comm.size:
                raise InvalidRootError(
                    f"src/dst ({src},{dst}) outside communicator of {comm.size}")
        if count <= 0 and scenario not in (Operation.barrier,
                                           Operation.config, Operation.nop):
            raise ZeroLengthBufferError(
                f"{scenario.name} with count {count}: data-plane calls "
                "need a positive element count")
        dtype = None
        for b in (op0, op1, res):
            if b is not None and not isinstance(b, DummyBuffer):
                if dtype is None:
                    dtype = b.data_type
                elif b.data_type != dtype:
                    raise DtypeMismatchError(
                        "mixed-dtype operands: use compress_dtype for wire "
                        "compression instead"
                    )
        comp = CompressionFlags.NO_COMPRESSION
        host = HostFlags.NO_HOST
        for b, flag in ((op0, HostFlags.OP0_HOST), (op1, HostFlags.OP1_HOST),
                        (res, HostFlags.RES_HOST)):
            if b is not None and getattr(b, "host_only", False):
                host |= flag
        arithcfg_addr = 0
        if dtype is not None:
            pair = (dtype, compress_dtype or dtype)
            if pair not in self.arith_config:
                raise ValueError(f"no arithmetic configuration for {pair}")
            if compress_dtype is not None and compress_dtype != dtype:
                from .ops.compression import is_quantized

                # a backend without the quantized lanes would degrade the
                # request to a cast, so refuse it host-side
                if is_quantized(self.arith_config[pair]) and not getattr(
                        self.cclo, "supports_quantized_wire", False):
                    raise NotImplementedError(
                        f"{type(self.cclo).__name__} has no blockwise-"
                        f"quantized wire lanes ({pair[0].name} -> "
                        f"{pair[1].name})")
                comp |= CompressionFlags.ETH_COMPRESSED
            arithcfg_addr = self.arith_config[pair].addr()
        return CallOptions(
            scenario=scenario,
            count=count,
            comm_addr=comm.exchmem_addr,
            root_src_dst=root_src_dst,
            function=function,
            tag=tag,
            arithcfg_addr=arithcfg_addr,
            compression_flags=comp,
            stream_flags=StreamFlags.NO_STREAM,
            host_flags=host,
            addr_0=0 if op0 is None else op0.address,
            addr_1=0 if op1 is None else op1.address,
            addr_2=0 if res is None else res.address,
            data_type=dtype or DataType.none,
            compress_dtype=compress_dtype or DataType.none,
        )

    def _stage_in(self, sync_in: list[BaseBuffer], from_device: bool):
        """Pre-launch host->device staging: host-only operands always
        stage; device buffers only without from_device residence."""
        for b in sync_in:
            if not from_device or getattr(b, "host_only", False):
                b.sync_to_device()

    def _complete(self, req, sync_out: list[BaseBuffer], to_device: bool,
                  run_async: bool):
        """Post-launch completion: async defers sync-out to wait()
        (host-only results still copy back under to_device); sync waits,
        checks and pulls results."""
        self._last_request = req
        if run_async:
            if to_device:
                req._accl_sync_out = [
                    b for b in sync_out if getattr(b, "host_only", False)
                ]
            else:
                req._accl_sync_out = sync_out
            return req
        req.wait()
        req.check()
        for b in sync_out:
            if not to_device or getattr(b, "host_only", False):
                b.sync_from_device()
        return req

    def _execute(
        self,
        opts: CallOptions,
        sync_in: list[BaseBuffer],
        sync_out: list[BaseBuffer],
        from_device: bool,
        to_device: bool,
        run_async: bool,
    ):
        # the armed resilience seam times a synchronous call end to end
        # (its completion waits on the request's CUDA event) for the
        # manager's post-completion deadline check; an async call has no
        # end-to-end time on the host
        mgr = self._resilience
        t0 = (time.perf_counter()
              if mgr is not None and not run_async else None)
        # tracer.span is the shared no-op when the tracer is inactive (one
        # predicate). The span is a host clock: a synchronous call's
        # covers its device time because _complete waits on the
        # request's CUDA event; an async call's closes at dispatch
        with get_tracer().span(opts.scenario.name, cat="call",
                               track="facade") as sp:
            self._stage_in(sync_in, from_device)
            Log.debug("call %s count=%d flags=c%x/s%x", opts.scenario.name,
                      opts.count, int(opts.compression_flags),
                      int(opts.stream_flags))
            req = self.cclo.start(opts)
            ret = self._complete(req, sync_out, to_device, run_async)
            if t0 is not None:
                mgr.observe_call(opts.scenario, opts.count,
                                 dtype_nbytes(opts.data_type)
                                 if opts.data_type != DataType.none else 4,
                                 time.perf_counter() - t0)
            tracer = get_tracer()
            if tracer.active:  # attach what the device resolved
                sp.set(op=opts.scenario.name, count=opts.count,
                       retcode=req.retcode)
                if run_async:
                    sp.set(dispatch_only=True)
                plan = getattr(req, "plan", None)
                if plan is not None:
                    sp.set(algorithm=plan.algorithm.name,
                           protocol=plan.protocol.name)
                # the estimate is read (on the card: computed) only where
                # something consumes it: the ring, or the drift sentinel
                # a synchronous call's span feeds; the metrics observer
                # skips a dispatch_only span
                if tracer.enabled or not run_async:
                    pred = getattr(req, "predicted_s", None)
                    if pred is not None:
                        sp.set(predicted_s=pred)
            return ret

    def wait(self, req: BaseRequest):
        """Complete an async request (sync-out deferred at start time)."""
        try:
            req.wait()
            req.check()
            for b in getattr(req, "_accl_sync_out", []):
                b.sync_from_device()
        finally:
            # release the private placeholder a run_async stream form rode
            # (a fresh _scratch), even when check() raises
            sc = getattr(req, "_accl_scratch", None)
            if sc is not None:
                self.free_buffer(sc)
                req._accl_scratch = None
        return req

    def get_duration_ns(self, req: BaseRequest | None = None) -> int:
        req = req or self._last_request
        return 0 if req is None else req.get_duration_ns()

    # ------------------------------------------------------------------ #
    # collectives
    # ------------------------------------------------------------------ #

    def _stream_opts(self, opts: CallOptions, op0_stream, res_stream):
        """Arm OP0_STREAM/RES_STREAM on a prepared descriptor (streams
        route through any collective). Stream ids ride dedicated
        descriptor bytes (word 8), leaving the tag free for matching."""
        if op0_stream is None and res_stream is None:
            return opts
        from .ops.streams import check_stream_id

        flags = StreamFlags.NO_STREAM
        if op0_stream is not None:
            flags |= StreamFlags.OP0_STREAM
            opts.op0_stream_id = check_stream_id(op0_stream)
        if res_stream is not None:
            flags |= StreamFlags.RES_STREAM
            opts.res_stream_id = check_stream_id(res_stream)
        opts.stream_flags = flags
        return opts

    def register_stream_producer(self, stream_id: int, fn):
        """Attach a device-side producer to a kernel stream (the PL
        kernel's data_to_cclo port). `fn(ranks)` gets the (world, 1)
        int64 tensor of rank indices and returns the stacked (world, n)
        operand (ops/streams.py). To ride a call sequence on the card it
        must be capturable into a CUDA graph: torch ops on the card only,
        with no host reads of device data, no synchronization and no
        copies from host memory."""
        self.cclo.streams.register_producer(stream_id, fn)

    def register_stream_consumer(self, stream_id: int, fn):
        """Attach a device-side consumer to a kernel stream: `fn` maps the
        stacked (world, n) result to the stacked result that lands in the
        result buffer. The same capturability rule as a producer's
        applies inside a call sequence on the card."""
        self.cclo.streams.register_consumer(stream_id, fn)

    def stream_put(self, count, stream_id, src, dst, recvbuf, *,
                   dtype=DataType.float32, run_async=False):
        """Device-autonomous send: the payload is made on the card by the
        producer registered on `stream_id`, moves from rank src to rank
        dst, passes the stream's consumer (if one is registered) and lands
        in recvbuf, with no host data path. Every row of recvbuf is
        written: dst's with src's produced row, the others with their own."""
        opts = CallOptions(
            scenario=Operation.send,
            count=count,
            root_src_dst=src | (dst << 16),
            op0_stream_id=stream_id,
            stream_flags=StreamFlags.OP0_STREAM,
            data_type=dtype,
            addr_2=recvbuf.address,
        )
        req = self.cclo.stream_put(opts)
        self._last_request = req
        if run_async:
            req._accl_sync_out = [recvbuf]
            return req
        req.wait()
        req.check()
        recvbuf.sync_from_device()
        return req

    def _scratch(self, count, dtype, fresh=False):
        """Internal placeholder buffer for a buffer-less stream endpoint
        (the dataType-only overloads of the reference driver), cached by
        (count, dtype); run_async callers pass fresh=True for a private
        one, released at wait()."""
        if isinstance(dtype, DataType):
            dtype = to_torch_dtype(dtype)
        if fresh:
            return self.create_buffer(count, dtype)
        key = (int(count), dtype)
        buf = self._stream_scratch.get(key)
        if buf is None:
            buf = self._stream_scratch[key] = self.create_buffer(count, dtype)
        return buf

    def nop(self):
        """A no-operation call through the device (the reference's
        nop): completes at once with retcode 0."""
        return self.cclo.call(CallOptions(scenario=Operation.nop))

    def copy(self, srcbuf, dstbuf, count, *, from_device=False,
             to_device=False, run_async=False):
        """dstbuf receives srcbuf's first count elements, on every rank."""
        opts = self._prepare(Operation.copy, srcbuf, None, dstbuf, count)
        return self._execute(opts, [srcbuf], [dstbuf], from_device,
                             to_device, run_async)

    def copy_from_stream(self, dstbuf, count, *, op0_stream, to_device=False,
                         run_async=False):
        """The operand comes from a registered producer stream, the
        result lands in dstbuf."""
        opts = self._prepare(Operation.copy, dstbuf, None, dstbuf, count)
        self._stream_opts(opts, op0_stream, None)
        return self._execute(opts, [dstbuf], [dstbuf], True, to_device,
                             run_async)

    def copy_to_stream(self, srcbuf, count, *, res_stream, dstbuf=None,
                       from_device=False, to_device=False,
                       run_async=False):
        """srcbuf routes through a registered consumer stream. The
        consumer's result lands in dstbuf when given, else in an internal
        placeholder; `to_device=True` skips the result's device->host
        sync even with a dstbuf."""
        fresh = dstbuf is None and run_async
        dst = dstbuf if dstbuf is not None else self._scratch(
            count, srcbuf.dtype, fresh=run_async)
        opts = self._prepare(Operation.copy, srcbuf, None, dst, count)
        self._stream_opts(opts, None, res_stream)
        req = self._execute(opts, [srcbuf], [dst], from_device,
                            to_device or dstbuf is None, run_async)
        if fresh:
            req._accl_scratch = dst
        return req

    def copy_from_to_stream(self, data_type, count, *, op0_stream, res_stream,
                            dstbuf=None, run_async=False):
        """Producer stream -> consumer stream with no user buffers;
        dstbuf optionally captures the consumer's result."""
        scratch = self._scratch(count, data_type, fresh=run_async)
        dst = dstbuf if dstbuf is not None else scratch
        opts = self._prepare(Operation.copy, scratch, None, dst, count)
        self._stream_opts(opts, op0_stream, res_stream)
        req = self._execute(opts, [scratch], [dst], True,
                            dstbuf is None, run_async)
        if run_async:
            req._accl_scratch = scratch
        return req

    def combine(self, count, function, op0, op1, res, *, from_device=False,
                to_device=False, run_async=False):
        """res = op0 (SUM/MAX) op1 elementwise, on every rank."""
        opts = self._prepare(Operation.combine, op0, op1, res, count,
                             function=int(function))
        return self._execute(opts, [op0, op1], [res], from_device,
                             to_device, run_async)

    def send(self, srcbuf, count, src, dst, tag=TAG_ANY, *, from_device=False,
             run_async=False, compress_dtype=None, comm=None,
             op0_stream=None):
        """Rank src sends count elements of its srcbuf row to rank dst
        (communicator-relative ranks). The send parks until its recv
        arrives; its operand is read when the pair runs. srcbuf may be a
        DataType when op0_stream is set: the payload then comes from the
        stream's producer."""
        fresh = False
        if isinstance(srcbuf, DataType):
            if op0_stream is None:
                raise ValueError("dataType-only send requires op0_stream")
            srcbuf = self._scratch(count, srcbuf, fresh=run_async)
            from_device = True
            fresh = run_async
        opts = self._prepare(Operation.send, srcbuf, None, None, count,
                             root_src_dst=src | (dst << 16), tag=tag,
                             compress_dtype=compress_dtype, comm=comm)
        self._stream_opts(opts, op0_stream, None)
        req = self._execute(opts, [srcbuf], [], from_device, True, run_async)
        if fresh:
            req._accl_scratch = srcbuf
        return req

    def recv(self, dstbuf, count, src, dst, tag=TAG_ANY, *, to_device=False,
             run_async=False, compress_dtype=None, comm=None,
             res_stream=None):
        """Rank dst receives count elements from rank src into its dstbuf
        row, pairing with a parked send of a matching (src, dst, tag), or
        parking until one arrives or the timeout (set_timeout) lapses.
        Every row of dstbuf is written: dst's with src's payload, every
        other rank's with its own send-buffer row. dstbuf may be a
        DataType when res_stream is set: the payload then only feeds the
        stream's consumer."""
        fresh = False
        if isinstance(dstbuf, DataType):
            if res_stream is None:
                raise ValueError("dataType-only recv requires res_stream")
            dstbuf = self._scratch(count, dstbuf, fresh=run_async)
            to_device = True  # nothing observes the placeholder
            fresh = run_async
        opts = self._prepare(Operation.recv, None, None, dstbuf, count,
                             root_src_dst=src | (dst << 16), tag=tag,
                             compress_dtype=compress_dtype, comm=comm)
        self._stream_opts(opts, None, res_stream)
        req = self._execute(opts, [], [dstbuf], True, to_device, run_async)
        if fresh:
            req._accl_scratch = dstbuf
        return req

    def bcast(self, buf, count, root, *, from_device=False, to_device=False,
              run_async=False, compress_dtype=None, comm=None,
              op0_stream=None, res_stream=None):
        """Every rank's buf receives root's."""
        opts = self._prepare(Operation.bcast, buf, None, buf, count,
                             root_src_dst=root, compress_dtype=compress_dtype,
                             comm=comm)
        self._stream_opts(opts, op0_stream, res_stream)
        return self._execute(opts, [buf], [buf], from_device, to_device,
                             run_async)

    def scatter(self, sendbuf, recvbuf, count, root, *, from_device=False,
                to_device=False, run_async=False, compress_dtype=None,
                comm=None, op0_stream=None, res_stream=None):
        """Rank j's recvbuf receives chunk j (count elements) of root's
        sendbuf of world*count elements."""
        opts = self._prepare(Operation.scatter, sendbuf, None, recvbuf, count,
                             root_src_dst=root, compress_dtype=compress_dtype,
                             comm=comm)
        self._stream_opts(opts, op0_stream, res_stream)
        return self._execute(opts, [sendbuf], [recvbuf], from_device,
                             to_device, run_async)

    def gather(self, sendbuf, recvbuf, count, root, *, from_device=False,
               to_device=False, run_async=False, compress_dtype=None,
               comm=None, op0_stream=None, res_stream=None):
        """Root's recvbuf (world*count elements) receives every rank's
        sendbuf, chunk j from rank j."""
        opts = self._prepare(Operation.gather, sendbuf, None, recvbuf, count,
                             root_src_dst=root, compress_dtype=compress_dtype,
                             comm=comm)
        self._stream_opts(opts, op0_stream, res_stream)
        return self._execute(opts, [sendbuf], [recvbuf], from_device,
                             to_device, run_async)

    def allgather(self, sendbuf, recvbuf, count, *, from_device=False,
                  to_device=False, run_async=False, compress_dtype=None,
                  comm=None, op0_stream=None, res_stream=None):
        """Every rank's recvbuf (world*count elements) receives every
        rank's sendbuf, chunk j from rank j."""
        opts = self._prepare(Operation.allgather, sendbuf, None, recvbuf,
                             count, compress_dtype=compress_dtype, comm=comm)
        self._stream_opts(opts, op0_stream, res_stream)
        return self._execute(opts, [sendbuf], [recvbuf], from_device,
                             to_device, run_async)

    def reduce(self, sendbuf, recvbuf, count, root, function, *,
               from_device=False, to_device=False, run_async=False,
               compress_dtype=None, comm=None, op0_stream=None,
               res_stream=None):
        """Root's recvbuf receives the elementwise reduction (SUM/MAX) of
        every rank's sendbuf."""
        opts = self._prepare(Operation.reduce, sendbuf, None, recvbuf, count,
                             root_src_dst=root, function=int(function),
                             compress_dtype=compress_dtype, comm=comm)
        self._stream_opts(opts, op0_stream, res_stream)
        return self._execute(opts, [sendbuf], [recvbuf], from_device,
                             to_device, run_async)

    def allreduce(self, sendbuf, recvbuf, count, function, *,
                  from_device=False, to_device=False, run_async=False,
                  compress_dtype=None, comm=None, op0_stream=None,
                  res_stream=None, mode="all", live_ranks=None):
        """Every rank's recvbuf receives the elementwise reduction
        (ReduceFunction SUM/MAX) of all ranks' sendbufs. compress_dtype
        names a wire dtype: fp16/bf16 (cast lanes), or int8 on float32
        buffers, the blockwise-quantized wire (int8 codes plus one fp32
        scale per 256 elements on every hop, ~3.9x fewer wire bytes; each
        element's result is within W quantization passes of the exact
        sum, and identical on every rank). An int8 call is always eager,
        cut into egr_rx_buf_size/4-element segments, so large calls want
        an ACCL built with a large egr_rx_buf_size.

        mode="live_subset" is the certified degraded form: `live_ranks`
        declares the surviving contributors, every other rank's operand is
        masked to exact zeros at the source inside the schedule (the
        torch-op ring), and the semantic certifier proves the answer sums
        exactly the survivors. SUM only, exact wire only; a full survivor
        set is the ordinary allreduce, bit for bit."""
        opts = self._prepare(Operation.allreduce, sendbuf, None, recvbuf,
                             count, function=int(function),
                             compress_dtype=compress_dtype, comm=comm)
        opts.live_ranks = self._live_subset(mode, live_ranks, function,
                                            compress_dtype, comm)
        self._stream_opts(opts, op0_stream, res_stream)
        return self._execute(opts, [sendbuf], [recvbuf], from_device,
                             to_device, run_async)

    def _live_subset(self, mode, live_ranks, function, compress_dtype,
                     comm) -> tuple:
        """Validate the degraded-mode arguments before anything is built
        or launched; returns the descriptor's normalized live_ranks, ()
        for the ordinary collective."""
        if mode not in ("all", "live_subset"):
            raise ValueError(
                f"allreduce mode must be 'all'|'live_subset', got {mode!r}")
        if mode == "all":
            if live_ranks is not None:
                raise ValueError("live_ranks requires mode='live_subset'")
            return ()
        if not live_ranks:
            raise ValueError(
                "mode='live_subset' needs a non-empty live_ranks set")
        comm_size = (comm or self.communicators[0]).size
        lr = normalize_live_ranks(live_ranks, comm_size)
        if ReduceFunction(function) != ReduceFunction.SUM:
            raise ValueError(
                "live-subset allreduce is SUM-only: the zero mask is the "
                "fold identity for SUM, nothing else is certified")
        if compress_dtype is not None:
            raise NotImplementedError(
                "live-subset allreduce is exact-wire only")
        if lr == tuple(range(comm_size)):
            return ()  # every rank lives: the ordinary allreduce's program
        if not getattr(self.cclo, "supports_live_subset", False):
            raise NotImplementedError(
                f"{type(self.cclo).__name__} has no masked live-subset "
                "ring; the degraded allreduce needs the torch-op ring")
        return lr

    def reduce_scatter(self, sendbuf, recvbuf, count, function, *,
                       from_device=False, to_device=False, run_async=False,
                       compress_dtype=None, comm=None, op0_stream=None,
                       res_stream=None):
        """Rank j's recvbuf (count elements) receives chunk j of the
        elementwise reduction of every rank's sendbuf (world*count)."""
        opts = self._prepare(Operation.reduce_scatter, sendbuf, None, recvbuf,
                             count, function=int(function),
                             compress_dtype=compress_dtype, comm=comm)
        self._stream_opts(opts, op0_stream, res_stream)
        return self._execute(opts, [sendbuf], [recvbuf], from_device,
                             to_device, run_async)

    def alltoall(self, sendbuf, recvbuf, count, *, from_device=False,
                 to_device=False, run_async=False, compress_dtype=None,
                 comm=None, op0_stream=None, res_stream=None):
        """Slot j (count elements) of rank i's sendbuf lands in slot i of
        rank j's recvbuf; both buffers hold world*count elements."""
        opts = self._prepare(Operation.alltoall, sendbuf, None, recvbuf,
                             count, compress_dtype=compress_dtype, comm=comm)
        self._stream_opts(opts, op0_stream, res_stream)
        return self._execute(opts, [sendbuf], [recvbuf], from_device,
                             to_device, run_async)

    def alltoallv(self, sendbuf, recvbuf, count, send_counts, *,
                  from_device=False, to_device=False, run_async=False,
                  compress_dtype=None, comm=None, op0_stream=None,
                  res_stream=None):
        """Capacity-bounded all-to-all (the MoE dispatch): alltoall's slot
        layout, but peer p receives only the first send_counts[p] elements
        of each source's slot p, its capacity, and the rest of the slot is
        zero (dropped at the source; each hop moves max(send_counts)
        elements). An all-count vector is the dense alltoall, bitwise.

        `send_counts` may instead be a sequencer.schedules.SlotRows: the
        slot-driven, dropless form, whose row placement is a device
        tensor that a producer writes on the card (an MoE router, inside
        the same recorded sequence), so that nothing is read back.
        `count` is then the width of a row, and the buffers hold the
        layout's rows a rank (`in_rows`, `out_rows`)."""
        opts = self._prepare_alltoallv(sendbuf, recvbuf, count, send_counts,
                                       compress_dtype=compress_dtype,
                                       comm=comm)
        self._stream_opts(opts, op0_stream, res_stream)
        return self._execute(opts, [sendbuf], [recvbuf], from_device,
                             to_device, run_async)

    def _prepare_alltoallv(self, sendbuf, recvbuf, count, send_counts, *,
                           compress_dtype=None, comm=None) -> CallOptions:
        """The alltoallv descriptor: the dense alltoall's plus the per-peer
        capacity vector, validated here so a bad vector fails before
        anything is built."""
        comm_size = (comm or self.communicators[0]).size
        if isinstance(send_counts, SlotRows):
            return self._prepare_slots(sendbuf, recvbuf, count,
                                         send_counts, compress_dtype, comm,
                                         comm_size)
        pc = tuple(int(c) for c in send_counts)
        if len(pc) != comm_size:
            raise ValueError(
                f"alltoallv needs one send count per rank: got {len(pc)} "
                f"for communicator of {comm_size}")
        if any(c <= 0 for c in pc):
            raise ZeroLengthBufferError(
                f"alltoallv send counts {pc} include a non-positive "
                "capacity; every peer needs a positive valid prefix")
        if any(c > count for c in pc):
            raise ValueError(
                f"alltoallv send counts {pc} exceed the {count}-element "
                "peer slot")
        if all(c == count for c in pc):
            # an all-full vector is the dense alltoall: normalized here, so
            # the signature and the built body are shared with it
            pc = ()
        if pc and not getattr(self.cclo, "supports_alltoallv", False):
            raise NotImplementedError(
                f"{type(self.cclo).__name__} has no capacity-masked "
                "alltoallv rotation")
        opts = self._prepare(Operation.alltoall, sendbuf, None, recvbuf,
                             count, compress_dtype=compress_dtype, comm=comm)
        opts.peer_counts = pc
        return opts

    def _prepare_slots(self, sendbuf, recvbuf, count, layout,
                         compress_dtype, comm, comm_size) -> CallOptions:
        """The slot-driven alltoallv's descriptor: the dense alltoall's
        plus its device layout, checked against the buffers here."""
        if comm_size != self.world or layout.slot_row.shape[0] != self.world:
            raise ValueError(
                "a slot-driven alltoallv runs over the whole world: "
                f"communicator of {comm_size}, layout of "
                f"{layout.slot_row.shape[0]} ranks, world {self.world}")
        if count != layout.width:
            raise ValueError(f"count {count} is not the layout's row width "
                             f"{layout.width}")
        if not getattr(self.cclo, "supports_slot_alltoallv", False):
            raise NotImplementedError(
                f"{type(self.cclo).__name__} has no slot-driven alltoallv")
        opts = self._prepare(Operation.alltoall, sendbuf, None, recvbuf,
                             count, compress_dtype=compress_dtype, comm=comm)
        opts.row_layout = layout
        return opts

    def barrier(self, comm=None):
        """Returns once every rank has entered the barrier."""
        opts = self._prepare(Operation.barrier, None, None, None, 0, comm=comm)
        req = self.cclo.start(opts)
        req.wait()
        req.check()
        return req

    # ------------------------------------------------------------------ #
    # communicators
    # ------------------------------------------------------------------ #

    def split(self, rank_indices: list[int]) -> Communicator:
        """A sub-communicator over a subset of ranks: its rank table is
        written to exchange memory and its handle can be passed as `comm=`
        to any collective or to sequence(). Buffers stay full-world
        stacked tensors; a sub-communicator call touches only its member
        rows, and its roots and src/dst ranks are its own (rank i is
        rank_indices[i]). Repeated splits of one member list return the
        same handle."""
        if len(set(rank_indices)) != len(rank_indices):
            raise ValueError("duplicate ranks in split")
        if not all(0 <= r < self.world for r in rank_indices):
            raise ValueError(f"split ranks outside world of {self.world}")
        cached = self._split_cache.get(tuple(rank_indices))
        if cached is not None and cached in self.communicators:
            return cached
        parent = self.communicators[0].ranks
        # backend constraints fail before any exchange memory is allocated
        self.cclo.validate_split(
            tuple(parent[r].device_index for r in rank_indices))
        ranks = [dataclasses.replace(parent[r], inbound_seq=0,
                                     outbound_seq=0) for r in rank_indices]
        nwords = 2 + len(ranks) * Communicator.WORDS_PER_RANK
        if self._exchmem_alloc + 4 * nwords > CCLOAddr.DYNAMIC_END:
            raise MemoryError("exchange memory exhausted by communicators")
        comm = Communicator(ranks, 0, self._exchmem_alloc)
        self._exchmem_alloc += 4 * nwords
        self.communicators.append(comm)
        self._write_communicator(comm)
        self._split_cache[tuple(rank_indices)] = comm
        return comm

    def get_comm_group(self, comm: Communicator | None = None) -> list[Rank]:
        """The communicator's rank table as the device holds it, read back
        from exchange memory (not the facade's cached object)."""
        comm = comm or self.communicators[0]
        n_words = 2 + Communicator.WORDS_PER_RANK * comm.size
        words = [self.cclo.read(comm.exchmem_addr + 4 * i)
                 for i in range(n_words)]
        return Communicator.from_exchmem_words(
            words, exchmem_addr=comm.exchmem_addr).ranks

    # ------------------------------------------------------------------ #
    # housekeeping and observability
    # ------------------------------------------------------------------ #

    def set_timeout(self, value: int):
        """How long (microseconds) a recv waits for its send."""
        self._config_call(CfgFunc.set_timeout, value)

    def set_max_eager_size(self, value: int):
        self._config_call(CfgFunc.set_max_eager_msg_size, value)

    def set_max_rendezvous_size(self, value: int):
        self._config_call(CfgFunc.set_max_rendezvous_msg_size, value)

    def dump_exchange_memory(self) -> str:
        return self.cclo.dump_exchange_memory()

    def dump_communicator(self, index: int = 0) -> str:
        return self.communicators[index].dump()

    def dump_eager_rx_buffers(self) -> str:
        """The eager rx state: on this backend the parked recv and send
        queues."""
        return self.cclo.dump_eager_rx_buffers()

    def arm_resilience(self, manager) -> None:
        """Arm per-call deadlines on this facade with a
        resilience.ResilienceManager that holds a DeadlinePolicy: every
        synchronous data-plane call is checked against its derived
        deadline after it completes, and a miss becomes a DeadlineMissed
        verdict on the manager (flight-recorder post-mortem attached); it
        never fails the completed call. The first call of each shape is a
        warm-up and is not checked (on the card it builds the kernels and
        schedules). `arm_resilience(None)` disarms."""
        self._resilience = manager

    def soft_reset(self):
        """The reset_periph config call: drains parked sends and recvs
        (each parked recv completes with RECEIVE_TIMEOUT_ERROR) and the
        built-schedule caches, leaving the device configured (unlike
        deinit, which also clears CFGRDY)."""
        self._config_call(CfgFunc.reset_periph, 0)
        # the schedules are rebuilt at their next call: an armed manager
        # exempts each shape's next call again
        if self._resilience is not None:
            self._resilience.reset_warmup()

    # ------------------------------------------------------------------ #
    # call sequences: record a batch, dispatch it as one program
    # ------------------------------------------------------------------ #

    def sequence(self, comm: Communicator | None = None,
                 lint: str = "error",
                 persistent=()) -> "SequenceRecorder":
        """Start recording a call sequence: collective/copy/combine calls
        on the returned recorder queue descriptors host-side (nothing
        executes), then `run()` (or `compile()` and `SequenceProgram.run()`)
        runs the whole batch as one prepared program: on the card one
        CUDA-graph replay, intermediates threaded on the card between
        steps, stream endpoints spliced at the seams. Usable as a context
        manager (the batch runs on clean exit)::

            with accl.sequence() as seq:
                seq.reduce_scatter(a, b, n, ReduceFunction.SUM)
                seq.allgather(b, c, n)
            # one dispatch happened; results are in b and c

        Results are bitwise the same as issuing the same calls eagerly
        back to back.

        `lint` runs the batch through the static analyzer (analysis/)
        before it is built: "error" (default) raises errors.LintError on
        hazardous batches, "warn" logs the diagnostics and proceeds,
        "off" opts out. "deep" adds the exhaustive-interleaving tier
        (each step's hops model-checked over every legal match order) and
        enforces like "error".

        `persistent` declares device-resident state buffers: buffers
        whose tails carry results from one dispatch to the next (a KV
        cache, an optimizer state), refreshed partial-width inside the
        batch by design. The hazard pass waives ACCL101 for exactly
        those buffers."""
        if lint not in ("error", "warn", "off", "deep"):
            raise ValueError(
                f"lint must be 'error'|'warn'|'off'|'deep', got {lint!r}")
        return SequenceRecorder(self, comm, lint=lint,
                                persistent=persistent)

    def certify_concurrent(self, programs, mode: str = "error"):
        """Prove a set of compiled SequencePrograms safe to dispatch
        CONCURRENTLY: pairwise non-interference over their footprint
        summaries (O(N^2) dict-sized checks), escalating a pair to the
        bounded cross-program product model check only when its
        summaries overlap (analysis/interference.py, ACCL601-604).

        A clean verdict means any interleaving of the set is equivalent
        to its serial composition. On success every program is stamped
        with the set's certificate id (`SequenceProgram.certificate`),
        which then rides its dispatch spans.

        `programs` may mix SequenceProgram handles and raw
        ProgramFootprint summaries. `mode` follows the lint gate: "error"
        raises LintError on findings, "warn" logs them, "off" skips
        enforcement; all modes return the diagnostic list. Verdicts are
        cached per pair on this ACCL, keyed by the two footprint
        signatures."""
        from .analysis.diagnostics import enforce
        from .analysis.interference import (
            InterferenceCertifier,
            ProgramFootprint,
            certificate_id,
        )

        if self._interference is None:
            self._interference = InterferenceCertifier()
        footprints = []
        handles = []
        for p in programs:
            if isinstance(p, ProgramFootprint):
                footprints.append(p)
                continue
            fp = getattr(p, "footprint", None)
            if fp is None:
                raise ValueError(
                    f"{type(p).__name__} carries no interference "
                    "footprint (pass SequenceProgram handles or "
                    "ProgramFootprint summaries)")
            footprints.append(fp)
            handles.append(p)
        diags = self._interference.certify(footprints)
        if not diags:
            cert = certificate_id(footprints)
            for h in handles:
                h._prepared.cert = cert
        enforce(diags, mode)
        return diags

    def scheduler(self, **kwargs) -> "MultiTenantScheduler":
        """A multi-tenant scheduler over this facade (scheduler/):
        admission with interference certificates (sharing this facade's
        certifier, so verdicts cached by certify_concurrent serve admission
        and back), strict priority classes with weighted fair queueing
        over predicted cost, typed backpressure, and per-tenant accounting
        through the metrics registry. Keywords go to
        MultiTenantScheduler (capacity_s, registry, ...)."""
        from .scheduler import MultiTenantScheduler

        return MultiTenantScheduler(self, **kwargs)


class SequenceRecorder:
    """Records a batch of collective/copy/combine descriptors host-side:
    each method queues the same descriptor its eager ACCL counterpart
    would dispatch, and `run()` hands the whole batch to the device for
    one prepare + dispatch (GPUDevice.start_sequence). Methods return the
    recorder, so chains compose; send/recv and barrier cannot ride a
    sequence (host-paired / payload-free)."""

    def __init__(self, accl: ACCL, comm: Communicator | None = None,
                 lint: str = "error", persistent=()):
        self._accl = accl
        self._comm = comm
        self._lint = lint
        # declared device-resident state buffers (the ACCL101 waiver), as
        # addresses: the layer the hazard pass renames from
        self._persistent = frozenset(b.address for b in persistent)
        self.calls: list[CallOptions] = []
        self._reads: list[list[BaseBuffer]] = []  # per-step operands
        self._writes: list[list[BaseBuffer]] = []  # per-step results
        self._ran = False

    def __len__(self) -> int:
        return len(self.calls)

    def __enter__(self) -> "SequenceRecorder":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and self.calls and not self._ran:
            self.run()
        return False

    def _record(self, opts: CallOptions, reads, writes) -> "SequenceRecorder":
        if self._ran:
            raise SequenceReuseError(
                "sequence already executed; record a new one")
        self.calls.append(opts)
        self._reads.append(list(reads))
        self._writes.append(list(writes))
        return self

    def _prep(self, scenario, op0, op1, res, count, op0_stream=None,
              res_stream=None, **kw):
        opts = self._accl._prepare(scenario, op0, op1, res, count,
                                   comm=self._comm, **kw)
        return self._accl._stream_opts(opts, op0_stream, res_stream)

    # -- recorded forms of the facade's data-plane calls -------------------

    def copy(self, srcbuf, dstbuf, count, *, op0_stream=None,
             res_stream=None):
        """Recorded copy; `res_stream` routes the result through a
        registered consumer before it lands in dstbuf (the recorded form
        of copy_to_stream), `op0_stream` takes the operand from a
        producer (copy_from_stream)."""
        opts = self._prep(Operation.copy, srcbuf, None, dstbuf, count,
                          op0_stream, res_stream)
        return self._record(opts, [srcbuf], [dstbuf])

    def combine(self, count, function, op0, op1, res):
        opts = self._prep(Operation.combine, op0, op1, res, count,
                          function=int(function))
        return self._record(opts, [op0, op1], [res])

    def bcast(self, buf, count, root, *, compress_dtype=None,
              op0_stream=None, res_stream=None):
        opts = self._prep(Operation.bcast, buf, None, buf, count,
                          op0_stream, res_stream, root_src_dst=root,
                          compress_dtype=compress_dtype)
        return self._record(opts, [buf], [buf])

    def scatter(self, sendbuf, recvbuf, count, root, *, compress_dtype=None,
                op0_stream=None, res_stream=None):
        opts = self._prep(Operation.scatter, sendbuf, None, recvbuf, count,
                          op0_stream, res_stream, root_src_dst=root,
                          compress_dtype=compress_dtype)
        return self._record(opts, [sendbuf], [recvbuf])

    def gather(self, sendbuf, recvbuf, count, root, *, compress_dtype=None,
               op0_stream=None, res_stream=None):
        opts = self._prep(Operation.gather, sendbuf, None, recvbuf, count,
                          op0_stream, res_stream, root_src_dst=root,
                          compress_dtype=compress_dtype)
        return self._record(opts, [sendbuf], [recvbuf])

    def allgather(self, sendbuf, recvbuf, count, *, compress_dtype=None,
                  op0_stream=None, res_stream=None):
        opts = self._prep(Operation.allgather, sendbuf, None, recvbuf, count,
                          op0_stream, res_stream,
                          compress_dtype=compress_dtype)
        return self._record(opts, [sendbuf], [recvbuf])

    def reduce(self, sendbuf, recvbuf, count, root, function, *,
               compress_dtype=None, op0_stream=None, res_stream=None):
        opts = self._prep(Operation.reduce, sendbuf, None, recvbuf, count,
                          op0_stream, res_stream, root_src_dst=root,
                          function=int(function),
                          compress_dtype=compress_dtype)
        return self._record(opts, [sendbuf], [recvbuf])

    def allreduce(self, sendbuf, recvbuf, count, function, *,
                  compress_dtype=None, op0_stream=None, res_stream=None,
                  mode="all", live_ranks=None):
        opts = self._prep(Operation.allreduce, sendbuf, None, recvbuf, count,
                          op0_stream, res_stream, function=int(function),
                          compress_dtype=compress_dtype)
        opts.live_ranks = self._accl._live_subset(
            mode, live_ranks, int(function), compress_dtype, self._comm)
        return self._record(opts, [sendbuf], [recvbuf])

    def reduce_scatter(self, sendbuf, recvbuf, count, function, *,
                       compress_dtype=None, op0_stream=None,
                       res_stream=None):
        opts = self._prep(Operation.reduce_scatter, sendbuf, None, recvbuf,
                          count, op0_stream, res_stream,
                          function=int(function),
                          compress_dtype=compress_dtype)
        return self._record(opts, [sendbuf], [recvbuf])

    def alltoall(self, sendbuf, recvbuf, count, *, compress_dtype=None,
                 op0_stream=None, res_stream=None):
        opts = self._prep(Operation.alltoall, sendbuf, None, recvbuf, count,
                          op0_stream, res_stream,
                          compress_dtype=compress_dtype)
        return self._record(opts, [sendbuf], [recvbuf])

    def alltoallv(self, sendbuf, recvbuf, count, send_counts, *,
                  compress_dtype=None, op0_stream=None, res_stream=None):
        opts = self._accl._prepare_alltoallv(
            sendbuf, recvbuf, count, send_counts,
            compress_dtype=compress_dtype, comm=self._comm)
        self._accl._stream_opts(opts, op0_stream, res_stream)
        return self._record(opts, [sendbuf], [recvbuf])

    # -- execution ---------------------------------------------------------

    def _sync_sets(self):
        """(sync_in, sync_out): external inputs are the buffers read before
        any in-sequence write (intermediates chain on the card); outputs
        are every written buffer, in first-write order: the sets eager
        back-to-back calls would sync."""
        written: set[int] = set()
        sync_in: list[BaseBuffer] = []
        sync_out: list[BaseBuffer] = []
        for reads, writes in zip(self._reads, self._writes):
            for b in reads:
                if id(b) not in written and all(b is not x for x in sync_in):
                    sync_in.append(b)
            for b in writes:
                written.add(id(b))
                if all(b is not x for x in sync_out):
                    sync_out.append(b)
        return sync_in, sync_out

    def _consume(self) -> None:
        if self._ran:
            raise SequenceReuseError(
                "sequence already executed; record a new one")
        if not self.calls:
            raise ValueError("empty sequence: record at least one call")
        self._ran = True

    def compile(self) -> "SequenceProgram":
        """Freeze the recorded batch into a re-dispatchable
        SequenceProgram: plan resolution, the lint gate, the dataflow
        analysis, the composed body and, on the card, its CUDA-graph
        capture all happen once here, and every `program.run()` is
        stage-in + one dispatch (one graph replay) + completion. The
        recorder is consumed (the same one-shot contract as run())."""
        self._consume()
        return SequenceProgram(self._accl, self)

    def run(self, *, from_device=False, to_device=False, run_async=False):
        """Dispatch the recorded batch as one program. from_device /
        to_device skip the host<->device syncs around the whole sequence
        (there are none between steps); run_async returns the request,
        to be completed with accl.wait()."""
        self._consume()
        accl = self._accl
        sync_in, sync_out = self._sync_sets()
        with get_tracer().span("sequence", cat="sequence",
                               track="facade") as sp:
            accl._stage_in(sync_in, from_device)
            Log.debug("sequence of %d: %s", len(self.calls),
                      "+".join(o.scenario.name for o in self.calls))
            req = accl.cclo.start_sequence(self.calls, lint=self._lint,
                                           persistent=self._persistent)
            ret = accl._complete(req, sync_out, to_device, run_async)
            if get_tracer().active:
                sp.set(n_steps=len(self.calls),
                       ops="+".join(o.scenario.name for o in self.calls))
                if run_async:
                    sp.set(dispatch_only=True)
                sig = getattr(req, "signature", None)
                if sig is not None:
                    sp.set(signature=sig)
                pred = getattr(req, "predicted_s", None)
                if pred is not None:
                    sp.set(predicted_s=pred)
            return ret


class SequenceProgram:
    """A recorded call sequence frozen into its steady-state form: plan
    resolution, lint, the composed body and its CUDA-graph capture
    happened once (at SequenceRecorder.compile), and every `run()` is
    stage-in + one dispatch + completion.

    The program binds the buffers the recorder referenced: each run
    reads their current device images and places results back, so the
    caller's loop is `write inputs -> program.run() -> read outputs`. The
    plans were resolved under the tuning registers live at compile time;
    retune, then re-record, to pick up new registers."""

    def __init__(self, accl: ACCL, recorder: SequenceRecorder):
        self._accl = accl
        self._sync_in, self._sync_out = recorder._sync_sets()
        self.n_steps = len(recorder.calls)
        self._ops = "+".join(o.scenario.name for o in recorder.calls)
        self._prepared = accl.cclo.prepare_sequence(
            recorder.calls, lint=recorder._lint,
            persistent=recorder._persistent)

    @property
    def plans(self):
        """The per-step Plans the batch resolved to (frozen)."""
        return self._prepared.plans

    @property
    def signature(self):
        """Digest of the batch's composite signature: the compile and lint
        cache key."""
        return self._prepared.sig

    @property
    def graph(self):
        """The prepared SequenceGraph (on the card: the captured CUDA
        graph, its capture time, its placement and the bytes its copy-in
        moves)."""
        return self._prepared.graph

    @property
    def footprint(self):
        """The program's interference summary (ProgramFootprint), the
        input to ACCL.certify_concurrent."""
        return self._prepared.footprint

    @property
    def certificate(self):
        """Certificate id of the pairwise-clean concurrent set this
        program was last admitted into (None until certify_concurrent
        passes it)."""
        return self._prepared.cert

    def run(self, *, from_device=False, to_device=False, run_async=False):
        """Dispatch the prepared batch over the bound buffers' current
        contents; the same sync semantics as SequenceRecorder.run()."""
        accl = self._accl
        with get_tracer().span("sequence", cat="sequence",
                               track="facade") as sp:
            accl._stage_in(self._sync_in, from_device)
            req = accl.cclo.dispatch_sequence(self._prepared)
            ret = accl._complete(req, self._sync_out, to_device, run_async)
            if get_tracer().active:
                sp.set(n_steps=self.n_steps, ops=self._ops, prepared=True)
                if run_async:
                    sp.set(dispatch_only=True)
                sig = getattr(req, "signature", None)
                if sig is not None:
                    sp.set(signature=sig)
                cert = getattr(req, "interference_cert", None)
                if cert is not None:
                    sp.set(interference_cert=cert)
            return ret
