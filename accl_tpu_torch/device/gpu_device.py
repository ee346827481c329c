"""GPUDevice: descriptor execution over virtual ranks on one card.

Counterpart of accl_tpu/device/tpu_device.py. TPUDevice resolves a
descriptor's buffers, selects a plan and launches the cached compiled
program over a mesh of chips. GPUDevice does the same for W virtual
ranks on one CUDA device (or on the CPU when the caller asks for it):
every buffer is a stacked (world, n) tensor, and one call executes the
collective for every rank. Completion is a CUDA event recorded after the
call's kernels instead of XLA's block_until_ready.

Every one-call collective is ported (copy, combine, bcast, scatter,
gather, allgather, reduce, allreduce, reduce_scatter, barrier);
point-to-point send/recv, alltoall, streams, call sequences and
sub-communicators raise NotImplementedError naming the slice of the port
that brings them.
"""

from __future__ import annotations

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
    TuningParams,
    dtype_nbytes,
)
from ..descriptor import CallOptions
from ..errors import not_ported
from ..request import BaseRequest, GPURequest
from ..sequencer.lowering import ScheduleCompiler
from ..sequencer.plan import Plan, select_algorithm
from ..sequencer.sequence import step_in_elems
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
                      tuning: TuningParams | None = None) -> Plan:
        """Per-descriptor plan selection (the one source both the eager
        path and, in a later slice, call sequences use)."""
        if options.stream_flags:
            raise not_ported("streamed operands", "streams")
        return select_algorithm(
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

    def _launch(self, options: CallOptions) -> GPURequest:
        self._comm_ctx(options.comm_addr)
        plan = self._resolve_step(options, self.tuning())
        fn = self.compiler.lower(options, plan)
        scen = options.scenario
        res = self._buf(options.addr_2)
        if scen == Operation.barrier:
            # the zero-payload notifications ride a one-element token
            args = [torch.ones((self.world, 1), dtype=torch.float32,
                               device=self.torch_device)]
        else:
            in_n = step_in_elems(options, self.world)
            args = [_slice_to(self._buf(options.addr_0).device, in_n)]
            if scen == Operation.combine:
                args.append(_slice_to(self._buf(options.addr_1).device, in_n))

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
                res.device = _place_into(res.device, out)

        req = GPURequest(options.scenario.name, [out], events,
                         on_complete=place)
        if events is None:
            req._start_time = t0  # host clock around the eager CPU run
        req.plan = plan
        return req

    # -- config calls ------------------------------------------------------

    def _config(self, options: CallOptions) -> BaseRequest:
        req = BaseRequest(f"config/{CfgFunc(options.function).name}")
        req.running()
        fn = CfgFunc(options.function)
        if fn == CfgFunc.reset_periph:
            self.compiler._cache.clear()
            self._comm_cache.clear()
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


def _slice_to(t: torch.Tensor, n: int) -> torch.Tensor:
    return t if t.shape[-1] == n else t[..., :n]


def _place_into(dst: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Write a program result into a (possibly wider) result buffer."""
    if dst.shape == out.shape:
        return out
    dst = dst.clone()
    dst[..., : out.shape[-1]] = out.to(dst.dtype)
    return dst
