"""Abstract CCLO device + exchange-memory model.

Counterpart of accl_tpu/device/base.py: a device executes call
descriptors and exposes word-addressed exchange memory whose register map
(and identity word) are the reference's, so both packages write the same
image at initialize time.
"""

from __future__ import annotations

from ..constants import EXCHMEM_SIZE
from ..descriptor import CallOptions
from ..request import BaseRequest


class CCLOAddr:
    """Exchange-memory register offsets (reference CCLO_ADDR namespace)."""

    RETCODE = 0x1FFC
    IDCODE = 0x1FF8
    CFGRDY = 0x1FF4
    PERFCNT = 0x1FF0
    SPARE3 = 0x1FE8
    SPARE2 = 0x1FE0
    # allreduce payloads <= this many bytes (and above max_eager) run the
    # rendezvous reduce+bcast composition; 0 = ring at every size
    ALLREDUCE_COMPOSITION_MAX_COUNT = 0x1FD8
    REDUCE_FLAT_TREE_MAX_COUNT = 0x1FD4
    REDUCE_FLAT_TREE_MAX_RANKS = 0x1FD0
    BCAST_FLAT_TREE_MAX_RANKS = 0x1FCC
    GATHER_FLAT_TREE_MAX_COUNT = 0x1FC8
    GATHER_FLAT_TREE_MAX_FANIN = 0x1FC4
    # synthesized-schedule crossovers; 0 keeps the hand-written schedules
    SYNTH_ALLREDUCE_MAX_COUNT = 0x1FC0
    SYNTH_ALLGATHER_MAX_COUNT = 0x1FBC
    SYNTH_REDUCE_SCATTER_MAX_COUNT = 0x1FB8
    # two-tier allreduce crossover (a MIN threshold); 0 = flat selection
    HIER_ALLREDUCE_MIN_COUNT = 0x1FB4
    # quantized-alltoall crossover (a MIN threshold); 0 = exact wire
    ALLTOALL_COMPRESS_MIN_COUNT = 0x1FB0
    # stripe-overlap crossover (a MIN threshold); 0 = serial form
    OVERLAP_MIN_COUNT = 0x1FAC
    # latency-grid synthesized-schedule crossover; 0 = off
    SYNTH_LATENCY_MAX_COUNT = 0x1FA8
    EGR_RX_BUF_SIZE = 0x4
    NUM_EGR_RX_BUFS = 0x0
    # start of the dynamically laid-out region (communicators, arith
    # configs), after the rx-ring descriptor table
    DYNAMIC_BASE = 0x200
    # end of the dynamic region: the lowest-addressed register above
    DYNAMIC_END = 0x1FA8


# Field names of the reference's versioned stats2 counter surface, in
# its native index order: the classic sequencer counters, then the
# reliable wire's health counters (CRC/dup drops, selective-retransmit
# ack/nack traffic, fault-injection tallies, CRC+ack ns), then the
# vectored wire's transmit shape. A device with no native wire reports
# every one as 0 (GPUDevice.wire_stats).
STATS2_FIELDS = (
    "passes", "parks", "park_ns", "seek_hit", "seek_miss",
    "tx_frames", "rx_frames", "crc_drops", "dup_drops",
    "retx_sent", "retx_miss", "nack_sent", "nack_rx",
    "ack_sent", "ack_rx", "rndzv_drops",
    "inj_loss", "inj_corrupt", "inj_dup", "inj_reorder", "rely_ns",
    "tx_syscalls", "tx_batched",
)

# The hardware id the framework reports (the same word as the reference,
# so exchange-memory images compare word for word).
ACCL_TPU_IDCODE = 0xACC1_7B00


class CCLODevice:
    """Backend interface: execute descriptors, expose exchange memory."""

    def __init__(self):
        # word-addressed exchange-memory model, 8 KB like the BRAM
        self._exchmem: dict[int, int] = {CCLOAddr.IDCODE: ACCL_TPU_IDCODE}

    # -- MMIO -------------------------------------------------------------

    def read(self, addr: int) -> int:
        self._check_addr(addr)
        return self._exchmem.get(addr, 0)

    def write(self, addr: int, value: int) -> None:
        self._check_addr(addr)
        self._exchmem[addr] = value & 0xFFFFFFFF

    def _check_addr(self, addr: int):
        if not 0 <= addr < EXCHMEM_SIZE:
            raise ValueError(f"exchange-memory address {addr:#x} out of range")

    def dump_exchange_memory(self) -> str:
        """Every written exchange-memory word, by address."""
        lines = ["exchange memory:"]
        for addr in sorted(self._exchmem):
            lines.append(f"  [{addr:#06x}] = {self._exchmem[addr]:#010x}")
        return "\n".join(lines)

    def dump_eager_rx_buffers(self) -> str:
        """The eager rx state; backends that have one override this."""
        return "eager rx ring: none on this backend"

    # -- calls ------------------------------------------------------------

    def call(self, options: CallOptions) -> BaseRequest:
        """Synchronous call: start + wait + store retcode."""
        req = self.start(options)
        req.wait()
        self.write(CCLOAddr.RETCODE, req.retcode)
        self.write(CCLOAddr.PERFCNT, req.duration_ns & 0xFFFFFFFF)
        return req

    def start(self, options: CallOptions) -> BaseRequest:
        raise NotImplementedError

    def deinit(self):
        pass
