"""Call descriptors: the host <-> sequencer contract.

Counterpart of accl_tpu/descriptor.py. A call is a fixed 15-word
descriptor; the same words key the port's compiled-schedule cache
through `signature()`. A call sequence is a batch of them
(`SequenceDescriptor`), keyed by its composite signature.
"""

from __future__ import annotations

import dataclasses

from .constants import (
    CompressionFlags,
    DataType,
    HostFlags,
    Operation,
    ReduceFunction,
    StreamFlags,
    TAG_ANY,
)

DESCRIPTOR_WORDS = 15


def normalize_live_ranks(live_ranks, world: int) -> tuple[int, ...]:
    """The one validation of a degraded live-subset survivor set, shared by
    the facade and plan selection: sorted, free of duplicates, every member
    inside the world. Callers decide what a full set means (the facade
    folds it into the ordinary collective)."""
    lr = tuple(sorted(int(r) for r in live_ranks))
    if len(set(lr)) != len(lr):
        raise ValueError(f"duplicate ranks in live_ranks {live_ranks}")
    if any(not 0 <= r < world for r in lr):
        raise ValueError(f"live_ranks {lr} outside world of {world}")
    return lr


@dataclasses.dataclass
class CallOptions:
    """Host-side form of a call descriptor."""

    scenario: Operation = Operation.nop
    count: int = 0
    comm_addr: int = 0
    root_src_dst: int = 0
    function: int = 0  # ReduceFunction for reductions, CfgFunc for config
    tag: int = TAG_ANY
    arithcfg_addr: int = 0
    compression_flags: CompressionFlags = CompressionFlags.NO_COMPRESSION
    stream_flags: StreamFlags = StreamFlags.NO_STREAM
    host_flags: HostFlags = HostFlags.NO_HOST
    op0_stream_id: int = 0
    res_stream_id: int = 0
    addr_0: int = 0  # operand 0 (send buffer)
    addr_1: int = 0  # operand 1 (second reduction operand)
    addr_2: int = 0  # result buffer
    # not serialized into the 15-word form: static dtypes (so compiled
    # schedules cache per signature), the alltoallv capacity vector and
    # the degraded live-subset set — each changes the compiled program
    data_type: DataType = DataType.none
    compress_dtype: DataType = DataType.none
    peer_counts: tuple[int, ...] = ()
    live_ranks: tuple[int, ...] = ()
    # the slot-driven alltoallv's device layout (schedules.SlotRows): its
    # rows are written on the card, so its identity keys the program
    row_layout: object = None

    def to_words(self) -> list[int]:
        """Serialize into the 15-word call stream layout: scenario, count,
        comm, root_src_dst, function, tag, arithcfg, compression,
        stream|host<<8|op0_stream<<16|res_stream<<24, then three 64-bit
        addresses as lo/hi word pairs."""
        words = [
            int(self.scenario),
            self.count,
            self.comm_addr,
            self.root_src_dst,
            int(self.function),
            self.tag,
            self.arithcfg_addr,
            int(self.compression_flags),
            int(self.stream_flags) | (int(self.host_flags) << 8)
            | ((self.op0_stream_id & 0xFF) << 16)
            | ((self.res_stream_id & 0xFF) << 24),
        ]
        for addr in (self.addr_0, self.addr_1, self.addr_2):
            words.append(addr & 0xFFFFFFFF)
            words.append((addr >> 32) & 0xFFFFFFFF)
        if len(words) != DESCRIPTOR_WORDS:
            raise AssertionError(f"descriptor encoded to {len(words)} words")
        return words

    @classmethod
    def from_words(cls, words: list[int]) -> "CallOptions":
        if len(words) != DESCRIPTOR_WORDS:
            raise ValueError(f"descriptor must be {DESCRIPTOR_WORDS} words")
        return cls(
            scenario=Operation(words[0]),
            count=words[1],
            comm_addr=words[2],
            root_src_dst=words[3],
            function=words[4],
            tag=words[5],
            arithcfg_addr=words[6],
            compression_flags=CompressionFlags(words[7]),
            stream_flags=StreamFlags(words[8] & 0xFF),
            host_flags=HostFlags((words[8] >> 8) & 0xFF),
            op0_stream_id=(words[8] >> 16) & 0xFF,
            res_stream_id=(words[8] >> 24) & 0xFF,
            addr_0=words[9] | (words[10] << 32),
            addr_1=words[11] | (words[12] << 32),
            addr_2=words[13] | (words[14] << 32),
        )

    @property
    def reduce_function(self) -> ReduceFunction:
        return ReduceFunction(self.function)

    def signature(self) -> tuple:
        """Static compilation signature for the schedule cache: every field
        that changes the compiled program but not the runtime-variable
        buffer addresses."""
        return (
            self.scenario,
            self.count,
            self.comm_addr,
            self.root_src_dst,
            self.function,
            self.data_type,
            self.compress_dtype,
            int(self.compression_flags),
            int(self.stream_flags),
            int(self.host_flags),
            self.op0_stream_id,
            self.res_stream_id,
            tuple(self.peer_counts),
            tuple(self.live_ranks),
        ) + (() if self.row_layout is None else (self.row_layout,))


@dataclasses.dataclass
class SequenceDescriptor:
    """A recorded batch of call descriptors executed as one prepared
    program: the host issues a single batch instead of one descriptor per
    collective (on the card, one CUDA-graph replay)."""

    steps: tuple[CallOptions, ...]

    def __post_init__(self):
        self.steps = tuple(self.steps)
        if not self.steps:
            raise ValueError("empty call sequence")
        comm = self.steps[0].comm_addr
        if any(s.comm_addr != comm for s in self.steps):
            raise ValueError(
                "all steps of a sequence must address one communicator")

    @property
    def comm_addr(self) -> int:
        return self.steps[0].comm_addr

    def to_words(self) -> list[int]:
        """Serialize as a batched call stream: a count header word followed
        by each step's 15-word descriptor back to back."""
        words = [len(self.steps)]
        for s in self.steps:
            words.extend(s.to_words())
        return words

    @classmethod
    def from_words(cls, words: list[int]) -> "SequenceDescriptor":
        n = words[0]
        if len(words) != 1 + n * DESCRIPTOR_WORDS:
            raise ValueError("malformed sequence descriptor stream")
        return cls(tuple(
            CallOptions.from_words(
                words[1 + i * DESCRIPTOR_WORDS:1 + (i + 1) * DESCRIPTOR_WORDS]
            )
            for i in range(n)
        ))

    def signature(self) -> tuple:
        """Composite static signature: the per-step signatures plus the
        dataflow between steps (which operands alias which results), with
        buffer addresses renamed canonically in order of first appearance,
        so two batches over different buffers with the same shapes and
        wiring share one prepared program and one lint verdict."""
        rename: dict[int, int] = {}

        def idx(addr: int) -> int | None:
            if addr == 0:
                return None
            return rename.setdefault(addr, len(rename))

        flow = tuple(
            (idx(s.addr_0), idx(s.addr_1), idx(s.addr_2)) for s in self.steps
        )
        return ("sequence",
                tuple(s.signature() for s in self.steps), flow)
