"""Core enumerations and constants of the PyTorch/CUDA port.

Counterpart of accl_tpu/constants.py, value for value: the enums, error
bits, register defaults and quantization constants are the same numbers,
so a descriptor or an exchange-memory image means the same thing to both
packages. The one difference is the dtype bridge: DataType maps onto
torch dtypes (bfloat16 included) instead of numpy dtypes, so no bf16
extension package is needed.
"""

from __future__ import annotations

import enum

import torch

# ---------------------------------------------------------------------------
# Call scenarios (reference: constants.hpp:190-216 `enum class operation`)
# ---------------------------------------------------------------------------


class Operation(enum.IntEnum):
    """The scenario field of a call descriptor."""

    config = 0
    copy = 1
    combine = 2
    send = 3
    recv = 4
    bcast = 5
    scatter = 6
    gather = 7
    reduce = 8
    allgather = 9
    allreduce = 10
    reduce_scatter = 11
    barrier = 12
    alltoall = 13
    nop = 255


class CfgFunc(enum.IntEnum):
    """Housekeeping sub-functions of Operation.config."""

    reset_periph = 0
    enable_pkt = 1
    set_timeout = 2
    set_max_eager_msg_size = 3
    set_max_rendezvous_msg_size = 4


class ReduceFunction(enum.IntEnum):
    SUM = 0
    MAX = 1


class OperationStatus(enum.IntEnum):
    """Status of an in-flight request."""

    QUEUED = 0
    EXECUTING = 1
    COMPLETED = 2


# ---------------------------------------------------------------------------
# Data types
# ---------------------------------------------------------------------------


class DataType(enum.IntEnum):
    none = 0
    int8 = 1
    float16 = 2
    float32 = 3
    float64 = 4
    int32 = 5
    int64 = 6
    bfloat16 = 7


DATATYPE_BITS: dict[DataType, int] = {
    DataType.none: 0,
    DataType.int8: 8,
    DataType.float16: 16,
    DataType.float32: 32,
    DataType.float64: 64,
    DataType.int32: 32,
    DataType.int64: 64,
    DataType.bfloat16: 16,
}


def dtype_nbytes(dt: DataType) -> int:
    return DATATYPE_BITS[dt] // 8


_TORCH_DTYPES: dict[DataType, torch.dtype] = {
    DataType.int8: torch.int8,
    DataType.float16: torch.float16,
    DataType.float32: torch.float32,
    DataType.float64: torch.float64,
    DataType.int32: torch.int32,
    DataType.int64: torch.int64,
    DataType.bfloat16: torch.bfloat16,
}
_FROM_TORCH = {v: k for k, v in _TORCH_DTYPES.items()}


def to_torch_dtype(dt: DataType) -> torch.dtype:
    return _TORCH_DTYPES[dt]


def from_torch_dtype(dt: torch.dtype) -> DataType:
    return _FROM_TORCH[dt]


# ---------------------------------------------------------------------------
# Flag words carried in the call descriptor
# ---------------------------------------------------------------------------


class StreamFlags(enum.IntFlag):
    NO_STREAM = 0
    OP0_STREAM = 1
    RES_STREAM = 2


class HostFlags(enum.IntFlag):
    NO_HOST = 0
    OP0_HOST = 1
    OP1_HOST = 2
    RES_HOST = 4


class CompressionFlags(enum.IntFlag):
    """ETH_COMPRESSED requests wire compression: payloads are cast to the
    compressed dtype of the active arithmetic configuration around each
    cross-rank hop."""

    NO_COMPRESSION = 0
    OP0_COMPRESSED = 1
    OP1_COMPRESSED = 2
    RES_COMPRESSED = 4
    ETH_COMPRESSED = 8


class Transport(enum.IntEnum):
    ICI = 0
    DCN = 1
    EMU = 2


# ---------------------------------------------------------------------------
# Error codes: the sticky-bit contract (any engine ORs bits into the call's
# return code; the host raises with every set bit decoded).
# ---------------------------------------------------------------------------


class ErrorCode(enum.IntFlag):
    COLLECTIVE_OP_SUCCESS = 0
    DMA_MISMATCH_ERROR = 1 << 0
    DMA_INTERNAL_ERROR = 1 << 1
    DMA_DECODE_ERROR = 1 << 2
    DMA_SLAVE_ERROR = 1 << 3
    DMA_NOT_OKAY_ERROR = 1 << 4
    DMA_NOT_END_OF_PACKET_ERROR = 1 << 5
    DMA_NOT_EXPECTED_BTT_ERROR = 1 << 6
    DMA_TIMEOUT_ERROR = 1 << 7
    CONFIG_SWITCH_ERROR = 1 << 8
    DEQUEUE_BUFFER_TIMEOUT_ERROR = 1 << 9
    DEQUEUE_BUFFER_SPARE_BUFFER_STATUS_ERROR = 1 << 10
    RECEIVE_TIMEOUT_ERROR = 1 << 11
    DEQUEUE_BUFFER_SPARE_BUFFER_DMATAG_MISMATCH = 1 << 12
    DEQUEUE_BUFFER_SPARE_BUFFER_INDEX_ERROR = 1 << 13
    COLLECTIVE_NOT_IMPLEMENTED = 1 << 14
    RECEIVE_OFFCHIP_SPARE_BUFF_ID_NOT_VALID = 1 << 15
    EAGER_THRESHOLD_INVALID = 1 << 16
    RENDEZVOUS_THRESHOLD_INVALID = 1 << 17
    DMA_SIZE_ERROR = 1 << 18
    ARITH_ERROR = 1 << 19
    PACK_TIMEOUT_STS_ERROR = 1 << 20
    PACK_SEQ_NUMBER_ERROR = 1 << 21
    COMPRESSION_ERROR = 1 << 22
    KRNL_TIMEOUT_STS_ERROR = 1 << 23
    KRNL_STS_COUNT_ERROR = 1 << 24
    SEGMENTER_EXPECTED_BTT_ERROR = 1 << 25
    DMA_TAG_MISMATCH_ERROR = 1 << 26


ERROR_CODE_BITS = 27  # bits 0..26 inclusive


def error_code_to_string(code: int) -> str:
    """Decode a sticky error word into a human-readable string."""
    if code == 0:
        return "COLLECTIVE_OP_SUCCESS"
    names = [e.name for e in ErrorCode if e.value and (code & e.value)]
    return " | ".join(names) if names else f"UNKNOWN_ERROR(0x{code:x})"


class ACCLError(RuntimeError):
    """Raised on the host when a call returns a nonzero retcode."""

    def __init__(self, function_name: str, retcode: int):
        self.retcode = retcode
        super().__init__(
            f"CCLO call {function_name} failed: {error_code_to_string(retcode)} "
            f"(retcode=0x{retcode:x})"
        )


# ---------------------------------------------------------------------------
# Defaults
# ---------------------------------------------------------------------------

TAG_ANY = 0xFFFFFFFF

DEFAULT_NUM_EAGER_RX_BUFS = 16
DEFAULT_EAGER_RX_BUF_SIZE = 1024  # bytes
DEFAULT_MAX_EAGER_SIZE = 1024  # bytes; above this (uncompressed, non-stream)
#   a transfer takes the rendezvous path
DEFAULT_MAX_RENDEZVOUS_SIZE = 32 * 1024  # bytes

# Max bytes a single data-movement command may carry before being chunked.
DMA_MAX_BTT = 8 * 1024 * 1024 - 64

# Max bytes per wire segment.
MAX_SEG_SIZE = 4096

# Hop-shape constants of the allreduce/allgather crossover rules and the
# streamed ring's jumbo-segment size.
LOGP_ALLREDUCE_HOP_BYTES = 32 * 1024
LOGP_ALLGATHER_HOP_BYTES = 128 * 1024
STREAM_SEG_BYTES = 1 << 20


def log2_floor(world: int) -> int:
    """floor(log2(world)) by bit scan."""
    r = 0
    while (1 << (r + 1)) <= world:
        r += 1
    return r


def logp_allreduce_max_bytes(world: int) -> int:
    """Payload ceiling (bytes) under which a power-of-two world runs the
    recursive halving-doubling allreduce instead of the ring."""
    hops_saved = 2 * (world - 1) - 2 * log2_floor(world)
    return hops_saved * LOGP_ALLREDUCE_HOP_BYTES


def logp_allgather_max_bytes(world: int) -> int:
    """Recursive-doubling threshold against the TOTAL gathered payload."""
    hops_saved = (world - 1) - log2_floor(world)
    return hops_saved * LOGP_ALLGATHER_HOP_BYTES


# ---------------------------------------------------------------------------
# Blockwise int8 wire quantization: int8 blocks with one fp32 scale per
# block (ops/compression.py, csrc/quant_wire.cu); the constants are part
# of the numeric contract shared with the JAX package.
# ---------------------------------------------------------------------------

QUANT_BLOCK_ELEMS = 256  # elements per scale block
QUANT_SCALE_BYTES = 4  # one fp32 scale per block
QUANT_QMAX = 127
# the block scale is DEFINED as amax * fp32(1/QUANT_QMAX)
QUANT_INV_QMAX = float(torch.tensor(1.0, dtype=torch.float32)
                       / torch.tensor(QUANT_QMAX, dtype=torch.float32))

EXCHMEM_SIZE = 8192  # bytes of emulated exchange memory per rank


class TuningParams:
    """Runtime algorithm-tuning registers (the CCLO_ADDR tuning registers
    and their defaults). Every register keeps the reference's meaning;
    0 = off for the composition, synthesized, hierarchical, quantized
    alltoall and overlap windows."""

    def __init__(
        self,
        gather_flat_tree_max_fanin: int = 2,
        gather_flat_tree_max_count: int = 32 * 1024,
        bcast_flat_tree_max_ranks: int = 3,
        reduce_flat_tree_max_ranks: int = 4,
        reduce_flat_tree_max_count: int = 32 * 1024,
        allreduce_composition_max_count: int = 0,
        synth_allreduce_max_count: int = 0,
        synth_allgather_max_count: int = 0,
        synth_reduce_scatter_max_count: int = 0,
        hier_allreduce_min_count: int = 0,
        alltoall_compress_min_count: int = 0,
        overlap_min_count: int = 0,
        synth_latency_max_count: int = 0,
    ):
        self.gather_flat_tree_max_fanin = gather_flat_tree_max_fanin
        self.gather_flat_tree_max_count = gather_flat_tree_max_count
        self.bcast_flat_tree_max_ranks = bcast_flat_tree_max_ranks
        self.reduce_flat_tree_max_ranks = reduce_flat_tree_max_ranks
        self.reduce_flat_tree_max_count = reduce_flat_tree_max_count
        self.allreduce_composition_max_count = allreduce_composition_max_count
        self.synth_allreduce_max_count = synth_allreduce_max_count
        self.synth_allgather_max_count = synth_allgather_max_count
        self.synth_reduce_scatter_max_count = synth_reduce_scatter_max_count
        self.synth_latency_max_count = synth_latency_max_count
        self.hier_allreduce_min_count = hier_allreduce_min_count
        self.alltoall_compress_min_count = alltoall_compress_min_count
        self.overlap_min_count = overlap_min_count

    @classmethod
    def default(cls, max_rndzv_msg_size: int = DEFAULT_MAX_RENDEZVOUS_SIZE):
        reduce_flat_ranks = 4
        return cls(
            reduce_flat_tree_max_ranks=reduce_flat_ranks,
            reduce_flat_tree_max_count=min(
                max_rndzv_msg_size // reduce_flat_ranks, 32 * 1024
            ),
        )

    @classmethod
    def from_crossovers(cls, cross: dict,
                        max_count_cap: int = 1 << 22) -> "TuningParams":
        """Register values from the timing model's switch-over points
        (sequencer.timing.tuning_crossovers), as the reference derives
        them. Byte thresholds are clamped to [1, max_count_cap] — an infinite
        crossover (flat never loses on this link) caps rather than
        overflowing the 32-bit register."""
        def as_reg(v):
            if v != v or v == float("inf"):  # NaN/inf -> cap
                return max_count_cap
            return max(1, min(int(v), max_count_cap))

        # the allreduce composition crossover may legitimately be 0
        # ("ring always wins"), which as_reg would clamp to 1; NaN/inf
        # cap like every other threshold
        comp = cross.get("allreduce_composition_max_bytes", 0)
        if comp != comp or comp == float("inf"):
            comp = max_count_cap
        comp = 0 if comp <= 0 else min(int(comp), max_count_cap)
        return cls(
            gather_flat_tree_max_count=as_reg(
                cross["gather_flat_tree_max_count_bytes"]),
            bcast_flat_tree_max_ranks=max(
                1, int(cross["bcast_flat_tree_max_ranks"])),
            reduce_flat_tree_max_ranks=max(
                1, int(cross["reduce_flat_tree_max_ranks"])),
            reduce_flat_tree_max_count=as_reg(
                cross["reduce_flat_tree_max_count_bytes"]),
            allreduce_composition_max_count=comp,
            # 0 is meaningful for the synth registers ("never wins on
            # this link" / no library entry): clamp only the top end
            synth_allreduce_max_count=min(
                int(cross.get("synth_allreduce_max_bytes", 0)),
                max_count_cap),
            synth_allgather_max_count=min(
                int(cross.get("synth_allgather_max_bytes", 0)),
                max_count_cap),
            synth_reduce_scatter_max_count=min(
                int(cross.get("synth_reduce_scatter_max_bytes", 0)),
                max_count_cap),
            # same MAX-register posture as the synth trio: 0 = no
            # latency-grid entry or never wins on this link
            synth_latency_max_count=min(
                int(cross.get("synth_latency_max_bytes", 0)),
                max_count_cap),
            # 0 is meaningful here too: no per-tier calibration / no
            # topology / hierarchical never wins on these links. This
            # is a MIN threshold, so the overflow-safe clamp is OFF —
            # min(v, cap) would WIDEN the window into the region the
            # calibration said flat wins.
            hier_allreduce_min_count=(
                int(cross.get("hier_allreduce_min_bytes", 0))
                if int(cross.get("hier_allreduce_min_bytes", 0))
                <= max_count_cap else 0),
            # same MIN-register posture: 0 = never wins / no quantized
            # lane on this link, and an over-cap window start clamps to
            # OFF (min(v, cap) would widen the window into the regime
            # the calibration said the exact wire wins)
            alltoall_compress_min_count=(
                int(cross.get("alltoall_compress_min_bytes", 0))
                if int(cross.get("alltoall_compress_min_bytes", 0))
                <= max_count_cap else 0),
            # same MIN-register posture again: 0 = no compute
            # calibration / overlap never predicts a win, and an
            # over-cap window start clamps to OFF (min(v, cap) would
            # widen the window into the regime the calibration said
            # the serial form wins)
            overlap_min_count=(
                int(cross.get("overlap_min_bytes", 0))
                if int(cross.get("overlap_min_bytes", 0))
                <= max_count_cap else 0),
        )
