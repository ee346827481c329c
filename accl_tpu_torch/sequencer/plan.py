"""Algorithm selection: which schedule runs a given call.

Counterpart of accl_tpu/sequencer/plan.py, rule for rule, for every
branch the default tuning registers reach. The branches that only a
non-zero register or an extra argument reach (the two-tier composition,
the synthesized and latency-grid libraries, stripe overlap, the degraded
live-subset ring) belong to later slices of the port: each raises
NotImplementedError naming its slice where the reference would enter it,
and none silently picks another plan. The register-opened rendezvous
reduce+bcast allreduce is ported.
"""

from __future__ import annotations

import dataclasses
import enum
import functools

from ..constants import (
    CompressionFlags,
    DataType,
    Operation,
    StreamFlags,
    TuningParams,
)
from ..errors import not_ported


class Protocol(enum.IntEnum):
    EAGER = 0  # segmented through preallocated RX ring slots
    RENDEZVOUS = 1  # bulk zero-copy transfer after an address handshake


class Algorithm(enum.IntEnum):
    """Schedule families."""

    NONE = 0  # local-only ops: copy/combine, world==1 corner cases
    EAGER_SENDRECV = 1
    RNDZV_SENDRECV = 2
    EAGER_FLAT = 3
    EAGER_RING = 4
    EAGER_RING_RS_AG = 5  # ring reduce-scatter + ring allgather
    RNDZV_FLAT_TREE = 6
    RNDZV_BIN_TREE = 7
    RNDZV_RING = 8
    RNDZV_REDUCE_BCAST = 9
    RNDZV_REDUCE_SCATTER = 10
    FLAT_ALLTOALL = 11
    BARRIER_GATHER_SCATTER = 12
    SYNTHESIZED = 13
    HIER_RS_AR_AG = 14
    FLAT_ALLTOALLV = 15


@dataclasses.dataclass(frozen=True)
class Plan:
    """The resolved execution plan for one call. seg_count is in elements
    (the eager segment size); all fields are static, so a Plan is part of
    the compiled-schedule cache key. Fields of the later-slice families
    are kept so a Plan compares field for field with the reference's."""

    protocol: Protocol
    algorithm: Algorithm
    seg_count: int  # elements per eager segment (== count when unsegmented)
    num_segments: int
    tree_fanin: int = 0
    use_bin_tree: bool = False
    stages: tuple["Plan", ...] = ()
    wire_dtype: DataType = DataType.none
    synth_key: str = ""
    inner_world: int = 0
    outer_world: int = 0
    stripes: int = 1
    inner_wire_dtype: DataType = DataType.none
    outer_wire_dtype: DataType = DataType.none
    peer_counts: tuple[int, ...] = ()
    live_ranks: tuple[int, ...] = ()


def is_rendezvous(
    bytes_count: int,
    compression: CompressionFlags,
    stream: StreamFlags,
    max_eager_size: int,
) -> bool:
    """The protocol switch every collective applies first: large,
    uncompressed, non-streamed messages go rendezvous; everything else is
    eager."""
    return (
        bytes_count > max_eager_size
        and compression == CompressionFlags.NO_COMPRESSION
        and stream == StreamFlags.NO_STREAM
    )


def eager_seg_count(
    count: int,
    dtype_nbytes: int,
    eager_rx_buf_size: int,
    stream: StreamFlags,
    world_align: int = 1,
) -> int:
    """Eager segment size in elements: the rx buffer capacity, optionally
    rounded down to a multiple of world size for algorithms that stride
    chunks by rank; streamed operands are never segmented."""
    if stream & StreamFlags.OP0_STREAM:
        return count
    seg = max(eager_rx_buf_size // dtype_nbytes, 1)
    if world_align > 1:
        seg -= seg % world_align
        seg = max(seg, world_align)
    return min(seg, count) if count > 0 else seg


def _segments(count: int, seg: int) -> int:
    return max((count + seg - 1) // seg, 1)


def select_algorithm(
    scenario: Operation,
    count: int,
    dtype_nbytes: int,
    world_size: int,
    compression: CompressionFlags = CompressionFlags.NO_COMPRESSION,
    stream: StreamFlags = StreamFlags.NO_STREAM,
    *,
    max_eager_size: int,
    eager_rx_buf_size: int,
    tuning: TuningParams,
    compress_dtype: DataType = DataType.none,
    topology: tuple[int, int] | None = None,
    peer_counts: tuple[int, ...] = (),
    live_ranks: tuple[int, ...] = (),
) -> Plan:
    """Resolve scenario + message + communicator into a Plan, with the
    reference's rules collective by collective. `topology` declares a
    two-tier (inner, outer) world; `peer_counts` is the alltoallv
    capacity vector; `live_ranks` the degraded survivor set."""
    bytes_count = count * dtype_nbytes
    rndzv = is_rendezvous(bytes_count, compression, stream, max_eager_size)
    proto = Protocol.RENDEZVOUS if rndzv else Protocol.EAGER
    wire = (compress_dtype
            if compression & CompressionFlags.ETH_COMPRESSED
            and compress_dtype != DataType.none
            else DataType.none)

    def eager_plan(algorithm: Algorithm, world_align: int = 1) -> Plan:
        seg = eager_seg_count(
            count, dtype_nbytes, eager_rx_buf_size, stream, world_align
        )
        return Plan(Protocol.EAGER, algorithm, seg, _segments(count, seg),
                    wire_dtype=wire)

    def rndzv_plan(algorithm: Algorithm, **kw) -> Plan:
        return Plan(Protocol.RENDEZVOUS, algorithm, count, 1,
                    wire_dtype=wire, **kw)

    # local-only operations and single-rank corner cases
    if scenario in (Operation.copy, Operation.combine, Operation.config, Operation.nop):
        return Plan(proto, Algorithm.NONE, count, 1)
    if world_size == 1 and scenario != Operation.barrier:
        return Plan(proto, Algorithm.NONE, count, 1)

    if scenario == Operation.allreduce and live_ranks:
        raise not_ported("the degraded live-subset allreduce", "resilience")

    if scenario == Operation.allreduce and topology is not None:
        inner_w, outer_w = topology
        if (tuning.hier_allreduce_min_count > 0
                and inner_w > 1 and outer_w > 1
                and inner_w * outer_w == world_size
                and bytes_count >= tuning.hier_allreduce_min_count
                and stream == StreamFlags.NO_STREAM
                and compression == CompressionFlags.NO_COMPRESSION):
            raise not_ported("the two-tier HIER_RS_AR_AG allreduce",
                             "hierarchical schedules")

    if (scenario == Operation.allreduce
            and tuning.synth_latency_max_count
            and 0 < bytes_count <= tuning.synth_latency_max_count
            and stream == StreamFlags.NO_STREAM
            and compression == CompressionFlags.NO_COMPRESSION):
        raise not_ported("the latency-grid synthesized library",
                             "synthesized schedules")

    synth_reg = {
        Operation.allreduce: tuning.synth_allreduce_max_count,
        Operation.allgather: tuning.synth_allgather_max_count,
        Operation.reduce_scatter: tuning.synth_reduce_scatter_max_count,
    }.get(scenario, 0)
    if (synth_reg and 0 < bytes_count <= synth_reg
            and stream == StreamFlags.NO_STREAM
            and compression == CompressionFlags.NO_COMPRESSION):
        raise not_ported("the synthesized schedule library",
                             "synthesized schedules")

    if scenario in (Operation.send, Operation.recv):
        if rndzv:
            return rndzv_plan(Algorithm.RNDZV_SENDRECV)
        return eager_plan(Algorithm.EAGER_SENDRECV)

    if scenario == Operation.bcast:
        if rndzv:
            if world_size > tuning.bcast_flat_tree_max_ranks:
                return rndzv_plan(Algorithm.RNDZV_BIN_TREE, use_bin_tree=True)
            return rndzv_plan(Algorithm.RNDZV_FLAT_TREE, tree_fanin=world_size - 1)
        return eager_plan(Algorithm.EAGER_FLAT)

    if scenario == Operation.scatter:
        if rndzv:
            return rndzv_plan(Algorithm.RNDZV_FLAT_TREE, tree_fanin=world_size - 1)
        return eager_plan(Algorithm.EAGER_FLAT)

    if scenario == Operation.gather:
        if rndzv:
            if bytes_count > tuning.gather_flat_tree_max_count:
                fanin = max(tuning.gather_flat_tree_max_fanin, 1)
            else:
                fanin = world_size - 1
            return rndzv_plan(Algorithm.RNDZV_FLAT_TREE, tree_fanin=fanin)
        return eager_plan(Algorithm.EAGER_RING)

    if scenario == Operation.allgather:
        if rndzv:
            return rndzv_plan(Algorithm.RNDZV_RING)
        return eager_plan(Algorithm.EAGER_RING)

    if scenario == Operation.reduce:
        if rndzv:
            if (
                world_size <= tuning.reduce_flat_tree_max_ranks
                or bytes_count <= tuning.reduce_flat_tree_max_count
            ):
                return rndzv_plan(Algorithm.RNDZV_FLAT_TREE, tree_fanin=world_size - 1)
            return rndzv_plan(Algorithm.RNDZV_BIN_TREE, use_bin_tree=True)
        return eager_plan(Algorithm.EAGER_RING)

    if scenario == Operation.reduce_scatter:
        if rndzv:
            # reduce(count*world, root=0) then scatter(count)
            sub = functools.partial(
                select_algorithm,
                dtype_nbytes=dtype_nbytes,
                world_size=world_size,
                compression=compression,
                stream=stream,
                max_eager_size=max_eager_size,
                eager_rx_buf_size=eager_rx_buf_size,
                tuning=tuning,
                compress_dtype=compress_dtype,
            )
            return rndzv_plan(
                Algorithm.RNDZV_REDUCE_SCATTER,
                stages=(
                    sub(Operation.reduce, count * world_size),
                    sub(Operation.scatter, count),
                ),
            )
        return eager_plan(Algorithm.EAGER_RING, world_align=world_size)

    if scenario == Operation.allreduce:
        # the segmented ring reduce-scatter + allgather, world-aligned
        # segments, is the default at every size
        if rndzv and bytes_count <= tuning.allreduce_composition_max_count:
            # the register-opened reduce(count) to rank 0 + bcast(count)
            # composition, both stages re-selected with the live registers
            sub = functools.partial(
                select_algorithm,
                dtype_nbytes=dtype_nbytes,
                world_size=world_size,
                compression=compression,
                stream=stream,
                max_eager_size=max_eager_size,
                eager_rx_buf_size=eager_rx_buf_size,
                tuning=tuning,
                compress_dtype=compress_dtype,
            )
            return rndzv_plan(
                Algorithm.RNDZV_REDUCE_BCAST,
                stages=(
                    sub(Operation.reduce, count),
                    sub(Operation.bcast, count),
                ),
            )
        if (tuning.overlap_min_count > 0
                and compression == CompressionFlags.NO_COMPRESSION
                and bytes_count >= tuning.overlap_min_count):
            raise not_ported("the stripe-overlapped allreduce",
                             "overlapped schedules")
        return eager_plan(Algorithm.EAGER_RING_RS_AG, world_align=world_size)

    if scenario == Operation.alltoall:
        # an all-full capacity vector IS the dense alltoall
        if peer_counts and any(c != count for c in peer_counts):
            if len(peer_counts) != world_size:
                raise ValueError(
                    f"alltoallv needs {world_size} peer counts, got "
                    f"{len(peer_counts)}")
            if any(c <= 0 or c > count for c in peer_counts):
                raise ValueError(
                    f"alltoallv peer counts {peer_counts} outside "
                    f"(0, {count}]")
            pc = tuple(int(c) for c in peer_counts)
            if rndzv:
                return rndzv_plan(Algorithm.FLAT_ALLTOALLV, peer_counts=pc)
            return dataclasses.replace(
                eager_plan(Algorithm.FLAT_ALLTOALLV), peer_counts=pc)
        return rndzv_plan(Algorithm.FLAT_ALLTOALL) if rndzv else eager_plan(
            Algorithm.FLAT_ALLTOALL
        )

    if scenario == Operation.barrier:
        return Plan(Protocol.RENDEZVOUS, Algorithm.BARRIER_GATHER_SCATTER, 0, 1)

    raise ValueError(f"no algorithm for scenario {scenario!r}")
