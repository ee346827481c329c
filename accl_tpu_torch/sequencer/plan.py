"""Algorithm selection: which schedule runs a given call.

Counterpart of accl_tpu/sequencer/plan.py, rule for rule: the default
branches, the register-opened ones (the rendezvous reduce+bcast
allreduce, the two-tier HIER_RS_AR_AG composition with its tiered
synthesized arbitration, the latency-grid and standard synthesized
libraries, the stripe-overlapped allreduce) and the wire arbitration of
`select_wire` / `select_tier_wires`, and the degraded live-subset
ring (the source-masked allreduce over the declared survivors).
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
from ..descriptor import normalize_live_ranks


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
    tier_wires: tuple[DataType, DataType] = (DataType.none, DataType.none),
    tier_links=None,
    peer_counts: tuple[int, ...] = (),
    overlap_link=None,
    overlap_compute=None,
    tiered_synth_ok: bool = True,
    live_ranks: tuple[int, ...] = (),
) -> Plan:
    """Resolve scenario + message + communicator into a Plan, with the
    reference's rules collective by collective.

    `topology=(inner_world, outer_world)` declares a two-tier world:
    allreduce payloads inside the HIER_ALLREDUCE_MIN_COUNT window run the
    striped two-tier composition with `tier_wires=(inner, outer)` wire
    dtypes and the stripe count timing.best_stripes picks under
    `tier_links` (default: the shipped per-tier calibration; none means
    one stripe), unless a tiered library entry for that factoring
    predicts faster (`tiered_synth_ok=False` pins the composition).
    `overlap_link` and `overlap_compute` parameterize the
    OVERLAP_MIN_COUNT window's stripe count (default: the shipped
    calibration; none keeps the serial form). `peer_counts` is the
    alltoallv capacity vector; `live_ranks` the degraded survivor set.
    Every register at 0 leaves the default selection bit for bit."""
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

    # the degraded live-subset allreduce: checked before every performance
    # window (two-tier, synthesized, overlap, the rendezvous composition),
    # all calibrated for the full set of contributors. A full survivor set
    # is the ordinary allreduce and falls through (the facade folds it to
    # () so the two share one compiled program)
    if scenario == Operation.allreduce and live_ranks:
        lr = normalize_live_ranks(live_ranks, world_size)
        if lr != tuple(range(world_size)):
            if compression != CompressionFlags.NO_COMPRESSION:
                raise ValueError(
                    "live-subset allreduce is exact-wire only: the "
                    "certified degraded mode does not compose with "
                    "compression lanes")
            base = eager_plan(Algorithm.EAGER_RING_RS_AG,
                              world_align=world_size)
            return dataclasses.replace(base, live_ranks=lr)

    # the striped two-tier allreduce: inside the HIER_ALLREDUCE_MIN_COUNT
    # window on a declared two-tier world, checked before the flat
    # synthesized windows (calibrated on a uniform link); a tiered
    # library entry of this factoring wins the cell when it predicts
    # faster under the same per-tier calibration
    if scenario == Operation.allreduce and topology is not None:
        inner_w, outer_w = topology
        if (tuning.hier_allreduce_min_count > 0
                and inner_w > 1 and outer_w > 1
                and inner_w * outer_w == world_size
                and bytes_count >= tuning.hier_allreduce_min_count
                and stream == StreamFlags.NO_STREAM
                and compression == CompressionFlags.NO_COMPRESSION):
            from .timing import best_stripes, predict_tiered

            iw, ow = tier_wires
            links = tier_links
            if links is None:
                from ..telemetry.feedback import default_tier_links

                links = default_tier_links()
            stripes = 1
            if links is not None:
                stripes = best_stripes(
                    links, count, dtype_nbytes, inner_w, outer_w,
                    inner_wire=iw, outer_wire=ow)
            hier_plan = Plan(Protocol.EAGER, Algorithm.HIER_RS_AR_AG,
                             count, 1, inner_world=inner_w,
                             outer_world=outer_w, stripes=stripes,
                             inner_wire_dtype=iw, outer_wire_dtype=ow)
            if tiered_synth_ok and links is not None:
                from . import synthesis
                from .timing import predict_synth_tiered

                key = synthesis.select_entry(
                    scenario, world_size, bytes_count,
                    tiers=(inner_w, outer_w))
                if key is not None:
                    synth_plan = Plan(Protocol.EAGER,
                                      Algorithm.SYNTHESIZED, count, 1,
                                      synth_key=key,
                                      inner_world=inner_w,
                                      outer_world=outer_w)
                    t_synth = predict_synth_tiered(
                        links, synth_plan, count, dtype_nbytes)
                    t_hier = predict_tiered(links, hier_plan, count,
                                            dtype_nbytes)
                    if t_synth < t_hier:
                        return synth_plan
            return hier_plan

    # the latency-grid library (1-64 KiB), checked before the standard
    # synthesized window
    if (scenario == Operation.allreduce
            and tuning.synth_latency_max_count
            and 0 < bytes_count <= tuning.synth_latency_max_count
            and stream == StreamFlags.NO_STREAM
            and compression == CompressionFlags.NO_COMPRESSION):
        from . import synthesis

        key = synthesis.select_entry(scenario, world_size, bytes_count,
                                     grid="lat")
        if key is not None:
            return Plan(Protocol.EAGER, Algorithm.SYNTHESIZED,
                        count, 1, wire_dtype=wire, synth_key=key)

    synth_reg = {
        Operation.allreduce: tuning.synth_allreduce_max_count,
        Operation.allgather: tuning.synth_allgather_max_count,
        Operation.reduce_scatter: tuning.synth_reduce_scatter_max_count,
    }.get(scenario, 0)
    # the standard synthesized library: exact uncompressed unstreamed
    # calls only (its int8 entries are not rank-consistent, so they are
    # never auto-selected; synthesis.select_entry(wire="int8") names them)
    if (synth_reg and 0 < bytes_count <= synth_reg
            and stream == StreamFlags.NO_STREAM
            and compression == CompressionFlags.NO_COMPRESSION):
        from . import synthesis

        key = synthesis.select_entry(scenario, world_size, bytes_count)
        if key is not None:
            return Plan(Protocol.EAGER, Algorithm.SYNTHESIZED,
                        count, 1, wire_dtype=wire, synth_key=key)

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
        plan = eager_plan(Algorithm.EAGER_RING_RS_AG,
                          world_align=world_size)
        # the stripe-overlapped allreduce: inside the OVERLAP_MIN_COUNT
        # window an exact eager allreduce runs as Plan.stripes independent
        # stripe chains, timing.best_overlap_stripes' argmin under the
        # calibrated link and compute term (none: the serial plan)
        if (tuning.overlap_min_count > 0
                and compression == CompressionFlags.NO_COMPRESSION
                and bytes_count >= tuning.overlap_min_count):
            link, fit = overlap_link, overlap_compute
            if link is None or fit is None:
                from ..telemetry import feedback as _fb

                if fit is None:
                    fit = _fb.default_compute_fit()
                if link is None:
                    tl = _fb.default_tier_links()
                    link = tl.outer if tl is not None \
                        else _fb.default_link()
            if link is not None and fit is not None:
                from .timing import best_overlap_stripes

                stripes = best_overlap_stripes(
                    link, count, dtype_nbytes, world_size,
                    compute_s=fit.seconds(bytes_count),
                    rx_buf_bytes=eager_rx_buf_size)
                if stripes > 1:
                    seg = -(-count // stripes)
                    seg += (-seg) % world_size
                    # world-aligning the stripe segment can merge the tail
                    # stripes (count=100, world=8, S=8 -> seg=16 -> 7
                    # chains): the frozen stripe count is the chain count
                    # the lowering runs
                    n_seg = _segments(count, seg)
                    if n_seg > 1:
                        return dataclasses.replace(
                            plan, seg_count=seg, num_segments=n_seg,
                            stripes=n_seg)
        return plan

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


def select_wire(
    scenario: Operation,
    count: int,
    data_type: DataType,
    world_size: int,
    link,
    *,
    max_eager_size: int,
    eager_rx_buf_size: int,
    rx_buf_bytes: int,
    tuning: TuningParams,
    arith_table: dict | None = None,
    min_gain: float = 0.05,
    aggregate: bool = False,
    quantized_ok: bool = True,
) -> DataType:
    """Pick the wire dtype for a call by PREDICTED TIME — compression as
    a plan dimension, not a flag (HiCCL's point that compression and
    algorithm choice must be measured performance decisions).

    Candidates are the arithmetic-configuration rows whose uncompressed
    dtype matches the payload (fp32 -> {fp16, bf16, int8-blockwise} on
    the default table) plus the uncompressed baseline. Each candidate is
    re-planned (compressed calls route eager) and costed through the
    calibrated timing model with WIRE-byte accounting; a compressed wire
    is chosen only when it beats the baseline by more than `min_gain`
    relative — on latency-dominated small payloads, where wire bytes
    barely move the prediction, the call keeps its exact fp32 wire
    rather than paying quantization error for nothing.

    `link` is a timing.LinkParams. Returns the chosen compress_dtype
    (DataType.none = stay uncompressed); callers hand it to the facade's
    `compress_dtype=` seam unchanged. `quantized_ok=False` drops the
    blockwise lanes from the candidate set — pass
    `getattr(device, "supports_quantized_wire", False)` when selecting
    for a backend that may lack the quantized ring kernels, so the
    runner-up cast lane wins instead of the facade rejecting the pick.
    """
    from ..arithconfig import DEFAULT_ARITH_CONFIG
    from ..constants import dtype_nbytes
    from ..ops.compression import is_quantized
    from .timing import predict

    table = arith_table or DEFAULT_ARITH_CONFIG
    elem_bytes = dtype_nbytes(data_type)
    kw: dict = dict(max_eager_size=max_eager_size,
                    eager_rx_buf_size=eager_rx_buf_size, tuning=tuning)

    def cost(wire: DataType) -> float:
        comp = (CompressionFlags.ETH_COMPRESSED if wire != DataType.none
                else CompressionFlags.NO_COMPRESSION)
        plan = select_algorithm(scenario, count, elem_bytes, world_size,
                                comp, compress_dtype=wire, **kw)
        return predict(link, scenario, plan, count, elem_bytes, world_size,
                       rx_buf_bytes=rx_buf_bytes, aggregate=aggregate)

    t_none = cost(DataType.none)
    best, t_best = DataType.none, t_none
    for (unc, cmp_), row in table.items():
        if unc != data_type or cmp_ == unc:
            continue
        if not quantized_ok and is_quantized(row):
            continue
        t = cost(cmp_)
        if t < t_best and (t_none - t) > min_gain * t_none:
            best, t_best = cmp_, t
    return best


def select_tier_wires(
    count: int,
    data_type: DataType,
    topology: tuple[int, int],
    tier_links,
    *,
    arith_table: dict | None = None,
    min_gain: float = 0.05,
    quantized_ok: bool = True,
) -> tuple[DataType, DataType]:
    """Per-tier wire arbitration for the striped hierarchical allreduce:
    `select_wire`'s predicted-time decision, made ONCE PER LINK.

    The hierarchical cost decomposes by tier (timing.hier_phase_costs
    charges phases 1/3 to the inner link and phase 2 to the outer), so
    each tier's wire is chosen independently: the candidate set is the
    arithmetic-configuration rows for the payload dtype, each costed
    through predict_tiered with that tier's wire active and the other
    uncompressed, and a compressed wire wins only when it beats the
    tier's uncompressed baseline by `min_gain` of the TOTAL call time.
    The typical calibrated outcome is exactly HiCCL's: int8 codes on
    the slow DCN tier (where wire bytes dominate), fp32 kept exact on
    ICI (where the latency term dominates and quantization error buys
    nothing). Returns (inner_wire, outer_wire) — DataType.none = stay
    uncompressed — which callers hand to select_algorithm's
    `tier_wires=`."""
    from ..arithconfig import DEFAULT_ARITH_CONFIG
    from ..constants import dtype_nbytes
    from ..ops.compression import is_quantized
    from .timing import best_stripes, predict_tiered

    table = arith_table or DEFAULT_ARITH_CONFIG
    elem_bytes = dtype_nbytes(data_type)
    inner_w, outer_w = topology

    def cost(iw: DataType, ow: DataType) -> float:
        stripes = best_stripes(tier_links, count, elem_bytes, inner_w,
                               outer_w, inner_wire=iw, outer_wire=ow)
        plan = Plan(Protocol.EAGER, Algorithm.HIER_RS_AR_AG, count, 1,
                    inner_world=inner_w, outer_world=outer_w,
                    stripes=stripes, inner_wire_dtype=iw,
                    outer_wire_dtype=ow)
        return predict_tiered(tier_links, plan, count, elem_bytes)

    picks = []
    for tier in ("inner", "outer"):
        def with_tier(w: DataType) -> float:
            return cost(w, DataType.none) if tier == "inner" \
                else cost(DataType.none, w)

        t_none = with_tier(DataType.none)
        best, t_best = DataType.none, t_none
        for (unc, cmp_), row in table.items():
            if unc != data_type or cmp_ == unc:
                continue
            if not quantized_ok and is_quantized(row):
                continue
            t = with_tier(cmp_)
            if t < t_best and (t_none - t) > min_gain * t_none:
                best, t_best = cmp_, t
        picks.append(best)
    return picks[0], picks[1]
