"""Per-hop timing model: an alpha-beta cost over the schedules' shapes.

Counterpart of accl_tpu/sequencer/timing.py, copied arithmetic for
arithmetic, so that the port selects exactly what the reference selects
(the crossover scans compare floats against byte grids: a rounding or a
vectorised sum would move a register by one grid step):

    T(call) = alpha * messages_on_critical_path
            + bytes_on_critical_path / beta

Its uses: `predict` (expected seconds for a planned call), the striped
two-tier and stripe-overlapped pipelines' stripe counts
(`best_stripes`, `best_overlap_stripes`), and `tuning_crossovers`, the
switch points ACCL.autotune writes into the tuning registers.

The parameters come from the port's copy of the reference's timing
model (accl_tpu_torch/data/timing_model.json, read by
telemetry/feedback.py), fitted on the reference's native emulator and a
CPU mesh: they describe those hosts, not an NVIDIA card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

from ..constants import (
    DataType,
    Operation,
    QUANT_BLOCK_ELEMS,
    QUANT_SCALE_BYTES,
    STREAM_SEG_BYTES,
    dtype_nbytes,
    logp_allgather_max_bytes,
    logp_allreduce_max_bytes,
)
from .plan import Algorithm, Plan, Protocol


def wire_elem_bytes(elem_bytes: int, wire: DataType) -> float:
    """Effective bytes-per-element ON THE WIRE for a hop under the given
    wire dtype: cast lanes travel at the cast width, the blockwise int8
    lanes at 1 B plus the amortized per-block fp32 scale, and
    DataType.none at the payload width. This is the width predict() and
    the crossover scan charge — ETH_COMPRESSED calls must not be billed
    uncompressed bytes (they would never show the compression win the
    wire actually delivers)."""
    if wire == DataType.none:
        return float(elem_bytes)
    wb = float(dtype_nbytes(wire))
    if wire == DataType.int8:
        wb += QUANT_SCALE_BYTES / QUANT_BLOCK_ELEMS
    return wb


@dataclasses.dataclass(frozen=True)
class LinkParams:
    """alpha: seconds of fixed cost per message on the critical path
    (dispatch + header + matching); beta: sustained payload bytes/second
    of one link direction."""

    alpha: float
    beta: float

    def seconds(self, messages: float, nbytes: float) -> float:
        return self.alpha * messages + nbytes / self.beta


@dataclasses.dataclass(frozen=True)
class ComputeFit:
    """The measured busy-core term of the compute-communication overlap
    pipeline: seconds the compute stage spliced next to a collective
    needs to materialize `nbytes` of operand (the gradient bytes of a
    train step's backward). `alpha` is the fixed per-step cost
    (dispatch + bookkeeping of the compute stage), `rate` the sustained
    operand bytes produced per second. Calibrated from telemetry spans
    (telemetry.feedback.calibrate_compute_from_trace) the same way
    LinkParams is calibrated from hop spans — the compute term is a
    measured quantity, never an assumption. The fit is per workload
    family (bytes-of-gradient is a proxy for the model's backward cost
    at a fixed batch shape); re-calibrate when the workload changes."""

    alpha: float
    rate: float

    def seconds(self, nbytes: float) -> float:
        return self.alpha + nbytes / self.rate


def _nonneg_lstsq2(rows: list, y_vals: list) -> tuple[float, float]:
    """The shared two-parameter fit of the link and compute
    calibrations: column-scaled least squares (well-conditioned across
    the 1 KB-1 GB dynamic range) clamped non-negative (a degenerate
    sweep clamps at zero rather than producing a negative cost)."""
    import numpy as np

    A = np.array(rows, float)
    y = np.array(y_vals, float)
    scale = A.max(axis=0)
    scale[scale == 0] = 1.0
    x, *_ = np.linalg.lstsq(A / scale, y, rcond=None)
    x = np.maximum(x / scale, 0.0)
    return float(x[0]), float(x[1])


def calibrate_compute(samples: list[tuple[float, float]]) -> ComputeFit:
    """Least-squares fit of (alpha, 1/rate) from samples of
    (operand_bytes, measured_seconds) of the compute stage — the same
    non-negative clamped solve `calibrate` uses for the link."""
    alpha, inv_rate = _nonneg_lstsq2([[1.0, b] for b, _ in samples],
                                     [t for _, t in samples])
    if inv_rate <= 0:
        inv_rate = 1e-12  # latency-flat samples: effectively infinite rate
    return ComputeFit(alpha=alpha, rate=1.0 / inv_rate)


@dataclasses.dataclass(frozen=True)
class TierLinks:
    """Per-tier link parameters of a two-tier world: `inner` is the
    fast intra-slice link (ICI / local POE), `outer` the slow
    cross-slice link (DCN / TCP). Each tier is calibrated
    independently — telemetry.feedback.calibrate_tiers_from_trace
    refits each from its own tier-tagged spans — so the hierarchical
    predictions charge every phase's wire bytes to the link it actually
    crosses (HiCCL's per-tier-model posture)."""

    inner: LinkParams
    outer: LinkParams

    def of(self, tier: str) -> LinkParams:
        if tier == "inner":
            return self.inner
        if tier == "outer":
            return self.outer
        raise ValueError(f"unknown tier {tier!r}")


def emulator_link(model: dict[str, Any]) -> LinkParams:
    """The emulator-tier LinkParams of a timing-model document: the
    bcast per-collective row (the root-serialized collective whose
    aggregate and critical-path shapes coincide, so its alpha/beta are
    genuine per-message/per-byte host costs), with fallback to the
    legacy single-"link" key. The ONE resolution rule shared by
    ACCL.autotune and the accl_synth tool — a schema change lands here
    or nowhere."""
    lk = (model.get("link_per_collective", {}).get("bcast")
          or model.get("link"))
    if not lk:
        raise ValueError("timing model has neither link_per_collective "
                         "nor link; re-run python -m "
                         "accl_tpu_torch.tools.timing_model")
    return LinkParams(alpha=lk["alpha_us"] * 1e-6,
                      beta=lk["beta_gbps"] * 1e9)


def _segs(nbytes: int, rx_buf_bytes: int) -> int:
    return max(1, math.ceil(nbytes / max(rx_buf_bytes, 1)))


# The native runtime streams ring/tree hop payloads as jumbo-segment
# messages (runtime.cpp egr_send callers): one message latency per hop
# regardless of the rx-buffer geometry. Single-sourced with the executor
# in constants.py (tests/test_timing.py pins them to the C++ source).
_STREAM_SEG = STREAM_SEG_BYTES


def _logp_allreduce(world: int, nbytes: int) -> bool:
    """Mirror of the native hop-shape auto rule (runtime.cpp
    logp_max_bytes): power-of-two worlds run recursive halving-doubling
    while the payload is under the crossover bytes per hop saved. The
    crossover arithmetic lives in constants.logp_allreduce_max_bytes —
    the single source pinned against runtime.cpp — so a retune cannot
    desynchronize this model from the executor it predicts."""
    if world & (world - 1):
        return False
    return nbytes <= logp_allreduce_max_bytes(world)


def _logp_allgather(world: int, total_bytes: int) -> bool:
    """Native logp_ag_max_bytes rule: recursive doubling for small total
    payloads on power-of-two worlds (crossover single-sourced in
    constants.logp_allgather_max_bytes, like _logp_allreduce)."""
    if world & (world - 1):
        return False
    return total_bytes <= logp_allgather_max_bytes(world)


def _logp_forced(world: int, auto: bool, logp_shape: bool | None) -> bool:
    """Resolve the logp-vs-ring hop shape: the auto crossover rule by
    default, or the caller's override mirroring the native executor's
    ACCL_RT_SHAPE forcing (which, like the native rule, still requires
    a power-of-two world)."""
    if logp_shape is None:
        return auto
    return logp_shape and not (world & (world - 1))


def coefficients(
    op: Operation,
    plan: Plan,
    count: int,
    elem_bytes: int,
    world: int,
    *,
    rx_buf_bytes: int,
    logp_shape: bool | None = None,
) -> tuple[float, float]:
    """(messages, bytes) on the CRITICAL PATH of the planned schedule —
    the busiest serialized sequence of hops, mirroring the structures in
    schedules.py / the native do_* bodies. Rendezvous messages count 2
    (address notification + one-sided write). Bytes are WIRE bytes: a
    plan with an active wire_dtype charges the compressed element width
    (+ scale side-channel for the quantized lanes), and its segment
    counts follow the compressed payload too. `logp_shape` overrides the
    allreduce/allgather logp-vs-ring auto rule (True/False = the native
    ACCL_RT_SHAPE=logp/ring forcing; None = auto) so forced-shape sweep
    rows are costed on the schedule that actually ran."""
    n = count * wire_elem_bytes(elem_bytes, plan.wire_dtype)
    P = world
    if P <= 1 or plan.algorithm == Algorithm.NONE:
        return 0.0, 0.0
    alg = plan.algorithm
    if alg == Algorithm.SYNTHESIZED:
        # the cost shape lives with the library entry: per-step send
        # sizes of the synthesized hop-DAG, wire bytes included (the
        # int8 entries carry their own encode/decode lanes)
        from .synthesis import cost_shape, entry_for_key

        return cost_shape(entry_for_key(plan.synth_key).spec, count,
                          elem_bytes, aggregate=False)
    if alg == Algorithm.HIER_RS_AR_AG:
        # single-link fallback (the flat-link callers: refit sampling,
        # facade prediction): all phases summed over all stripes, both
        # tiers charged to the one link. The calibrated per-tier,
        # pipelined prediction is predict_tiered.
        return _hier_flat_cost(plan, count, elem_bytes, aggregate=False)
    s = _segs(n, rx_buf_bytes)  # eager segments per full-payload message

    if alg == Algorithm.EAGER_SENDRECV:
        return s, n
    if alg == Algorithm.RNDZV_SENDRECV:
        return 2, n
    if alg == Algorithm.EAGER_FLAT:
        # root serializes P-1 sends of n each (scatter's `count` is
        # already per-chunk by the descriptor convention, so n covers
        # both bcast and scatter)
        return (P - 1) * _segs(n, rx_buf_bytes), (P - 1) * n
    if alg == Algorithm.EAGER_RING:
        # daisy chain: P-1 sequential whole-payload streamed hops
        if op == Operation.allgather and \
                _logp_forced(P, _logp_allgather(P, P * n), logp_shape):
            # native recursive doubling: log2(P) steps, same volume
            return math.log2(P), (P - 1) * n
        return (P - 1) * _segs(n, _STREAM_SEG), (P - 1) * n
    if alg == Algorithm.EAGER_RING_RS_AG:
        S = max(plan.stripes, 1)
        if S > 1:
            # stripe-overlapped plan, SERIAL shape: the S independent
            # RS+AG chains run back to back (the dispatch->compute
            # form), so messages multiply by S while total wire bytes
            # stay 2n(P-1)/P. The pipelined (overlapped) form is
            # predict_overlapped — this is deliberately the cost of
            # NOT overlapping, so serial callers (the eager twin, the
            # crossover scan's baseline) are charged honestly. Striped
            # plans never take the logp shape: the stripes exist to
            # pipeline the ring.
            chunk = (n / S) / P
            return S * 2 * (P - 1) * _segs(int(chunk), _STREAM_SEG), \
                2 * (P - 1) * (n / P)
        chunk = n / P
        if _logp_forced(P, _logp_allreduce(P, n), logp_shape):
            # native recursive halving-doubling: 2*log2(P) exchange
            # steps carrying n(1-1/P) bytes per phase
            return 2 * math.log2(P), 2 * (P - 1) * chunk
        # ring: 2(P-1) steps of the 1/P chunk, streamed whole
        return 2 * (P - 1) * _segs(int(chunk), _STREAM_SEG), \
            2 * (P - 1) * chunk
    if alg == Algorithm.RNDZV_FLAT_TREE:
        if op in (Operation.gather, Operation.reduce):
            # handshakes overlap; P-1 one-sided writes serialize into the
            # root's link
            return 2.0, (P - 1) * n
        # bcast/scatter: root serializes P-1 rendezvous sends
        return 2 * (P - 1), (P - 1) * n
    if alg == Algorithm.RNDZV_BIN_TREE:
        r = math.ceil(math.log2(P)) if P > 1 else 0
        return 2 * r, r * n
    if alg == Algorithm.RNDZV_RING:
        # the native executor streams the allgather ring eagerly at every
        # size now (no per-hop address handshake), so a rendezvous-size
        # allgather costs ring hops, not 2x handshake messages
        if op == Operation.allgather:
            if _logp_forced(P, _logp_allgather(P, P * n), logp_shape):
                return math.log2(P), (P - 1) * n
            return (P - 1) * _segs(n, _STREAM_SEG), (P - 1) * n
        return 2 * (P - 1), (P - 1) * n
    if alg in (Algorithm.RNDZV_REDUCE_BCAST,
               Algorithm.RNDZV_REDUCE_SCATTER):
        # compositions carry their per-stage plans (plan.py resolves them
        # with the same tuning registers): sum the stages back to back
        if alg == Algorithm.RNDZV_REDUCE_BCAST:
            stage_ops = (Operation.reduce, Operation.bcast)
            stage_counts = (count, count)
        else:
            stage_ops = (Operation.reduce, Operation.scatter)
            stage_counts = (count * world, count)
        tm = tb = 0.0
        for sub_op, sub_count, sub_plan in zip(stage_ops, stage_counts,
                                               plan.stages):
            m, b = coefficients(sub_op, sub_plan, sub_count, elem_bytes,
                                world, rx_buf_bytes=rx_buf_bytes)
            tm += m
            tb += b
        return tm, tb
    if alg == Algorithm.FLAT_ALLTOALL:
        # pairwise rotation (.c:2140-2211): P-1 steps, each shipping one
        # `count`-element peer chunk per rank; eager exchanges stream
        # whole chunks (jumbo segments) since r5. Bytes are WIRE bytes
        # (n already charges wire_elem_bytes), so the int8 lane's
        # ~3.94x reduction shows up here — this is the shape the
        # ALLTOALL_COMPRESS_MIN_COUNT crossover scans.
        per = 2 if plan.protocol == Protocol.RENDEZVOUS else \
            _segs(n, _STREAM_SEG)
        return (P - 1) * per, (P - 1) * n
    if alg == Algorithm.FLAT_ALLTOALLV:
        # capacity-bounded rotation: same P-1 steps, but every hop moves
        # vmax = max(peer_counts) elements (the SPMD-uniform hop shape
        # schedules.alltoallv_schedule pads to), not the full slot
        nv = max(plan.peer_counts) * wire_elem_bytes(elem_bytes,
                                                     plan.wire_dtype)
        per = 2 if plan.protocol == Protocol.RENDEZVOUS else \
            _segs(int(nv), _STREAM_SEG)
        return (P - 1) * per, (P - 1) * nv
    if alg == Algorithm.BARRIER_GATHER_SCATTER:
        return 2 * (P - 1), 0.0
    raise ValueError(f"no cost shape for {alg}")


def coefficients_aggregate(
    op: Operation,
    plan: Plan,
    count: int,
    elem_bytes: int,
    world: int,
    *,
    rx_buf_bytes: int,
    logp_shape: bool | None = None,
) -> tuple[float, float]:
    """(messages, bytes) SUMMED OVER ALL RANKS — the cost shape a
    serialized host actually pays. The emulator runs its whole world on
    one CI core (accl_log/REPORT.md r5 analysis), so wall time tracks
    the total work moved through the machine, not the critical path:
    fitting this shape per collective put the fitted beta at the
    measured ~1.4-2 GB/s transport rate and the median error under
    1.15x, where the critical-path shape was 1.9-3x off. The
    critical-path `coefficients` remain the model for parallel hardware
    (the TPU tier and the tuning-register crossovers). Bytes are WIRE
    bytes and `logp_shape` forces the logp-vs-ring hop shape (see
    `coefficients`)."""
    n = count * wire_elem_bytes(elem_bytes, plan.wire_dtype)
    P = world
    if P <= 1 or plan.algorithm == Algorithm.NONE:
        return 0.0, 0.0
    alg = plan.algorithm
    if alg == Algorithm.SYNTHESIZED:
        from .synthesis import cost_shape, entry_for_key

        return cost_shape(entry_for_key(plan.synth_key).spec, count,
                          elem_bytes, aggregate=True)
    if alg == Algorithm.HIER_RS_AR_AG:
        return _hier_flat_cost(plan, count, elem_bytes, aggregate=True)
    r = math.ceil(math.log2(P)) if P > 1 else 0

    if alg in (Algorithm.EAGER_SENDRECV, Algorithm.RNDZV_SENDRECV,
               Algorithm.EAGER_FLAT, Algorithm.RNDZV_FLAT_TREE,
               Algorithm.BARRIER_GATHER_SCATTER):
        # root-serialized (or point-to-point) shapes: the critical path
        # IS the aggregate
        return coefficients(op, plan, count, elem_bytes, world,
                            rx_buf_bytes=rx_buf_bytes)
    if alg == Algorithm.EAGER_RING:
        if op == Operation.allgather:
            if _logp_forced(P, _logp_allgather(P, P * n), logp_shape):
                return P * r, P * (P - 1) * n
            return P * (P - 1) * _segs(n, _STREAM_SEG), P * (P - 1) * n
        if op == Operation.reduce:
            # fused recv-reduce-send chain: each non-root sends its
            # combined partial exactly once
            return (P - 1) * _segs(n, _STREAM_SEG), (P - 1) * n
        if op == Operation.reduce_scatter:
            # every rank relays P-1 chunk messages around the ring
            return P * (P - 1) * _segs(n, _STREAM_SEG), P * (P - 1) * n
        # gather daisy chain to root: rank at distance k relays k messages
        return P * (P - 1) / 2 * _segs(n, _STREAM_SEG), P * (P - 1) / 2 * n
    if alg == Algorithm.EAGER_RING_RS_AG:
        S = max(plan.stripes, 1)
        if S > 1:
            # striped serial shape summed over all ranks (see the
            # critical-path branch): S x the message count, same bytes
            chunk = (n / S) / P
            return S * 2 * P * (P - 1) * _segs(int(chunk), _STREAM_SEG), \
                2 * (P - 1) * n
        chunk = n / P
        if _logp_forced(P, _logp_allreduce(P, n), logp_shape):
            return 2 * P * r, 2 * (P - 1) * n
        return 2 * P * (P - 1) * _segs(int(chunk), _STREAM_SEG), \
            2 * (P - 1) * n
    if alg == Algorithm.RNDZV_BIN_TREE:
        # every non-root gets exactly one payload (bcast) / sends one
        # partial (reduce): handshake + write per edge
        return 2 * (P - 1), (P - 1) * n
    if alg == Algorithm.RNDZV_RING:
        if op == Operation.allgather:
            if _logp_forced(P, _logp_allgather(P, P * n), logp_shape):
                return P * r, P * (P - 1) * n
            return P * (P - 1) * _segs(n, _STREAM_SEG), P * (P - 1) * n
        return 2 * P * (P - 1), P * (P - 1) * n
    if alg in (Algorithm.RNDZV_REDUCE_BCAST,
               Algorithm.RNDZV_REDUCE_SCATTER):
        if alg == Algorithm.RNDZV_REDUCE_BCAST:
            stage_ops = (Operation.reduce, Operation.bcast)
            stage_counts = (count, count)
        else:
            stage_ops = (Operation.reduce, Operation.scatter)
            stage_counts = (count * world, count)
        tm = tb = 0.0
        for sub_op, sub_count, sub_plan in zip(stage_ops, stage_counts,
                                               plan.stages):
            m, b = coefficients_aggregate(sub_op, sub_plan, sub_count,
                                          elem_bytes, world,
                                          rx_buf_bytes=rx_buf_bytes)
            tm += m
            tb += b
        return tm, tb
    if alg == Algorithm.FLAT_ALLTOALL:
        # eager exchanges stream whole chunks (jumbo segments) since r5
        per = 2 if plan.protocol == Protocol.RENDEZVOUS else \
            _segs(n, _STREAM_SEG)
        return P * (P - 1) * per, P * (P - 1) * n
    if alg == Algorithm.FLAT_ALLTOALLV:
        nv = max(plan.peer_counts) * wire_elem_bytes(elem_bytes,
                                                     plan.wire_dtype)
        per = 2 if plan.protocol == Protocol.RENDEZVOUS else \
            _segs(int(nv), _STREAM_SEG)
        return P * (P - 1) * per, P * (P - 1) * nv
    raise ValueError(f"no aggregate cost shape for {alg}")


def _hier_flat_cost(plan: Plan, count: int, elem_bytes: int, *,
                    aggregate: bool) -> tuple[float, float]:
    """All stripes of all phases summed onto ONE link — the cost shape
    coefficients/coefficients_aggregate expose for HIER plans to
    single-link consumers."""
    S = max(plan.stripes, 1)
    tm = tb = 0.0
    for _tier, m, b in hier_phase_costs(plan, count, elem_bytes,
                                        aggregate=aggregate):
        tm += S * m
        tb += S * b
    return tm, tb


def hier_phase_costs(
    plan: Plan,
    count: int,
    elem_bytes: int,
    *,
    aggregate: bool = False,
) -> list[tuple[str, float, float]]:
    """(tier, messages, bytes) of the three phases of ONE STRIPE of the
    striped hierarchical allreduce (Algorithm.HIER_RS_AR_AG):

        1. inner reduce-scatter  — (L-1) ring hops of the 1/L chunk
        2. outer allreduce       — 2(P-1) ring hops of the 1/(L*P) chunk
        3. inner allgather       — (L-1) ring hops of the 1/L chunk

    Bytes are WIRE bytes PER TIER: phase 1/3 charge the inner wire
    dtype, phase 2 the outer one — this is the accounting that lets
    `select_tier_wires` see int8-on-DCN as a win without pretending ICI
    compressed too. aggregate=True sums over all ranks (the
    serialized-host regime); default is the per-link critical path."""
    L, P = max(plan.inner_world, 1), max(plan.outer_world, 1)
    S = max(plan.stripes, 1)
    stripe = -(-count // S)  # ceil
    padded = stripe + (-stripe) % L
    chunk = padded // L  # elements of one inner chunk == the outer shard
    n_i = chunk * wire_elem_bytes(elem_bytes, plan.inner_wire_dtype)
    shard_pad = chunk + (-chunk) % P
    n_o = (shard_pad // P) * wire_elem_bytes(elem_bytes,
                                             plan.outer_wire_dtype)
    m_rs = (L - 1) * _segs(int(n_i), _STREAM_SEG)
    b_rs = (L - 1) * n_i
    m_ar = 2 * (P - 1) * _segs(int(n_o), _STREAM_SEG)
    b_ar = 2 * (P - 1) * n_o
    if aggregate:
        # every rank runs every phase; a serialized host pays all of it
        world = L * P
        return [("inner", world * m_rs, world * b_rs),
                ("outer", world * m_ar, world * b_ar),
                ("inner", world * m_rs, world * b_rs)]
    return [("inner", m_rs, b_rs), ("outer", m_ar, b_ar),
            ("inner", m_rs, b_rs)]


def predict_tiered(
    links: TierLinks,
    plan: Plan,
    count: int,
    elem_bytes: int,
    *,
    aggregate: bool = False,
) -> float:
    """Expected seconds for a striped hierarchical allreduce plan with
    each phase charged to ITS OWN tier link, software pipelining
    included: the S stripes' chains overlap across the two link
    resources, so

        T = t_rs + t_ar + t_ag + (S - 1) * max(t_rs + t_ag, t_ar)

    — fill + drain of the pipeline plus S-1 repetitions of the
    bottleneck tier (the inner link runs both RS and AG, the outer link
    runs the shard allreduce; whichever is busier paces the steady
    state). aggregate=True models the serialized host, where nothing
    overlaps: T = S * sum(phases)."""
    phases = hier_phase_costs(plan, count, elem_bytes, aggregate=aggregate)
    t = [links.of(tier).seconds(m, b) for tier, m, b in phases]
    S = max(plan.stripes, 1)
    if aggregate:
        return S * sum(t)
    inner_busy = t[0] + t[2]
    outer_busy = t[1]
    return sum(t) + (S - 1) * max(inner_busy, outer_busy)


def best_stripes(
    links: TierLinks,
    count: int,
    elem_bytes: int,
    inner_world: int,
    outer_world: int,
    *,
    inner_wire: DataType = DataType.none,
    outer_wire: DataType = DataType.none,
    candidates: tuple[int, ...] = (1, 2, 4, 8),
    aggregate: bool = False,
) -> int:
    """The cost model's stripe count for a hierarchical allreduce: the
    S minimizing the pipelined prediction (ties break toward fewer
    stripes — less padding, smaller program). This is the ONLY source
    of Plan.stripes, so S is a measured-model decision, never a
    hardcoded constant."""
    best_s, best_t = 1, float("inf")
    for s in candidates:
        if s > max(count, 1):
            continue
        plan = Plan(Protocol.EAGER, Algorithm.HIER_RS_AR_AG, count, 1,
                    inner_world=inner_world, outer_world=outer_world,
                    stripes=s, inner_wire_dtype=inner_wire,
                    outer_wire_dtype=outer_wire)
        t = predict_tiered(links, plan, count, elem_bytes,
                           aggregate=aggregate)
        if t < best_t - 1e-15:
            best_s, best_t = s, t
    return best_s


def predict_synth_tiered(
    links: TierLinks,
    plan: Plan,
    count: int,
    elem_bytes: int,
    *,
    aggregate: bool = False,
) -> float:
    """Per-tier prediction for a SYNTHESIZED plan whose library entry
    is TIERED (synthesis.SynthSpec.tiers): every hop charged against
    its own TierLinks entry — the hier_phase_costs accounting
    generalized to tier-annotated hop-DAGs. The flat
    coefficients/predict path keeps charging both tiers to one link
    for single-link consumers (facade prediction, refit sampling);
    this is the calibrated form selection arbitrates with inside the
    HIER_ALLREDUCE_MIN_COUNT window."""
    from .synthesis import entry_for_key, predict_spec_tiered

    return predict_spec_tiered(links, entry_for_key(plan.synth_key).spec,
                               count, elem_bytes, aggregate=aggregate)


def predict_overlapped(
    params: LinkParams,
    plan: Plan,
    count: int,
    elem_bytes: int,
    world: int,
    *,
    compute_s: float,
    rx_buf_bytes: int,
    serial: bool = False,
) -> float:
    """Busy-link vs busy-core pipelined prediction for a
    stripe-overlapped eager ring allreduce (Plan.stripes = S on
    EAGER_RING_RS_AG) running next to the compute stage that produces
    its operand — the PR 8 fill + drain + (S-1)*max(...) pipeline shape
    generalized with a measured per-stripe compute term:

        T_overlap = c + lam + (S - 1) * max(c, o)
        T_serial  = compute_s + S * lam        (serial=True)

    where c = compute_s / S is the per-stripe busy-CORE term (the
    measured ComputeFit evaluation, split across stripes the way the
    backward materializes gradient stripes), lam the full critical-path
    latency of ONE stripe's RS+AG chain (every per-message fixed cost
    included — this is the pipeline's fill and drain), and o the
    per-stripe steady-state busy-LINK term: the stripe's wire bytes
    plus ONE per-message fixed cost. In steady state the sequencer
    injects one stripe at a time (one fixed cost each) while the
    remaining 2(P-1)-1 hop latencies of that stripe pipeline behind
    neighbouring stripes' compute and wire — alpha is dispatch +
    header + matching work (see LinkParams), not link occupancy, so
    independent chains amortize it; only the drain (the last stripe,
    with nothing left to hide behind) pays the whole chain latency.

    serial=True is the dispatch->compute form: all compute, then the S
    stripe chains back to back — the cost of the bitwise-identical
    serial twin (the same shape `coefficients` charges striped plans).
    """
    S = max(plan.stripes, 1)
    stripe = -(-count // S)
    sp = Plan(Protocol.EAGER, Algorithm.EAGER_RING_RS_AG, stripe, 1,
              wire_dtype=plan.wire_dtype)
    # logp_shape=False: a striped plan always lowers the ring chains
    # (the stripes exist to pipeline them), so the per-stripe cost
    # must never flip to the recursive halving-doubling shape the
    # unstriped auto rule would pick at small stripe payloads —
    # matching the striped branch of `coefficients` exactly
    m, b = coefficients(Operation.allreduce, sp, stripe, elem_bytes,
                        world, rx_buf_bytes=rx_buf_bytes,
                        logp_shape=False)
    lam = params.seconds(m, b)
    if serial or S == 1:
        return compute_s + S * lam
    occ = params.seconds(min(m, 1.0), b)
    c = compute_s / S
    return c + lam + (S - 1) * max(c, occ)


def best_overlap_stripes(
    params: LinkParams,
    count: int,
    elem_bytes: int,
    world: int,
    *,
    compute_s: float,
    rx_buf_bytes: int,
    candidates: tuple[int, ...] = (1, 2, 4, 8),
) -> int:
    """The cost model's stripe count for an overlapped gradient
    allreduce: the S minimizing the pipelined prediction (ties break
    toward fewer stripes — less padding, smaller program). Like
    best_stripes for the hierarchical composition, this is the ONLY
    source of an overlap plan's Plan.stripes, so S is a measured-model
    decision, never a hardcoded constant."""
    best_s, best_t = 1, float("inf")
    for s in candidates:
        if s > 1 and s * world > max(count, 1):
            continue  # every stripe must hold at least one world chunk
        plan = Plan(Protocol.EAGER, Algorithm.EAGER_RING_RS_AG, count, 1,
                    stripes=s)
        t = predict_overlapped(params, plan, count, elem_bytes, world,
                               compute_s=compute_s,
                               rx_buf_bytes=rx_buf_bytes)
        if t < best_t - 1e-15:
            best_s, best_t = s, t
    return best_s


def predict(
    params: LinkParams,
    op: Operation,
    plan: Plan,
    count: int,
    elem_bytes: int,
    world: int,
    *,
    rx_buf_bytes: int,
    aggregate: bool = False,
) -> float:
    """Expected seconds for the planned call on a link with `params`.
    aggregate=True uses the serialized-host cost shape (emulator tier);
    default is the critical path (parallel hardware)."""
    fn = coefficients_aggregate if aggregate else coefficients
    m, b = fn(op, plan, count, elem_bytes, world,
              rx_buf_bytes=rx_buf_bytes)
    return params.seconds(m, b)


def sequence_coefficients(
    calls: list[tuple[Operation, Plan, int, int]],
    world: int,
    *,
    rx_buf_bytes: int,
    aggregate: bool = False,
) -> tuple[float, float]:
    """(messages, bytes) for a recorded call sequence: the per-call cost
    shapes summed back to back (stages of a sequence serialize on their
    data dependencies, like the composed-collective shapes above).
    `calls` entries are (op, plan, count, elem_bytes)."""
    fn = coefficients_aggregate if aggregate else coefficients
    tm = tb = 0.0
    for op, plan, count, elem_bytes in calls:
        m, b = fn(op, plan, count, elem_bytes, world,
                  rx_buf_bytes=rx_buf_bytes)
        tm += m
        tb += b
    return tm, tb


def predict_sequence(
    params: LinkParams,
    calls: list[tuple[Operation, Plan, int, int]],
    world: int,
    *,
    rx_buf_bytes: int,
    aggregate: bool = False,
    dispatch_alpha: float = 0.0,
    fused: bool = True,
    compute_s: float = 0.0,
) -> float:
    """Expected seconds for a recorded sequence of calls.

    The wire work is identical either way; what fusion buys is the host
    seam: an eager sequence pays one program dispatch (plus the HBM
    materialization XLA cannot fuse across) PER CALL, a fused sequence
    pays exactly one for the whole batch. `dispatch_alpha` is that
    per-dispatch host cost (the timing model's dispatch_alpha_us tier
    or a measured per-call floor); fused=False models the eager chain
    so callers can evaluate fusion as a PERFORMANCE choice:

        gain = predict_sequence(..., fused=False) - predict_sequence(...)
             = (len(calls) - 1) * dispatch_alpha

    `compute_s` is the measured busy-core term of a compute stage
    recorded next to the collectives (a ComputeFit evaluation — the
    train step's backward spliced as a stream endpoint). A FUSED
    sequence containing a stripe-overlapped allreduce (Plan.stripes >
    1 on EAGER_RING_RS_AG) overlaps that compute with the wire through
    the busy-link vs busy-core pipeline (predict_overlapped); every
    other form — serial dispatch->compute, or no striped plan — pays
    compute + wire back to back (`coefficients` already charges a
    striped plan's serial chains S x their messages)."""
    olap = 0.0
    overlapped = False
    rest = []
    for call in calls:
        op, plan, count, elem_bytes = call
        if (fused and not aggregate and not overlapped and compute_s > 0
                and op == Operation.allreduce
                and plan.algorithm == Algorithm.EAGER_RING_RS_AG
                and plan.stripes > 1):
            olap = predict_overlapped(
                params, plan, count, elem_bytes, world,
                compute_s=compute_s, rx_buf_bytes=rx_buf_bytes)
            overlapped = True
            continue
        rest.append(call)
    tm, tb = sequence_coefficients(rest, world, rx_buf_bytes=rx_buf_bytes,
                                   aggregate=aggregate)
    n_dispatch = 1 if fused else max(len(calls), 1)
    t = params.seconds(tm, tb) + dispatch_alpha * n_dispatch + olap
    if not overlapped:
        t += compute_s
    return t


def predict_prepared(
    params: LinkParams,
    steps,
    plans,
    world: int,
    *,
    rx_buf_bytes: int,
    aggregate: bool = True,
    dispatch_alpha: float = 0.0,
) -> float:
    """Expected seconds for ONE dispatch of a prepared descriptor batch
    — the admission-control price of a tenant's steady-state step.

    `steps` are the batch's resolved CallOptions and `plans` the Plans
    they froze to (a _PreparedSequence's `desc.steps` / `plans`); steps
    whose plan never resolved (stream endpoints spliced at the seams)
    carry no wire cost and are skipped. Aggregate cost shape by default
    — the regime the shipped emulator fit calibrates, and the shape the
    per-step dispatch telemetry already predicts with."""
    calls = []
    for opts, plan in zip(steps, plans):
        if plan is None:
            continue
        calls.append((opts.scenario, plan, int(opts.count),
                      dtype_nbytes(opts.data_type)))
    if not calls:
        raise ValueError("prepared batch has no priceable steps "
                         "(every plan is None)")
    return predict_sequence(params, calls, world,
                            rx_buf_bytes=rx_buf_bytes,
                            aggregate=aggregate,
                            dispatch_alpha=dispatch_alpha, fused=True)


def calibrate(samples: list[tuple[float, float, float]]) -> LinkParams:
    """Least-squares fit of (alpha, 1/beta) from samples of
    (messages, bytes, measured_seconds): t ~= alpha*m + bytes*inv_beta.
    Non-negative solution (a degenerate sweep clamps at zero rather than
    producing a negative latency)."""
    alpha, inv_beta = _nonneg_lstsq2([[m, b] for m, b, _ in samples],
                                     [t for _, _, t in samples])
    if inv_beta <= 0:
        inv_beta = 1e-12  # pure-latency sweep: effectively infinite beta
    if alpha <= 0:
        alpha = 1e-9
    return LinkParams(alpha=alpha, beta=1.0 / inv_beta)


def tuning_crossovers(params: LinkParams, *, world: int = 8,
                      elem_bytes: int = 4,
                      rx_buf_bytes: int = 4096,
                      wire_dtype: DataType = DataType.none,
                      tier_links: "TierLinks | None" = None,
                      topology: tuple[int, int] | None = None,
                      compute_fit: "ComputeFit | None" = None) -> dict:
    """The model's own switch-over points for the five tuning registers
    (reference defaults accl.cpp:1198-1208: gather fan-in capped above
    32 KB, bcast flat <= 3 ranks, reduce flat <= 4 ranks or <= 32 KB).

    - bcast ranks: flat costs (P-1) serialized sends, the binary tree
      ceil(log2 P) rounds — the crossover is STRUCTURAL (P-1 vs log2 P),
      independent of alpha/beta: flat wins up to the largest P with
      P-1 <= ceil(log2 P).
    - reduce/gather byte thresholds: flat trees pay one round of latency
      but serialize (P-1) payloads into the root's link; trees pay
      log2(P) rounds of latency for log2(P) payloads. Crossover bytes =
      where the extra serialized payload time equals the saved round
      latency.

    `wire_dtype` evaluates the crossovers under an active compression
    lane: the latency-vs-serialization tradeoffs happen in WIRE bytes,
    but the registers are compared against UNCOMPRESSED payload bytes
    (select_algorithm's bytes_count), so byte thresholds scale up by
    elem_bytes / wire_elem_bytes — e.g. the int8 lanes stretch the
    flat-tree regime ~3.94x further in payload bytes. This is how
    autotune() moves its crossovers when the quantized lanes are on.

    Scope caveat: a wire_dtype tune is a declaration that the workload's
    collectives ride that wire. The byte registers are global (the
    reference's registers are too) and the rendezvous branches that
    consult them are reachable only by UNCOMPRESSED calls in this port
    (is_rendezvous requires NO_COMPRESSION) — so a session mixing
    compressed and uncompressed traffic should tune from its dominant
    regime; the minority shape sees registers calibrated for the other
    wire, exactly as with the reference's hand-picked globals.
    """
    P = world
    a, b = params.alpha, params.beta
    # payload-bytes per wire-byte: register thresholds live in payload
    # bytes while the latency/serialization arithmetic is wire bytes
    wire_ratio = elem_bytes / wire_elem_bytes(elem_bytes, wire_dtype)

    bcast_max = 1
    while (bcast_max + 1) - 1 <= math.ceil(math.log2(bcast_max + 1)):
        bcast_max += 1

    r = math.ceil(math.log2(P))
    # flat reduce: 2 latency + (P-1)n/b ; binomial: 2r latency + r*n/b
    denom = (P - 1 - r) / b
    reduce_cross = ((2 * r - 2) * a / denom * wire_ratio
                    if denom > 0 else float("inf"))
    # flat gather (unbounded fan-in) vs fan-in-capped binomial: same shape
    gather_cross = reduce_cross

    # rank crossover at a large representative payload (1 MB, where the
    # rank register governs — small payloads are the count register's
    # job): the last world where the flat tree's serialized payload still
    # beats the tree's extra latency rounds
    n_big = float(1 << 20)
    reduce_ranks = 1
    for pq in range(2, 65):
        rq = math.ceil(math.log2(pq))
        if 2 * a + (pq - 1) * n_big / b <= 2 * rq * a + rq * n_big / b:
            reduce_ranks = pq
        else:
            break

    # allreduce: ring RS+AG (the measured default) vs the reference's
    # rendezvous reduce+bcast composition (.c:1878-1887), arbitrated by
    # THIS model per (size, world) — the largest payload where the
    # composition still predicts faster (0: ring wins everywhere, the
    # emulator-measured outcome). Scanned through the real selection
    # rules so the stage shapes match what would actually run.
    from ..constants import Operation, TuningParams
    from .plan import select_algorithm

    comp_best = 0
    force_comp = TuningParams(allreduce_composition_max_count=1 << 62)
    ring_only = TuningParams()
    max_eager = rx_buf_bytes
    nbytes = max_eager * 2
    if wire_dtype != DataType.none:
        # compressed calls never take the rendezvous path (is_rendezvous
        # requires NO_COMPRESSION), so the reduce+bcast composition is
        # unreachable under an active wire: the ring is the only shape
        nbytes = (1 << 24) + 1
    while nbytes <= (1 << 24):
        count = max(nbytes // elem_bytes, 1)
        kw: dict = dict(max_eager_size=max_eager,
                        eager_rx_buf_size=rx_buf_bytes)
        t_comp = predict(params, Operation.allreduce,
                         select_algorithm(Operation.allreduce, count,
                                          elem_bytes, P, tuning=force_comp,
                                          **kw),
                         count, elem_bytes, P, rx_buf_bytes=rx_buf_bytes)
        t_ring = predict(params, Operation.allreduce,
                         select_algorithm(Operation.allreduce, count,
                                          elem_bytes, P, tuning=ring_only,
                                          **kw),
                         count, elem_bytes, P, rx_buf_bytes=rx_buf_bytes)
        if t_comp < t_ring:
            comp_best = nbytes
        nbytes *= 2

    # Synthesized-schedule crossovers: for each op with committed
    # library entries at this world, the largest payload where the best
    # fp32 synthesized schedule still predicts faster than the whole
    # hand-written zoo (synthesis.hand_written_best forces the
    # tuning-reachable alternatives too). 0 = no entry or never wins —
    # the register stays off and selection is unchanged. int8-wire
    # entries are deliberately excluded: select_algorithm never
    # auto-substitutes them (they are not rank-consistent — see the
    # synthesized branch in plan.select_algorithm), so the register
    # must describe exactly the fp32 window selection will honor.
    # Tiered entries are excluded too: their windows are PER-TIER
    # predictions against the striped composition, selected through
    # the HIER_ALLREDUCE_MIN_COUNT window's arbitration — scoring them
    # on this uniform link would claim a win the calibration never
    # measured.
    from . import synthesis as _synth

    synth_regs: dict[str, int] = {}
    for op_key, scen in (("allreduce", Operation.allreduce),
                         ("allgather", Operation.allgather),
                         ("reduce_scatter", Operation.reduce_scatter)):
        entries = [e for e in _synth.library().values()
                   if e.spec.op == op_key and e.spec.world == P
                   and not e.spec.wire and not e.spec.tiers
                   and e.spec.grid == "std"]
        best_bytes = 0
        if entries:
            sbytes = 1 << 10
            while sbytes <= (1 << 24):
                cnt = max(sbytes // elem_bytes, 1)
                t_synth = min(
                    _synth.predict_spec(params, e.spec, cnt, elem_bytes)
                    for e in entries)
                t_hand = _synth.hand_written_best(
                    params, scen, cnt, elem_bytes, P,
                    rx_buf_bytes=rx_buf_bytes)
                if t_synth < t_hand:
                    best_bytes = sbytes
                sbytes *= 2
        synth_regs[f"synth_{op_key}_max_bytes"] = best_bytes

    # Latency-window synthesized-schedule crossover: the end of the
    # CONTIGUOUS-FROM-BOTTOM winning run of the committed latency-grid
    # allreduce entries (synthesis.SIZE_GRID_LAT, 1-64 KiB — the
    # decode regime where the alpha term dominates) against the same
    # hand-written zoo. A MAX register like the synth trio, but the
    # scan STOPS at the first losing cell instead of keeping the
    # largest win: select_algorithm treats every payload under the
    # register as latency-window territory, so a loss below a win must
    # not be overclaimed. 0 = no lat entry or the smallest cell loses
    # — the register stays off and selection is bit-for-bit unchanged.
    lat_entries = [e for e in _synth.library().values()
                   if e.spec.op == "allreduce" and e.spec.world == P
                   and not e.spec.wire and not e.spec.tiers
                   and e.spec.grid == "lat"]
    lat_best = 0
    for sbytes in (_synth.SIZE_GRID_LAT if lat_entries else ()):
        cnt = max(sbytes // elem_bytes, 1)
        t_synth = min(
            _synth.predict_spec(params, e.spec, cnt, elem_bytes)
            for e in lat_entries)
        t_hand = _synth.hand_written_best(
            params, Operation.allreduce, cnt, elem_bytes, P,
            rx_buf_bytes=rx_buf_bytes)
        if t_synth >= t_hand:
            break  # a loss ends the contiguous-from-bottom window
        lat_best = sbytes
    synth_regs["synth_latency_max_bytes"] = lat_best

    # Quantized-alltoall crossover: the start of the CONTIGUOUS winning
    # suffix — the smallest alltoall payload (descriptor bytes_count =
    # count * elem_bytes, the register's comparison unit) such that the
    # int8 blockwise wire predicts faster than the exact fp32 wire by
    # more than `select_wire`'s min_gain bar at that size and every
    # LARGER swept size. A MIN register like the hier one: the
    # compressed wire's win is the bandwidth regime (~3.94x fewer wire
    # bytes per hop), while on the latency floor the prediction barely
    # moves and the exact wire is kept rather than paying quantization
    # error for nothing. Scanned through the real selection rules so
    # the costed plans are what would actually run; 0 = never clears
    # the gain bar on this link, the register stays off and selection
    # is bit-for-bit unchanged.
    from ..constants import CompressionFlags

    a2a_min = 0
    a2a_min_gain = 0.05
    a2a_tuning = TuningParams()
    nb = 1 << 10
    while nb <= (1 << 24):
        cnt = max(nb // elem_bytes, 1)
        akw: dict = dict(max_eager_size=rx_buf_bytes,
                         eager_rx_buf_size=rx_buf_bytes,
                         tuning=a2a_tuning)
        p_fp32 = select_algorithm(Operation.alltoall, cnt, elem_bytes, P,
                                  **akw)
        p_int8 = select_algorithm(Operation.alltoall, cnt, elem_bytes, P,
                                  CompressionFlags.ETH_COMPRESSED,
                                  compress_dtype=DataType.int8, **akw)
        t_fp32 = predict(params, Operation.alltoall, p_fp32, cnt,
                         elem_bytes, P, rx_buf_bytes=rx_buf_bytes)
        t_int8 = predict(params, Operation.alltoall, p_int8, cnt,
                         elem_bytes, P, rx_buf_bytes=rx_buf_bytes)
        if t_int8 < t_fp32 and (t_fp32 - t_int8) > a2a_min_gain * t_fp32:
            if a2a_min == 0:
                a2a_min = nb  # candidate start of the suffix
        else:
            a2a_min = 0  # loss above a win: suffix restarts
        nb *= 2

    # Hierarchical-allreduce crossover: with per-tier links and a
    # declared (inner, outer) topology, the START of the CONTIGUOUS
    # winning SUFFIX — the smallest payload such that the striped
    # two-tier composition (best stripe count per size) predicts faster
    # than the flat ring at that size and every LARGER swept size. The
    # register is a MIN threshold ([min, inf) window) because the
    # composition's win is the bandwidth regime: it moves 1/L of the
    # bytes on the slow tier but pays more message latencies, so it
    # loses the latency floor and wins from some size up. A win set
    # that does not extend to the top of the sweep cannot be expressed
    # by the single threshold and is NOT overclaimed (same contiguity
    # posture as the synth windows). The flat ring over a two-tier
    # world is paced by its SLOWEST links — every ring step includes
    # the cross-slice edges — so the flat side is charged to the outer
    # link. 0 = no tier calibration / no topology / never wins: the
    # register stays off and selection is bit-for-bit unchanged.
    hier_min = 0
    if tier_links is not None and topology is not None:
        L_in, P_out = topology
        if L_in > 1 and P_out > 1 and L_in * P_out == P:
            hkw: dict = dict(max_eager_size=rx_buf_bytes,
                             eager_rx_buf_size=rx_buf_bytes)
            nb = 1 << 10
            while nb <= (1 << 24):
                cnt = max(nb // elem_bytes, 1)
                s_best = best_stripes(tier_links, cnt, elem_bytes, L_in,
                                      P_out)
                hplan = Plan(Protocol.EAGER, Algorithm.HIER_RS_AR_AG,
                             cnt, 1, inner_world=L_in, outer_world=P_out,
                             stripes=s_best)
                t_hier = predict_tiered(tier_links, hplan, cnt,
                                        elem_bytes)
                flat = select_algorithm(
                    Operation.allreduce, cnt, elem_bytes, P,
                    tuning=ring_only, **hkw)
                t_flat = predict(tier_links.outer, Operation.allreduce,
                                 flat, cnt, elem_bytes, P,
                                 rx_buf_bytes=rx_buf_bytes)
                if t_hier < t_flat:
                    if hier_min == 0:
                        hier_min = nb  # candidate start of the suffix
                else:
                    hier_min = 0  # loss above a win: suffix restarts
                nb *= 2

    # Compute-communication overlap crossover: with a measured compute
    # term (ComputeFit, calibrated from telemetry spans of the workload's
    # compute stage), the START of the CONTIGUOUS winning SUFFIX — the
    # smallest streamed-allreduce payload such that the stripe-overlapped
    # schedule (best S per size, the argmin) predicts faster than the
    # serial dispatch->compute form at the SAME stripe count — the
    # bitwise-identical twin, compute then S chains back to back — by
    # more than `overlap_min_gain` of the serial time, at that size and
    # every LARGER swept size. Scanned under the SHAPED link when a
    # per-tier calibration exists (tier_links.outer — the slow-wire
    # regime the overlap claim lives in, the same link stripe selection
    # uses) else this link. A MIN register like the hier one; 0 = no
    # compute calibration or overlap never clears the bar, the register
    # stays off and selection is bit-for-bit the serial form.
    overlap_min = 0
    overlap_min_gain = 0.05
    if compute_fit is not None:
        olink = tier_links.outer if tier_links is not None else params
        nb = 1 << 10
        while nb <= (1 << 24):
            cnt = max(nb // elem_bytes, 1)
            comp_s = compute_fit.seconds(nb)
            s_best = best_overlap_stripes(
                olink, cnt, elem_bytes, P, compute_s=comp_s,
                rx_buf_bytes=rx_buf_bytes)
            oplan = Plan(Protocol.EAGER, Algorithm.EAGER_RING_RS_AG,
                         cnt, 1, stripes=s_best)
            t_on = predict_overlapped(olink, oplan, cnt, elem_bytes, P,
                                      compute_s=comp_s,
                                      rx_buf_bytes=rx_buf_bytes)
            t_serial = predict_overlapped(olink, oplan, cnt, elem_bytes,
                                          P, compute_s=comp_s,
                                          rx_buf_bytes=rx_buf_bytes,
                                          serial=True)
            if (s_best > 1 and t_on < t_serial
                    and (t_serial - t_on) > overlap_min_gain * t_serial):
                if overlap_min == 0:
                    overlap_min = nb  # candidate start of the suffix
            else:
                overlap_min = 0  # loss above a win: suffix restarts
            nb *= 2

    return {
        "alltoall_compress_min_bytes": a2a_min,
        "hier_allreduce_min_bytes": hier_min,
        "overlap_min_bytes": overlap_min,
        "bcast_flat_tree_max_ranks": bcast_max,
        "reduce_flat_tree_max_count_bytes": reduce_cross,
        "gather_flat_tree_max_count_bytes": gather_cross,
        "reduce_flat_tree_max_ranks": reduce_ranks,
        "allreduce_composition_max_bytes": comp_best,
        "world": P,
        "wire_dtype": wire_dtype.name,
        **synth_regs,
    }
