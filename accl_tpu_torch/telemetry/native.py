"""Raw per-call records -> SPAN v1 events, with their plan and cost.

Counterpart of accl_tpu/telemetry/native.py. The reference lifts the
records of its native emulator's trace ring into events here; the port
has no native runtime, and the same lift serves any raw per-call record
of the shape {opcode, count, bytes, start_ns, end_ns, retcode, detail,
d_passes, d_parks, d_seek_hit, d_seek_miss[, rank]}: on the card, a
traced call's CUDA-event duration makes one (chip_smoke.py's telemetry
phase). To the record the lift attaches what only the host knows:

  - the Operation name behind the opcode;
  - the Plan the shared selection rules resolve for that call, under
    the caller's eager geometry and registers;
  - the aggregate cost coefficients (messages, wire bytes) of that plan
    (timing.coefficients_aggregate), which let
    feedback.calibrate_from_trace turn measured spans into
    timing.calibrate samples;
  - the timing.predict estimate under a given LinkParams.

Tracks are named "emu/r<rank>" unless the caller names one. drain_world
drains every rank of a native EmuWorld (device/emu_device.py) through the
same lift, one track per rank.
"""

from __future__ import annotations

import time

from ..constants import Operation, TuningParams, dtype_nbytes, DataType
from ..sequencer.plan import select_algorithm
from ..sequencer.timing import LinkParams, coefficients_aggregate

# the reference's emulator-sweep eager/rx geometry: the default under
# which a raw record is re-planned when the caller does not say
# otherwise (a facade's own geometry is max_eager_size and
# eager_rx_buf_size)
DEFAULT_MAX_EAGER = 4096
DEFAULT_RX_BUF = 4096


def span_cost(
    op: Operation,
    count: int,
    elem_bytes: int,
    world: int,
    *,
    max_eager_size: int = DEFAULT_MAX_EAGER,
    rx_buf_bytes: int = DEFAULT_RX_BUF,
    tuning: TuningParams | None = None,
    logp_shape: bool | None = None,
):
    """(plan, messages, wire_bytes) for one call under the shared
    selection rules and the AGGREGATE cost shape (the serialized-host
    regime the shipped model is calibrated on). Returns (None, 0, 0)
    for calls with no data-plane cost shape (config/nop). `logp_shape`
    forces the logp (True) or ring (False) hop shape; None is the
    shared auto rule."""
    if op in (Operation.config, Operation.nop):
        return None, 0.0, 0.0
    plan = select_algorithm(
        op, count, elem_bytes, world,
        max_eager_size=max_eager_size,
        eager_rx_buf_size=rx_buf_bytes,
        tuning=tuning if tuning is not None else TuningParams.default(),
    )
    m, b = coefficients_aggregate(op, plan, count, elem_bytes, world,
                                  rx_buf_bytes=rx_buf_bytes,
                                  logp_shape=logp_shape)
    return plan, m, b


def aggregate_wire_gbps(
    op_name: str,
    nbytes: int,
    world: int,
    seconds: float,
    *,
    max_eager_size: int = DEFAULT_MAX_EAGER,
    rx_buf_bytes: int = DEFAULT_RX_BUF,
    tuning: TuningParams | None = None,
    logp_shape: bool | None = None,
) -> float:
    """Aggregate wire-bytes bandwidth of one measured sweep row: the
    TOTAL bytes the planned schedule moves across all ranks
    (timing.coefficients_aggregate) divided by the measured seconds
    (payload GB/s understates collectives that move (P-1)x their
    payload)."""
    if seconds <= 0 or nbytes <= 0:
        return float("nan")
    op = Operation[op_name]
    count = max(nbytes // 4, 1)
    _plan, _m, agg_bytes = span_cost(
        op, count, 4, world, max_eager_size=max_eager_size,
        rx_buf_bytes=rx_buf_bytes, tuning=tuning, logp_shape=logp_shape)
    return agg_bytes / seconds / 1e9


def native_event(
    raw: dict,
    *,
    world: int,
    track: str | None = None,
    link: LinkParams | None = None,
    max_eager_size: int = DEFAULT_MAX_EAGER,
    rx_buf_bytes: int = DEFAULT_RX_BUF,
    tuning: TuningParams | None = None,
    ts_base_ns: int | None = None,
    logp_shape: bool | None = None,
    tier: str | None = None,
) -> dict:
    """Lift one raw per-call record into a SPAN v1 event.

    `ts_base_ns` rebases the record's clock into the host
    perf_counter_ns domain (default: anchors the span's end at now,
    which keeps relative order within a rank).
    `tier` tags the span with the two-tier link it crossed
    (args["tier"] = "inner" | "outer", a SPAN v1-compatible detail
    key): feedback.calibrate_tiers_from_trace refits each tier from
    exactly its own labeled samples."""
    op = Operation(raw["opcode"])
    count = int(raw["count"])
    nbytes = int(raw["bytes"])
    elem_bytes = max(nbytes // count, 1) if count else 4
    plan, m, b = span_cost(
        op, count, elem_bytes, world, max_eager_size=max_eager_size,
        rx_buf_bytes=rx_buf_bytes, tuning=tuning, logp_shape=logp_shape)
    dur = max(int(raw["end_ns"]) - int(raw["start_ns"]), 0)
    if ts_base_ns is None:
        ts_base_ns = time.perf_counter_ns() - int(raw["end_ns"])
    args = {
        "op": op.name,
        "count": count,
        "bytes": nbytes,
        "world": world,
        "rank": int(raw.get("rank", 0)),
        "retcode": int(raw["retcode"]),
        "detail": int(raw["detail"]),
        "measured_s": dur / 1e9,
        "d_passes": int(raw["d_passes"]),
        "d_parks": int(raw["d_parks"]),
        "d_seek_hit": int(raw["d_seek_hit"]),
        "d_seek_miss": int(raw["d_seek_miss"]),
    }
    if tier is not None:
        args["tier"] = tier
    if plan is not None:
        args["algorithm"] = plan.algorithm.name
        args["protocol"] = plan.protocol.name
        args["coef_messages"] = float(m)
        args["coef_bytes"] = float(b)
        if link is not None:
            args["predicted_s"] = link.seconds(m, b)
    return {
        "name": op.name,
        "cat": "native",
        "track": track or f"emu/r{raw.get('rank', 0)}",
        "ts_ns": ts_base_ns + int(raw["start_ns"]),
        "dur_ns": dur,
        "args": args,
    }


def drain_world(
    emu_world,
    *,
    link: LinkParams | None = None,
    max_eager_size: int = DEFAULT_MAX_EAGER,
    rx_buf_bytes: int = DEFAULT_RX_BUF,
    tuning: TuningParams | None = None,
    tracer=None,
    logp_shape: bool | None = None,
    tier: str | None = None,
    track_prefix: str = "emu",
) -> tuple[list[dict], int]:
    """Drain every rank of an EmuWorld into SPAN v1 events, one track per
    rank. Returns (events, total_dropped); with a `tracer` the events are
    also appended to its ring. `tier` tags every drained span (a whole
    EmuWorld plays one tier of an emulated two-tier world); `track_prefix`
    keeps the tiers' tracks apart in the export."""
    events: list[dict] = []
    dropped = 0
    now = time.perf_counter_ns()
    for rank in emu_world.ranks:
        if rank is None:
            continue
        raw, d = rank.trace_read()
        dropped += d
        # anchor each rank's runtime-relative clock so its LAST span ends
        # now: ranks are ordered well enough for a timeline, and exactly
        # within each rank
        base = now - max((int(r["end_ns"]) for r in raw), default=0)
        for r in raw:
            events.append(native_event(
                r, world=len(emu_world.ranks),
                track=f"{track_prefix}/r{r.get('rank', 0)}",
                link=link, max_eager_size=max_eager_size,
                rx_buf_bytes=rx_buf_bytes, tuning=tuning,
                ts_base_ns=base, logp_shape=logp_shape, tier=tier))
    if tracer is not None:
        tracer.extend(events)
    return events, dropped


def default_wire_dtype() -> DataType:
    """Uncompressed wire (the raw records this module lifts carry no
    compression lane)."""
    return DataType.none


__all__ = [
    "span_cost",
    "aggregate_wire_gbps",
    "native_event",
    "drain_world",
    "DEFAULT_MAX_EAGER",
    "DEFAULT_RX_BUF",
    "dtype_nbytes",
]
