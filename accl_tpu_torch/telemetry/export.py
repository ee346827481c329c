"""Trace export: event-schema validation, Chrome trace-event JSON, and
the predicted-vs-measured residual table.

Counterpart of accl_tpu/telemetry/export.py. The trace document
(tracer.Tracer.to_trace) is the one exchange format; this module turns
it into

  - Chrome trace-event JSON (Perfetto / chrome://tracing loadable): one
    named track (tid) per span `track`, complete events with
    microsecond timestamps, span args carried through verbatim;
  - a residual table: every span that carries both a prediction
    (args.predicted_s) and a measurement (dur_ns or args.measured_s)
    contributes |predicted - measured| / measured.

EVENT_SCHEMA is the reference's JSON Schema document, copied. The port
does not depend on the jsonschema package: validate_trace checks a
trace with its own validator for the keywords EVENT_SCHEMA uses (type,
properties, required, additionalProperties, items, enum, const,
minimum) under draft-07 semantics, and raises ValueError naming the path
of the first failing key.
"""

from __future__ import annotations

import json
import pathlib

from .tracer import SCHEMA_VERSION

# JSON Schema document for one trace file, the reference's copied. Span args are an open object
# (emitters attach detail freely) but the keys the residual/feedback
# machinery consumes are typed, so a drifted emitter fails validation
# instead of silently skewing the calibration.
EVENT_SCHEMA: dict = {
    "$schema": "http://json-schema.org/draft-07/schema#",
    "title": "accl-tpu trace",
    "type": "object",
    "required": ["schema", "spans"],
    "properties": {
        "schema": {"const": SCHEMA_VERSION},
        # meta stays open, but the observability keys the always-on
        # layer embeds are typed: a drifted registry snapshot or
        # sentinel report fails validation instead of silently shipping
        # a malformed metrics section in every exported trace
        "meta": {
            "type": "object",
            "properties": {
                "metrics": {
                    "type": "object",
                    "required": ["counters", "gauges", "histograms"],
                    "properties": {
                        "counters": {"type": "object"},
                        "gauges": {"type": "object"},
                        # per-series histogram rows are fully typed:
                        # the quantile keys MUST mirror
                        # metrics.QUANTILES via metrics.quantile_key
                        # (tests/test_torch_metrics.py pins the two
                        # against each other), so a quantile added
                        # without its type here fails the tests
                        "histograms": {
                            "type": "object",
                            "additionalProperties": {
                                "type": "array",
                                "items": {
                                    "type": "object",
                                    "required": ["labels", "count",
                                                 "sum", "window"],
                                    "properties": {
                                        "labels": {"type": "object"},
                                        "count": {"type": "integer"},
                                        "sum": {"type": "number"},
                                        "window": {"type": "integer"},
                                        "min": {"type": "number"},
                                        "max": {"type": "number"},
                                        "p50": {"type": "number"},
                                        "p95": {"type": "number"},
                                        "p99": {"type": "number"},
                                        "p99_9": {"type": "number"},
                                    },
                                    "additionalProperties": False,
                                },
                            },
                        },
                    },
                },
                "drift_sentinel": {
                    "type": "object",
                    "required": ["verdict", "flagged"],
                    "properties": {
                        "window": {"type": "integer"},
                        "verdict": {"type": "object"},
                        "flagged": {"type": "array",
                                    "items": {"type": "string"}},
                        "stragglers": {"type": "array"},
                    },
                },
                # per-rank wire-health counter snapshot (the stats2
                # surface: CRC/dup drops, selective-retransmit ack/nack
                # traffic, fault-injection tallies) — the escalation
                # policy's evidence for lossy-link vs dead-rank. Typed
                # so a drifted counter rendering fails validation.
                "wire_health": {
                    "type": "object",
                    "required": ["per_rank", "totals"],
                    "properties": {
                        "per_rank": {
                            "type": "object",
                            "additionalProperties": {
                                "type": "object",
                                "additionalProperties": {
                                    "type": "integer"},
                            },
                        },
                        "totals": {
                            "type": "object",
                            "additionalProperties": {"type": "integer"},
                        },
                    },
                },
            },
        },
        "spans": {
            "type": "array",
            "items": {
                "type": "object",
                "required": ["name", "cat", "track", "ts_ns", "dur_ns"],
                "properties": {
                    "name": {"type": "string"},
                    "cat": {
                        "type": "string",
                        # "compute": a timed compute stage next to the
                        # collectives (args.compute_bytes carries the
                        # operand bytes it materializes) — the
                        # ComputeFit calibration samples of the
                        # overlap pipeline (feedback.compute_samples).
                        # "error": the sticky-retcode marker the flight
                        # recorder emits at dump-on-error time
                        # (telemetry.recorder — args.retcode is the
                        # failing call's sticky error word)
                        "enum": ["call", "step", "phase", "sequence",
                                 "native", "compute", "error"],
                    },
                    "track": {"type": "string"},
                    "ts_ns": {"type": "integer", "minimum": 0},
                    "dur_ns": {"type": "integer", "minimum": 0},
                    "args": {
                        "type": "object",
                        "properties": {
                            "op": {"type": "string"},
                            "count": {"type": "integer"},
                            "bytes": {"type": "integer"},
                            "world": {"type": "integer"},
                            "algorithm": {"type": "string"},
                            "protocol": {"type": "string"},
                            "retcode": {"type": "integer"},
                            "detail": {"type": "integer"},
                            "predicted_s": {"type": "number"},
                            "measured_s": {"type": "number"},
                            "coef_messages": {"type": "number"},
                            "coef_bytes": {"type": "number"},
                            "signature": {"type": "string"},
                            "step": {"type": "integer"},
                            "rank": {"type": "integer"},
                            "d_passes": {"type": "integer"},
                            "d_parks": {"type": "integer"},
                            "d_seek_hit": {"type": "integer"},
                            "d_seek_miss": {"type": "integer"},
                            "compute_bytes": {"type": "integer"},
                            # the deadline-miss marker (resilience
                            # host-side verdicts, recorder
                            # .on_deadline_miss): a cat "error" span
                            # with no sticky retcode carries these
                            "deadline_missed": {"type": "boolean"},
                            "deadline_s": {"type": "number"},
                            "suspect_rank": {"type": "integer"},
                        },
                        "additionalProperties": True,
                    },
                },
            },
        },
    },
}


_TYPES = {
    "object": lambda v: isinstance(v, dict),
    "array": lambda v: isinstance(v, list),
    "string": lambda v: isinstance(v, str),
    "boolean": lambda v: isinstance(v, bool),
    # draft-07: a bool is no number, and a float with no fractional part
    # is an integer
    "number": lambda v: (isinstance(v, (int, float))
                         and not isinstance(v, bool)),
    "integer": lambda v: (not isinstance(v, bool)
                          and (isinstance(v, int)
                               or (isinstance(v, float) and v.is_integer()))),
}


def _equal(a, b) -> bool:
    """JSON equality: true and 1 differ, 1 and 1.0 do not."""
    if isinstance(a, bool) or isinstance(b, bool):
        return isinstance(a, bool) and isinstance(b, bool) and a == b
    return a == b


def _check(value, schema: dict, path: str) -> None:
    """Raise ValueError at the first keyword of `schema` that `value`
    violates; `path` names the value inside the document."""
    t = schema.get("type")
    if t is not None and not _TYPES[t](value):
        raise ValueError(f"{path}: {value!r} is not of type {t!r}")
    if "const" in schema and not _equal(value, schema["const"]):
        raise ValueError(f"{path}: {value!r} is not {schema['const']!r}")
    if "enum" in schema and not any(_equal(value, e)
                                    for e in schema["enum"]):
        raise ValueError(f"{path}: {value!r} is not one of "
                         f"{schema['enum']!r}")
    if ("minimum" in schema and _TYPES["number"](value)
            and value < schema["minimum"]):
        raise ValueError(f"{path}: {value!r} is less than the minimum "
                         f"{schema['minimum']!r}")
    if isinstance(value, dict):
        for key in schema.get("required", ()):
            if key not in value:
                raise ValueError(f"{path}: required key {key!r} is missing")
        props = schema.get("properties", {})
        extra = schema.get("additionalProperties", True)
        for key, v in value.items():
            if key in props:
                _check(v, props[key], f"{path}.{key}")
            elif extra is False:
                raise ValueError(f"{path}: key {key!r} is not allowed")
            elif isinstance(extra, dict):
                _check(v, extra, f"{path}.{key}")
    if isinstance(value, list) and "items" in schema:
        for i, v in enumerate(value):
            _check(v, schema["items"], f"{path}[{i}]")


def validate_trace(trace: dict) -> None:
    """Raise ValueError, naming the path of the failing key, when the
    trace violates EVENT_SCHEMA (the keywords it uses, draft-07)."""
    _check(trace, EVENT_SCHEMA, "$")


def to_chrome(trace: dict) -> dict:
    """Chrome trace-event JSON: one pid, one tid per span track (named
    via thread_name metadata so Perfetto labels the rows), complete (X)
    events in microseconds. Zero-duration spans (recorded sequence
    steps) are stretched to 1 ns so they stay clickable."""
    tracks: list[str] = []
    index: dict[str, int] = {}
    for sp in trace.get("spans", []):
        t = sp["track"]
        if t not in index:
            index[t] = len(tracks)
            tracks.append(t)
    events = [
        {
            "ph": "M",
            "pid": 0,
            "tid": i,
            "name": "thread_name",
            "args": {"name": t},
        }
        for i, t in enumerate(tracks)
    ]
    for sp in trace.get("spans", []):
        events.append({
            "ph": "X",
            "pid": 0,
            "tid": index[sp["track"]],
            "name": sp["name"],
            "cat": sp["cat"],
            "ts": sp["ts_ns"] / 1e3,
            "dur": max(sp["dur_ns"], 1) / 1e3,
            "args": sp.get("args", {}),
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"schema": trace.get("schema", SCHEMA_VERSION),
                      "meta": trace.get("meta", {})},
    }


def measured_seconds(span: dict) -> float:
    """A span's measured wall seconds: explicit args.measured_s when the
    emitter recorded one (native spans), else the span duration.
    Partially-populated spans (hand-built fixtures, truncated dumps)
    degrade to 0.0 — "no measurement" — rather than raising."""
    args = span.get("args") or {}
    try:
        if "measured_s" in args:
            return float(args["measured_s"])
        return float(span.get("dur_ns", 0)) / 1e9
    except (TypeError, ValueError):
        return 0.0


def residual_rows(trace: dict) -> list[dict]:
    """All spans carrying BOTH a prediction and a nonzero measurement,
    as rows of (name, track, predicted_s, measured_s, rel_err). Robust
    against empty and partially-populated traces: a span with no
    `predicted_s`, a non-numeric prediction, or a zero/absent
    measurement contributes no row (it has no residual to claim) —
    never an exception."""
    rows = []
    for sp in trace.get("spans", []):
        if not isinstance(sp, dict):
            continue
        args = sp.get("args") or {}
        if "predicted_s" not in args:
            continue
        if args.get("dispatch_only"):
            # an async span closed at dispatch: its duration is the
            # host seam, not the collective the prediction models —
            # comparing them would corrupt the residual table
            continue
        if sp.get("cat") == "error":
            # dump-on-error markers (sticky retcodes, deadline misses)
            # carry the failing call's predicted/elapsed pair as
            # DIAGNOSTIC detail — a wedged wait's elapsed time is not a
            # measurement of the collective, and one miss would skew
            # every residual median (and any band armed from it)
            continue
        meas = measured_seconds(sp)
        if meas <= 0:
            continue
        try:
            pred = float(args["predicted_s"])
        except (TypeError, ValueError):
            continue
        rows.append({
            "name": sp.get("name", "?"),
            "track": sp.get("track", "?"),
            "predicted_s": pred,
            "measured_s": meas,
            "rel_err": abs(pred - meas) / meas,
        })
    return rows


def median(xs: list[float]) -> float:
    if not xs:
        return float("nan")
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def residual_summary(rows: list[dict]) -> dict:
    """Aggregate the residual table: overall and per-op median relative
    error (|predicted - measured| / measured). An empty table (a trace
    from a run with no predictions, or drained before any call
    completed) yields the well-typed empty summary — `median_rel_err`
    is None, never NaN (NaN round-trips as Infinity-adjacent garbage
    through strict JSON consumers) and never an exception."""
    if not rows:
        return {"rows": 0, "median_rel_err": None,
                "per_op_median_rel_err": {}}
    by_op: dict[str, list[float]] = {}
    for r in rows:
        by_op.setdefault(r["name"], []).append(r["rel_err"])
    return {
        "rows": len(rows),
        "median_rel_err": median([r["rel_err"] for r in rows]),
        "per_op_median_rel_err": {
            op: median(errs) for op, errs in sorted(by_op.items())
        },
    }


# The wire-health counters of the stats2 surface that describe FAULT
# REPAIR activity — damage actually observed and absorbed (corrupt
# frames dropped, duplicates deduped, frames actually resent).  This is
# the resilience manager's lossy-vs-dark evidence, and deliberately
# EXCLUDES the nack/ack traffic counters: a survivor nacks a dead
# rank's silence (and a stalled healthy peer) too, so "someone is
# waiting" counters climb in BOTH cases and cannot distinguish them.
# Kept here — next to the export that renders them — so the exporter
# and the consumer read one list.
WIRE_FAULT_KEYS = (
    "crc_drops", "dup_drops", "retx_sent", "retx_miss",
)


def wire_health_report(stats_by_rank: dict) -> dict:
    """Normalize per-rank wire-health snapshots (device wire_stats()
    dicts keyed by rank; GPUDevice.wire_stats) into the trace-meta
    `wire_health` shape: string-keyed per-rank rows plus a totals row.
    Non-integer values and unknown keys pass through int-coerced /
    verbatim so a newer native counter never breaks an older exporter;
    an empty input yields the well-typed empty report."""
    per_rank: dict = {}
    totals: dict = {}
    for rank in sorted(stats_by_rank):
        row = {}
        for k, v in (stats_by_rank[rank] or {}).items():
            try:
                iv = int(v)
            except (TypeError, ValueError):
                continue
            row[str(k)] = iv
            totals[str(k)] = totals.get(str(k), 0) + iv
        per_rank[str(rank)] = row
    return {"per_rank": per_rank, "totals": totals}


def wire_health_rows(stats_by_rank: dict) -> list[dict]:
    """Flat per-rank rows (rank + every counter) for table rendering."""
    rep = wire_health_report(stats_by_rank)
    return [{"rank": rank, **row}
            for rank, row in sorted(rep["per_rank"].items(),
                                    key=lambda kv: int(kv[0]))]


def write_trace(path, trace: dict) -> None:
    pathlib.Path(path).write_text(json.dumps(trace, indent=1))


def read_trace(path) -> dict:
    return json.loads(pathlib.Path(path).read_text())
