"""Flight recorder: a bounded in-memory ring of the last N spans per
track, with dump-on-error wired into the sticky-retcode path.

Counterpart of accl_tpu/telemetry/recorder.py. It rides the span
emission seam the metrics registry does (a Tracer observer: facade
calls, sequence phases, per-step markers), keeps only the most recent N
per track (ACCL_FLIGHT_CAP, default 256), and when a call completes with
a sticky nonzero retcode (errors.notify_sticky_retcode, called from
BaseRequest.complete: a recv that timed out, a failed launch) freezes
the rings into a self-contained SPAN v1 post-mortem document: the
failing call's error marker span appended (cat "error", the op name,
its sticky retcode), the live metrics snapshot and drift verdict in its
meta, without full tracing ever having been enabled.

The last post-mortem is always kept in memory (`last_error_trace()`);
set ACCL_FLIGHT_DIR to also write each one to
<dir>/flight_last_error.json (file writes are opt-in so fault-injection
tests do not spray files).
"""

from __future__ import annotations

import json
import os
import pathlib
import threading
import time
from collections import deque
from typing import Any

from .tracer import SCHEMA_VERSION, get_tracer

DEFAULT_TRACK_CAPACITY = 256


class FlightRecorder:
    """Thread-safe per-track bounded span rings (drop-oldest)."""

    def __init__(self, track_capacity: int | None = None):
        if track_capacity is None:
            try:
                track_capacity = int(os.environ.get("ACCL_FLIGHT_CAP", "0"))
            except ValueError:
                track_capacity = 0
            if track_capacity <= 0:
                track_capacity = DEFAULT_TRACK_CAPACITY
        self.track_capacity = int(track_capacity)
        self._mu = threading.Lock()
        self._tracks: dict[str, deque[dict[str, Any]]] = {}
        self._last_error_trace: dict[str, Any] | None = None

    # -- observer ----------------------------------------------------------

    def __call__(self, ev: dict[str, Any]) -> None:
        track = ev.get("track", "?")
        with self._mu:
            dq = self._tracks.get(track)
            if dq is None:
                dq = self._tracks[track] = deque(
                    maxlen=self.track_capacity)
            dq.append(ev)

    # -- readout -----------------------------------------------------------

    def snapshot(self) -> list[dict[str, Any]]:
        """Every retained span, globally time-ordered."""
        with self._mu:
            spans = [ev for dq in self._tracks.values() for ev in dq]
        spans.sort(key=lambda ev: ev.get("ts_ns", 0))
        return spans

    def clear(self) -> None:
        with self._mu:
            self._tracks.clear()
            self._last_error_trace = None

    def to_trace(self, *, reason: str,
                 extra_meta: dict[str, Any] | None = None) -> dict[str, Any]:
        """Freeze the rings into a self-contained SPAN v1 document; the
        live metrics snapshot + sentinel verdict ride the meta so the
        post-mortem carries its own context."""
        meta: dict[str, Any] = {
            "flight_recorder": True,
            "reason": reason,
            "track_capacity": self.track_capacity,
        }
        try:
            from .metrics import get_observer

            meta.update(get_observer().trace_meta())
        except Exception:  # a metrics failure must not lose the dump
            pass
        if extra_meta:
            meta.update(extra_meta)
        return {"schema": SCHEMA_VERSION, "meta": meta,
                "spans": self.snapshot()}

    # -- dump-on-error -----------------------------------------------------

    def freeze_error(self, reason: str) -> dict[str, Any]:
        """Retain (and optionally write) the post-mortem for one sticky
        error."""
        doc = self.to_trace(reason=reason)
        with self._mu:
            self._last_error_trace = doc
        self._maybe_write(doc)
        return doc

    def _maybe_write(self, doc: dict[str, Any]) -> None:
        out = os.environ.get("ACCL_FLIGHT_DIR")
        if not out:
            return
        try:
            d = pathlib.Path(out)
            d.mkdir(parents=True, exist_ok=True)
            (d / "flight_last_error.json").write_text(
                json.dumps(doc, indent=1))
        except OSError:
            pass  # a full disk must not mask the real error

    def last_error_trace(self) -> dict[str, Any] | None:
        with self._mu:
            return self._last_error_trace


# ---------------------------------------------------------------------------
# process-wide instance
# ---------------------------------------------------------------------------

_recorder = FlightRecorder()
_armed = False


def get_recorder() -> FlightRecorder:
    return _recorder


def install(tracer: Any) -> None:
    global _armed
    tracer.add_observer(_recorder)
    _armed = True


def uninstall(tracer: Any) -> None:
    global _armed
    tracer.remove_observer(_recorder)
    _armed = False


def armed() -> bool:
    """True when the process-wide recorder rides the span stream (the
    sticky-retcode hook is a no-op otherwise)."""
    return _armed


def on_sticky_retcode(function_name: str, retcode: int, *,
                      detail: int = 0, rank: int | None = None,
                      count: int | None = None) -> dict[str, Any] | None:
    """Module-level dump-on-error entry (errors.notify_sticky_retcode
    forwards here). No-op unless the recorder is armed. The error
    marker span is EMITTED through the process tracer — every observer
    sees it (the metrics error counter increments, the recorder ring
    retains it) — then the rings freeze into the retained post-mortem
    document."""
    if not _armed:
        return None
    args: dict[str, Any] = {"retcode": int(retcode)}
    if detail:
        args["detail"] = int(detail)
    if rank is not None:
        args["rank"] = int(rank)
    if count is not None:
        args["count"] = int(count)
    get_tracer().emit(
        function_name, "error",
        "errors" if rank is None else f"emu/r{rank}",
        ts_ns=time.perf_counter_ns(), dur_ns=0, args=args)
    return _recorder.freeze_error(
        f"sticky retcode 0x{int(retcode):x} from {function_name}")


def on_deadline_miss(op: str, *, rank: int | None = None,
                     count: int | None = None,
                     predicted_s: float | None = None,
                     deadline_s: float | None = None,
                     elapsed_s: float | None = None,
                     suspect_rank: int | None = None,
                     retcode: int = 0) -> dict[str, Any] | None:
    """Host-side dump-on-error twin of ``on_sticky_retcode``: a missed
    model-derived deadline (a deadline policy's verdict) is an error
    event even when no sticky retcode exists.  Emits the marker span through the tracer (cat
    "error", ``deadline_missed: true`` — the metrics error counter sees
    it) and freezes the rings into the retained post-mortem.  No-op
    unless the recorder is armed; never raises."""
    if not _armed:
        return None
    args: dict[str, Any] = {"deadline_missed": True,
                            "retcode": int(retcode)}
    if rank is not None:
        args["rank"] = int(rank)
    if count is not None:
        args["count"] = int(count)
    if predicted_s is not None:
        args["predicted_s"] = float(predicted_s)
    if deadline_s is not None:
        args["deadline_s"] = float(deadline_s)
    if elapsed_s is not None:
        args["measured_s"] = float(elapsed_s)
    if suspect_rank is not None:
        args["suspect_rank"] = int(suspect_rank)
    get_tracer().emit(
        op, "error", "errors" if rank is None else f"emu/r{rank}",
        ts_ns=time.perf_counter_ns(), dur_ns=0, args=args)
    return _recorder.freeze_error(f"deadline missed on {op}")


def last_error_trace() -> dict[str, Any] | None:
    return _recorder.last_error_trace()
