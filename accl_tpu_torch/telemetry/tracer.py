"""In-process span tracer: the host half of the port's telemetry.

Counterpart of accl_tpu/telemetry/tracer.py, kept to the same contract
so the two packages exchange traces: a thread-safe, bounded,
drop-oldest ring of span events that the facade, the sequence machinery
and GPUDevice emit into, exported by telemetry.export.

One event schema (SPAN v1, SCHEMA_VERSION letter for letter the
reference's):

    {"name": str,      # operation / phase label ("allreduce", "lint")
     "cat": str,       # "call" | "step" | "phase" | "sequence" | "native"
                       #   | "compute" | "error"
     "track": str,     # render track: "facade", "device", "errors", ...
     "ts_ns": int,     # start, perf_counter_ns domain
     "dur_ns": int,    # duration (0 = instant marker, e.g. a step of a
                       #   prepared sequence, whose time is inside the
                       #   one graph replay)
     "args": {...}}    # detail keys: op, count, bytes, world, algorithm,
                       #   protocol, retcode, predicted_s, measured_s,
                       #   coef_messages, coef_bytes, signature, step, ...

A facade span is a host clock. On the card it covers the device time
only because a synchronous call waits on its request's CUDA event before
the span closes; a run_async span closes at dispatch and is marked
dispatch_only.

Tracing is off by default and costs one predicate per instrumented site
when off (`span()` returns a shared no-op object before any argument
handling). Enable it with ACCL_TELEMETRY=1 in the environment or
telemetry.enable().

The tracer is also the one emission seam of the always-on layer
(telemetry.metrics, telemetry.recorder): observers registered with
`add_observer()` receive every emitted event at emission time, whether
or not the ring itself is collecting. `span()` returns a live span
whenever the tracer is `active` (ring enabled or observers installed);
the ring retains events only when `enabled`.

A call's timing.predict estimate (`predicted_s`) is computed only where
something reads it: when the ring is collecting, or for a synchronous
call, whose measured span feeds the drift sentinel. A run_async call
with the ring off carries none.

Layer spans (`layer()`) time the work inside one dispatch: binding the
buffers (`bind`; args `in_place` and `staged` count the buffers a
captured graph takes where they lie and those it copies in), the load
(`load`: the graph's address-table write and its staged copies in), the
results (`results`: the fresh result allocations and the clones of what
staged steps left in the graph's memory; `copies` on both counts device
copies only), the per-step markers, placing results, plan resolution and
the launch. They are cat
"phase" on track "layer", so SPAN v1 holds them unchanged, and each
names the span that caused it in `args.parent` / `args.parent_ts_ns`
(the innermost live span open on its thread, or the one its emitter
names). Their gate is narrower than `active`: the ring collecting or a
torch.profiler session recording. With neither, `layer()` returns the
shared no-op and the always-on layer never sees one; the metrics
observer skips the track in any case.

While a torch.profiler session records, every live span also opens a
`torch.profiler.record_function` range named `accl:<track>/<name>`, so
the program's spans lie on the profiler's own clock, beside the device
timeline (the ring's `ts_ns` is perf_counter_ns, another epoch).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from torch.autograd import profiler as _profiler

SCHEMA_VERSION = "accl-tpu-trace-v1"

# default host ring capacity (spans); the ring drops OLDEST on overflow
# and counts the drops, as the reference's does
DEFAULT_CAPACITY = 65536

# the render track of layer spans (Tracer.layer)
LAYER_TRACK = "layer"

# per thread: the live spans open while the layer gate was open, the
# innermost last, from which a layer span takes its cause
_open = threading.local()


def _open_spans() -> list:
    stack = getattr(_open, "spans", None)
    if stack is None:
        stack = _open.spans = []
    return stack


class _NullSpan:
    """Shared no-op span: the disabled-tracing fast path. Reentrant and
    stateless, so one instance serves every call site."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        # false, so a call site can skip building args nobody records
        return False

    def set(self, **_kw) -> "_NullSpan":
        return self

    def emit(self) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _LiveSpan:
    """Context manager measuring one span; emitted into the tracer ring
    on exit. `set()` attaches args discovered mid-span (e.g. the plan a
    device resolved after dispatch). A `deferred` span measures its host
    time at exit and is emitted by `emit()`, once what it waits for (a
    CUDA event pair read at completion) is known; it may be entered more
    than once before that, and then starts at its first entry and lasts
    the sum of its entries.

    While the layer gate is open (ring collecting, or a profiler
    recording) the span is on its thread's stack of open spans for its
    lifetime, and under a profiler it also holds a record_function
    range."""

    __slots__ = ("_tracer", "name", "cat", "track", "args", "_t0", "dur_ns",
                 "cause", "deferred", "_pushed", "_range", "_entered")

    def __init__(self, tracer: "Tracer", name: str, cat: str, track: str,
                 args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.track = track
        self.args = args
        self._t0 = 0
        self._entered = 0
        self.dur_ns = 0
        # (name, ts_ns) of the span that caused a layer span; None takes
        # the innermost open one at entry
        self.cause = None
        self.deferred = False
        self._pushed = False
        self._range = None

    def __enter__(self) -> "_LiveSpan":
        profiling = _profiler._is_profiler_enabled
        if profiling:
            self._range = _profiler.record_function(
                f"accl:{self.track}/{self.name}")
            self._range.__enter__()
        if profiling or self._tracer._enabled:
            stack = _open_spans()
            if self.track == LAYER_TRACK:
                if self.cause is None and stack:
                    self.cause = (stack[-1].name, stack[-1]._t0)
                if self.cause is not None:
                    self.args["parent"], self.args["parent_ts_ns"] = \
                        self.cause
            stack.append(self)
            self._pushed = True
        self._entered = time.perf_counter_ns()
        if not self._t0:
            self._t0 = self._entered
        return self

    def set(self, **kw) -> "_LiveSpan":
        self.args.update(kw)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.dur_ns += time.perf_counter_ns() - self._entered
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        if self._pushed:
            stack = _open_spans()
            if stack and stack[-1] is self:
                stack.pop()
            elif self in stack:
                stack.remove(self)
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        if not self.deferred:
            self.emit()
        return False

    def emit(self) -> None:
        self._tracer.emit(self.name, self.cat, self.track,
                          ts_ns=self._t0, dur_ns=self.dur_ns, args=self.args)


class Tracer:
    """Thread-safe bounded span ring (drop-oldest, counted drops)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("ACCL_TELEMETRY", "0") not in (
                "", "0", "false", "off")
        self._enabled = bool(enabled)
        self.capacity = int(capacity)
        self._spans: deque = deque()
        self._mu = threading.Lock()
        self.drops = 0
        # observers are stored as an immutable tuple so the hot-path
        # read (`span()`'s predicate, `emit()`'s fan-out) is lock-free;
        # installs/removals copy-on-write under the ring lock
        self._observers: tuple = ()
        self.observer_errors = 0

    # -- switching ---------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def active(self) -> bool:
        """True when spans are worth building: the ring is collecting
        OR an observability observer (metrics registry, flight
        recorder) is installed. Emitters gate arg attachment on this,
        not on `enabled`, so live metrics see the plan/prediction keys
        even when nobody is recording a full trace."""
        return self._enabled or bool(self._observers)

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    # -- observers (the always-on observability seam) ----------------------

    def add_observer(self, fn) -> None:
        """Register a callable fed every emitted event (idempotent)."""
        with self._mu:
            if fn not in self._observers:
                self._observers = self._observers + (fn,)

    def remove_observer(self, fn) -> None:
        with self._mu:
            self._observers = tuple(o for o in self._observers if o is not fn)

    def _observe(self, ev: dict) -> None:
        for obs in self._observers:
            try:
                obs(ev)
            except Exception:
                # an observer bug must never take down the data plane;
                # counted so a broken observer is visible, not silent
                self.observer_errors += 1

    # -- emission ----------------------------------------------------------

    def span(self, name: str, cat: str = "call", track: str = "host",
             **args) -> "_NullSpan | _LiveSpan":
        """Start a span context manager. An inactive tracer (ring off,
        no observers) returns the shared no-op before touching the
        arguments."""
        if not (self._enabled or self._observers):
            return _NULL_SPAN
        return _LiveSpan(self, name, cat, track, args)

    @property
    def layering(self) -> bool:
        """The layer gate: the ring is collecting or a torch.profiler
        session is recording (a module flag read, no call)."""
        return self._enabled or _profiler._is_profiler_enabled

    def layer(self, name: str, *, cause: "_NullSpan | _LiveSpan | None" = None,
              deferred: bool = False, **args) -> "_NullSpan | _LiveSpan":
        """A layer span (cat "phase", track "layer") timing one part of
        a dispatch; the shared no-op unless the layer gate is open.
        `cause` is the span that caused it where that is not the
        innermost open one (work done at a request's completion names
        its dispatch); `deferred` leaves the emission to the span's
        `emit()`."""
        if not (self._enabled or _profiler._is_profiler_enabled):
            return _NULL_SPAN
        sp = _LiveSpan(self, name, "phase", LAYER_TRACK, args)
        if cause:
            sp.cause = (cause.name, cause._t0)
        sp.deferred = deferred
        return sp

    def emit(self, name: str, cat: str, track: str, *, ts_ns: int,
             dur_ns: int, args: dict | None = None) -> None:
        """Record one already-measured span (the direct form used when
        lifting device timings or replaying recorded ones). Observers
        see every event at emission; the ring retains it only when
        enabled."""
        if not (self._enabled or self._observers):
            return
        ev = {
            "name": name,
            "cat": cat,
            "track": track,
            "ts_ns": int(ts_ns),
            "dur_ns": int(dur_ns),
            "args": dict(args or {}),
        }
        if self._observers:
            self._observe(ev)
        if not self._enabled:
            return
        with self._mu:
            if len(self._spans) >= self.capacity:
                self._spans.popleft()
                self.drops += 1
            self._spans.append(ev)

    def extend(self, events: list[dict]) -> None:
        """Bulk-append pre-shaped span events (ring discipline applies;
        observers see each event exactly as emit() would feed them)."""
        if not (self._enabled or self._observers):
            return
        if self._observers:
            for ev in events:
                self._observe(ev)
        if not self._enabled:
            return
        with self._mu:
            for ev in events:
                if len(self._spans) >= self.capacity:
                    self._spans.popleft()
                    self.drops += 1
                self._spans.append(ev)

    # -- readout -----------------------------------------------------------

    def snapshot(self) -> list[dict]:
        """Non-destructive copy of the current ring contents."""
        with self._mu:
            return list(self._spans)

    def drain(self) -> list[dict]:
        """Remove and return every buffered span."""
        with self._mu:
            out = list(self._spans)
            self._spans.clear()
            return out

    def clear(self) -> None:
        with self._mu:
            self._spans.clear()
            self.drops = 0

    def to_trace(self, meta: dict | None = None) -> dict:
        """Package the current spans as a schema-versioned trace document
        (the on-disk / exchange format every exporter consumes).
        Observers exposing a `trace_meta()` hook (the metrics registry
        snapshot + drift-sentinel report) contribute to the meta, so
        every exported trace carries the live metrics next to its
        spans."""
        m = {"drops": self.drops}
        for obs in self._observers:
            tm = getattr(obs, "trace_meta", None)
            if tm is not None:
                try:
                    m.update(tm())
                except Exception:
                    self.observer_errors += 1
        if meta:
            m.update(meta)
        return {"schema": SCHEMA_VERSION, "meta": m, "spans": self.snapshot()}


_tracer = Tracer()


def get_tracer() -> Tracer:
    """The process-wide tracer every built-in emitter uses."""
    return _tracer


def enable() -> None:
    _tracer.enable()


def disable() -> None:
    _tracer.disable()
