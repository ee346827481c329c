"""Streaming metrics registry and the drift sentinel: the always-on
half of the port's telemetry.

Counterpart of accl_tpu/telemetry/metrics.py, the same rule over the
same events, so a trace replayed through either package gives the same
registry, exposition and verdict. The trace ring (tracer.py) answers
"what happened, span by span" after the fact; this module answers "what
is happening now". It is fed at span-emission time (the facade's call
spans and the sequence phases and steps reach Tracer.emit, which hands
every event to its installed observers), never when a trace is drained.
The port's layer spans (track "layer", tracer.py), which the reference
does not emit, are skipped, so they never change what the rule gives:

  - a streaming metrics registry: counters, gauges and bounded
    streaming-quantile histograms (p50/p95/p99/p99.9 over a sliding
    sample window plus exact cumulative count/sum/min/max) keyed by
    (op, algorithm, protocol, world) labels, with Prometheus-style text
    exposition (`expose_text`) and a JSON snapshot that rides the SPAN
    v1 trace meta (Tracer.to_trace embeds it);

  - the drift sentinel: rolling-window predicted-vs-measured residuals
    per op (a span's predicted_s beside its measurement, the pair the
    residual table reads), a frozen reference band armed from the first
    samples, and a band-leave verdict. Per-rank measurements (spans of
    cat "native" with a rank) feed a straggler attribution.

Everything here is bounded: histogram windows, sentinel windows, and
the label space (collectives x algorithms x protocols x worlds, and the
capped tenant label), so an always-on registry cannot grow without
limit in a long-lived process.
"""

from __future__ import annotations

import math
import os
import threading
from collections import deque
from typing import Any, Callable, Iterable

from .export import measured_seconds, median as _median
from .tracer import LAYER_TRACK

# label key order is FIXED: the registry keys series by this tuple so
# exposition and snapshots are deterministic across runs
LABEL_KEYS = ("op", "algorithm", "protocol", "world")

# Cardinality-guarded label keys: every other label in this module draws
# from a closed set (collectives x algorithms x protocols x worlds), but
# a TENANT id is caller-supplied — an abusive or buggy tenant-id stream
# must not be able to mint unbounded series in an always-on registry or
# blow up the Prometheus exposition. Values past the cap collapse into
# the `other` overflow bucket (their observations still count — only
# the per-value attribution is lost) and the overflow is itself counted
# (accl_label_overflow_total), so saturation is visible, never silent.
GUARDED_LABEL_KEYS = ("tenant",)
LABEL_OVERFLOW_BUCKET = "other"
DEFAULT_LABEL_VALUE_CAP = 64


def _label_value_cap() -> int:
    """Env-tunable per-key cardinality cap (ACCL_METRICS_LABEL_CAP);
    clamped to >= 1 so at least one real value is always attributable."""
    raw = os.environ.get("ACCL_METRICS_LABEL_CAP", "")
    try:
        cap = int(raw) if raw else DEFAULT_LABEL_VALUE_CAP
    except ValueError:
        cap = DEFAULT_LABEL_VALUE_CAP
    return max(cap, 1)

DEFAULT_HISTOGRAM_WINDOW = 512
# p99.9 rides the same 512-sample window as the rest: nearest-rank over
# 512 samples makes it the window maximum until ~1000 samples would fit,
# which is exactly the honest tail readout an interactive-serving gate
# wants (the worst step seen in the last window, stabilizing as windows
# grow) — not a fabricated interpolation past the data
QUANTILES = (0.5, 0.95, 0.99, 0.999)


def quantile_key(q: float) -> str:
    """Snapshot/JSON key for a quantile: p50, p95, p99, p99_9 — the
    fractional part joins with '_' so 0.999 cannot collide with 0.99
    (int(q*100) maps both to 99)."""
    return "p" + f"{q * 100:g}".replace(".", "_")

LabelsKey = tuple[tuple[str, str], ...]


def _labels_key(labels: dict[str, Any]) -> LabelsKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _quantile(sorted_xs: list[float], q: float) -> float:
    """Nearest-rank quantile (ceil(q*n)-1) over a sorted window."""
    if not sorted_xs:
        return float("nan")
    idx = max(math.ceil(q * len(sorted_xs)) - 1, 0)
    return sorted_xs[min(idx, len(sorted_xs) - 1)]


class Counter:
    """Monotonic counter (float increments allowed: byte totals)."""

    __slots__ = ("value", "_mu")

    def __init__(self) -> None:
        self.value = 0.0
        self._mu = threading.Lock()

    def inc(self, v: float = 1.0) -> None:
        with self._mu:
            self.value += v


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Bounded streaming-quantile histogram: exact cumulative
    count/sum/min/max plus a sliding window of the last `window`
    samples from which p50/p95/p99/p99.9 are computed on demand. Bounded by
    construction — an always-on series can never grow past its window
    no matter how long the process lives."""

    __slots__ = ("count", "sum", "min", "max", "_window", "_mu")

    def __init__(self, window: int = DEFAULT_HISTOGRAM_WINDOW) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._window: deque[float] = deque(maxlen=max(int(window), 1))
        self._mu = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._mu:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            self._window.append(v)

    def quantiles(self) -> dict[float, float]:
        with self._mu:
            xs = sorted(self._window)
        return {q: _quantile(xs, q) for q in QUANTILES}

    def snapshot(self) -> dict[str, Any]:
        with self._mu:
            xs = sorted(self._window)
        out: dict[str, Any] = {
            "count": self.count,
            "sum": self.sum,
            "window": len(xs),
        }
        if xs:
            out["min"] = self.min
            out["max"] = self.max
            for q in QUANTILES:
                out[quantile_key(q)] = _quantile(xs, q)
        return out


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(key: LabelsKey, extra: tuple[tuple[str, str], ...] = ()) -> str:
    items = key + extra
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in items)
    return "{" + body + "}"


class MetricsRegistry:
    """Thread-safe named-series registry. Series are created lazily on
    first touch and keyed by (metric name, sorted label tuple).

    Caller-supplied label keys (``GUARDED_LABEL_KEYS``, i.e. `tenant`)
    are cardinality-guarded: the first `label_value_cap` distinct
    values get their own series, every later value lands in the
    ``other`` overflow bucket and bumps ``accl_label_overflow_total``
    — so a hostile tenant-id stream bounds the registry instead of
    growing it."""

    def __init__(self, histogram_window: int = DEFAULT_HISTOGRAM_WINDOW,
                 label_value_cap: int | None = None):
        self._mu = threading.Lock()
        self._histogram_window = histogram_window
        self._label_value_cap = (max(int(label_value_cap), 1)
                                 if label_value_cap is not None
                                 else _label_value_cap())
        self._guarded_values: dict[str, set[str]] = {}
        self._counters: dict[tuple[str, LabelsKey], Counter] = {}
        self._gauges: dict[tuple[str, LabelsKey], Gauge] = {}
        self._histograms: dict[tuple[str, LabelsKey], Histogram] = {}

    # -- label cardinality guard -------------------------------------------

    def _guard_labels(self, labels: dict[str, Any]) -> dict[str, Any]:
        """Map guarded label values past the cap onto the overflow
        bucket. Admission is first-come: the set of attributed values
        freezes once full, so the series space is bounded for the
        process lifetime no matter what ids arrive later."""
        overflowed: list[str] = []
        for k in GUARDED_LABEL_KEYS:
            if k not in labels:
                continue
            v = str(labels[k])
            if v == LABEL_OVERFLOW_BUCKET:
                continue
            seen = self._guarded_values.get(k)
            if seen is not None and v in seen:
                continue
            with self._mu:
                seen = self._guarded_values.setdefault(k, set())
                if v in seen:
                    continue
                if len(seen) < self._label_value_cap:
                    seen.add(v)
                    continue
            labels = {**labels, k: LABEL_OVERFLOW_BUCKET}
            overflowed.append(k)
        # outside _mu: counter() re-acquires the registry lock on a
        # first-touch miss
        for k in overflowed:
            self.counter("accl_label_overflow_total", label=k).inc()
        return labels

    def guarded_values(self, key: str) -> frozenset[str]:
        """The attributed value set for a guarded label key (what got a
        series of its own before the cap)."""
        with self._mu:
            return frozenset(self._guarded_values.get(key, ()))

    # -- series access -----------------------------------------------------

    def counter(self, name: str, **labels: Any) -> Counter:
        labels = self._guard_labels(labels)
        key = (name, _labels_key(labels))
        c = self._counters.get(key)
        if c is None:
            with self._mu:
                c = self._counters.setdefault(key, Counter())
        return c

    def gauge(self, name: str, **labels: Any) -> Gauge:
        labels = self._guard_labels(labels)
        key = (name, _labels_key(labels))
        g = self._gauges.get(key)
        if g is None:
            with self._mu:
                g = self._gauges.setdefault(key, Gauge())
        return g

    def histogram(self, name: str, **labels: Any) -> Histogram:
        labels = self._guard_labels(labels)
        key = (name, _labels_key(labels))
        h = self._histograms.get(key)
        if h is None:
            with self._mu:
                h = self._histograms.setdefault(
                    key, Histogram(self._histogram_window))
        return h

    def clear(self) -> None:
        with self._mu:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._guarded_values.clear()

    # -- readout -----------------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """JSON-ready registry state — the document Tracer.to_trace
        embeds in the SPAN v1 meta (``meta["metrics"]``)."""
        with self._mu:
            counters = list(self._counters.items())
            gauges = list(self._gauges.items())
            histograms = list(self._histograms.items())

        def rows(items: Iterable, render: Callable) -> dict[str, list]:
            by_name: dict[str, list] = {}
            for (name, key), series in sorted(items, key=lambda kv: kv[0]):
                row = {"labels": dict(key)}
                row.update(render(series))
                by_name.setdefault(name, []).append(row)
            return by_name

        return {
            "counters": rows(counters, lambda c: {"value": c.value}),
            "gauges": rows(gauges, lambda g: {"value": g.value}),
            "histograms": rows(histograms, lambda h: h.snapshot()),
        }

    def expose_text(self) -> str:
        """Prometheus text exposition (counters and gauges as-is;
        histograms as summary-style quantile series plus _sum/_count)."""
        lines: list[str] = []
        with self._mu:
            counters = sorted(self._counters.items(), key=lambda kv: kv[0])
            gauges = sorted(self._gauges.items(), key=lambda kv: kv[0])
            histograms = sorted(self._histograms.items(),
                                key=lambda kv: kv[0])
        seen: set[str] = set()
        for (name, key), c in counters:
            if name not in seen:
                seen.add(name)
                lines.append(f"# TYPE {name} counter")
            lines.append(f"{name}{_fmt_labels(key)} {c.value:g}")
        for (name, key), g in gauges:
            if name not in seen:
                seen.add(name)
                lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{_fmt_labels(key)} {g.value:g}")
        for (name, key), h in histograms:
            if name not in seen:
                seen.add(name)
                lines.append(f"# TYPE {name} summary")
            for q, v in h.quantiles().items():
                lines.append(
                    f"{name}{_fmt_labels(key, (('quantile', f'{q:g}'),))}"
                    f" {v:g}")
            lines.append(f"{name}_sum{_fmt_labels(key)} {h.sum:g}")
            lines.append(f"{name}_count{_fmt_labels(key)} {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# drift sentinel
# ---------------------------------------------------------------------------

DEFAULT_SENTINEL_WINDOW = 64
DEFAULT_SENTINEL_MIN_SAMPLES = 8
DEFAULT_SENTINEL_BAND_FACTOR = 3.0
# the absolute floor under the band: a reference armed on a near-perfect
# fit (residuals ~0.02) must not flag ordinary mesh jitter as drift
DEFAULT_SENTINEL_BAND_FLOOR = 0.25


class DriftSentinel:
    """Rolling predicted-vs-measured residual watcher per op.

    Band semantics: for each op the sentinel
    keeps a bounded window of relative residuals ``|predicted_s -
    measured_s| / measured_s``. The first ``min_samples`` residuals arm
    a FROZEN reference (their median — the shipped calibration's honest
    error in the current regime); from then on the op is *out of band*
    when the rolling median exceeds ``max(reference * band_factor,
    reference + band_floor)``. A regime change (congestion, throttle,
    tenant interference) inflates
    every measurement against the stale prediction, the rolling median
    crosses the band within one window, and ``flagged()`` names the op;
    a stable run keeps drawing residuals from the reference
    distribution and stays quiet. Detection and report only: nothing
    applies registers from the verdict.

    Per-rank feeds (spans of cat "native" carrying a rank) drive a
    straggler attribution: per (op, count) the per-rank median
    measurement, the max-over-ranks vs median-of-ranks skew, and the
    argmax rank.
    """

    def __init__(self, window: int = DEFAULT_SENTINEL_WINDOW,
                 min_samples: int = DEFAULT_SENTINEL_MIN_SAMPLES,
                 band_factor: float = DEFAULT_SENTINEL_BAND_FACTOR,
                 band_floor: float = DEFAULT_SENTINEL_BAND_FLOOR):
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.band_factor = float(band_factor)
        self.band_floor = float(band_floor)
        self._mu = threading.Lock()
        self._residuals: dict[str, deque[float]] = {}
        self._reference: dict[str, float] = {}
        self._n_seen: dict[str, int] = {}
        # (op, count) -> rank -> bounded deque of measured seconds
        self._rank_meas: dict[tuple[str, int], dict[int, deque[float]]] = {}

    # -- feeding -----------------------------------------------------------

    def feed(self, op: str, predicted_s: float, measured_s: float) -> None:
        if measured_s <= 0:
            return
        rel = abs(float(predicted_s) - float(measured_s)) / float(measured_s)
        with self._mu:
            dq = self._residuals.get(op)
            if dq is None:
                dq = self._residuals[op] = deque(maxlen=self.window)
            dq.append(rel)
            self._n_seen[op] = self._n_seen.get(op, 0) + 1
            if op not in self._reference and len(dq) >= self.min_samples:
                self._reference[op] = _median(list(dq))

    def feed_rank(self, op: str, count: int, rank: int,
                  measured_s: float) -> None:
        if measured_s <= 0:
            return
        with self._mu:
            ranks = self._rank_meas.setdefault((op, int(count)), {})
            dq = ranks.get(int(rank))
            if dq is None:
                dq = ranks[int(rank)] = deque(maxlen=self.window)
            dq.append(float(measured_s))

    def set_reference(self, op: str, median_rel_err: float) -> None:
        """Pin an op's reference residual explicitly (e.g. from a
        committed calibration's known error) instead of self-arming."""
        with self._mu:
            self._reference[op] = float(median_rel_err)

    def reset(self) -> None:
        with self._mu:
            self._residuals.clear()
            self._reference.clear()
            self._n_seen.clear()
            self._rank_meas.clear()

    # -- verdicts ----------------------------------------------------------

    def band_hi(self, reference: float) -> float:
        return max(reference * self.band_factor,
                   reference + self.band_floor)

    def verdict(self) -> dict[str, dict[str, Any]]:
        """Per-op drift verdict: rolling median residual vs the frozen
        reference band. ``armed=False`` ops (fewer than ``min_samples``
        residuals seen) carry no in/out-of-band claim."""
        out: dict[str, dict[str, Any]] = {}
        with self._mu:
            items = [(op, list(dq)) for op, dq in self._residuals.items()]
            refs = dict(self._reference)
            seen = dict(self._n_seen)
        for op, xs in sorted(items):
            row: dict[str, Any] = {
                "n": seen.get(op, len(xs)),
                "window": len(xs),
                "median_rel_err": _median(xs),
            }
            ref = refs.get(op)
            if ref is None:
                row["armed"] = False
            else:
                hi = self.band_hi(ref)
                row.update(armed=True, reference=ref, band_hi=hi,
                           in_band=row["median_rel_err"] <= hi)
            out[op] = row
        return out

    def flagged(self) -> list[str]:
        """Ops whose rolling residual has left the band — the sentinel's
        one-line answer."""
        return [op for op, row in self.verdict().items()
                if row.get("armed") and not row["in_band"]]

    def straggler_report(self) -> list[dict[str, Any]]:
        """Per (op, count): per-rank median measured seconds, the
        max-over-ranks vs median-of-ranks skew, and which rank is the
        straggler. Needs >= 2 ranks reporting."""
        with self._mu:
            waves = [(key, {r: list(dq) for r, dq in ranks.items()})
                     for key, ranks in self._rank_meas.items()]
        out = []
        for (op, count), ranks in sorted(waves):
            if len(ranks) < 2:
                continue
            per_rank = {r: _median(xs) for r, xs in sorted(ranks.items())}
            med = _median(list(per_rank.values()))
            worst_rank = max(per_rank, key=lambda r: per_rank[r])
            out.append({
                "op": op,
                "count": count,
                "ranks": len(per_rank),
                "per_rank_median_s": per_rank,
                "median_s": med,
                "max_s": per_rank[worst_rank],
                "skew": per_rank[worst_rank] / med if med > 0
                else float("nan"),
                "straggler_rank": worst_rank,
            })
        return out

    def report(self) -> dict[str, Any]:
        """The JSON block the trace meta carries: verdict + flags +
        straggler attribution."""
        return {
            "window": self.window,
            "min_samples": self.min_samples,
            "band_factor": self.band_factor,
            "band_floor": self.band_floor,
            "verdict": self.verdict(),
            "flagged": self.flagged(),
            "stragglers": self.straggler_report(),
        }


# ---------------------------------------------------------------------------
# the span -> metrics rule (the observer Tracer.emit feeds)
# ---------------------------------------------------------------------------


def _series_labels(ev: dict[str, Any], args: dict[str, Any]) -> dict[str, Any]:
    return {
        "op": args.get("op") or ev.get("name", "?"),
        "algorithm": args.get("algorithm", "?"),
        "protocol": args.get("protocol", "?"),
        "world": args.get("world", 0),
    }


class MetricsObserver:
    """The Tracer observer: lifts every emitted SPAN v1 event into
    registry updates and sentinel feeds. One instance per (registry,
    sentinel) pair; ``install()`` wires the process-wide one."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 sentinel: DriftSentinel | None = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.sentinel = sentinel if sentinel is not None else DriftSentinel()

    def __call__(self, ev: dict[str, Any]) -> None:
        if ev.get("track") == LAYER_TRACK:
            # layer spans exist only while tracing or profiling: the
            # registry's series read the same with either off
            return
        reg = self.registry
        cat = ev.get("cat", "")
        args = ev.get("args") or {}
        if cat in ("call", "native"):
            labels = _series_labels(ev, args)
            reg.counter("accl_calls_total", **labels).inc()
            nbytes = args.get("bytes")
            if nbytes:
                reg.counter("accl_bytes_total", **labels).inc(float(nbytes))
            meas = measured_seconds(ev)
            if meas > 0 and not args.get("dispatch_only"):
                reg.histogram("accl_call_seconds", **labels).observe(meas)
                pred = args.get("predicted_s")
                if isinstance(pred, (int, float)):
                    self.sentinel.feed(labels["op"], float(pred), meas)
                if cat == "native" and "rank" in args:
                    self.sentinel.feed_rank(labels["op"],
                                            int(args.get("count", 0)),
                                            int(args["rank"]), meas)
            rc = args.get("retcode", 0)
            if rc:
                reg.counter("accl_errors_total", op=labels["op"],
                            retcode=rc).inc()
        elif cat == "step":
            # fused-batch steps execute inside ONE dispatch and never
            # appear as calls: the step counter is what keeps the op
            # mix of steady-state sequence traffic visible live
            reg.counter("accl_steps_total",
                        **_series_labels(ev, args)).inc()
        elif cat == "phase":
            meas = measured_seconds(ev)
            if meas > 0:
                reg.histogram("accl_phase_seconds",
                              phase=ev.get("name", "?")).observe(meas)
        elif cat == "sequence":
            reg.counter("accl_sequences_total").inc()
            meas = measured_seconds(ev)
            if meas > 0 and not args.get("dispatch_only"):
                reg.histogram("accl_sequence_seconds").observe(meas)
        elif cat == "error":
            reg.counter("accl_errors_total", op=ev.get("name", "?"),
                        retcode=args.get("retcode", 0)).inc()

    def trace_meta(self) -> dict[str, Any]:
        """Contribution to Tracer.to_trace's meta: the live registry
        snapshot + sentinel report ride every exported trace."""
        return {"metrics": self.registry.snapshot(),
                "drift_sentinel": self.sentinel.report()}


def replay_trace(trace: dict[str, Any],
                 observer: MetricsObserver | None = None) -> MetricsObserver:
    """Rebuild registry + sentinel state from an already-exported trace
    document: the offline twin of the
    live observer, running the SAME span -> metrics rule."""
    obs = observer if observer is not None else MetricsObserver()
    for sp in trace.get("spans", []):
        if isinstance(sp, dict):
            obs(sp)
    return obs


# ---------------------------------------------------------------------------
# process-wide instance
# ---------------------------------------------------------------------------

_observer = MetricsObserver()


def get_observer() -> MetricsObserver:
    return _observer


def get_registry() -> MetricsRegistry:
    """The process-wide registry the installed observer feeds."""
    return _observer.registry


def get_sentinel() -> DriftSentinel:
    """The process-wide drift sentinel."""
    return _observer.sentinel


def install(tracer: Any) -> None:
    """Attach the process-wide metrics observer to a tracer (idempotent)."""
    tracer.add_observer(_observer)


def uninstall(tracer: Any) -> None:
    tracer.remove_observer(_observer)
