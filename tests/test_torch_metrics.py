"""The port's always-on layer (accl_tpu_torch/telemetry/metrics.py and
recorder.py) against the JAX package's.

The reference's pure tests of tests/test_metrics.py run as cases
parametrised over both packages (`pkg`), so each holds the port to the
reference's contract and the two to one behaviour: the registry and its
label guard, the bounded histograms, the Prometheus exposition, the
span -> metrics observer rule, the tracer's observer seam, the drift
sentinel and the flight recorder with its sticky-retcode seam. Then the
committed traces accl_log/golden_trace.json and hier_trace.json replay
through both packages' replay_trace to equal registry snapshots,
identical exposition and equal sentinel reports (the golden trace flags
alltoall and names the rank-3 straggler).
"""

import importlib
import json
import pathlib
import threading

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKGS = ("accl_tpu", "accl_tpu_torch")


def _tel(pkg: str):
    """The package's telemetry: (package, metrics, recorder, tracer)."""
    t = importlib.import_module(f"{pkg}.telemetry")
    return t, t.metrics, t.recorder, importlib.import_module(
        f"{pkg}.telemetry.tracer")


def _call_event(op="allreduce", dur_ns=1_000_000, predicted_s=None,
                retcode=0, cat="call", rank=None, count=1024, world=8,
                measured_s=None):
    args = {"op": op, "count": count, "bytes": count * 4, "world": world,
            "algorithm": "EAGER_RING_RS_AG", "protocol": "EAGER",
            "retcode": retcode}
    if predicted_s is not None:
        args["predicted_s"] = predicted_s
    if measured_s is not None:
        args["measured_s"] = measured_s
    if rank is not None:
        args["rank"] = rank
    return {"name": op, "cat": cat, "track": "facade", "ts_ns": 0,
            "dur_ns": dur_ns, "args": args}


pkgs = pytest.mark.parametrize("pkg", PKGS)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


@pkgs
def test_registry_series_keyed_by_labels(pkg):
    _, M, _, _ = _tel(pkg)
    reg = M.MetricsRegistry()
    reg.counter("accl_calls_total", op="allreduce", world=8).inc()
    reg.counter("accl_calls_total", op="allreduce", world=8).inc()
    reg.counter("accl_calls_total", op="bcast", world=8).inc()
    rows = reg.snapshot()["counters"]["accl_calls_total"]
    assert {r["labels"]["op"]: r["value"] for r in rows} == \
        {"allreduce": 2.0, "bcast": 1.0}


@pkgs
def test_histogram_bounded_window_quantiles_and_cumulative(pkg):
    _, M, _, _ = _tel(pkg)
    h = M.Histogram(window=10)
    for i in range(100):
        h.observe(float(i))
    snap = h.snapshot()
    assert snap["count"] == 100
    assert snap["sum"] == pytest.approx(sum(range(100)))
    assert snap["min"] == 0.0 and snap["max"] == 99.0
    assert snap["window"] == 10
    assert 90.0 <= snap["p50"] <= 99.0
    assert snap["p99"] >= snap["p95"] >= snap["p50"]
    assert M.Histogram().snapshot() == {"count": 0, "sum": 0.0, "window": 0}


@pkgs
def test_p99_9_is_window_max_nearest_rank(pkg):
    _, M, _, _ = _tel(pkg)
    assert M.quantile_key(0.999) == "p99_9"
    assert M.quantile_key(0.99) == "p99"
    h = M.Histogram()  # default window: 512
    for i in range(1000):
        h.observe(float(i))
    snap = h.snapshot()
    assert snap["window"] == 512
    assert snap["p99_9"] == 999.0 == snap["max"]
    assert snap["p99"] <= snap["p99_9"]
    reg = M.MetricsRegistry()
    reg.histogram("accl_serve_step_seconds", mode="fused").observe(0.25)
    assert ('accl_serve_step_seconds{mode="fused",quantile="0.999"} 0.25'
            in reg.expose_text().splitlines())


@pkgs
def test_event_schema_pins_registry_quantile_keys(pkg):
    t, M, _, _ = _tel(pkg)
    row_schema = (t.EVENT_SCHEMA["properties"]["meta"]["properties"]
                  ["metrics"]["properties"]["histograms"]
                  ["additionalProperties"]["items"])
    props = set(row_schema["properties"])
    qkeys = {M.quantile_key(q) for q in M.QUANTILES}
    assert qkeys <= props
    assert row_schema["additionalProperties"] is False
    assert not props - qkeys - {"labels", "count", "sum", "window",
                                "min", "max"}
    h = M.Histogram()
    h.observe(1.0)
    assert set({"labels": {"op": "allreduce"}, **h.snapshot()}) <= props


@pkgs
def test_prometheus_exposition_format(pkg):
    _, M, _, _ = _tel(pkg)
    reg = M.MetricsRegistry()
    reg.counter("accl_calls_total", op="allreduce",
                algorithm="RING", protocol="EAGER", world=8).inc(3)
    reg.gauge("accl_ring_drops", track="host").set(2)
    reg.histogram("accl_call_seconds", op="allreduce").observe(0.5)
    lines = reg.expose_text().splitlines()
    assert "# TYPE accl_calls_total counter" in lines
    assert ('accl_calls_total{algorithm="RING",op="allreduce",'
            'protocol="EAGER",world="8"} 3') in lines
    assert "# TYPE accl_ring_drops gauge" in lines
    assert "# TYPE accl_call_seconds summary" in lines
    assert 'accl_call_seconds{op="allreduce",quantile="0.5"} 0.5' in lines
    assert 'accl_call_seconds_count{op="allreduce"} 1' in lines
    reg.counter("x", detail='say "hi"\n').inc()
    assert 'x{detail="say \\"hi\\"\\n"} 1' in reg.expose_text()


@pkgs
def test_registry_thread_safety_smoke(pkg):
    _, M, _, _ = _tel(pkg)
    reg = M.MetricsRegistry()

    def worker():
        for _ in range(1000):
            reg.counter("n", op="allreduce").inc()
            reg.histogram("h", op="allreduce").observe(1.0)

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert reg.counter("n", op="allreduce").value == 4000
    assert reg.histogram("h", op="allreduce").count == 4000


# ---------------------------------------------------------------------------
# label-cardinality guard
# ---------------------------------------------------------------------------


@pkgs
def test_guarded_label_overflows_into_other_bucket(pkg):
    _, M, _, _ = _tel(pkg)
    reg = M.MetricsRegistry(label_value_cap=2)
    for tenant, v in (("a", 1), ("b", 1), ("c", 1), ("d", 2)):
        reg.counter("accl_tenant_dispatches_total", tenant=tenant).inc(v)
    assert reg.guarded_values("tenant") == {"a", "b"}
    snap = reg.snapshot()
    assert {r["labels"]["tenant"]: r["value"]
            for r in snap["counters"]["accl_tenant_dispatches_total"]} == \
        {"a": 1.0, "b": 1.0, "other": 3.0}
    (ovf,) = snap["counters"]["accl_label_overflow_total"]
    assert ovf["labels"] == {"label": "tenant"} and ovf["value"] == 2.0
    reg.histogram("accl_tenant_dispatch_seconds", tenant="zzz").observe(1.0)
    reg.gauge("accl_tenant_depth", tenant="zzz").set(1)
    snap = reg.snapshot()
    (h,) = snap["histograms"]["accl_tenant_dispatch_seconds"]
    assert h["labels"]["tenant"] == "other"
    (g,) = snap["gauges"]["accl_tenant_depth"]
    assert g["labels"]["tenant"] == "other"


@pkgs
def test_guard_bounds_hostile_id_stream(pkg):
    _, M, _, _ = _tel(pkg)
    reg = M.MetricsRegistry(label_value_cap=8)
    for i in range(80):
        reg.counter("accl_tenant_dispatches_total", tenant=f"t{i:03d}").inc()
    rows = reg.snapshot()["counters"]["accl_tenant_dispatches_total"]
    assert len(rows) == 9  # 8 attributed + `other`
    (other,) = [r for r in rows if r["labels"]["tenant"] == "other"]
    assert other["value"] == 72.0
    reg.counter("accl_tenant_dispatches_total", tenant="t000").inc()
    rows = reg.snapshot()["counters"]["accl_tenant_dispatches_total"]
    (t0,) = [r for r in rows if r["labels"]["tenant"] == "t000"]
    assert t0["value"] == 2.0


@pkgs
def test_guard_leaves_closed_label_sets_alone(pkg):
    _, M, _, _ = _tel(pkg)
    reg = M.MetricsRegistry(label_value_cap=1)
    for i in range(5):
        reg.counter("accl_calls_total", op=f"op{i}").inc()
    rows = reg.snapshot()["counters"]["accl_calls_total"]
    assert {r["labels"]["op"] for r in rows} == {f"op{i}" for i in range(5)}


@pkgs
def test_guard_explicit_other_and_env_cap(pkg, monkeypatch):
    _, M, _, _ = _tel(pkg)
    reg = M.MetricsRegistry(label_value_cap=1)
    reg.counter("accl_tenant_dispatches_total", tenant="other").inc()
    assert reg.guarded_values("tenant") == set()
    assert "accl_label_overflow_total" not in reg.snapshot()["counters"]
    monkeypatch.delenv("ACCL_METRICS_LABEL_CAP", raising=False)
    assert M._label_value_cap() == M.DEFAULT_LABEL_VALUE_CAP
    monkeypatch.setenv("ACCL_METRICS_LABEL_CAP", "3")
    assert M._label_value_cap() == 3
    assert M.MetricsRegistry()._label_value_cap == 3
    monkeypatch.setenv("ACCL_METRICS_LABEL_CAP", "0")
    assert M._label_value_cap() == 1  # clamped
    monkeypatch.setenv("ACCL_METRICS_LABEL_CAP", "junk")
    assert M._label_value_cap() == M.DEFAULT_LABEL_VALUE_CAP
    reg2 = M.MetricsRegistry(label_value_cap=1)
    reg2.counter("n", tenant="a").inc()
    assert reg2.guarded_values("tenant") == {"a"}
    reg2.clear()
    assert reg2.guarded_values("tenant") == set()


# ---------------------------------------------------------------------------
# the span -> metrics observer rule
# ---------------------------------------------------------------------------


@pkgs
def test_observer_lifts_call_spans_into_series(pkg):
    _, M, _, _ = _tel(pkg)
    obs = M.MetricsObserver(M.MetricsRegistry(), M.DriftSentinel())
    obs(_call_event(dur_ns=2_000_000, predicted_s=1e-3))
    obs(_call_event(dur_ns=4_000_000, retcode=0x800))
    snap = obs.registry.snapshot()
    calls = snap["counters"]["accl_calls_total"][0]
    assert calls["value"] == 2.0
    assert calls["labels"] == {"op": "allreduce",
                               "algorithm": "EAGER_RING_RS_AG",
                               "protocol": "EAGER", "world": "8"}
    assert snap["counters"]["accl_bytes_total"][0]["value"] == 2 * 4096.0
    h = snap["histograms"]["accl_call_seconds"][0]
    assert h["count"] == 2 and h["p50"] == pytest.approx(2e-3)
    errs = snap["counters"]["accl_errors_total"][0]
    assert errs["labels"] == {"op": "allreduce", "retcode": "2048"}
    v = obs.sentinel.verdict()["allreduce"]
    assert v["n"] == 1 and v["median_rel_err"] == pytest.approx(0.5)


@pkgs
def test_observer_counts_fused_steps(pkg):
    _, M, _, _ = _tel(pkg)
    obs = M.MetricsObserver(M.MetricsRegistry(), M.DriftSentinel())
    ev = _call_event(op="reduce_scatter", cat="step", dur_ns=0)
    obs(ev)
    obs(ev)
    snap = obs.registry.snapshot()
    (row,) = snap["counters"]["accl_steps_total"]
    assert row["value"] == 2.0 and row["labels"]["op"] == "reduce_scatter"
    assert "accl_calls_total" not in snap["counters"]


@pkgs
def test_observer_skips_dispatch_only_measurements(pkg):
    _, M, _, _ = _tel(pkg)
    obs = M.MetricsObserver(M.MetricsRegistry(), M.DriftSentinel())
    ev = _call_event(predicted_s=1e-3)
    ev["args"]["dispatch_only"] = True
    obs(ev)
    snap = obs.registry.snapshot()
    assert snap["counters"]["accl_calls_total"][0]["value"] == 1.0
    assert "accl_call_seconds" not in snap["histograms"]
    assert obs.sentinel.verdict() == {}


@pkgs
def test_observer_feeds_straggler_attribution_from_native_ranks(pkg):
    _, M, _, _ = _tel(pkg)
    obs = M.MetricsObserver(M.MetricsRegistry(), M.DriftSentinel())
    for _ in range(4):
        for rank in range(4):
            dur = 5_000_000 if rank == 2 else 1_000_000
            obs(_call_event(cat="native", rank=rank, dur_ns=dur))
    (wave,) = obs.sentinel.straggler_report()
    assert wave["op"] == "allreduce" and wave["ranks"] == 4
    assert wave["straggler_rank"] == 2
    assert wave["skew"] == pytest.approx(5.0)


@pkgs
def test_tracer_observer_seam_live_with_ring_disabled(pkg):
    _, M, _, T = _tel(pkg)
    tr = T.Tracer(enabled=False)
    assert not tr.active
    obs = M.MetricsObserver(M.MetricsRegistry(), M.DriftSentinel())
    tr.add_observer(obs)
    assert tr.active and not tr.enabled
    with tr.span("allreduce", cat="call", track="facade",
                 op="allreduce", world=4) as sp:
        sp.set(algorithm="RING", protocol="EAGER")
    assert tr.snapshot() == []
    snap = obs.registry.snapshot()
    assert snap["counters"]["accl_calls_total"][0]["value"] == 1.0
    doc = tr.to_trace({"world": 4})
    assert doc["meta"]["metrics"]["counters"]["accl_calls_total"]
    assert "drift_sentinel" in doc["meta"]
    tr.remove_observer(obs)
    assert not tr.active
    assert tr.span("x", cat="call", track="t") is tr.span(
        "y", cat="call", track="t")


@pkgs
def test_observer_exception_counted_never_raises(pkg):
    _, _, _, T = _tel(pkg)
    tr = T.Tracer(enabled=True)

    def broken(ev):
        raise RuntimeError("observer bug")

    tr.add_observer(broken)
    tr.emit("x", "call", "t", ts_ns=0, dur_ns=1, args={})
    assert tr.observer_errors == 1
    assert [s["name"] for s in tr.snapshot()] == ["x"]


@pkgs
def test_replay_trace_is_the_offline_twin(pkg):
    _, M, _, _ = _tel(pkg)
    spans = [_call_event(), _call_event(op="bcast")]
    live = M.MetricsObserver(M.MetricsRegistry(), M.DriftSentinel())
    for s in spans:
        live(s)
    replayed = M.replay_trace({"spans": spans})
    assert replayed.registry.snapshot()["counters"] == \
        live.registry.snapshot()["counters"]


# ---------------------------------------------------------------------------
# drift sentinel
# ---------------------------------------------------------------------------


@pkgs
def test_sentinel_arms_reference_then_flags_regime_change(pkg):
    _, M, _, _ = _tel(pkg)
    s = M.DriftSentinel(window=16, min_samples=8, band_factor=3.0,
                        band_floor=0.25)
    for _ in range(12):
        s.feed("allreduce", predicted_s=1e-3, measured_s=1.1e-3)
    v0 = s.verdict()["allreduce"]
    assert v0["armed"] and v0["in_band"]
    assert v0["reference"] == pytest.approx(0.0909, rel=1e-2)
    assert s.flagged() == []
    for _ in range(16):
        s.feed("allreduce", predicted_s=1e-3, measured_s=5e-3)
    v = s.verdict()["allreduce"]
    assert v["reference"] == v0["reference"]  # frozen at arming
    assert not v["in_band"]
    assert s.flagged() == ["allreduce"]


@pkgs
def test_sentinel_quiet_on_stable_run(pkg):
    _, M, _, _ = _tel(pkg)
    s = M.DriftSentinel(window=32, min_samples=8)
    meas = [1.05e-3, 1.2e-3, 0.9e-3, 1.1e-3]
    for i in range(200):
        s.feed("allreduce", 1e-3, meas[i % len(meas)])
    assert s.flagged() == []
    assert s.verdict()["allreduce"]["in_band"]


@pkgs
def test_sentinel_band_floor_tolerates_tight_reference(pkg):
    _, M, _, _ = _tel(pkg)
    s = M.DriftSentinel(window=16, min_samples=4, band_factor=3.0,
                        band_floor=0.25)
    for _ in range(8):
        s.feed("bcast", 1e-3, 1.01e-3)
    for _ in range(8):
        s.feed("bcast", 1e-3, 1.2e-3)
    assert s.flagged() == []


@pkgs
def test_sentinel_unarmed_below_min_samples(pkg):
    _, M, _, _ = _tel(pkg)
    s = M.DriftSentinel(min_samples=8)
    for _ in range(5):
        s.feed("gather", 1e-3, 9e-3)
    v = s.verdict()["gather"]
    assert v["armed"] is False and "in_band" not in v
    assert s.flagged() == []


@pkgs
def test_sentinel_report_shape_and_reset(pkg):
    _, M, _, _ = _tel(pkg)
    s = M.DriftSentinel(window=8, min_samples=2)
    s.feed("allreduce", 1e-3, 2e-3)
    s.feed("allreduce", 1e-3, 2e-3)
    s.feed_rank("allreduce", 1024, 0, 1e-3)
    s.feed_rank("allreduce", 1024, 1, 2e-3)
    rep = s.report()
    assert set(rep) == {"window", "min_samples", "band_factor",
                        "band_floor", "verdict", "flagged", "stragglers"}
    assert rep["stragglers"][0]["straggler_rank"] == 1
    json.dumps(rep)
    s.reset()
    assert s.verdict() == {} and s.straggler_report() == []


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


@pkgs
def test_flight_recorder_bounded_per_track(pkg):
    _, _, R, _ = _tel(pkg)
    fr = R.FlightRecorder(track_capacity=4)
    for i in range(10):
        fr({"name": f"a{i}", "cat": "call", "track": "facade",
            "ts_ns": i, "dur_ns": 1, "args": {}})
        fr({"name": f"b{i}", "cat": "native", "track": "emu/r0",
            "ts_ns": 100 + i, "dur_ns": 1, "args": {}})
    spans = fr.snapshot()
    assert len(spans) == 8
    assert [s["name"] for s in spans if s["track"] == "facade"] == \
        ["a6", "a7", "a8", "a9"]
    assert spans == sorted(spans, key=lambda s: s["ts_ns"])


@pkgs
def test_flight_recorder_trace_doc_is_schema_valid(pkg, monkeypatch):
    t, _, R, _ = _tel(pkg)
    monkeypatch.setenv("ACCL_FLIGHT_CAP", "8")
    fr = R.FlightRecorder()
    assert fr.track_capacity == 8
    fr(_call_event())
    doc = fr.to_trace(reason="unit test")
    assert doc["meta"]["flight_recorder"] is True
    assert doc["meta"]["reason"] == "unit test"
    t.validate_trace(doc)


@pkgs
def test_notify_sticky_retcode_emits_marker_and_freezes(pkg, monkeypatch,
                                                        tmp_path):
    t, _, R, _ = _tel(pkg)
    errors = importlib.import_module(f"{pkg}.errors")
    assert R.armed() and t.observability_enabled()  # the default
    monkeypatch.setenv("ACCL_FLIGHT_DIR", str(tmp_path))
    R.get_recorder().clear()
    doc = errors.notify_sticky_retcode("allreduce", 0x20, rank=3, count=512)
    assert doc is not None
    (err,) = [s for s in doc["spans"] if s["cat"] == "error"]
    assert err["name"] == "allreduce" and err["track"] == "emu/r3"
    assert err["args"] == {"retcode": 0x20, "rank": 3, "count": 512}
    assert "0x20" in doc["meta"]["reason"]
    assert R.last_error_trace() is doc
    on_disk = json.loads((tmp_path / "flight_last_error.json").read_text())
    assert on_disk["meta"]["reason"] == doc["meta"]["reason"]


@pkgs
def test_request_completion_with_retcode_freezes_post_mortem(pkg):
    _, _, R, _ = _tel(pkg)
    request = importlib.import_module(f"{pkg}.request")
    R.get_recorder().clear()
    req = request.BaseRequest("reduce_scatter")
    req.running()
    req.complete(0x104)
    doc = R.last_error_trace()
    assert doc is not None
    (err,) = [s for s in doc["spans"] if s["cat"] == "error"]
    assert err["name"] == "reduce_scatter"
    assert err["args"]["retcode"] == 0x104


@pkgs
def test_deadline_miss_marker_and_disarmed_noop(pkg):
    """on_deadline_miss freezes a post-mortem whose marker carries the
    deadline keys; with observability off both dump hooks are no-ops."""
    t, _, R, _ = _tel(pkg)
    R.get_recorder().clear()
    doc = R.on_deadline_miss("allreduce", count=64, predicted_s=1e-3,
                             deadline_s=5e-3, elapsed_s=9e-3,
                             suspect_rank=2)
    (err,) = [s for s in doc["spans"] if s["cat"] == "error"]
    assert err["track"] == "errors" and err["args"] == {
        "deadline_missed": True, "retcode": 0, "count": 64,
        "predicted_s": 1e-3, "deadline_s": 5e-3, "measured_s": 9e-3,
        "suspect_rank": 2}
    t.validate_trace(doc)
    t.disable_observability()
    try:
        assert not t.observability_enabled()
        assert R.on_sticky_retcode("x", 1) is None
        assert R.on_deadline_miss("x") is None
    finally:
        t.enable_observability()
    assert t.observability_enabled()


# ---------------------------------------------------------------------------
# the committed traces through both packages
# ---------------------------------------------------------------------------


def _replay(pkg: str, trace: dict):
    _, M, _, _ = _tel(pkg)
    win = int(trace.get("meta", {}).get("sentinel_window",
                                        M.DEFAULT_SENTINEL_WINDOW))
    return M.replay_trace(trace, M.MetricsObserver(
        M.MetricsRegistry(), M.DriftSentinel(window=win)))


@pytest.mark.parametrize("name", ["golden_trace.json", "hier_trace.json"])
def test_replay_of_committed_trace_matches_reference(name):
    import accl_tpu_torch.telemetry as PT

    trace = PT.read_trace(ROOT / "accl_log" / name)
    ref, port = _replay("accl_tpu", trace), _replay("accl_tpu_torch", trace)
    assert port.registry.snapshot() == ref.registry.snapshot()
    assert port.registry.expose_text() == ref.registry.expose_text()
    # NaN skews compare as their JSON text
    assert json.dumps(port.sentinel.report(), sort_keys=True) == \
        json.dumps(ref.sentinel.report(), sort_keys=True)
    if name == "golden_trace.json":
        assert port.sentinel.flagged() == ["alltoall"]
        strag = [w for w in port.sentinel.straggler_report()
                 if w["op"] == "alltoall"]
        assert strag[0]["straggler_rank"] == 3 and strag[0]["skew"] > 1.2
        assert trace["meta"]["drift_sentinel"]["flagged"] == ["alltoall"]
