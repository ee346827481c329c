"""The port's telemetry (accl_tpu_torch/telemetry/) against the JAX
package's.

The reference's tracer, export and feedback tests of
tests/test_telemetry.py run as cases parametrised over both packages
(`pkg`). Then parity on the same inputs: the fits of the committed
traces (accl_log/golden_trace.json, hier_trace.json) and the residual
reports equal to rel 1e-12, the compute fit of a synthetic trace, the
Chrome documents, and the port's own schema validator against
jsonschema.validate with the reference's EVENT_SCHEMA on valid and
drifted documents. Last, the facades: the same calls through the JAX
facade (mesh8) and the port's (torch_device="cpu", W = 8) with tracing
on give the same spans (name, cat, track, arg keys, the plan, step and
signature keys, predicted_s to rel 1e-12), autotune_from_trace sets the
same registers on both, tracing off records nothing, and a recv that
times out freezes the same post-mortem shape.
"""

import importlib
import json
import math
import pathlib

import jsonschema
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKGS = ("accl_tpu", "accl_tpu_torch")
RNG = np.random.default_rng(1311)
WORLD = 8

pkgs = pytest.mark.parametrize("pkg", PKGS)


def _tel(pkg: str):
    return importlib.import_module(f"{pkg}.telemetry")


def _tracer_cls(pkg: str):
    return importlib.import_module(f"{pkg}.telemetry.tracer").Tracer


def _ref_schema_ok(doc) -> bool:
    from accl_tpu.telemetry.export import EVENT_SCHEMA

    try:
        jsonschema.validate(doc, EVENT_SCHEMA)
        return True
    except jsonschema.ValidationError:
        return False


def _port_schema_ok(doc) -> bool:
    from accl_tpu_torch.telemetry import validate_trace

    try:
        validate_trace(doc)
        return True
    except ValueError:
        return False


def _close(a, b, rel=1e-12) -> bool:
    """Nested equality, floats to `rel` (NaN equal to NaN)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_close(a[k], b[k], rel) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_close(x, y, rel) for x, y in zip(a, b)))
    if isinstance(a, float) and not isinstance(b, bool):
        if math.isnan(a):
            return isinstance(b, float) and math.isnan(b)
        return math.isclose(a, b, rel_tol=rel, abs_tol=0.0)
    return a == b


# ---------------------------------------------------------------------------
# the reference's tracer / export / feedback tests, on both packages
# ---------------------------------------------------------------------------


@pkgs
def test_aggregate_wire_gbps_reflects_total_volume(pkg):
    nbytes, world, secs = 1 << 20, 8, 0.01
    agg = _tel(pkg).native.aggregate_wire_gbps("allreduce", nbytes, world,
                                                secs)
    assert agg > 5 * nbytes / secs / 1e9


@pkgs
def test_tracer_disabled_span_is_noop_singleton(pkg):
    tr = _tracer_cls(pkg)(enabled=False)
    s1 = tr.span("a", cat="call", track="x")
    assert s1 is tr.span("b", cat="phase", track="y")
    with s1 as sp:
        sp.set(anything=1)
    assert tr.snapshot() == []


@pkgs
def test_tracer_ring_drops_oldest_and_counts(pkg):
    tr = _tracer_cls(pkg)(capacity=3, enabled=True)
    for i in range(5):
        tr.emit(f"s{i}", "call", "t", ts_ns=i, dur_ns=1, args={})
    assert tr.drops == 2
    assert [s["name"] for s in tr.snapshot()] == ["s2", "s3", "s4"]
    assert [s["name"] for s in tr.drain()] == ["s2", "s3", "s4"]
    assert tr.snapshot() == []


@pkgs
def test_tracer_env_switch(pkg, monkeypatch):
    Tracer = _tracer_cls(pkg)
    monkeypatch.setenv("ACCL_TELEMETRY", "1")
    assert Tracer().enabled
    monkeypatch.setenv("ACCL_TELEMETRY", "off")
    assert not Tracer().enabled


@pkgs
def test_tracer_span_measures_and_attaches_args(pkg):
    tr = _tracer_cls(pkg)(enabled=True)
    with tr.span("op", cat="call", track="facade", count=4) as sp:
        sp.set(algorithm="RING")
    (ev,) = tr.drain()
    assert ev["name"] == "op" and ev["cat"] == "call"
    assert ev["dur_ns"] >= 0
    assert ev["args"] == {"count": 4, "algorithm": "RING"}


@pkgs
def test_tracer_span_records_exception_and_propagates(pkg):
    tr = _tracer_cls(pkg)(enabled=True)
    with pytest.raises(ValueError):
        with tr.span("bad", cat="phase", track="t"):
            raise ValueError("x")
    (ev,) = tr.drain()
    assert ev["args"]["error"] == "ValueError"


def _mini_trace(pkg: str):
    tr = _tracer_cls(pkg)(enabled=True)
    tr.emit("allreduce", "native", "emu/r0", ts_ns=10, dur_ns=100,
            args={"op": "allreduce", "coef_messages": 2.0,
                  "coef_bytes": 1000.0, "measured_s": 1e-3,
                  "predicted_s": 2e-3, "retcode": 0})
    tr.emit("lint", "phase", "device", ts_ns=5, dur_ns=0, args={})
    return tr.to_trace({"world": 2})


SCHEMA_FAILURES = (ValueError, jsonschema.ValidationError)


@pkgs
def test_schema_accepts_valid_and_rejects_drift(pkg):
    t = _tel(pkg)
    trace = _mini_trace(pkg)
    t.validate_trace(trace)
    bad = json.loads(json.dumps(trace))
    bad["spans"][0]["cat"] = "mystery"
    with pytest.raises(SCHEMA_FAILURES):
        t.validate_trace(bad)
    bad2 = json.loads(json.dumps(trace))
    del bad2["spans"][0]["ts_ns"]
    with pytest.raises(SCHEMA_FAILURES):
        t.validate_trace(bad2)
    bad3 = json.loads(json.dumps(trace))
    bad3["spans"][0]["args"]["predicted_s"] = "fast"
    with pytest.raises(SCHEMA_FAILURES):
        t.validate_trace(bad3)


@pkgs
def test_chrome_export_one_named_track_per_rank(pkg):
    chrome = _tel(pkg).to_chrome(_mini_trace(pkg))
    metas = [e for e in chrome["traceEvents"] if e["ph"] == "M"]
    xs = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
    assert {m["args"]["name"] for m in metas} == {"emu/r0", "device"}
    assert len(xs) == 2
    assert all(e["dur"] > 0 for e in xs)
    ar = next(e for e in xs if e["name"] == "allreduce")
    assert ar["args"]["coef_messages"] == 2.0


def _synthetic_trace(pkg, alpha=1e-4, beta=1e9, n=12, skew=1.0):
    tr = _tracer_cls(pkg)(enabled=True)
    for k in range(n):
        m = float(2 + k)
        b = float(1 << (12 + k % 8))
        t = (alpha * m + b / beta) * skew
        tr.emit("allreduce", "native", f"emu/r{k % 4}", ts_ns=k,
                dur_ns=int(t * 1e9),
                args={"coef_messages": m, "coef_bytes": b,
                      "measured_s": t})
    return tr.to_trace()


@pkgs
def test_calibrate_from_trace_recovers_link(pkg):
    link = _tel(pkg).calibrate_from_trace(
        _synthetic_trace(pkg, alpha=1e-4, beta=1e9))
    assert link.alpha == pytest.approx(1e-4, rel=0.05)
    assert link.beta == pytest.approx(1e9, rel=0.05)


@pkgs
def test_calibrate_from_trace_rejects_span_free_trace(pkg):
    tr = _tracer_cls(pkg)(enabled=True)
    tr.emit("lint", "phase", "device", ts_ns=0, dur_ns=5, args={})
    with pytest.raises(ValueError, match="calibratable"):
        _tel(pkg).calibrate_from_trace(tr.to_trace())


@pkgs
def test_residual_improvement_refit_beats_wrong_default(pkg):
    timing = importlib.import_module(f"{pkg}.sequencer.timing")
    wrong = timing.LinkParams(alpha=1e-5, beta=4e9)
    out = _tel(pkg).residual_improvement(
        _synthetic_trace(pkg, alpha=1e-4, beta=1e9), default=wrong)
    assert out["improved"]
    assert out["median_rel_err_refit"] < out["median_rel_err_default"]


def _two_tier_trace(pkg):
    true = {"inner": (2e-6, 4e9), "outer": (400e-6, 0.1e9),
            None: (1e-4, 1e9)}
    tr = _tracer_cls(pkg)(enabled=True)
    for tier, (a, b_) in true.items():
        for k in range(8):
            m = float(2 + k)
            b = float(1 << (14 + k % 6))
            t = a * m + b / b_
            args = {"coef_messages": m, "coef_bytes": b, "measured_s": t}
            if tier is not None:
                args["tier"] = tier
            tr.emit("allreduce", "native", f"hier/{tier or 'flat'}/r{k % 2}",
                    ts_ns=k, dur_ns=int(t * 1e9), args=args)
    return tr.to_trace(), true


@pkgs
def test_calibrate_tiers_recovers_each_link_independently(pkg):
    trace, true = _two_tier_trace(pkg)
    tiers = _tel(pkg).calibrate_tiers_from_trace(trace)
    assert tiers.inner.beta == pytest.approx(true["inner"][1], rel=0.05)
    assert tiers.outer.beta == pytest.approx(true["outer"][1], rel=0.05)
    assert tiers.inner.alpha == pytest.approx(true["inner"][0], rel=0.1)
    assert tiers.outer.alpha == pytest.approx(true["outer"][0], rel=0.1)
    assert tiers.inner.beta > 10 * tiers.outer.beta


@pkgs
def test_flat_fit_excludes_tier_tagged_spans(pkg):
    t = _tel(pkg)
    trace, true = _two_tier_trace(pkg)
    flat = t.calibrate_from_trace(trace)
    assert flat.alpha == pytest.approx(true[None][0], rel=0.05)
    assert flat.beta == pytest.approx(true[None][1], rel=0.05)
    assert len(t.feedback.hop_samples(trace)) == 8
    assert len(t.feedback.hop_samples(trace, tier="inner")) == 8
    with pytest.raises(ValueError, match="tier='bogus'"):
        t.calibrate_from_trace(trace, tier="bogus")


@pkgs
def test_residual_machinery_tolerates_empty_and_partial_traces(pkg):
    t = _tel(pkg)
    empty = {"schema": t.SCHEMA_VERSION, "spans": []}
    assert t.residual_rows(empty) == []
    assert t.residual_rows({}) == []
    assert t.residual_summary([]) == {
        "rows": 0, "median_rel_err": None, "per_op_median_rel_err": {}}
    partial = {"spans": [
        {"name": "allreduce"},
        {"cat": "call", "args": {"predicted_s": 0.1}},
        {"name": "x", "track": "t", "ts_ns": 0, "dur_ns": 0,
         "args": {"predicted_s": 0.1}},
        {"name": "y", "track": "t", "ts_ns": 0, "dur_ns": 1000,
         "args": {"predicted_s": "bogus"}},
        {"name": "z", "track": "t", "ts_ns": 0, "dur_ns": 1000,
         "args": None},
        "not-a-span",
    ]}
    assert t.residual_rows(partial) == []
    assert t.export.measured_seconds({"args": {"measured_s": "fast"}}) == 0.0
    rep = t.residual_report(partial)
    assert rep["span_residuals"]["rows"] == 0
    assert rep["span_residuals"]["median_rel_err"] is None
    assert "error" in rep["calibration"]
    partial["spans"].append(
        {"name": "allreduce", "track": "emu/r0", "ts_ns": 0,
         "dur_ns": 1_000_000, "args": {"predicted_s": 2e-3}})
    rows = t.residual_rows(partial)
    assert len(rows) == 1
    s = t.residual_summary(rows)
    assert s["rows"] == 1 and s["median_rel_err"] == pytest.approx(1.0)


@pkgs
def test_residual_rows_skip_dispatch_only_and_error_spans(pkg):
    t = _tel(pkg)
    spans = [{"name": "allreduce", "cat": cat, "track": "facade", "ts_ns": 0,
              "dur_ns": 1000, "args": {"predicted_s": 1e-6, **extra}}
             for cat, extra in (("call", {"dispatch_only": True}),
                                ("error", {}), ("call", {}))]
    (row,) = t.residual_rows({"spans": spans})
    assert row["rel_err"] == pytest.approx(0.0)


@pkgs
def test_wire_health_report_normalizes_and_totals(pkg):
    t = _tel(pkg)
    rep = t.wire_health_report({
        1: {"crc_drops": 2, "retx_sent": 3, "junk": "nan"},
        0: {"crc_drops": 1, "retx_sent": 0, "tx_frames": 7.0},
    })
    assert list(rep["per_rank"]) == ["0", "1"]
    assert rep["per_rank"]["1"] == {"crc_drops": 2, "retx_sent": 3}
    assert rep["totals"] == {"crc_drops": 3, "retx_sent": 3, "tx_frames": 7}
    assert t.wire_health_report({}) == {"per_rank": {}, "totals": {}}
    assert t.wire_health_rows({1: {"a": 1}, 0: {"a": 2}}) == \
        [{"rank": "0", "a": 2}, {"rank": "1", "a": 1}]


@pkgs
def test_wire_health_meta_is_schema_typed(pkg):
    t = _tel(pkg)
    trace = {"schema": t.SCHEMA_VERSION, "spans": [],
             "meta": {"wire_health": t.wire_health_report(
                 {0: {"crc_drops": 1}})}}
    t.validate_trace(trace)
    for wh in ({"per_rank": {}},
               {"per_rank": {"0": {"x": "y"}}, "totals": {}}):
        with pytest.raises(SCHEMA_FAILURES):
            t.validate_trace({"schema": t.SCHEMA_VERSION, "spans": [],
                              "meta": {"wire_health": wh}})


@pkgs
def test_trace_file_round_trip(pkg, tmp_path):
    t = _tel(pkg)
    trace = _mini_trace(pkg)
    t.write_trace(tmp_path / "t.json", trace)
    assert t.read_trace(tmp_path / "t.json") == trace


def test_gpu_device_wire_stats_is_the_stats2_surface():
    """GPUDevice.wire_stats: every stats2 field (the reference's names,
    in its order) at 0, rendering into a schema-valid wire_health."""
    from accl_tpu.device.emu_device import STATS2_FIELDS as REF_FIELDS
    from accl_tpu_torch import telemetry as PT
    from accl_tpu_torch.device.base import STATS2_FIELDS
    from accl_tpu_torch.device.gpu_device import GPUDevice

    assert STATS2_FIELDS == REF_FIELDS
    stats = GPUDevice(WORLD, "cpu").wire_stats()
    assert tuple(stats) == STATS2_FIELDS and set(stats.values()) == {0}
    rep = PT.wire_health_report({0: stats})
    assert set(PT.WIRE_FAULT_KEYS) < set(rep["totals"])
    PT.validate_trace({"schema": PT.SCHEMA_VERSION, "spans": [],
                       "meta": {"wire_health": rep}})


def test_drain_world_waits_for_the_emulator():
    """drain_world over a world whose ranks hand both packages the same
    raw ring spans: the same events, one track per rank (the timestamps
    are anchored at each call's clock, so they compare per rank), the
    same dropped count, and the tracer gets the events."""
    import types

    from accl_tpu.telemetry import native as ref_native
    from accl_tpu_torch.sequencer.timing import LinkParams
    from accl_tpu_torch.telemetry import native
    from accl_tpu_torch.telemetry.tracer import Tracer

    rng = np.random.default_rng(31)

    def raw(rank, i):
        count = int(rng.integers(1, 5000))
        start = int(rng.integers(0, 10**6)) + 10**6 * i
        return {"opcode": int(rng.choice([5, 6, 7, 9, 10])),
                "retcode": 0, "detail": 0, "count": count,
                "bytes": 4 * count, "start_ns": start,
                "end_ns": start + int(rng.integers(1, 10**5)),
                "d_passes": i, "d_parks": 0, "d_seek_hit": 1,
                "d_seek_miss": 0, "rank": rank}

    spans = {r: [raw(r, i) for i in range(4)] for r in range(3)}
    world = types.SimpleNamespace(ranks=[
        types.SimpleNamespace(trace_read=lambda r=r: (spans[r], r))
        for r in range(3)] + [None])
    link = LinkParams(alpha=2e-5, beta=3e9)
    kw = dict(link=link, tier="inner", track_prefix="tier0")
    want, want_dropped = ref_native.drain_world(world, **kw)
    tracer = Tracer(capacity=64)
    tracer.enable()
    got, dropped = native.drain_world(world, tracer=tracer, **kw)
    assert dropped == want_dropped == 3
    assert len(got) == len(want) == 12
    assert [e["track"] for e in got] == [f"tier0/r{r}" for r in range(3)
                                         for _ in range(4)]
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "ts_ns"} == \
            {k: v for k, v in w.items() if k != "ts_ns"}
    for r in range(3):
        ts = [e["ts_ns"] for e in got if e["track"] == f"tier0/r{r}"]
        ts_ref = [e["ts_ns"] for e in want if e["track"] == f"tier0/r{r}"]
        assert [t - ts[0] for t in ts] == [t - ts_ref[0] for t in ts_ref]
    assert len(tracer.snapshot()) == 12


# ---------------------------------------------------------------------------
# the committed traces: fits, reports and Chrome documents
# ---------------------------------------------------------------------------


def _committed(name):
    from accl_tpu_torch.telemetry import read_trace

    return read_trace(ROOT / "accl_log" / name)


def _fit(pkg, fn, trace):
    """A fit's (alpha, beta) per link, or the ValueError's type."""
    try:
        out = getattr(_tel(pkg), fn)(trace)
    except ValueError:
        return "ValueError"
    if fn == "calibrate_tiers_from_trace":
        return {k: (getattr(out, k).alpha, getattr(out, k).beta)
                for k in ("inner", "outer")}
    return (out.alpha, out.beta)


TRACES = ("golden_trace.json", "hier_trace.json")


@pytest.mark.parametrize("name", TRACES)
@pytest.mark.parametrize("fn", ("calibrate_from_trace",
                                "calibrate_tiers_from_trace"))
def test_fits_of_committed_traces_match_reference(name, fn):
    trace = _committed(name)
    want = _fit("accl_tpu", fn, trace)
    assert _close(_fit("accl_tpu_torch", fn, trace), want)
    if name == "golden_trace.json":
        assert want != "ValueError"  # the golden trace fits both ways


@pytest.mark.parametrize("name", TRACES)
def test_residual_reports_of_committed_traces_match_reference(name):
    import accl_tpu.telemetry as RT
    import accl_tpu_torch.telemetry as PT

    trace = _committed(name)
    assert _close(PT.residual_report(trace), RT.residual_report(trace)) \
        or PT.residual_report(trace)["calibration"].keys() == \
        RT.residual_report(trace)["calibration"].keys() == {"error"}
    try:
        want = RT.residual_improvement(trace)
    except ValueError:
        with pytest.raises(ValueError):
            PT.residual_improvement(trace)
        return
    got = PT.residual_improvement(trace)
    assert _close(got, want) and "median_rel_err_default" in got
    assert _close(PT.residual_summary(PT.residual_rows(trace)),
                  RT.residual_summary(RT.residual_rows(trace)))


@pytest.mark.parametrize("name", TRACES)
def test_chrome_documents_of_committed_traces_match_reference(name):
    import accl_tpu.telemetry as RT
    import accl_tpu_torch.telemetry as PT

    trace = _committed(name)
    assert PT.to_chrome(trace) == RT.to_chrome(trace)


def test_calibrate_compute_from_trace_matches_reference():
    """The overlap pipeline's compute term from compute-tagged spans:
    both packages recover the same ComputeFit, the truth to 1%."""
    import accl_tpu.telemetry as RT
    import accl_tpu_torch.telemetry as PT

    alpha, rate = 3e-5, 2e11
    spans = []
    for k, nbytes in enumerate(RNG.integers(1 << 16, 1 << 26, 10)):
        t = alpha + float(nbytes) / rate
        spans.append({"name": "compute", "cat": "compute", "track": "host",
                      "ts_ns": k, "dur_ns": int(t * 1e9),
                      "args": {"compute_bytes": int(nbytes),
                               "measured_s": t}})
    spans.append({"name": "allreduce", "cat": "call", "track": "facade",
                  "ts_ns": 99, "dur_ns": 5, "args": {}})
    trace = {"schema": PT.SCHEMA_VERSION, "meta": {}, "spans": spans}
    PT.validate_trace(trace)
    got = PT.calibrate_compute_from_trace(trace)
    want = RT.calibrate_compute_from_trace(trace)
    assert _close((got.alpha, got.rate), (want.alpha, want.rate))
    assert got.alpha == pytest.approx(alpha, rel=0.01)
    assert got.rate == pytest.approx(rate, rel=0.01)
    assert PT.feedback.compute_samples(trace) == \
        RT.feedback.compute_samples(trace)
    with pytest.raises(ValueError, match="compute span"):
        PT.calibrate_compute_from_trace({"spans": spans[:1]})


# ---------------------------------------------------------------------------
# the port's validator against jsonschema with the reference's schema
# ---------------------------------------------------------------------------


def test_event_schema_is_the_reference_copy():
    import accl_tpu.telemetry as RT
    import accl_tpu_torch.telemetry as PT

    assert PT.EVENT_SCHEMA == RT.EVENT_SCHEMA
    assert PT.SCHEMA_VERSION == RT.SCHEMA_VERSION == "accl-tpu-trace-v1"


def _drift(trace, edit):
    doc = json.loads(json.dumps(trace))
    edit(doc)
    return doc


def _set(path, value):
    def edit(doc):
        node = doc
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value
    return edit


def _delete(path):
    def edit(doc):
        node = doc
        for k in path[:-1]:
            node = node[k]
        del node[path[-1]]
    return edit


# (label, edit, valid): the drift cases of the reference's schema test,
# then one per keyword EVENT_SCHEMA uses, and the draft-07 type edges
DRIFTS = (
    ("unknown cat", _set(("spans", 0, "cat"), "mystery"), False),
    ("missing ts_ns", _delete(("spans", 0, "ts_ns")), False),
    ("string prediction", _set(("spans", 0, "args", "predicted_s"),
                               "fast"), False),
    ("other schema", _set(("schema",), "accl-tpu-trace-v0"), False),
    ("negative dur", _set(("spans", 1, "dur_ns"), -1), False),
    ("spans not an array", _set(("spans",), {}), False),
    ("meta not an object", _set(("meta",), []), False),
    ("missing spans", _delete(("spans",)), False),
    ("bool step", _set(("spans", 0, "args", "step"), True), False),
    ("integral float count", _set(("spans", 0, "args", "count"), 3.0),
     True),
    ("fractional count", _set(("spans", 0, "args", "count"), 3.5), False),
    ("open args", _set(("spans", 0, "args", "anything"), [1, "x"]), True),
    ("extra span key", _set(("spans", 0, "extra"), 1), True),
    ("histogram row extra key",
     _set(("meta", "metrics", "histograms", "h"),
          [{"labels": {}, "count": 1, "sum": 1.0, "window": 1, "p42": 1.0}]),
     False),
    ("histogram row missing window",
     _set(("meta", "metrics", "histograms", "h"),
          [{"labels": {}, "count": 1, "sum": 1.0}]), False),
    ("histogram row", _set(("meta", "metrics", "histograms", "h"),
                           [{"labels": {}, "count": 1, "sum": 1.0,
                             "window": 1, "p99_9": 2.0}]), True),
    ("flagged not strings", _set(("meta", "drift_sentinel", "flagged"),
                                 [1]), False),
    ("sentinel without verdict", _delete(("meta", "drift_sentinel",
                                          "verdict")), False),
    ("metrics without gauges", _delete(("meta", "metrics", "gauges")),
     False),
    ("wire totals not integers",
     _set(("meta", "wire_health"),
          {"per_rank": {"0": {"a": 1}}, "totals": {"a": 1.5}}), False),
)


@pytest.fixture(scope="module")
def base_trace():
    """A small trace made by the port with its meta keys filled: the
    metrics snapshot and sentinel report of a live observer."""
    from accl_tpu_torch.telemetry import metrics
    from accl_tpu_torch.telemetry.tracer import Tracer

    tr = Tracer(enabled=True)
    tr.add_observer(metrics.MetricsObserver())
    tr.emit("allreduce", "call", "facade", ts_ns=1, dur_ns=1000,
            args={"op": "allreduce", "count": 8, "predicted_s": 1e-6,
                  "algorithm": "EAGER_RING_RS_AG", "protocol": "EAGER"})
    tr.emit("lint", "phase", "device", ts_ns=2, dur_ns=0, args={})
    return tr.to_trace({"world": WORLD})


@pytest.mark.parametrize("label,edit,valid", DRIFTS,
                         ids=[d[0] for d in DRIFTS])
def test_validator_agrees_with_jsonschema_on_drift(base_trace, label, edit,
                                                   valid):
    doc = _drift(base_trace, edit)
    assert _ref_schema_ok(doc) is valid
    assert _port_schema_ok(doc) is valid


def test_validator_names_the_failing_path(base_trace):
    from accl_tpu_torch.telemetry import validate_trace

    doc = _drift(base_trace, _set(("spans", 0, "args", "predicted_s"), "x"))
    with pytest.raises(ValueError, match=r"\$\.spans\[0\]\.args\.predicted_s"):
        validate_trace(doc)


@pytest.mark.parametrize("name", TRACES)
def test_validator_agrees_with_jsonschema_on_committed(name):
    doc = _committed(name)
    assert _ref_schema_ok(doc) and _port_schema_ok(doc)


# ---------------------------------------------------------------------------
# the facades: the same calls through both, traced
# ---------------------------------------------------------------------------


def _port_facade():
    from accl_tpu_torch import ACCL

    return ACCL(world=WORLD, torch_device="cpu")


def _drive(accl, F, x, make):
    """allreduce 8192 f32; a reduce_scatter+allgather sequence; the same
    batch compiled and run twice; one async allreduce. Returns the
    allreduce's request and the results."""
    n, chunk = x.shape[1], x.shape[1] // WORLD
    a = accl.create_buffer(n, data=make(x))
    b, c, d = (accl.create_buffer(chunk), accl.create_buffer(n),
               accl.create_buffer(n))
    req = accl.allreduce(a, c, n, F.SUM)
    with accl.sequence() as seq:
        seq.reduce_scatter(a, b, chunk, F.SUM)
        seq.allgather(b, c, chunk)
    rec = accl.sequence()
    rec.reduce_scatter(a, b, chunk, F.SUM)
    rec.allgather(b, d, chunk)
    prog = rec.compile()
    prog.run()
    prog.run()
    accl.wait(accl.allreduce(a, c, n, F.SUM, run_async=True))
    return req, [np.asarray(buf.host) for buf in (c, d)]


def _traced(pkg, run):
    tr = _tel(pkg).get_tracer()
    was = tr.enabled
    tr.clear()
    tr.enable()
    try:
        out = run()
        return tr.to_trace({"world": WORLD}), out
    finally:
        tr.clear()
        if not was:
            tr.disable()


@pytest.fixture(scope="module")
def traced_pair(mesh8):
    from accl_tpu.accl import ACCL as RefACCL
    from accl_tpu.constants import ReduceFunction as RefF
    from accl_tpu_torch import ReduceFunction

    x = RNG.standard_normal((WORLD, 8192)).astype(np.float32)
    ref = _traced("accl_tpu", lambda: _drive(RefACCL(mesh8), RefF, x,
                                             lambda v: v))
    port = _traced("accl_tpu_torch", lambda: _drive(
        _port_facade(), ReduceFunction, x, torch.from_numpy))
    return ref, port


COMPARED_ARGS = ("op", "count", "algorithm", "protocol", "step", "n_steps",
                 "ops", "signature", "dispatch_only", "prepared", "world",
                 "retcode", "tier")


def _without_layer(spans):
    """The port's spans less its layer spans (track "layer"), which time
    parts of its own dispatch that the reference does not emit."""
    return [s for s in spans if s["track"] != "layer"]


def test_facade_spans_match_reference(traced_pair):
    (ref_trace, _), (port_trace, _) = traced_pair
    ref, port = ref_trace["spans"], _without_layer(port_trace["spans"])
    assert [(s["name"], s["cat"], s["track"]) for s in port] == \
        [(s["name"], s["cat"], s["track"]) for s in ref]
    for r, p in zip(ref, port):
        assert p["args"].keys() == r["args"].keys(), (r["name"], r["cat"])
        for k in COMPARED_ARGS:
            assert p["args"].get(k) == r["args"].get(k), (r["name"], k)
        if "predicted_s" in r["args"]:
            assert p["args"]["predicted_s"] == pytest.approx(
                r["args"]["predicted_s"], rel=1e-12, abs=0)
            assert p["args"]["predicted_s"] > 0


def test_port_trace_gates(traced_pair):
    """What the card's telemetry phase gates, on the CPU: the trace
    validates (both validators), exports to the facade and device
    tracks, each call span names its request's plan, one signature per
    batch across its phases and steps, the sequence span's prediction
    is the sum of its steps', and the results match the reference's."""
    from accl_tpu_torch import telemetry as PT

    (_, (_, ref_out)), (trace, (req, out)) = traced_pair
    assert _port_schema_ok(trace) and _ref_schema_ok(trace)
    spans = _without_layer(trace["spans"])
    chrome = PT.to_chrome(dict(trace, spans=spans))
    assert {e["args"]["name"] for e in chrome["traceEvents"]
            if e["ph"] == "M"} == {"facade", "device"}
    call = spans[0]
    assert call["cat"] == "call"
    assert call["args"]["algorithm"] == req.plan.algorithm.name
    sigs = {s["args"]["signature"] for s in spans if s["cat"] == "phase"}
    assert len(sigs) == 1
    assert {s["args"]["signature"] for s in spans
            if s["cat"] in ("step", "sequence")} == sigs
    first = next(s for s in spans if s["cat"] == "sequence")
    steps = [s for s in spans if s["cat"] == "step"][:2]
    assert first["args"]["predicted_s"] == pytest.approx(
        sum(s["args"]["predicted_s"] for s in steps), rel=1e-12)
    assert [s["args"]["dispatch_only"] for s in spans
            if s.get("args", {}).get("dispatch_only")] == [True]
    for got, want in zip(out, ref_out):
        np.testing.assert_array_equal(got, want)
    assert trace["meta"]["metrics"]["counters"]["accl_calls_total"]


def test_tracing_off_records_nothing_but_metrics_count():
    """The ring stays empty with tracing off (the default), while the
    always-on registry still counts the call."""
    from accl_tpu_torch import ReduceFunction
    from accl_tpu_torch import telemetry as PT

    tr = PT.get_tracer()
    tr.clear()
    assert not tr.enabled and tr.active  # observability is on by default

    def calls():
        return sum(r["value"] for r in PT.get_registry().snapshot()
                   ["counters"].get("accl_calls_total", [])
                   if r["labels"]["op"] == "allreduce")

    before = calls()
    accl = _port_facade()
    a, c = accl.create_buffer(1024), accl.create_buffer(1024)
    accl.allreduce(a, c, 1024, ReduceFunction.SUM)
    assert tr.snapshot() == []
    assert calls() == before + 1
    PT.disable_observability()
    try:
        assert not tr.active
        assert tr.span("allreduce") is tr.span("bcast")
        accl.allreduce(a, c, 1024, ReduceFunction.SUM)
        assert calls() == before + 1
    finally:
        PT.enable_observability()


@pytest.mark.parametrize("source", ("synthetic", "golden_trace.json"))
def test_autotune_from_trace_sets_the_reference_registers(mesh8, source):
    from accl_tpu.accl import ACCL as RefACCL
    import accl_tpu.telemetry as RT
    import accl_tpu_torch.telemetry as PT

    trace = (_synthetic_trace("accl_tpu_torch", alpha=5e-4, beta=0.5e9)
             if source == "synthetic" else _committed(source))
    ref, port = RefACCL(mesh8), _port_facade()
    want = RT.autotune_from_trace(ref, trace)
    got = PT.autotune_from_trace(port, trace)
    assert vars(got) == vars(want)
    assert vars(port.cclo.tuning()) == vars(ref.cclo.tuning())
    assert got.reduce_flat_tree_max_count >= 1


def test_recv_timeout_freezes_the_reference_post_mortem(mesh8):
    """A recv no send matches times out (RECEIVE_TIMEOUT_ERROR); with
    observability armed, both packages freeze a post-mortem holding the
    preceding call span and the error marker, of the same shape."""
    from accl_tpu.accl import ACCL as RefACCL
    from accl_tpu.constants import ReduceFunction as RefF
    from accl_tpu_torch import ACCLError, ReduceFunction
    from accl_tpu.constants import ACCLError as RefACCLError

    docs = {}
    for pkg, accl, F, err in (
            ("accl_tpu", RefACCL(mesh8), RefF, RefACCLError),
            ("accl_tpu_torch", _port_facade(), ReduceFunction, ACCLError)):
        t = _tel(pkg)
        t.recorder.get_recorder().clear()
        a, c = accl.create_buffer(256), accl.create_buffer(256)
        accl.allreduce(a, c, 256, F.SUM)
        accl.set_timeout(20_000)
        try:
            with pytest.raises(err, match="RECEIVE_TIMEOUT"):
                accl.recv(c, 256, src=0, dst=1, tag=7)
        finally:
            accl.set_timeout(1_000_000)
        doc = t.last_error_trace()
        t.validate_trace(doc)
        docs[pkg] = doc
    ref, port = docs["accl_tpu"], docs["accl_tpu_torch"]
    shape = [(s["name"], s["cat"], s["track"], sorted(s["args"]))
             for s in port["spans"]]
    assert shape == [(s["name"], s["cat"], s["track"], sorted(s["args"]))
                     for s in ref["spans"]]
    assert shape[-2][:2] == ("allreduce", "call")
    assert shape[-1][:2] == ("recv", "error")
    assert port["spans"][-1]["args"] == ref["spans"][-1]["args"]
    assert port["meta"].keys() == ref["meta"].keys()
    assert port["meta"]["reason"] == ref["meta"]["reason"]
    assert _ref_schema_ok(port)
