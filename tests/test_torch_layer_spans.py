"""The port's layer spans (telemetry.tracer.Tracer.layer) and the
profiler bridge, on the CPU.

With the ring collecting, an eager call leaves `resolve` and `launch`
under its facade span, and a prepared sequence's dispatch leaves `bind`,
`load`, `results` and `place` under its `dispatch` span and `markers`
under its facade span, each naming that span by name and start. With the
ring off and no profiler the gate is closed: `layer()` is the shared
no-op, a dispatch records the replay's two CUDA events and no more, and
the always-on registry reads the same. Under torch.profiler every live
span opens an `accl:<track>/<name>` range inside its caller's. An async
eager call with the ring off computes no timing.predict estimate; a
synchronous one still feeds the drift sentinel. A graph dispatch's
device path runs here over a stand-in for the CUDA event and graph:
completion waits on the replay's end only, and a `results` span whose
clones are still running is emitted at a later completion.
"""

import pytest
import torch

from accl_tpu_torch import ACCL, ReduceFunction
from accl_tpu_torch import telemetry as PT
from accl_tpu_torch.telemetry.metrics import MetricsObserver
from accl_tpu_torch.telemetry.tracer import _NULL_SPAN

WORLD = 4
N = 64
SUM = ReduceFunction.SUM


@pytest.fixture
def tracer():
    tr = PT.get_tracer()
    was = tr.enabled
    tr.clear()
    yield tr
    tr.clear()
    if was:
        tr.enable()
    else:
        tr.disable()


def _program(accl, n_calls=3):
    """A compiled batch of `n_calls` allreduces, each with its own send
    and receive buffer, as a decode step's."""
    rec = accl.sequence()
    for _ in range(n_calls):
        rec.allreduce(accl.create_buffer(N), accl.create_buffer(N), N, SUM)
    return rec.compile()


def _run(prog, accl):
    accl.wait(prog.run(from_device=True, to_device=True, run_async=True))


def _cause_of(span, spans):
    """The span a layer span names as its cause."""
    hits = [s for s in spans if s["name"] == span["args"]["parent"]
            and s["ts_ns"] == span["args"]["parent_ts_ns"]]
    assert len(hits) == 1, span
    return hits[0]


def test_both_paths_name_their_cause(tracer):
    accl = ACCL(world=WORLD, torch_device="cpu")
    a, b = accl.create_buffer(N), accl.create_buffer(N)
    prog = _program(accl)
    tracer.enable()
    accl.allreduce(a, b, N, SUM)
    accl.wait(accl.allreduce(a, b, N, SUM, run_async=True))
    _run(prog, accl)
    spans = tracer.drain()
    layer = [s for s in spans if s["track"] == "layer"]
    assert all(s["cat"] == "phase" for s in layer)
    assert [s["name"] for s in layer] == [
        "resolve", "launch", "resolve", "launch",
        "bind", "markers", "load", "results", "place"]
    for s in layer:
        cause = _cause_of(s, spans)
        assert cause["ts_ns"] <= s["ts_ns"]
        assert "device_ns" not in s["args"]
        if s["name"] in ("resolve", "launch"):
            assert (cause["cat"], cause["name"]) == ("call", "allreduce")
            assert s["ts_ns"] + s["dur_ns"] <= cause["ts_ns"] + cause[
                "dur_ns"]
        elif s["name"] == "markers":
            assert (cause["cat"], cause["name"]) == ("sequence", "sequence")
        else:
            assert (cause["track"], cause["name"]) == ("device", "dispatch")
    calls = [s for s in spans if s["cat"] == "call"]
    assert [_cause_of(s, spans) for s in layer[:4]] == [
        calls[0], calls[0], calls[1], calls[1]]
    by = {s["name"]: s["args"] for s in layer[4:]}
    assert by["load"]["copies"] == 6
    assert by["results"]["copies"] == 3
    assert by["load"]["bytes"] == prog.graph.load_bytes
    assert by["results"]["bytes"] == prog.graph.results_bytes == \
        2 * 3 * WORLD * N * 4
    assert by["bind"]["n"] == 6 and by["place"]["n"] == 3
    assert by["markers"]["n"] == 3
    assert "algorithm" in layer[0]["args"]


def test_closed_gate_builds_nothing_and_the_registry_reads_the_same(tracer):
    assert not tracer.enabled and not tracer.layering
    assert tracer.layer("bind", n=1) is _NULL_SPAN
    assert not _NULL_SPAN
    accl = ACCL(world=WORLD, torch_device="cpu")
    a, b = accl.create_buffer(N), accl.create_buffer(N)
    prog = _program(accl)

    def registry(ring):
        obs = MetricsObserver()
        tracer.add_observer(obs)
        if ring:
            tracer.enable()
        try:
            accl.allreduce(a, b, N, SUM)
            accl.wait(accl.allreduce(a, b, N, SUM, run_async=True))
            _run(prog, accl)
        finally:
            tracer.disable()
            tracer.remove_observer(obs)
        snap = obs.registry.snapshot()
        return ({k: rows for k, rows in snap["counters"].items()},
                {k: [(r["labels"], r["count"]) for r in rows]
                 for k, rows in snap["histograms"].items()})

    off = registry(False)
    assert tracer.snapshot() == []
    on = registry(True)
    assert any(s["track"] == "layer" for s in tracer.drain())
    assert on == off
    assert [labels for labels, _ in on[1]["accl_phase_seconds"]] == [
        {"phase": "dispatch"}]


class _Event:
    """A stand-in for torch.cuda.Event: every record and sync counted,
    1 ms between any two; `passed` is what query() answers."""

    made: list = []

    def __init__(self, enable_timing=False):
        self.records = 0
        self.synced = 0
        self.passed = True
        _Event.made.append(self)

    def record(self, stream=None):
        self.records += 1

    def query(self):
        return self.passed

    def synchronize(self):
        self.synced += 1

    def elapsed_time(self, other):
        return 1.0


class _Graph:
    def replay(self):
        pass


@pytest.fixture
def graph_dispatch(monkeypatch):
    """A prepared program whose dispatch takes the graph path, over the
    stand-in event and a graph whose replay leaves the outputs of one
    eager run in place."""
    accl = ACCL(world=WORLD, torch_device="cpu")
    prog = _program(accl)
    _run(prog, accl)
    prog.graph.graph = _Graph()
    _Event.made = []
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    return accl, prog


def test_closed_gate_records_the_replays_two_events(graph_dispatch, tracer):
    accl, prog = graph_dispatch
    req = prog.run(from_device=True, to_device=True, run_async=True)
    accl.wait(req)
    assert len(_Event.made) == 2
    assert [e.records for e in _Event.made] == [1, 1]
    assert _Event.made[1].synced == 1
    assert req.get_duration_ns() == 1_000_000


def test_open_gate_times_the_copies_on_the_card(graph_dispatch, tracer):
    accl, prog = graph_dispatch
    tracer.enable()
    req = prog.run(from_device=True, to_device=True, run_async=True)
    start, end, head, tail = _Event.made
    assert req._events == (start, end)
    assert [e.records for e in _Event.made] == [1, 1, 1, 1]
    # the clones are still running at completion, which waits on the
    # replay's end alone: `results` waits for a later completion
    tail.passed = False
    accl.wait(req)
    assert end.synced == 1 and tail.synced == 0
    assert req.get_duration_ns() == 1_000_000
    first = {s["name"]: s for s in tracer.drain() if s["track"] == "layer"}
    assert "results" not in first
    assert first["load"]["args"]["device_ns"] == 1_000_000
    tail.passed = True
    _run(prog, accl)
    spans = [s for s in tracer.drain() if s["track"] == "layer"]
    results = [s for s in spans if s["name"] == "results"]
    assert [s["args"]["parent_ts_ns"] for s in results] == [
        first["load"]["args"]["parent_ts_ns"],
        next(s for s in spans if s["name"] == "load")["args"][
            "parent_ts_ns"]]
    assert all(s["args"]["device_ns"] == 1_000_000 for s in results)
    assert first["load"]["args"]["copies"] + results[0]["args"][
        "copies"] == 9
    assert len(_Event.made) == 8


def test_profiler_ranges_nest_and_stay_out_of_the_benchmarks_names(tracer):
    from cardbench.trace import HOST_SPANS

    accl = ACCL(world=WORLD, torch_device="cpu")
    a, b = accl.create_buffer(N), accl.create_buffer(N)
    prog = _program(accl)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert tracer.layering and not tracer.enabled
        with torch.profiler.record_function("replay"):
            _run(prog, accl)
        with torch.profiler.record_function("dispatch"):
            accl.allreduce(a, b, N, SUM)
    assert not tracer.layering
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    outer = {n: (s, e) for n, s, e in events if n in ("replay", "dispatch")}
    bridged = [(n, s, e) for n, s, e in events if n.startswith("accl:")]
    names = {n for n, _, _ in bridged}
    assert {"accl:facade/sequence", "accl:device/dispatch",
            "accl:layer/bind", "accl:layer/load", "accl:layer/results",
            "accl:layer/markers", "accl:layer/place",
            "accl:facade/allreduce", "accl:layer/resolve",
            "accl:layer/launch"} <= names
    assert not names & set(HOST_SPANS)
    for n, s, e in bridged:
        lo, hi = outer["dispatch" if n in (
            "accl:facade/allreduce", "accl:layer/resolve",
            "accl:layer/launch") else "replay"]
        assert lo <= s and e <= hi, n
    # the ring stayed off: the bridge records into the profiler only
    assert tracer.snapshot() == []


def test_async_eager_call_with_the_ring_off_predicts_nothing(
        tracer, monkeypatch):
    from accl_tpu_torch.sequencer import timing

    predict = timing.predict
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return predict(*a, **kw)

    fed = []
    sentinel = PT.get_sentinel()
    feed = sentinel.feed
    monkeypatch.setattr(timing, "predict", counted)
    monkeypatch.setattr(sentinel, "feed",
                        lambda *a: (fed.append(a[0]), feed(*a)))
    accl = ACCL(world=WORLD, torch_device="cpu")
    a, b = accl.create_buffer(N), accl.create_buffer(N)
    accl.wait(accl.allreduce(a, b, N, SUM, run_async=True))
    assert calls == [] and fed == []
    accl.allreduce(a, b, N, SUM)
    assert calls == [1] and fed == ["allreduce"]
    tracer.enable()
    accl.wait(accl.allreduce(a, b, N, SUM, run_async=True))
    assert calls == [1, 1] and fed == ["allreduce"]
    (span,) = [s for s in tracer.drain() if s["cat"] == "call"]
    assert span["args"]["dispatch_only"] and span["args"]["predicted_s"] > 0
