"""The readers of the program's layer spans (track `layer`): each on
hand-made spans, where it finds nothing to read, and on a tiny traced
run of `decode_graph_b64` on the CPU, where every host reading and the
copy count are there and the device readings are not."""

import time
from types import SimpleNamespace

import pytest

from cardbench import harness

ROOT = harness.ROOT
HOST = ("bind", "load", "results", "markers", "place")
DEVICE = ("load", "results")
NEW = ([f"{n}_host_us" for n in HOST] + [f"{n}_device_ms" for n in DEVICE]
       + ["copies_per_step"])


def _read(name, spans):
    return harness._module(ROOT, "metrics", name).read(
        SimpleNamespace(spans=spans))


def _layer(name, dur_ns, parent_ts=0, **args):
    return {"name": name, "cat": "phase", "track": "layer", "ts_ns": 0,
            "dur_ns": dur_ns,
            "args": dict(parent="dispatch", parent_ts_ns=parent_ts, **args)}


@pytest.mark.parametrize("name", HOST)
def test_host_readers_take_the_median_of_their_span(name):
    spans = [_layer(name, d) for d in (3000, 1000, 2000)]
    # another layer span, and a span of that name on another track
    spans.append(_layer("other", 10**9))
    spans.append({"name": name, "track": "device", "dur_ns": 10**9,
                  "args": {}})
    assert _read(f"{name}_host_us", spans) == 2.0
    assert _read(f"{name}_host_us", []) is None


@pytest.mark.parametrize("name", DEVICE)
def test_device_readers_read_the_event_pairs(name):
    spans = [_layer(name, 10**9, device_ns=ns)
             for ns in (4_000_000, 5_000_000, 9_000_000)]
    spans.append(_layer(name, 10**9))  # off the card: no device_ns
    assert _read(f"{name}_device_ms", spans) == 5.0
    assert _read(f"{name}_device_ms", [_layer(name, 1)]) is None
    assert _read(f"{name}_device_ms", []) is None


def test_copies_per_step_pairs_load_and_results_by_their_dispatch():
    spans = []
    for ts in (10, 20, 30):
        spans += [_layer("load", 1, ts, copies=352),
                  _layer("results", 1, ts, copies=176)]
    # a dispatch whose results span the ring dropped
    spans.append(_layer("load", 1, 40, copies=352))
    assert _read("copies_per_step", spans) == 528
    assert _read("copies_per_step", [_layer("bind", 1, 10, n=352)]) is None


def test_every_new_metric_is_declared_for_the_decode_cell():
    spec = harness.load_spec()
    by = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        assert by[name]["workloads"] == ["decode_graph_b64"]
    assert by["copies_per_step"]["source"] == "program_counter"


def test_a_traced_decode_run_on_the_cpu_reads_the_layer_spans():
    cell = harness.load_cell(harness.load_spec(), "decode_graph_b64")
    res = harness.run_cell("decode_graph_b64", 2**31 + 17, 0.05, True,
                           t_start=time.perf_counter(), device="cpu",
                           shrink=cell.traffic["cpu_shrink"])
    assert res["correct"] is True
    got = res["metrics"]
    for name in HOST:
        assert got[f"{name}_host_us"]["value"] > 0
    # 176 allreduces: 352 buffers copied in, 176 results cloned out
    assert got["copies_per_step"]["value"] == 528
    for name in DEVICE:
        assert f"{name}_device_ms" not in got
    # the profiled phase's gap names stay the benchmark's own
    names = {n for n, _ in res["breakdown"]["idle_gaps"]}
    assert names <= {"step", "dispatch", "wait", "replay", "between_steps"}
    assert not any(n.startswith("accl:")
                   for n, _ in res["breakdown"]["device_ops"])
