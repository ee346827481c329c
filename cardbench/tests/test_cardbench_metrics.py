"""Each per-layer metric's reader on a hand-made context: its value, and
nothing where it finds nothing to read."""

from types import SimpleNamespace

import pytest

from cardbench import harness
from cardbench.trace import TraceView

ROOT = harness.ROOT
MS = 1_000_000


def _read(name, ctx):
    return harness._module(ROOT, "metrics", name).read(ctx)


def _ctx(**kw):
    base = dict(steps=4, window_s=0.02, step_bytes=3.35e12 * 0.001,
                spans=[], launches=10, replays=0, replay_ns=[], trace=None,
                peak_bytes=0, operand_bytes=1 << 30, phases={})
    base.update(kw)
    return SimpleNamespace(**base)


def test_facade_host_us_is_the_median_facade_span():
    spans = [{"track": "facade", "dur_ns": d} for d in (3000, 1000, 2000)]
    spans.append({"track": "device", "dur_ns": 10**9})
    assert _read("facade_host_us", _ctx(spans=spans)) == 2.0
    assert _read("facade_host_us", _ctx()) is None


def test_launches_per_step_counts_a_replay_as_one():
    assert _read("launches_per_step", _ctx(launches=10, replays=2)) == 3.0
    assert _read("launches_per_step", _ctx(steps=0)) is None


def test_replay_device_ms_is_the_median_replay():
    assert _read("replay_device_ms", _ctx(replay_ns=[2 * MS, 4 * MS, 9 * MS])) == 4.0
    assert _read("replay_device_ms", _ctx()) is None


def test_step_roofline_over_the_window():
    # 4 steps of 1 ms each at the peak, in 20 ms: 20%
    assert _read("step_roofline", _ctx()) == pytest.approx(20.0)


def test_kernel_roofline_and_idle_share_from_the_trace():
    host = [("step", 0, 10 * MS), ("step", 10 * MS, 20 * MS)]
    dev = [("void ring_allreduce_kernel<float>", 0, 4 * MS),
           ("Memcpy DtoD", 4 * MS, 5 * MS)]
    view = TraceView(dev, host)
    ctx = _ctx(trace=view)
    # 2 traced steps of 1 ms at the peak over 4 ms of kernel 1: 50%
    assert _read("ring_kernel_roofline", ctx) == pytest.approx(50.0)
    assert _read("device_idle_pct", ctx) == pytest.approx(75.0)
    other = _ctx(trace=TraceView([("Memcpy DtoD", 0, MS)], host))
    assert _read("ring_kernel_roofline", other) is None
    assert _read("ring_kernel_roofline", _ctx()) is None
    assert _read("device_idle_pct", _ctx()) is None


def test_peak_copies_counts_operand_sized_sets():
    assert _read("peak_copies", _ctx(peak_bytes=3 << 30)) == 3.0
    assert _read("peak_copies", _ctx()) is None


def test_buffers_s_is_the_set_up_phase():
    assert _read("buffers_s", _ctx(phases={"buffers": 14.5})) == 14.5
    assert _read("buffers_s", _ctx()) is None
