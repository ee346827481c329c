"""The reduction from a device timeline and host spans to busy time, idle
gaps and the breakdown, on a hand-made trace."""

import pytest

from cardbench.trace import TraceView

MS = 1_000_000


def _view():
    host = [("step", 0, 10 * MS), ("dispatch", 0, 2 * MS),
            ("wait", 2 * MS, 10 * MS), ("step", 10 * MS, 20 * MS),
            ("replay", 10 * MS, 13 * MS), ("wait", 13 * MS, 20 * MS)]
    device = [("ring", 1 * MS, 4 * MS), ("copy", 3 * MS, 5 * MS),
              ("ring", 12 * MS, 18 * MS), ("before", -5 * MS, -1 * MS),
              ("straddle", 19 * MS, 25 * MS)]
    return TraceView(device, host)


def test_window_runs_from_first_step_to_last():
    v = _view()
    assert v.steps == 2
    assert v.window_s == pytest.approx(0.020)


def test_busy_is_the_union_clipped_to_the_window():
    # [1, 5] + [12, 18] + [19, 20] ms
    assert _view().busy_s == pytest.approx(0.011)


def test_kernel_seconds_and_device_ops():
    v = _view()
    assert v.kernel_seconds("ring") == (pytest.approx(0.009), 2)
    assert v.kernel_seconds("absent") == (0.0, 0)
    ops = dict(v.device_ops())
    assert ops["ring"] == pytest.approx(0.009)
    assert "before" not in ops


def test_idle_gaps_are_named_by_the_innermost_host_span():
    # gaps [0, 1] dispatch, [5, 12]: middle 8.5 in wait, [18, 19] wait
    gaps = dict(_view().idle_gaps())
    assert gaps["dispatch"] == pytest.approx(0.001)
    assert gaps["wait"] == pytest.approx(0.008)
    assert set(gaps) == {"dispatch", "wait"}


def test_an_empty_trace_reads_nothing():
    v = TraceView([], [])
    assert v.steps == 0 and v.window_s == 0 and v.busy_s == 0
    assert v.idle_gaps() == [] and v.device_ops() == []
