"""What a traced window's device trace says: device intervals, host
spans, busy time, idle gaps and the breakdown.

The benchmark's own host spans (`step`, `dispatch`, `wait`, `replay`)
are `torch.profiler.record_function` ranges, so they share the device
trace's clock. The traced window runs from the first `step` span's
start to the last one's end. Busy time is the union of every kernel,
copy and fill on the card inside that window; an idle gap is named by
the innermost host span that covers its middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

HOST_SPANS = ("step", "dispatch", "wait", "replay")
TOP = 10
NAME_CHARS = 160


class TraceView:
    def __init__(self, device: list[tuple[str, int, int]],
                 host: list[tuple[str, int, int]]):
        steps = [(s, e) for n, s, e in host if n == "step"]
        self.steps = len(steps)
        self.t0 = min(s for s, _ in steps) if steps else 0
        self.t1 = max(e for _, e in steps) if steps else 0
        # device intervals clipped to the window
        self.device = [(n, max(s, self.t0), min(e, self.t1))
                       for n, s, e in device if e > self.t0 and s < self.t1]
        self.host = host

    @classmethod
    def from_profiler(cls, prof) -> "TraceView":
        from torch.autograd import DeviceType

        device, host = [], []
        for ev in prof.profiler.kineto_results.events():
            s = ev.start_ns()
            e = s + ev.duration_ns()
            if ev.device_type() == DeviceType.CUDA:
                # a host span's range drawn on the device timeline is no
                # device work
                if not ev.is_user_annotation() and ev.name() not in HOST_SPANS:
                    device.append((ev.name(), s, e))
            elif ev.name() in HOST_SPANS:
                host.append((ev.name(), s, e))
        return cls(device, host)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> list[tuple[int, int]]:
        merged: list[list[int]] = []
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_seconds(self, fragment: str) -> tuple[float, int]:
        """Summed device seconds and count of the operations whose name
        holds `fragment`."""
        hits = [e - s for n, s, e in self.device if fragment in n]
        return sum(hits) / 1e9, len(hits)

    def device_ops(self) -> list[list]:
        by = defaultdict(int)
        for n, s, e in self.device:
            by[n[:NAME_CHARS]] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n, t / 1e9] for n, t in top]

    def idle_gaps(self) -> list[list]:
        gaps = []
        prev = self.t0
        for s, e in self.busy_intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        # spans of one name never overlap: one sorted list a name, the
        # innermost (latest in HOST_SPANS) that covers a gap names it
        levels = []
        for name in reversed(HOST_SPANS):
            spans = sorted((s, e) for n, s, e in self.host if n == name)
            levels.append((name, [s for s, _ in spans], spans))
        by = defaultdict(int)
        for s, e in gaps:
            mid = (s + e) // 2
            name = "between_steps"
            for level, starts, spans in levels:
                i = bisect.bisect_right(starts, mid) - 1
                if i >= 0 and spans[i][1] > mid:
                    name = level
                    break
            by[name] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n, t / 1e9] for n, t in top]
