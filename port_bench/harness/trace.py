"""Reduction of a `torch.profiler` trace, kept in memory, to what the
per-layer metrics read: each device operation's time by name, the device's
busy time (the union of its operations' intervals) inside the traced
window, and its idle gaps named by the benchmark span the host was in.

The benchmark marks its spans with `record_function("bench.<name>")`; the
traced window is the span "bench.window". Kernel and host events share the
profiler's clock.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import List

WINDOW = "bench.window"


class TraceSummary:
    """`ops`: device seconds by operation name; `busy_s`, `window_s`; `gaps`:
    idle seconds by the innermost benchmark span open at each gap's start."""

    def __init__(self, ops: Counter, busy_s: float, window_s: float, gaps: Counter):
        self.ops, self.busy_s, self.window_s, self.gaps = ops, busy_s, window_s, gaps

    def seconds_matching(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(s for name, s in self.ops.items() if rx.search(name))

    @property
    def device_s(self) -> float:
        return sum(self.ops.values())


def summarize(events) -> TraceSummary:
    """From `prof.events()` (FunctionEvents, times in microseconds)."""
    from torch.autograd import DeviceType

    spans, device = [], []
    for e in events:
        if e.is_user_annotation and e.device_type == DeviceType.CPU and e.name.startswith("bench."):
            spans.append((e.name, e.time_range.start, e.time_range.end))
        elif e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            device.append((e.name, e.time_range.start, e.time_range.end))
    windows = [(a, b) for name, a, b in spans if name == WINDOW]
    if not windows:
        raise ValueError("the trace has no bench.window span")
    w0, w1 = windows[0]
    inside = sorted((a, b, n) for n, a, b in device if a >= w0 and b <= w1 and b > a)
    ops = Counter()
    for a, b, n in inside:
        ops[n] += (b - a) * 1e-6
    busy, gaps = 0.0, Counter()
    named = sorted(((a, b, n) for n, a, b in spans if n != WINDOW), key=lambda s: s[0])

    def host_at(t: float) -> str:
        best = None
        for a, b, n in named:
            if a <= t <= b and (best is None or a >= best[0]):
                best = (a, n)
        return best[1][len("bench."):] if best else "between spans"

    cursor = w0
    for a, b, _ in inside:
        if a > cursor:
            gaps[host_at(cursor)] += (a - cursor) * 1e-6
        if b > cursor:
            busy += (b - max(a, cursor)) * 1e-6
            cursor = b
    if w1 > cursor:
        gaps[host_at(cursor)] += (w1 - cursor) * 1e-6
    return TraceSummary(ops, busy, (w1 - w0) * 1e-6, gaps)


def top(counter: Counter, k: int = 10) -> List[list]:
    return [[name, seconds] for name, seconds in counter.most_common(k)]

