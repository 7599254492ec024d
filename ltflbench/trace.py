"""The traced window: ``torch.profiler`` over a steady part of a run, kept
in memory and reduced to what the per-layer metrics read.

Device time is the union of the device events' intervals inside the
window (``chip_smoke.profile_call``'s arithmetic), so overlapping events
count once; the idle share is one minus it over the window. A kernel's
time is the summed duration of the device events whose names match its
patterns. Only the reduction is kept: no trace file is written.
"""
from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

Span = Tuple[str, int, int]          # name, start ns, end ns


@dataclass
class Trace:
    window_ns: Tuple[int, int]
    device: List[Span] = field(default_factory=list)
    host: List[Span] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return union_ns([(s, e) for _, s, e in self.device],
                        *self.window_ns) / 1e9

    def kernel_s(self, patterns: Sequence[str]) -> float:
        """Summed duration of the device events matching any pattern."""
        rx = re.compile("|".join(patterns))
        return sum(e - s for n, s, e in self.device if rx.search(n)) / 1e9

    def count(self, patterns: Sequence[str]) -> int:
        rx = re.compile("|".join(patterns))
        return sum(1 for n, _, _ in self.device if rx.search(n))


def union_ns(spans: Iterable[Tuple[int, int]], lo: int, hi: int) -> int:
    """Length of the union of the intervals, clipped to [lo, hi]."""
    busy, end = 0, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in spans):
        if e <= s:
            continue
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def capture(fn: Callable[[], None], sync: Callable[[], None]) -> Trace:
    """Run ``fn`` under the profiler, the window bounded by ``sync()`` on
    both sides, and keep its device and host events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.time_ns()
        fn()
        sync()
        t1 = time.time_ns()
    trace = Trace(window_ns=(t0, t1))
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        span = (ev.name(), start, start + ev.duration_ns())
        if ev.device_type().name == "CUDA":
            trace.device.append(span)
        else:
            trace.host.append(span)
    return trace


def top_device_ops(trace: Trace, k: int = 10) -> List[List]:
    """The ``k`` device operations that took the most time in the
    window, by name, with their summed seconds."""
    lo, hi = trace.window_ns
    total = {}
    for n, s, e in trace.device:
        d = min(e, hi) - max(s, lo)
        if d > 0:
            total[n] = total.get(n, 0) + d
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:k]
    return [[n, v / 1e9] for n, v in ranked]


def idle_gaps(trace: Trace, k: int = 10) -> List[List]:
    """The ``k`` longest stretches of the window with no device event,
    each named by the innermost host event that covers its middle (what
    the host was doing while the device waited)."""
    lo, hi = trace.window_ns
    gaps, end = [], lo
    for s, e in sorted((s, e) for _, s, e in trace.device):
        if s > end:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
    if end < hi:
        gaps.append((end, hi))
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:k]
    out = []
    for a, b in gaps:
        mid = (a + b) // 2
        covering = [(e - s, n) for n, s, e in trace.host if s <= mid <= e]
        name = min(covering)[1] if covering else "no host event"
        out.append([name, (b - a) / 1e9])
    return out


def share(trace: Trace, patterns: Sequence[str]) -> Optional[float]:
    """Percent of the device's busy time spent in the matching kernels;
    None where the trace has no device time or no matching event."""
    busy = trace.busy_s
    if busy <= 0 or trace.count(patterns) == 0:
        return None
    return 100.0 * trace.kernel_s(patterns) / busy


def idle_share(trace: Trace) -> Optional[float]:
    if not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
