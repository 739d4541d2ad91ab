"""A traced window: ``torch.profiler`` (CPU and CUDA activities) around a
fixed piece of the cell's work, opened and closed by the benchmark's own
span ``bench.window``, and what the harness reads from it: the device's
busy seconds (the union of every device operation's interval inside the
window), the device time of kernels by name, and the idle gaps named by
what the host was doing in them."""
from __future__ import annotations

import heapq
import re
from typing import Callable, Dict, List, Tuple

SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.window"


class Trace:
    def __init__(self, device_ops: List[Tuple[float, float, str]],
                 host_ops: List[Tuple[float, float, str]],
                 window: Tuple[float, float]):
        self.window = window                     # (start, end), us
        lo, hi = window
        self.device_ops = [(max(s, lo), min(e, hi), n)
                           for s, e, n in device_ops if e > lo and s < hi]
        self.host_ops = host_ops
        self.busy = _union(sorted((s, e) for s, e, _ in self.device_ops))

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def kernel_seconds(self, names) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds one
        of ``names``."""
        hits = [(e - s) for s, e, n in self.device_ops
                if any(k in n for k in names)]
        return sum(hits) * 1e-6, len(hits)

    def top_ops(self, k: int = 10):
        by: Dict[str, float] = {}
        for s, e, n in self.device_ops:
            by[n] = by.get(n, 0.0) + (e - s) * 1e-6
        return _top(by, k)

    def idle_gaps(self, k: int = 10):
        """The idle time inside the window summed by the host's activity at
        each gap's middle: the outermost and the innermost host operation
        open there ("outer/inner"), or "none"."""
        lo, hi = self.window
        gaps, at = [], lo
        for s, e in self.busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        ops = sorted(self.host_ops)
        by: Dict[str, float] = {}
        open_ops: list = []
        i = 0
        for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
            t = (g0 + g1) / 2
            while i < len(ops) and ops[i][0] <= t:
                heapq.heappush(open_ops, (ops[i][1], ops[i][0], ops[i][2]))
                i += 1
            while open_ops and open_ops[0][0] < t:
                heapq.heappop(open_ops)
            if open_ops:
                outer = min(open_ops, key=lambda o: o[1])[2]
                inner = max(open_ops, key=lambda o: o[1])[2]
                name = outer if outer == inner else f"{outer}/{inner}"
            else:
                name = "none"
            by[name] = by.get(name, 0.0) + (g1 - g0) * 1e-6
        return _top(by, k)


def _union(intervals):
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _top(by: Dict[str, float], k: int):
    return [[clean(n), v] for n, v in sorted(by.items(),
                                             key=lambda kv: -kv[1])[:k]]


def clean(name: str, width: int = 80) -> str:
    return re.sub(r"[^A-Za-z0-9_.:/-]+", "_", name)[:width]


def profile(fn: Callable[[], None]) -> Trace:
    """Run ``fn`` (which ends in a device synchronisation) under the
    profiler inside the span ``bench.window``, and read the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            fn()
    cuda = torch.autograd.DeviceType.CUDA
    device_ops, host_ops, window = [], [], None
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end
        if ev.device_type == cuda:
            # the profiler mirrors the host's annotations (our spans) on
            # the device's timeline; they are not device work
            if not ev.name.startswith(SPAN_PREFIX):
                device_ops.append((s, e, ev.name))
        elif ev.name == WINDOW_SPAN:
            window = (s, e)
        else:
            host_ops.append((s, e, ev.name))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    return Trace(device_ops, host_ops, window)
