"""One torch.profiler window over a few items of a traced run, reduced to
what the per-layer metrics and the breakdown read: the device's busy time
(the union of its kernels, copies and sets), kernel launches, kernel time
by name, the idle gaps by what the host was doing, and the calls that
blocked the host inside the port's root spans (harness/spans.py)."""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10
SCAN = 4000           # host events looked back at when naming a gap


@dataclass
class Profile:
    window_s: float                              # host clock, synchronized ends
    busy_s: float                                # union of device activity
    kernels: List[Tuple[str, float]]             # (name, seconds) of every kernel
    idle_by_host: List[Tuple[str, float]] = field(default_factory=list)
    syncs: Dict[str, int] = field(default_factory=dict)   # by innermost span

    def kernel_s(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(d for n, d in self.kernels if rx.search(n))

    def top_ops(self, n: int = TOP) -> List[Tuple[str, float]]:
        by = defaultdict(float)
        for name, d in self.kernels:
            by[name[:200]] += d
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]


class Window:
    """start() / stop() around the profiled items; read() afterwards gives
    the Profile. The trace is written under TMPDIR and removed once read."""

    def __init__(self):
        self.prof = None
        self.t0 = self.window_s = 0.0

    @staticmethod
    def warm() -> None:
        """Start the profiler once outside the window: its first start
        initialises the device tracer, which takes seconds."""
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                       torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)

    def read(self) -> Profile:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.prof = None
        return reduce_trace(events, self.window_s)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce_trace(events: List[dict], window_s: float) -> Profile:
    """Profile of a chrome trace's events (times in microseconds)."""
    from .spans import host_syncs     # spans.py imports this module
    dev, kernels, host, spans = [], [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, ts, dur = ev.get("cat", ""), float(ev["ts"]), float(ev["dur"])
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            if cat == "kernel":
                kernels.append((ev.get("name", "?"), dur * 1e-6))
        elif cat in HOST_CATS:
            name = ev.get("name", "?")
            (spans if name.startswith("span:") else host).append((ts, ts + dur, name))
    busy = _merge(dev)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    return Profile(window_s=window_s, busy_s=busy_s, kernels=kernels,
                   idle_by_host=_idle_by_host(busy, host, spans), syncs=host_syncs(events))


def _innermost(t: float, evs: List[Tuple[float, float, str]], starts: List[float]
               ) -> Optional[str]:
    i = bisect.bisect_right(starts, t)
    best, best_len = None, float("inf")
    for s, e, name in evs[max(0, i - SCAN):i][::-1]:
        if e >= t and e - s < best_len:
            best, best_len = name, e - s
    return best


def _idle_by_host(busy, host, spans) -> List[Tuple[str, float]]:
    """Seconds of the gaps between device activity, summed by what the host
    ran at each gap's middle: the innermost span of the benchmark's and the
    innermost host operation, or 'python' where no operation ran."""
    if len(busy) < 2:
        return []
    host.sort()
    spans.sort()
    hs, ss = [h[0] for h in host], [s[0] for s in spans]
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)), reverse=True)[:500]
    by = defaultdict(float)
    for g, s, e in gaps:
        mid = 0.5 * (s + e)
        span = _innermost(mid, spans, ss) or "-"
        op = _innermost(mid, host, hs) or "python"
        by[f"{span} | {op}"[:200]] += g * 1e-6
    return sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
