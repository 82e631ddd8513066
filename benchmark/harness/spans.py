"""What a traced run can read of the port's own spans
(nerfloc_tpu_torch/utils/profiling.py: `span:<name>` profiler ranges and
in-memory records, both only while the port's tracer is on).

- `recording`: the drivers' switch, the port's tracer on from a traced
  window's start to the end of its profiled items, its records kept in
  the run's Record; an untraced run, or a system without the tracer (the
  reference), leaves it off.
- `span_ms`: host ms per item summed over the records of one span name.
- `host_syncs`: the CUDA runtime and driver calls that block the host,
  counted inside the port's root spans (`span:query`, `span:step`) of a
  chrome trace, by the innermost span around each; the driver's own
  reads of poses and losses fall outside them.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib
from collections import Counter
from typing import Dict, Iterable, Optional, Sequence

from .profile import _innermost, _merge
from .systems import PORT

ROOT_SPANS = ("span:query", "span:step")
API_CATS = ("cuda_runtime", "cuda_driver")


def blocks_host(name: str) -> bool:
    """A runtime or driver call that waits for the device: any
    *Synchronize, and a copy without Async (cudaMemcpy, cuMemcpyDtoH...)."""
    if "Synchronize" in name:
        return True
    return name.startswith(("cudaMemcpy", "cuMemcpy")) and "Async" not in name


def host_syncs(events: Sequence[dict]) -> Dict[str, int]:
    """Calls that block the host whose start lies inside a root span of
    the port, counted by the innermost `span:` range around each (chrome
    trace events, times in microseconds; any thread's ranges)."""
    spans = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), ev["name"])
                   for ev in events if ev.get("ph") == "X" and "dur" in ev
                   and str(ev.get("name", "")).startswith("span:"))
    span_starts = [s for s, _, _ in spans]
    roots = _merge([(s, e) for s, e, name in spans if name in ROOT_SPANS])
    starts = [s for s, _ in roots]
    by: Dict[str, int] = Counter()
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in API_CATS:
            continue
        if not blocks_host(ev.get("name", "")):
            continue
        t = float(ev["ts"])
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= roots[i][1]:
            by[_innermost(t, spans, span_starts)] += 1
    return dict(by)


def span_ms(records, name: str, items: Iterable[int]) -> Optional[float]:
    """Host ms per item of `items`, summed over the records named `name`
    (profiling.Span: name, item, start_ns, end_ns); None where no such
    record falls in them."""
    items = set(items)
    ns = [r.end_ns - r.start_ns for r in records if r.name == name and r.item in items]
    return 1e-6 * sum(ns) / len(items) if ns else None


@contextlib.contextmanager
def recording(system, rec, on: bool):
    """With `on` and the port as `system`, the port's tracer cleared and on
    for the block (its items numbered from 0 by the block's first root
    span), then off, its records in rec.spans. Otherwise nothing: the
    tracer stays off and nothing is imported."""
    if not on or system.package != PORT:
        yield
        return
    tracer = importlib.import_module(f"{PORT}.utils.profiling")
    tracer.clear()
    tracer.enable(True)
    try:
        yield
    finally:
        tracer.enable(False)
        rec.spans = tracer.records()
        tracer.clear()
