"""The arithmetic the metric readers share (benchmark/metrics/*.py)."""
from __future__ import annotations

import math
from typing import Optional

from . import spans
from .cost import PEAK_BF16_FLOPS, agg_bound_s, agg_cost
from .record import Record

FUSED_AGG = r"fused_agg"      # the port's fused aggregation kernels, by name


def per_item_ms(r: Record, kind: str) -> Optional[float]:
    """Host ms per completed item over the whole window."""
    if r.kind != kind or r.trace or not r.items:
        return None
    return 1e3 * r.window_s / r.items


def traced_item_ms(r: Record, kind: str) -> Optional[float]:
    """Host ms per completed item over the whole window of a traced run
    (its spans on): the per-layer copy of a rate that a cell cannot bound
    end to end."""
    if r.kind != kind or not r.trace or not r.items:
        return None
    return 1e3 * r.window_s / r.items


def span_ms(r: Record, kind: str, layer: str) -> Optional[float]:
    return r.span_ms.get(layer) if r.kind == kind and r.trace else None


def program_span_ms(r: Record, kind: str, name: str) -> Optional[float]:
    """Host ms per window item of the port's span `name` (its records
    while the tracer was on, harness/spans.span_ms)."""
    if r.kind != kind or not r.trace or not r.items:
        return None
    return spans.span_ms(r.spans, name, range(r.items))


def host_syncs(r: Record, kind: str) -> Optional[float]:
    """Calls that blocked the host inside the port's root spans, per
    profiled item (harness/spans.host_syncs); None where the port's tracer
    left no record, as then no root span was there to count inside."""
    p = r.profile
    if r.kind != kind or p is None or not r.profile_items or not r.spans:
        return None
    return sum(p.syncs.values()) / r.profile_items


def item_quantile_ms(r: Record, kind: str, q: float, min_beyond: int = 10
                     ) -> Optional[float]:
    """The q-quantile (nearest rank) of the traced window's host ms per
    item; None where fewer than `min_beyond` items lie beyond it."""
    n = len(r.item_ms)
    if r.kind != kind or not r.trace or n * (1.0 - q) < min_beyond:
        return None
    return sorted(r.item_ms)[math.ceil(q * n) - 1]


def idle_share(r: Record, kind: str) -> Optional[float]:
    """% of the profiled window in which no kernel, copy or set ran."""
    p = r.profile
    if r.kind != kind or p is None or p.window_s <= 0 or p.busy_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)


def launches(r: Record, kind: str) -> Optional[float]:
    """Kernels the profiler saw per profiled item."""
    if r.kind != kind or r.profile is None or not r.profile_items:
        return None
    return len(r.profile.kernels) / r.profile_items


def roofline(r: Record, kind: str) -> Optional[float]:
    """% of the least time the card needs for the fused aggregation calls
    of the profiled items (their work counted from their shapes: bf16
    products at the bf16 peak, f32 ones at TF32's, other operations at the
    FP32 peak, bytes at HBM's rate) over the device time of the kernels
    named fused_agg in the same items."""
    p = r.profile
    if r.kind != kind or p is None or not r.agg_calls:
        return None
    t = p.kernel_s(FUSED_AGG)
    if t <= 0:
        return None
    bound = sum(agg_bound_s(agg_cost(c["N"], c["K"], c["F"], c["W"], c["param_shapes"],
                                     c["NF"], c["act_bytes"]),
                            "bf16" if c["act_bytes"] == 2 else "tf32")
                for c in r.agg_calls)
    return 100.0 * bound / t


def mfu(r: Record, kind: str) -> Optional[float]:
    """% of the bf16 peak that one item's FLOPs (counted once on the
    reference at the cell's shapes) make over the traced run's host time
    per item (its window, after the profiled items)."""
    if r.kind != kind or not r.trace or not r.flops_per_item:
        return None
    s = r.per_item_s()
    return 100.0 * r.flops_per_item / s / PEAK_BF16_FLOPS if s else None
