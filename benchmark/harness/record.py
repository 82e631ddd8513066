"""What one run measured, as the metric readers see it."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .profile import Profile


@dataclass
class Record:
    kind: str                        # the driver's item: 'query' or 'train'
    setup_s: float = 0.0             # process start to the window's start
    window_s: float = 0.0            # host clock over the whole window
    items: int = 0                   # queries or steps completed in the window
    peak_bytes: int = 0              # max_memory_allocated over the window
    trace: bool = False
    # traced runs: device ms per item by span over the window's items, then
    # a profiler window over `profile_items` items after the window (the
    # fused aggregation calls inside it recorded)
    span_ms: Dict[str, Optional[float]] = field(default_factory=dict)
    profile: Optional[Profile] = None
    profile_items: int = 0
    agg_calls: List[Dict[str, Any]] = field(default_factory=list)
    # traced runs, with the port's tracer on from the window's start to the
    # end of the profiled items: its span records (profiling.Span), and
    # each window item's host ms, end to end
    spans: List[Any] = field(default_factory=list)
    item_ms: List[float] = field(default_factory=list)
    # from the cell's data: FLOPs of one item, counted on the reference
    flops_per_item: Optional[float] = None

    def per_item_s(self) -> Optional[float]:
        """Host seconds per item of the window."""
        return self.window_s / self.items if self.items else None
