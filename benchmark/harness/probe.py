"""Instruments set around the port's layers from outside, by replacing the
names the port looks them up by, and undone afterwards.

- `Spans`: CUDA events (and a profiler range) around each call of a layer
  function, by layer name, tagged with the item (query or step) the call
  served. Only in traced runs.
- `AggShapes`: the shapes of each fused aggregation call (at the Python
  entry the model calls, `conditional_nerf.fused_neighbor_agg`), while a
  profiler window is open.
- `Capture`: references to what a layer returned (no copy, no wait), kept
  for the comparison with the reference after the window.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch


class Patches:
    """setattr with undo."""

    def __init__(self):
        self._undo: List[Tuple[Any, str, Any, bool]] = []

    def replace(self, owner, attr: str, make: Callable[[Callable], Callable]) -> None:
        old = getattr(owner, attr)
        had = attr in vars(owner)
        self._undo.append((owner, attr, vars(owner).get(attr), had))
        setattr(owner, attr, make(old))

    def undo(self) -> None:
        for owner, attr, old, had in reversed(self._undo):
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)
        self._undo.clear()


class Spans:
    """Device time of layer calls by CUDA events, per item."""

    def __init__(self, patches: Patches):
        self.patches = patches
        self.item = -1
        self.events: Dict[str, List[Tuple[int, Any, Any]]] = defaultdict(list)
        self.marks: Dict[str, List[Tuple[int, Any]]] = defaultdict(list)

    def wrap(self, owner, attr: str, layer: str) -> None:
        def make(fn):
            def run(*a, **kw):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                with torch.profiler.record_function(f"span:{layer}"):
                    start.record()
                    out = fn(*a, **kw)
                    end.record()
                self.events[layer].append((self.item, start, end))
                return out
            return run
        self.patches.replace(owner, attr, make)

    def mark_end(self, owner, attr: str, name: str) -> None:
        """An event at the end of each call of owner.attr (no range)."""
        def make(fn):
            def run(*a, **kw):
                out = fn(*a, **kw)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.marks[name].append((self.item, ev))
                return out
            return run
        self.patches.replace(owner, attr, make)

    def per_item_ms(self, layer: str, items) -> Optional[float]:
        """Mean over `items` of the summed device ms of the layer's calls in
        each item (after torch.cuda.synchronize())."""
        items = set(items)
        per: Dict[int, float] = defaultdict(float)
        for i, s, e in self.events.get(layer, []):
            if i in items:
                per[i] += s.elapsed_time(e)
        return sum(per.values()) / len(items) if per and items else None

    def between_ms(self, start_layer: str, end_mark: str, items) -> Optional[float]:
        """Mean over `items` of the ms from the end of the last call of
        `start_layer` to the last `end_mark` event of each item."""
        items = set(items)
        ends = {i: e for i, _, e in self.events.get(start_layer, []) if i in items}
        marks = {i: m for i, m in self.marks.get(end_mark, []) if i in items}
        both = [i for i in ends if i in marks]
        if not both:
            return None
        return sum(ends[i].elapsed_time(marks[i]) for i in both) / len(both)


class AggShapes:
    """The shapes of each fused aggregation call while `on`."""

    def __init__(self, patches: Patches, module) -> None:
        self.on = False
        self.calls: List[Dict[str, Any]] = []

        def make(fn):
            def run(xyz, direction, mv_agg, nb_xyz, nb_dir, nb_feat, scale, params, freqs,
                    *a, **kw):
                if self.on:
                    self.calls.append({
                        "N": xyz.shape[0], "K": nb_xyz.shape[1], "F": nb_feat.shape[-1],
                        "W": mv_agg.shape[-1], "NF": freqs.numel(),
                        "act_bytes": mv_agg.element_size(),
                        "param_shapes": {k: tuple(v.shape) for k, v in params.items()}})
                return fn(xyz, direction, mv_agg, nb_xyz, nb_dir, nb_feat, scale, params,
                          freqs, *a, **kw)
            return run
        patches.replace(module, "fused_neighbor_agg", make)


class Capture:
    """What the wrapped layers returned, by item: {item: {key: value}}.
    While `item` is None, nothing is kept."""

    def __init__(self, patches: Patches):
        self.patches = patches
        self.item: Optional[int] = None
        self.items: Dict[int, Dict[str, Any]] = defaultdict(dict)

    def keep(self, owner, attr: str, take: Callable[[Dict[str, Any], tuple, dict, Any], None]
             ) -> None:
        """After each call of owner.attr, take(record, args, kwargs, out)
        files what it needs into the current item's record."""
        def make(fn):
            def run(*a, **kw):
                out = fn(*a, **kw)
                if self.item is not None:
                    take(self.items[self.item], a, kw, out)
                return out
            return run
        self.patches.replace(owner, attr, make)


def profile_items(rec, patches: Patches, nerf_module, item: Callable[[int], Any]):
    """Run rec.profile_items items under one profiler window, recording the
    shapes of their fused aggregation calls into rec.agg_calls; returns the
    stopped Window (read() it once the timed window is over)."""
    from .profile import Window
    aggs = AggShapes(patches, nerf_module)
    Window.warm()
    prof = Window()
    prof.start()
    aggs.on = True
    for k in range(rec.profile_items):
        item(k)
    aggs.on = False
    prof.stop()
    rec.agg_calls = aggs.calls
    return prof
