"""The port's tracer: named spans at its layer boundaries.

    with span("refine.render"):
        ...

Off (the default), `span` tests one flag and returns a shared null
context: no profiler range, no event, no synchronize, no allocation. On
(`enable(True)`), a span opens the profiler range "span:<name>", so a
torch.profiler trace shows it on the kernels' clock, and keeps a `Span`
record in memory: its name, the span open around it on its thread, its
item, its thread and its host clock (time.perf_counter_ns) at both ends.
Nothing is written anywhere; `records()` hands the records over and
`clear()` drops them.

The root spans `query` and `step` each take a new item number (from 0
after `clear()`); every span opened until the root closes, on any thread
(the autograd engine's, which runs a backward on CUDA tensors, too),
carries it. The item is the process's current one: queries and steps run
one at a time. Spans outside a root carry item -1.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch

ROOTS = ("query", "step")


class Span(NamedTuple):
    name: str
    parent: Optional[str]     # the span open around it on its thread
    item: int
    thread: int
    start_ns: int
    end_ns: int


_on = False
_NULL = contextlib.nullcontext()
_records: List[Span] = []
_items = itertools.count()
_item = -1
_local = threading.local()     # .open: the names of this thread's open spans


def enable(on: bool) -> None:
    """Turn the spans on or off (records kept so far stay)."""
    global _on
    _on = bool(on)


def records() -> List[Span]:
    """The spans closed since the last clear(), in the order they closed."""
    return list(_records)


def clear() -> None:
    """Drop the records and number the next root's item 0."""
    global _items
    _records.clear()
    _items = itertools.count()


def span(name: str):
    """A context manager around one layer's call (see the module's note)."""
    if not _on:
        return _NULL
    return _span(name)


@contextlib.contextmanager
def _span(name: str):
    global _item
    opened = getattr(_local, "open", None)
    if opened is None:
        opened = _local.open = []
    parent = opened[-1] if opened else None
    root, outer = name in ROOTS, _item
    if root:
        _item = next(_items)
    item = _item
    opened.append(name)
    start = time.perf_counter_ns()
    try:
        with torch.profiler.record_function("span:" + name):
            yield
    finally:
        end = time.perf_counter_ns()
        opened.pop()
        if root:
            _item = outer
        _records.append(Span(name, parent, item, threading.get_ident(), start, end))
