"""The default query's cell (`7scenes.localize`): found by name, its mix
bypassing the cascade and refinement, the drivers' switch of the port's
tracer (off with no record in an untraced window, on over a traced
window's items and its profiled ones), and a capture for the comparison
that does not grow with the window's queries."""
import time
from collections import Counter
from types import SimpleNamespace

import pytest
import torch

from conftest import make_root
from harness import probe, readers, spec, systems
from harness.profile import Profile
from harness.record import Record
from harness.spans import recording
from nerfloc_tpu_torch.utils import profiling

CELL = "7scenes.localize"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return make_root(tmp_path_factory.mktemp("bench"))


def test_localize_cell_resolves():
    c = spec.load_cell(CELL)
    assert (c.config_name, c.mix_name, c.chips) == ("7scenes", "localize", 1)
    assert c.config["frame"] == [256, 352] and c.mix["views"] == "n_views_test"
    assert c.mix["config"] == {"cascade_matching": False, "optimize_pose": False}
    assert c.mix["probe_spans"] == []          # its metrics read the port's spans alone
    assert c.driver().Driver.KIND == "query"
    assert set(c.data["limits"]) == {"kp_missed", "score_gap", "match_wrong", "pnp_gap"}
    assert c.data["flops_per_item"] > 0
    assert {m["name"] for m in c.end_to_end} == {"query_ms", "peak_mem_gib", "setup_s"}
    assert all(m["moves"] == "query_ms" for m in c.per_layer)
    assert {m["name"] for m in c.per_layer} == {
        "localize_ms.localize", "context_ms.localize",
        "keypoints_ms.localize", "match_ms.localize", "pnp_ms.localize", "host_syncs.localize",
        "query_p95_ms.localize", "idle_share.localize", "launches.localize", "mfu.localize",
        "fused_agg_roofline.localize"}


def _driver(root, cell, system=systems.port):
    c = spec.load_cell(f"tiny-{cell}", root)
    drv = c.driver().Driver(c, system(), torch.device("cpu"))
    drv.prepare(20260301)
    return drv


def _count(drv, patches):
    calls = Counter()

    def counted(name):
        def make(fn):
            def run(*a, **kw):
                calls[name] += 1
                return fn(*a, **kw)
            return run
        return make
    patches.replace(drv.s.system.mods["step"], "refine_pose", counted("refine_pose"))
    patches.replace(drv.s.model, "match_cascade", counted("match_cascade"))
    return calls


@pytest.mark.parametrize("cell,refines", [(CELL, False), ("7scenes.refine_query", True)])
def test_the_localize_mix_bypasses_cascade_and_refinement(root, cell, refines):
    drv = _driver(root, cell)
    patches = probe.Patches()
    calls = _count(drv, patches)
    try:
        for i in range(2):
            pose = drv.query(i)
            assert bool(torch.isfinite(pose).all())
    finally:
        patches.undo()
    want = 2 if refines else 0
    assert calls == Counter({"refine_pose": want, "match_cascade": want} if refines else {})


def test_untraced_window_leaves_the_tracer_off(root):
    drv = _driver(root, CELL)
    seen = []
    patches = probe.Patches()
    patches.replace(drv.s.model, "localize_parts", lambda fn: (
        lambda *a, **kw: (seen.append(profiling._on), fn(*a, **kw))[1]))
    profiling.clear()
    try:
        rec, _, done = drv.window(0.0, False, min_items=2)
    finally:
        patches.undo()
    assert len(done) == 2 and seen == [False, False]
    assert profiling.records() == [] and rec.spans == [] and rec.item_ms == []


def test_recording_is_the_ports_alone():
    rec = Record(kind="query", trace=True)
    with recording(systems.reference(), rec, True):
        assert not profiling._on
    with recording(systems.port(), rec, False):
        assert not profiling._on
    assert rec.spans == []
    with recording(systems.port(), rec, True):
        assert profiling._on
        with profiling.span("query"):
            pass
    assert not profiling._on and profiling.records() == []
    assert [(s.name, s.item) for s in rec.spans] == [("query", 0)]


class _Event:
    """torch.cuda.Event on the host clock, for the harness's own spans."""

    def __init__(self, enable_timing=False):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


def test_traced_window_records_the_ports_spans(root, monkeypatch):
    """A traced window of the localize mix, its profiler window replaced by
    the profiled items alone: the port's spans of every window query and
    profiled query, numbered in turn, no cascade or refinement span, each
    window query's host ms, and the readers read them."""
    def items_alone(rec, patches, nerf, item):
        for k in range(rec.profile_items):
            item(k)
        return SimpleNamespace(read=lambda: Profile(window_s=1.0, busy_s=0.5, kernels=[],
                                                    syncs={"span:pnp": 6}))
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(probe, "profile_items", items_alone)
    drv = _driver(root, CELL)
    rec, _, done = drv.window(0.0, True, min_items=3)
    n, prof = rec.items, rec.profile_items
    assert n == len(done) == 3 and prof == 3 and not profiling._on
    queries = sorted(s.item for s in rec.spans if s.name == "query")
    assert queries == list(range(n + prof))
    names = {s.name for s in rec.spans}
    assert {"localize", "localize.context", "localize.keypoints", "localize.match",
            "pnp"} <= names and not names & {"cascade", "refine", "refine.render"}
    assert len(rec.item_ms) == n and all(v > 0 for v in rec.item_ms)
    assert sum(rec.item_ms) == pytest.approx(1e3 * rec.window_s, rel=0.05)
    assert rec.span_ms == {}                   # no CUDA-event span of the harness
    for name in ("localize", "localize.context", "localize.keypoints", "localize.match", "pnp"):
        assert readers.program_span_ms(rec, "query", name) > 0
    assert readers.host_syncs(rec, "query") == pytest.approx(2.0)
    assert readers.item_quantile_ms(rec, "query", 0.95) is None    # 3 queries


@pytest.mark.parametrize("cell", [CELL, "7scenes.refine_query"])
def test_capture_keeps_the_first_pass_over_the_pool(root, cell):
    """A window of twice the pool's queries keeps the comparison's inputs of
    the first pass alone, which hold every sampled item; the comparison
    still reads every number of the cell."""
    from harness import query_check
    drv = _driver(root, cell)
    pool = len(drv.pool)
    rec, cap, done = drv.window(0.0, False, min_items=2 * pool)
    assert len(done) == 2 * pool
    assert sorted(cap.items) == list(range(pool))
    picked = query_check.sample_items(20260301, done, int(drv.mix["sample"]))
    assert picked and all(k < pool for k, _ in picked)
    ref = spec.load_cell(f"tiny-{cell}", root)
    drv.release()
    numbers = drv.check(20260301, cap, done,
                        lambda: ref.driver().Driver(ref, systems.reference(), torch.device("cpu")))
    assert set(numbers) == set(ref.data["limits"])
