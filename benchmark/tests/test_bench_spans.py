"""The readings of the port's own spans (harness/spans.py) on synthetic
records and traces, how the breakdown names a gap inside a program span,
and on the card, three host reads inside a program span counted as three
syncs."""
import json
from collections import namedtuple

import pytest
import torch

from harness.profile import reduce_trace
from harness.spans import blocks_host, host_syncs, span_ms


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_blocking_calls_by_name():
    for name in ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
                 "cuStreamSynchronize", "cudaMemcpy", "cuMemcpyDtoH_v2"):
        assert blocks_host(name), name
    for name in ("cudaMemcpyAsync", "cuMemcpyHtoDAsync_v2", "cudaLaunchKernel",
                 "cudaEventRecord", "cudaStreamWaitEvent"):
        assert not blocks_host(name), name


def test_syncs_count_inside_the_root_spans_only():
    evs = [_ev("user_annotation", "span:query", 0, 1000),
           _ev("user_annotation", "span:step", 2000, 1000),
           _ev("user_annotation", "span:refine", 100, 400),        # not a root
           _ev("cuda_runtime", "cudaStreamSynchronize", 150, 5),    # in the refine
           _ev("cuda_runtime", "cudaMemcpyAsync", 200, 5),          # does not block
           _ev("cuda_runtime", "cudaMemcpy", 600, 5),               # in the query
           _ev("cuda_runtime", "cudaLaunchKernel", 400, 5),
           _ev("cuda_runtime", "cudaDeviceSynchronize", 1500, 5),   # between the roots
           _ev("cuda_driver", "cuStreamSynchronize", 2500, 5),      # in the step
           _ev("cuda_runtime", "cudaStreamSynchronize", 3500, 5),   # after: the driver's read
           _ev("cpu_op", "aten::item", 160, 5)]
    assert host_syncs(evs) == {"span:query": 1, "span:refine": 1, "span:step": 1}
    assert host_syncs([e for e in evs if not e["name"].startswith("span:")]) == {}


def test_program_spans_inside_a_benchmark_span_name_the_gap():
    """The harness's span:refine holds the port's span:refine.render and
    span:refine.grad: a gap is named by the innermost span over its middle."""
    evs = [_ev("kernel", "k", 0, 100), _ev("kernel", "k", 300, 100),
           _ev("kernel", "k", 900, 100),
           _ev("user_annotation", "span:refine", 0, 1000),
           _ev("user_annotation", "span:refine.render", 50, 300),
           _ev("user_annotation", "span:refine.grad", 400, 550),
           _ev("user_annotation", "span:fused_agg.replay", 500, 300),
           _ev("cpu_op", "aten::mm", 120, 160)]
    p = reduce_trace(evs, window_s=0.001)
    assert dict(p.idle_by_host) == {"span:refine.render | aten::mm": pytest.approx(200e-6),
                                    "span:fused_agg.replay | python": pytest.approx(500e-6)}


Span = namedtuple("Span", "name parent item thread start_ns end_ns")


def test_span_ms_per_item():
    recs = [Span("refine.render", "refine", 0, 1, 0, 2_000_000),
            Span("refine.render", "refine", 0, 1, 3_000_000, 4_000_000),
            Span("refine.render", "refine", 1, 1, 0, 3_000_000),
            Span("refine.render", "refine", 2, 1, 0, 9_000_000),     # outside the items
            Span("fused_agg.replay", None, 1, 2, 0, 500_000)]
    assert span_ms(recs, "refine.render", range(2)) == pytest.approx(3.0)
    assert span_ms(recs, "fused_agg.replay", range(2)) == pytest.approx(0.25)
    assert span_ms(recs, "refine.grad", range(2)) is None
    assert span_ms([], "refine.render", range(2)) is None


@pytest.mark.cuda
def test_three_host_reads_in_a_program_span_are_three_syncs(card, tmp_path):
    from nerfloc_tpu_torch.utils import profiling
    x = torch.ones(1024, device="cuda")
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    profiling.enable(True)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with profiling.span("query"):
                for _ in range(3):
                    (x * 2).sum().item()
            torch.cuda.synchronize()              # outside the root: not counted
            x.sum().item()
    finally:
        profiling.enable(False)
        profiling.clear()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert host_syncs(events) == {"span:query": 3}
    blocking = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and blocks_host(e.get("name", ""))]
    assert len(blocking) >= 5


def _query_record(**kw):
    from harness.record import Record
    return Record(kind="query", trace=True, **kw)


def test_program_span_readers_on_records():
    from harness import readers
    recs = [Span("query", None, 0, 1, 0, 100_000_000),
            Span("localize.context", "localize", 0, 1, 0, 30_000_000),
            Span("localize.context", "localize", 1, 1, 0, 40_000_000),
            Span("pnp", "query", 1, 1, 0, 20_000_000),
            Span("localize.context", "localize", 2, 1, 0, 90_000_000)]   # a profiled item
    r = _query_record(items=2, spans=recs)
    assert readers.program_span_ms(r, "query", "localize.context") == pytest.approx(35.0)
    assert readers.program_span_ms(r, "query", "query") == pytest.approx(50.0)
    assert readers.program_span_ms(r, "query", "pnp") == pytest.approx(10.0)
    assert readers.program_span_ms(r, "query", "localize.match") is None
    assert readers.program_span_ms(r, "train", "pnp") is None
    r.trace = False
    assert readers.program_span_ms(r, "query", "pnp") is None


def test_host_syncs_reader_per_profiled_item():
    from harness import readers
    from harness.profile import Profile
    p = Profile(window_s=1.0, busy_s=0.5, kernels=[],
                syncs={"span:query": 4, "span:pnp": 11})
    recs = [Span("query", None, 0, 1, 0, 1)]
    r = _query_record(items=5, spans=recs, profile=p, profile_items=3)
    assert readers.host_syncs(r, "query") == pytest.approx(5.0)
    assert readers.host_syncs(r, "train") is None
    p.syncs = {}
    assert readers.host_syncs(r, "query") == 0.0         # a count: none is 0
    r.spans = []
    assert readers.host_syncs(r, "query") is None        # the tracer was off


def test_reduce_trace_keeps_the_syncs():
    evs = [_ev("user_annotation", "span:query", 0, 1000),
           _ev("user_annotation", "span:pnp", 100, 300),
           _ev("cuda_runtime", "cudaStreamSynchronize", 150, 5),
           _ev("cuda_runtime", "cudaMemcpy", 600, 5),
           _ev("kernel", "k", 0, 10)]
    assert reduce_trace(evs, window_s=0.001).syncs == {"span:pnp": 1, "span:query": 1}


@pytest.mark.parametrize("n,want", [(200, 190.0), (399, 380.0), (1000, 950.0), (199, None)])
def test_query_p95_on_records(n, want):
    """Nearest rank of the window's per-query host ms; under 200 queries
    fewer than 10 lie beyond the 95th percentile, and nothing is read."""
    import importlib.util
    from conftest import BENCH
    path = BENCH / "metrics" / "query_p95_ms.localize.py"
    spec = importlib.util.spec_from_file_location("p95", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ms = [float(v) for v in range(n, 0, -1)]             # 1..n ms, in any order
    r = _query_record(items=n, item_ms=ms)
    assert mod.read(r) == want
    assert mod.samples(r) == n
    r.trace = False
    assert mod.read(r) is None
