#!/usr/bin/env python3
"""A cell's traced window with the port's tracer on, and the tracer's cost.

    python3 benchmark/tools/trace_spans.py --workload <cell> --seed <n> \
        --seconds 51 --pairs 20 [--out chiprun_out/spans.jsonl]

Runs the cell's set-up, then the tracer's cost: `--pairs` pairs of items,
the port's tracer (nerfloc_tpu_torch/utils/profiling.py) off for one and
on for the other (the same pool item, the order turning each pair), each
item closed by a synchronize (`cost`: host ms of each side), and the host
time of one span off and on, alone (`span_us`). These come before any
profiler window: after one, each launch costs the host more. Then the
cell's traced window (`--trace 1`: the spans the harness patches in and
the port's tracer on, then the profiler over the mix's `profile_items`),
and from that run:

- `spans`: host ms per window item of each span of the port, and its calls
  per item; `span_share`, the window's spans times one span's host time
  with the tracer on, over the window: the tracer's cost;
- `syncs_by_span`: the calls that blocked the host in the profiled items
  (harness/spans.host_syncs), per item, by the innermost span;
- `metrics`: the cell's per-layer metrics as its readers read this run
  (the span readings among them), and `idle_gaps`, the breakdown's, with `unspanned_share`, the part of
  the listed idle seconds that no span names.

Prints one JSON line; --out appends it to a file. Needs a CUDA card.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]


def _item(drv, i: int) -> None:
    """One item of the driver on pool item i, closed by a synchronize."""
    import torch
    if drv.KIND == "query":
        drv.query(i)
    else:
        drv.train_step(i)
    torch.cuda.synchronize()


def _span_us(profiling, on: bool, n: int = 100_000) -> float:
    """Host microseconds of one empty span, the tracer on or off."""
    profiling.enable(on)
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with profiling.span("refine.render"):
            pass
    t1 = time.perf_counter_ns()
    profiling.enable(False)
    profiling.clear()
    return 1e-3 * (t1 - t0) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--pairs", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--root", default=str(HERE.parent))
    a = ap.parse_args(argv)
    import torch
    from harness import runner, spans, spec, systems
    from nerfloc_tpu_torch.utils import profiling
    if not torch.cuda.is_available():
        print("trace_spans: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(a.workload, Path(a.root))
    runner.cache_dirs(Path(a.root))
    drv = cell.driver().Driver(cell, systems.port(), torch.device("cuda"))
    drv.prepare(a.seed)

    # the tracer's cost: pairs of items, off and on, the order turning
    cost = {False: [], True: []}
    for k in range(a.pairs):
        i = (int(drv.mix["warmup"]) + k) % len(drv.pool)
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            profiling.enable(on)
            t0 = time.perf_counter()
            _item(drv, i)
            cost[on].append(1e3 * (time.perf_counter() - t0))
            profiling.enable(False)
            profiling.clear()
    span_us = {"off": _span_us(profiling, False), "on": _span_us(profiling, True)}

    # the window: the driver turns the port's tracer on over it and its
    # profiled items, and keeps the records and the profiled syncs
    rec, _, _ = drv.window(a.seconds, True)
    rec.flops_per_item = cell.data.get("flops_per_item")
    recs, syncs = rec.spans, rec.profile.syncs
    window = range(rec.items)
    names = sorted({r.name for r in recs})
    metrics = {m["name"]: spec.metric_reader(m["name"], cell.bench_dir)(rec)
               for m in cell.per_layer}
    gaps = rec.profile.idle_by_host
    listed = sum(s for _, s in gaps)
    row = {"workload": a.workload, "seed": a.seed, "items": rec.items,
           "window_s": rec.window_s, "profile_items": rec.profile_items,
           "device": torch.cuda.get_device_name(0), "metrics": metrics,
           "spans": {n: {"ms": spans.span_ms(recs, n, window),
                         "calls": sum(r.name == n and r.item in window for r in recs)
                         / max(rec.items, 1)} for n in names},
           "syncs_by_span": {k: v / rec.profile_items for k, v in syncs.items()},
           "span_us": span_us,
           "spans_per_item": sum(r.item in window for r in recs) / max(rec.items, 1),
           "span_share": sum(r.item in window for r in recs) * span_us["on"] * 1e-6
           / rec.window_s,
           "idle_gaps": gaps,
           "unspanned_share": sum(s for k, s in gaps if k.startswith("- |")) / listed
           if listed else None}

    if a.pairs:
        rel = [on / off - 1.0 for off, on in zip(cost[False], cost[True])]
        row["cost"] = {"off_ms": cost[False], "on_ms": cost[True],
                       "off_median_ms": statistics.median(cost[False]),
                       "on_median_ms": statistics.median(cost[True]),
                       "pair_rel_median": statistics.median(rel),
                       "pair_rel_quartiles": statistics.quantiles(rel, n=4)
                       if len(rel) > 1 else rel}
    line = json.dumps(row)
    print(line, flush=True)
    if a.out:
        with open(a.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
