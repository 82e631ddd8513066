"""One run of one cell: set-up, the window, the comparison, the result.

The result is one JSON line, the last line of standard output:
correct, attempted, failed, metrics (the cell's end-to-end metrics, or
with --trace 1 its per-layer metrics, each as read by
benchmark/metrics/<name>.py), device, with --trace 1 breakdown,
`samples` (the items each metric with a samples() reader was read from,
as a percentile's), and last `checks`: each compared number with its
limit. The samples and then the compared numbers are also the last lines
of standard error.
"""
from __future__ import annotations

import gc
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

from . import guard, spec, systems

EXIT_NO_CARD, EXIT_FORBIDDEN = 3, 4


def cache_dirs(root: Path) -> None:
    """Kernel caches inside the checkout, at fixed paths."""
    base = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")


def card_ok(chips: int) -> Optional[str]:
    if not torch.cuda.is_available():
        return "no CUDA device"
    if torch.cuda.device_count() < chips:
        return f"{torch.cuda.device_count()} CUDA devices, the cell needs {chips}"
    return None


def device_info(rec, chips: int, device: torch.device) -> Dict[str, Any]:
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": chips, "memory_peak_bytes": int(rec.peak_bytes)}
    if rec.profile is not None:
        info["busy_s"] = rec.profile.busy_s
        info["window_s"] = rec.profile.window_s
    return info


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, Any]]:
    """Each limited number beside its limit; a number the run could not
    read (or read as not finite) is None."""
    def val(k):
        v = numbers.get(k)
        return v if v is not None and math.isfinite(v) else None
    return {k: {"value": val(k), "limit": v} for k, v in limits.items()}


def passed(checks: Dict[str, Dict[str, Any]]) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        root: Path = spec.ROOT, device: str = "cuda", need_card: bool = True,
        system: Callable[[], systems.System] = systems.port, fault: Optional[str] = None,
        out=sys.stdout, err=sys.stderr) -> int:
    cell = spec.load_cell(workload, root)
    if need_card:
        why = card_ok(cell.chips)
        if why:
            print(f"benchmark: {why}; no result", file=err)
            return EXIT_NO_CARD
    cache_dirs(root)
    dev = torch.device(device)
    drv_mod = cell.driver()
    drv = drv_mod.Driver(cell, system(), dev, fault=fault)
    drv.prepare(seed)
    setup_s = time.perf_counter() - t_start
    rec, cap, done = drv.window(seconds, trace)
    rec.setup_s = setup_s
    rec.flops_per_item = cell.data.get("flops_per_item")
    failed = drv.failed(done)
    plan = drv.s.plan
    drv.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = drv.check(seed, cap, done,
                        lambda: drv_mod.Driver(cell, systems.reference(), dev, plan))
    checks = judge(numbers, cell.data["limits"])
    metrics, samples = {}, {}
    for m in cell.metrics(trace):
        reader = spec.metric_module(m["name"], cell.bench_dir)
        v = reader.read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            if hasattr(reader, "samples"):
                samples[m["name"]] = reader.samples(rec)
    result: Dict[str, Any] = {
        "correct": passed(checks) and failed == 0 and rec.items > 0,
        "attempted": rec.items, "failed": failed, "metrics": metrics,
        "device": device_info(rec, cell.chips, dev)}
    if rec.profile is not None:
        result["breakdown"] = {"device_ops": [list(x) for x in rec.profile.top_ops()],
                               "idle_gaps": [list(x) for x in rec.profile.idle_by_host]}
    if samples:
        result["samples"] = samples
    result["checks"] = checks
    found = guard.loaded_forbidden()
    if found:
        print(f"benchmark: the run loaded {found}; no result", file=err)
        return EXIT_FORBIDDEN
    for k, n in samples.items():
        print(f"samples {k} {n!r}", file=err)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0
