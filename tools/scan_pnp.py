#!/usr/bin/env python3
"""RANSAC PnP on the card: ransac_pnp's CUDA route (the torch route
replayed from two CUDA graphs around its SVD) against the torch route op by
op (the benchmark's frozen reference).

    python3 tools/scan_pnp.py --seeds 8 --first-seed 5000000001 \
        [--out pnp_scan.json]

1. Memory at the query's shape (N=1024 matches, 512 hypotheses), before
   any other work in the process: what each route adds to the allocated
   bytes during a call (`peak_mib`) and after it (`kept_mib`), and to the
   reserved bytes after it and torch.cuda.empty_cache() (`reserved_mib`):
   the CUDA graphs' private pools, which hold the captured intermediates
   and the capture stream's cuBLAS workspace, count only there.
2. The scan: for each seed, the 7scenes.localize cell's set-up (weights,
   the pool of queries and their noise from the seed), then each pool
   query's matches with both of its RANSAC noises (pnp_gumbel, pnp2_gumbel)
   solved by ransac_pnp and by the reference, as the cell's pnp_gap
   compares them: whether every output is equal bit for bit
   (`route_equal`) and the largest [R | t] difference.
3. Timing on the cell's first query: a call of ransac_pnp and of the
   reference on the same CUDA tensors, each closed by a synchronize
   (`call_ms`, `torch_ms`), the reference on the CPU (`torch_cpu_ms`), the
   kernels each launches per call (profiler), and where each one's host
   syncs come from (`torch.cuda.set_sync_debug_mode("warn")`, by Python
   line).

Prints one JSON line; --out writes it. Needs a CUDA card, but for a
rehearsal on the CPU at tiny widths (`--device cpu --root <a checkout made
by benchmark/tests/conftest.make_root> --workload tiny-7scenes.localize`),
which runs the scan alone.
"""
import argparse
import importlib
import json
import statistics
import sys
import time
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]


def _launches(fn) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type.name == "CUDA"
               and not e.name.startswith("Memcpy") and not e.name.startswith("Memset"))


def _sync_sources(fn) -> dict:
    """The Python lines under which fn's host syncs fire, with counts."""
    import linecache
    import torch
    where: Counter = Counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for w in caught:
        line = linecache.getline(w.filename, w.lineno).strip()
        where[f"{Path(w.filename).name}:{w.lineno}: {line}"] += 1
    return dict(where)


def _memory(pnp, ref_pnp, systems, dev) -> dict:
    """Phase 1 (the module's docstring), on a synthetic match set."""
    import torch
    g = torch.Generator(device=dev).manual_seed(0)
    N, H = 1024, 512
    pts2d = torch.rand((N, 2), generator=g, device=dev) * 300
    pts3d = torch.rand((N, 3), generator=g, device=dev) * 4
    mask = torch.rand((N,), generator=g, device=dev) > 0.5
    K = torch.tensor([[280.0, 0, 176], [0, 281, 128], [0, 0, 1]], device=dev)
    gumbel = pnp.gumbel_noise((H, N), g, dev)
    routes = {"torch": lambda: ref_pnp.ransac_pnp(pts2d, pts3d, mask, K, gumbel=gumbel),
              "routed": lambda: pnp.ransac_pnp(pts2d, pts3d, mask, K, gumbel=gumbel)}
    out = {}
    for name in ("torch", "routed", "routed"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base, base_r = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        with systems.exact_f32():
            res = routes[name]()
        torch.cuda.synchronize()
        del res
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        out.setdefault(name, []).append(
            {"peak_mib": (peak - base) / 2**20,
             "kept_mib": (torch.cuda.memory_allocated() - base) / 2**20,
             "reserved_mib": (torch.cuda.memory_reserved() - base_r) / 2**20})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--first-seed", type=int, default=5000000001)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--workload", default="7scenes.localize")
    a = ap.parse_args(argv)

    import torch
    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("scan_pnp: no CUDA device", file=sys.stderr)
        return 2
    from harness import spec, systems
    from nerfloc_tpu_torch.solve import pnp

    out = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"}
    ref_pnp = importlib.import_module(f"{systems.REFERENCE}.solve.pnp")
    cell = spec.load_cell(a.workload, Path(a.root))
    if dev.type == "cuda":
        out["memory"] = _memory(pnp, ref_pnp, systems, dev)
    drv = cell.driver().Driver(cell, systems.port(), dev)
    step_mod = drv.s.system.mods["step"]
    calls = []

    def keep(fn):
        def run(*args, **kw):
            calls.append((args, kw))
            return fn(*args, **kw)
        return run

    orig = step_mod.ransac_pnp
    scan, firsts = [], None
    for k in range(a.seeds):
        seed = a.first_seed + k
        drv.prepare(seed)
        for i in range(len(drv.pool)):
            calls.clear()
            step_mod.ransac_pnp = keep(orig)
            try:
                drv.query(i)
            finally:
                step_mod.ransac_pnp = orig
            (args, kw), = calls
            args = args[:4]
            if firsts is None:
                firsts = (args, kw)
                out["layout"] = [(str(x.dtype), tuple(x.shape), x.stride()) for x in args]
            thresh = kw["thresh_px"]
            for name in ("pnp_gumbel", "pnp2_gumbel"):
                g = drv.noise[i][name]
                routed = pnp.ransac_pnp(*args, gumbel=g, thresh_px=thresh)
                with systems.exact_f32():
                    want = ref_pnp.ransac_pnp(*args, thresh_px=thresh, gumbel=g)
                scan.append({
                    "seed": seed, "item": i, "noise": name, "matches": int(args[2].sum()),
                    "route_equal": all(torch.equal(x, y) for x, y in zip(routed, want)),
                    "route_gap": float((routed.c2w[:3] - want.c2w[:3]).abs().max()),
                })
    out["scan"] = {"calls": len(scan),
                   "route_unequal": sum(not s["route_equal"] for s in scan),
                   "route_gap_max": max(s["route_gap"] for s in scan),
                   "items": scan}
    if dev.type == "cuda":
        _time(out, drv, firsts, pnp, ref_pnp, systems)
    print(json.dumps({k: v for k, v in out.items() if k != "scan"}))
    print(json.dumps({k: v for k, v in out["scan"].items() if k != "items"}))
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(out) + "\n")
    return 0


def _time(out, drv, firsts, pnp, ref_pnp, systems) -> None:
    """Phase 3 (the module's docstring) into out."""
    import torch
    args, kw = firsts
    g = drv.noise[0]["pnp_gumbel"]
    thresh = kw["thresh_px"]

    def routed():
        return pnp.ransac_pnp(*args, gumbel=g, thresh_px=thresh)

    def torch_route():
        with systems.exact_f32():
            return ref_pnp.ransac_pnp(*args, thresh_px=thresh, gumbel=g)
    for _ in range(5):
        routed()
        torch_route()

    def host_ms(fn, n):
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t))
        return statistics.median(ts)
    out["call_ms"] = host_ms(routed, 50)
    out["torch_ms"] = host_ms(torch_route, 20)
    cpu = [x.cpu() for x in args]
    out["torch_cpu_ms"] = host_ms(lambda: ref_pnp.ransac_pnp(*cpu, thresh_px=thresh,
                                                               gumbel=g.cpu()), 5)
    out["launches"] = {"routed": _launches(routed), "torch": _launches(torch_route)}
    out["syncs"] = {"torch": _sync_sources(torch_route), "routed": _sync_sources(routed)}


if __name__ == "__main__":
    sys.exit(main())
