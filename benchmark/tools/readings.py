#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from: the compared
numbers of a cell on many seeds, for the port (the lower reading), for the
control (the reference in the port's place, one precision below the
configuration's; the upper reading) and for planted faults.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 \
        --modes port,control,ref16,fault:stale --out chiprun_out/readings.jsonl

Each mode builds its model once and runs, per seed, the cell's set-up, a
window of the mix's `sample` queries (or, for training, one step after the
followed warm-up steps), and the comparison with the reference. One JSON
line per (mode, seed).
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated run seeds")
    ap.add_argument("--modes", default="port,control")
    ap.add_argument("--out", default=None)
    ap.add_argument("--root", default=str(HERE.parent))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    import torch
    from harness import runner, spec, systems
    cell = spec.load_cell(a.workload, Path(a.root))
    runner.cache_dirs(Path(a.root))
    dev = torch.device(a.device)
    mod = cell.driver()
    plan = None
    ref = None
    out = open(a.out, "a") if a.out else None
    for mode in a.modes.split(","):
        fault = mode.split(":", 1)[1] if mode.startswith("fault:") else None
        system = {"control": lambda: systems.control(cell.config["dtype"]),
                  "ref16": systems.reference_bf16}.get(mode, systems.port)()
        drv = mod.Driver(cell, system, dev, plan, fault=fault)
        plan = drv.s.plan
        if ref is None:
            ref = mod.Driver(cell, systems.reference(), dev, plan)
        for seed in (int(s) for s in a.seeds.split(",")):
            t0 = time.perf_counter()
            drv.prepare(seed)
            n = int(cell.mix.get("sample", 1))
            rec, cap, done = drv.window(0.0, False, min_items=n)
            numbers = drv.check(seed, cap, done, lambda: ref)
            row = {"workload": a.workload, "mode": mode, "seed": seed, "numbers": numbers,
                   "failed": drv.failed(done), "seconds": time.perf_counter() - t0,
                   "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
            print(json.dumps(row), flush=True)
            if out:
                out.write(json.dumps(row) + "\n")
                out.flush()
        drv.fault_patches.undo()
        del drv
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
