#!/usr/bin/env python3
"""Count the FLOPs of one item of a cell (a query, or a train step with
its backward) on the frozen reference at the cell's shapes, with
torch.utils.flop_counter.FlopCounterMode, and write them into
benchmark/cells/<cell>.json as `flops_per_item` (what mfu divides).

    python3 benchmark/tools/count_flops.py --workload <cell> [--seed 1] [--write]

The count is of the reference, so no change to the port moves it; it
does not depend on the seed (the shapes are fixed).
"""
import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]


def count(cell, seed: int, device) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    from harness import systems
    drv = cell.driver().Driver(cell, systems.reference(), device)
    drv.prepare(seed)
    with FlopCounterMode(display=False) as fc:
        if drv.KIND == "query":
            drv.query(0)
        else:
            drv.train_step(0)
    return int(fc.get_total_flops())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--write", action="store_true")
    a = ap.parse_args(argv)
    import torch
    from harness import spec
    cell = spec.load_cell(a.workload)
    flops = count(cell, a.seed, torch.device(a.device))
    print(json.dumps({"workload": a.workload, "flops_per_item": flops}))
    if a.write:
        path = cell.bench_dir / "cells" / f"{a.workload}.json"
        data = json.loads(path.read_text())
        data["flops_per_item"] = flops
        path.write_text(json.dumps(data, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
