#!/usr/bin/env python3
"""Time the fused-aggregation kernel of two checkouts on one card, in turns.

    python3 tools/compare_fused_agg.py OTHER_CHECKOUT [--out FILE]

Runs other, this, this, other: each turn is a fresh process that imports the
port from its checkout (building its kernel there), makes the same seeded
inputs with that checkout's chip_smoke.agg_inputs and prints the device time
of one fused_agg.launch at the query shapes (N=1024 with K=8 and K=1) and at
the render shape (N=262144, K=8), with CUDA events behind a sleep kernel
(chip_smoke.device_ms). Prints the card's name and power limit. Unpack the
other commit with `git archive <commit> | tar -x -C <dir>` into a directory
that .gitignore lists.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((1024, 8, 50), (1024, 1, 50), (262144, 8, 3))   # N, K, timed launches

TURN = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from nerfloc_tpu_torch.ops import fused_agg as fa
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
out = {}
for N, K, iters in %r:
    x = cs.agg_inputs(N, K, 195, 128, seed=N + K, dev=dev)
    with torch.no_grad():
        out["%%dx%%d" %% (N, K)] = cs.device_ms(lambda: fa.launch(**x), iters=iters)
    del x
print("TURN " + json.dumps(out))
"""


def turn(checkout: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", TURN % (SHAPES,)], cwd=checkout,
                          capture_output=True, text=True, timeout=900)
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")), None)
    if proc.returncode or line is None:
        raise RuntimeError(f"turn in {checkout} failed:\n{proc.stdout}\n{proc.stderr}")
    return json.loads(line[5:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    card = cs.card_line()
    other = os.path.abspath(args.other)
    order = [("other", other), ("this", ROOT), ("this", ROOT), ("other", other)]
    runs = {"other": [], "this": []}
    for name, path in order:
        runs[name].append(turn(path))
        print(f"{name}: {runs[name][-1]}", flush=True)
    print(f"fused_agg kernel ms, other = {other}, this = {ROOT}; {card}")
    summary = {}
    for key in runs["this"][0]:
        a = [r[key] for r in runs["other"]]
        b = [r[key] for r in runs["this"]]
        summary[key] = {"other_ms": a, "this_ms": b,
                        "speedup": statistics.mean(a) / statistics.mean(b)}
        print(f"  {key}: other {a[0]:.4f} / {a[1]:.4f}, this {b[0]:.4f} / {b[1]:.4f}, "
              f"speed-up {summary[key]['speedup']:.2f}x")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, **summary}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
