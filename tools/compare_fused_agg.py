#!/usr/bin/env python3
"""Time the fused-aggregation kernel of two checkouts on one card, in turns.

    python3 tools/compare_fused_agg.py OTHER_CHECKOUT [--tiles] [--pairs N]
                                       [--dtype both|f32|bf16] [--out FILE]
                                       [--shapes N:K,N:K,...]

Runs N pairs of turns, other then this, then this then other, and so on
(N=2: other, this, this, other): each turn is a fresh process that imports
the port from its checkout (building its kernel there), makes the same
seeded inputs with that checkout's chip_smoke.agg_inputs (agg_inputs_bf16
for the bf16 instantiation) and prints the device time of one
fused_agg.launch at its default tile, in f32 and in bf16, at the query
shapes (N=1024 with K=8 and K=1), the refinement shape (N=32768, K=8), the
train shape (N=65536, K=8) and the render shape (N=262144, K=8), with CUDA
events behind a sleep kernel (chip_smoke.device_ms). --tiles adds every
bf16 tile the checkout offers (fused_agg.tile_options, by rows) at the
query shapes, and every bf16 wgmma tile at the three K=8 step shapes, so
that the query plan's tiles (by rows: a checkout's 16-row tile may be a
cluster of CTAs in one and a single CTA in the other) are timed side by
side. --shapes replaces the shapes by the given (N, K) pairs (50 timed
launches each), all of them query-sized for --tiles.
Prints each key's speed-up and whether
this checkout is slower beyond the spread: with two turns each the larger
difference between one checkout's two turns, with more twice the standard
error of the paired differences. Prints the card's name and power limit.
Unpack the other commit with `git archive <commit> | tar -x -C <dir>` into
a directory that .gitignore lists.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((1024, 8, 50), (1024, 1, 50), (32768, 8, 20), (65536, 8, 10),
          (262144, 8, 3))   # N, K, timed launches

TURN = """
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from nerfloc_tpu_torch.ops import fused_agg as fa
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
shapes, dtypes, tiles = %r, %r, %r
out = {}
for N, K, iters in shapes:
    x = cs.agg_inputs(N, K, 195, 128, seed=N + K, dev=dev)
    for name, xi in (("f32", x), ("bf16", cs.agg_inputs_bf16(x))):
        if name not in dtypes:
            continue
        with torch.no_grad():
            out["%%s %%dx%%d" %% (name, N, K)] = cs.device_ms(lambda: fa.launch(**xi),
                                                             iters=iters)
            if name != "bf16" or not tiles:
                continue
            for rows in (r for r in fa.tile_options(K, bf16=True)
                         if N < 32768 or r >= fa.WGMMA_ROWS):
                key = "bf16 %%dx%%d rows=%%d" %% (N, K, rows)
                out[key] = cs.device_ms(lambda: fa.launch(**xi, rows=rows), iters=iters)
    del x
print("TURN " + json.dumps(out))
"""


def turn(checkout: str, shapes, dtypes, tiles: bool) -> dict:
    proc = subprocess.run([sys.executable, "-c", TURN % (shapes, dtypes, tiles)], cwd=checkout,
                          capture_output=True, text=True, timeout=900)
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")), None)
    if proc.returncode or line is None:
        raise RuntimeError(f"turn in {checkout} failed:\n{proc.stdout}\n{proc.stderr}")
    return json.loads(line[5:])


def spread_of(a: list, b: list) -> float:
    if len(a) == 2:
        return max(abs(a[0] - a[1]), abs(b[0] - b[1]))
    d = [y - x for x, y in zip(a, b)]
    return 2 * statistics.stdev(d) / math.sqrt(len(d))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--tiles", action="store_true",
                    help="also every bf16 tile at the query shapes and every bf16 wgmma "
                         "tile at the K=8 step shapes")
    ap.add_argument("--pairs", type=int, default=2, help="pairs of turns (at least 2)")
    ap.add_argument("--dtype", choices=("both", "f32", "bf16"), default="both")
    ap.add_argument("--out", default="")
    ap.add_argument("--shapes", default="",
                    help="comma-separated N:K pairs to time instead of the default shapes")
    args = ap.parse_args()
    if args.pairs < 2:
        ap.error("--pairs must be at least 2")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    card = cs.card_line()
    other = os.path.abspath(args.other)
    dtypes = ("f32", "bf16") if args.dtype == "both" else (args.dtype,)
    shapes = SHAPES
    if args.shapes:
        shapes = tuple((int(n), int(k), 50) for n, k in
                       (pair.split(":") for pair in args.shapes.split(",")))
    runs = {"other": [], "this": []}
    for i in range(args.pairs):
        for name in (("other", "this") if i % 2 == 0 else ("this", "other")):
            runs[name].append(turn(other if name == "other" else ROOT, shapes, dtypes,
                                    args.tiles))
            print(f"{name}: {runs[name][-1]}", flush=True)
    print(f"fused_agg kernel ms, other = {other}, this = {ROOT}; {card}")
    summary = {}
    for key in sorted(set(runs["this"][0]) | set(runs["other"][0])):
        a = [r[key] for r in runs["other"] if key in r]
        b = [r[key] for r in runs["this"] if key in r]
        if not a or not b:
            summary[key] = {"other_ms": a, "this_ms": b}
            print(f"  {key}: other {' / '.join(f'{v:.4f}' for v in a) or '-'}, "
                  f"this {' / '.join(f'{v:.4f}' for v in b) or '-'}")
            continue
        spread = spread_of(a, b)
        slower = statistics.mean(b) - statistics.mean(a) > spread
        summary[key] = {"other_ms": a, "this_ms": b, "spread_ms": spread,
                        "speedup": statistics.mean(a) / statistics.mean(b),
                        "slower_beyond_spread": slower}
        print(f"  {key}: other {' / '.join(f'{v:.4f}' for v in a)}, "
              f"this {' / '.join(f'{v:.4f}' for v in b)}, "
              f"speed-up {summary[key]['speedup']:.3f}x, spread {spread:.4f} ms"
              f"{', SLOWER beyond the spread' if slower else ''}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, **summary}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
