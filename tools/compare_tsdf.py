#!/usr/bin/env python3
"""Time the TSDF integration kernel of two checkouts on one card, in turns.

    python3 tools/compare_tsdf.py OTHER_CHECKOUT [--pairs N] [--out FILE]

Writes chip_smoke.py's phase-18 scene once (a raw 7-Scenes-layout scene at
640x480, seeded: data.synthetic.write_seven_scenes_raw), then runs N pairs
of turns, other then this, then this then other, and so on: each turn is a
fresh process that imports the port from its checkout (building its
kernels there), preprocesses the scene on the card with its own
preprocess.seven_scenes (chip_smoke._preprocess_seven_scenes, which
records the 16 fused frames), and times one native.tsdf.integrate_frame
launch per frame with CUDA events (behind a sleep kernel, so that the
host's set-up of the launch is not timed), integrating the frames in order
into a fresh volume, twice; a checkout whose integrate_frame takes the frame's
largest depth is given it, as TSDFVolume.integrate gives it. Prints each
turn's median ms per frame, the speed-up and whether this checkout is
slower beyond the spread (compare_fused_agg.spread_of), and the card's name
and power limit. Unpack the other commit with `git archive <commit> | tar
-x -C <dir>` into a directory that .gitignore lists.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from compare_fused_agg import spread_of  # noqa: E402

TURN = """
import inspect, json, statistics, sys
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
from nerfloc_tpu_torch.native import tsdf as ntsdf
dev = torch.device("cuda")
_, _, calls, vol = cs._preprocess_seven_scenes(%r, "cuda")
takes_max = "depth_max" in inspect.signature(ntsdf.integrate_frame).parameters
frames = []
for (v, color, depth, K, c2w, *_), _ms in calls:
    extra = {"depth_max": float(np.max(depth))} if takes_max else {}
    frames.append((v._upload(depth), v._upload(color), np.asarray(K, np.float32).reshape(9),
                   *ntsdf.world_to_camera(c2w), extra))
ms = []
for _ in range(2):
    work = {k: torch.ones_like(t) if k == "tsdf" else torch.zeros_like(t)
            for k, t in vol.volume().items()}
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for depth, color, K, R, t, extra in frames:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)   # the host's set-up of the launch is not timed
        start.record()
        ntsdf.integrate_frame(work, vol.dims, vol.origin, vol.voxel_size, vol.sdf_trunc, depth,
                              color, K, R, t, 1.0, overflow, **extra)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
print("TURN " + json.dumps({"ms": statistics.median(ms), "frames": len(frames),
                            "launches": len(ms), "voxels": int(np.prod(vol.dims))}))
"""


def turn(checkout: str, scene_root: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", TURN % scene_root], cwd=checkout,
                          capture_output=True, text=True, timeout=900)
    line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")), None)
    if proc.returncode or line is None:
        raise RuntimeError(f"turn in {checkout} failed:\n{proc.stdout}\n{proc.stderr}")
    return json.loads(line[5:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other")
    ap.add_argument("--pairs", type=int, default=2, help="pairs of turns (at least 2)")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if args.pairs < 2:
        ap.error("--pairs must be at least 2")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from nerfloc_tpu_torch.data import synthetic as syn
    card = cs.card_line()
    other = os.path.abspath(args.other)
    runs = {"other": [], "this": []}
    with tempfile.TemporaryDirectory(prefix="compare_tsdf_") as root:
        syn.write_seven_scenes_raw(root, cs.PREP_SCENE, cs.PREP_TRAIN_SEQS, cs.PREP_TEST_SEQS,
                                   n_frames=cs.PREP_FRAMES)
        for i in range(args.pairs):
            for name in (("other", "this") if i % 2 == 0 else ("this", "other")):
                runs[name].append(turn(other if name == "other" else ROOT, root))
                print(f"{name}: {runs[name][-1]}", flush=True)
    a = [r["ms"] for r in runs["other"]]
    b = [r["ms"] for r in runs["this"]]
    spread = spread_of(a, b)
    slower = statistics.mean(b) - statistics.mean(a) > spread
    summary = {"other_ms": a, "this_ms": b, "spread_ms": spread,
               "speedup": statistics.mean(a) / statistics.mean(b), "slower_beyond_spread": slower,
               "frames": runs["this"][0]["frames"], "voxels": runs["this"][0]["voxels"]}
    print(f"tsdf_integrate median ms per frame, other = {other}, this = {ROOT}; {card}")
    print(f"  other {' / '.join(f'{v:.4f}' for v in a)}, this {' / '.join(f'{v:.4f}' for v in b)},"
          f" speed-up {summary['speedup']:.3f}x, spread {spread:.4f} ms"
          f"{', SLOWER beyond the spread' if slower else ''}")
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"card": card, "tsdf_integrate": summary}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
