#!/usr/bin/env python3
"""Where the time of one localization query goes, on the GPU, in the
PyTorch port (nerfloc_tpu_torch).

    python3 tools/profile_torch_localize.py [--views 5] [--dtype bfloat16] [--out profile.json]

Runs localize_forward at full width (default Config with
render.fused_query_agg=True, 240x320, seeded weights; --dtype: the compute
dtype, float32 by default) and reports:
  * per-stage host-clock times, each stage fenced by torch.cuda.synchronize
    (build_context, query_coarse, match, ransac_pnp);
  * a torch.profiler window over 3 queries: device busy time per query,
    the device's idle share of the wall time, and the top kernels by
    device time and the top operators by host time.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--views", type=int, default=5)
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                    help="the model's compute dtype")
    ap.add_argument("--out", default="", help="also write the full result as JSON here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_localize: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nerfloc_tpu_torch.configs import Config, RenderConfig
    from nerfloc_tpu_torch.data import device_batch, make_query_batch
    from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
    from nerfloc_tpu_torch.solve.pnp import gumbel_noise, ransac_pnp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cfg = Config(render=RenderConfig(fused_query_agg=True))
    model = NerfPoseEstimator(cfg, device=dev, seed=0, dtype=getattr(torch, args.dtype))
    batch = to_device_batch(device_batch(make_query_batch(
        n_views=args.views, H=240, W=320, seed=0)), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(3):
        model.localize_forward(batch, generator=gen)
    torch.cuda.synchronize()

    def stages():
        out = {}

        def mark(name, t0):
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t0) * 1e3
            return time.perf_counter()

        with torch.no_grad():
            t0 = time.perf_counter()
            ctx, q2d = model.build_context(batch)
            t0 = mark("build_context", t0)
            kp = gumbel_noise((model.n_coarse_points(batch),), gen, dev)
            desc, pts3d, ndc = model.model_3d.query_coarse(ctx, kp)
            t0 = mark("query_coarse", t0)
            m = model.match(ctx, q2d, batch, desc, pts3d, ndc)
            t0 = mark("match", t0)
            ransac_pnp(m["mkps2d_f"], m["mkps3d"], m["pair_mask"], batch["K"],
                       thresh_px=cfg.ransac_thresh, n_hyps=cfg.shapes.pnp_hypotheses,
                       generator=gen)
            mark("ransac_pnp", t0)
        return out

    runs = [stages() for _ in range(5)]
    stage_ms = {k: statistics.median(r[k] for r in runs) for k in runs[0]}

    n_prof = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            model.localize_forward(batch, generator=gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_prof
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)

    # device activities only (kernels, copies); operator rows would count
    # their kernels twice, and the profiler's own buffer flushes are not work
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and dev_us(e) > 0 and "Buffer Flush" not in e.key),
                     key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / n_prof
    host = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)
    result = {
        "card": card, "views": args.views, "dtype": args.dtype, "wall_ms_per_query": wall_ms,
        "device_busy_ms_per_query": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "stage_ms": stage_ms,
        "kernels_per_query": sum(e.count for e in kernels) / n_prof,
        "top_device": [{"name": e.key, "ms_per_query": dev_us(e) / 1e3 / n_prof,
                        "calls_per_query": e.count / n_prof} for e in kernels[:25]],
        "top_host": [{"name": e.key, "self_cpu_ms_per_query":
                      e.self_cpu_time_total / 1e3 / n_prof,
                      "calls_per_query": e.count / n_prof} for e in host[:15]],
        "ops_per_query": sum(e.count for e in events if e.key.startswith("aten::"))
        / n_prof,
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(f"card: {card}; compute dtype {args.dtype}")
    print(f"stages (ms, median of 5, synchronized): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stage_ms.items()))
    print(f"profiled: wall {wall_ms:.2f} ms/query, device busy {busy_ms:.2f} ms/query, "
          f"idle share {result['device_idle_share']:.3f}, "
          f"aten ops/query {result['ops_per_query']:.0f}, "
          f"device activities/query {result['kernels_per_query']:.0f}")
    for e in result["top_device"][:15]:
        print(f"  dev {e['ms_per_query']:8.3f} ms  x{e['calls_per_query']:6.1f}  {e['name'][:90]}")
    for e in result["top_host"][:8]:
        print(f"  host {e['self_cpu_ms_per_query']:8.3f} ms  x{e['calls_per_query']:6.1f}  "
              f"{e['name'][:80]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
