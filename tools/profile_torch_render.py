#!/usr/bin/env python3
"""Where the time of one render_rays call goes, on the GPU, in the PyTorch
port (nerfloc_tpu_torch).

    python3 tools/profile_torch_render.py [--dtype bfloat16] [--out profile.json]

Renders 4096 rays at seeded pixels of the query view against a full-width
scene context (default Config with render.fused_query_agg=True, V=5 at
240x320, seeded weights; --dtype: the compute dtype, float32 by default),
dense-64 and guided 16+16, and reports for each:
  * per-stage device times inside the real call: CUDA events recorded
    around each stage's function (z values / guided pass, projection,
    knn_proj, aggregator table sampling + visibility decode, neighbour
    gather, fused_agg kernel, RayUnet, sigma head, blending, compositing),
    the rest of the call as "other"; medians of 5 calls, each ended by
    torch.cuda.synchronize();
  * fused_agg launches per call (the wrapper's counter);
  * a torch.profiler window over 3 calls: device busy time per call, the
    device's idle share of the wall time, device activities per call and
    the top kernels by device time.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (RENDER_RAYS, seeded_rays, StageTimer, card_line)


def profile_kind(kind, render, batch, rays, dtype, n_prof: int = 3):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nerfloc_tpu_torch.configs import Config
    from nerfloc_tpu_torch.models.fields import conditional_nerf as cn
    from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator
    from nerfloc_tpu_torch.ops import fused_agg as fa

    torch.cuda.reset_peak_memory_stats()
    model = NerfPoseEstimator(Config(render=render), device=torch.device("cuda"), seed=0,
                              dtype=dtype)
    counter = fa.LAUNCHES_BF16 if dtype == torch.bfloat16 else fa.LAUNCHES
    nerf = model.model_3d
    with torch.no_grad():
        ctx, _ = model.build_context(batch)

        def call():
            return nerf.render_rays(ctx, *rays, batch["pose"])
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        counter.n = 0
        call()
        torch.cuda.synchronize()
        launches = counter.n

        T = cs.StageTimer()
        T.wrap(nerf, "ray_depths", "z values / guided pass")
        T.wrap(cn, "compute_projections", "projection")
        T.wrap(nerf, "render_neighbours", "knn_proj")
        T.wrap(nerf.multiview_aggregator, "forward", "aggregator: tables + visibility")
        T.wrap(nerf, "gather_neighbours", "neighbour gather")
        T.wrap(cn, "fused_neighbor_agg", "fused_agg kernel")
        T.wrap(nerf.ray_unet, "forward", "RayUnet")
        T.wrap(nerf.sigma_mlp, "forward", "sigma head")
        T.wrap(nerf, "blend_views", "blending")
        T.wrap(nerf, "composite", "compositing")
        runs = []
        try:
            for _ in range(5):
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0 = time.perf_counter()
                start.record()
                call()
                end.record()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                stages = {k: ms for k, (ms, _) in T.take().items()}
                stages["other (rest of the call)"] = start.elapsed_time(end) - sum(stages.values())
                stages["device span of the call"] = start.elapsed_time(end)
                stages["host wall of the call"] = wall
                runs.append(stages)
        finally:
            T.restore()
        stage_ms = {k: statistics.median(r[k] for r in runs) for k in runs[0]}

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_prof):
                call()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n_prof
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)

    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and dev_us(e) > 0 and "Buffer Flush" not in e.key),
                     key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / n_prof
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model, nerf, ctx
    torch.cuda.empty_cache()
    return {
        "kind": kind, "samples": render.N_samples + render.N_importance,
        "fused_agg_launches_per_call": launches, "stage_ms": stage_ms,
        "profiled_wall_ms_per_call": wall_ms, "device_busy_ms_per_call": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_activities_per_call": sum(e.count for e in kernels) / n_prof,
        "peak_memory_gib": peak,
        "top_device": [{"name": e.key, "ms_per_call": dev_us(e) / 1e3 / n_prof,
                        "calls_per_call": e.count / n_prof} for e in kernels[:20]],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                    help="the model's compute dtype")
    ap.add_argument("--out", default="", help="also write the full result as JSON here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_render: needs a CUDA device", file=sys.stderr)
        return 2
    dtype = getattr(torch, args.dtype)
    from nerfloc_tpu_torch.configs import RenderConfig
    from nerfloc_tpu_torch.data import device_batch, make_query_batch
    from nerfloc_tpu_torch.models.pose_estimator import to_device_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    batch = to_device_batch(device_batch(make_query_batch(n_views=5, H=240, W=320, seed=0)),
                            dev)
    rays = cs.seeded_rays(batch, cs.RENDER_RAYS, seed=0)

    result = {"card": card, "rays": cs.RENDER_RAYS, "dtype": args.dtype, "runs": []}
    for kind, render in (("dense", RenderConfig(fused_query_agg=True)),
                         ("guided", RenderConfig(fused_query_agg=True, N_samples=16,
                                                 N_importance=16))):
        r = profile_kind(kind, render, batch, rays, dtype)
        result["runs"].append(r)
        print(f"{kind} ({r['samples']} samples/ray, {cs.RENDER_RAYS} rays, {args.dtype}; {card}): "
              f"fused_agg launches/call {r['fused_agg_launches_per_call']}")
        print("  stages (device ms inside one call, median of 5):")
        for k, v in r["stage_ms"].items():
            print(f"    {k:34s} {v:9.3f}")
        print(f"  profiled: wall {r['profiled_wall_ms_per_call']:.2f} ms/call, device busy "
              f"{r['device_busy_ms_per_call']:.2f} ms/call, idle share "
              f"{r['device_idle_share']:.3f}, device activities/call "
              f"{r['device_activities_per_call']:.0f}, peak memory "
              f"{r['peak_memory_gib']:.2f} GiB")
        for e in r["top_device"][:12]:
            print(f"    dev {e['ms_per_call']:8.3f} ms  x{e['calls_per_call']:5.1f}  "
                  f"{e['name'][:90]}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
