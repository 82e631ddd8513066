#!/usr/bin/env python3
"""Where the time of one eval query goes, on the GPU, in the PyTorch port
(nerfloc_tpu_torch).

    python3 tools/profile_torch_eval.py [--dtype bfloat16] [--out profile.json]

Runs make_eval_step at full width (default Config with
render.fused_query_agg=True, cascade_matching=True, optimize_pose=True;
V=5 at 240x320, 512 refinement rays x 64 samples, 50 Adam steps; seeded
weights and noise; --dtype: the model's compute dtype, float32 by
default), one query per step, and reports:
  * per-stage device times inside the real step, by CUDA events recorded
    around each stage's function: localization (build_context,
    query_coarse, the first match, the first PnP), the cascade
    (match_cascade, the second PnP, count_pose_inliers) and the refinement
    (its render_rays forwards, its backwards, the replayed reference_agg
    inside the backwards, and the rest of refine_pose: se(3) maps, Adam);
    the rest of the step as "other". Medians of 3 queries after 2 warm-up
    queries, each ended by torch.cuda.synchronize();
  * the peak device memory of one query;
  * a torch.profiler window over 2 queries: device busy time per query,
    the device's idle share of the wall time, device activities per query
    and the top kernels.
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

import chip_smoke as cs  # noqa: E402  (StageTimer, card_line, eval_cfg, eval_noise)
from profile_torch_train import timed_backward  # noqa: E402

REPLAY = "refinement: replayed reference_agg (in the backward)"


def outer_grad_timer(torch, T, name: str):
    """Wrap torch.autograd.grad in CUDA events, counting only calls that
    are not nested in another (the fused kernel's backward calls it
    too); returns the undo function."""
    orig = torch.autograd.grad
    depth = [0]

    def grad(*a, **kw):
        if depth[0]:
            return orig(*a, **kw)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        depth[0] += 1
        start.record()
        try:
            return orig(*a, **kw)
        finally:
            end.record()
            depth[0] -= 1
            T.events[name].append((start, end))
    torch.autograd.grad = grad
    return lambda: setattr(torch.autograd, "grad", orig)


def split_calls(T, name: str, names):
    """Hand the k-th call of a stage recorded under `name` in each query to
    names[k % len(names)] (the first and the cascade pass share functions)."""
    calls = T.events.pop(name, [])
    for k, n in enumerate(names):
        T.events[n] += calls[k::len(names)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                    help="the model's compute dtype")
    ap.add_argument("--out", default="", help="also write the full result as JSON here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_eval: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nerfloc_tpu_torch.data import device_batch, make_query_batch, stack_batches
    from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
    from nerfloc_tpu_torch.ops import fused_agg as fa
    from nerfloc_tpu_torch.train import step as step_mod
    from nerfloc_tpu_torch.train.step import make_eval_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    cfg = cs.eval_cfg()
    model = NerfPoseEstimator(cfg, device=dev, seed=0, dtype=getattr(torch, args.dtype))
    step = make_eval_step(model, cfg)
    batch = to_device_batch(stack_batches([device_batch(make_query_batch(
        n_views=5, H=240, W=320, seed=0))]), dev)

    def run(i):
        noise = {k: v.to(dev) for k, v in cs.eval_noise(model, batch, seed=i).items()}
        return step(batch, noise=noise)
    for i in range(2):
        run(i)
    torch.cuda.synchronize()

    T = cs.StageTimer()
    for owner, attr, name in ((model, "build_context", "localize: build_context"),
                              (model.model_3d, "query_coarse", "localize: query_coarse"),
                              (model, "match", "match"),
                              (step_mod, "ransac_pnp", "pnp"),
                              (step_mod, "count_pose_inliers", "cascade: count_pose_inliers"),
                              (step_mod, "refine_pose", "refine_pose"),
                              (model.model_3d, "render_rays",
                               "refinement: forward (render_rays)")):
        T.wrap(owner, attr, name)
    undo = [timed_backward(fa, T), outer_grad_timer(torch, T, "refinement: backward")]
    runs = []
    try:
        for i in range(3):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            run(10 + i)
            end.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            T.events[REPLAY] = T.events.pop("backward: replayed reference_agg", [])
            split_calls(T, "match", ("localize: match", "cascade: match (second matcher)"))
            split_calls(T, "pnp", ("localize: ransac_pnp", "cascade: ransac_pnp"))
            took = T.take()
            ms = {k: v for k, (v, _) in took.items()}
            calls = {k: n for k, (_, n) in took.items()}
            ms["refinement: rest (se(3) maps, Adam, acceptance)"] = ms.pop("refine_pose") - \
                ms["refinement: forward (render_rays)"] - ms["refinement: backward"]
            span = start.elapsed_time(end)
            ms["other (pose error, pairs, gaps)"] = span - sum(
                v for k, v in ms.items() if k != REPLAY)
            ms["device span of the query"] = span
            ms["host wall of the query"] = wall
            ms["peak memory GiB"] = torch.cuda.max_memory_allocated() / 2**30
            runs.append(ms)
    finally:
        for u in undo:
            u()
        T.restore()
    stage_ms = {k: statistics.median(r[k] for r in runs) for k in runs[0]}

    n_prof = 2
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_prof):
            run(20 + i)
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
    result = {
        "card": card, "dtype": args.dtype, "stage_ms": stage_ms, "calls_per_query": calls,
        "profiled_wall_ms_per_query": wall_ms, "device_busy_ms_per_query": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_activities_per_query": sum(e.count for e in kernels) / n_prof,
        "top_device": [{"name": e.key, "ms_per_query": dev_us(e) / 1e3 / n_prof,
                        "calls_per_query": e.count / n_prof} for e in kernels[:25]],
    }
    print(f"eval query, V=5 240x320, cascade + refinement ({cfg.shapes.pose_refine_rays} rays "
          f"x {cfg.render.N_samples} samples, 50 Adam steps), compute dtype {args.dtype}; "
          f"{card}")
    print("  stages (device ms inside one query, median of 3; calls per query):")
    for k, v in stage_ms.items():
        print(f"    {k:52s} {v:10.3f}  {calls.get(k, '')}")
    print(f"  profiled: wall {wall_ms:.2f} ms/query, device busy {busy_ms:.2f} ms/query, idle "
          f"share {result['device_idle_share']:.3f}, device activities/query "
          f"{result['device_activities_per_query']:.0f}")
    for e in result["top_device"][:15]:
        print(f"    dev {e['ms_per_query']:8.3f} ms  x{e['calls_per_query']:7.1f}  {e['name'][:90]}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
