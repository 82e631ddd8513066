#!/usr/bin/env python3
"""Where the time of one train step goes, on the GPU, in the PyTorch port
(nerfloc_tpu_torch).

    python3 tools/profile_torch_train.py [--dtype bfloat16] [--out profile.json]

Runs make_train_step at full width (default Config with
render.fused_query_agg=True, V=5 at 240x320, 1024 keypoints, 1024 rays
dense-64, B=1, seeded weights and noise; --dtype: the model's compute
dtype, float32 by default) and reports:
  * per-stage device times inside the real step: CUDA events recorded
    around build_context, the matching forward (query_coarse, the
    ground-truth pairs, match), the ref-depth loss, the render loss
    (render_rays + rendering_loss), the backward, and the optimizer; the
    rest of the step as "other"; inside the backward, the replayed
    reference_agg backward of the fused kernel. Medians of 5 steps after 3
    warm-up steps, each ended by torch.cuda.synchronize();
  * the device memory of one step: the peak since the step began, read
    at the end of each stage, and what the forward leaves allocated for
    the backward;
  * the context sampler's backward (the index-add of the bilinear samples
    of [fine features | ray features] at every fine point in every view)
    at the step's shapes, timed alone: median of 10;
  * a torch.profiler window over 3 steps: device busy time per step, the
    device's idle share of the wall time, device activities per step, the
    index-backward (scatter-add) kernels' share, and the top kernels;
  * the step again with the process capped at a quarter of the card's
    memory (torch.cuda.set_per_process_memory_fraction): its peak and the
    median ms of 3 steps, which tell workspace taken because it is free
    (cuDNN chooses convolution algorithms by the memory it can get) from
    tensors the step needs.
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

import chip_smoke as cs  # noqa: E402  (StageTimer, card_line, train_noise)


def timed_backward(fa, T):
    """Wrap _FusedAgg.backward (a staticmethod) in CUDA events; returns the
    undo function."""
    orig = fa._FusedAgg.backward

    def backward(ctx, g):
        import torch
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = orig(ctx, g)
        end.record()
        T.events["backward: replayed reference_agg"].append((start, end))
        return out
    fa._FusedAgg.backward = staticmethod(backward)
    return lambda: setattr(fa._FusedAgg, "backward", staticmethod(orig))


def memory_by_stage(run, stages):
    """{stage: (peak GiB since the step began, allocated GiB)} at the end of
    each (owner, attr, name) stage of one step."""
    import torch
    out, undo = {}, []
    for owner, attr, name in stages:
        fn = getattr(owner, attr)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            res = _fn(*a, **kw)
            out[_name] = (torch.cuda.max_memory_allocated() / 2**30,
                          torch.cuda.memory_allocated() / 2**30)
            return res
        undo.append((owner, attr, fn, attr in vars(owner)))
        setattr(owner, attr, wrapped)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        out["whole step"] = (torch.cuda.max_memory_allocated() / 2**30,
                             torch.cuda.memory_allocated() / 2**30)
    finally:
        for owner, attr, fn, had in reversed(undo):
            if had:
                setattr(owner, attr, fn)
            else:
                delattr(owner, attr)
    return out


def sampler_backward_ms(model, batch):
    """(forward ms, backward ms) of the context build's bilinear sampling of
    [fine features | ray features] at the fine points' projections."""
    import torch
    from nerfloc_tpu_torch.models.fields.projector import compute_projections, feature_uv
    from nerfloc_tpu_torch.ops.interp import bilinear_sample_views_map_grad
    with torch.no_grad():
        ctx, _ = model.build_context(batch)
    sv, fmap = ctx.sv, ctx.feat_fine_src
    V, H, W = sv.images.shape[:3]
    h, w = fmap.shape[1:3]
    proj = compute_projections(ctx.fine.xyz, sv.Ks, sv.poses, H, W)
    uv = feature_uv(proj.uv, h, w, H, W)
    maps = torch.cat([fmap, sv.vis_featmaps], dim=-1).detach().requires_grad_(True)
    cot = torch.randn(V, uv.shape[1], maps.shape[-1], device=maps.device)
    fwd, bwd = [], []
    for i in range(13):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        e[0].record()
        out = bilinear_sample_views_map_grad(maps, uv)
        e[1].record()
        torch.autograd.grad(out, maps, cot)
        e[2].record()
        torch.cuda.synchronize()
        if i >= 3:
            fwd.append(e[0].elapsed_time(e[1]))
            bwd.append(e[1].elapsed_time(e[2]))
    return statistics.median(fwd), statistics.median(bwd), tuple(maps.shape), uv.shape[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                    help="the model's compute dtype")
    ap.add_argument("--out", default="", help="also write the full result as JSON here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_train: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nerfloc_tpu_torch.configs import Config, RenderConfig
    from nerfloc_tpu_torch.data import device_batch, make_query_batch, stack_batches
    from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
    from nerfloc_tpu_torch.ops import fused_agg as fa
    from nerfloc_tpu_torch.train.state import TrainState
    from nerfloc_tpu_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    cfg = Config(render=RenderConfig(fused_query_agg=True))
    model = NerfPoseEstimator(cfg, device=dev, seed=0, dtype=getattr(torch, args.dtype))
    batch = to_device_batch(stack_batches([device_batch(make_query_batch(
        n_views=5, H=240, W=320, seed=0))]), dev)
    state = TrainState(model, cfg)
    step = make_train_step(model, cfg)

    def run(i):
        kp, idx = cs.train_noise(model, batch, seed=i)
        return step(state, batch, kp_gumbel=kp.to(dev), ray_idx=idx.to(dev))
    for i in range(3):
        run(i)
    torch.cuda.synchronize()

    stages = ((model, "build_context", "forward: build_context"),
              (model.model_3d, "query_coarse", "forward: matching"),
              (model, "match", "forward: matching"),
              (model.model_3d.multiview_aggregator, "ref_depth_loss",
               "forward: ref-depth loss"),
              (model, "compute_render_loss", "forward: render loss"),
              (torch.Tensor, "backward", "backward"),
              (TrainState, "apply_gradients", "optimizer"))
    memory = memory_by_stage(lambda: run(3), stages)
    T = cs.StageTimer()
    for owner, attr, name in stages:
        T.wrap(owner, attr, name)
    undo = timed_backward(fa, T)
    runs = []
    try:
        for i in range(5):
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            run(10 + i)
            end.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            ms = {k: v for k, (v, _) in T.take().items()}
            span = start.elapsed_time(end)
            ms["other (rest of the step)"] = span - sum(
                v for k, v in ms.items() if k != "backward: replayed reference_agg")
            ms["device span of the step"] = span
            ms["host wall of the step"] = wall
            runs.append(ms)
    finally:
        undo()
        T.restore()
    stage_ms = {k: statistics.median(r[k] for r in runs) for k in runs[0]}

    s_fwd, s_bwd, s_shape, s_pts = sampler_backward_ms(model, {k: v[0] for k, v in batch.items()})

    n_prof = 3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_prof):
            run(20 + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_prof
    peak = torch.cuda.max_memory_allocated() / 2**30
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)

    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and dev_us(e) > 0 and "Buffer Flush" not in e.key),
                     key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / n_prof
    scatter_ms = sum(dev_us(e) for e in kernels
                     if "index" in e.key.lower() and ("backward" in e.key.lower()
                                                      or "put" in e.key.lower())) / 1e3 / n_prof
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(0.25)
    try:
        cap_peak = memory_by_stage(lambda: run(30), ())["whole step"][0]
        cap_ms = []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(31 + i)
            torch.cuda.synchronize()
            cap_ms.append((time.perf_counter() - t0) * 1e3)
        capped = {"peak_gib": cap_peak, "ms_per_step": statistics.median(cap_ms)}
    except torch.cuda.OutOfMemoryError as e:
        capped = {"error": str(e).splitlines()[0]}
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)

    result = {
        "card": card, "dtype": args.dtype, "stage_ms": stage_ms,
        "context_sampler": {"maps": s_shape, "points_per_view": s_pts,
                            "forward_ms": s_fwd, "backward_ms": s_bwd},
        "profiled_wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_activities_per_step": sum(e.count for e in kernels) / n_prof,
        "index_backward_kernels_ms_per_step": scatter_ms,
        "peak_memory_gib": peak,
        "memory_gib_at_stage_end": memory,
        "capped_at_quarter": capped,
        "top_device": [{"name": e.key, "ms_per_step": dev_us(e) / 1e3 / n_prof,
                        "calls_per_step": e.count / n_prof} for e in kernels[:25]],
    }
    print(f"train step, V=5 240x320, B=1, 1024 keypoints, 1024 rays x 64 samples, compute "
          f"dtype {args.dtype}; {card}")
    print("  stages (device ms inside one step, median of 5):")
    for k, v in stage_ms.items():
        print(f"    {k:36s} {v:9.3f}")
    print("  memory at the end of each stage (GiB: peak since the step began, allocated):")
    for k, (pk, al) in memory.items():
        print(f"    {k:36s} {pk:9.2f} {al:9.2f}")
    print(f"  capped at a quarter of the card's memory: {capped}")
    print(f"  context sampler alone, maps {s_shape} at {s_pts} points per view: forward "
          f"{s_fwd:.3f} ms, backward (scatter-add) {s_bwd:.3f} ms (median of 10)")
    print(f"  profiled: wall {wall_ms:.2f} ms/step, device busy {busy_ms:.2f} ms/step, idle "
          f"share {result['device_idle_share']:.3f}, device activities/step "
          f"{result['device_activities_per_step']:.0f}, index-backward kernels "
          f"{scatter_ms:.3f} ms/step, peak memory {peak:.2f} GiB")
    for e in result["top_device"][:15]:
        print(f"    dev {e['ms_per_step']:8.3f} ms  x{e['calls_per_step']:6.1f}  {e['name'][:90]}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
