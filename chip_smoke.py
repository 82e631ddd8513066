#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (nerfloc_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --parallel-only   # phase 1, then phases 14 and 16
    python3 chip_smoke.py --prep-only       # phase 1, then phase 18
    python3 chip_smoke.py --options-only    # phase 1, then phase 19

Phases (any failure exits non-zero):
  1. build every hand-written kernel from csrc/ (one nvcc per source:
     fused_agg.cu and tsdf.cu) and the host helpers;
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (and a ragged N), forward and one gradient;
  3. the port's CUDA path against its CPU path (the plain versions, held
     against the JAX package by tests/test_torch_*.py) on a small query;
  4. the main path: localize_forward at full width (default Config with
     render.fused_query_agg=True, V=5 at 240x320, seeded weights), with the
     launch counters set to 0 just before one query and read just after;
     then the median ms/query over 10 queries;
  5. the PnP perfect-correspondence fixture (rot < 0.5 deg, trans < 1 cm);
  6. the render path's CUDA run against its CPU run on a small context
     (V=3 at 32x32, 64 rays, dense S=8 and guided 4+4), same weights;
  7. the render path at full width (default Config with
     render.fused_query_agg=True, V=5 at 240x320, seeded weights), dense-64
     and guided 16+16, each its own model: the scene context once, then
     4096 rays at seeded pixels per render_rays call, with the launch
     counters set to 0 just before one call and read just after (exactly
     one fused_agg launch); the median ms/call over 10 calls, and the
     kernel's own device time inside one dense call;
  8. render_image of a 240x320 frame in chunks of 2048 rays: 38 launches
     in the first frame, then the median ms/frame over 3 more;
  9. the train step: (a) a tiny step (V=3 at 32x32, the test config's
     sizes) on CUDA through the kernel against the same step on the CPU
     through the plain versions, same weights and noise: loss, its terms
     and every parameter gradient; (b) the kernel's forward and its
     replayed backward at the render train shape (N=65536, K=8) against
     the plain version under autograd, and the forward's kernel and
     plain-version times there; (c) make_train_step at full width
     (default Config with render.fused_query_agg=True, V=5 at 240x320,
     1024 keypoints, 1024 rays dense-64, B=1): 2 warm-up steps and 10
     timed steps on one fixed batch, the launch counters set to 0 just
     before each step and read just after (exactly 3 fused_agg launches),
     loss and grad_norm finite every step, and the loss at the first
     step's noise lower after the steps than before them;
 10. kernel and plain-version times at the query shapes (every tile size)
     and at the render shape (N=262144, K=8), each kernel's bound at the
     FP32 peak and at the TF32 tensor-core peak;
 11. the eval step: (a) a tiny eval step (the test config's sizes, cascade
     matching and refinement on, 128 refinement rays, two queries) on CUDA
     against the CPU, same weights and noise: discrete outputs equal, poses
     and errors within PATH_TOL plus 3x their CPU spread under a 2^-22
     weight change; (b) the kernel at the refinement shape (N=32768, K=8)
     against the plain version, forward and the replayed backward's input
     gradients (xyz, direction, mv_agg), and its times and bound there;
     (c) make_eval_step at full width (default Config with
     render.fused_query_agg=True, cascade_matching=True, optimize_pose=True;
     V=5 at 240x320, 512 refinement rays x 64 samples, 50 Adam steps),
     one query per step: the launch counters set to 0 just before each
     query and read just after (exactly 55 fused_agg launches, 52 of them
     in refinement), the pose a rotation and its errors finite, 2 warm-up
     and 5 timed queries (ms/query and device ms of localization, cascade
     and refinement), the accepted cascade poses and refinements; the
     per-scene table of eval_dataset over 4 queries of 2 seeds (batches of
     3, the last one padded) and render_psnr_eval over one view, finite;
 12. the bf16 compute dtype (compute_dtype_of(Config()), the JAX package's
     default): (a) the kernel's bf16 instantiation against its plain
     version (kernel_agg) at the query shapes (every tile size: the
     16/32-row cluster tiles, 16 of which K = 1 takes, and the 64/128-row
     wide tiles, 64 of which K = 8 takes), ragged N (999, 1001) at every
     tile, K = 3 and 12, the small K > 1 launches of the 32-row cluster
     tile and the render shape, within BF16_TOL of the plain
     version's own bf16-vs-f32 distance, and the replayed bf16 backward;
     (b) the small query and render in bf16, CUDA against the CPU, within
     the CPU's own bf16-vs-f32 distance; (c) localize_forward in bf16 at
     full width (exactly 2 bf16 launches and 0 f32 ones per query, the
     pose a rotation, the median ms/query over 10, peak memory); (d)
     render_rays in bf16 at full width, dense-64 and guided 16+16 (exactly
     1 bf16 launch per call, renders finite, rgb in [0, 1], the median
     ms/call over 10, the kernel's time inside one call); (e) the bf16
     kernel's times, plain-version times and bound at the bf16 tensor-core
     peak (the second entry of the `kernels` line).
 13. the bf16 steps: (a) the tiny bf16 train and eval steps on CUDA
     against the CPU (small_steps_bf16_vs_cpu); (b) the bf16 kernel and its
     replayed backward at the train shape (N=65536, K=8) and the
     refinement shape (N=32768, K=8), with times and bounds; (c)
     make_train_step at bf16 at full width as in 9c (exactly 3 bf16
     launches and 0 f32 ones per step); (d) make_eval_step at bf16 at full
     width as in 11c (exactly 55 bf16 launches per query, 52 in
     refinement, and 0 f32 ones), eval_dataset and render_psnr_eval; the
     bf16 and f32 step times side by side.
 14. the CLIs on files: two scenes written by data.synthetic.write_scene
     at 480x640 (16 train and 2 test frames each, PNG frames through the
     port's encoder with libpng's adaptive filter choice per row, so most
     rows are Up, Avg or Paeth; netvlad retrieval pkls), a data YAML with
     video_7scenes's TRANSFORM and AUG_TRANSFORM pointed at them, and
     configs/7scenes_all.yaml loaded by the port's load_config with only
     dataset_type, scenes and max_epochs: 1 replaced (the test CLI also
     sets cascade_matching and optimize_pose; render.fused_query_agg stays
     off, and the card runs the kernel all the same); cli.train.main for
     one epoch (B=1; exactly 3 bf16 launches and 0 f32 per step, the
     counters set to 0 just before each step and read just after; loss and
     grad_norm finite; the epoch eval's psnr_test finite; a pose_acc best
     stream), then the same batches through a fresh model's step with no
     loader running, then cli.test.main over its checkpoints (exactly 55
     bf16 launches per query; the per-scene table finite, n == 4); no cv2,
     PIL or yaml module loaded; host ms per dataset item (train with
     augmentation, test), the loader's items/s at the CLI's B=1 and at B=8
     with 8 threads and with 1, the CLI's median ms/step and the share of
     the epoch outside the step, eval ms/query, the PNG decoder's ms per
     480x640 Paeth frame, and the exact-KNN calls of the steps timed with
     ops/knn's squared norms and with plain f32 ones.
 15. the per-scene fine-tune configurations on files, bf16, full width:
     two object scenes written by data.synthetic.write_object_scene in
     OnePose's layout at 512x512 (20 train and 2 test frames each; float32
     MVS depth as TIFF), one 12-Scenes-layout scene written by
     write_twelve_scenes_scene (1296x968 JPEG colour frames, 640x480 depth
     PNGs), each config with only dataset_type, scenes and max_epochs: 1
     (and the test switches) replaced: (a) cli.train at
     configs/onepose_all.yaml (appearance on, V=5); (b) cli.train at
     configs/onepose/0447.yaml with --ckpt at (a)'s checkpoints (no
     appearance, coordinate heads, V=16 coreset FPS, N_rand 512, object
     masks): the warm start's fresh tensors exactly the 12 of the
     coordinate heads, exactly 3 bf16 and 0 f32 launches per step, losses
     finite, the same batches with no loader, the loader-wait share, peak
     memory; (c) cli.test on (b) with cascade, refinement, vis_3d_box and
     the trajectory: exactly 55 bf16 launches per query, each box PNG
     decoded and equal to the box drawn at the predicted pose, a finite
     table; (d) cli.train at configs/12scenes/apt1_kitchen.yaml without
     --ckpt (its YAML ckpt: unread), then cli.test (2 launches per query);
     host ms per JPEG decode (helper, decode_py), per 512x512 float32 TIFF
     read per compression, per compute_target_mask and per item; no cv2,
     PIL, yaml or tifffile module loaded.
 16. parallelism on phase 14's scenes and configurations (bf16), each
     job a subprocess with PYTHONHASHSEED=0 (dataset items draw alike in
     every process), its rank processes started by torchrun: (a) cli.train
     as 2 ranks sharing the card over gloo (NCCL refuses two ranks on one
     device), global batch 2, one epoch with its multi-process eval:
     exactly 3 bf16 and 0 f32 launches per step per rank, both ranks'
     parameters bit-equal after the epoch, one gradient all-reduce per
     step; every job runs under torch.use_deterministic_algorithms (ops
     without a deterministic implementation warn and are listed); (b) the
     same epoch as 1 rank over NCCL (its all-reduce built and launched),
     which is one process's arithmetic run again: its first-step gradient
     and parameters bit-equal to the one-process run's, then one cli.test
     whose table equals one process's; against one process's B=2 epoch on
     the same batches and noise, the 2 ranks' first-step gradient and
     parameters after the epoch each within PAR_TOL of every leaf's norm
     (plus 1e-8 of the whole norm, for leaves zero in exact arithmetic);
     (c) 2 ranks over NCCL where there are 2 cards;
     render_image_ray_sharded of a 240x320 frame at ray width 2 (phase 8's
     f32 model): 19 launches per rank, rgb and depth within FRAME_TOL of
     render_image in one process, the mask equal; cli.test as 2 ranks with
     cascade and refinement over phase 14's checkpoints, each query's
     noise fixed by its test index: the per-scene table equal on both
     ranks, and against one process's counts and pose_acc equal and errors
     within PAR_TOL. Times: ms per DDP step (two processes sharing one
     card: not a scaling number), ms and bytes of the gradient all-reduce
     (gloo and NCCL), ms per ray-sharded frame and per all_gather, ms per
     multi-process eval query and per metric gather.
 17. retrieval.pipeline with netvlad (VGG16 conv5_3, 64 x 512 clusters,
     whitening 32768 -> 4096) and dir (ResNet101, GeM, fc 2048) at full
     width with seeded random weights, on phase 14's and phase 15's
     written scenes (PNG and JPEG frames), on the card and then on the
     CPU: every top-k list equal, or equal up to ties (position by
     position the two entries' CPU similarities within 2 eps + 1e-5, eps
     the largest distance of a card descriptor from its CPU one), the
     descriptors' cosine within RETRIEVAL_COS of 1; ms per frame of the
     model at batch 8, 224x224, and peak memory.
 18. offline scene preparation on the card: (a) a raw 7-Scenes-layout
     scene written by data.synthetic.write_seven_scenes_raw at the
     dataset's 640x480 and the preprocessor's own f = 525, cx 320, cy 240
     (two train sequences and one test sequence of PREP_FRAMES frames;
     the cut is the frame count), preprocess.seven_scenes at its defaults
     (voxel 0.02, stride 5) with --device cuda, the counters set to 0 just
     before it and read just after (exactly one tsdf launch per fused
     frame, no fused_agg launch), then with --device cpu on a copy of the
     raw scene: the card's volume (tsdf, weight, r, g, b) bit-equal to the
     host copy's after the last frame, both pkls and pc.ply byte-equal;
     one more frame whose camera sits inside the volume near its low-z
     face, one float32 step in front of a plane of voxel centres (the
     kernel's brick culling meets the slab where projections leave the int
     range): one launch, the volume bit-equal to the host copy's, the
     overflow counts equal and not 0; the share of bricks that the host
     mirror of the kernel's brick test keeps (brick_keep_mask: a prediction,
     printed in the phase's text, not in the kernels line); the kernel's device ms per frame (CUDA
     events around each launch, behind a sleep kernel so that the host's
     set-up is not timed, on a fresh volume, frames on the card; median
     over two passes), its bound
     (the updated voxels' 40 bytes and the frame's own bytes at 3.35 TB/s,
     or its float operations at the FP32 peak, whichever is larger), voxels
     per second, the host copy's ms per frame, peak memory, the end-to-end
     time split into frame reads, percentiles, bounds, integration,
     extraction and writes; (b) retrieval.pipeline (netvlad, seeded
     weights) on the preprocessed scene, cli.train one epoch at
     configs/7scenes_all.yaml (its data YAML's tempo_interval PREP_TEMPO
     leaves a few steps; exactly 3 bf16 fused_agg launches each), cli.test
     on its two test queries (exactly 55 each); (c) the 12-Scenes, OnePose
     and Cambridge (--no-mvs) preprocessors on raw scenes of their own
     layouts and sizes, and their outputs and a COLMAP workspace through
     build_dataset at configs/12scenes/apt1_kitchen.yaml,
     onepose/0447.yaml, cambridge/KingsCollege.yaml and (colmap)
     7scenes_all.yaml: every item finite, at its config's shapes.
 19. the options that are off by default: (a) on a 32x32, V=3 context
     (dense S=8, 64 rays, same weights) render_image_rays under each render
     option (knn_mode 'flat'; 'ray' with the gather and with
     geo_assembly='onehot'; use_merged_table; table_dtype='int8';
     prune_views=2) on CUDA against the CPU within PATH_TOL, masks equal;
     localize_forward with simple_3d_model, with keypoints_3d_source='sfm'
     (200 seeded points3d) and at 40x40 support views (DepthFusionNet's
     antialiased resize), CUDA against CPU; (b) at full width (default
     Config at compute_dtype_of: bf16, V=5 at 240x320, 4096 rays dense-64,
     one scene context per option) each render option: exactly 1 bf16
     fused_agg launch per render_rays call, renders finite with rgb in
     [0, 1] and depth in [0, far], the median ms/call over 5 and peak
     memory; then against the default option on the same rays, at the JAX
     tests' bounds: the merged table, the int8 tables and knn_mode 'flat'
     (rgb max 0.05, mean 0.01; flat's depth within 0.5), prune_views=5
     against the unpruned render at f32 (2e-4 rel + 2e-5; printed at
     bf16); (c) at full width, localize_forward and one make_train_step
     step with simple_3d_model (0 launches each, the pose a rotation) and
     with keypoints_3d_source='sfm' over 8192 seeded points3d (2 bf16
     launches per query, 3 per step, every keypoint a valid SfM point),
     losses finite, the median ms over 5 queries and 5 steps.
The last lines are a `kernels` JSON object (fused_agg, fused_agg_bf16 and
tsdf_integrate, the kernel of phase 18, which replaces host code of the
JAX package rather than a TPU kernel), the card's name and power limit,
and {"ok": true, "device": {...}}. Without CUDA it exits 2 and
prints no result. `chip_smoke.py --worker <spec.json>` is one process of
phase 16 (the script starts it).
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, dense
# TF32 and bf16 on the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
RENDER_N, RENDER_K = 262144, 8   # 4096 rays x 64 samples, 8 neighbours
RENDER_RAYS, RENDER_CHUNK = 4096, 2048
TRAIN_N = 1024 * 64              # N_rand rays x 64 samples of the train render
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
REFINE_N = 512 * 64              # refinement rays x 64 samples
# per eval query: query_coarse and query_fine (2), the cascade's query_fine
# (1), 50 refinement steps and the losses before and after them (52)
EVAL_LAUNCHES, REFINE_LAUNCHES = 55, 52
EVAL_WARMUP, EVAL_QUERIES = 2, 5
# phase 14: the 7-Scenes frame size, two scenes; 10 retrieved views per
# frame for n_views_test
CLI_H, CLI_W, CLI_TRAIN, CLI_TEST, CLI_SUPPORT = 480, 640, 16, 2, 10
CLI_SCENES = ("box0", "box1")
# phase 15: two OnePose-layout objects at OnePose's 512x512 and one
# 12-Scenes-layout scene at its 1296x968 colour frames; 20 train and 2 test
# frames each
FT_OBJECTS = ("0447-synthetic-box", "0450-synthetic-box")
FT_JPEG_SCENE = "apt1/kitchen"
FT_OBJ_HW, FT_TRAIN, FT_TEST, FT_SUPPORT = 512, 20, 2, 10
ATOL = RTOL = 1e-4       # f32 kernel vs plain version (different sum orders)
# bf16 kernel vs its plain version: both round to bf16 at the same points
# and differ in the order of their f32 sums, which moves a value across a
# bf16 rounding boundary now and then (on the CPU, f64 sums in the plain
# version move it by 0.05x its distance from f32, RMS, and 0.36x, max);
# the distance must stay within these shares of the plain version's own
# distance from f32
BF16_TOL, BF16_TOL_MAX = 0.2, 1.0
# CUDA path vs CPU path end to end: gathered neighbour features are rounded
# to bf16 as in the reference, so a last-bit f32 difference upstream (cuDNN
# vs CPU convolution sum order) can move a value across a bf16 rounding
# boundary, a 2^-9 relative step
PATH_TOL = 2e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"


def device_ms(fn, iters: int = 50) -> float:
    """Device time per call: a sleep kernel lets the host queue every call
    before the first starts, so host overhead does not count."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def agg_inputs(N: int, K: int, F: int, W: int, seed: int, dev, params=None):
    """Seeded fused-aggregation inputs (and weights unless given)."""
    import torch
    g = torch.Generator().manual_seed(seed)

    def rnd(*s, sc=1.0):
        return (torch.randn(*s, generator=g) * sc).to(dev)

    xyz = rnd(N, 3)
    nb_xyz = xyz[:, None] + rnd(N, K, 3, sc=0.1)
    nb_dir = rnd(N, K, 4)
    x = dict(xyz=xyz, direction=nb_dir[:, 0].contiguous(), mv_agg=rnd(N, W),
             nb_xyz=nb_xyz, nb_dir=nb_dir, nb_feat=rnd(N, K, F),
             scale=torch.tensor(7.0, device=dev))
    if params is None:
        NF, RD1, RD2 = 10, 16, 27
        fin = F + 3 + 6 * NF + RD2
        params = {"rd_w1": rnd(4, RD1, sc=0.5), "rd_b1": rnd(RD1, sc=0.1),
                  "rd_w2": rnd(RD1, RD2, sc=0.25), "rd_b2": rnd(RD2, sc=0.1),
                  "b_w0p": rnd(fin, W, sc=fin ** -0.5), "b_b0": rnd(W, sc=0.1),
                  "b_w1": rnd(W, W, sc=W ** -0.5), "b_b1": rnd(W, sc=0.1),
                  "b_w2": rnd(W, W, sc=W ** -0.5), "b_b2": rnd(W, sc=0.1),
                  "a_wq": rnd(W, 128, sc=W ** -0.5), "a_wk": rnd(W, 128, sc=W ** -0.5),
                  "a_wv": rnd(W, 128, sc=W ** -0.5), "a_wfc": rnd(128, W, sc=128 ** -0.5),
                  "ln_s": 1 + rnd(W, sc=0.1), "ln_b": rnd(W, sc=0.1)}
    x["params"] = params
    x["freqs"] = torch.tensor([2.0 ** i for i in range(10)], device=dev)
    return x


def agg_cost(N: int, K: int, F: int, W: int, params, freqs, act_bytes: int = 4):
    """(product FLOPs, other FLOPs, bytes) the fused aggregation needs:
    every input read once, the output written once; mv_agg and nb_feat
    take act_bytes each (2 in the bf16 instantiation), the rest is f32.
    With K=1 the softmax weight is 1, so the q and k products and the
    scores are not needed."""
    NF, HD = freqs.numel(), 128
    RD1, RD2 = params["rd_w1"].shape[1], params["rd_w2"].shape[1]
    fin = F + 3 + 6 * NF + RD2
    n_kv = 2 if K > 1 else 1
    prod = (N * K * (2 * fin * W + 2 * 2 * W * W + n_kv * 2 * W * HD)
            + N * ((n_kv - 1) * 2 * W * HD + 2 * HD * W))
    other = (N * K * (2 * (4 * RD1 + RD1 * RD2) + 6 * NF + 3)
             + N * ((2 * 2 * K * HD if K > 1 else 0) + 8 * W))
    floats = (N * (3 + 4) + N * K * (3 + 4) + 1 + NF
              + sum(p.numel() for p in params.values()) + N * W)
    return prod, other, 4 * floats + act_bytes * (N * W + N * K * F)


def agg_bounds(cost, tc: str = "tf32"):
    """(FP32 bound ms, tensor-core bound ms, what bounds the latter): the
    larger of the operations over their peak (the products on the tf32 or
    bf16 tensor cores) and the bytes over HBM's."""
    prod, other, nbytes = cost
    f32_ms = max((prod + other) / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
    peak = {"tf32": PEAK_TF32_FLOPS, "bf16": PEAK_BF16_FLOPS}[tc]
    terms = {f"operations ({tc} tensor cores)": prod / peak,
             "operations (fp32 cores)": other / PEAK_F32_FLOPS,
             "bytes (hbm)": nbytes / PEAK_BYTES_PER_S}
    unit = max(terms, key=terms.get)
    return f32_ms, terms[unit] * 1e3, unit


def tile_info(N: int, K: int, rows: int, params, freqs, F: int, bf16: bool) -> dict:
    """One launch's tile: rows of a CTA, the CTAs of its cluster (0: none;
    a cluster's CTAs hold the weights once between them), its shared memory
    and ring stages (0 for a cluster tile: its weights are resident), and
    the weight bytes the launch reads from L2 by count
    (fused_agg.weight_stream_bytes), not measured."""
    from nerfloc_tpu_torch.ops import fused_agg as fa
    RD1, RD2 = params["rd_w1"].shape[1], params["rd_w2"].shape[1]
    smem, stages = fa.smem_plan(rows, fa.tile_samples(rows, K, bf16), K, F, freqs.numel(), RD1,
                                RD2, bf16=bf16)
    return {"tile_rows": rows, "cluster": fa.tile_cluster(rows, bf16), "smem_bytes": smem,
            "ring_stages": stages,
            "l2_weight_bytes_model": fa.weight_stream_bytes(N, K, rows, F, freqs.numel(), RD2,
                                                            bf16)}


def tile_text(info: dict) -> str:
    share = (f"clusters of {info['cluster']} CTAs holding the weights once, resident"
             if info["cluster"] else
             f"each weight stage serving all of them, {info['ring_stages']} ring stages")
    return (f"{info['tile_rows']} rows a CTA, {share}, {info['smem_bytes']} B shared memory, "
            f"{info['l2_weight_bytes_model'] / 1e6:.1f} MB of weights from L2 per launch "
            f"(counted)")


def check_fused_agg(dev):
    """Kernel vs plain version at the main path's shapes (every tile size),
    a ragged N, K that leave part of a tile empty and misalign its feature
    block (3) or span two softmax groups of 8 keys (12), the render shape,
    and one gradient. Returns the largest abs error."""
    import torch
    from nerfloc_tpu_torch.ops import fused_agg as fa
    worst = 0.0
    for N, K in ((1024, 8), (1024, 1), (1000, 8), (999, 1), (1001, 8), (512, 8), (300, 3),
                 (100, 12), (200, 12), (RENDER_N, RENDER_K)):
        x = agg_inputs(N, K, 195, 128, seed=N + K, dev=dev)
        with torch.no_grad():
            ref = fa.reference_agg(**x)
        plans = [0] if N == RENDER_N else [0, *fa.tile_options(K)]
        for rows in plans:
            out = fa.launch(**x, rows=rows)
            torch.cuda.synchronize()
            err = (out - ref).abs()
            bad = err > ATOL + RTOL * ref.abs()
            worst = max(worst, float(err.max()))
            print(f"fused_agg N={N} K={K} rows={rows or fa.tile_plan(N, K, fa._sm_count(dev))[0]}: "
                  f"max_abs_err={float(err.max()):.3g} (tol {ATOL}+{RTOL}*|ref|)")
            if bool(bad.any()) or not bool(torch.isfinite(out).all()):
                fail(f"fused_agg disagrees with reference_agg at N={N} K={K} rows={rows}")
        del x, ref
    # gradient: autograd.Function (kernel forward) vs the plain version
    x = agg_inputs(256, 8, 195, 128, seed=5, dev=dev)
    grads = []
    for use_kernel in (True, False):
        mv = x["mv_agg"].clone().requires_grad_(True)
        feat = x["nb_feat"].clone().requires_grad_(True)
        w1 = x["params"]["b_w1"].clone().requires_grad_(True)
        p = {**x["params"], "b_w1": w1}
        args = dict(x, mv_agg=mv, nb_feat=feat, params=p)
        out = (fa._FusedAgg.apply(*[args[k] for k in ("xyz", "direction", "mv_agg",
                                                      "nb_xyz", "nb_dir", "nb_feat",
                                                      "scale", "freqs")],
                                  *[p[k] for k in fa.PARAM_KEYS])
               if use_kernel else fa.reference_agg(**args))
        (out * torch.linspace(-1, 1, out.numel(), device=dev).view_as(out)).sum().backward()
        grads.append([mv.grad, feat.grad, w1.grad])
    for a, b in zip(*grads):
        if not torch.allclose(a, b, atol=ATOL, rtol=RTOL):
            fail("fused_agg gradient disagrees with the plain version's")
    print("fused_agg gradient (mv_agg, nb_feat, base_mlp fc1) matches reference_agg")
    return worst


def agg_inputs_bf16(x):
    """The bf16 instantiation's inputs: mv_agg and nb_feat rounded to bf16."""
    import torch
    return dict(x, mv_agg=x["mv_agg"].to(torch.bfloat16),
                nb_feat=x["nb_feat"].to(torch.bfloat16))


def rms(t) -> float:
    return float(t.float().pow(2).mean().sqrt())


def check_fused_agg_bf16(dev):
    """The bf16 instantiation against its plain version (kernel_agg, which
    rounds where the Pallas kernel at dt=bf16 rounds) at the query shapes
    (every tile size: the 16- and 32-row cluster tiles and the wide ones),
    ragged N (999 and 1001: a partial last tile and CTAs past N that only
    hold weights), K = 3 and 12, the small K > 1 launches the 32-row
    cluster tile takes (512 x 8, 200 x 12), and the render shape (the
    default tile and every wgmma tile); and
    the replayed backward (reference_agg in bf16) against autograd through
    it. bf16 cannot be held to f32 tolerances: the kernel's distance from
    the plain version must stay within BF16_TOL times the plain version's
    own distance from f32 (RMS, and max abs beside it). Returns the largest
    abs error."""
    import torch
    from nerfloc_tpu_torch.ops import fused_agg as fa
    worst = 0.0
    for N, K in ((1024, 8), (1024, 1), (1000, 8), (999, 1), (1001, 8), (512, 8), (300, 3),
                 (100, 12), (200, 12), (RENDER_N, RENDER_K)):
        x = agg_inputs(N, K, 195, 128, seed=N + K, dev=dev)
        xb = agg_inputs_bf16(x)
        with torch.no_grad():
            ref = fa.kernel_agg(**xb)
            ref32 = fa.reference_agg(**x)
        yard_rms, yard_max = rms(ref - ref32), float((ref - ref32).abs().max())
        plans = [0, *(r for r in fa.tile_options(K, bf16=True)
                      if N != RENDER_N or r >= fa.WGMMA_ROWS)]
        for rows in plans:
            out = fa.launch(**xb, rows=rows)
            torch.cuda.synchronize()
            e_rms, e_max = rms(out - ref), float((out - ref).abs().max())
            worst = max(worst, e_max)
            r = rows or fa.tile_plan(N, K, fa._sm_count(dev), bf16=True)[0]
            print(f"fused_agg bf16 N={N} K={K} rows={r}"
                  f"{f' (clusters of {fa.tile_cluster(r, True)})' if fa.tile_cluster(r, True) else ''}: "
                  f"vs plain rms {e_rms:.3g} max {e_max:.3g}; plain bf16 vs f32 rms "
                  f"{yard_rms:.3g} max {yard_max:.3g} (tol rms <= {BF16_TOL} x, "
                  f"max <= {BF16_TOL_MAX} x)")
            if not (bool(torch.isfinite(out).all()) and e_rms <= BF16_TOL * yard_rms
                    and e_max <= BF16_TOL_MAX * yard_max):
                fail(f"fused_agg bf16 disagrees with kernel_agg at N={N} K={K} rows={rows}")
        del x, xb, ref, ref32
    x = agg_inputs_bf16(agg_inputs(256, 8, 195, 128, seed=5, dev=dev))
    grads = []
    for use_kernel in (True, False):
        mv = x["mv_agg"].clone().requires_grad_(True)
        feat = x["nb_feat"].clone().requires_grad_(True)
        w1 = x["params"]["b_w1"].clone().requires_grad_(True)
        p = {**x["params"], "b_w1": w1}
        args = dict(x, mv_agg=mv, nb_feat=feat, params=p)
        out = (fa._FusedAgg.apply(*[args[k] for k in ("xyz", "direction", "mv_agg",
                                                      "nb_xyz", "nb_dir", "nb_feat",
                                                      "scale", "freqs")],
                                  *[p[k] for k in fa.PARAM_KEYS])
               if use_kernel else fa.reference_agg(**args, dtype=torch.bfloat16))
        (out * torch.linspace(-1, 1, out.numel(), device=dev).view_as(out)).sum().backward()
        grads.append([mv.grad, feat.grad, w1.grad])
    for a, b in zip(*grads):
        if not torch.equal(a, b):
            fail("fused_agg bf16 gradient differs from the replayed reference_agg's")
    print("fused_agg bf16 gradient (mv_agg, nb_feat, base_mlp fc1) equals reference_agg(bf16)'s")
    return worst


def small_query_vs_cpu(dev):
    """The CUDA path (kernels) against the CPU path (plain versions) on a
    32x32, V=3 query with the same weights and noise."""
    import torch
    from nerfloc_tpu_torch.configs import Config, MatchingConfig, RenderConfig
    from nerfloc_tpu_torch.data import device_batch, make_query_batch
    from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
    from nerfloc_tpu_torch.solve.pnp import gumbel_noise
    cfg = Config(backbone2d_fpn_dim=32, model_3d_hidden_dim=32, matcher_hidden_dim=48,
                 n_views_test=3, render=RenderConfig(fused_query_agg=True),
                 matching=MatchingConfig(fine_num_3d_keypoints=32,
                                         coarse_num_3d_keypoints=32))
    nb = device_batch(make_query_batch(n_views=3, H=32, W=32, seed=0))
    outs = []
    for d in (torch.device("cpu"), dev):
        m = NerfPoseEstimator(cfg, device=d, seed=3)
        b = to_device_batch(nb, d)
        g = torch.Generator().manual_seed(11)
        kp = gumbel_noise((m.n_coarse_points(b),), g, "cpu").to(d)
        pnp = gumbel_noise((cfg.shapes.pnp_hypotheses, 32), g, "cpu").to(d)
        outs.append({k: v.cpu() for k, v in
                     m.localize_forward(b, kp_gumbel=kp, pnp_gumbel=pnp).items()})
    cpu, gpu = outs
    # PATH_TOL, wider than the kernel's own bound (see there)
    for k, tol in (("desc_3d", PATH_TOL), ("score_matrix", PATH_TOL), ("mkps2d", 1e-2)):
        err = float((cpu[k] - gpu[k]).abs().max())
        print(f"small query {k}: cuda vs cpu max_abs_err={err:.3g} (tol {tol})")
        if not err <= tol:
            fail(f"small query {k} differs between CUDA and CPU by {err}")
    if not torch.equal(cpu["match_j"], gpu["match_j"]):
        fail("small query match_j differs between CUDA and CPU")


def seeded_rays(batch, n: int, seed: int):
    """n rays of the query view through seeded uniform pixels."""
    import torch
    from nerfloc_tpu_torch.geometry.cameras import rays_for_pixels
    H, W = batch["image"].shape[:2]
    g = torch.Generator().manual_seed(seed)
    uv = torch.stack([torch.rand(n, generator=g) * (W - 1),
                      torch.rand(n, generator=g) * (H - 1)], dim=-1)
    return rays_for_pixels(uv.to(batch["K"].device), batch["K"], batch["pose"])


def small_render_vs_cpu(dev):
    """render_image_rays on CUDA (kernel) against the CPU (plain versions)
    on a 32x32, V=3 context with the same weights: dense S=8 and guided
    4+4 (N_guide 8), 64 rays."""
    import torch
    from nerfloc_tpu_torch.configs import Config, MatchingConfig, RenderConfig
    from nerfloc_tpu_torch.data import device_batch, make_query_batch
    from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
    nb = device_batch(make_query_batch(n_views=3, H=32, W=32, seed=0))
    for kind, render in (("dense", RenderConfig(fused_query_agg=True, N_samples=8)),
                         ("guided", RenderConfig(fused_query_agg=True, N_samples=4,
                                                 N_importance=4, N_guide=8))):
        cfg = Config(backbone2d_fpn_dim=32, model_3d_hidden_dim=32, matcher_hidden_dim=48,
                     n_views_test=3, render=render,
                     matching=MatchingConfig(fine_num_3d_keypoints=32,
                                             coarse_num_3d_keypoints=32))
        outs = []
        for d in (torch.device("cpu"), dev):
            m = NerfPoseEstimator(cfg, device=d, seed=3)
            b = to_device_batch(nb, d)
            outs.append({k: v.cpu() for k, v in
                         m.render_image_rays(b, *seeded_rays(b, 64, seed=5)).items()})
        cpu, gpu = outs
        for k in ("rgb", "depth", "weights", "feat"):
            err = float((cpu[k] - gpu[k]).abs().max())
            print(f"small render {kind} {k}: cuda vs cpu max_abs_err={err:.3g} "
                  f"(tol {PATH_TOL})")
            if not err <= PATH_TOL:
                fail(f"small render {kind} {k} differs between CUDA and CPU by {err}")
        if not torch.equal(cpu["mask"], gpu["mask"]):
            fail(f"small render {kind} mask differs between CUDA and CPU")


def check_render_out(out, n_rays: int, S: int, far: float, what: str):
    import torch
    shapes = {"rgb": (n_rays, 3), "depth": (n_rays,), "weights": (n_rays, S)}
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape or not bool(torch.isfinite(out[k]).all()):
            fail(f"{what}: {k} malformed ({tuple(out[k].shape)}, expected {shape})")
    rgb, depth = out["rgb"], out["depth"]
    if float(rgb.min()) < -1e-4 or float(rgb.max()) > 1 + 1e-4:
        fail(f"{what}: rgb outside [0, 1] ({float(rgb.min())}, {float(rgb.max())})")
    if float(depth.min()) < 0 or float(depth.max()) > far:
        fail(f"{what}: depth outside [0, far={far}]")


class StageTimer:
    """CUDA events around wrapped functions, by stage name: the device time
    of each stage inside a real call."""

    def __init__(self):
        import torch
        self.torch = torch
        self.events = defaultdict(list)
        self.undo = []

    def wrap(self, owner, attr: str, name: str):
        fn = getattr(owner, attr)

        def run(*a, **kw):
            start, end = (self.torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*a, **kw)
            end.record()
            self.events[name].append((start, end))
            return out
        had = attr in vars(owner)
        self.undo.append((owner, attr, getattr(owner, attr) if had else None, had))
        setattr(owner, attr, run)

    def restore(self):
        for owner, attr, old, had in reversed(self.undo):
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)

    def take(self):
        """{stage: (ms, calls)} of the events recorded since the last take()."""
        self.torch.cuda.synchronize()
        out = {k: (sum(s.elapsed_time(e) for s, e in v), len(v))
               for k, v in self.events.items()}
        self.events.clear()
        return out


def render_full_width(dev, card: str):
    """Phases 7-8: render_rays at full width, dense-64 and guided 16+16,
    then render_image of one frame. Returns the numbers for `kernels`."""
    import torch
    from nerfloc_tpu_torch.configs import Config, RenderConfig
    from nerfloc_tpu_torch.data import device_batch, make_query_batch
    from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
    from nerfloc_tpu_torch.ops import fused_agg as fa
    H, W = 240, 320
    batch = to_device_batch(device_batch(make_query_batch(n_views=5, H=H, W=W, seed=0)),
                            dev)
    far = float(batch["far"])
    rays = seeded_rays(batch, RENDER_RAYS, seed=0)
    res = {}
    for kind, render in (("dense", RenderConfig(fused_query_agg=True)),
                         ("guided", RenderConfig(fused_query_agg=True, N_samples=16,
                                                 N_importance=16))):
        model = NerfPoseEstimator(Config(render=render), device=dev, seed=0)
        nerf = model.model_3d
        S = render.N_samples + render.N_importance
        with torch.no_grad():
            ctx, _ = model.build_context(batch)

            def call():
                return nerf.render_rays(ctx, *rays, batch["pose"])
            for _ in range(2):
                call()
            torch.cuda.synchronize()
            fa.LAUNCHES.n = 0
            out = call()
            torch.cuda.synchronize()
            launches = fa.LAUNCHES.n
            print(f"render {kind} ({render.N_samples}+{render.N_importance}): fused_agg "
                  f"launches per render_rays call = {launches}")
            if launches != 1:
                fail(f"expected 1 fused_agg launch per render_rays call, got {launches}")
            check_render_out(out, RENDER_RAYS, S, far, f"render_rays {kind}")
            print(f"render {kind}: mask share {float(out['mask'].float().mean()):.3f}, "
                  f"depth mean {float(out['depth'].mean()):.4f}")
            torch.cuda.reset_peak_memory_stats()
            times = []
            for _ in range(10):
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms = statistics.median(times)
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"render_rays {kind} V=5 {H}x{W}, {RENDER_RAYS} rays x {S} samples: "
                  f"median {ms:.2f} ms/call over 10 (min {min(times):.2f}, max "
                  f"{max(times):.2f}), {RENDER_RAYS / ms * 1e3:.0f} rays/s; peak memory "
                  f"{peak:.2f} GiB; {card}")
            res[f"render_{kind}_ms_per_call"] = ms
            if kind == "dense":
                T = StageTimer()
                T.wrap(fa, "launch", "fused_agg")
                try:
                    call()
                finally:
                    T.restore()
                k_ms, n = T.take()["fused_agg"]
                print(f"render dense: fused_agg inside one call {k_ms:.4f} ms over {n} "
                      f"launch ({100 * k_ms / ms:.1f} % of the call); {card}")
                res["render_launches_per_call"] = launches
                res["render_kernel_ms_in_call"] = k_ms

                def frame():
                    return nerf.render_image(ctx, batch["K"], batch["pose"], H, W)
                torch.cuda.synchronize()
                fa.LAUNCHES.n = 0
                img = frame()
                torch.cuda.synchronize()
                n_img = fa.LAUNCHES.n
                want = -(-H * W // RENDER_CHUNK)
                if nerf.cfg.render.chunk != RENDER_CHUNK or n_img != want:
                    fail(f"render_image: expected {want} launches, got {n_img}")
                for k, v in img.items():
                    if tuple(v.shape[:2]) != (H, W):
                        fail(f"render_image {k} has shape {tuple(v.shape)}")
                check_render_out({k: v.reshape((H * W,) + v.shape[2:]) for k, v in img.items()},
                                 H * W, S, far, "render_image")
                del img
                times = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    frame()
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                frame_ms = statistics.median(times)
                print(f"render_image {H}x{W} in chunks of {nerf.cfg.render.chunk}: median "
                      f"{frame_ms:.2f} ms/frame over 3 after one warm-up frame (min "
                      f"{min(times):.2f}, max {max(times):.2f}), {H * W / frame_ms * 1e3:.0f} "
                      f"rays/s, fused_agg launches {n_img}; {card}")
                res["render_image_ms_per_frame"] = frame_ms
        del model, nerf, ctx, out
        torch.cuda.empty_cache()
    return res


def check_pose(pose, what: str):
    import torch
    R = pose[:3, :3].double()
    if not bool(torch.isfinite(pose).all()):
        fail(f"{what}: non-finite pose")
    ortho = float((R @ R.T - torch.eye(3, dtype=R.dtype, device=R.device)).abs().max())
    det = float(torch.linalg.det(R))
    if ortho > 1e-3 or abs(det - 1.0) > 1e-3:
        fail(f"{what}: pose not a rotation (ortho {ortho}, det {det})")


def pnp_fixture(dev):
    """Known-good correspondences (query depth back-projected through the
    GT pose) must give the pose back."""
    import torch
    from nerfloc_tpu_torch.data import device_batch, make_query_batch
    from nerfloc_tpu_torch.geometry.se3 import compute_pose_error
    from nerfloc_tpu_torch.solve.pnp import ransac_pnp
    b = {k: torch.as_tensor(v).to(dev) for k, v in
         device_batch(make_query_batch(n_views=3, H=32, W=32, seed=0)).items()}
    H, W = b["image"].shape[:2]
    gy, gx = torch.meshgrid(torch.arange(4, H - 4, 4, dtype=torch.float32, device=dev),
                            torch.arange(4, W - 4, 4, dtype=torch.float32, device=dev),
                            indexing="ij")
    uv = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
    d = b["depth"][uv[:, 1].long(), uv[:, 0].long()]
    pc = (torch.cat([uv, torch.ones_like(uv[:, :1])], -1) @ torch.linalg.inv(b["K"]).T) \
        * d[:, None]
    pw = pc @ b["pose"][:3, :3].T + b["pose"][:3, 3]
    g = torch.Generator(device=dev).manual_seed(7)
    res = ransac_pnp(uv, pw, d > 1e-3, b["K"], thresh_px=8.0, n_hyps=512, generator=g)
    rot, trans = (float(v) for v in compute_pose_error(res.c2w, b["pose"]))
    print(f"pnp fixture: rot_err={rot:.4g} deg trans_err={trans:.4g} m "
          f"success={bool(res.success)}")
    if not (bool(res.success) and rot < 0.5 and trans < 0.01):
        fail("PnP fixture did not recover the pose")


def tiny_cfg(**render):
    """The CPU tests' tiny config (__graft_entry__._tiny_cfg sizes), fused."""
    from nerfloc_tpu_torch.configs import Config, MatchingConfig, RenderConfig
    return Config(backbone2d_fpn_dim=32, model_3d_hidden_dim=32, matcher_hidden_dim=48,
                  n_views_train=3, n_views_test=3,
                  render=RenderConfig(N_samples=8, N_rand=32, chunk=64, fused_query_agg=True,
                                      **render),
                  matching=MatchingConfig(fine_num_3d_keypoints=32,
                                          coarse_num_3d_keypoints=32))


def train_noise(model, batch, seed: int):
    """Seeded (kp_gumbel [B, P], ray_idx [B, N_rand]) for a batch with a
    leading axis B, drawn on the CPU."""
    import torch
    from nerfloc_tpu_torch.solve.pnp import gumbel_noise
    B, H, W = batch["image"].shape[:3]
    g = torch.Generator().manual_seed(seed)
    P = model.n_coarse_points({k: v[0] for k, v in batch.items()})
    kp = gumbel_noise((B, P), g, "cpu")
    idx = torch.stack([torch.randperm(H * W, generator=g)[:model.cfg.render.N_rand]
                       for _ in range(B)])
    return kp, idx


def small_train_vs_cpu(dev):
    """Phase 9a: one tiny train step on CUDA (kernel) against the CPU
    (plain versions), same weights and noise; the loss, its terms and every
    parameter gradient within PATH_TOL of their scale. The gradient bound
    of a leaf adds three times its spread on the CPU alone: the largest
    change of that leaf's gradient when every weight moves by one f32
    rounding (2^-22 relative, two seeded draws of signs). Gathered
    neighbour features are rounded to bf16, so such a change moves some of
    them by a whole bf16 step (2^-9) and the fine-matching gradients by up
    to about 1 %; the CUDA path's own f32 differences do the same.
    Returns the fused_agg launches of the CUDA step."""
    import torch
    from nerfloc_tpu_torch.data import device_batch, make_query_batch, stack_batches
    from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
    from nerfloc_tpu_torch.ops import fused_agg as fa
    from nerfloc_tpu_torch.train.state import TrainState
    from nerfloc_tpu_torch.train.step import make_train_step
    cfg = tiny_cfg()
    nb = stack_batches([device_batch(make_query_batch(n_views=3, H=32, W=32, seed=0))])
    cpu = torch.device("cpu")
    runs = []
    for d, perturb in ((cpu, 0), (dev, 0), (cpu, 1), (cpu, 2)):
        m = NerfPoseEstimator(cfg, device=d, seed=3)
        if perturb:
            perturb_(m, perturb)
        b = to_device_batch(nb, d)
        kp, idx = train_noise(m, b, seed=11)
        fa.LAUNCHES.n = 0
        metrics = make_train_step(m, cfg)(TrainState(m, cfg), b, kp_gumbel=kp.to(d),
                                          ray_idx=idx.to(d))
        launches = fa.LAUNCHES.n
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).double().cpu()
                 for n, p in m.named_parameters()}
        runs.append(({k: float(v) for k, v in metrics.items()}, grads, launches))
    (cpu_m, cpu_g, _), (gpu_m, gpu_g, launches) = runs[:2]
    spread = {n: max(float((r[1][n] - g).norm()) for r in runs[2:]) for n, g in cpu_g.items()}
    for k in ("loss", "coarse_loss", "fine_loss", "ref_depth_loss", "render_loss", "grad_norm"):
        err = abs(cpu_m[k] - gpu_m[k]) / max(abs(cpu_m[k]), 1e-12)
        print(f"small train {k}: cuda {gpu_m[k]:.6g} cpu {cpu_m[k]:.6g} rel err {err:.3g} "
              f"(tol {PATH_TOL})")
        if not err <= PATH_TOL:
            fail(f"small train {k} differs between CUDA and CPU by {err:.3g} relative")
    # per leaf |g_cuda - g_cpu| <= PATH_TOL |g_cpu| + 1e-8 |g_cpu|_all
    # (+ 3 spread): the second term covers leaves whose gradient is zero in
    # exact arithmetic (biases before a normalization or a softmax); the
    # worst relative errors are reported among the others
    total = sum(float(g.norm()) ** 2 for g in cpu_g.values()) ** 0.5
    errs = {n: (float((gpu_g[n] - g).norm()), float(g.norm())) for n, g in cpu_g.items()}
    plain = [n for n, (d, s) in errs.items() if d > PATH_TOL * s + 1e-8 * total]
    bad = [n for n in plain if errs[n][0] > PATH_TOL * errs[n][1] + 1e-8 * total + 3 * spread[n]]
    worst = sorted(((d / s, spread[n] / s, n) for n, (d, s) in errs.items()
                    if s > 1e-6 * total), reverse=True)[:5]
    print(f"small train gradients: {len(errs) - len(plain)} of {len(errs)} leaves within "
          f"{PATH_TOL} of their norm (+1e-8 of the total {total:.4g}), the other {len(plain)} "
          f"within it plus 3x their CPU spread; worst (relative error, relative CPU spread): "
          + ", ".join(f"{n} {e:.3g} {sp:.3g}" for e, sp, n in worst))
    if bad:
        fail("small train gradients differ between CUDA and CPU: " + ", ".join(
            f"{n} {errs[n][0]:.3g} of {errs[n][1]:.3g}" for n in bad))
    print(f"small train: fused_agg launches in the CUDA step = {launches}")
    if launches != 3:
        fail(f"expected 3 fused_agg launches in a train step, got {launches}")
    return launches


def check_fused_agg_train_shape(dev, card: str):
    """Phase 9b: kernel forward and replayed backward at the render train
    shape against reference_agg under autograd (every differentiable
    input: mv_agg, nb_feat and the weights); then the forward's kernel and
    plain-version times and bounds there. Returns (max abs error, times)."""
    import torch
    from nerfloc_tpu_torch.ops import fused_agg as fa
    x = agg_inputs(TRAIN_N, RENDER_K, 195, 128, seed=9, dev=dev)
    cot = torch.randn(TRAIN_N, 128, generator=torch.Generator().manual_seed(1)).to(dev)
    res = []
    for use_kernel in (True, False):
        leaves = {"mv_agg": x["mv_agg"].clone().requires_grad_(True),
                  "nb_feat": x["nb_feat"].clone().requires_grad_(True),
                  **{k: v.clone().requires_grad_(True) for k, v in x["params"].items()}}
        args = dict(x, mv_agg=leaves["mv_agg"], nb_feat=leaves["nb_feat"],
                    params={k: leaves[k] for k in fa.PARAM_KEYS})
        if use_kernel:
            out = fa._FusedAgg.apply(*[args[k] for k in ("xyz", "direction", "mv_agg", "nb_xyz",
                                                         "nb_dir", "nb_feat", "scale", "freqs")],
                                     *[args["params"][k] for k in fa.PARAM_KEYS])
        else:
            out = fa.reference_agg(**args)
        grads = torch.autograd.grad(out, list(leaves.values()), cot)
        res.append((out.detach(), dict(zip(leaves, grads))))
        del out, grads, leaves, args
    (out, g), (ref, g_ref) = res
    err = float((out - ref).abs().max())
    worst = max(float((g[k] - g_ref[k]).abs().max()) for k in g)
    bad = [k for k in g if not torch.allclose(g[k], g_ref[k], atol=ATOL, rtol=RTOL)]
    print(f"fused_agg train shape N={TRAIN_N} K={RENDER_K}: forward max_abs_err={err:.3g}, "
          f"backward max_abs_err={worst:.3g} over {len(g)} inputs (tol {ATOL}+{RTOL}*|ref|)")
    if not torch.allclose(out, ref, atol=ATOL, rtol=RTOL) or bad:
        fail(f"fused_agg at the train shape disagrees with reference_agg ({bad or 'forward'})")
    with torch.no_grad():
        k_ms = device_ms(lambda: fa.launch(**x), iters=10)
        p_ms = device_ms(lambda: fa.reference_agg(**x), iters=5)
    cost = agg_cost(TRAIN_N, RENDER_K, 195, 128, x["params"], x["freqs"])
    f32_ms, b_ms, unit = agg_bounds(cost)
    if k_ms < b_ms:
        fail(f"fused_agg at the train shape reads faster than its bound ({k_ms} < {b_ms} ms)")
    print(f"fused_agg train shape N={TRAIN_N} K={RENDER_K}: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms, bound {b_ms:.4f} ms by {unit} ({100 * b_ms / k_ms:.1f} %), FP32 "
          f"bound {f32_ms:.4f} ms; {card}")
    return err, {"train_ms": k_ms, "train_plain_ms": p_ms, "train_bound_ms": b_ms,
                 "train_bound_f32_ms": f32_ms}


def launch_counts():
    """(f32, bf16) fused_agg launches since the counters were last set to 0."""
    from nerfloc_tpu_torch.ops import fused_agg as fa
    return fa.LAUNCHES.n, fa.LAUNCHES_BF16.n


def zero_launch_counts():
    """Sets every kernel's launch count to 0 (fused_agg's and tsdf's)."""
    from nerfloc_tpu_torch.native import tsdf
    from nerfloc_tpu_torch.ops import fused_agg as fa
    fa.LAUNCHES.n = fa.LAUNCHES_BF16.n = tsdf.LAUNCHES.n = 0


def expect_launches(n: int, bf16: bool, what: str):
    """Exactly n launches of the instantiation of the compute dtype since
    the counters were set to 0, and none of the other."""
    n32, n16 = launch_counts()
    got, other = (n16, n32) if bf16 else (n32, n16)
    if got != n or other != 0:
        fail(f"{what}: expected {n} {'bf16' if bf16 else 'f32'} fused_agg launches and 0 of "
             f"the other instantiation, got {got} and {other}")
    return got


def train_full_width(dev, card: str, dtype=None):
    """Phase 9c (13c at bf16): make_train_step at full width at compute
    dtype `dtype` (f32 by default). Returns its numbers."""
    import torch
    from nerfloc_tpu_torch.configs import Config, RenderConfig
    from nerfloc_tpu_torch.data import device_batch, make_query_batch, stack_batches
    from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
    from nerfloc_tpu_torch.train.state import TrainState
    from nerfloc_tpu_torch.train.step import make_train_step
    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    tag = "bf16 " if bf16 else ""
    cfg = Config(render=RenderConfig(fused_query_agg=True))
    model = NerfPoseEstimator(cfg, device=dev, seed=0, dtype=dtype)
    batch = to_device_batch(stack_batches([device_batch(make_query_batch(
        n_views=5, H=240, W=320, seed=0))]), dev)
    state = TrainState(model, cfg)
    step = make_train_step(model, cfg)
    kp0, idx0 = (v.to(dev) for v in train_noise(model, batch, seed=0))

    def first_noise_loss():
        with torch.no_grad():
            return float(model.train_forward({k: v[0] for k, v in batch.items()},
                                             kp_gumbel=kp0[0], ray_idx=idx0[0])["loss"])
    loss_before = first_noise_loss()
    torch.cuda.reset_peak_memory_stats()
    times, losses, launches = [], [], []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        kp, idx = (kp0, idx0) if i == 0 else \
            (v.to(dev) for v in train_noise(model, batch, seed=i))
        torch.cuda.synchronize()
        zero_launch_counts()
        t0 = time.perf_counter()
        metrics = step(state, batch, kp_gumbel=kp, ray_idx=idx)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches.append(expect_launches(3, bf16, f"{tag}train step {i}"))
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        print(f"{tag}train step {i}{' (warm-up)' if i < TRAIN_WARMUP else ''}: loss {loss:.6g} "
              f"grad_norm {gnorm:.6g} matching_iou {float(metrics['matching_iou']):.4f} "
              f"psnr {float(metrics['psnr']):.3f} fused_agg launches {launches[-1]} "
              f"{ms:.2f} ms")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"{tag}train step {i}: loss {loss} or grad_norm {gnorm} not finite")
        losses.append(loss)
        if i >= TRAIN_WARMUP:
            times.append(ms)
    peak = torch.cuda.max_memory_allocated() / 2**30
    loss_after = first_noise_loss()
    print(f"{tag}train: loss at the first step's noise {loss_before:.6g} before, "
          f"{loss_after:.6g} after {len(losses)} steps")
    if not loss_after < loss_before:
        fail(f"{tag}train: loss did not fall ({loss_before} -> {loss_after})")
    ms = statistics.median(times)
    V, H, W = batch["topk_images"].shape[1:4]
    print(f"{tag}train step V={V} {H}x{W}, B=1, {cfg.matching.fine_num_3d_keypoints} keypoints, "
          f"{cfg.render.N_rand} rays x {cfg.render.N_samples} samples: median "
          f"{ms:.2f} ms/step over {TRAIN_STEPS} (min {min(times):.2f}, max {max(times):.2f}), "
          f"{1e3 / ms:.3f} steps/s; peak memory {peak:.2f} GiB; {card}")
    del model, state, batch
    torch.cuda.empty_cache()
    return {"train_ms_per_step": ms, "train_launches_per_step": launches[-1],
            "train_peak_gib": peak, "train_loss_before": loss_before,
            "train_loss_after": loss_after}


def eval_cfg(base=None, **kw):
    """The eval path's config: `base` (default: the full-width Config with
    render.fused_query_agg=True) with cascade matching and photometric
    refinement on, and any field of `kw` replaced."""
    import dataclasses
    from nerfloc_tpu_torch.configs import Config, RenderConfig
    base = base or Config(render=RenderConfig(fused_query_agg=True))
    return dataclasses.replace(base, cascade_matching=True, optimize_pose=True, **kw)


def eval_noise(model, batch, seed: int):
    """Seeded noise of make_eval_step's four streams for a batch with a
    leading axis B, drawn on the CPU."""
    import torch
    from nerfloc_tpu_torch.solve.pnp import gumbel_noise
    from nerfloc_tpu_torch.solve.pose_refine import sample_refine_pixels
    cfg = model.cfg
    B, H, W = batch["image"].shape[:3]
    g = torch.Generator().manual_seed(seed)
    P = model.n_coarse_points({k: v[0] for k, v in batch.items()})
    hyps = (B, cfg.shapes.pnp_hypotheses, cfg.matching.fine_num_3d_keypoints)
    return {"kp_gumbel": gumbel_noise((B, P), g, "cpu"),
            "pnp_gumbel": gumbel_noise(hyps, g, "cpu"),
            "pnp2_gumbel": gumbel_noise(hyps, g, "cpu"),
            "refine_uv": torch.stack([sample_refine_pixels(
                H, W, cfg.shapes.pose_refine_rays, generator=g) for _ in range(B)])}


def small_eval_vs_cpu(dev):
    """Phase 11a: the tiny eval step (cascade and refinement on, 128
    refinement rays) on CUDA (kernel) against the CPU (plain versions),
    same weights and noise, two queries. The model seed and the noise give
    each query 5 first-pass matches (a RANSAC minimal set from fewer than 3
    would take masked points: an ill-posed solve; the check asks for 4). Discrete outputs
    equal; poses and errors within PATH_TOL plus three times their spread
    on the CPU alone when every weight moves by one f32 rounding (the
    refinement's 50 Adam steps carry a change of the scene context on).
    Returns the CUDA step's fused_agg launches."""
    import torch
    from nerfloc_tpu_torch.configs import StaticShapeConfig
    from nerfloc_tpu_torch.data import device_batch, make_query_batch, stack_batches
    from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
    from nerfloc_tpu_torch.ops import fused_agg as fa
    from nerfloc_tpu_torch.train.step import make_eval_step
    cfg = eval_cfg(base=tiny_cfg(), shapes=StaticShapeConfig(pose_refine_rays=128))
    nb = stack_batches([device_batch(make_query_batch(n_views=3, H=32, W=32, seed=s))
                        for s in (0, 1)])
    cpu = torch.device("cpu")
    runs = []
    for d, perturb in ((cpu, 0), (dev, 0), (cpu, 1), (cpu, 2)):
        m = NerfPoseEstimator(cfg, device=d, seed=2)
        if perturb:
            perturb_(m, perturb)
        b = to_device_batch(nb, d)
        noise = {k: v.to(d) for k, v in eval_noise(m, b, seed=11).items()}
        fa.LAUNCHES.n = 0
        out = make_eval_step(m, cfg)(b, noise=noise)
        runs.append(({k: v.cpu() for k, v in out.items()}, fa.LAUNCHES.n))
    (cpu_o, _), (gpu_o, launches) = runs[:2]
    if int(cpu_o["num_matches"].min()) < 4:
        fail(f"small eval: the fixture's queries have {cpu_o['num_matches'].tolist()} "
             "matches, fewer than 4")
    for k in ("num_inliers", "num_matches", "pnp_success", "matching_iou"):
        if not torch.equal(cpu_o[k], gpu_o[k]):
            fail(f"small eval {k} differs between CUDA and CPU: {gpu_o[k]} vs {cpu_o[k]}")
    for k in ("pose_pred", "rot_err_deg", "trans_err_m"):
        err = float((cpu_o[k] - gpu_o[k]).abs().max())
        spread = max(float((r[0][k] - cpu_o[k]).abs().max()) for r in runs[2:])
        print(f"small eval {k}: cuda vs cpu max_abs_err={err:.3g} (tol {PATH_TOL} + 3 x "
              f"the CPU spread {spread:.3g})")
        if not err <= PATH_TOL + 3 * spread:
            fail(f"small eval {k} differs between CUDA and CPU by {err}")
    print(f"small eval: fused_agg launches in the CUDA step (2 queries) = {launches}")
    if launches != 2 * EVAL_LAUNCHES:
        fail(f"expected {2 * EVAL_LAUNCHES} fused_agg launches in the small eval step, "
             f"got {launches}")
    return launches


def check_fused_agg_refine_shape(dev, card: str):
    """Phase 11b: the kernel at the refinement shape (512 rays x 64
    samples, K=8) against reference_agg: the forward, and the replayed
    backward's gradients in the inputs the refinement differentiates (the
    samples' xyz and direction, their multiview feature) against autograd
    through the plain version; then the forward's kernel and plain-version
    times and bounds. Returns (max abs error, times)."""
    import torch
    from nerfloc_tpu_torch.ops import fused_agg as fa
    x = agg_inputs(REFINE_N, RENDER_K, 195, 128, seed=13, dev=dev)
    cot = torch.randn(REFINE_N, 128, generator=torch.Generator().manual_seed(2)).to(dev)
    keys = ("xyz", "direction", "mv_agg")
    res = []
    for use_kernel in (True, False):
        leaves = {k: x[k].clone().requires_grad_(True) for k in keys}
        args = {**x, **leaves}
        if use_kernel:
            out = fa._FusedAgg.apply(*[args[k] for k in ("xyz", "direction", "mv_agg", "nb_xyz",
                                                         "nb_dir", "nb_feat", "scale", "freqs")],
                                     *[x["params"][k] for k in fa.PARAM_KEYS])
        else:
            out = fa.reference_agg(**args)
        grads = torch.autograd.grad(out, list(leaves.values()), cot)
        res.append((out.detach(), dict(zip(keys, grads))))
        del out, grads, leaves, args
    (out, g), (ref, g_ref) = res
    err = float((out - ref).abs().max())
    worst = max(float((g[k] - g_ref[k]).abs().max()) for k in keys)
    bad = [k for k in keys if not torch.allclose(g[k], g_ref[k], atol=ATOL, rtol=RTOL)]
    print(f"fused_agg refine shape N={REFINE_N} K={RENDER_K}: forward max_abs_err={err:.3g}, "
          f"backward max_abs_err={worst:.3g} in {', '.join(keys)} (tol {ATOL}+{RTOL}*|ref|)")
    if not torch.allclose(out, ref, atol=ATOL, rtol=RTOL) or bad:
        fail(f"fused_agg at the refine shape disagrees with reference_agg ({bad or 'forward'})")
    with torch.no_grad():
        k_ms = device_ms(lambda: fa.launch(**x), iters=20)
        p_ms = device_ms(lambda: fa.reference_agg(**x), iters=10)
    f32_ms, b_ms, unit = agg_bounds(agg_cost(REFINE_N, RENDER_K, 195, 128, x["params"],
                                             x["freqs"]))
    if k_ms < b_ms:
        fail(f"fused_agg at the refine shape reads faster than its bound ({k_ms} < {b_ms} ms)")
    print(f"fused_agg refine shape N={REFINE_N} K={RENDER_K}: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms, bound {b_ms:.4f} ms by {unit} ({100 * b_ms / k_ms:.1f} %), FP32 "
          f"bound {f32_ms:.4f} ms; {card}")
    return max(err, worst), {"refine_ms": k_ms, "refine_plain_ms": p_ms,
                             "refine_bound_ms": b_ms, "refine_bound_f32_ms": f32_ms}


class EvalProbe:
    """Records, inside the real eval step, each stage's device time (CUDA
    events), the poses its stages return (the first and cascade PnP poses,
    the pose before and after refinement) and the fused_agg launches of the
    refinement."""

    def __init__(self, model):
        from nerfloc_tpu_torch.train import step as step_mod
        self.timer = StageTimer()
        self.poses = defaultdict(list)
        self.timer.wrap(model, "localize_parts", "localize")
        self.timer.wrap(model, "match_cascade", "cascade")
        self.timer.wrap(step_mod, "count_pose_inliers", "cascade")
        for attr, name in (("ransac_pnp", "pnp"), ("refine_pose", "refinement")):
            self._record(step_mod, attr, name)

    def _record(self, owner, attr: str, name: str):
        self.timer.wrap(owner, attr, name)
        timed = getattr(owner, attr)

        def run(*a, **kw):
            n0 = launch_counts()
            out = timed(*a, **kw)
            if name == "pnp":
                self.poses["pnp"].append(out.c2w)
            else:
                self.poses["refine_in"].append(a[1])
                self.poses["refine_out"].append(out)
                self.poses["refine_launches"].append(
                    tuple(b - a0 for a0, b in zip(n0, launch_counts())))
            return out
        setattr(owner, attr, run)

    def take(self):
        """(stage ms, first PnP poses, cascade PnP poses, poses into and out
        of refinement, refinement launches) since the last take(); the first
        PnP of a query counts as localization, the second as the cascade."""
        ev = self.timer.events
        pnp = ev.pop("pnp", [])
        ev["localize"] += pnp[0::2]
        ev["cascade"] += pnp[1::2]
        ms = {k: v for k, (v, _) in self.timer.take().items()}
        p, self.poses = self.poses, defaultdict(list)
        return (ms, p["pnp"][0::2], p["pnp"][1::2], p["refine_in"], p["refine_out"],
                p["refine_launches"])

    def restore(self):
        self.timer.restore()


def synthetic_items(seeds, H: int, W: int):
    """Query items of make_query_batch over two named scenes, as a
    sequence eval_dataset reads."""
    from nerfloc_tpu_torch.data import make_query_batch
    items = []
    for i, s in enumerate(seeds):
        it = make_query_batch(n_views=5, H=H, W=W, seed=s)
        it.update(scene=f"scene{i % 2}", filename=f"query{i}")
        items.append(it)
    return items


def eval_full_width(dev, card: str, dtype=None):
    """Phase 11c (13d at bf16): make_eval_step at full width at compute
    dtype `dtype` (f32 by default; default Config with
    render.fused_query_agg=True, cascade_matching=True, optimize_pose=True;
    V=5 at 240x320, seeded weights and noise), one query per step: 2
    warm-up queries and 5 timed ones, the launch counters set to 0 just
    before each and read just after (exactly EVAL_LAUNCHES of the dtype's
    instantiation, none of the other); the pose a rotation, the errors
    finite; the accepted cascade poses and refinements; then eval_dataset
    over 4 queries of 2 seeds (the last batch padded) and render_psnr_eval
    over one view. Returns its numbers."""
    import torch
    from nerfloc_tpu_torch.data import device_batch, stack_batches
    from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
    from nerfloc_tpu_torch.train.evaluate import (eval_dataset, make_render_psnr_fn,
                                                  render_psnr_eval)
    from nerfloc_tpu_torch.train.step import make_eval_step
    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    tag = "bf16 " if bf16 else ""
    H, W = 240, 320
    cfg = eval_cfg()
    model = NerfPoseEstimator(cfg, device=dev, seed=0, dtype=dtype)
    step = make_eval_step(model, cfg)
    items = synthetic_items(range(EVAL_WARMUP + EVAL_QUERIES), H, W)
    probe = EvalProbe(model)
    times, parts, launches, refine_launches = [], [], [], []
    accepted = {"cascade": 0, "refinement": 0}
    try:
        torch.cuda.reset_peak_memory_stats()
        for i, it in enumerate(items):
            batch = to_device_batch(stack_batches([device_batch(it)]), dev)
            noise = {k: v.to(dev) for k, v in eval_noise(model, batch, seed=100 + i).items()}
            torch.cuda.synchronize()
            zero_launch_counts()
            t0 = time.perf_counter()
            out = step(batch, noise=noise)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches.append(expect_launches(EVAL_LAUNCHES, bf16, f"{tag}eval query {i}"))
            stage_ms, pnp1, pnp2, ref_in, ref_out, ref_n = probe.take()
            refine_launches.append(ref_n[0][1 if bf16 else 0])
            pose = out["pose_pred"][0]
            check_pose(pose, f"{tag}eval query {i}")
            rot, trans = float(out["rot_err_deg"][0]), float(out["trans_err_m"][0])
            if not (math.isfinite(rot) and math.isfinite(trans)):
                fail(f"{tag}eval query {i}: errors not finite ({rot}, {trans})")
            if refine_launches[-1] != REFINE_LAUNCHES:
                fail(f"{tag}eval query {i}: expected {REFINE_LAUNCHES} fused_agg launches in "
                     f"refinement, got {refine_launches[-1]}")
            if not torch.equal(ref_out[0], pose):
                fail(f"{tag}eval query {i}: pose_pred is not the refinement's result")
            used_cascade = torch.equal(ref_in[0], pnp2[0]) and not torch.equal(pnp2[0], pnp1[0])
            refined = not torch.equal(ref_out[0], ref_in[0])
            accepted["cascade"] += used_cascade
            accepted["refinement"] += refined
            warm = i < EVAL_WARMUP
            print(f"{tag}eval query {i}{' (warm-up)' if warm else ''}: rot_err {rot:.4g} deg "
                  f"trans_err {trans:.4g} m inliers {int(out['num_inliers'][0])} matches "
                  f"{int(out['num_matches'][0])} matching_iou "
                  f"{float(out['matching_iou'][0]):.4f} cascade pose "
                  f"{'kept' if used_cascade else 'rejected'}, refinement "
                  f"{'accepted' if refined else 'rejected'}; fused_agg launches "
                  f"{launches[-1]} ({refine_launches[-1]} in refinement); {ms:.2f} ms "
                  f"(device: " + ", ".join(
                      f"{k} {v:.2f}" for k, v in stage_ms.items()) + ")")
            if not warm:
                times.append(ms)
                parts.append(stage_ms)
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        probe.restore()
    ms = statistics.median(times)
    part_ms = {k: statistics.median(p[k] for p in parts) for k in parts[0]}
    print(f"{tag}eval step V=5 {H}x{W}, cascade + refinement ({cfg.shapes.pose_refine_rays} rays "
          f"x {cfg.render.N_samples} samples, 50 Adam steps): median {ms:.2f} ms/query over "
          f"{len(times)} after {EVAL_WARMUP} warm-up queries (min {min(times):.2f}, max "
          f"{max(times):.2f}); device ms by stage (median): " + ", ".join(
              f"{k} {v:.2f}" for k, v in part_ms.items())
          + f"; fused_agg launches per query {launches[-1]}; accepted over "
          f"{EVAL_WARMUP + EVAL_QUERIES} queries: cascade poses {accepted['cascade']}, "
          f"refinements {accepted['refinement']}; peak memory {peak:.2f} GiB; {card}")

    table_items = synthetic_items((0, 1, 0, 1), H, W)
    res = eval_dataset(table_items, step, 3, {0: "scene0", 1: "scene1"}, cfg, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
    print(f"{tag}eval_dataset over 4 queries of 2 seeds (batches of 3): {json.dumps(res)}")
    for name, row in res.items():
        if not all(math.isfinite(v) for v in row.values()) or not 0 <= row["pose_acc"] <= 1:
            fail(f"{tag}eval_dataset row {name} malformed: {row}")
    if res["avg"]["n"] != 4 or res["avg"]["files"] != 4:
        fail(f"{tag}eval_dataset counted {res['avg']['n']} queries, expected 4")
    psnr = render_psnr_eval(make_render_psnr_fn(model), table_items, max_views=1)
    print(f"{tag}render_psnr_eval over one {H}x{W} view: {psnr}")
    if psnr.get("n_rendered") != 1 or not math.isfinite(psnr.get("psnr_test", math.nan)):
        fail(f"{tag}render_psnr_eval malformed: {psnr}")
    del model, step
    torch.cuda.empty_cache()
    return {"eval_ms_per_query": ms, "eval_part_ms": part_ms,
            "eval_launches_per_query": launches[-1],
            "refine_launches_per_query": refine_launches[-1], "eval_peak_gib": peak,
            "eval_accepted": accepted}


def small_paths_bf16_vs_cpu(dev):
    """The bf16 query and render on CUDA against the same on the CPU (V=3
    at 32x32, the same weights and noise): each output within the CPU's own
    bf16-vs-f32 distance (RMS). Both sides round to bf16 at the same points
    but sum in other orders (cuBLAS, cuDNN, the kernel), which moves values
    across bf16 rounding boundaries; a path that lost its bf16 rounding or
    its kernel would be as far off as f32 is."""
    import torch
    from nerfloc_tpu_torch.configs import Config, MatchingConfig, RenderConfig
    from nerfloc_tpu_torch.data import device_batch, make_query_batch
    from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
    from nerfloc_tpu_torch.solve.pnp import gumbel_noise
    nb = device_batch(make_query_batch(n_views=3, H=32, W=32, seed=0))
    cfg = Config(backbone2d_fpn_dim=32, model_3d_hidden_dim=32, matcher_hidden_dim=48,
                 n_views_test=3, render=RenderConfig(fused_query_agg=True, N_samples=8),
                 matching=MatchingConfig(fine_num_3d_keypoints=32,
                                         coarse_num_3d_keypoints=32))
    runs = {}
    for d, dt in ((torch.device("cpu"), torch.float32), (torch.device("cpu"), torch.bfloat16),
                  (dev, torch.bfloat16)):
        m = NerfPoseEstimator(cfg, device=d, seed=3, dtype=dt)
        b = to_device_batch(nb, d)
        g = torch.Generator().manual_seed(11)
        kp = gumbel_noise((m.n_coarse_points(b),), g, "cpu").to(d)
        pnp = gumbel_noise((cfg.shapes.pnp_hypotheses, 32), g, "cpu").to(d)
        with torch.no_grad():
            q = m.localize_forward(b, kp_gumbel=kp, pnp_gumbel=pnp)
            r = m.render_image_rays(b, *seeded_rays(b, 64, seed=5))
        runs[(d.type, dt)] = {**{k: q[k].float().cpu() for k in ("desc_3d", "score_matrix")},
                              **{k: r[k].float().cpu() for k in ("rgb", "depth", "weights")}}
    c32, c16 = runs[("cpu", torch.float32)], runs[("cpu", torch.bfloat16)]
    g16 = runs[("cuda", torch.bfloat16)]
    for k in c32:
        yard, err = rms(c16[k] - c32[k]), rms(g16[k] - c16[k])
        print(f"small bf16 {k}: cuda vs cpu rms {err:.3g} (max {float((g16[k] - c16[k]).abs().max()):.3g}); "
              f"cpu bf16 vs f32 rms {yard:.3g} (tol: below it)")
        if not err <= yard:
            fail(f"small bf16 {k}: CUDA is {err} from the CPU, the CPU's bf16 only {yard} from f32")


def bf16_full_width(dev, card: str):
    """The bf16 main paths at full width: localize_forward (exactly 2 bf16
    launches and no f32 one per query, the pose a rotation, the median
    ms/query over 10, peak memory) and render_rays of 4096 rays, dense-64
    and guided 16+16 (exactly 1 bf16 launch per call, renders finite with
    rgb in [0, 1], the median ms/call over 10, the kernel's device time
    inside one dense call). Default Config with render.fused_query_agg=True
    at its compute dtype (compute_dtype_of: bf16), V=5 at 240x320, seeded
    weights. Returns the numbers for `kernels`."""
    import torch
    from nerfloc_tpu_torch.configs import Config, RenderConfig, compute_dtype_of
    from nerfloc_tpu_torch.data import device_batch, make_query_batch
    from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
    from nerfloc_tpu_torch.ops import fused_agg as fa
    H, W = 240, 320
    batch = to_device_batch(device_batch(make_query_batch(n_views=5, H=H, W=W, seed=0)), dev)
    far = float(batch["far"])
    res = {}
    cfg = Config(render=RenderConfig(fused_query_agg=True))
    dt = compute_dtype_of(cfg)
    model = NerfPoseEstimator(cfg, device=dev, seed=0, dtype=dt)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):
        model.localize_forward(batch, generator=gen)
    torch.cuda.synchronize()
    zero_launch_counts()
    out = model.localize_forward(batch, generator=gen)
    torch.cuda.synchronize()
    n32, n16 = launch_counts()
    print(f"bf16 main path ({dt}): fused_agg launches per query bf16 = {n16}, f32 = {n32}")
    if n16 != 2 or n32 != 0:
        fail(f"expected 2 bf16 and 0 f32 fused_agg launches per bf16 query, got {n16} and {n32}")
    check_pose(out["pose"], "bf16 localize_forward")
    if out["score_matrix"].dtype != torch.bfloat16 or out["pose"].dtype != torch.float32:
        fail("bf16 localize_forward output dtypes differ from the JAX package's")
    print(f"bf16 main path: matches={int(out['match_mask'].sum())} "
          f"inliers={int(out['num_inliers'])} success={bool(out['pnp_success'])}")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        model.localize_forward(batch, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"bf16 localize_forward V=5 {H}x{W}: median {ms:.2f} ms/query over 10 (min "
          f"{min(times):.2f}, max {max(times):.2f}); peak memory {peak:.2f} GiB; {card}")
    res.update(localize_bf16_ms=ms, localize_bf16_peak_gib=peak, launches=n16)
    del model, out
    rays = seeded_rays(batch, RENDER_RAYS, seed=0)
    for kind, render in (("dense", RenderConfig(fused_query_agg=True)),
                         ("guided", RenderConfig(fused_query_agg=True, N_samples=16,
                                                 N_importance=16))):
        model = NerfPoseEstimator(Config(render=render), device=dev, seed=0, dtype=dt)
        nerf = model.model_3d
        S = render.N_samples + render.N_importance
        with torch.no_grad():
            ctx, _ = model.build_context(batch)

            def call():
                return nerf.render_rays(ctx, *rays, batch["pose"])
            for _ in range(2):
                call()
            torch.cuda.synchronize()
            zero_launch_counts()
            rout = call()
            torch.cuda.synchronize()
            n32, n16 = launch_counts()
            print(f"bf16 render {kind}: fused_agg launches per render_rays call bf16 = {n16}, "
                  f"f32 = {n32}")
            if n16 != 1 or n32 != 0:
                fail(f"expected 1 bf16 fused_agg launch per bf16 render_rays call, "
                     f"got {n16} (and {n32} f32)")
            check_render_out(rout, RENDER_RAYS, S, far, f"bf16 render_rays {kind}")
            times = []
            for _ in range(10):
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            ms = statistics.median(times)
            print(f"bf16 render_rays {kind} V=5 {H}x{W}, {RENDER_RAYS} rays x {S} samples: "
                  f"median {ms:.2f} ms/call over 10 (min {min(times):.2f}, max "
                  f"{max(times):.2f}), {RENDER_RAYS / ms * 1e3:.0f} rays/s; {card}")
            res[f"render_{kind}_bf16_ms"] = ms
            if kind == "dense":
                T = StageTimer()
                T.wrap(fa, "launch", "fused_agg")
                try:
                    call()
                finally:
                    T.restore()
                k_ms, n = T.take()["fused_agg"]
                print(f"bf16 render dense: fused_agg inside one call {k_ms:.4f} ms over {n} "
                      f"launch ({100 * k_ms / ms:.1f} % of the call); {card}")
                res["render_launches_per_call"] = n16
                res["render_kernel_ms_in_call"] = k_ms
        del model, nerf, ctx, rout
        torch.cuda.empty_cache()
    return res


def perturb_(model, seed: int) -> None:
    """Every weight moved by one f32 rounding (2^-22 relative), the signs
    drawn from `seed`."""
    import torch
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1 + 2.0 ** -22 * (torch.randint(0, 2, p.shape, generator=g) * 2 - 1).to(p.device))


def within_bf16_spread(name: str, gpu, cpu, cpu32, spreads, worst: list) -> bool:
    """CUDA bf16 against CPU bf16, the CPU's f32 beside them. Holds when
    rms(cuda - cpu) <= sqrt(rms(cpu - cpu32)^2 + the spreads^2): the CPU's
    own bf16-vs-f32 distance with the spread of each side under a 2^-22
    weight change added in quadrature (a bf16 result moves by up to a whole
    bf16 step when an f32 sum upstream ends in another last bit; where that
    moves a discrete choice downstream the spread is as large as the
    bf16-vs-f32 distance itself); or when the CUDA result is that close to
    the CPU's f32 result: the CPU sums the cotangent of a bf16 broadcast (a
    bias, normalization statistics) in bf16 as XLA's CPU backend does, the
    card in f32, so on such gradients the card's bf16 sits nearer f32."""
    d, ref = rms(gpu - cpu), rms(cpu - cpu32)
    bound = math.sqrt(ref ** 2 + sum(s ** 2 for s in spreads))
    d32 = rms(gpu - cpu32)
    worst.append((min(d, d32) / bound if bound else (0.0 if min(d, d32) == 0 else math.inf),
                  d / ref if ref else 0.0, name))
    return min(d, d32) <= bound


def small_steps_bf16_vs_cpu(dev):
    """Phase 13a: the tiny bf16 train step (B=1) and the tiny bf16 eval
    step (cascade and refinement on, 128 refinement rays, two queries) on
    CUDA (the bf16 kernel) against the same steps on the CPU (the plain
    versions), same weights and noise, and the CPU's f32 steps beside them:
    the loss, its terms and every gradient leaf, the poses and errors
    within_bf16_spread (ref_depth_loss also moves by
    1/#pixels for each decoded mean that rounds to the other side of the
    decoded depth's jump at d_inv == 0, counted here); at least half of the
    discrete eval outputs equal to the CPU's (PnP success all of them);
    the launches (3 per train step, 2 x 55 per eval step) all of the bf16
    instantiation. Returns the CUDA train step's launches."""
    import torch
    from nerfloc_tpu_torch.configs import StaticShapeConfig
    from nerfloc_tpu_torch.data import device_batch, make_query_batch, stack_batches
    from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
    from nerfloc_tpu_torch.train.state import TrainState
    from nerfloc_tpu_torch.train.step import make_eval_step, make_train_step
    cpu, bf = torch.device("cpu"), torch.bfloat16
    runs = (("cpu32", cpu, torch.float32, 0), ("cpu", cpu, bf, 0), ("cuda", dev, bf, 0),
            ("cpu+", cpu, bf, 1), ("cuda+", dev, bf, 1))

    # the train step
    cfg = tiny_cfg()
    nb = stack_batches([device_batch(make_query_batch(n_views=3, H=32, W=32, seed=0))])
    T = {}
    for name, d, dt, perturb in runs:
        m = NerfPoseEstimator(cfg, device=d, seed=3, dtype=dt)
        if perturb:
            perturb_(m, perturb)
        b = to_device_batch(nb, d)
        kp, idx = train_noise(m, b, seed=11)
        with torch.no_grad():
            ctx, _ = m.build_context({k: v[0] for k, v in b.items()})
            agg = m.model_3d.multiview_aggregator
            mean = agg.dist_decoder.predict_mean(ctx.sv.vis_featmaps)[..., 0].float().cpu()
        zero_launch_counts()
        metrics = make_train_step(m, cfg)(TrainState(m, cfg), b, kp_gumbel=kp.to(d),
                                          ray_idx=idx.to(d))
        counts = launch_counts()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).double().cpu()
                 for n, p in m.named_parameters()}
        T[name] = ({k: v.double().cpu() for k, v in metrics.items()}, grads, counts, mean,
                   (float(b["near"]), float(b["far"])))
        del m, ctx
    if T["cuda"][2] != (0, 3):
        fail(f"small bf16 train: expected 3 bf16 and 0 f32 fused_agg launches, got "
             f"{T['cuda'][2][1]} and {T['cuda'][2][0]}")
    near, far = T["cpu"][4]
    x0 = (1.0 / near) / ((-1.0 / far) + 1.0 / near)
    jumps = int(((T["cuda"][3] > x0) != (T["cpu"][3] > x0)).sum())
    worst, bad = [], []
    for k in ("loss", "coarse_loss", "fine_loss", "ref_depth_loss", "render_loss", "grad_norm"):
        v = {n: T[n][0][k] for n in T}
        extra = jumps / T["cpu"][3].numel() if k == "ref_depth_loss" else 0.0
        ok = within_bf16_spread(k, v["cuda"], v["cpu"], v["cpu32"],
                                (rms(v["cpu+"] - v["cpu"]), rms(v["cuda+"] - v["cuda"]), extra),
                                worst)
        print(f"small bf16 train {k}: cuda {float(v['cuda']):.6g} cpu {float(v['cpu']):.6g} "
              f"cpu f32 {float(v['cpu32']):.6g} (ratio to the bound {worst[-1][0]:.3f}"
              f"{f'; {jumps} decoded means across the jump' if extra else ''})")
        if not ok:
            bad.append(k)
    leaves = []
    for n in T["cpu"][1]:
        g = {r: T[r][1][n] for r in T}
        if not within_bf16_spread(n, g["cuda"], g["cpu"], g["cpu32"],
                                  (rms(g["cpu+"] - g["cpu"]), rms(g["cuda+"] - g["cuda"])),
                                  leaves):
            bad.append(n)
    leaves.sort(reverse=True)
    # really bf16: over all leaves the card's gradient is as far from the
    # CPU's f32 one as half the CPU's bf16 one is (a path that lost its
    # bf16 rounding would sit on f32)
    far = {r: sum(float((T[r][1][n] - g).norm()) ** 2 for n, g in T["cpu32"][1].items()) ** 0.5
           for r in ("cuda", "cpu")}
    print(f"small bf16 train gradients: {len(leaves)} leaves; worst (ratio to the bound, the "
          f"distance from the CPU's bf16 over its bf16-vs-f32 distance): " + ", ".join(
              f"{n} {a:.3f} {b:.3f}" for a, b, n in leaves[:5])
          + f"; all leaves: distance from the CPU's f32 cuda {far['cuda']:.4g}, cpu bf16 "
          f"{far['cpu']:.4g}")
    if not far["cuda"] >= 0.5 * far["cpu"]:
        bad.append("the gradient sits on f32 (not bf16)")
    if bad:
        fail("small bf16 train differs between CUDA and CPU beyond the bf16 spread: "
             + ", ".join(bad))

    # the eval step
    cfg = eval_cfg(base=tiny_cfg(), shapes=StaticShapeConfig(pose_refine_rays=128))
    nb = stack_batches([device_batch(make_query_batch(n_views=3, H=32, W=32, seed=s))
                        for s in (0, 1)])
    E = {}
    for name, d, dt, perturb in runs:
        m = NerfPoseEstimator(cfg, device=d, seed=2, dtype=dt)
        if perturb:
            perturb_(m, perturb)
        b = to_device_batch(nb, d)
        noise = {k: v.to(d) for k, v in eval_noise(m, b, seed=11).items()}
        zero_launch_counts()
        out = make_eval_step(m, cfg)(b, noise=noise)
        E[name] = ({k: v.cpu() for k, v in out.items()}, launch_counts())
        del m
    if E["cuda"][1] != (0, 2 * EVAL_LAUNCHES):
        fail(f"small bf16 eval: expected {2 * EVAL_LAUNCHES} bf16 and 0 f32 fused_agg "
             f"launches, got {E['cuda'][1][1]} and {E['cuda'][1][0]}")
    # the counts come from mutual nearest matches over the bf16 scores of a
    # tiny random model (4-6 matches per query), where one flipped match
    # moves a count: JAX's own bf16 eval step keeps half of these outputs
    # under a 2^-22 weight change (tests/test_torch_bf16_eval.py), so at
    # least half must be equal here, and PnP success all of them
    keys = ("num_inliers", "num_matches", "pnp_success", "matching_iou")
    same = sum(int((E["cuda"][0][k] == E["cpu"][0][k]).sum()) for k in keys)
    self_same = sum(int((E[r + "+"][0][k] == E[r][0][k]).sum()) for k in keys
                    for r in ("cpu", "cuda"))
    total = sum(E["cpu"][0][k].numel() for k in keys)
    print(f"small bf16 eval discrete outputs: {same} of {total} equal to the CPU's (under a "
          f"2^-22 weight change each device keeps {self_same} of {2 * total} of its own)")
    if 2 * same < total or not torch.equal(E["cuda"][0]["pnp_success"],
                                            E["cpu"][0]["pnp_success"]):
        fail(f"small bf16 eval: {same} of {total} discrete outputs equal to the CPU's, fewer "
             f"than half, or PnP success differs")
    worst = []
    for k in ("pose_pred", "rot_err_deg", "trans_err_m"):
        v = {n: E[n][0][k].double() for n in E}
        ok = within_bf16_spread(k, v["cuda"], v["cpu"], v["cpu32"],
                                (rms(v["cpu+"] - v["cpu"]), rms(v["cuda+"] - v["cuda"])), worst)
        print(f"small bf16 eval {k}: cuda vs cpu rms {rms(v['cuda'] - v['cpu']):.3g}, cpu bf16 "
              f"vs f32 {rms(v['cpu'] - v['cpu32']):.3g}, spreads cpu "
              f"{rms(v['cpu+'] - v['cpu']):.3g} cuda {rms(v['cuda+'] - v['cuda']):.3g} (ratio to "
              f"the bound {worst[-1][0]:.3f})")
        if not ok:
            fail(f"small bf16 eval {k} differs between CUDA and CPU beyond the bf16 spread")
    check_pose(E["cuda"][0]["pose_pred"][0].to(dev), "small bf16 eval")
    return T["cuda"][2][1]


def check_fused_agg_bf16_steps(dev, card: str):
    """Phase 13b: the bf16 instantiation at the train shape (N=65536, K=8)
    and the refinement shape (N=32768, K=8) against kernel_agg, within
    BF16_TOL (RMS) and BF16_TOL_MAX (max) of the plain version's own
    bf16-vs-f32 distance; the replayed backward (reference_agg at bf16)
    equal to autograd through reference_agg at bf16 in what each step
    differentiates (train: mv_agg, nb_feat and every weight; refinement:
    xyz, direction, mv_agg); the kernel's, the plain version's and the
    replayed backward's device times and the bound at the bf16 tensor-core
    peak. Returns (max abs error, times)."""
    import torch
    from nerfloc_tpu_torch.ops import fused_agg as fa
    bf = torch.bfloat16
    worst, times = 0.0, {}
    order = ("xyz", "direction", "mv_agg", "nb_xyz", "nb_dir", "nb_feat", "scale", "freqs")
    for tag, N, seed, keys in (("train", TRAIN_N, 9, ("mv_agg", "nb_feat")),
                               ("refine", REFINE_N, 13, ("xyz", "direction", "mv_agg"))):
        x = agg_inputs(N, RENDER_K, 195, 128, seed=seed, dev=dev)
        xb = agg_inputs_bf16(x)
        with torch.no_grad():
            ref = fa.kernel_agg(**xb)
            ref32 = fa.reference_agg(**x)
        yard_rms, yard_max = rms(ref - ref32), float((ref - ref32).abs().max())
        default = fa.tile_plan(N, RENDER_K, fa._sm_count(dev), bf16=True)[0]
        tiles = sorted({default, *(r for r in fa.tile_options(RENDER_K, bf16=True)
                                   if r >= fa.WGMMA_ROWS)})
        for rows in tiles:
            with torch.no_grad():
                out = fa.launch(**xb, rows=rows)
            torch.cuda.synchronize()
            e_rms, e_max = rms(out - ref), float((out - ref).abs().max())
            worst = max(worst, e_max)
            print(f"fused_agg bf16 {tag} shape N={N} K={RENDER_K} ({rows}-row tiles"
                  f"{', default' if rows == default else ''}): vs plain rms {e_rms:.3g} max "
                  f"{e_max:.3g}; plain bf16 vs f32 rms {yard_rms:.3g} max {yard_max:.3g} "
                  f"(tol rms <= {BF16_TOL} x, max <= {BF16_TOL_MAX} x)")
            if not (bool(torch.isfinite(out).all()) and e_rms <= BF16_TOL * yard_rms
                    and e_max <= BF16_TOL_MAX * yard_max):
                fail(f"fused_agg bf16 disagrees with kernel_agg at the {tag} shape, "
                     f"{rows}-row tiles")
            del out
        del ref, ref32
        cot = torch.randn(N, 128, generator=torch.Generator().manual_seed(seed)).to(dev)
        wkeys = fa.PARAM_KEYS if tag == "train" else ()
        grads = []
        for use_kernel in (True, False):
            leaves = {k: xb[k].clone().requires_grad_(True) for k in keys}
            p = {k: v.clone().requires_grad_(k in wkeys) for k, v in xb["params"].items()}
            args = {**xb, **leaves, "params": p}
            o = (fa._FusedAgg.apply(*[args[k] for k in order], *[p[k] for k in fa.PARAM_KEYS])
                 if use_kernel else fa.reference_agg(**args, dtype=bf))
            g = torch.autograd.grad(o, list(leaves.values()) + [p[k] for k in wkeys], cot)
            grads.append(g)
            del o, leaves, p, args
        if not all(torch.equal(a, b) for a, b in zip(*grads)):
            fail(f"fused_agg bf16 replayed backward differs from autograd through "
                 f"reference_agg(bf16) at the {tag} shape")
        del grads

        def backward():
            leaves = {k: xb[k].clone().requires_grad_(True) for k in keys}
            p = {k: v.clone().requires_grad_(k in wkeys) for k, v in xb["params"].items()}
            o = fa.reference_agg(**{**xb, **leaves, "params": p}, dtype=bf)
            torch.autograd.grad(o, list(leaves.values()) + [p[k] for k in wkeys], cot)
        cost = agg_cost(N, RENDER_K, 195, 128, xb["params"], xb["freqs"], 2)
        f32_ms, b_ms, unit = agg_bounds(cost, "bf16")
        by_tile = {}
        with torch.no_grad():
            for rows in tiles:
                by_tile[rows] = device_ms(lambda: fa.launch(**xb, rows=rows), iters=10)
                info = tile_info(N, RENDER_K, rows, xb["params"], xb["freqs"], 195, True)
                print(f"fused_agg bf16 {tag} shape N={N} K={RENDER_K}, {rows}-row tiles: kernel "
                      f"{by_tile[rows]:.4f} ms ({100 * b_ms / by_tile[rows]:.1f} % of its bound); "
                      f"{tile_text(info)}; {card}")
            k_ms = by_tile[default]
            p_ms = device_ms(lambda: fa.kernel_agg(**xb), iters=3)
        b_ms_replay = device_ms(backward, iters=3)
        if k_ms < b_ms:
            fail(f"fused_agg bf16 at the {tag} shape reads faster than its bound ({k_ms} < {b_ms})")
        print(f"fused_agg bf16 {tag} shape N={N} K={RENDER_K}: replayed backward equal to "
              f"autograd through reference_agg(bf16) in {', '.join(keys)}"
              f"{' and the weights' if wkeys else ''}; kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, bound {b_ms:.4f} ms by {unit} ({100 * b_ms / k_ms:.1f} %); "
              f"replayed backward {b_ms_replay:.4f} ms; {card}")
        times.update({f"{tag}_ms": k_ms, f"{tag}_plain_ms": p_ms, f"{tag}_bound_ms": b_ms,
                      f"{tag}_backward_replay_ms": b_ms_replay,
                      f"{tag}_ms_by_tile_rows": by_tile,
                      f"{tag}_tile": tile_info(N, RENDER_K, default, xb["params"], xb["freqs"],
                                               195, True)})
        del x, xb, cot
        torch.cuda.empty_cache()
    return worst, times


class StepProbe:
    """Wraps a CLI module's make_train_step / make_eval_step: each step is
    synchronized, the launch counters are set to 0 just before it and read
    just after (exactly `expect` of the bf16 instantiation and none of the
    f32 one), and its time and the time since the previous step returned
    are kept; with keep_batches, its device batch too."""

    def __init__(self, module, name: str, expect: int, what: str,
                 keep_batches: bool = False, knn_count=None):
        self.module, self.name, self.expect, self.what = module, name, expect, what
        self.knn_count = knn_count
        self.orig = getattr(module, name)
        self.ms, self.gaps, self.launches, self.last_exit = [], [], [], None
        self.batches = [] if keep_batches else None
        setattr(module, name, self.make)

    def make(self, *args, **kwargs):
        import torch
        step = self.orig(*args, **kwargs)

        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if self.last_exit is not None:
                self.gaps.append((t0 - self.last_exit) * 1e3)
            if self.batches is not None:
                self.batches.append(a[1])
            if self.knn_count is not None:
                self.knn_count.active = True
            zero_launch_counts()
            out = step(*a, **k)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if self.knn_count is not None:
                self.knn_count.active = False
            self.launches.append(expect_launches(self.expect, True,
                                                 f"{self.what} {len(self.ms)}"))
            self.ms.append((t1 - t0) * 1e3)
            self.last_exit = t1
            return out
        return wrapped

    def restore(self):
        setattr(self.module, self.name, self.orig)


class KnnCount:
    """Counts the exact-KNN calls of the conditional NeRF (ops/knn.knn, the
    query's neighbour search) by shape while `active`."""

    def __init__(self):
        from nerfloc_tpu_torch.models.fields import conditional_nerf
        self.module, self.orig = conditional_nerf, conditional_nerf.knn
        self.active, self.calls = False, defaultdict(int)
        conditional_nerf.knn = self

    def __call__(self, queries, points, K, points_mask=None):
        if self.active:
            self.calls[(queries.shape[0], points.shape[0], K)] += 1
        return self.orig(queries, points, K, points_mask=points_mask)

    def take(self):
        calls, self.calls = dict(self.calls), defaultdict(int)
        return calls

    def restore(self):
        self.module.knn = self.orig


def knn_norm_ms(calls, dev) -> tuple:
    """Host-clock ms of the knn calls `calls` {(N, M, K): count} as ops/knn
    computes them (sq_norm: XLA's CPU rounding, f64 steps) and with
    torch.sum squared norms in f32, on seeded points: per shape 20 calls,
    synchronized, times its count, summed; the two forms in turn 5 times,
    the median of the last 4."""
    import torch
    from nerfloc_tpu_torch.ops.knn import knn, topk_first

    def knn_sum(q, p, K, mask):
        d = torch.sum(q * q, dim=-1, keepdim=True) - 2.0 * (q @ p.T) + \
            torch.sum(p * p, dim=-1)[None, :]
        d = torch.where(mask[None, :], torch.clamp(d, min=0.0), torch.finfo(d.dtype).max / 4)
        return topk_first(d, K, largest=False)

    def knn_sq_norm(q, p, K, mask):
        return knn(q, p, K, points_mask=mask)

    gen = torch.Generator(device=dev).manual_seed(0)
    inputs = [(torch.rand(N, 3, device=dev, generator=gen) * 4,
               torch.rand(M, 3, device=dev, generator=gen) * 4,
               K, torch.rand(M, device=dev, generator=gen) > 0.1, n)
              for (N, M, K), n in calls.items()]
    turns = {knn_sq_norm: [], knn_sum: []}
    for _ in range(5):
        for fn, totals in turns.items():
            total = 0.0
            for q, p, K, mask, n in inputs:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(20):
                    fn(q, p, K, mask)
                torch.cuda.synchronize()
                total += n * (time.perf_counter() - t0) * 1e3 / 20
            totals.append(total)
    return statistics.median(turns[knn_sq_norm][1:]), statistics.median(turns[knn_sum][1:])


def write_flow_yaml(path: str, doc) -> None:
    """A YAML document as one flow collection (JSON is such a document)."""
    with open(path, "w") as f:
        f.write(json.dumps(doc) + "\n")


def _subdir(root: str, name: str):
    """A new directory `name` under `root`, kept for the later phases."""
    import contextlib
    path = os.path.join(root, name)
    os.makedirs(path)
    return contextlib.nullcontext(path)


def clis_on_files(dev, card: str, files: str):
    """Phase 14: the train and test CLIs on written 480x640 scenes at full
    width in bf16 (see the module docstring), under files/cli. Returns its
    numbers and the paths phases 16-17 reuse."""
    import numpy as np
    import torch
    from nerfloc_tpu_torch.cli import test as cli_test
    from nerfloc_tpu_torch.cli import train as cli_train
    from nerfloc_tpu_torch.configs import compute_dtype_of, load_config
    from nerfloc_tpu_torch.data import build_dataset, png
    from nerfloc_tpu_torch.data.prefetch import BatchLoader
    from nerfloc_tpu_torch.data.synthetic import SCENE_VARIANTS, write_scene
    from nerfloc_tpu_torch.train.checkpoint import discover_best_dirs
    out = {}
    with _subdir(files, "cli") as root:
        t0 = time.perf_counter()
        for i, name in enumerate(CLI_SCENES):
            tex, bh, rs = SCENE_VARIANTS[i]
            write_scene(root, scene=name, n_train=CLI_TRAIN, n_test=CLI_TEST,
                        n_support=CLI_SUPPORT, tex=tex, box_half=bh, radius_scale=rs,
                        H=CLI_H, W=CLI_W)
        rows = {"rgb": np.zeros(5, np.int64), "depth": np.zeros(5, np.int64)}
        for dirpath, _, files in os.walk(root):
            for f in files:
                if f.endswith(".png"):
                    with open(os.path.join(dirpath, f), "rb") as fh:
                        kind = "depth" if f.endswith(".depth.png") else "rgb"
                        rows[kind] += np.bincount(png.filter_types(fh.read()), minlength=5)
        print(f"cli: wrote {len(CLI_SCENES)} scenes of {CLI_TRAIN}+{CLI_TEST} frames at "
              f"{CLI_H}x{CLI_W} in {time.perf_counter() - t0:.2f} s, rows filtered per row as "
              f"libpng's adaptive choice: rows of filter type 0-4 "
              f"{rows['rgb'].tolist()} (RGB), {rows['depth'].tolist()} (depth)")
        data_path = _write_data_yaml(root, "video_7scenes", CLI_SCENES)
        overrides = {"dataset_type": data_path, "scenes": list(CLI_SCENES), "max_epochs": 1}
        test_overrides = {**overrides, "cascade_matching": True, "optimize_pose": True}
        paths = {kind: _write_config(root, kind, "7scenes_all.yaml", ov)
                 for kind, ov in (("train", overrides), ("test", test_overrides))}
        cfg = load_config(paths["train"])
        if compute_dtype_of(cfg) != torch.bfloat16:
            fail("cli: the config's compute dtype is not bf16")

        # host side: dataset items, the loader, the PNG decoder
        train_ds = build_dataset(cfg, "train", mode="train")
        test_ds = build_dataset(cfg, "test", mode="test")
        item_ms = {}
        for kind, ds in (("train", train_ds), ("test", test_ds)):
            times = []
            for i in range(min(8, len(ds))):
                t0 = time.perf_counter()
                ds[i]
                times.append((time.perf_counter() - t0) * 1e3)
            item_ms[kind] = statistics.median(times)
        # BatchLoader assembles one batch at a time (pool.map over its
        # items): at the CLI's B=1 one thread works; B=8 gives 8 threads 8
        # items at once, and B=8 with one thread is the serial rate
        rates, B8 = {}, min(8, len(train_ds))
        for B, workers in ((1, 8), (B8, 8), (B8, 1)):
            loader = BatchLoader(train_ds, B, shuffle=True, seed=0, num_workers=workers)
            t0 = time.perf_counter()
            n_items = B * sum(1 for _ in loader.epoch(0))
            rates[(B, workers)] = n_items / (time.perf_counter() - t0)
        items_per_s = rates[(1, 8)]
        frame = (np.random.default_rng(0).random((CLI_H, CLI_W, 3)) * 255).astype(np.uint8)
        blob = png.encode(frame, 4)
        raw = png.filter_rows(frame.reshape(CLI_H, -1), 3, np.full(CLI_H, 4))
        unfilter_ms = statistics.median(_host_ms(lambda: png.unfilter(raw, 3)) for _ in range(5))
        decode_ms = statistics.median(_host_ms(lambda: png.decode(blob)) for _ in range(5))
        if not np.array_equal(png.decode(blob), frame):
            fail("cli: a Paeth-filtered 480x640 frame does not decode to itself")
        print(f"cli host: build_dataset item {item_ms['train']:.2f} ms (train, with augmentation, "
              f"V={cfg.n_views_train}), {item_ms['test']:.2f} ms (test, V={cfg.n_views_test}); "
              f"BatchLoader over {n_items} items: B=1 (the CLI's; 1 of 8 threads at work) "
              f"{rates[(1, 8)]:.2f} items/s, B={B8} with 8 threads {rates[(B8, 8)]:.2f}, B={B8} "
              f"with 1 thread {rates[(B8, 1)]:.2f}; PNG Paeth {CLI_H}x{CLI_W} frame: native unfilter "
              f"{unfilter_ms:.2f} ms, decode {decode_ms:.2f} ms; {card}")

        # the train CLI
        runs = os.path.join(root, "runs")
        print(f"cli: render.fused_query_agg {cfg.render.fused_query_agg} (the YAML's); on "
              "the card the query aggregation is the fused kernel all the same")
        knn_count = KnnCount()
        probe = StepProbe(cli_train, "make_train_step", 3, "cli train step",
                          keep_batches=True, knn_count=knn_count)
        try:
            t0 = time.perf_counter()
            rc = cli_train.main(["--config", paths["train"], "--basedir", runs, "--batch", "1",
                                 "--eval_interval", "1", "--train_render_views", "1",
                                 "--device", "cuda"])
            train_wall = time.perf_counter() - t0
        finally:
            probe.restore()
        if rc != 0 or len(probe.ms) != len(train_ds):
            fail(f"cli train: rc {rc}, {len(probe.ms)} steps for {len(train_ds)} items")
        run_dir = os.path.join(runs, cfg.expname or "default", cfg.version)
        log = [json.loads(line) for line in open(os.path.join(run_dir, "log.jsonl"))]
        for rec in log:
            if "loss" in rec and not (math.isfinite(rec["loss"]) and
                                      math.isfinite(rec["grad_norm"])):
                fail(f"cli train: loss or grad_norm not finite: {rec}")
        evals = [rec["eval"] for rec in log if "eval" in rec]
        if not evals or not math.isfinite(evals[-1]["avg"].get("psnr_test", math.nan)):
            fail(f"cli train: no finite psnr_test in the epoch eval: {evals}")
        ckpts = os.path.join(run_dir, "ckpts")
        if "pose_acc" not in discover_best_dirs(ckpts):
            fail("cli train: no pose_acc best stream")
        epoch_s = (sum(probe.ms) + sum(probe.gaps)) / 1e3
        step_ms = statistics.median(probe.ms)
        wait_share = sum(probe.gaps) / 1e3 / epoch_s
        train_launches = probe.launches[-1]
        train_knn = knn_count.take()
        alone_ms = _step_alone_ms(cfg, probe.batches, dev)
        probe.batches.clear()
        print(f"cli train: {len(probe.ms)} steps, exactly {probe.launches[-1]} bf16 fused_agg "
              f"launches each; median {step_ms:.2f} ms/step (min {min(probe.ms):.2f}, max "
              f"{max(probe.ms):.2f}); outside the step between steps (loader wait + copy) "
              f"{wait_share:.4f} of {epoch_s:.2f} s; the same {len(probe.ms)} batches through "
              f"a fresh model's step with no loader running {alone_ms:.2f} ms/step (median); "
              f"CLI wall {train_wall:.2f} s; epoch eval {json.dumps(evals[-1]['avg'])}; {card}")

        # the test CLI
        out_json = os.path.join(root, "eval", "results.json")
        probe = StepProbe(cli_test, "make_eval_step", EVAL_LAUNCHES, "cli eval query",
                          knn_count=knn_count)
        try:
            t0 = time.perf_counter()
            rc = cli_test.main(["--config", paths["test"], "--ckpt", ckpts, "--out", out_json,
                                "--device", "cuda"])
            test_wall = time.perf_counter() - t0
        finally:
            probe.restore()
            knn_count.restore()
        n_test = len(CLI_SCENES) * CLI_TEST
        if rc != 0 or len(probe.ms) != n_test:
            fail(f"cli test: rc {rc}, {len(probe.ms)} queries for {n_test} items")
        per_scene = json.load(open(out_json))["per_scene"]
        for name in (*CLI_SCENES, "avg"):
            row = per_scene.get(name)
            if row is None or not all(math.isfinite(v) for v in row.values()) or \
                    not 0 <= row["pose_acc"] <= 1:
                fail(f"cli test: row {name} malformed: {row}")
        if per_scene["avg"]["n"] != n_test:
            fail(f"cli test: {per_scene['avg']['n']} queries counted, expected {n_test}")
        eval_ms = statistics.median(probe.ms)
        print(f"cli test: {n_test} queries (cascade + refinement), exactly "
              f"{probe.launches[-1]} bf16 fused_agg launches each; median {eval_ms:.2f} "
              f"ms/query (min {min(probe.ms):.2f}, max {max(probe.ms):.2f}); CLI wall "
              f"{test_wall:.2f} s; table {json.dumps(per_scene)}; {card}")

        # ops/knn's squared norms (XLA's CPU rounding, in f64 steps) against
        # plain f32 torch.sum norms, at the shapes and counts of the steps
        eval_knn = knn_count.take()
        n_steps = len(train_ds)
        knn_ms = {}
        for kind, calls, n in (("train", train_knn, n_steps), ("eval", eval_knn, n_test)):
            per = {k: v / n for k, v in calls.items()}
            knn_ms[kind] = knn_norm_ms(per, dev)
            print(f"cli knn ({kind}): calls per {'step' if kind == 'train' else 'query'} by "
                  f"(queries, points, K) {json.dumps({str(k): v for k, v in per.items()})}; "
                  f"their host ms with ops/knn's sq_norm {knn_ms[kind][0]:.3f}, with f32 "
                  f"torch.sum norms {knn_ms[kind][1]:.3f} (difference "
                  f"{knn_ms[kind][0] - knn_ms[kind][1]:.3f} ms against "
                  f"{step_ms if kind == 'train' else eval_ms:.2f} ms); {card}")
    loaded = [m for m in ("cv2", "PIL", "yaml") if m in sys.modules]
    if loaded:
        fail(f"cli: {loaded} were imported")
    out.update(cli_root=root, cli_paths=paths, cli_ckpts=ckpts,
               cli_item_ms_train=item_ms["train"], cli_item_ms_test=item_ms["test"],
               cli_loader_items_per_s=items_per_s, cli_train_ms_per_step=step_ms,
               cli_train_launches_per_step=train_launches,
               cli_loader_wait_share=wait_share, cli_train_ms_alone=alone_ms,
               cli_eval_ms_per_query=eval_ms,
               cli_eval_launches_per_query=probe.launches[-1],
               png_unfilter_ms=unfilter_ms, png_decode_ms=decode_ms,
               cli_loader_items_per_s_b8=rates[(B8, 8)],
               cli_loader_items_per_s_b8_serial=rates[(B8, 1)],
               knn_sq_norm_ms_train=knn_ms["train"], knn_sq_norm_ms_eval=knn_ms["eval"])
    return out


def _write_data_yaml(root: str, family: str, scenes) -> str:
    """The port's copy of configs/data/<family>.yaml with base_dir and the
    scenes pointed at `root`, as one flow document."""
    from nerfloc_tpu_torch.configs import load_yaml
    repo = os.path.dirname(os.path.abspath(__file__))
    data = load_yaml(os.path.join(repo, "nerfloc_tpu_torch", "configs", "data", f"{family}.yaml"))
    data.update(base_dir=root, scenes=list(scenes))
    path = os.path.join(root, f"{family}.yaml")
    write_flow_yaml(path, data)
    return path


def _write_config(root: str, name: str, base: str, overrides: dict) -> str:
    """configs/<base> with only `overrides` replaced, as one flow document
    (checked equal to load_config with the overrides)."""
    from nerfloc_tpu_torch.configs import load_config, load_yaml
    repo = os.path.dirname(os.path.abspath(__file__))
    base_path = os.path.join(repo, "configs", base)
    doc = load_yaml(base_path)
    doc.update(overrides)
    path = os.path.join(root, f"{name}.yaml")
    write_flow_yaml(path, doc)
    if load_config(path) != load_config(base_path, overrides):
        fail(f"the written {name} config is not {base} with {overrides}")
    return path


def _train_cli(cli_train, argv, expect: int, what: str, n_items: int):
    """cli.train.main under a StepProbe; returns the probe."""
    probe = StepProbe(cli_train, "make_train_step", expect, what, keep_batches=True)
    try:
        rc = cli_train.main(argv)
    finally:
        probe.restore()
    if rc != 0 or len(probe.ms) != n_items:
        fail(f"{what}: rc {rc}, {len(probe.ms)} steps for {n_items} items")
    return probe


def _read_log(run_dir: str, what: str):
    log = [json.loads(line) for line in open(os.path.join(run_dir, "log.jsonl"))]
    for rec in log:
        if "loss" in rec and not (math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"])):
            fail(f"{what}: loss or grad_norm not finite: {rec}")
    return log


def _test_cli(cli_test, argv, expect: int, what: str, n_items: int, out_json: str, scenes):
    probe = StepProbe(cli_test, "make_eval_step", expect, what)
    try:
        rc = cli_test.main(argv)
    finally:
        probe.restore()
    if rc != 0 or len(probe.ms) != n_items:
        fail(f"{what}: rc {rc}, {len(probe.ms)} queries for {n_items} items")
    per_scene = json.load(open(out_json))["per_scene"]
    for name in (*scenes, "avg"):
        row = per_scene.get(name)
        if row is None or not all(math.isfinite(v) for v in row.values()):
            fail(f"{what}: row {name} malformed: {row}")
    return probe, per_scene


def finetune_on_files(dev, card: str, files: str):
    """Phase 15: the per-scene fine-tune configurations through the CLIs
    on files, bf16, full width (see the module docstring), under files/ft.
    Returns its numbers."""
    import pickle

    import numpy as np
    import torch
    from nerfloc_tpu_torch.cli import test as cli_test
    from nerfloc_tpu_torch.cli import train as cli_train
    from nerfloc_tpu_torch.configs import compute_dtype_of, load_config
    from nerfloc_tpu_torch.data import build_dataset, jpeg, png, tiff
    from nerfloc_tpu_torch.data.scene_store import SceneStore
    from nerfloc_tpu_torch.data.synthetic import write_object_scene, write_twelve_scenes_scene
    from nerfloc_tpu_torch.data.video_dataset import compute_target_mask
    from nerfloc_tpu_torch.utils.visualization import draw_box3d
    out = {}
    with _subdir(files, "ft") as root:
        t0 = time.perf_counter()
        for i, name in enumerate(FT_OBJECTS):
            write_object_scene(root, scene=name, n_train=FT_TRAIN, n_test=FT_TEST,
                               n_support=FT_SUPPORT, H=FT_OBJ_HW, W=FT_OBJ_HW, tex=i + 1)
        write_twelve_scenes_scene(root, scene=FT_JPEG_SCENE, n_train=FT_TRAIN, n_test=FT_TEST,
                                  n_support=FT_SUPPORT)
        print(f"finetune: wrote {len(FT_OBJECTS)} object scenes ({FT_TRAIN}+{FT_TEST} frames, "
              f"{FT_OBJ_HW}x{FT_OBJ_HW} PNG, float32 depth TIFF, Deflate + floating-point "
              f"predictor) and a 12-Scenes-layout scene ({FT_TRAIN}+{FT_TEST} 1296x968 JPEG "
              f"frames, 640x480 depth PNG) in {time.perf_counter() - t0:.2f} s")
        onepose = _write_data_yaml(root, "video_onepose", FT_OBJECTS)
        twelve = _write_data_yaml(root, "video_12scenes", [FT_JPEG_SCENE])
        paths = {
            "all": _write_config(root, "all", "onepose_all.yaml", {
                "dataset_type": onepose, "scenes": list(FT_OBJECTS), "max_epochs": 1}),
            "obj": _write_config(root, "obj", "onepose/0447.yaml", {
                "dataset_type": onepose, "scenes": [FT_OBJECTS[0]], "max_epochs": 1}),
            "obj_test": _write_config(root, "obj_test", "onepose/0447.yaml", {
                "dataset_type": onepose, "scenes": [FT_OBJECTS[0]], "max_epochs": 1,
                "cascade_matching": True, "optimize_pose": True, "vis_3d_box": True,
                "vis_trajectory": True, "test_render_interval": 1}),
            "jpeg": _write_config(root, "jpeg", "12scenes/apt1_kitchen.yaml", {
                "dataset_type": twelve, "scenes": [FT_JPEG_SCENE], "max_epochs": 1}),
        }
        cfgs = {k: load_config(v) for k, v in paths.items()}
        for k, c in cfgs.items():
            if compute_dtype_of(c) != torch.bfloat16:
                fail(f"finetune: {k} does not run at bf16")
        obj = cfgs["obj"]
        if obj.encode_appearance or not obj.use_scene_coord_memorization or \
                obj.n_views_train != 16 or obj.support_image_selection != "coreset" or \
                obj.render.N_rand != 512:
            fail(f"finetune: onepose/0447.yaml is not the per-object fine-tune: {obj}")

        # host numbers
        meta = pickle.load(open(os.path.join(root, FT_JPEG_SCENE, "info_train.pkl"), "rb"))[0]
        blob = open(os.path.join(root, meta["file_name"]), "rb").read()
        helper = jpeg.decode(blob)
        if helper.shape != (968, 1296, 3) or not np.array_equal(jpeg.decode_py(blob), helper):
            fail("finetune: the JPEG helper and decode_py disagree on a 12-Scenes frame")
        jpeg_ms = statistics.median(_host_ms(lambda: jpeg.decode(blob)) for _ in range(10))
        jpeg_py_ms = statistics.median(_host_ms(lambda: jpeg.decode_py(blob)) for _ in range(3))
        store = SceneStore.load(root, FT_OBJECTS[0])
        fr = store.train_frames[0]
        depth = tiff.read(os.path.join(root, fr["depth_file_name"]))
        tiff_ms = {}
        for comp, pred, label in ((tiff.DEFLATE, 3, "deflate+fp predictor (the scenes')"),
                                  (tiff.NONE, 1, "none"), (tiff.LZW, 3, "lzw+fp predictor")):
            p = os.path.join(root, f"t_{comp}.tiff")
            tiff.write(p, depth, comp, pred)
            if not np.array_equal(tiff.read(p), depth):
                fail(f"finetune: TIFF {label} does not read back")
            tiff_ms[label] = statistics.median(_host_ms(lambda: tiff.read(p)) for _ in range(10))
        w2c = np.vstack([fr["extrinsic_Tcw"], [0, 0, 0, 1]])
        K = np.array([[fr["camera_intrinsic"][0], 0, fr["camera_intrinsic"][2]],
                      [0, fr["camera_intrinsic"][1], fr["camera_intrinsic"][3]], [0, 0, 1]])
        mask = compute_target_mask(store.points, K, w2c, depth.shape)
        if not 0 < mask.sum() < mask.size:
            fail("finetune: the target mask is empty or full")
        mask_ms = statistics.median(_host_ms(lambda: compute_target_mask(
            store.points, K, w2c, depth.shape)) for _ in range(20))
        item_ms = {}
        for kind, c in (("obj", obj), ("jpeg", cfgs["jpeg"])):
            for mode in ("train", "test"):
                ds = build_dataset(c, mode, mode=mode)
                item_ms[(kind, mode)] = statistics.median(
                    _host_ms(lambda i=i: ds[i]) for i in range(min(4, len(ds))))
                if kind == "obj" and not ds[0]["target_mask"].any():
                    fail("finetune: an object item without its target mask")
        print(f"finetune host: JPEG 1296x968 4:2:0 decode {jpeg_ms:.2f} ms (helper, median of "
              f"10), {jpeg_py_ms:.2f} ms (decode_py, median of 3); {FT_OBJ_HW}x{FT_OBJ_HW} float32 "
              f"TIFF read "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in tiff_ms.items())
              + f" (median of 10); compute_target_mask {mask_ms:.2f} ms (median of 20, "
              f"{len(store.points)} points); items (median of 4): object train "
              f"{item_ms[('obj', 'train')]:.2f} ms, test {item_ms[('obj', 'test')]:.2f} ms "
              f"(V=16: 17 frames and the probe read), 12-Scenes JPEG train "
              f"{item_ms[('jpeg', 'train')]:.2f} ms, test {item_ms[('jpeg', 'test')]:.2f} ms "
              f"(V={cfgs['jpeg'].n_views_train}/{cfgs['jpeg'].n_views_test}); {card}")

        # (a) the multi-object run
        runs = os.path.join(root, "runs")
        n_all = len(FT_OBJECTS) * FT_TRAIN
        probe = _train_cli(cli_train, ["--config", paths["all"], "--basedir", runs,
                                       "--eval_interval", "1", "--train_render_views", "1",
                                       "--device", "cuda"], 3, "finetune (a) step", n_all)
        all_dir = os.path.join(runs, cfgs["all"].expname, cfgs["all"].version)
        _read_log(all_dir, "finetune (a)")
        all_ckpts = os.path.join(all_dir, "ckpts")
        a_ms = statistics.median(probe.ms)
        print(f"finetune (a): onepose_all.yaml, {len(probe.ms)} steps at V=5, exactly "
              f"{probe.launches[-1]} bf16 launches each, median {a_ms:.2f} ms/step; {card}")

        # (b) the per-object fine-tune, warm-started from (a)
        torch.cuda.reset_peak_memory_stats()
        probe = _train_cli(cli_train, ["--config", paths["obj"], "--basedir", runs,
                                       "--ckpt", all_ckpts, "--eval_interval", "1",
                                       "--train_render_views", "1", "--device", "cuda"],
                           3, "finetune (b) step", FT_TRAIN)
        peak_train = torch.cuda.max_memory_allocated() / 2**30
        obj_dir = os.path.join(runs, obj.expname, obj.version)
        log = _read_log(obj_dir, "finetune (b)")
        ws = [r for r in log if "warm_start" in r]
        heads = ("model_3d.coord_desc_mlp_coarse", "model_3d.coord_desc_mlp_fine")
        if len(ws) != 1 or len(ws[0]["fresh"]) != 12 or \
                not all(k.startswith(heads) for k in ws[0]["fresh"]):
            fail(f"finetune (b): the warm start's fresh tensors are not the coordinate "
                 f"heads': {ws}")
        losses = [r["loss"] for r in log if "loss" in r]
        ft_ms = statistics.median(probe.ms)
        epoch_s = (sum(probe.ms) + sum(probe.gaps)) / 1e3
        wait_share = sum(probe.gaps) / 1e3 / epoch_s
        ft_launches = probe.launches[-1]
        alone_ms = _step_alone_ms(obj, probe.batches, dev)
        probe.batches.clear()
        print(f"finetune (b): onepose/0447.yaml with --ckpt (a): restored {ws[0]['restored']} "
              f"tensors, fresh exactly the 12 of the coordinate heads; {len(probe.ms)} steps "
              f"at V=16 (coreset FPS), N_rand 512, exactly {ft_launches} bf16 launches and 0 "
              f"f32 each; losses finite ({losses}); median {ft_ms:.2f} ms/step (min "
              f"{min(probe.ms):.2f}, max {max(probe.ms):.2f}); outside the step {wait_share:.4f} "
              f"of {epoch_s:.2f} s; the same batches with no loader {alone_ms:.2f} ms/step; "
              f"peak {peak_train:.2f} GiB; {card}")

        # (c) the test CLI with everything on
        out_json = os.path.join(root, "eval", "results.json")
        torch.cuda.reset_peak_memory_stats()
        probe, table = _test_cli(cli_test, ["--config", paths["obj_test"], "--ckpt",
                                            os.path.join(obj_dir, "ckpts"), "--out", out_json,
                                            "--device", "cuda"],
                                 EVAL_LAUNCHES, "finetune (c) query", FT_TEST, out_json,
                                 [FT_OBJECTS[0]])
        peak_eval = torch.cuda.max_memory_allocated() / 2**30
        ft_eval_ms = statistics.median(probe.ms)
        ft_eval_launches = probe.launches[-1]
        poses = pickle.load(open(os.path.join(root, "eval", "trajectory.pkl"), "rb"))["poses_pred"]
        test_ds = build_dataset(load_config(paths["obj_test"]), "test", mode="test")
        in_view = 0
        for i in range(FT_TEST):
            p = os.path.join(root, "eval", f"box_{i:05d}.png")
            if not os.path.exists(p):
                fail(f"finetune (c): {p} not written")
            item = test_ds[i]
            img = (np.asarray(item["image"]) * 255).astype(np.uint8)
            over = png.read(p)
            want = draw_box3d(img, item["bbox3d_corners"][:8], item["K"], poses[i])
            if not np.array_equal(over, want):
                fail(f"finetune (c): {p} is not the box at the predicted pose")
            green = (over[..., 0] == 0) & (over[..., 1] == 255) & (over[..., 2] == 0)
            in_view += bool(green.any())
            at_gt = draw_box3d(img, item["bbox3d_corners"][:8], item["K"], item["pose"])
            if not ((at_gt[..., 1] == 255) & (at_gt[..., 0] == 0)).any():
                fail(f"finetune (c): item {i}'s box is not in view at its true pose")
        print(f"finetune (c): cli.test with cascade, refinement and vis_3d_box, {len(probe.ms)} "
              f"queries at V=16, exactly {probe.launches[-1]} bf16 launches each; median "
              f"{ft_eval_ms:.2f} ms/query; {FT_TEST} box PNGs decoded, each the box at the "
              f"predicted pose ({in_view} with box pixels in view; random weights); peak "
              f"{peak_eval:.2f} GiB; table {json.dumps(table)}; {card}")

        # (d) the 12-Scenes JPEG scene without --ckpt
        jcfg = cfgs["jpeg"]
        yaml_ckpt = jcfg.ckpt
        existed = os.path.exists(yaml_ckpt)
        probe = _train_cli(cli_train, ["--config", paths["jpeg"], "--basedir", runs,
                                       "--eval_interval", "1", "--train_render_views", "1",
                                       "--device", "cuda"], 3, "finetune (d) step", FT_TRAIN)
        jpeg_dir = os.path.join(runs, jcfg.expname, jcfg.version)
        jlog = _read_log(jpeg_dir, "finetune (d)")
        if any("warm_start" in r for r in jlog) or (not existed and os.path.exists(yaml_ckpt)):
            fail(f"finetune (d): cli.train read the YAML's ckpt: {yaml_ckpt}")
        jpeg_ms_step = statistics.median(probe.ms)
        jpeg_launches = probe.launches[-1]
        out_json = os.path.join(root, "eval_jpeg", "results.json")
        probe, jtable = _test_cli(cli_test, ["--config", paths["jpeg"], "--ckpt",
                                             os.path.join(jpeg_dir, "ckpts"), "--out", out_json,
                                             "--device", "cuda"],
                                  2, "finetune (d) query", FT_TEST, out_json, [FT_JPEG_SCENE])
        print(f"finetune (d): 12scenes/apt1_kitchen.yaml without --ckpt (its ckpt: "
              f"{yaml_ckpt} unread, trained from the fresh init), {FT_TRAIN} steps on JPEG frames "
              f"at V={jcfg.n_views_train}, exactly {jpeg_launches} bf16 launches each, median "
              f"{jpeg_ms_step:.2f} ms/step; cli.test {len(probe.ms)} queries, exactly "
              f"{probe.launches[-1]} bf16 launches each, median {statistics.median(probe.ms):.2f} "
              f"ms/query; table {json.dumps(jtable)}; {card}")
    loaded = [m for m in ("cv2", "PIL", "yaml", "tifffile") if m in sys.modules]
    if loaded:
        fail(f"finetune: {loaded} were imported")
    out.update(ft_train_ms_per_step=ft_ms, ft_train_launches_per_step=ft_launches,
               ft_train_ms_alone=alone_ms, ft_loader_wait_share=wait_share,
               ft_eval_ms_per_query=ft_eval_ms, ft_eval_launches_per_query=ft_eval_launches,
               ft_peak_train_gib=peak_train, ft_peak_eval_gib=peak_eval,
               jpeg_decode_ms=jpeg_ms, jpeg_decode_py_ms=jpeg_py_ms, tiff_read_ms=tiff_ms,
               target_mask_ms=mask_ms, jpeg_train_ms_per_step=jpeg_ms_step, ft_root=root)
    return out


# -- phases 16-17 -----------------------------------------------------------------

PAR_TOL = 2e-3          # 2-rank against one-process results on the card
FRAME_TOL = 1e-5        # ray-sharded frame against render_image
RAY_WIDTH = 2
RETRIEVAL_K = 16        # the default image_core_set_size
RETRIEVAL_COS = 1e-3    # 1 - cosine of card and CPU descriptors


def _worker_setup():
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


class Timed:
    """Wraps module.name: each call synchronized and timed (host ms), with
    `key(*args)` kept beside the time."""

    def __init__(self, module, name: str, key=lambda *a, **k: None):
        self.module, self.name, self.key = module, name, key
        self.orig = getattr(module, name)
        self.calls = []
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.orig(*args, **kwargs)
        torch.cuda.synchronize()
        self.calls.append((self.key(*args, **kwargs), (time.perf_counter() - t0) * 1e3))
        return out

    def restore(self):
        setattr(self.module, self.name, self.orig)


def _worker_train(spec):
    """cli.train.main(spec['train']) with each step probed (exactly 3 bf16
    launches per query of this rank, 0 f32) and every all_reduce timed; the
    final state on the CPU."""
    import torch
    import torch.distributed as dist
    from nerfloc_tpu_torch.cli import train as cli_train
    states, first = [], []

    class Recorded(cli_train.TrainState):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            states.append(self)

        def apply_gradients(self, grads):
            if not first:
                first.append(grads.detach().cpu().clone())
            super().apply_gradients(grads)
    cli_train.TrainState = Recorded
    probe = StepProbe(cli_train, "make_train_step", 3 * spec["queries_per_rank"],
                      "ddp train step")
    reduces = Timed(dist, "all_reduce", lambda t, *a, **k: (t.numel(), t.element_size()))
    try:
        if cli_train.main(spec["train"]) != 0:
            fail("parallel: cli.train returned non-zero")
    finally:
        probe.restore()
        reduces.restore()
    st = states[0]
    n_params = sum(p.numel() for p in st.params)
    grads = [ms for (n, _), ms in reduces.calls if n == n_params]
    return {"model": {k: v.detach().cpu() for k, v in st.model.state_dict().items()},
            "first_grad": first[0],
            "sizes": [(n, p.numel()) for n, p in st.model.named_parameters()], "step": st.step, "step_ms": probe.ms, "launches": probe.launches,
            "grad_reduce_ms": grads, "n_params": n_params,
            "backend": dist.get_backend() if dist.is_initialized() else None}


def _worker_render(spec):
    """One 240x320 frame of the default f32 model (as phase 8): with a
    world of 2, render_image_ray_sharded over a (1, 2) mesh; alone,
    render_image. Launches of the first frame, ms of 3 more."""
    import torch
    import torch.distributed as dist
    from nerfloc_tpu_torch.configs import Config, RenderConfig
    from nerfloc_tpu_torch.data import device_batch, make_query_batch
    from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
    from nerfloc_tpu_torch.parallel.mesh import MeshSpec, make_mesh, world
    from nerfloc_tpu_torch.parallel.render import (make_context_builder,
                                                   make_ray_sharded_render,
                                                   render_image_ray_sharded)
    dev = torch.device("cuda", torch.cuda.current_device())
    H, W = 240, 320
    cfg = Config(render=RenderConfig(fused_query_agg=True))
    model = NerfPoseEstimator(cfg, device=dev, seed=0)
    batch = to_device_batch(device_batch(make_query_batch(n_views=5, H=H, W=W, seed=0)), dev)
    sharded = world()[1] > 1
    with torch.no_grad():
        if sharded:
            mesh = make_mesh(MeshSpec(data=1, ray=RAY_WIDTH))
            ctx = make_context_builder(model)(batch)
            render = make_ray_sharded_render(model, cfg, mesh)

            def frame():
                return render_image_ray_sharded(model, cfg, ctx, batch["K"], batch["pose"],
                                                H, W, mesh, render=render)
        else:
            ctx, _ = model.build_context(batch)

            def frame():
                return model.model_3d.render_image(ctx, batch["K"], batch["pose"], H, W)
        frame()
        torch.cuda.synchronize()
        zero_launch_counts()
        img = frame()
        torch.cuda.synchronize()
        launches = launch_counts()
        gathers = Timed(dist, "all_gather") if sharded else None
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            frame()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if gathers is not None:
            gathers.restore()
    return {"launches": launches, "frame_ms": times,
            "gather_ms": [ms for _, ms in gathers.calls] if gathers else [],
            **{k: img[k].cpu() for k in ("rgb", "depth", "mask")}}


def _worker_test(spec):
    """cli.test.main(spec['test']) with each query probed (exactly 55 bf16
    launches) and the metric gather timed; this rank's table."""
    from nerfloc_tpu_torch.cli import test as cli_test
    from nerfloc_tpu_torch.train import evaluate
    tables = []
    orig_eval = cli_test.eval_dataset

    def eval_dataset(*a, **k):
        tables.append(orig_eval(*a, **k))
        return tables[-1]
    cli_test.eval_dataset = eval_dataset
    probe = StepProbe(cli_test, "make_eval_step", EVAL_LAUNCHES, "ddp eval query")
    gather = Timed(evaluate, "allgather_metrics")
    try:
        if cli_test.main(spec["test"]) != 0:
            fail("parallel: cli.test returned non-zero")
    finally:
        probe.restore()
        gather.restore()
        cli_test.eval_dataset = orig_eval
    table = {k: v for k, v in tables[0].items() if k != "_poses"}
    return {"table": table, "query_ms": probe.ms, "launches": probe.launches,
            "gather_ms": [ms for _, ms in gather.calls]}


def worker(spec_path: str) -> int:
    """One process of phase 16 (`chip_smoke.py --worker <spec.json>`, under
    torchrun or alone): the parts the spec names, in order, each result
    saved to <out>/<tag>_rank<r>.pt."""
    _worker_setup()
    import warnings
    import torch
    from nerfloc_tpu_torch.parallel.mesh import init_distributed, launched, world
    spec = json.load(open(spec_path))
    if launched():
        init_distributed(spec["backend"], "cuda")
    else:
        torch.cuda.set_device(0)
    # deterministic kernels where torch has them (CUBLAS_WORKSPACE_CONFIG
    # is set by _run_ranks); an op without one warns, and its name is kept
    torch.use_deterministic_algorithms(True, warn_only=True)
    parts = {"train": _worker_train, "render": _worker_render, "test": _worker_test}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = {part: parts[part](spec) for part in spec["parts"]}
    res["nondeterministic"] = sorted({str(w.message).split(" does not have a deterministic")[0]
                                      for w in caught
                                      if "does not have a deterministic" in str(w.message)})
    torch.save(res, os.path.join(spec["out"], f"{spec['tag']}_rank{world()[0]}.pt"))
    if launched():
        torch.distributed.destroy_process_group()
    return 0


def _run_ranks(tag: str, n: int, spec: dict, out: str, timeout: float):
    """Phase 16's worker as n torchrun ranks (n = 0: one process without
    torchrun), PYTHONHASHSEED=0 in every process so that dataset items draw
    alike, cuBLAS with a fixed workspace (deterministic algorithms);
    returns each rank's results. Kills what is left on a timeout."""
    import torch
    spec = {**spec, "tag": tag, "out": out}
    path = os.path.join(out, f"{tag}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    script = os.path.abspath(__file__)
    cmd = [sys.executable, script, "--worker", path] if n == 0 else \
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={n}", script, "--worker", path]
    env = {**os.environ, "PYTHONHASHSEED": "0", "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        log, _ = proc.communicate()
        fail(f"parallel {tag}: timed out after {timeout} s:\n{log[-4000:]}")
    if proc.returncode != 0:
        fail(f"parallel {tag}: exit {proc.returncode}:\n{log[-6000:]}")
    wall = time.perf_counter() - t0
    return [torch.load(os.path.join(out, f"{tag}_rank{r}.pt"), weights_only=False)
            for r in range(max(n, 1))], wall


def _leaf_dist(a, b):
    return {k: float((a[k].double() - v.double()).norm()) for k, v in b.items()}


def _grad_leaves(flat, sizes):
    """The flat first-step gradient split into {parameter name: values}."""
    return dict(zip([n for n, _ in sizes], flat.split([k for _, k in sizes])))


def _leaves_agree(got, want, what: str):
    """Per leaf ||got - want|| against PAR_TOL ||want|| + 1e-8 ||want||_all
    (the floor covers leaves that are zero in exact arithmetic). Prints the
    leaves nearest their bound; returns (the largest share of the bound
    used, its leaf): the caller fails above 1."""
    d = _leaf_dist(got, want)
    total = math.sqrt(sum(float(v.double().norm()) ** 2 for v in want.values()))
    rows = sorted(((d[k] / (PAR_TOL * float(v.double().norm()) + 1e-8 * total + 1e-30), k)
                   for k, v in want.items()), reverse=True)
    print(f"{what}: {sum(1 for k in want if d[k] > 0)} of {len(want)} leaves differ; "
          f"leaves nearest the bound (share, ||diff||, ||leaf||): " +
          "; ".join(f"{k} {r:.3g} {d[k]:.3g} {float(want[k].double().norm()):.3g}"
                    for r, k in rows[:5]))
    return rows[0]


def _tables_agree(a: dict, b: dict, what: str) -> float:
    """Same rows and keys; counts and pose_acc equal; each error within
    PAR_TOL of max(1, |value|). Returns the largest share of the bound
    used."""
    if sorted(a) != sorted(b):
        fail(f"{what}: rows {sorted(a)} against {sorted(b)}")
    worst = 0.0
    for row in a:
        if sorted(a[row]) != sorted(b[row]):
            fail(f"{what}: row {row} keys differ")
        for k, v in a[row].items():
            w = b[row][k]
            if k in ("n", "files", "pose_acc"):
                if v != w:
                    fail(f"{what}: {row}.{k} {v} against {w}")
                continue
            share = abs(v - w) / (PAR_TOL * max(1.0, abs(w)))
            worst = max(worst, share)
            if not share <= 1.0:
                fail(f"{what}: {row}.{k} {v} against {w}")
    return worst


def parallel_on_files(dev, card: str, cli: dict):
    """Phase 16: data-parallel cli.train, the ray-sharded render and the
    multi-process cli.test on phase 14's scenes (see the module docstring).
    Returns its numbers."""
    import torch
    torch.cuda.empty_cache()
    root, paths, ckpts = cli["cli_root"], cli["cli_paths"], cli["cli_ckpts"]
    out = os.path.join(root, "parallel")
    os.makedirs(out)

    def spec(kind: str, backend: str, parts, n_ranks: int):
        return {"backend": backend, "parts": parts, "queries_per_rank": 2 // n_ranks,
                "train": ["--config", paths["train"], "--basedir", os.path.join(out, kind),
                          "--batch", "2", "--eval_interval", "1", "--train_render_views", "1",
                          "--dist_backend", backend, "--device", "cuda"],
                "test": ["--config", paths["test"], "--ckpt", ckpts, "--out",
                         os.path.join(out, kind, "eval", "results.json"),
                         "--dist_backend", backend, "--device", "cuda"]}
    both = ["train", "render", "test"]
    two, two_s = _run_ranks("gloo2", 2, spec("gloo2", "gloo", both, 2), out, 600)
    one, one_s = _run_ranks("one", 0, spec("one", "gloo", both, 1), out, 600)
    nccl, nccl_s = _run_ranks("nccl1", 1, spec("nccl1", "nccl", ["train", "test"], 1), out,
                              400)

    # (a) 2 ranks over gloo sharing the card
    t2 = [r["train"] for r in two]
    t1 = one[0]["train"]
    for k, v in t2[0]["model"].items():
        if not torch.equal(v, t2[1]["model"][k]):
            fail(f"parallel: the ranks' {k} differ after the epoch")
    if not t2[0]["step"] == t1["step"] == len(t1["step_ms"]) == len(t2[0]["step_ms"]):
        fail(f"parallel: steps {t2[0]['step']} (2 ranks) against {t1['step']} (one process)")
    # the 1-rank NCCL epoch at B=2 is the one-process arithmetic again:
    # under deterministic algorithms it is bit-equal, which the 2-rank
    # bounds below rely on
    tn = nccl[0]["train"]
    nondet = sorted({m for job in (two, one, nccl) for r in job for m in r["nondeterministic"]})
    print(f"parallel: ops without a deterministic implementation that ran: "
          f"{nondet or 'none'}")
    moved = [k for k, v in t1["model"].items() if not torch.equal(v, tn["model"][k])]
    if moved or not torch.equal(tn["first_grad"], t1["first_grad"]):
        fail(f"parallel (b): one process's B=2 epoch run again (1 NCCL rank) is not "
             f"bit-equal ({len(moved)} leaves differ, e.g. {moved[:3]}); ops without a "
             f"deterministic implementation: {nondet or 'none'}")
    leaf, leaf_k = _leaves_agree(
        *(_grad_leaves(t["first_grad"], t1["sizes"]) for t in (t2[0], t1)),
        "parallel (a) first-step gradient, 2 ranks vs one process")
    epoch, epoch_k = _leaves_agree(t2[0]["model"], t1["model"],
                                   "parallel (a) parameters after the epoch, 2 ranks vs one "
                                   "process")
    for share, k, what in ((leaf, leaf_k, "first-step gradient"),
                           (epoch, epoch_k, "parameters after the epoch")):
        if not share <= 1.0:
            fail(f"parallel (a): {what}: {k} at {share:.3g} of PAR_TOL per leaf")
    if t2[0]["backend"] != "gloo" or len(t2[0]["grad_reduce_ms"]) != t2[0]["step"]:
        fail(f"parallel: {len(t2[0]['grad_reduce_ms'])} gradient all-reduces over "
             f"{t2[0]['backend']} for {t2[0]['step']} steps")
    grad_bytes = t2[0]["n_params"] * 4
    ddp_ms = statistics.median(t2[0]["step_ms"] + t2[1]["step_ms"])
    red_ms = statistics.median(t2[0]["grad_reduce_ms"] + t2[1]["grad_reduce_ms"])
    print(f"parallel (a): cli.train on 2 ranks over gloo sharing one card, global batch 2, "
          f"{t2[0]['step']} steps, exactly {t2[0]['launches'][-1]} bf16 fused_agg launches per "
          f"step per rank (1 query each); parameters of the 2 ranks bit-equal; against one "
          f"process at B=2, per leaf within {leaf:.3g} (first-step gradient) and "
          f"{epoch:.3g} (parameters after the epoch) of the bound ({t1['step']} steps, median "
          f"{statistics.median(t1['step_ms']):.2f} ms/step); median {ddp_ms:.2f} ms per DDP step "
          f"(two processes sharing one card: not a scaling number); gradient all-reduce "
          f"{grad_bytes} bytes ({t2[0]['n_params']} f32), median {red_ms:.3f} ms over gloo on "
          f"CUDA tensors; job wall {two_s:.1f} s (one process {one_s:.1f} s); {card}")
    # (b) one rank over NCCL
    if tn["backend"] != "nccl" or len(tn["grad_reduce_ms"]) != tn["step"] or tn["step"] == 0:
        fail(f"parallel (b): {len(tn['grad_reduce_ms'])} gradient all-reduces over "
             f"{tn['backend']} for {tn['step']} steps")
    nccl_ms = statistics.median(tn["grad_reduce_ms"])
    print(f"parallel (b): cli.train as 1 rank over NCCL, {tn['step']} steps at B=2, exactly "
          f"{tn['launches'][-1]} bf16 launches per step of 2 queries, "
          f"{len(tn['grad_reduce_ms'])} NCCL "
          f"gradient all-reduces of {grad_bytes} bytes, median {nccl_ms:.3f} ms; the same "
          f"arithmetic as one process and bit-equal to it (first-step gradient and every "
          f"leaf after the epoch); median {statistics.median(tn['step_ms']):.2f} "
          f"ms/step; job wall {nccl_s:.1f} s; {card}")
    n_dev = torch.cuda.device_count()
    if n_dev >= 2:
        nn2, _ = _run_ranks("nccl2", 2, spec("nccl2", "nccl", ["train"], 2), out, 600)
        m0, m1 = nn2[0]["train"]["model"], nn2[1]["train"]["model"]
        if any(not torch.equal(v, m1[k]) for k, v in m0.items()):
            fail("parallel (c): the NCCL ranks' parameters differ")
        l2, l2_k = _leaves_agree(*(_grad_leaves(t["first_grad"], t1["sizes"])
                                   for t in (nn2[0]["train"], t1)),
                                 "parallel (c) first-step gradient, 2 NCCL ranks vs one")
        if not l2 <= 1.0:
            fail(f"parallel (c): first-step gradient: {l2_k} at {l2:.3g} of PAR_TOL per leaf")
        print(f"parallel (c): 2 ranks over NCCL on 2 cards, within {l2:.3g} of the bound; "
              f"{card}")
    else:
        print(f"parallel (c): {n_dev} card: 2 ranks over NCCL need 2 (NCCL refuses two ranks "
              "on one device); not run")

    # the ray-sharded frame
    r2 = [r["render"] for r in two]
    r1 = one[0]["render"]
    want_per_rank = -(-240 * 320 // (RENDER_CHUNK * RAY_WIDTH))
    frame_err = 0.0
    for r in r2:
        if r["launches"] != (want_per_rank, 0):
            fail(f"parallel: ray-sharded frame launches (f32, bf16) {r['launches']}, expected "
                 f"({want_per_rank}, 0) per rank")
        if not torch.equal(r["mask"], r1["mask"]):
            fail("parallel: the ray-sharded frame's mask differs from render_image's")
        for k in ("rgb", "depth"):
            frame_err = max(frame_err, float((r[k] - r1[k]).abs().max()))
    if r1["launches"] != (2 * want_per_rank, 0) or not frame_err <= FRAME_TOL:
        fail(f"parallel: ray-sharded frame {frame_err:.3g} from render_image "
             f"({r1['launches']} launches alone)")
    frame_ms = statistics.median(r2[0]["frame_ms"] + r2[1]["frame_ms"])
    per_rank = r2[0]["launches"][0]
    print(f"parallel: render_image_ray_sharded 240x320 at ray width {RAY_WIDTH} (gloo, one "
          f"card): {per_rank} f32 launches per rank (render_image alone "
          f"{r1['launches'][0]}), rgb and depth {frame_err:.3g} from render_image; median "
          f"{frame_ms:.2f} ms/frame (alone {statistics.median(r1['frame_ms']):.2f}), "
          f"all_gather median {statistics.median(r2[0]['gather_ms']):.3f} ms; {card}")

    # the multi-process test CLI
    e2 = [r["test"] for r in two]
    e1 = one[0]["test"]
    if e2[0]["table"] != e2[1]["table"]:
        fail("parallel: the ranks' tables differ")
    if nccl[0]["test"]["table"] != e1["table"]:
        fail(f"parallel (b): one process's cli.test run again (1 NCCL rank) gives another "
             f"table: {nccl[0]['test']['table']} against {e1['table']}")
    worst = _tables_agree(e2[0]["table"], e1["table"], "parallel cli.test 2 ranks vs one")
    q_ms = statistics.median(e2[0]["query_ms"] + e2[1]["query_ms"])
    g_ms = statistics.median(e2[0]["gather_ms"] + e2[1]["gather_ms"])
    print(f"parallel: cli.test on 2 ranks ({len(e2[0]['query_ms'])} + {len(e2[1]['query_ms'])} "
          f"queries, cascade + refinement, exactly {e2[0]['launches'][-1]} bf16 launches each, "
          f"noise by test index): tables equal on both ranks, within {worst:.3g} of the "
          f"bound from one process (counts and pose_acc equal; a rerun's table equal); "
          f"median {q_ms:.2f} ms/query (one process "
          f"{statistics.median(e1['query_ms']):.2f}), gather median {g_ms:.3f} ms; table "
          f"{json.dumps(e2[0]['table']['avg'])}; {card}")
    return {"ddp_train_ms_per_step": ddp_ms, "ddp_grad_allreduce_ms": red_ms,
            "ddp_grad_allreduce_bytes": grad_bytes, "nccl_grad_allreduce_ms": nccl_ms,
            "ddp_train_launches_per_step_per_rank": t2[0]["launches"][-1],
            "ray_sharded_frame_ms": frame_ms, "ray_sharded_launches_per_rank": per_rank,
            "ddp_eval_ms_per_query": q_ms, "ddp_eval_launches_per_query": e2[0]["launches"][-1],
            "ddp_gather_ms": g_ms}


def _top_k_agree(pkls, cpu_descs, scenes, tol: float, what: str):
    """Each card top-k list against the CPU's: equal, or equal up to ties,
    i.e. position by position the CPU similarities of the two entries
    within `tol` (and entries one list has beyond the other's end within
    `tol` of the similarity cut at 0). Returns (lists equal, lists equal up
    to ties, the smallest gap between neighbouring similarities)."""
    import numpy as np
    from nerfloc_tpu_torch.data.scene_store import SceneStore
    same = ties = 0
    gap = math.inf
    for i, (base, scene) in enumerate(scenes):
        store = SceneStore.load(base, scene)
        d_train, d_test = (np.asarray(d, np.float64) for d in cpu_descs[2 * i:2 * i + 2])
        index = {f["file_name"]: j for j, f in enumerate(store.train_frames)}
        for split, dq, frames in (("train", d_train, store.train_frames),
                                  ("test", d_test, store.test_frames)):
            q_index = {f["file_name"]: j for j, f in enumerate(frames)}
            for q, got in pkls[("cuda", scene, split)].items():
                want = pkls[("cpu", scene, split)][q]
                sims = [float(dq[q_index[q]] @ d_train[index[n]]) for n in want]
                gap = min([gap] + [abs(a - b) for a, b in zip(sims, sims[1:])])
                if got == want:
                    same += 1
                    continue
                sg = [float(dq[q_index[q]] @ d_train[index[n]]) for n in got]
                n = min(len(sg), len(sims))
                ok = all(abs(a - b) <= tol for a, b in zip(sg[:n], sims[:n])) and \
                    all(abs(v) <= tol for v in sg[n:] + sims[n:])
                if not ok:
                    fail(f"{what}: {scene} {split} {q}: card {got} ({sg}) against CPU {want} "
                         f"({sims}), not within ties of {tol:.3g}")
                ties += 1
    return same, ties, gap


def retrieval_on_files(dev, card: str, scenes):
    """Phase 17: retrieval.pipeline with netvlad and dir at full width
    (seeded random weights) on the written scenes [(base_dir, scene)], on
    the card and on the CPU: pkls equal, descriptors within RETRIEVAL_COS."""
    import pickle

    import numpy as np
    import torch
    from nerfloc_tpu_torch.data.scene_store import SceneStore
    from nerfloc_tpu_torch.retrieval import pipeline as rp
    descs = []
    orig = rp.extract_descriptors

    def recorded(*a, **k):
        descs.append(orig(*a, **k))
        return descs[-1]
    rp.extract_descriptors = recorded
    res = {}
    try:
        for method in ("netvlad", "dir"):
            model = rp.retrieval_model(method)
            pkls = {}
            for where in ("cuda", "cpu"):
                descs.clear()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                n_frames = 0
                for base, scene in scenes:
                    store = SceneStore.load(base, scene)
                    rp.run_scene_retrieval(store, method, RETRIEVAL_K, model=model,
                                           device=dev if where == "cuda" else "cpu")
                    n_frames += len(store.train_frames) + len(store.test_frames)
                    for split in ("train", "test"):
                        with open(os.path.join(store.scene_dir,
                                               f"image_retrieval_{split}_{method}.pkl"),
                                  "rb") as f:
                            pkls[(where, scene, split)] = pickle.load(f)
                wall = (time.perf_counter() - t0) * 1e3
                if where == "cuda":
                    peak = torch.cuda.max_memory_allocated() / 2**30
                    cuda_descs, cuda_wall = list(descs), wall
            cos = min(float(np.min(np.sum(a * b, axis=1) /
                                   (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))))
                      for a, b in zip(cuda_descs, descs))
            if not 1.0 - cos <= RETRIEVAL_COS:
                fail(f"retrieval {method}: descriptors' cosine {cos} between card and CPU")
            # a similarity is known to within 2 eps (unit descriptors eps apart)
            eps = max(float(np.max(np.linalg.norm(a - b, axis=1)))
                      for a, b in zip(cuda_descs, descs))
            same, ties, gap = _top_k_agree(pkls, descs, scenes, 2 * eps + 1e-5,
                                           f"retrieval {method}")
            model.to(dev)
            x = torch.rand(8, 224, 224, 3, generator=torch.Generator().manual_seed(0)).to(dev)
            with torch.no_grad():
                model(x)
                times = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    model(x)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3 / 8)
            ms = statistics.median(times)
            n_lists = sum(len(t) for (w, _, _), t in pkls.items() if w == "cuda")
            print(f"retrieval {method}: {len(scenes)} scenes, {n_frames} frames, {n_lists} "
                  f"top-{RETRIEVAL_K} lists: {same} equal on the card and the CPU, {ties} "
                  f"equal up to similarity ties within 2 eps + 1e-5 = {2 * eps + 1e-5:.3g} "
                  f"(eps = {eps:.3g}, the largest distance of a card descriptor from its CPU "
                  f"one; the closest pair of similarities in any list {gap:.3g}), "
                  f"descriptors' cosine >= {cos:.7f}; model forward at batch 8, 224x224: "
                  f"median {ms:.3f} "
                  f"ms/frame; the pipeline on the card {cuda_wall / n_frames:.2f} ms/frame "
                  f"(file reads and resizing included), peak memory {peak:.2f} GiB; {card}")
            res[f"retrieval_{method}_ms_per_frame"] = ms
            res[f"retrieval_{method}_peak_gib"] = peak
            del model
            torch.cuda.empty_cache()
    finally:
        rp.extract_descriptors = orig
    return res


# phase 18: scene preparation on the card. A 7-Scenes-layout scene at the
# dataset's own 640x480 and f = 525 (preprocess.seven_scenes' constants):
# two train sequences and one test sequence of PREP_FRAMES frames each
# (the cut: the frame counts), preprocessed at the module's defaults (voxel
# 0.02, stride 5); the data YAML's tempo_interval PREP_TEMPO leaves the
# CLIs a few train steps and two test queries
PREP_SCENE, PREP_FRAMES, PREP_TEMPO = "chess", 40, 20
PREP_TRAIN_SEQS, PREP_TEST_SEQS = (1, 2), (3,)
TSDF_BYTES_PER_UPDATE = 40        # a voxel the frame updates: 5 floats read, 5 written


class Buckets:
    """Host-clock time of wrapped callables, by bucket; each call
    synchronized on the card when `sync`. `restore` unwraps them all."""

    def __init__(self, sync: bool):
        self.sync, self.ms, self.wrapped = sync, defaultdict(float), []

    def wrap(self, owner, name: str, bucket: str, record=None):
        import torch
        orig, raw = getattr(owner, name), vars(owner)[name]

        def timed(*a, **k):
            if self.sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*a, **k)
            if self.sync:
                torch.cuda.synchronize()
            self.ms[bucket] += (time.perf_counter() - t0) * 1e3
            if record is not None:
                record.append((a, (time.perf_counter() - t0) * 1e3))
            return out
        setattr(owner, name, staticmethod(timed) if isinstance(raw, staticmethod) else timed)
        self.wrapped.append((owner, name, raw))

    def restore(self):
        for owner, name, raw in reversed(self.wrapped):
            setattr(owner, name, raw)
        self.wrapped.clear()


def _preprocess_seven_scenes(root: str, device: str):
    """preprocess.seven_scenes.main on `root` for PREP_SCENE on `device`,
    its stages timed (frame reads, percentiles, the frusta's bounds,
    integration, extraction, writes). Returns (wall ms, buckets, the
    integrate calls [(args, ms)], the volumes made)."""
    from nerfloc_tpu_torch.native import tsdf as ntsdf
    from nerfloc_tpu_torch.preprocess import common, seven_scenes
    b = Buckets(sync=device == "cuda")
    integrations, volumes = [], []
    orig_init = ntsdf.TSDFVolume.__init__

    def init(self, *a, **k):
        orig_init(self, *a, **k)
        volumes.append(self)
    for name in ("load_image", "load_depth", "load_pose_txt"):
        b.wrap(seven_scenes, name, "frame reads")
    b.wrap(seven_scenes, "frame_near_far", "percentiles")
    b.wrap(ntsdf.TSDFVolume, "frustum_bounds", "bounds")
    b.wrap(ntsdf.TSDFVolume, "integrate", "integration", record=integrations)
    b.wrap(ntsdf.TSDFVolume, "get_point_cloud", "extraction")
    b.wrap(seven_scenes, "write_info", "writes")
    b.wrap(common, "write_ply_points", "writes")
    ntsdf.TSDFVolume.__init__ = init
    try:
        t0 = time.perf_counter()
        rc = seven_scenes.main([root, PREP_SCENE, "--device", device])
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        ntsdf.TSDFVolume.__init__ = orig_init
        b.restore()
    if rc != 0 or len(volumes) != 1:
        fail(f"prep: seven_scenes on {device}: rc {rc}, {len(volumes)} volumes")
    return wall, dict(b.ms), integrations, volumes[0]


def _tsdf_cost(vol, frames, dev):
    """Per frame (depth and colour on the card, K, c2w, the host's largest
    depth), on a copy of the volume as it was before the frame: the
    kernel's device ms (CUDA events around one launch), the voxels it
    updates, the voxels in front of the camera, the share of bricks the
    host mirror of the kernel's test keeps; integrating the frames in
    order. Returns ([ms], [updated], [in front], [kept share])."""
    import numpy as np
    import torch
    from nerfloc_tpu_torch.native import tsdf as ntsdf
    work = {k: torch.ones_like(v) if k == "tsdf" else torch.zeros_like(v)
            for k, v in vol.volume().items()}
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    nx, ny, nz = (int(d) for d in vol.dims)
    vs = np.float32(vol.voxel_size)
    grid = [torch.as_tensor(vol.origin[a] + np.arange(n, dtype=np.float32) * vs).to(dev)
            for a, n in enumerate((nx, ny, nz))]
    ms, updated, front, kept = [], [], [], []
    for depth, color, K, c2w, depth_max in frames:
        R, t = ntsdf.world_to_camera(c2w)
        cull = ntsdf.cull_planes(vol.dims, vol.origin, vol.voxel_size, vol.sdf_trunc,
                                 np.asarray(K, np.float32).reshape(9), R, t, *depth.shape,
                                 depth_max)
        kept.append(float(ntsdf.brick_keep_mask(vol.dims, vol.origin, vol.voxel_size,
                                                cull).mean()))
        Rt = torch.as_tensor(R).to(dev)
        pz = (grid[0][:, None, None] * Rt[6] + grid[1][None, :, None] * Rt[7]
              + float(t[2]) + grid[2][None, None, :] * Rt[8])
        front.append(int((pz > 0).sum()))
        del pz
        before = work["weight"].clone()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000)   # the card waits while the host sets the launch up
        start.record()
        ntsdf.integrate_frame(work, vol.dims, vol.origin, vol.voxel_size, vol.sdf_trunc,
                              depth, color, np.asarray(K, np.float32).reshape(9), R, t, 1.0,
                              overflow, depth_max)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        updated.append(int((work["weight"] != before).sum()))
    return ms, updated, front, kept


def tsdf_frame_inside(vol, seed: int):
    """A frame whose camera sits inside the volume `vol` near its low-z
    face, looking along +z (rotation identity), one float32 step in front
    of a plane of voxel centres: that plane's voxels are at pz = one ulp of
    their z, where most projections leave the int range (skipped and
    counted), so culling meets the overflow slab. A 640x480 frame at
    7-Scenes' intrinsics, depth 0.5-3 m and colour from `seed`. Returns
    (depth, color, K, c2w), numpy."""
    import numpy as np
    from nerfloc_tpu_torch.native import tsdf as ntsdf
    rng = np.random.default_rng(seed)
    H, W = 480, 640
    K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]])
    cent = ntsdf.axis_centres(vol.dims, vol.origin, vol.voxel_size)
    c2w = np.eye(4)
    c2w[0, 3], c2w[1, 3] = (float(c[len(c) // 2]) + 0.003 for c in cent[:2])
    c2w[2, 3] = float(np.nextafter(cent[2][5], np.float32(-np.inf)))
    depth = rng.uniform(0.5, 3.0, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.05] = 0.0
    color = rng.random((H, W, 3), dtype=np.float32)
    return depth, color, K, c2w


def tsdf_inside_check(vol, dev):
    """tsdf_frame_inside into a fresh volume of `vol`'s grid on the card
    and through the host copy: volumes bit-equal, overflow counts equal and
    not 0, exactly one launch. Returns (overflows, kept share)."""
    import numpy as np
    import torch
    from nerfloc_tpu_torch.native import tsdf as ntsdf
    depth, color, K, c2w = tsdf_frame_inside(vol, seed=18)
    vols = {}
    for d in (dev, torch.device("cpu")):
        v = ntsdf.TSDFVolume.on_grid(vol.dims, vol.origin, vol.voxel_size, vol.sdf_trunc, d)
        n0 = ntsdf.LAUNCHES.n
        v.integrate(color, depth, K, c2w)
        if d.type == "cuda":
            torch.cuda.synchronize()
            if ntsdf.LAUNCHES.n - n0 != 1:
                fail(f"prep: {ntsdf.LAUNCHES.n - n0} tsdf launches for the inside frame")
        vols[d.type] = v
    for k, t in vols["cuda"].volume().items():
        if not torch.equal(t.cpu(), vols["cpu"].volume()[k]):
            fail(f"prep: the inside frame's {k} differs between the card and the host copy")
    over = (vols["cuda"].projection_overflows, vols["cpu"].projection_overflows)
    if over[0] != over[1] or over[0] == 0:
        fail(f"prep: inside frame overflow counts {over} (card, host), expected equal, not 0")
    R, t = ntsdf.world_to_camera(c2w)
    cull = ntsdf.cull_planes(vol.dims, vol.origin, vol.voxel_size, vol.sdf_trunc,
                             np.asarray(K, np.float32).reshape(9), R, t, *depth.shape,
                             ntsdf.frame_depth_max(depth))
    kept = float(ntsdf.brick_keep_mask(vol.dims, vol.origin, vol.voxel_size, cull).mean())
    del vols
    return over[0], kept


def prepare_on_files(dev, card: str, files: str):
    """Phase 18: offline scene preparation on the card (see the module
    docstring), under files/prep. Returns the tsdf_integrate `kernels`
    entry and the phase's numbers."""
    import pickle
    import shutil

    import numpy as np
    import torch
    from nerfloc_tpu_torch.cli import test as cli_test
    from nerfloc_tpu_torch.cli import train as cli_train
    from nerfloc_tpu_torch.configs import load_config
    from nerfloc_tpu_torch.data import build_dataset
    from nerfloc_tpu_torch.data import synthetic as syn
    from nerfloc_tpu_torch.data.ply import read_ply_points
    from nerfloc_tpu_torch.native import tsdf as ntsdf
    from nerfloc_tpu_torch.preprocess import cambridge, onepose, twelve_scenes
    from nerfloc_tpu_torch.retrieval import pipeline as rp
    t_phase = time.perf_counter()
    with _subdir(files, "prep") as root:
        # (a) the raw scene, preprocessed on the card and on the CPU
        card_root, cpu_root = os.path.join(root, "card"), os.path.join(root, "cpu")
        t0 = time.perf_counter()
        syn.write_seven_scenes_raw(card_root, PREP_SCENE, PREP_TRAIN_SEQS, PREP_TEST_SEQS,
                                   n_frames=PREP_FRAMES)
        shutil.copytree(card_root, cpu_root)
        write_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_launch_counts()
        wall, parts, calls, vol = _preprocess_seven_scenes(card_root, dev.type)
        launches = ntsdf.LAUNCHES.n
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        n_fused = len(PREP_TRAIN_SEQS) * len(range(0, PREP_FRAMES, 5))
        if launches != n_fused or len(calls) != n_fused or launch_counts() != (0, 0):
            fail(f"prep: {launches} tsdf launches for {len(calls)} integrations of {n_fused} "
                 f"frames (fused_agg {launch_counts()})")
        cpu_wall, cpu_parts, cpu_calls, cpu_vol = _preprocess_seven_scenes(cpu_root, "cpu")
        # the card's volume against the host copy's, after the last frame
        max_err = 0.0
        for k, v in vol.volume().items():
            d = (v.cpu() - cpu_vol.volume()[k]).abs()
            max_err = max(max_err, float(d.max()))
            if not torch.equal(v.cpu(), cpu_vol.volume()[k]):
                fail(f"prep: the card's {k} is not the host copy's: {int((d > 0).sum())} "
                     f"voxels differ, by at most {float(d.max())}")
        sd, cd = (os.path.join(r, PREP_SCENE) for r in (card_root, cpu_root))
        for name in ("info_train.pkl", "info_test.pkl", "pc.ply"):
            with open(os.path.join(sd, name), "rb") as a, open(os.path.join(cd, name), "rb") as b:
                if a.read() != b.read():
                    fail(f"prep: {name} of the cuda run differs from the cpu run's")
        overflows = (vol.projection_overflows, cpu_vol.projection_overflows)
        n_vox = int(np.prod(vol.dims))
        n_points = len(pickle.load(open(os.path.join(sd, "info_train.pkl"), "rb")))
        xyz, _ = read_ply_points(os.path.join(sd, "pc.ply"))
        if not (len(xyz) > 1000 and np.isfinite(xyz).all()):
            fail(f"prep: pc.ply has {len(xyz)} points")

        # the kernel alone, per frame, frames already on the card
        frames = []
        for (self_, color, depth, K, c2w, *_), _ms in calls:
            frames.append((self_._upload(depth), self_._upload(color), K, c2w,
                           ntsdf.frame_depth_max(depth)))
        k_ms, updated, front, kept = _tsdf_cost(vol, frames, dev)
        k_ms2, _, _, _ = _tsdf_cost(vol, frames, dev)
        inside_over, inside_kept = tsdf_inside_check(vol, dev)
        host_ms = [ms for _, ms in cpu_calls]
        H, W = frames[0][0].shape
        nbytes = [u * TSDF_BYTES_PER_UPDATE + H * W * 16 for u in updated]
        # float operations: the voxel's centre and depth for every voxel
        # (12), the rest of its projection for the voxels in front (18),
        # the update with colour for the updated ones (22)
        ops = [12 * n_vox + 18 * f + 22 * u for f, u in zip(front, updated)]
        b_bytes = statistics.median(nbytes) / PEAK_BYTES_PER_S * 1e3
        b_ops = statistics.median(ops) / PEAK_F32_FLOPS * 1e3
        bound_ms, bound_by = max((b_bytes, "bytes"), (b_ops, "operations"))
        kernel_ms = statistics.median(k_ms + k_ms2)
        if kernel_ms < bound_ms:
            fail(f"prep: tsdf_integrate reads faster than its bound ({kernel_ms} < {bound_ms})")
        print(f"prep: wrote {len(PREP_TRAIN_SEQS) + len(PREP_TEST_SEQS)} sequences of "
              f"{PREP_FRAMES} 640x480 frames in {write_s:.2f} s; volume {vol.dims.tolist()} = "
              f"{n_vox} voxels at 0.02; {launches} tsdf launches for {n_fused} fused frames "
              f"(exactly one per frame), the card's volume (tsdf, weight, r, g, b) bit-equal to "
              f"the host copy's, pkls and pc.ply ({len(xyz)} points) equal to the cpu run's; "
              f"voxels whose projection left the int range: {overflows[0]} (card), "
              f"{overflows[1]} (host); a frame from inside the volume near its low-z face: "
              f"one launch, bit-equal, {inside_over} voxels left the int range on both, "
              f"the host mirror of the brick test keeps {100 * inside_kept:.1f} % of its "
              f"bricks; {card}")
        print(f"prep tsdf_integrate: kernel median {kernel_ms:.4f} ms per frame over "
              f"{len(k_ms) * 2} launches (min {min(k_ms + k_ms2):.4f}, max "
              f"{max(k_ms + k_ms2):.4f}), {n_vox / kernel_ms / 1e6:.3f} G voxels/s; updated "
              f"voxels per frame median {statistics.median(updated)}, in front "
              f"{statistics.median(front)}, bricks the host mirror of the kernel's brick "
              f"test keeps (a prediction from brick_keep_mask, not read from the kernel; of "
              f"{int(np.prod([-(-int(d) // ntsdf.BRICK) for d in vol.dims]))}) median "
              f"{100 * statistics.median(kept):.1f} % (min {100 * min(kept):.1f}, max "
              f"{100 * max(kept):.1f}); bound {bound_ms:.5f} ms by {bound_by} (bytes "
              f"{statistics.median(nbytes) / 1e6:.3f} MB: {b_bytes:.5f} ms; operations "
              f"{statistics.median(ops) / 1e6:.1f} M at the FP32 peak: {b_ops:.5f} ms); host "
              f"copy median {statistics.median(host_ms):.2f} ms per frame (one thread, "
              f"with the wrapper); the wrapper on the card with the upload "
              f"{statistics.median([ms for _, ms in calls]):.3f} ms per frame; peak memory of "
              f"the preprocessing (above what earlier phases hold) {peak:.3f} GiB; {card}")
        split = {k: round(v, 2) for k, v in parts.items()}
        print(f"prep end to end ({dev.type}): {wall:.2f} ms for {n_points} train and "
              f"{len(PREP_TEST_SEQS) * PREP_FRAMES} test frames, {n_fused} of them fused; "
              f"stages (ms) {json.dumps(split)}; cpu run {cpu_wall:.2f} ms, stages "
              f"{json.dumps({k: round(v, 2) for k, v in cpu_parts.items()})}; {card}")
        del frames, vol, cpu_vol
        torch.cuda.empty_cache()

        # (b) retrieval, cli.train and cli.test on the preprocessed scene
        data_path = _write_data_yaml(root, "video_7scenes", [PREP_SCENE])
        doc = json.load(open(data_path))
        doc.update(base_dir=card_root, tempo_interval=PREP_TEMPO)
        write_flow_yaml(data_path, doc)
        overrides = {"dataset_type": data_path, "scenes": [PREP_SCENE], "max_epochs": 1}
        test_overrides = {**overrides, "cascade_matching": True, "optimize_pose": True}
        paths = {kind: _write_config(root, f"prep_{kind}", "7scenes_all.yaml", ov)
                 for kind, ov in (("train", overrides), ("test", test_overrides))}
        t0 = time.perf_counter()
        if rp.main(["--config", paths["train"], "--method", "netvlad",
                    "--device", dev.type]) != 0:
            fail("prep: retrieval failed")
        retrieval_s = time.perf_counter() - t0
        for split in ("train", "test"):
            table = pickle.load(open(os.path.join(sd, f"image_retrieval_{split}_netvlad.pkl"),
                                     "rb"))
            frames = pickle.load(open(os.path.join(sd, f"info_{split}.pkl"), "rb"))
            if set(table) != {f["file_name"] for f in frames} or \
                    (split == "test" and not all(table.values())):
                fail(f"prep: the {split} retrieval pkl misses frames or lists")
        cfg = load_config(paths["train"])
        n_train = len(build_dataset(cfg, "train", mode="train"))
        runs = os.path.join(root, "runs")
        t0 = time.perf_counter()
        probe = _train_cli(cli_train, ["--config", paths["train"], "--basedir", runs,
                                       "--batch", "1", "--eval_interval", "2",
                                       "--train_render_views", "0", "--device", dev.type],
                           3, "prep cli train step", n_train)
        train_s = time.perf_counter() - t0
        probe.batches.clear()
        run_dir = os.path.join(runs, cfg.expname or "default", cfg.version)
        _read_log(run_dir, "prep cli train")
        out_json = os.path.join(root, "eval", "results.json")
        t0 = time.perf_counter()
        tprobe, per_scene = _test_cli(
            cli_test, ["--config", paths["test"], "--ckpt", os.path.join(run_dir, "ckpts"),
                       "--out", out_json, "--device", dev.type],
            EVAL_LAUNCHES, "prep cli eval query", 2, out_json, [PREP_SCENE])
        test_s = time.perf_counter() - t0
        print(f"prep pipeline: retrieval (netvlad, seeded weights) {retrieval_s:.2f} s; "
              f"cli.train {n_train} steps, exactly {probe.launches[-1]} bf16 fused_agg launches "
              f"each, median {statistics.median(probe.ms):.2f} ms/step, {train_s:.2f} s with "
              f"the model's set-up; cli.test 2 queries, exactly {tprobe.launches[-1]} each, "
              f"median {statistics.median(tprobe.ms):.2f} ms/query, {test_s:.2f} s; table "
              f"{json.dumps(per_scene)}; {card}")

        # (c) the other preprocessors, and the families, through build_dataset
        t0 = time.perf_counter()
        other = os.path.join(root, "other")
        syn.write_twelve_scenes_raw(other, "apt1", "kitchen", n_train=8, n_test=2)
        syn.write_onepose_raw(other, "0447-synthetic-box", n_seqs=3, n_frames=4)
        syn.write_cambridge_raw(other, "KingsCollege", n_train=4, n_test=2)
        syn.write_colmap_workspace(os.path.join(other, "ws"), H=480, W=640)
        other_write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for rc in (twelve_scenes.main([other, "apt1/kitchen"]),
                   onepose.main([other, "0447-synthetic-box"]),
                   cambridge.main([other, "KingsCollege", "--no-mvs"])):
            if rc != 0:
                fail("prep: a preprocessor failed")
        other_prep_s = time.perf_counter() - t0
        checks = [("12scenes/apt1_kitchen.yaml", "video_12scenes", "apt1/kitchen"),
                  ("onepose/0447.yaml", "video_onepose", "0447-synthetic-box"),
                  ("cambridge/KingsCollege.yaml", "video_cambridge", "KingsCollege"),
                  ("7scenes_all.yaml", "colmap", "ws")]
        counts = {}
        t0 = time.perf_counter()
        for base, family, scene in checks:
            if family == "colmap":
                ov = {"dataset_type": "colmap", "datadir": other, "scenes": [scene]}
                hw = (480, 640)
            else:
                ov = {"dataset_type": _write_data_yaml(other, family, [scene]),
                      "scenes": [scene]}
                pad = [t["PadToSize"] for t in json.load(open(ov["dataset_type"]))["TRANSFORM"]
                       if "PadToSize" in t][0]
                hw = (pad["height"], pad["width"])
            cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                           "configs", base), ov)
            for mode in ("train", "test"):
                ds = build_dataset(cfg, mode, mode=mode)
                V = cfg.n_views_train if mode == "train" else cfg.n_views_test
                counts[f"{family}/{mode}"] = len(ds)
                if len(ds) == 0:
                    fail(f"prep: {family} {mode} has no items")
                for i in range(len(ds)):
                    _check_item(ds[i], hw, V, f"prep {family} {mode} item {i}")
        items_s = time.perf_counter() - t0
        print(f"prep other families: wrote 12-Scenes (1296x968 JPEG), OnePose (512x512), "
              f"Cambridge (1920x1080) and a COLMAP workspace (480x640) in {other_write_s:.2f} s, "
              f"preprocessed the first three in {other_prep_s:.2f} s (Cambridge --no-mvs); "
              f"build_dataset items {json.dumps(counts)}, all finite at their configs' shapes, "
              f"in {items_s:.2f} s; phase 18 {time.perf_counter() - t_phase:.2f} s; {card}")
    entry = {
        "name": "tsdf_integrate", "route": "cuda",
        "source": "nerfloc_tpu_torch/csrc/tsdf.cu",
        "replaces": "nerfloc_tpu/native/tsdf.cpp:63",
        "replaces_kind": "host C++ (OpenMP), not a TPU kernel",
        "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
        "plain_ms": statistics.median(host_ms), "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "launches_per": "scene (one per fused frame)",
        "voxels": n_vox, "voxels_per_s": n_vox / kernel_ms * 1e3, "peak_gib": peak,
        "inside_frame_overflows": inside_over,
        "prep_ms": wall, "prep_stages_ms": parts, "projection_overflows": overflows[0],
        "prep_train_launches_per_step": probe.launches[-1],
        "prep_eval_launches_per_query": tprobe.launches[-1],
    }
    return entry


# -- phase 19: the options that are off by default --------------------------

RENDER_OPTIONS = {
    "flat": dict(knn_mode="flat"),
    "ray": dict(knn_mode="ray"),
    "ray_onehot": dict(knn_mode="ray", geo_assembly="onehot"),
    "merged": dict(use_merged_table=True),
    "int8": dict(table_dtype="int8"),
    "prune2": dict(prune_views=2),
}
OPT_CALLS = 5               # timed render_rays calls / queries / steps per option
N_SFM = 8192                # seeded SfM points of the full-width SfM queries
OPT_HW = (240, 320)         # the full-width query and support size
RESIZE_HW = 40              # a support side of 8 mod 16: DepthFusionNet's resize


def sfm_points(batch, n: int, seed: int):
    """n points back-projected from seeded query pixels with depth (the
    scene's SfM points; their last tenth masked out), on batch's device."""
    import torch
    g = torch.Generator().manual_seed(seed)
    depth, K, c2w = (batch[k].float().cpu() for k in ("depth", "K", "pose"))
    v, u = torch.nonzero(depth > 0, as_tuple=True)
    pick = torch.randperm(len(u), generator=g)[:n]
    u, v = u[pick].float(), v[pick].float()
    d = depth[v.long(), u.long()]
    cam = torch.stack([(u - K[0, 2]) / K[0, 0] * d, (v - K[1, 2]) / K[1, 1] * d, d], -1)
    pts = cam @ c2w[:3, :3].T + c2w[:3, 3]
    mask = torch.arange(len(pts)) < len(pts) - len(pts) // 10
    dev = batch["K"].device
    return pts.to(dev), mask.to(dev)


def to_device(obj, dev):
    """A scene context (dataclasses, NamedTuples and tensors) on dev."""
    import dataclasses
    import torch
    if torch.is_tensor(obj):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: to_device(getattr(obj, f.name), dev)
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_device(x, dev) for x in obj))
    return obj


def options_small_vs_cpu(dev):
    """Phase 19a: each render option's render_rays on a 32x32, V=3 context
    (dense S=8, 64 rays, same weights) on CUDA against the CPU within
    PATH_TOL, masks equal: from the same CPU-built context moved to the
    card (the option's render path alone), and end to end (each device
    builds its own context) but for table_dtype='int8', whose rounding
    turns the devices' last-bit feature differences into whole
    quantization steps (printed); then localize_forward with
    simple_3d_model, with keypoints_3d_source='sfm' (seeded points3d) and
    at 40x40 support views (DepthFusionNet's resize), CUDA against CPU."""
    import dataclasses
    import torch
    from nerfloc_tpu_torch.configs import Config, MatchingConfig, RenderConfig
    from nerfloc_tpu_torch.data import device_batch, make_query_batch
    from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
    from nerfloc_tpu_torch.solve.pnp import gumbel_noise
    cpu = torch.device("cpu")
    nb = device_batch(make_query_batch(n_views=3, H=32, W=32, seed=0))
    worst = {}
    for name, opt in RENDER_OPTIONS.items():
        cfg = Config(backbone2d_fpn_dim=32, model_3d_hidden_dim=32, matcher_hidden_dim=48,
                     n_views_test=3,
                     render=RenderConfig(fused_query_agg=True, N_samples=8, **opt),
                     matching=MatchingConfig(fine_num_3d_keypoints=32,
                                             coarse_num_3d_keypoints=32))
        models = {d: NerfPoseEstimator(cfg, device=d, seed=3) for d in (cpu, dev)}
        batches = {d: to_device_batch(nb, d) for d in (cpu, dev)}
        rays = seeded_rays(batches[cpu], 64, seed=5)
        with torch.no_grad():
            ctx = models[cpu].build_context(batches[cpu])[0]
            ref = models[cpu].model_3d.render_rays(ctx, *rays, batches[cpu]["pose"])
            runs = {"same context": models[dev].model_3d.render_rays(
                to_device(ctx, dev), *(r.to(dev) for r in rays), batches[dev]["pose"])}
            e2e = models[dev].render_image_rays(batches[dev], *(r.to(dev) for r in rays))
            runs["end to end"] = e2e
        for how, out in runs.items():
            out = {k: v.cpu() for k, v in out.items()}
            errs = {k: float((ref[k] - out[k]).abs().max())
                    for k in ("rgb", "depth", "weights", "feat")}
            gated = how == "same context" or name != "int8"
            print(f"small render {name} ({how}): cuda vs cpu max_abs_err "
                  + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
                  + (f" (tol {PATH_TOL})" if gated else " (printed: int8 rounding)"))
            if gated:
                worst[f"{name} {how}"] = max(errs.values())
                if not max(errs.values()) <= PATH_TOL:
                    fail(f"small render {name} ({how}) differs between CUDA and CPU by "
                         f"{max(errs.values())}")
                if not torch.equal(ref["mask"], out["mask"]):
                    fail(f"small render {name} ({how}) mask differs between CUDA and CPU")
    for name, kw, hw in (("simple_3d_model", dict(simple_3d_model=True), 32),
                         ("sfm", dict(keypoints_3d_source="sfm"), 32),
                         ("resize", {}, RESIZE_HW)):
        base = tiny_cfg()
        cfg = dataclasses.replace(base, n_views_test=3, **kw)
        nbh = device_batch(make_query_batch(n_views=3, H=hw, W=hw, seed=0))
        outs = []
        for d in (torch.device("cpu"), dev):
            m = NerfPoseEstimator(cfg, device=d, seed=3)
            b = to_device_batch(nbh, d)
            if name == "sfm":
                b["points3d"], b["points3d_mask"] = sfm_points(b, 200, seed=9)
            g = torch.Generator().manual_seed(11)
            kp = gumbel_noise((m.n_coarse_points(b),), g, "cpu").to(d)
            pnp = gumbel_noise((cfg.shapes.pnp_hypotheses, 32), g, "cpu").to(d)
            outs.append({k: v.cpu() for k, v in
                         m.localize_forward(b, kp_gumbel=kp, pnp_gumbel=pnp).items()})
        cpu, gpu = outs
        errs = {k: float((cpu[k].float() - gpu[k].float()).abs().max())
                for k in ("desc_3d", "score_matrix")}
        worst[name] = max(errs.values())
        print(f"small query {name} (support {hw}x{hw}): cuda vs cpu max_abs_err "
              + ", ".join(f"{k} {e:.3g}" for k, e in errs.items()) + f" (tol {PATH_TOL})")
        if not worst[name] <= PATH_TOL:
            fail(f"small query {name} differs between CUDA and CPU by {worst[name]}")
        if not torch.equal(cpu["match_j"], gpu["match_j"]):
            fail(f"small query {name} match_j differs between CUDA and CPU")
    return worst


def _timed(fn, n: int):
    """(median ms, min, max) of n calls of fn, each fenced by a sync."""
    import torch
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times), max(times)


def options_full_width(dev, card: str):
    """Phase 19b-c: every render option and both model options at full
    width (default Config, compute_dtype_of: bf16, V=5 at 240x320, seeded
    weights). Returns the numbers for `kernels`."""
    import dataclasses
    import torch
    from nerfloc_tpu_torch.configs import Config, RenderConfig, compute_dtype_of
    from nerfloc_tpu_torch.data import device_batch, make_query_batch, stack_batches
    from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
    from nerfloc_tpu_torch.train.state import TrainState
    from nerfloc_tpu_torch.train.step import make_train_step
    H, W = OPT_HW
    host = device_batch(make_query_batch(n_views=5, H=H, W=W, seed=0))
    batch = to_device_batch(host, dev)
    far = float(batch["far"])
    rays = seeded_rays(batch, RENDER_RAYS, seed=0)
    base = Config(render=RenderConfig(fused_query_agg=True))
    dt = compute_dtype_of(base)
    res = {"options_render_launches_per_call": {}, "options_render_ms": {},
           "options_render_peak_gib": {}}
    renders = {}

    def render_option(name, opt, dtype, timed: bool):
        cfg = dataclasses.replace(base, render=dataclasses.replace(base.render, **opt))
        model = NerfPoseEstimator(cfg, device=dev, seed=0, dtype=dtype)
        nerf = model.model_3d
        with torch.no_grad():
            ctx, _ = model.build_context(batch)

            def call():
                return nerf.render_rays(ctx, *rays, batch["pose"])
            call()
            torch.cuda.synchronize()
            zero_launch_counts()
            out = call()
            torch.cuda.synchronize()
            bf16 = dtype == torch.bfloat16
            n = expect_launches(1, bf16, f"render_rays {name} ({dtype})")
            check_render_out(out, RENDER_RAYS, cfg.render.N_samples, far,
                             f"render_rays {name} ({dtype})")
            if timed:
                torch.cuda.reset_peak_memory_stats()
                ms, lo, hi = _timed(call, OPT_CALLS)
                peak = torch.cuda.max_memory_allocated() / 2**30
                print(f"render_rays {name} bf16 V=5 {H}x{W}, {RENDER_RAYS} rays x "
                      f"{cfg.render.N_samples}: {n} bf16 fused_agg launch per call; median "
                      f"{ms:.2f} ms/call over {OPT_CALLS} (min {lo:.2f}, max {hi:.2f}); peak "
                      f"memory {peak:.2f} GiB; {card}")
                res["options_render_launches_per_call"][name] = n
                res["options_render_ms"][name] = ms
                res["options_render_peak_gib"][name] = peak
        out = {k: v.float().cpu() for k, v in out.items()}
        del model, nerf, ctx
        torch.cuda.empty_cache()
        return out

    renders["proj"] = render_option("proj (default)", {}, dt, timed=True)
    for name, opt in RENDER_OPTIONS.items():
        renders[name] = render_option(name, opt, dt, timed=True)

    def rgb_close(a, b, what):
        err = (renders[a]["rgb"] - renders[b]["rgb"]).abs()
        print(f"{what}: rgb max {float(err.max()):.4g} (bound 0.05), mean "
              f"{float(err.mean()):.4g} (bound 0.01); {card}")
        if not (float(err.max()) < 0.05 and float(err.mean()) < 0.01):
            fail(f"{what}: rgb differs beyond the JAX tests' bounds")
        return float(err.max())
    res["merged_vs_separate_rgb_max"] = rgb_close("merged", "proj",
                                                  "merged table vs separate tables")
    res["int8_vs_bf16_rgb_max"] = rgb_close("int8", "proj", "int8 tables vs bf16 tables")
    res["flat_vs_proj_rgb_max"] = rgb_close("flat", "proj", "knn_mode flat vs proj")
    d_err = float((renders["flat"]["depth"] - renders["proj"]["depth"]).abs().max())
    print(f"knn_mode flat vs proj: depth max {d_err:.4g} (bound 0.5); {card}")
    if not d_err <= 0.5:
        fail(f"knn_mode flat vs proj: depth differs by {d_err}")
    # prune_views = V reorders the views only; the JAX tests' bound is an
    # f32 one (2e-4 rel, 2e-5 abs), so it is held at f32, and at bf16 printed
    for dtype in (torch.float32, dt):
        full = render_option("prune5", dict(prune_views=5), dtype, timed=False)
        ref = renders["proj"] if dtype == dt else render_option("proj", {}, dtype, timed=False)
        worst = 0.0
        for k in ("rgb", "depth", "weights"):
            excess = ((full[k] - ref[k]).abs() - 2e-4 * ref[k].abs()).max()
            worst = max(worst, float((full[k] - ref[k]).abs().max()))
            if dtype == torch.float32 and float(excess) > 2e-5:
                fail(f"prune_views=5 at f32: {k} differs from the unpruned render")
            if dtype == torch.float32 and not torch.equal(full["mask"], ref["mask"]):
                fail("prune_views=5 at f32: mask differs from the unpruned render")
        print(f"prune_views=5 vs unpruned ({str(dtype).split('.')[-1]}): max abs diff "
              f"{worst:.3g}{' (bound 2e-4 rel + 2e-5)' if dtype == torch.float32 else ''}; "
              f"{card}")
        res[f"prune5_vs_unpruned_max_{str(dtype).split('.')[-1]}"] = worst

    # 19c: the model options, localize_forward and one train step each
    points3d, points3d_mask = sfm_points(batch, N_SFM, seed=9)
    for name, kw, launches in (("simple_3d_model", dict(simple_3d_model=True), (0, 0)),
                               ("sfm", dict(keypoints_3d_source="sfm"), (2, 3))):
        cfg = dataclasses.replace(base, **kw)
        model = NerfPoseEstimator(cfg, device=dev, seed=0, dtype=dt)
        b = dict(batch)
        if name == "sfm":
            b["points3d"], b["points3d_mask"] = points3d, points3d_mask
        gen = torch.Generator(device=dev).manual_seed(0)
        model.localize_forward(b, generator=gen)
        torch.cuda.synchronize()
        zero_launch_counts()
        out = model.localize_forward(b, generator=gen)
        torch.cuda.synchronize()
        n_q = expect_launches(launches[0], True, f"localize_forward {name}")
        check_pose(out["pose"], f"localize_forward {name}")
        if name == "sfm":
            ok = (out["mkps3d"][:, None, :] == points3d[points3d_mask][None]).all(-1).any(-1)
            if not bool(ok.all()):
                fail("localize_forward sfm: a keypoint is not a valid SfM point")
        q_ms, q_lo, q_hi = _timed(lambda: model.localize_forward(b, generator=gen), OPT_CALLS)
        stacked = to_device_batch(stack_batches([host]), dev)
        if name == "sfm":
            stacked["points3d"], stacked["points3d_mask"] = points3d[None], points3d_mask[None]
        state = TrainState(model, cfg)
        step = make_train_step(model, cfg)
        losses, t_ms = [], []
        for i in range(1 + OPT_CALLS):
            kp, idx = (v.to(dev) for v in train_noise(model, stacked, seed=i))
            torch.cuda.synchronize()
            zero_launch_counts()
            t0 = time.perf_counter()
            metrics = step(state, stacked, kp_gumbel=kp, ray_idx=idx)
            torch.cuda.synchronize()
            t_ms.append((time.perf_counter() - t0) * 1e3)
            n_t = expect_launches(launches[1], True, f"train step {name} {i}")
            losses.append(float(metrics["loss"]))
            if not math.isfinite(losses[-1]):
                fail(f"train step {name} {i}: loss {losses[-1]} not finite")
        s_ms = statistics.median(t_ms[1:])
        print(f"{name} bf16 V=5 {H}x{W}: localize_forward {n_q} bf16 fused_agg launches, "
              f"median {q_ms:.2f} ms/query over {OPT_CALLS} (min {q_lo:.2f}, max {q_hi:.2f}), "
              f"matches {int(out['match_mask'].sum())}; train step {n_t} launches, median "
              f"{s_ms:.2f} ms/step over {OPT_CALLS} after 1 warm-up, losses "
              + " ".join(f"{x:.5g}" for x in losses) + f"; {card}")
        res[f"{name}_launches_per_query"] = n_q
        res[f"{name}_train_launches_per_step"] = n_t
        res[f"{name}_ms_per_query"] = q_ms
        res[f"{name}_ms_per_step"] = s_ms
        del model, state, step, out
        torch.cuda.empty_cache()
    return res


def _check_item(item, hw, V: int, what: str):
    """A dataset item at its config's shapes, its float arrays finite."""
    import numpy as np
    H, W = hw
    want = {"image": (H, W, 3), "depth": (H, W), "pose": (4, 4), "K": (3, 3),
            "topk_images": (V, H, W, 3), "topk_depths": (V, H, W), "topk_poses": (V, 4, 4),
            "topk_Ks": (V, 3, 3)}
    for k, shape in want.items():
        if tuple(np.shape(item[k])) != shape:
            fail(f"{what}: {k} has shape {np.shape(item[k])}, expected {shape}")
    for k, v in item.items():
        v = np.asarray(v)
        if v.dtype.kind == "f" and not np.isfinite(v).all():
            fail(f"{what}: {k} is not finite")


def _step_alone_ms(cfg, batches, dev) -> float:
    """Median ms of make_train_step on a fresh model of the CLI's config
    over `batches` (the CLI's own device batches, after 2 warm-up steps on
    the first), with no loader thread running: the CLI's steps without the
    data path beside them on the host."""
    import torch
    from nerfloc_tpu_torch.configs import compute_dtype_of
    from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator
    from nerfloc_tpu_torch.train.state import TrainState
    from nerfloc_tpu_torch.train.step import make_train_step
    model = NerfPoseEstimator(cfg, device=dev, seed=0, dtype=compute_dtype_of(cfg))
    state, step = TrainState(model, cfg), make_train_step(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    times = []
    for i, batch in enumerate([batches[0]] * 2 + list(batches)):
        torch.cuda.synchronize()
        zero_launch_counts()
        t0 = time.perf_counter()
        step(state, batch, generator=gen)
        torch.cuda.synchronize()
        expect_launches(3, True, f"cli step alone {i}")
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    del model, state
    torch.cuda.empty_cache()
    return statistics.median(times)


def _host_ms(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def time_fused_agg(model, cfg, dev, launches: int, max_err: float, card: str,
                   bf16: bool = False):
    """Kernel, plain-version and bound times of the fused aggregation at the
    query shapes (coarse K=8 and fine K=1 launches, N = keypoints; every
    tile size, the default one reported) and at the render shape, with the
    model's own weights; for the f32 instantiation (plain version
    reference_agg, bound at the TF32 tensor-core peak, and at the FP32
    one beside it) or the bf16 one (kernel_agg, the bf16 peak, mv_agg and
    the features at 2 bytes). Returns its `kernels` entry."""
    import torch
    from nerfloc_tpu_torch.ops import fused_agg as fa
    C, W = cfg.backbone2d_fpn_dim, cfg.model_3d_hidden_dim
    params = {k: v.detach() for k, v in
              fa.extract_agg_params(model.model_3d, 3 + C).items()}
    n_kp = cfg.matching.fine_num_3d_keypoints
    n_sm = fa._sm_count(dev)
    rd_widths = (params["rd_w1"].shape[1], params["rd_w2"].shape[1])
    tag, tc, nbytes = ("fused_agg bf16", "bf16", 2) if bf16 else ("fused_agg", "tf32", 4)
    plain = fa.kernel_agg if bf16 else fa.reference_agg

    def inputs(N, K, seed):
        x = agg_inputs(N, K, 3 + C, W, seed=seed, dev=dev, params=params)
        return agg_inputs_bf16(x) if bf16 else x
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_f32_ms": 0.0}
    units = []
    tiles = {}

    def info(N, K, rows):
        return tile_info(N, K, rows, params, x["freqs"], 3 + C, bf16)
    for N, K in ((n_kp, 8), (n_kp, 1)):
        x = inputs(N, K, seed=K)
        rows_default = fa.tile_plan(N, K, n_sm, bf16)[0]
        tiles[f"query_k{K}"] = info(N, K, rows_default)
        with torch.no_grad():
            for rows in fa.tile_options(K, bf16):
                r_ms = device_ms(lambda: fa.launch(**x, rows=rows))
                print(f"{tag} N={N} K={K} rows={rows}: kernel {r_ms:.4f} ms"
                      f"{' (default)' if rows == rows_default else ''}; "
                      f"{tile_text(info(N, K, rows))}; {card}")
            k_ms = device_ms(lambda: fa.launch(**x))
            # a cluster tile reads the f32 weights itself: no packing
            packs = not fa.tile_cluster(rows_default, bf16)
            pack_ms = device_ms(lambda: fa.pack_agg_weights(
                params, 3 + C, x["freqs"].numel(), dtype=x["mv_agg"].dtype)) if packs else 0.0
            p_ms = device_ms(lambda: plain(**x))
        prod, other, nbytes_ = cost = agg_cost(N, K, 3 + C, W, params, x["freqs"], nbytes)
        f32_ms, b_ms, unit = agg_bounds(cost, tc)
        smem, stages = fa.smem_plan(rows_default, fa.tile_samples(rows_default, K, bf16), K,
                                    3 + C, x["freqs"].numel(), *rd_widths, bf16=bf16)
        if k_ms < b_ms:
            fail(f"{tag} N={N} K={K} reads faster than its bound ({k_ms} < {b_ms} ms)")
        tot["ms"] += k_ms
        tot["plain_ms"] += p_ms
        tot["bound_ms"] += b_ms
        tot["bound_f32_ms"] += f32_ms
        units.append((b_ms, f"K={K}: {unit}"))
        print(f"{tag} N={N} K={K}: {rows_default}-row tiles ({smem} B shared memory, "
              f"{stages} ring stages, clusters of {fa.tile_cluster(rows_default, bf16)}); "
              f"kernel {k_ms:.4f} ms ("
              f"{f'of which weight packing {pack_ms:.4f} ms' if packs else 'no weight packing'}"
              f"), plain {p_ms:.4f} ms, bound {b_ms:.4f} ms by {unit} "
              f"({100 * b_ms / k_ms:.1f} %), FP32 bound {f32_ms:.4f} ms "
              f"({prod / 1e9:.3f} GFLOP products, {other / 1e9:.3f} GFLOP other, "
              f"{nbytes_ / 1e6:.2f} MB); {card}")
    # render shape: N = 4096 rays x 64 samples, K = 8
    x = inputs(RENDER_N, RENDER_K, seed=3)
    r_rows = fa.tile_plan(RENDER_N, RENDER_K, n_sm, bf16)[0]
    tiles["render"] = info(RENDER_N, RENDER_K, r_rows)
    cost = agg_cost(RENDER_N, RENDER_K, 3 + C, W, params, x["freqs"], nbytes)
    rf32_ms, rb_ms, r_unit = agg_bounds(cost, tc)
    with torch.no_grad():
        r_ms = device_ms(lambda: fa.launch(**x), iters=5)
        # f32 beside its 32-row tile (bf16 has none: its wgmma tiles follow)
        r32_ms = None if bf16 else device_ms(lambda: fa.launch(**x, rows=32), iters=5)
        for rows in (r for r in fa.tile_options(RENDER_K, bf16) if r >= fa.WGMMA_ROWS):
            t_ms = device_ms(lambda: fa.launch(**x, rows=rows), iters=5)
            print(f"{tag} render N={RENDER_N} K={RENDER_K} rows={rows}: kernel {t_ms:.4f} ms "
                  f"({100 * rb_ms / t_ms:.1f} % of its bound)"
                  f"{' (default)' if rows == r_rows else ''}; "
                  f"{tile_text(info(RENDER_N, RENDER_K, rows))}; {card}")
        rp_ms = device_ms(lambda: plain(**x), iters=3)
    r_smem, r_stages = tiles["render"]["smem_bytes"], tiles["render"]["ring_stages"]
    if r_ms < rb_ms:
        fail(f"{tag} at the render shape reads faster than its bound ({r_ms} < {rb_ms} ms)")
    print(f"{tag} render N={RENDER_N} K={RENDER_K}: kernel {r_ms:.4f} ms "
          f"({r_rows}-row tiles, {r_smem} B shared memory, {r_stages} ring stages"
          f"{'' if r32_ms is None else f'; 32-row tiles: {r32_ms:.4f} ms'}), "
          f"plain {rp_ms:.4f} ms, bound {rb_ms:.4f} ms by {r_unit} "
          f"({100 * rb_ms / r_ms:.1f} %), FP32 bound {rf32_ms:.4f} ms "
          f"({cost[0] / 1e9:.1f} GFLOP products, {cost[1] / 1e9:.2f} GFLOP other, "
          f"{cost[2] / 1e9:.3f} GB); {card}")
    del x
    print("times per query: ms/plain_ms/bound_ms sum the coarse (K=8) and fine "
          "(K=1) launches; render_* are one launch at the render shape")
    return {
        "name": "fused_agg_bf16" if bf16 else "fused_agg", "route": "cuda",
        "source": "nerfloc_tpu_torch/csrc/fused_agg.cu",
        "replaces": "nerfloc_tpu/ops/fused_agg.py:279",
        "launches": launches, "max_abs_err": max_err,
        "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
        "bound_by": max(units)[1].split(": ")[1].split(" ")[0],
        "bound_unit": "; ".join(u for _, u in units),
        "bound_f32_ms": tot["bound_f32_ms"],
        "library_ms": None,
        "render_ms": r_ms, "render_plain_ms": rp_ms, "render_bound_ms": rb_ms,
        "render_bound_f32_ms": rf32_ms,
        **({"tile_rows": {k: v["tile_rows"] for k, v in tiles.items()},
            "l2_weight_bytes_model": {k: v["l2_weight_bytes_model"] for k, v in tiles.items()}}
           if bf16 else {}),
    }


def main() -> int:
    if sys.argv[1:2] == ["--worker"]:
        return worker(sys.argv[2])
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from nerfloc_tpu_torch.configs import Config, RenderConfig
        from nerfloc_tpu_torch.data import device_batch, make_query_batch
        from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
        from nerfloc_tpu_torch.ops import fused_agg as fa
        from nerfloc_tpu_torch.ops import native
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products sum in f32, as XLA sums the JAX package's
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")

    # every source at once: one nvcc per kernel, the host helpers (PNG
    # unfilter, JPEG decode and TIFF LZW) with the host's C++ compiler
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:
        jobs = [pool.submit(native.build_all, ["fused_agg", "tsdf"])] + \
            [pool.submit(native.build_host, h)
             for h in ("png_unfilter", "jpeg_decode", "tsdf_host")]
        for job in jobs:
            job.result()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a, and the host helpers)")
    for name in ("fused_agg", "tsdf"):
        for line in native.build_report(name).splitlines():
            if ("ptxas" in line or "spill" in line) and "Compile time" not in line:
                print(f"build report ({name}): {line.strip()}")

    import tempfile
    if sys.argv[1:2] == ["--prep-only"]:
        # phase 18 alone: scene preparation and its kernel
        with tempfile.TemporaryDirectory(prefix="chip_smoke_files_") as files:
            prep = prepare_on_files(dev, card, files)
        print(json.dumps({"kernels": [prep]}))
        return 0
    if sys.argv[1:2] == ["--options-only"]:
        # phase 19 alone: the options that are off by default
        options_small_vs_cpu(dev)
        print(json.dumps(options_full_width(dev, card)))
        return 0
    if sys.argv[1:2] == ["--parallel-only"]:
        # phases 14 and 16 alone: a quicker check of the parallel path
        with tempfile.TemporaryDirectory(prefix="chip_smoke_files_") as files:
            par = parallel_on_files(dev, card, clis_on_files(dev, card, files))
        print(json.dumps(par))
        return 0

    max_err = check_fused_agg(dev)
    max_err_bf16 = check_fused_agg_bf16(dev)
    small_query_vs_cpu(dev)

    # main path at full width
    cfg = Config(render=RenderConfig(fused_query_agg=True))
    model = NerfPoseEstimator(cfg, device=dev, seed=0)
    batch = to_device_batch(device_batch(make_query_batch(n_views=5, H=240, W=320,
                                                          seed=0)), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):
        model.localize_forward(batch, generator=gen)
    torch.cuda.synchronize()
    fa.LAUNCHES.n = 0
    out = model.localize_forward(batch, generator=gen)
    torch.cuda.synchronize()
    launches = fa.LAUNCHES.n
    print(f"main path: fused_agg launches per query = {launches}")
    if launches != 2:
        fail(f"expected 2 fused_agg launches per query, got {launches}")
    check_pose(out["pose"], "localize_forward")
    n_kp = cfg.matching.fine_num_3d_keypoints
    if tuple(out["mkps2d"].shape) != (n_kp, 2) or not bool(torch.isfinite(out["mkps2d"]).all()):
        fail("localize_forward mkps2d malformed")
    print(f"main path: matches={int(out['match_mask'].sum())} "
          f"inliers={int(out['num_inliers'])} success={bool(out['pnp_success'])}")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        model.localize_forward(batch, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    loc_ms = statistics.median(times)
    print(f"localize_forward V=5 240x320: median {loc_ms:.2f} ms/query over 10 "
          f"(min {min(times):.2f}, max {max(times):.2f}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")

    pnp_fixture(dev)
    small_render_vs_cpu(dev)
    render = render_full_width(dev, card)
    small_train_vs_cpu(dev)
    train_err, train_agg = check_fused_agg_train_shape(dev, card)
    max_err = max(max_err, train_err)
    train = train_full_width(dev, card)
    small_eval_vs_cpu(dev)
    refine_err, refine_agg = check_fused_agg_refine_shape(dev, card)
    max_err = max(max_err, refine_err)
    evals = eval_full_width(dev, card)
    small_paths_bf16_vs_cpu(dev)
    bf16 = bf16_full_width(dev, card)
    small_steps_bf16_vs_cpu(dev)
    steps_err, steps_agg = check_fused_agg_bf16_steps(dev, card)
    max_err_bf16 = max(max_err_bf16, steps_err)
    train16 = train_full_width(dev, card, torch.bfloat16)
    evals16 = eval_full_width(dev, card, torch.bfloat16)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_files_") as files:
        cli = clis_on_files(dev, card, files)
        ft = finetune_on_files(dev, card, files)
        par = parallel_on_files(dev, card, cli)
        retrieval = retrieval_on_files(
            dev, card, [(cli["cli_root"], s) for s in CLI_SCENES] +
            [(ft["ft_root"], s) for s in (*FT_OBJECTS, FT_JPEG_SCENE)])
        prep = prepare_on_files(dev, card, files)
    options_err = options_small_vs_cpu(dev)
    options = options_full_width(dev, card)
    print(f"train step, full width: f32 {train['train_ms_per_step']:.2f} ms/step (peak "
          f"{train['train_peak_gib']:.2f} GiB), bf16 {train16['train_ms_per_step']:.2f} ms/step "
          f"(peak {train16['train_peak_gib']:.2f} GiB); eval query: f32 "
          f"{evals['eval_ms_per_query']:.2f} ms, bf16 {evals16['eval_ms_per_query']:.2f} ms; "
          f"{card}")

    kernels = [{**time_fused_agg(model, cfg, dev, launches, max_err, card),
                "render_launches_per_call": render["render_launches_per_call"],
                "render_kernel_ms_in_call": render["render_kernel_ms_in_call"],
                "train_launches_per_step": train["train_launches_per_step"], **train_agg,
                "eval_launches_per_query": evals["eval_launches_per_query"],
                "refine_launches_per_query": evals["refine_launches_per_query"],
                **refine_agg,
                "ray_sharded_frame_launches_per_rank": par["ray_sharded_launches_per_rank"]},
               {**time_fused_agg(model, cfg, dev, bf16["launches"], max_err_bf16, card,
                                 bf16=True),
                "render_launches_per_call": bf16["render_launches_per_call"],
                "render_kernel_ms_in_call": bf16["render_kernel_ms_in_call"],
                "train_launches_per_step": train16["train_launches_per_step"],
                "eval_launches_per_query": evals16["eval_launches_per_query"],
                "refine_launches_per_query": evals16["refine_launches_per_query"],
                **steps_agg,
                "cli_train_launches_per_step": cli["cli_train_launches_per_step"],
                "cli_eval_launches_per_query": cli["cli_eval_launches_per_query"],
                "finetune_train_launches_per_step": ft["ft_train_launches_per_step"],
                "finetune_eval_launches_per_query": ft["ft_eval_launches_per_query"],
                "ddp_train_launches_per_step_per_rank":
                    par["ddp_train_launches_per_step_per_rank"],
                "ddp_eval_launches_per_query": par["ddp_eval_launches_per_query"],
                "prep_train_launches_per_step": prep.pop("prep_train_launches_per_step"),
                "prep_eval_launches_per_query": prep.pop("prep_eval_launches_per_query"),
                **{k: options[k] for k in (
                    "options_render_launches_per_call", "options_render_ms",
                    "simple_3d_model_launches_per_query",
                    "simple_3d_model_train_launches_per_step", "sfm_launches_per_query",
                    "sfm_train_launches_per_step")},
                "options_small_cuda_vs_cpu_max_err": options_err},
               prep]
    for tag in ("train", "refine"):   # the bf16 tiles at the step shapes (phase 13b)
        tile = kernels[1].pop(f"{tag}_tile")
        for key in ("tile_rows", "l2_weight_bytes_model"):
            kernels[1][key][tag] = tile[key]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
