"""Evaluation / localization CLI (counterpart of nerfloc_tpu/cli/test.py).

Loads a checkpoint (the best stream of --best_metric when the train run
kept one, else the latest), runs the localization pipeline over the test
split (matching, PnP, the cascade and photometric refinement when the
config or flags ask for them) and reports per-scene median
rotation/translation errors and pose accuracy; optionally dumps the
trajectory, the OnePose 3D box overlays (`vis_3d_box`: box_<i>.png every
test_render_interval items of an object scene, the box drawn at the
predicted pose) and renders test views for PSNR (PNGs through
data/png.py). Each test item's noise comes from a generator seeded by
--seed and its index (train/evaluate.query_generator), so the table does
not depend on how many processes share the items.

Under torchrun every rank evaluates its strided shard of the test set and
the results are all-gathered (train/evaluate.eval_dataset); rank 0 writes
the JSON, the overlays and the renders. `--ray_shards N` splits each
rendered frame's rays over a ray group of the first N ranks
(parallel/render.py); it needs N ranks.

Usage:
  python -m nerfloc_tpu_torch.cli.test --config configs/7scenes_all.yaml \
      --ckpt runs/exp/default/ckpts [--optimize_pose] [--vis_rendering] \
      [--out results.json] [--device cuda]
  torchrun --nproc_per_node=N -m nerfloc_tpu_torch.cli.test --config ... \
      [--ray_shards N] [--dist_backend nccl|gloo]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs import compute_dtype_of, load_config, override_cfg_with_args
from ..data import build_dataset, device_batch, png
from ..device import resolve_device
from ..models.fields.losses import img2mse, mse2psnr
from ..models.pose_estimator import NerfPoseEstimator, to_device_batch
from ..parallel.mesh import MeshSpec, init_distributed, launched, make_mesh, world
from ..parallel.render import (make_context_builder, make_ray_sharded_render,
                               render_image_ray_sharded)
from ..train.checkpoint import (DEFAULT_METRIC_MODES, CheckpointManager, discover_best_dirs,
                                partial_restore)
from ..train.evaluate import eval_dataset
from ..train.step import make_eval_step
from ..utils.common import colorize_depth
from ..utils.visualization import draw_box3d, dump_trajectory


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--ckpt", type=str, required=False, default=None)
    p.add_argument("--datadir", type=str, default=None)
    p.add_argument("--out", type=str, default=None, help="results json path")
    p.add_argument("--load_latest", action="store_true",
                   help="load the most recent checkpoint even when a metric-keyed best "
                        "stream exists")
    p.add_argument("--best_metric", type=str, default="pose_acc",
                   help="which best stream to prefer (pose_acc / median_trans_err_m / "
                        "psnr_test)")
    p.add_argument("--optimize_pose", action="store_true", default=None)
    p.add_argument("--vis_rendering", action="store_true", default=None)
    p.add_argument("--test_render_interval", type=int, default=None)
    p.add_argument("--ray_shards", type=int, default=1,
                   help="ranks each rendered image's rays are split over (a ray group of "
                        "the first N ranks under torchrun)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda, under torchrun cuda:LOCAL_RANK; raises "
                        "without a GPU)")
    p.add_argument("--dist_backend", type=str, default=None,
                   help="torch.distributed backend under torchrun (default nccl on CUDA, gloo "
                        "on the CPU)")
    return p.parse_args(argv)


def load_checkpoint(model: NerfPoseEstimator, ckpt: str, load_latest: bool,
                    best_metric: str) -> str:
    """Load the best stream of `best_metric` (else the first stream on
    disk) or, with `load_latest` or without streams, the latest checkpoint
    under `ckpt` into `model`, shape-matched. Returns what was loaded."""
    best_dirs = discover_best_dirs(ckpt)
    pick = None
    if best_dirs and not load_latest:
        pick = best_metric if best_metric in best_dirs else sorted(best_dirs)[0]
    if pick is not None:
        mgr = CheckpointManager(ckpt, metric_keys={pick: DEFAULT_METRIC_MODES.get(pick, "max")})
        restored, label = mgr.restore(best=pick), f"best[{pick}]"
    else:
        restored, label = CheckpointManager(ckpt).restore(), "latest"
    if restored is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt}")
    model.load_state_dict(partial_restore(model.state_dict(), restored["model"]))
    return f"{label} checkpoint from {ckpt} (step {restored['step']})"


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if launched():
        dev = init_distributed(args.dist_backend, args.device)
    else:
        dev = resolve_device(args.device)
    rank, n_ranks = world()
    # every rank creates the ray groups; a world narrower than the ray
    # width raises here, before any work
    ray_mesh = make_mesh(MeshSpec(data=1, ray=args.ray_shards)) if args.ray_shards > 1 else None
    cfg = override_cfg_with_args(load_config(args.config), args)

    test_ds = build_dataset(cfg, "test", mode="test")
    scene_names = dict(enumerate(test_ds.scene_names()))
    model = NerfPoseEstimator(cfg, device=dev, seed=args.seed, dtype=compute_dtype_of(cfg))
    if args.ckpt:
        print("loaded " + load_checkpoint(model, args.ckpt, args.load_latest, args.best_metric))

    eval_step = make_eval_step(model, cfg)
    results = eval_dataset(test_ds, eval_step, 1, scene_names, cfg, device=dev,
                           collect_poses=cfg.vis_trajectory or cfg.vis_3d_box,
                           query_seed=args.seed)

    poses = results.pop("_poses", None)
    out_dir = os.path.dirname(args.out) if args.out else "eval_out"
    if cfg.vis_trajectory and rank == 0:
        pts = test_ds.datasets[0].store.points if test_ds.datasets else None
        dump_trajectory(os.path.join(out_dir, "trajectory.pkl"), poses["filenames"],
                        poses["poses_pred"], poses["poses_gt"], pts)
    if cfg.vis_3d_box and rank == 0:
        write_box_overlays(test_ds, poses["poses_pred"], cfg.test_render_interval, out_dir)
    if cfg.vis_rendering and (rank == 0 or (ray_mesh is not None and ray_mesh.member)):
        render = render_eval(model, cfg, test_ds, out_dir if args.out else "renders",
                             mesh=ray_mesh, write=rank == 0)
        results["render"] = render
        for scene, p in render["psnr_per_scene"].items():
            if scene in results:
                results[scene]["psnr"] = p
        if render["psnr_mean"] is not None:
            results["avg"]["psnr"] = render["psnr_mean"]
    if rank == 0:
        print(json.dumps(results, indent=2))
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"per_scene": results}, f)
    if n_ranks > 1:
        dist.barrier()
    return 0


def write_box_overlays(test_ds, poses_pred: np.ndarray, interval: int, out_dir: str) -> List[str]:
    """box_<i>.png for every `interval`-th test item of an object scene:
    its image with the object's 3D box drawn at the predicted pose."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for i in range(0, len(test_ds), max(interval, 1)):
        item = test_ds[i]
        if "bbox3d_corners" not in item:
            continue
        img = (np.asarray(item["image"]) * 255).astype(np.uint8)
        over = draw_box3d(img, np.asarray(item["bbox3d_corners"])[:8], np.asarray(item["K"]),
                          poses_pred[i])
        path = os.path.join(out_dir, f"box_{i:05d}.png")
        png.write(path, over)
        written.append(path)
    return written


@torch.no_grad()
def render_eval(model: NerfPoseEstimator, cfg, test_ds, out_dir: str = "renders",
                mesh=None, write: bool = True) -> Dict:
    """Render every `test_render_interval`-th test view whole (scene
    context, then render_image in chunks, or with a ray mesh
    render_image_ray_sharded, which every rank of its ray group calls),
    report its PSNR over the pixels the render's mask keeps, and with
    `write` write render_<i>.png and depth_<i>.png."""
    if write:
        os.makedirs(out_dir, exist_ok=True)
    if mesh is not None:
        build_ctx = make_context_builder(model)
        rrender = make_ray_sharded_render(model, cfg, mesh)
    psnrs, psnr_scenes = [], []
    for i in range(0, len(test_ds), max(cfg.test_render_interval, 1)):
        item = test_ds[i]
        b = to_device_batch(device_batch(item), model.device)
        H, W = b["image"].shape[:2]
        if mesh is None:
            ctx, _ = model.build_context(b)
            out = model.model_3d.render_image(ctx, b["K"], b["pose"], H, W)
        else:
            out = render_image_ray_sharded(model, cfg, build_ctx(b), b["K"], b["pose"], H, W,
                                           mesh, render=rrender)
        psnr = float(mse2psnr(img2mse(out["rgb"], b["image"], mask=out["mask"])))
        psnrs.append(psnr)
        psnr_scenes.append(item.get("scene", ""))
        if not write:
            continue
        rgb = np.clip(out["rgb"].float().cpu().numpy() * 255, 0, 255).astype(np.uint8)
        png.write(os.path.join(out_dir, f"render_{i:05d}.png"), rgb)
        depth_vis = colorize_depth(out["depth"].float().cpu().numpy(),
                                   out["mask"].cpu().numpy())
        png.write(os.path.join(out_dir, f"depth_{i:05d}.png"),
                  (depth_vis * 255).astype(np.uint8))
        print(f"render {i}: psnr={psnr:.2f}")
    per_scene = {s: float(np.mean([p for p, sc in zip(psnrs, psnr_scenes) if sc == s]))
                 for s in set(psnr_scenes)}
    return {"psnr_mean": float(np.mean(psnrs)) if psnrs else None,
            "psnr_per_scene": per_scene, "n_rendered": len(psnrs)}


if __name__ == "__main__":
    sys.exit(main())
