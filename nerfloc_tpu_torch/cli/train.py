"""Training CLI (counterpart of nerfloc_tpu/cli/train.py).

Config merge and flag overrides, dataset and loader construction,
auto-resume from the run's latest checkpoint, an optional warm start from
the `--ckpt` flag only, as the JAX CLI warm-starts (a shape-matched partial
restore of the parameters: new heads keep their fresh weights, the Adam
moments start fresh; a directory with nothing under it leaves the fresh
init, and the YAML's `ckpt:` is not read), the epoch loop with a periodic
eval (the per-scene table and the render PSNR of a few test views), and
metric-keyed checkpoints. The model runs at compute_dtype_of(cfg), B
queries per step on one device; the step's noise comes from a
torch.Generator seeded by --seed.

Usage:
  python -m nerfloc_tpu_torch.cli.train --config configs/7scenes_all.yaml \
      [--datadir ...] [--basedir runs/] [--max_epochs N] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

import torch

from ..configs import compute_dtype_of, load_config, override_cfg_with_args
from ..data import build_dataset
from ..data.prefetch import BatchLoader
from ..device import resolve_device
from ..models.pose_estimator import NerfPoseEstimator, to_device_batch
from ..train.checkpoint import (DEFAULT_METRIC_MODES, CheckpointManager, partial_restore,
                                restorable)
from ..train.evaluate import eval_dataset, make_render_psnr_fn, render_psnr_eval
from ..train.state import TrainState
from ..train.step import make_eval_step, make_train_step

LOG_EVERY = 50


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--datadir", type=str, default=None)
    p.add_argument("--basedir", type=str, default="runs")
    p.add_argument("--expname", type=str, default=None)
    p.add_argument("--version", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None,
                   help="warm-start checkpoint dir (partial restore)")
    p.add_argument("--max_epochs", type=int, default=None)
    p.add_argument("--lrate", type=float, default=None)
    p.add_argument("--batch", type=int, default=None, help="queries per step (default 1)")
    p.add_argument("--eval_interval", type=int, default=1)
    p.add_argument("--train_render_views", type=int, default=2,
                   help="test views rendered per epoch eval for psnr_test (0 disables)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; raises without a GPU)")
    return p.parse_args(argv)


def _log(path: str, record: dict) -> None:
    line = json.dumps(record)
    print(line, flush=True)
    with open(path, "a") as f:
        f.write(line + "\n")


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = override_cfg_with_args(load_config(args.config), args)

    run_dir = os.path.join(args.basedir, cfg.expname or "default", cfg.version)
    os.makedirs(run_dir, exist_ok=True)
    log_path = os.path.join(run_dir, "log.jsonl")
    batch_size = args.batch or 1

    train_ds = build_dataset(cfg, "train", mode="train")
    test_ds = build_dataset(cfg, "test", mode="test")
    scene_names = dict(enumerate(test_ds.scene_names()))

    model = NerfPoseEstimator(cfg, device=dev, seed=args.seed, dtype=compute_dtype_of(cfg))
    state = TrainState(model, cfg)
    mgr = CheckpointManager(os.path.join(run_dir, "ckpts"), metric_keys=DEFAULT_METRIC_MODES)
    latest = mgr.latest_step()
    if latest is not None:
        state.load_state_dict(mgr.restore(latest))
        print(f"resumed from step {latest}")
    elif args.ckpt:
        restored = CheckpointManager(args.ckpt).restore()
        if restored is None:
            print(f"nothing to warm-start from under {args.ckpt}: training from the fresh init")
        else:
            taken = set(restorable(model.state_dict(), restored["model"]))
            model.load_state_dict(partial_restore(model.state_dict(), restored["model"]))
            print(f"warm-started from {args.ckpt}")
            _log(log_path, {"warm_start": args.ckpt, "restored": len(taken),
                            "fresh": sorted(k for k in model.state_dict() if k not in taken)})

    train_step = make_train_step(model, cfg)
    eval_step = make_eval_step(model, cfg)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    loader = BatchLoader(train_ds, batch_size, shuffle=True, seed=args.seed)
    render_psnr_fn = None  # built at the first epoch eval
    # resume at the saved epoch: len(loader) applies the loader's own
    # drop_last rule, so a completed epoch is never trained again
    steps_per_epoch = max(1, len(loader))
    start_epoch = min(state.step // steps_per_epoch, cfg.max_epochs)
    for epoch in range(start_epoch, cfg.max_epochs):
        t0 = time.time()
        for it, host_batch in enumerate(loader.epoch(epoch)):
            metrics = train_step(state, to_device_batch(host_batch, dev), generator=generator)
            if it % LOG_EVERY == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(epoch=epoch, it=it, step=state.step,
                         sec_per_it=(time.time() - t0) / (it + 1))
                _log(log_path, m)

        if (epoch + 1) % args.eval_interval == 0:
            results = eval_dataset(test_ds, eval_step, batch_size, scene_names, cfg,
                                   device=dev, generator=generator)
            if args.train_render_views > 0:
                if render_psnr_fn is None:
                    render_psnr_fn = make_render_psnr_fn(model)
                results["avg"].update(render_psnr_eval(render_psnr_fn, test_ds,
                                                       max_views=args.train_render_views))
            _log(log_path, {"epoch": epoch, "eval": results})
            mgr.save(state.step, state, metrics={
                k: results["avg"][k] for k in ("pose_acc", "median_trans_err_m", "psnr_test")
                if k in results["avg"]})
        else:
            mgr.save(state.step, state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
