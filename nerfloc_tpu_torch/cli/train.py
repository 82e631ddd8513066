"""Training CLI (counterpart of nerfloc_tpu/cli/train.py).

Config merge and flag overrides, dataset and loader construction,
auto-resume from the run's latest checkpoint, an optional warm start from
the `--ckpt` flag only, as the JAX CLI warm-starts (a shape-matched partial
restore of the parameters: new heads keep their fresh weights, the Adam
moments start fresh; a directory with nothing under it leaves the fresh
init, and the YAML's `ckpt:` is not read), the epoch loop with a periodic
eval (the per-scene table and the render PSNR of a few test views), and
metric-keyed checkpoints. The model runs at compute_dtype_of(cfg); the
step's noise comes from a torch.Generator seeded by --seed, the epoch
eval's from a generator per test item seeded by --seed, the epoch and the
item's index (train/evaluate.query_generator), in one process and under
torchrun alike.

Data parallel under torchrun: each process is one rank with its own
device (cuda:LOCAL_RANK), `--batch` is the global batch (default: the
world size) and must divide by the world; each rank loads its rows of
every global batch and the gradient is all-reduced (train/step.py). Rank 0
resumes or warm-starts and broadcasts the state, writes log.jsonl and the
checkpoints, and renders the PSNR views; the epoch eval is the
multi-process eval_dataset. `--dist_backend` defaults to NCCL on CUDA
(gloo on the CPU); gloo on CUDA tensors is how several ranks share one
card. Without torchrun it is one process, as before.

Usage:
  python -m nerfloc_tpu_torch.cli.train --config configs/7scenes_all.yaml \
      [--datadir ...] [--basedir runs/] [--max_epochs N] [--device cuda]
  torchrun --nproc_per_node=N -m nerfloc_tpu_torch.cli.train --config ... \
      [--batch N] [--dist_backend nccl|gloo]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from ..configs import compute_dtype_of, load_config, override_cfg_with_args
from ..data import build_dataset
from ..data.prefetch import BatchLoader
from ..device import resolve_device
from ..models.pose_estimator import NerfPoseEstimator, to_device_batch
from ..parallel.mesh import MeshSpec, init_distributed, launched, make_mesh, world
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
    p.add_argument("--batch", type=int, default=None,
                   help="global queries per step (default: the world size, 1 without torchrun)")
    p.add_argument("--eval_interval", type=int, default=1)
    p.add_argument("--train_render_views", type=int, default=2,
                   help="test views rendered per epoch eval for psnr_test (0 disables)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda, under torchrun cuda:LOCAL_RANK; raises "
                        "without a GPU)")
    p.add_argument("--dist_backend", type=str, default=None,
                   help="torch.distributed backend under torchrun (default nccl on CUDA, gloo "
                        "on the CPU)")
    return p.parse_args(argv)


def _log(path: str, record: dict) -> None:
    line = json.dumps(record)
    print(line, flush=True)
    with open(path, "a") as f:
        f.write(line + "\n")


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    if launched():
        dev = init_distributed(args.dist_backend, args.device)
    else:
        dev = resolve_device(args.device)
    rank, n_ranks = world()
    cfg = override_cfg_with_args(load_config(args.config), args)

    run_dir = os.path.join(args.basedir, cfg.expname or "default", cfg.version)
    log_path = os.path.join(run_dir, "log.jsonl")
    if rank == 0:
        os.makedirs(run_dir, exist_ok=True)
    batch_size = args.batch or n_ranks
    if batch_size % n_ranks:
        raise ValueError(f"--batch {batch_size} does not divide by the world size {n_ranks}")
    mesh = make_mesh(MeshSpec(data=n_ranks)) if launched() else None
    group = mesh.data_group if mesh is not None else None

    train_ds = build_dataset(cfg, "train", mode="train")
    test_ds = build_dataset(cfg, "test", mode="test")
    scene_names = dict(enumerate(test_ds.scene_names()))

    model = NerfPoseEstimator(cfg, device=dev, seed=args.seed, dtype=compute_dtype_of(cfg))
    state = TrainState(model, cfg)
    mgr = None
    if rank == 0:
        mgr = CheckpointManager(os.path.join(run_dir, "ckpts"), metric_keys=DEFAULT_METRIC_MODES)
        latest = mgr.latest_step()
        if latest is not None:
            state.load_state_dict(mgr.restore(latest))
            print(f"resumed from step {latest}")
        elif args.ckpt:
            restored = CheckpointManager(args.ckpt).restore()
            if restored is None:
                print(f"nothing to warm-start from under {args.ckpt}: training from the fresh "
                      "init")
            else:
                taken = set(restorable(model.state_dict(), restored["model"]))
                model.load_state_dict(partial_restore(model.state_dict(), restored["model"]))
                print(f"warm-started from {args.ckpt}")
                _log(log_path, {"warm_start": args.ckpt, "restored": len(taken),
                                "fresh": sorted(k for k in model.state_dict()
                                                if k not in taken)})
    if group is not None:
        state.broadcast(group)

    train_step = make_train_step(model, cfg, group=group)
    eval_step = make_eval_step(model, cfg)
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    loader = BatchLoader(train_ds, batch_size, shuffle=True, seed=args.seed,
                         rank=rank, world=n_ranks)
    render_psnr_fn = None  # built at the first epoch eval
    # resume at the saved epoch: len(loader) applies the loader's own
    # drop_last rule, so a completed epoch is never trained again
    steps_per_epoch = max(1, len(loader))
    start_epoch = min(state.step // steps_per_epoch, cfg.max_epochs)
    for epoch in range(start_epoch, cfg.max_epochs):
        t0 = time.time()
        for it, host_batch in enumerate(loader.epoch(epoch)):
            metrics = train_step(state, to_device_batch(host_batch, dev), generator=generator)
            if it % LOG_EVERY == 0 and rank == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(epoch=epoch, it=it, step=state.step,
                         sec_per_it=(time.time() - t0) / (it + 1))
                _log(log_path, m)

        saved = {}
        if (epoch + 1) % args.eval_interval == 0:
            # each test item's noise is its own (seed, epoch, index): the
            # table does not depend on the split over ranks, and the train
            # generator is the steps' alone
            results = eval_dataset(test_ds, eval_step, batch_size // n_ranks, scene_names, cfg,
                                   device=dev, query_seed=(args.seed, epoch))
            if args.train_render_views > 0:
                psnr = [None]
                if rank == 0:
                    if render_psnr_fn is None:
                        render_psnr_fn = make_render_psnr_fn(model)
                    psnr[0] = render_psnr_eval(render_psnr_fn, test_ds,
                                               max_views=args.train_render_views)
                if n_ranks > 1:
                    dist.broadcast_object_list(psnr, 0)
                results["avg"].update(psnr[0])
            if rank == 0:
                _log(log_path, {"epoch": epoch, "eval": results})
            saved = {k: results["avg"][k] for k in ("pose_acc", "median_trans_err_m",
                                                     "psnr_test") if k in results["avg"]}
        if rank == 0:
            mgr.save(state.step, state, metrics=saved or None)
        if n_ranks > 1:
            dist.barrier()
    return 0


if __name__ == "__main__":
    sys.exit(main())
