"""Evaluation over a dataset (counterpart of nerfloc_tpu/train/evaluate.py:
`eval_dataset`, `make_render_psnr_fn`, `render_psnr_eval`).

`eval_dataset` runs an eval step (train/step.py make_eval_step) over any
sequence of items (`__len__` / `__getitem__`, each item a query dict with
its 'scene', 'scale_factor', 'filename' and 'pose'), batch by batch. The
final batch is padded by repeating its last item and the padded outputs
are dropped. Items are loaded and stacked by a thread pool one or two
batches ahead of the step (numpy work that releases the GIL). The
per-query errors go to the per-scene table of utils.metrics.

One process only: the multi-process gather of the JAX package comes with
the port's parallelism (torch.distributed).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data import device_batch, stack_batches
from ..device import DeviceLike, resolve_device
from ..models.fields.losses import img2mse, mse2psnr
from ..models.pose_estimator import to_device_batch
from ..utils.metrics import aggregate_per_scene


def _prefetch_eval_batches(test_ds, batch_size: int, num_workers: int = 8,
                           depth: int = 2):
    """Yield (items, real_count, host_batch) with the final batch padded by
    repeating its last item."""
    n = len(test_ds)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        # re-check `stop` while the queue is full: a consumer that left
        # early never drains it
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            with ThreadPoolExecutor(num_workers) as pool:
                for start in range(0, n, batch_size):
                    if stop.is_set():
                        return
                    idxs = list(range(start, min(start + batch_size, n)))
                    real = len(idxs)
                    idxs += [idxs[-1]] * (batch_size - real)
                    items = list(pool.map(lambda i: test_ds[i], idxs))
                    if not put((items, real, stack_batches([device_batch(i) for i in items]))):
                        return
            put(None)
        except BaseException as e:  # the consumer raises it
            put(e)

    threading.Thread(target=produce, daemon=True).start()
    try:
        while True:
            got = q.get()
            if got is None:
                return
            if isinstance(got, BaseException):
                raise got
            yield got
    finally:
        stop.set()


def eval_dataset(test_ds, eval_step: Callable, batch_size: int,
                 scene_names: Dict[int, str], cfg, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 collect_poses: bool = False) -> Dict:
    """The per-scene table (utils.metrics.aggregate_per_scene: median
    errors, pose_acc, n, the mean matching_iou) of eval_step over test_ds,
    with 'files' under 'avg', and with collect_poses the predicted and
    ground-truth poses by filename under '_poses'. Batches go to `device`
    (CUDA unless the caller asks for another); the eval step's noise comes
    from `generator`."""
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise NotImplementedError("eval_dataset: multi-process evaluation is not ported")
    dev = resolve_device(device)
    name_to_id = {v: k for k, v in scene_names.items()}
    rot, trans, ious, poses_pred = [], [], [], []
    sids, scales, files, poses_gt = [], [], [], []
    for items, real, host in _prefetch_eval_batches(test_ds, batch_size):
        out = eval_step(to_device_batch(host, dev), generator=generator)
        rot.append(out["rot_err_deg"][:real].cpu().numpy())
        trans.append(out["trans_err_m"][:real].cpu().numpy())
        ious.append(out["matching_iou"][:real].cpu().numpy())
        sids.extend(name_to_id.get(it["scene"], 0) for it in items[:real])
        scales.extend(float(it["scale_factor"]) for it in items[:real])
        files.extend(it["filename"] for it in items[:real])
        if collect_poses:
            poses_pred.append(out["pose_pred"][:real].cpu().numpy())
            poses_gt.extend(np.asarray(it["pose"]) for it in items[:real])
    results = aggregate_per_scene(
        np.asarray(sids), np.concatenate(rot), np.concatenate(trans), scene_names,
        np.asarray(scales), rot_thresh=cfg.rotation_eval_thresh,
        trans_thresh=cfg.translation_eval_thresh, dataset_type=cfg.dataset_type,
        extras={"matching_iou": np.concatenate(ious)})
    results["avg"]["files"] = len(files)
    if collect_poses:
        results["_poses"] = {"filenames": files,
                             "poses_pred": np.concatenate(poses_pred, axis=0),
                             "poses_gt": np.stack(poses_gt)}
    return results


def make_render_psnr_fn(model) -> Callable[[Dict], float]:
    """psnr_of(item) -> the PSNR of the query view rendered whole
    (build_context, then render_image in chunks) against its image, over
    the pixels the render's mask keeps."""

    @torch.no_grad()
    def psnr_of(item: Dict) -> float:
        b = to_device_batch(device_batch(item), model.device)
        ctx, _ = model.build_context(b)
        H, W = b["image"].shape[:2]
        out = model.model_3d.render_image(ctx, b["K"], b["pose"], H, W)
        return float(mse2psnr(img2mse(out["rgb"], b["image"], mask=out["mask"])))

    return psnr_of


def render_psnr_eval(psnr_of: Callable[[Dict], float], test_ds, max_views: int = 2,
                     interval: int = 0) -> Dict:
    """Mean render PSNR over up to max_views test views, every `interval`-th
    (default: spread evenly). Without a view there is no psnr_test key (a
    NaN would reach the logs and the checkpoint metrics)."""
    n = len(test_ds)
    if n == 0 or max_views <= 0:
        return {"n_rendered": 0}
    stride = max(interval, 1) if interval else max(n // max_views, 1)
    psnrs = [psnr_of(test_ds[i]) for i in list(range(0, n, stride))[:max_views]]
    return {"psnr_test": float(np.mean(psnrs)), "n_rendered": len(psnrs)}
