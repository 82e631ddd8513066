"""Evaluation over a dataset (counterpart of nerfloc_tpu/train/evaluate.py:
`eval_dataset`, `make_render_psnr_fn`, `render_psnr_eval`).

`eval_dataset` runs an eval step (train/step.py make_eval_step) over any
sequence of items (`__len__` / `__getitem__`, each item a query dict with
its 'scene', 'scale_factor', 'filename' and 'pose'), batch by batch. The
final batch is padded by repeating its last item and the padded outputs
are dropped. Items are loaded and stacked by a thread pool one or two
batches ahead of the step (numpy work that releases the GIL). The
per-query errors go to the per-scene table of utils.metrics.

In a process group wider than one, each process evaluates the strided
shard rank::world of the items and the per-query arrays are all-gathered
(parallel/multihost.py), so every process returns the same table. With
`query_seed`, each query's noise comes from a generator seeded by the
seed and the query's index in test_ds, so the table does not depend on
how the items are split over processes.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..data import device_batch, stack_batches
from ..device import DeviceLike, resolve_device
from ..models.fields.losses import img2mse, mse2psnr
from ..models.pose_estimator import to_device_batch
from ..parallel.mesh import world
from ..parallel.multihost import allgather_metrics, process_shard_indices
from ..utils.metrics import aggregate_per_scene

_FNAME_BYTES = 256


def _prefetch_eval_batches(test_ds, batch_size: int, num_workers: int = 8,
                           depth: int = 2, indices: Optional[Sequence[int]] = None):
    """Yield (items, real_count, host_batch, item_indices) with the final
    batch padded by repeating its last item. `indices` restricts the
    iteration to those items (a process's shard)."""
    pool_idx = list(range(len(test_ds))) if indices is None else [int(i) for i in indices]
    n = len(pool_idx)
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
                    idxs = pool_idx[start:start + batch_size]
                    real = len(idxs)
                    idxs = idxs + [idxs[-1]] * (batch_size - real)
                    items = list(pool.map(lambda i: test_ds[i], idxs))
                    if not put((items, real, stack_batches([device_batch(i) for i in items]),
                                idxs)):
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


def _encode_names(names: Sequence[str]) -> np.ndarray:
    """Strings -> fixed-width [N, 256] uint8 rows, so file names cross the
    same tensor all-gather as the metric arrays."""
    arr = np.zeros((len(names), _FNAME_BYTES), np.uint8)
    for i, s in enumerate(names):
        b = s.encode("utf-8")[:_FNAME_BYTES]
        arr[i, :len(b)] = np.frombuffer(b, np.uint8)
    return arr


def _decode_names(arr) -> List[str]:
    return [bytes(row[row != 0]).decode("utf-8") for row in np.asarray(arr)]


def query_generator(seed: Union[int, Sequence[int]], index: int,
                    device: torch.device) -> torch.Generator:
    """The generator of test item `index`'s noise under `seed` (an int or
    a tuple of ints, e.g. (seed, epoch)): a 64-bit hash of both, so no
    seed or index overflows it."""
    key = [int(s) % 2 ** 64 for s in np.atleast_1d(np.asarray(seed, dtype=object))]
    state = np.random.SeedSequence([*key, int(index)]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def eval_dataset(test_ds, eval_step: Callable, batch_size: int,
                 scene_names: Dict[int, str], cfg, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 collect_poses: bool = False,
                 query_seed: Union[int, Sequence[int], None] = None) -> Dict:
    """The per-scene table (utils.metrics.aggregate_per_scene: median
    errors, pose_acc, n, the mean matching_iou) of eval_step over test_ds,
    with 'files' under 'avg', and with collect_poses the predicted and
    ground-truth poses by filename under '_poses' (in test-set order).
    Batches go to `device` (CUDA unless the caller asks for another); the
    eval step's noise comes from `generator`, or with `query_seed` from
    query_generator(query_seed, index) per query. In a process group of
    `world` processes each evaluates its strided shard and the results are
    all-gathered: identical on every process. Fewer items than processes
    raise ValueError (before any collective)."""
    dev = resolve_device(device)
    rank, nprocs = world()
    multiproc = nprocs > 1
    if multiproc and len(test_ds) < nprocs:
        raise ValueError(f"multi-process eval needs len(test_ds) >= world size "
                         f"({len(test_ds)} < {nprocs})")
    indices = process_shard_indices(len(test_ds), rank, nprocs) if multiproc else None
    name_to_id = {v: k for k, v in scene_names.items()}
    rot, trans, ious, poses_pred = [], [], [], []
    sids, scales, files, poses_gt = [], [], [], []
    for items, real, host, idxs in _prefetch_eval_batches(test_ds, batch_size, indices=indices):
        gen = generator if query_seed is None else \
            [query_generator(query_seed, i, dev) for i in idxs]
        out = eval_step(to_device_batch(host, dev), generator=gen)
        rot.append(out["rot_err_deg"][:real].cpu().numpy())
        trans.append(out["trans_err_m"][:real].cpu().numpy())
        ious.append(out["matching_iou"][:real].cpu().numpy())
        sids.extend(name_to_id.get(it["scene"], 0) for it in items[:real])
        scales.extend(float(it["scale_factor"]) for it in items[:real])
        files.extend(it["filename"] for it in items[:real])
        if collect_poses:
            poses_pred.append(out["pose_pred"][:real].cpu().numpy())
            poses_gt.extend(np.asarray(it["pose"]) for it in items[:real])
    local = {"rot": np.concatenate(rot), "trans": np.concatenate(trans),
             "sid": np.asarray(sids, np.int64), "scale": np.asarray(scales, np.float64),
             "iou": np.concatenate(ious)}
    if collect_poses:
        local.update(pose_pred=np.concatenate(poses_pred, axis=0), pose_gt=np.stack(poses_gt))
    if multiproc:
        if collect_poses:
            local["fname"] = _encode_names(files)
        local = allgather_metrics(local, indices, len(test_ds))
        if collect_poses:
            files = _decode_names(local["fname"])
    results = aggregate_per_scene(
        local["sid"], local["rot"], local["trans"], scene_names, local["scale"],
        rot_thresh=cfg.rotation_eval_thresh, trans_thresh=cfg.translation_eval_thresh,
        dataset_type=cfg.dataset_type, extras={"matching_iou": local["iou"]})
    results["avg"]["files"] = len(test_ds) if multiproc else len(files)
    if collect_poses:
        results["_poses"] = {"filenames": files, "poses_pred": local["pose_pred"],
                             "poses_gt": local["pose_gt"]}
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
