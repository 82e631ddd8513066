"""Query dataset: one localization query + its support set, static shapes
(counterpart of nerfloc_tpu/data/video_dataset.py: `DataOptions`,
`VideoDataset`, `MultiSceneDataset`, `add_depth_noise`).

  * every item has identical array shapes across scenes: images go through
    ResizeAndCrop + PadToSize, support sets are padded/truncated to exactly
    `n_views`, the scene point cloud to `max_points` with a mask. Padded
    support views carry depth==0 everywhere, so they contribute no neural
    points and no supervision.
  * each item draws from its own Generator, seeded as the JAX package seeds
    it: hash((epoch, split, idx)) & 0x7FFFFFFF. `split` is a str, whose
    hash Python randomizes per process unless PYTHONHASHSEED is set, so
    two processes draw differently (the JAX package does the same; one
    process draws as the JAX package does in it). The draws come in the
    same order: augmentation parameters, the support choice, the point
    subsample, the depth noise.
  * support-view modes: retrieval / coreset / coreset+retrieval / mvs,
    with FPS or covisibility coreset samplers.
  * object scenes (a store with `bboxes_3d`, OnePose's layout): each
    query frame is read once more to learn its size, its target mask is
    the filled convex hull of the object's points projected with the
    frame's pose (`compute_target_mask`), and the mask goes through the
    query's transforms; the item carries `bbox3d_corners` and
    `target_mask`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import imgproc
from .reader import intrinsic_to_K, load_frame
from .samplers import CovisibilitySampler, fps_poses
from .scene_store import SceneStore, _tcw44
from .transforms import Compose


def compute_target_mask(points: np.ndarray, K: np.ndarray, w2c: np.ndarray,
                        hw: tuple) -> np.ndarray:
    """The convex hull of the object points projected into the frame,
    filled (scipy's ConvexHull, then imgproc.fill_poly as cv2.fillPoly)."""
    from scipy.spatial import ConvexHull

    pts_cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    z = np.maximum(pts_cam[:, 2], 1e-8)
    uv = (pts_cam[:, :2] @ K[:2, :2].T) / z[:, None] + K[:2, 2]
    hull = ConvexHull(uv)
    poly = uv[hull.vertices].astype(np.int32)
    mask = np.zeros(hw, dtype=np.uint8)
    imgproc.fill_poly(mask, poly, 255)
    return mask > 0


def add_depth_noise(depth: np.ndarray, mask: np.ndarray, depth_length: float,
                    rng: np.random.Generator,
                    region=(0.1, 0.3), offset=(0.05, 0.2),
                    local_noise: float = 0.01) -> np.ndarray:
    """Synthetic depth corruption: a random rectangular region around a valid
    pixel gets a global +- offset plus local noise."""
    coords = np.stack(np.nonzero(mask), -1)
    if len(coords) == 0:
        return depth
    out = depth.copy()
    extent = coords.max(0) - coords.min(0) + 1
    cy, cx = coords[rng.integers(len(coords))]
    ly, lx = rng.uniform(*region, 2) * extent
    sel = (np.abs(coords[:, 0] - cy) < ly) & (np.abs(coords[:, 1] - cx) < lx)
    sign = -1.0 if rng.random() < 0.5 else 1.0
    g = sign * rng.uniform(*offset) * depth_length
    noise = rng.uniform(-local_noise, local_noise, sel.sum()) * depth_length
    ys, xs = coords[sel, 0], coords[sel, 1]
    out[ys, xs] += (g + noise).astype(out.dtype)
    return out


@dataclass
class DataOptions:
    """Per-dataset knobs (the data-YAML surface, configs/data/*.yaml)."""
    n_views: int = 10
    support_image_selection: str = "retrieval"
    image_core_set_size: int = 16
    coreset_sampler: str = "FPS"
    max_points: int = 8192           # static points3d capacity
    aug_ref_depth: bool = False
    aug_depth_offset_prob: float = 0.3
    aug_global_noise_prob: float = 0.3


class VideoDataset:
    """One scene; yields static-shape query dicts."""

    def __init__(self, store: SceneStore, split: str,
                 transforms: Compose, aug_transforms: Optional[Compose] = None,
                 opts: Optional[DataOptions] = None, mode: str = "test",
                 test_time_color_jitter: bool = False,
                 test_time_style_change: bool = False):
        self.store = store
        self.split = split
        self.mode = mode
        self.transform = transforms
        self.aug_transform = aug_transforms or Compose([])
        self.opts = opts or DataOptions()
        self.epoch = 0
        self.test_time_style_change = test_time_style_change

        # test-time color-jitter robustness harness: a fixed table of jitter
        # parameter combinations, selected per frame by a filename hash so
        # runs are reproducible
        self.test_time_color_jitter = test_time_color_jitter
        if test_time_color_jitter:
            from .transforms import ColorJitter

            self._tt_jitter = ColorJitter()
            self._tt_params = [
                {"order": [0, 1, 2, 3], "brightness": b, "contrast": c,
                 "saturation": s, "hue": h}
                for b in (0.25, 0.75, 1.25, 1.75)
                for c in (0.25, 0.75, 1.25, 1.75)
                for s in (0.25, 0.75, 1.25, 1.75)
                for h in (0.05, -0.05)
            ]

        self._train_index = store.train_index()
        self._coreset_names: Optional[List[str]] = None
        if "coreset" in self.opts.support_image_selection:
            self._coreset_names = self._build_coreset()

    # -- coreset ---------------------------------------------------------

    def _build_coreset(self) -> List[str]:
        frames = self.store.train_frames
        names = [f["file_name"] for f in frames]
        k = self.opts.image_core_set_size
        rng = np.random.default_rng(666)
        if self.opts.coreset_sampler == "covisibility" and \
                self.store.points is not None:
            w2cs = np.stack([_tcw44(f["extrinsic_Tcw"]) for f in frames])
            Ks = np.stack([intrinsic_to_K(f["camera_intrinsic"])
                           for f in frames])
            sampler = CovisibilitySampler(self.store.points, w2cs, Ks, rng=rng)
            idx = sampler.sample(k)
        else:
            idx = fps_poses(self.store.train_c2ws(), k, rng=rng)
        return [names[i] for i in idx]

    # -- support selection -------------------------------------------------

    def _support_names(self, meta: Dict, rng: np.random.Generator) -> List[str]:
        mode = self.opts.support_image_selection
        top_k = [n for n in meta.get("top_k", []) if n in self._train_index]
        n = self.opts.n_views
        if mode == "coreset":
            names = list(self._coreset_names)
        elif mode == "coreset+retrieval":
            names = top_k[: max(n - len(self._coreset_names), 0)] + \
                list(self._coreset_names)
        elif mode == "mvs":
            names = self._mvs_support(top_k)
        else:  # retrieval
            names = top_k
        if self.mode == "train" and len(names) > n:
            # a random n of the retrieved pool
            sel = rng.choice(len(names), n, replace=False)
            names = [names[i] for i in sorted(sel)]
        names = names[:n]
        if not names:  # degenerate: fall back to nearest training frames
            names = [f["file_name"] for f in self.store.train_frames[:n]]
        while len(names) < n:  # pad by cycling (masked out via depth==0 later
            names.append(names[len(names) % max(len(names), 1)])
        return names

    def _mvs_support(self, top_k: List[str]) -> List[str]:
        """Nearest retrieval + fixed-step temporal neighbors from the same
        sequence."""
        if not top_k:
            return []
        nearest = top_k[0]
        frames = self.store.train_frames
        seq_id = None
        for f in frames:
            if f["file_name"] == nearest:
                seq_id = f.get("sequence_id")
                break
        seq = [f["file_name"] for f in frames if f.get("sequence_id") == seq_id]
        i = seq.index(nearest)
        step = 5
        if i < step:
            cand = [i + step, i + 2 * step]
        elif i >= len(seq) - step:
            cand = [i - step, i - 2 * step]
        else:
            cand = [i - step, i + step]
        return [nearest] + [seq[j] for j in cand if 0 <= j < len(seq)]

    # -- item assembly ------------------------------------------------------

    def _load_transformed(self, meta: Dict, aug_params=None, mask=None):
        img, depth, Tcw, K = load_frame(self.store.base_dir, meta)
        img, depth, Tcw, K, mask = self.transform(img, depth, Tcw, K, mask)
        if aug_params is not None:
            img, depth, Tcw, K, mask = self.aug_transform(
                img, depth, Tcw, K, mask, params=aug_params)
        return img, depth, Tcw, K, mask

    def __len__(self) -> int:
        return len(self.store.frames(self.split))

    def __getitem__(self, idx: int) -> Dict:
        store, opts = self.store, self.opts
        meta = store.frames(self.split)[idx]
        rng = np.random.default_rng(
            (hash((self.epoch, self.split, idx)) & 0x7FFFFFFF))

        aug_params = self.aug_transform.sample_params(rng) \
            if self.mode == "train" else None

        if self.mode == "test" and self.test_time_style_change:
            # swap in the pre-stylized night images
            meta = dict(meta)
            meta["file_name"] = meta["file_name"].replace(
                "/seq", "/style_images/seq").replace("/frame", "_night/frame")

        tmask = None
        if store.bboxes_3d is not None and store.points is not None:
            # the frame's size before the transforms: the JAX package reads
            # the whole frame for it
            Tcw = _tcw44(meta["extrinsic_Tcw"])
            _, depth_probe, _, _ = load_frame(store.base_dir, meta)
            tmask = compute_target_mask(
                store.points, intrinsic_to_K(meta["camera_intrinsic"]), Tcw,
                depth_probe.shape).astype(np.uint8)

        img, depth, Tcw, K, tmask = self._load_transformed(meta, aug_params, tmask)
        if self.mode == "test" and self.test_time_color_jitter:
            import hashlib

            h = int(hashlib.sha1(meta["file_name"].encode()).hexdigest(), 16)
            p = self._tt_params[h % len(self._tt_params)]
            img, depth, Tcw, K, tmask = self._tt_jitter(img, depth, Tcw, K, tmask, params=p)
        c2w = np.linalg.inv(_tcw44(Tcw)).astype(np.float32)
        depth = depth * store.scale_factor

        names = self._support_names(meta, rng)
        sup = [self._load_transformed(store.train_frames[self._train_index[n]])
               for n in names]
        topk_images = np.stack([s[0] for s in sup]).astype(np.float32) / 255.0
        topk_depths = np.stack([s[1] for s in sup]) * store.scale_factor
        topk_poses = np.stack([np.linalg.inv(_tcw44(s[2])) for s in sup]
                              ).astype(np.float32)
        topk_Ks = np.stack([s[3] for s in sup]).astype(np.float32)

        near = np.float32(max(store.near, 0.01))
        far = np.float32(store.far)

        out: Dict = {
            "image": img.astype(np.float32) / 255.0,
            "depth": depth.astype(np.float32),
            "pose": c2w,
            "K": K.astype(np.float32),
            "near": near,
            "far": far,
            "topk_images": topk_images,
            "topk_depths": topk_depths.astype(np.float32),
            "topk_poses": topk_poses,
            "topk_Ks": topk_Ks,
            "scene": store.scene,
            "scale_factor": np.float32(store.scale_factor),
            "filename": meta["file_name"],
        }

        if store.points is not None:
            pts = store.points
            P = opts.max_points
            if len(pts) > P:
                sel = rng.choice(len(pts), P, replace=False)
                pts = pts[sel]
            padded = np.zeros((P, 3), np.float32)
            padded[: len(pts)] = pts
            pmask = np.zeros(P, bool)
            pmask[: len(pts)] = True
            out["points3d"] = padded
            out["points3d_mask"] = pmask

        if self.mode == "train" and opts.aug_ref_depth:
            out["topk_depths_gt"] = out["topk_depths"].copy()
            depth_len = float(far - near)
            noisy = []
            for d in out["topk_depths"]:
                nd = d
                if rng.random() < opts.aug_depth_offset_prob:
                    nd = add_depth_noise(nd, nd > 0, depth_len, rng)
                if rng.random() < opts.aug_global_noise_prob:
                    nd = nd + rng.uniform(-0.005, 0.005, nd.shape
                                          ).astype(np.float32) * depth_len
                noisy.append(nd)
            out["topk_depths"] = np.stack(noisy)

        # zero support depth outside the scene range
        rng_mask = (out["topk_depths"] > near) & (out["topk_depths"] < far)
        out["topk_depths"] = out["topk_depths"] * rng_mask.astype(np.float32)

        if store.bboxes_3d is not None:
            out["bbox3d_corners"] = store.bboxes_3d.reshape(-1, 3).astype(np.float32)
            if tmask is not None:
                out["target_mask"] = tmask.astype(bool)
        return out

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def set_mode(self, mode: str):
        self.mode = mode


class MultiSceneDataset:
    """Concatenation of per-scene datasets."""

    def __init__(self, datasets: Sequence[VideoDataset]):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, idx: int) -> Dict:
        d = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[d][idx - self._offsets[d]]

    def set_mode(self, mode: str):
        for d in self.datasets:
            d.set_mode(mode)

    def set_epoch(self, epoch: int):
        for d in self.datasets:
            d.set_epoch(epoch)

    def scene_names(self) -> List[str]:
        return [d.store.scene for d in self.datasets]
