"""LLFF (forward-facing) scene loading through poses_bounds.npy
(counterpart of nerfloc_tpu/data/llff_scene.py):

  <scene>/poses_bounds.npy   [N, 17]: 3x5 pose (R | t | [H, W, focal]) + near/far
  <scene>/images[_N]/*       source images (optionally downsampled by N)

LLFF poses are [down, right, back] axes, converted to OpenCV's [right,
down, forward]. Every 8th frame is the test split.
"""
from __future__ import annotations

import glob
import os
from typing import List

import numpy as np

from .scene_store import SceneStore


def llff_scene_store(base_dir: str, scene: str, factor: int = 4,
                     holdout: int = 8) -> SceneStore:
    scene_dir = os.path.join(base_dir, scene)
    pb = np.load(os.path.join(scene_dir, "poses_bounds.npy"))  # [N, 17]
    poses = pb[:, :15].reshape(-1, 3, 5)
    bounds = pb[:, 15:]

    img_dir = os.path.join(scene_dir, f"images_{factor}")
    if not os.path.isdir(img_dir):
        img_dir = os.path.join(scene_dir, "images")
        factor = 1
    names = sorted(glob.glob(os.path.join(img_dir, "*")))
    names = [n for n in names
             if n.lower().endswith((".png", ".jpg", ".jpeg"))]
    if len(names) != len(poses):
        raise ValueError(f"{scene_dir}: {len(names)} images vs {len(poses)} poses")

    frames: List[dict] = []
    for i, (p, name) in enumerate(zip(poses, names)):
        H, W, focal = p[:, 4]
        H, W, focal = H / factor, W / factor, focal / factor
        # LLFF [down, right, back] -> OpenCV [right, down, forward]
        c2w = np.eye(4)
        c2w[:3, :4] = np.concatenate(
            [p[:, 1:2], p[:, 0:1], -p[:, 2:3], p[:, 3:4]], axis=1)
        frames.append({
            "file_name": os.path.relpath(name, scene_dir),
            "depth_file_name": "none",  # LLFF has no depth; zeros at load
            "extrinsic_Tcw": np.linalg.inv(c2w)[:3].astype(np.float32),
            "camera_intrinsic": np.array(
                [focal, focal, W / 2.0, H / 2.0, 0.0, 0.0], np.float32),
            "near": float(bounds[i, 0] * 0.9),
            "far": float(bounds[i, 1] * 1.1),
            "sequence_id": "0",
            "frame_id": i,
        })

    store = SceneStore(base_dir=scene_dir, scene=scene)
    store.test_frames = [f for i, f in enumerate(frames)
                         if i % holdout == 0]
    store.train_frames = [f for i, f in enumerate(frames)
                          if i % holdout != 0]
    store.near = min(f["near"] for f in frames)
    store.far = max(f["far"] for f in frames)
    store._recenter()
    store._rescale(1.0)
    return store
