"""Blender / NeRF-synthetic scene loading, transforms_{split}.json
(counterpart of nerfloc_tpu/data/blender_scene.py):

  <scene>/transforms_{train,test}.json  (camera_angle_x, frames[])
  <scene>/<frame.file_path>.png         RGBA renders
  optional <frame.file_path>_depth.npy / .png depth maps

Blender cameras are OpenGL's (y up, z backward); poses are converted to
the pipeline's OpenCV convention. Frames without depth get zeros.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from .reader import load_image
from .scene_store import SceneStore

# OpenGL cam (y up, z back) -> OpenCV cam (y down, z forward)
_GL2CV = np.diag([1.0, -1.0, -1.0, 1.0])


def load_blender_split(scene_dir: str, split: str, white_bkgd: bool = True
                       ) -> List[Dict]:
    with open(os.path.join(scene_dir, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    frames = []
    for i, fr in enumerate(meta["frames"]):
        rel = fr["file_path"]
        if not os.path.splitext(rel)[1]:
            rel = rel + ".png"
        rel = rel.lstrip("./")
        img_path = os.path.join(scene_dir, rel)
        # image size from the first frame (all share one camera)
        if i == 0:
            H, W = load_image(img_path).shape[:2]
            focal = 0.5 * W / np.tan(0.5 * meta["camera_angle_x"])
        c2w_gl = np.asarray(fr["transform_matrix"], np.float64)
        c2w = c2w_gl @ _GL2CV
        depth_rel = os.path.splitext(rel)[0] + "_depth.npy"
        if not os.path.exists(os.path.join(scene_dir, depth_rel)):
            alt = os.path.splitext(rel)[0] + "_depth.png"
            depth_rel = alt if os.path.exists(os.path.join(scene_dir, alt)) \
                else depth_rel
        frames.append({
            "file_name": rel,
            "depth_file_name": depth_rel,
            "extrinsic_Tcw": np.linalg.inv(c2w)[:3].astype(np.float32),
            "camera_intrinsic": np.array(
                [focal, focal, W / 2.0, H / 2.0, 0.0, 0.0], np.float32),
            "near": 2.0,
            "far": 6.0,
            "sequence_id": "0",
            "frame_id": i,
            "frame_dim": (H, W),
        })
    return frames


def blender_scene_store(base_dir: str, scene: str,
                        near: float = 2.0, far: float = 6.0) -> SceneStore:
    scene_dir = os.path.join(base_dir, scene)
    store = SceneStore(base_dir=scene_dir, scene=scene)
    store.train_frames = load_blender_split(scene_dir, "train")
    store.test_frames = load_blender_split(scene_dir, "test")
    for frames in (store.train_frames, store.test_frames):
        for f in frames:
            f["near"], f["far"] = near, far
    store.near, store.far = near, far
    store._recenter()
    store._rescale(1.0)
    return store
