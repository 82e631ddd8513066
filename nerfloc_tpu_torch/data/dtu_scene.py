"""DTU scene loading, MVSNet's rectified layout (counterpart of
nerfloc_tpu/data/dtu_scene.py):

  <base>/Cameras[/train]/<view:08d>_cam.txt   'extrinsic' 4x4 w2c rows,
                                              'intrinsic' 3x3 rows,
                                              'depth_min depth_interval
                                               [n_depths depth_max]'
  <base>/Rectified/<scan>[_train]/rect_<view+1:03d>_<light>_r5000.png
  <base>/Depths/<scan>[_train]/depth_map_<view:04d>.pfm   (optional)

MVSNet cam.txt intrinsics belong to the 4x-downsampled depth resolution;
`intrinsic_scale` (default 4.0) rescales them to the rectified image size
(1.0 for cam files that already match the images). Every 8th view is the
test split; support views come by pose proximity.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Optional

import numpy as np

from .scene_store import SceneStore, attach_pose_retrieval


def _read_cam_file(path: str):
    with open(path) as f:
        txt = f.read()
    nums = {}
    for key in ("extrinsic", "intrinsic"):
        m = re.search(key + r"\s*\n((?:[-\d.eE+\s]+\n?)+)", txt)
        if m is None:
            raise ValueError(f"no '{key}' block in {path}")
        nums[key] = np.array(m.group(1).split(), dtype=np.float64)
    w2c = nums["extrinsic"][:16].reshape(4, 4).astype(np.float32)
    K = nums["intrinsic"][:9].reshape(3, 3).astype(np.float32)
    # trailing line: depth_min depth_interval [n_depths depth_max]
    tail = txt.strip().splitlines()[-1].split()
    depth_min = float(tail[0])
    if len(tail) >= 4:
        depth_max = float(tail[3])
    else:
        depth_max = depth_min + float(tail[1]) * 192.0  # MVSNet default planes
    return w2c, K, depth_min, depth_max


def dtu_scene_store(base_dir: str, scan: str, light: str = "3",
                    intrinsic_scale: float = 4.0, holdout: int = 8,
                    max_views: Optional[int] = None) -> SceneStore:
    """Build a SceneStore for one DTU scan (e.g. scan='scan114')."""
    cam_dir = os.path.join(base_dir, "Cameras", "train")
    if not os.path.isdir(cam_dir):
        cam_dir = os.path.join(base_dir, "Cameras")
    img_dir = os.path.join(base_dir, "Rectified", f"{scan}_train")
    if not os.path.isdir(img_dir):
        img_dir = os.path.join(base_dir, "Rectified", scan)
    depth_dir = os.path.join(base_dir, "Depths", f"{scan}_train")
    if not os.path.isdir(depth_dir):
        depth_dir = os.path.join(base_dir, "Depths", scan)

    cam_files = sorted(glob.glob(os.path.join(cam_dir, "*_cam.txt")))
    if max_views is not None:
        cam_files = cam_files[:max_views]
    if not cam_files:
        raise FileNotFoundError(f"no cam files under {cam_dir}")

    frames: List[Dict] = []
    nears, fars = [], []
    for cam_path in cam_files:
        view = int(os.path.basename(cam_path).split("_")[0])
        img_name = f"rect_{view + 1:03d}_{light}_r5000.png"
        img_path = os.path.join(img_dir, img_name)
        if not os.path.exists(img_path):
            continue
        w2c, K, dmin, dmax = _read_cam_file(cam_path)
        K = K.copy()
        K[:2] *= intrinsic_scale
        depth_rel = os.path.join(
            os.path.relpath(depth_dir, base_dir),
            f"depth_map_{view:04d}.pfm")
        if not os.path.exists(os.path.join(base_dir, depth_rel)):
            depth_rel = "none"
        frames.append({
            "file_name": os.path.join(os.path.relpath(img_dir, base_dir),
                                      img_name),
            "depth_file_name": depth_rel,
            "extrinsic_Tcw": w2c[:3].astype(np.float32),
            "camera_intrinsic": np.array(
                [K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0.0, 0.0], np.float32),
            "near": dmin * 0.9,
            "far": dmax * 1.1,
            "sequence_id": "0",
            "frame_id": view,
        })
        nears.append(dmin * 0.9)
        fars.append(dmax * 1.1)
    if not frames:
        raise FileNotFoundError(
            f"no rectified images for {scan} (light '{light}') in {img_dir}")

    store = SceneStore(base_dir=base_dir, scene=scan)
    store.test_frames = frames[::holdout]
    test_ids = {id(f) for f in store.test_frames}
    store.train_frames = [f for f in frames if id(f) not in test_ids]
    store.near = float(min(nears))
    store.far = float(max(fars))
    store._recenter()
    # DTU scans are millimetre-scale; rescale so far ~ 10 units (as
    # SceneStore.load's rescale_far_limit does)
    store._rescale(10.0 / store.far)
    attach_pose_retrieval(store, k=10)
    return store
