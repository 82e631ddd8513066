"""Shared preprocessing helpers (counterpart of
nerfloc_tpu/preprocess/common.py)."""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from ..data.ply import write_ply_points
from ..device import DeviceLike
from ..native.tsdf import TSDFVolume


def load_pose_txt(path: str) -> np.ndarray:
    """4x4 camera-to-world from a whitespace text file (7/12-Scenes layout)."""
    pose = np.loadtxt(path).astype(np.float64)
    if pose.shape != (4, 4):
        raise ValueError(f"{path}: bad pose shape {pose.shape}")
    return pose


def frame_near_far(depth_m: np.ndarray, lo: float = 0.1, hi: float = 99.9):
    """Per-frame near/far as depth percentiles."""
    d = depth_m.reshape(-1)
    return float(np.percentile(d, lo)), float(np.percentile(d, hi))


def make_meta(file_name: str, depth_file_name: str, Twc: np.ndarray,
              fx: float, fy: float, cx: float, cy: float,
              near: float, far: float, sequence_id, frame_id: int,
              frame_dim=None) -> Dict:
    return {
        "file_name": file_name,
        "depth_file_name": depth_file_name,
        "extrinsic_Tcw": np.linalg.inv(Twc)[:3].astype(np.float32),
        "camera_intrinsic": np.array([fx, fy, cx, cy, 0.0, 0.0],
                                     dtype=np.float32),
        "near": near,
        "far": far,
        "sequence_id": sequence_id,
        "frame_id": int(frame_id),
        "frame_dim": frame_dim,
    }


def write_info(scene_dir: str, split: str, metas: List[Dict]):
    os.makedirs(scene_dir, exist_ok=True)
    with open(os.path.join(scene_dir, f"info_{split}.pkl"), "wb") as f:
        pickle.dump(metas, f)


def fuse_scene_tsdf(frames, out_ply: str, voxel_size: float = 0.02,
                    frame_stride: int = 5, max_points: Optional[int] = None,
                    device: DeviceLike = None) -> int:
    """TSDF-fuse (rgb, depth_m, K, c2w) tuples into a coloured pc.ply on
    `device` (cuda unless the caller asks for the CPU; each frame is
    uploaded once). Returns the number of points written."""
    frames = list(frames)
    used = frames[::frame_stride] if frame_stride > 1 else frames
    bounds = TSDFVolume.frustum_bounds([f[1] for f in used],
                                       [f[2] for f in used],
                                       [f[3] for f in used])
    vol = TSDFVolume(bounds, voxel_size=voxel_size, device=device)
    for rgb, depth, K, c2w in used:
        vol.integrate(rgb, depth, K, c2w)
    xyz, rgb = vol.get_point_cloud(thresh=0.2)
    if max_points is not None and len(xyz) > max_points:
        sel = np.random.default_rng(0).choice(len(xyz), max_points,
                                              replace=False)
        xyz, rgb = xyz[sel], rgb[sel]
    write_ply_points(out_ply, xyz, rgb)
    return len(xyz)
