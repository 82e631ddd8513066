"""Trajectory dumps and the 3D box overlay (counterpart of
nerfloc_tpu/utils/visualization.py's `dump_trajectory`, `BOX_EDGES`,
`project_points_np` and `draw_box3d`; the lines are drawn by
data/imgproc.line, OpenCV's cv2.line arithmetic)."""
from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np

from ..data import imgproc

# 12 edges of a box given its 8 corners in OnePose order
BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
             (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]


def project_points_np(xyz: np.ndarray, K: np.ndarray, w2c: np.ndarray) -> np.ndarray:
    cam = xyz @ w2c[:3, :3].T + w2c[:3, 3]
    z = np.maximum(cam[:, 2], 1e-8)
    return (cam[:, :2] @ K[:2, :2].T) / z[:, None] + K[:2, 2]


def draw_box3d(img: np.ndarray, corners: np.ndarray, K: np.ndarray,
               pose_c2w: np.ndarray, color=(0, 255, 0), thickness: int = 2) -> np.ndarray:
    """A copy of img (uint8 [H, W, 3]) with the wireframe of the box whose
    8 world corners are `corners`, seen from camera-to-world `pose_c2w`."""
    w2c = np.linalg.inv(pose_c2w)
    uv = project_points_np(corners, K, w2c).astype(np.int32)
    out = img.copy()
    for a, b in BOX_EDGES:
        imgproc.line(out, uv[a], uv[b], color, thickness)
    return out


def dump_trajectory(path: str, filenames: List[str],
                    poses_pred: np.ndarray, poses_gt: np.ndarray,
                    points3d: Optional[np.ndarray] = None):
    """Trajectory + scene points pkl."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({
            "filenames": filenames,
            "poses_pred": np.asarray(poses_pred),
            "poses_gt": np.asarray(poses_gt),
            "points3d": points3d,
        }, f)
