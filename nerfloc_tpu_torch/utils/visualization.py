"""Trajectory dumps (counterpart of nerfloc_tpu/utils/visualization.py's
`dump_trajectory`; the 3D box overlay is not ported)."""
from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np


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
