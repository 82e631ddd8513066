"""Support-view core-set samplers in numpy (a copy of
nerfloc_tpu/data/samplers.py; the same generator calls in the same order):
  fps_poses      farthest-point sampling under rotation-angular distance,
                 with a running min-distance vector;
  covisibility   greedy max-coverage of scene points over a boolean
                 visibility table, falling back to rotation FPS once every
                 point is covered.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def rotation_angular_dist(R1: np.ndarray, R2: np.ndarray) -> np.ndarray:
    """Angle of R1 R2^T for broadcastable stacks of rotations, radians."""
    rel = R1 @ np.swapaxes(R2, -1, -2)
    tr = np.trace(rel, axis1=-2, axis2=-1)
    return np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0))


def fps_poses(c2ws: np.ndarray, k: int,
              rng: Optional[np.random.Generator] = None,
              init_idx: Optional[int] = None) -> np.ndarray:
    """Select k pose indices by farthest-point sampling over rotation angle."""
    n = len(c2ws)
    k = min(k, n)
    rng = rng or np.random.default_rng(666)
    R = c2ws[:, :3, :3]
    first = int(rng.integers(n)) if init_idx is None else init_idx
    chosen = [first]
    min_d = rotation_angular_dist(R, R[first][None])
    for _ in range(1, k):
        nxt = int(np.argmax(min_d))
        chosen.append(nxt)
        min_d = np.minimum(min_d, rotation_angular_dist(R, R[nxt][None]))
    return np.asarray(chosen, dtype=np.int64)


class CovisibilitySampler:
    """Greedy max-coverage over a point-visibility table."""

    def __init__(self, points: np.ndarray, w2cs: np.ndarray, Ks: np.ndarray,
                 image_hw: Optional[tuple] = None, max_num_pts: int = 8192,
                 rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng(666)
        if len(points) > max_num_pts:
            points = points[rng.choice(len(points), max_num_pts, replace=False)]
        self.points = points
        self.w2cs = w2cs
        self.Ks = Ks
        # vis[i, j] = point j visible in view i
        pts_cam = np.einsum("vij,nj->vni", w2cs[:, :3, :3], points) \
            + w2cs[:, :3, 3][:, None, :]
        uvz = np.einsum("vij,vnj->vni", Ks, pts_cam)
        z = uvz[..., 2]
        u = uvz[..., 0] / (z + 1e-8)
        v = uvz[..., 1] / (z + 1e-8)
        if image_hw is None:
            # the image size inferred from the principal point
            w_img = (Ks[:, 0, 2] * 2)[:, None]
            h_img = (Ks[:, 1, 2] * 2)[:, None]
        else:
            h_img = np.full((len(Ks), 1), image_hw[0], dtype=np.float64)
            w_img = np.full((len(Ks), 1), image_hw[1], dtype=np.float64)
        self.vis = (z > 0) & (u > 0) & (u < w_img) & (v > 0) & (v < h_img)

    def sample(self, k: int, target: Optional[np.ndarray] = None) -> np.ndarray:
        """Greedy cover; target = boolean point subset to cover (default all).
        Falls back to rotation-FPS among the already-chosen set once covered."""
        n_views = self.vis.shape[0]
        k = min(k, n_views)
        remaining = np.ones(self.vis.shape[1], bool) if target is None \
            else target.copy()
        available = np.ones(n_views, bool)
        chosen = []
        c2w_R = np.swapaxes(self.w2cs[:, :3, :3], -1, -2)
        min_d = np.full(n_views, np.inf)
        for _ in range(k):
            if remaining.any():
                gain = self.vis[:, remaining].sum(axis=1)
                gain[~available] = -1
                best = int(np.argmax(gain))
                remaining &= ~self.vis[best]
            else:
                d = np.where(available, min_d, -np.inf)
                best = int(np.argmax(d))
            chosen.append(best)
            available[best] = False
            min_d = np.minimum(min_d, rotation_angular_dist(c2w_R, c2w_R[best][None]))
        return np.asarray(chosen, dtype=np.int64)
