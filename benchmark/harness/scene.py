"""Seeded queries over the synthetic box scene, made on the device.

A copy of the port's `data.synthetic.make_query_batch` (the reference batch
contract: the query image and depth, its pose and intrinsics, the support
views' images, depths, poses and intrinsics, near and far), kept here so
that no change to the port moves the traffic. The camera sits inside an
axis-aligned textured box: depth is the ray's exit distance, colour a
smooth 3D texture at the hit point. The poses come from the seed on the
host (a few numbers); the views are rendered on the device.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

BOX_HALF = 2.0


def texture(p: torch.Tensor) -> torch.Tensor:
    """Smooth colour in [0, 1] at points p [..., 3] (the port's tex=0)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.5 + 0.35 * torch.sin(1.7 * x + 0.3) + 0.15 * torch.sin(3.1 * y * z)
    g = 0.5 + 0.35 * torch.sin(2.3 * y - 1.1) + 0.15 * torch.sin(2.9 * x * z + 1.0)
    b = 0.5 + 0.35 * torch.cos(1.9 * z + 0.7) + 0.15 * torch.sin(2.2 * x * y - 0.5)
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


def render_box_views(c2w: torch.Tensor, K: torch.Tensor, H: int, W: int):
    """RGB [V, H, W, 3] and z-depth [V, H, W] of the box interior from the
    cameras c2w [V, 4, 4] (float64 on the device)."""
    dev = c2w.device
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float64, device=dev),
                          torch.arange(W, dtype=torch.float64, device=dev), indexing="ij")
    d_cam = torch.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                         torch.ones_like(u)], dim=-1)                 # [H, W, 3], z = 1
    d_w = torch.einsum("hwj,vij->vhwi", d_cam, c2w[:, :3, :3])        # [V, H, W, 3]
    o = c2w[:, None, None, :3, 3]
    safe = torch.where(d_w.abs() < 1e-12, torch.ones_like(d_w), d_w)
    t_axis = torch.where(d_w.abs() < 1e-12, torch.full_like(d_w, math.inf),
                         (torch.sign(d_w) * BOX_HALF - o) / safe)
    t_hit = torch.where(t_axis > 0, t_axis, torch.full_like(t_axis, math.inf)).amin(dim=-1)
    pts = o + d_w * t_hit[..., None]
    return texture(pts).float(), t_hit.float()


def look_at_pose(eye: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)) -> np.ndarray:
    """OpenCV-convention camera-to-world (z forward, y down)."""
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, dtype=np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, eye
    return T


def query(n_views: int, H: int, W: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """One query and its n_views support views, as device tensors with the
    numeric fields of the batch contract."""
    rng = np.random.default_rng(seed)
    f = 0.8 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], dtype=np.float64)

    def sample_pose(angle):
        eye = np.array([0.35 * np.cos(angle), 0.1 * np.sin(2 * angle), 0.35 * np.sin(angle)])
        target = np.array([2.0 * np.cos(angle), 0.3 * np.sin(angle), 2.0 * np.sin(angle)])
        return look_at_pose(eye, target)

    base = rng.uniform(0, 2 * np.pi)
    angles = base + np.linspace(-0.25, 0.25, n_views) + rng.normal(0, 0.02, n_views)
    poses = np.stack([sample_pose(base)] + [sample_pose(a) for a in angles])
    Kt = torch.tensor(K, device=device)
    rgb, depth = render_box_views(torch.tensor(poses, device=device), Kt, H, W)
    K32 = Kt.float()
    return {"image": rgb[0], "depth": depth[0],
            "pose": torch.tensor(poses[0], dtype=torch.float32, device=device),
            "K": K32,
            "near": torch.tensor(0.5, device=device),
            "far": torch.tensor(2.0 * BOX_HALF * math.sqrt(3.0), dtype=torch.float32,
                                device=device),
            "topk_images": rgb[1:], "topk_depths": depth[1:],
            "topk_poses": torch.tensor(poses[1:], dtype=torch.float32, device=device),
            "topk_Ks": K32.expand(n_views, 3, 3).contiguous(),
            "scale_factor": torch.tensor(1.0, device=device)}
