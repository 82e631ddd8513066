"""Pinhole camera math (counterpart of nerfloc_tpu/geometry/cameras.py).

Conventions: `c2w` is a camera-to-world 4x4 (OpenCV camera: x right, y
down, z forward), `K` a 3x3 intrinsics matrix, pixel (u, v) with u along
the width.
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def pixel_grid(H: int, W: int, like: Tensor) -> Tensor:
    """[H, W, 2] grid of (u, v) pixel coordinates in like's dtype/device."""
    u = torch.arange(W, dtype=like.dtype, device=like.device)
    v = torch.arange(H, dtype=like.dtype, device=like.device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return torch.stack([uu, vv], dim=-1)


def transform_points(T: Tensor, pts: Tensor) -> Tensor:
    """Apply a 4x4 (or 3x4) rigid transform to [..., 3] points."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., :3, 3]


def world_to_camera(c2w: Tensor, pts_w: Tensor) -> Tensor:
    """World points -> camera frame through the closed-form rigid inverse."""
    return (pts_w - c2w[..., :3, 3]) @ c2w[..., :3, :3]


def camera_project(pts_cam: Tensor, K: Tensor, eps: float = 1e-8
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """(u, v, z) of camera-frame points; the division is guarded at z~0
    (callers mask with z > 0)."""
    uvz = pts_cam @ K.transpose(-1, -2)
    z = uvz[..., 2]
    small = torch.where(z < 0, torch.full_like(z, -eps), torch.full_like(z, eps))
    denom = torch.where(torch.abs(z) < eps, small, z)
    return uvz[..., 0] / denom, uvz[..., 1] / denom, z


def get_rays(H: int, W: int, K: Tensor, c2w: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-pixel world rays (rays_o [H,W,3], unit rays_d [H,W,3])."""
    uv = pixel_grid(H, W, K)
    dirs = torch.stack([(uv[..., 0] - K[0, 2]) / K[0, 0],
                        (uv[..., 1] - K[1, 2]) / K[1, 1],
                        torch.ones_like(uv[..., 0])], dim=-1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_d = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    return c2w[:3, 3].expand_as(rays_d), rays_d


def rays_for_pixels(uv: Tensor, K: Tensor, c2w: Tensor) -> Tuple[Tensor, Tensor]:
    """Rays through arbitrary float pixel coordinates [N, 2] ->
    (rays_o [N,3], unit rays_d [N,3]); only the requested rays are built."""
    dirs = torch.stack([(uv[..., 0] - K[0, 2]) / K[0, 0],
                        (uv[..., 1] - K[1, 2]) / K[1, 1],
                        torch.ones_like(uv[..., 0])], dim=-1)
    rays_d = dirs @ c2w[:3, :3].T
    rays_d = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
    return c2w[:3, 3].expand_as(rays_d), rays_d


def backproject_depth(depth: Tensor, K: Tensor, c2w: Tensor) -> Tuple[Tensor, Tensor]:
    """[H, W] depth -> (world points [H,W,3], validity depth > 0)."""
    H, W = depth.shape
    uv = pixel_grid(H, W, depth)
    x = (uv[..., 0] - K[0, 2]) / K[0, 0]
    y = (uv[..., 1] - K[1, 2]) / K[1, 1]
    pts_cam = torch.stack([x * depth, y * depth, depth], dim=-1)
    return transform_points(c2w, pts_cam), depth > 0


def scale_intrinsics(K: Tensor, stride: float) -> Tensor:
    """Divide the first two rows of K by `stride`."""
    scale = torch.tensor([1.0 / stride, 1.0 / stride, 1.0], dtype=K.dtype,
                         device=K.device)
    return K * scale[:, None]
