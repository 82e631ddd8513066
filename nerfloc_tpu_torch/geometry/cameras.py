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


def views_times(x: Tensor, M: Tensor) -> Tensor:
    """x[v] @ M[v] for each view: x [V, P, 3], M [V, 3, 3] -> [V, P, 3].

    One product of all views' rows with every view's M ([V*P, 3] @
    [3, 3V]), of which each view keeps its own block: each element is
    summed as one matrix product sums it, whatever P (on the CPU an FMA
    chain over k, as the JAX package's dots; a batched product of few rows
    takes another path there). The V-fold work is 3V columns a row."""
    V, P, _ = x.shape
    out = x.reshape(V * P, 3) @ M.permute(1, 0, 2).reshape(3, 3 * V)
    return out.view(V, P, V, 3).diagonal(dim1=0, dim2=2).permute(2, 0, 1)


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


def camera_dirs(H: int, W: int, K: Tensor) -> Tensor:
    """Camera-frame directions ((u - cx) / fx, (v - cy) / fy, 1) of the
    pixels of cameras K [..., 3, 3] -> [..., H, W, 3]."""
    uv = pixel_grid(H, W, K)
    k = K[..., None, None, :, :]
    x = (uv[..., 0] - k[..., 0, 2]) / k[..., 0, 0]
    y = (uv[..., 1] - k[..., 1, 2]) / k[..., 1, 1]
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def get_rays(H: int, W: int, K: Tensor, c2w: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-pixel world rays (rays_o [H,W,3], unit rays_d [H,W,3])."""
    rays_d = camera_dirs(H, W, K) @ c2w[:3, :3].T
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
    """[V, H, W] depths of cameras K [V, 3, 3], c2w [V, 4, 4] -> (world
    points [V, H, W, 3], validity depth > 0)."""
    V, H, W = depth.shape
    pts_cam = (camera_dirs(H, W, K) * depth[..., None]).reshape(V, H * W, 3)
    pts = views_times(pts_cam, c2w[:, :3, :3].transpose(-1, -2)) + c2w[:, None, :3, 3]
    return pts.reshape(V, H, W, 3), depth > 0


def scale_intrinsics(K: Tensor, stride: float) -> Tensor:
    """The first two rows of K [..., 3, 3] times 1 / stride (rounded to
    K's dtype), the third as it is."""
    return torch.cat([K[..., :2, :] * (1.0 / stride), K[..., 2:, :]], dim=-2)
