"""Multi-view projection + sampling of support images/features
(counterpart of nerfloc_tpu/models/fields/projector.py)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...geometry.math import safe_normalize
from ...ops.interp import bilinear_sample_views

Tensor = torch.Tensor


class Projection(NamedTuple):
    uv: Tensor        # [V, N, 2] pixel locations in image resolution
    depth: Tensor     # [V, N] projected z-depth
    in_front: Tensor  # [V, N] bool, z > 0
    inbound: Tensor   # [V, N] bool, inside [0, W-1] x [0, H-1]


def _rows_times(x: Tensor, M: Tensor, fused_last: bool = False) -> Tensor:
    """x [..., 3] @ M [..., 3, 3] as XLA's CPU backend computes the small
    products of the JAX package's projection: each output column summed
    over k = 0, 1, 2 with every product and sum rounded to f32, except
    that with fused_last the third column's steps are fused (each product
    added exactly and the sum rounded once). Bit for bit, points on a
    view's own pixel grid then project to its border as in JAX (inbound is
    a hard test there)."""
    cols = [(x[..., 0] * M[..., 0, j] + x[..., 1] * M[..., 1, j]) + x[..., 2] * M[..., 2, j]
            for j in range(3)]
    if fused_last:
        x64, M64 = x.double(), M.double()
        acc = (x64[..., 0] * M64[..., 0, 2]).to(x.dtype)
        for k in (1, 2):
            acc = (x64[..., k] * M64[..., k, 2] + acc.double()).to(x.dtype)
        cols[2] = acc
    return torch.stack(cols, dim=-1)


def compute_projections(xyz: Tensor, Ks: Tensor, c2ws: Tensor, H: int,
                        W: int) -> Projection:
    """Project [N, 3] world points into V cameras (batched over views)."""
    pts_cam = _rows_times(xyz[None] - c2ws[:, None, :3, 3], c2ws[:, None, :3, :3],
                          fused_last=True)                                   # [V, N, 3]
    uvz = _rows_times(pts_cam, Ks[:, None].transpose(-1, -2))
    z = uvz[..., 2]
    denom = torch.where(torch.abs(z) < 1e-8,
                        torch.where(z < 0, torch.full_like(z, -1e-8), torch.full_like(z, 1e-8)),
                        z)
    u, v = uvz[..., 0] / denom, uvz[..., 1] / denom
    uv = torch.stack([torch.clamp(u, -1e6, 1e6), torch.clamp(v, -1e6, 1e6)], dim=-1)
    inbound = ((uv[..., 0] >= 0) & (uv[..., 0] <= W - 1.0)
               & (uv[..., 1] >= 0) & (uv[..., 1] <= H - 1.0))
    return Projection(uv, z, z > 0, inbound)


def feature_uv(uv: Tensor, h: int, w: int, H: int, W: int) -> Tensor:
    """Image-pixel coords uv [..., 2] of H x W images -> featmap-pixel coords
    in h x w maps (align-corners sampling). The factors are made on uv's
    device, so nothing is copied from the host: a linspace of two steps
    holds exactly its two ends, rounded to uv's dtype."""
    return uv * torch.linspace((w - 1.0) / (W - 1.0), (h - 1.0) / (H - 1.0), 2,
                               dtype=uv.dtype, device=uv.device)


def project_and_sample(xyz: Tensor, Ks: Tensor, c2ws: Tensor, images: Tensor,
                       featmaps: Tensor):
    """-> rgb [N, V, 3], feat [N, V, C], mask [N, V, 1] (in_front & inbound);
    featmaps may have another resolution than the images."""
    H, W = images.shape[1], images.shape[2]
    h, w = featmaps.shape[1], featmaps.shape[2]
    proj = compute_projections(xyz, Ks, c2ws, H, W)
    rgb = bilinear_sample_views(images, proj.uv)
    feat = bilinear_sample_views(featmaps, feature_uv(proj.uv, h, w, H, W))
    mask = (proj.in_front & proj.inbound).to(xyz.dtype)
    return rgb.transpose(0, 1), feat.transpose(0, 1), mask.T[..., None]


def compute_angle(xyz: Tensor, query_pose: Tensor, support_poses: Tensor) -> Tensor:
    """Ray-angle features [V, N, 4]: the unit difference of the
    point->query-camera and point->support-camera directions, and their
    dot product."""
    ray2tar = safe_normalize(query_pose[:3, 3][None, :] - xyz)          # [N, 3]
    ray2src = safe_normalize(support_poses[:, None, :3, 3] - xyz[None])  # [V, N, 3]
    diff = safe_normalize(ray2tar[None] - ray2src)
    dot = torch.sum(ray2tar[None] * ray2src, dim=-1, keepdim=True)
    return torch.cat([diff, dot], dim=-1)
