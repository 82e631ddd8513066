"""K-nearest-neighbour search (counterpart of nerfloc_tpu/ops/knn.py:
`knn`, `knn_gather`, `pack_xyz_window`, `knn_proj`, `knn_from_candidates`).
XLA ops in the JAX package, plain PyTorch here.

Distances use the same expansion as the reference, |q|^2 - 2 q.p + |p|^2
clamped at 0, with masked points at finfo.max/4; ties go to the lower
point index, as lax.top_k orders them. The squared norms are rounded as
XLA's CPU backend rounds them (`sq_norm`): points back-projected from
millimetre depth maps sit at near-equal distances, and a last-bit
difference there reorders neighbours.

The render KNN (`knn_proj`) takes its candidates from a window of the
featmap grid around each sample's projection in every view. The JAX table
stores xyz as three bf16 parts whose sum is the f32 value exactly (a TPU
gather workaround); this table stores the f32 xyz itself, so the
candidates, their distances and the stable re-rank are the same.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .interp import pack_window

Tensor = torch.Tensor


def topk_first(x: Tensor, k: int, largest: bool = True) -> Tuple[Tensor, Tensor]:
    """Top-k along the last axis, sorted, with exact ties broken towards
    the lower index (lax.top_k's order; torch.topk leaves it unspecified)."""
    vals, idx = torch.sort(x, dim=-1, descending=largest, stable=True)
    return vals[..., :k], idx[..., :k]


def sq_norm(x: Tensor) -> Tensor:
    """|x|^2 over the last axis, summed left to right with each step one
    fused multiply-add rounded once to x's dtype: the order and roundings
    of XLA's CPU reduction of f32 vectors (each fused step in f64, then
    rounded), on every device, so the CUDA and CPU paths rank neighbours
    alike."""
    sq = x.to(torch.float64) ** 2
    acc = sq[..., 0].to(x.dtype)
    for i in range(1, x.shape[-1]):
        acc = (sq[..., i] + acc.to(torch.float64)).to(x.dtype)
    return acc


def knn(queries: Tensor, points: Tensor, K: int,
        points_mask: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """(squared dists [N, K] ascending, idx [N, K] int64) of the K nearest
    `points` [M, D] to each query [N, D]; masked points are excluded."""
    big = torch.finfo(queries.dtype).max / 4
    d = sq_norm(queries)[:, None] - 2.0 * (queries @ points.T) + sq_norm(points)[None, :]
    d = torch.clamp(d, min=0.0)
    if points_mask is not None:
        d = torch.where(points_mask[None, :], d, torch.full_like(d, big))
    return topk_first(d, K, largest=False)


def knn_gather(features: Tensor, idx: Tensor) -> Tensor:
    """Gather [M, C] features at [N, K] indices -> [N, K, C]."""
    return features[torch.clamp(idx, min=0)]


def proj_window(win: int) -> Tuple[Tuple[int, int], ...]:
    """(dx, dy) offsets of a win x win window, dy-major."""
    r = win // 2
    return tuple((dx, dy) for dy in range(-r, r + 1) for dx in range(-r, r + 1))


def pack_xyz_window(xyz_maps: Tensor, mask_maps: Tensor, win: int = 3) -> Tensor:
    """knn_proj's candidate table: [V, h, w, 3] point maps + [V, h, w]
    validity -> [V*h*w, win^2 * 4] rows of [x, y, z, valid] per offset."""
    cells = torch.cat([xyz_maps, mask_maps[..., None].to(xyz_maps.dtype)], dim=-1)
    return pack_window(cells, proj_window(win))


def knn_proj(xyz: Tensor, uv_fm: Tensor, front: Tensor, packed: Tensor,
             h: int, w: int, K: int, win: int = 3) -> Tensor:
    """Projection-window KNN of render samples against the fine neural
    points, which are the featmap grid of each support view.

    xyz [N, 3]; uv_fm [V, N, 2] projections in FEATMAP pixels (image uv /
    stride); front [V, N] bool (projection usable); packed from
    pack_xyz_window; h, w featmap size. The window centre is the rounded
    projection clipped to [r, size-1-r], so edge windows repeat candidates.
    Returns idx [N, K] int64 into the flat [V*h*w] points, nearest first."""
    V, N = uv_fm.shape[:2]
    r = win // 2
    dev = uv_fm.device
    u0 = torch.clamp(torch.round(uv_fm[..., 0]), r, w - 1 - r).long()
    v0 = torch.clamp(torch.round(uv_fm[..., 1]), r, h - 1 - r).long()
    row = torch.arange(V, device=dev)[:, None] * (h * w) + v0 * w + u0    # [V, N]
    g = packed[row.reshape(-1)].reshape(V, N, win * win, 4)
    valid = (g[..., 3] > 0.5) & front[:, :, None]
    off = torch.arange(-r, r + 1, device=dev)
    step = off.repeat_interleave(win) * w + off.repeat(win)             # dy-major
    return knn_from_candidates(xyz, g[..., :3], valid, row[..., None] + step, K)


def knn_from_candidates(xyz: Tensor, cand_xyz: Tensor, cand_valid: Tensor,
                        cand_idx: Tensor, K: int) -> Tensor:
    """Exact f32 re-rank of per-view candidates: xyz [N, 3], cand_xyz
    [V, N, O, 3], cand_valid [V, N, O], cand_idx [V, N, O] -> idx [N, K],
    nearest first; equal distances keep the view-major, offset-minor
    candidate order (a stable sort, as lax.sort)."""
    V, N, O = cand_idx.shape
    d = xyz[None, :, None, :] - cand_xyz
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    d2 = torch.where(cand_valid, d2, torch.finfo(torch.float32).max / 4)
    d2 = d2.permute(1, 0, 2).reshape(N, V * O)
    order = torch.sort(d2, dim=1, stable=True)[1][:, :K]
    return torch.gather(cand_idx.permute(1, 0, 2).reshape(N, V * O), 1, order)
