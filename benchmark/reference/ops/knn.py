"""K-nearest-neighbour search (counterpart of nerfloc_tpu/ops/knn.py:
`knn`, `knn_rays`, `knn_gather`, `split_bf16x3`, `xyz_window_channels`,
`pack_xyz_window`, `knn_proj`, `knn_from_candidates`,
`knn_from_candidate_planes`). XLA ops in the JAX package, plain PyTorch
here.

Distances use the same expansion as the reference, |q|^2 - 2 q.p + |p|^2
clamped at 0, with masked points at finfo.max/4; ties go to the lower
point index, as lax.top_k orders them. The squared norms are rounded as
XLA's CPU backend rounds them (`sq_norm`): points back-projected from
millimetre depth maps sit at near-equal distances, and a last-bit
difference there reorders neighbours. `knn` tiles the point cloud and
chunks the queries, so its distance block stays bounded at render width,
and merges the tiles' top-K exactly.

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
    return dot_last(x, x)


KNN_TILE = 8192           # points per tile of the flat KNN (the JAX package's tile)
KNN_QUERY_CHUNK = 16384   # queries per distance block: [chunk, tile] f32 plus its sort


def knn(queries: Tensor, points: Tensor, K: int,
        points_mask: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """(squared dists [N, K] ascending, idx [N, K] int64) of the K nearest
    `points` [M, D] to each query [N, D]; masked points are excluded.

    The points go in tiles of KNN_TILE and the queries in chunks of
    KNN_QUERY_CHUNK: each tile's top-K, then an exact merge of the tiles'
    candidates. The tiles are concatenated in point order and every sort
    is stable, so equal distances still go to the lower point index."""
    big = torch.finfo(queries.dtype).max / 4
    q_sq, p_sq = sq_norm(queries), sq_norm(points)
    out_d, out_i = [], []
    for q0 in range(0, queries.shape[0], KNN_QUERY_CHUNK):
        q = queries[q0:q0 + KNN_QUERY_CHUNK]
        cand_d, cand_i = [], []
        for p0 in range(0, points.shape[0], KNN_TILE):
            p = points[p0:p0 + KNN_TILE]
            d = q_sq[q0:q0 + KNN_QUERY_CHUNK, None] - 2.0 * (q @ p.T) \
                + p_sq[None, p0:p0 + KNN_TILE]
            d = torch.clamp(d, min=0.0)
            if points_mask is not None:
                d = torch.where(points_mask[None, p0:p0 + KNN_TILE], d,
                                torch.full_like(d, big))
            vals, idx = topk_first(d, K, largest=False)
            cand_d.append(vals)
            cand_i.append(idx + p0)
        if len(cand_d) == 1:
            out_d.append(cand_d[0])
            out_i.append(cand_i[0])
            continue
        vals, pos = topk_first(torch.cat(cand_d, dim=1), K, largest=False)
        out_d.append(vals)
        out_i.append(torch.gather(torch.cat(cand_i, dim=1), 1, pos))
    return torch.cat(out_d), torch.cat(out_i)


def dot_last(a: Tensor, b: Tensor) -> Tensor:
    """sum(a * b) over the last axis in sq_norm's order and roundings."""
    prod = a.to(torch.float64) * b.to(torch.float64)
    acc = prod[..., 0].to(a.dtype)
    for i in range(1, a.shape[-1]):
        acc = (prod[..., i] + acc.to(torch.float64)).to(a.dtype)
    return acc


def _mean_rows(points: Tensor) -> Tensor:
    """Mean of [M, 3] points over M."""
    return points.sum(0) / points.shape[0]


def _exact_dot3(a: Tensor, b: Tensor) -> Tensor:
    """[R, 3] x [T, 3] -> [R, T] as ((a0 b0 + a1 b1) + a2 b2) in f32. The
    operands hold bf16 values, so every product is exact in f32 and the
    sum order alone fixes the result, on every device alike."""
    a, b = a.float(), b.float()
    return (a[:, None, 0] * b[None, :, 0] + a[:, None, 1] * b[None, :, 1]) \
        + a[:, None, 2] * b[None, :, 2]


def ray_segment_keys(rays_o: Tensor, rays_d: Tensor, z_vals: Tensor, points: Tensor,
                     points_mask: Optional[Tensor] = None,
                     selection_dtype: torch.dtype = torch.float32):
    """knn_rays' selection keys: a function keys(lo, hi) -> [R, hi - lo]
    squared distances of points[lo:hi] (centred on the cloud's mean) to each
    ray's [z_first, z_last] segment in selection_dtype, masked points at
    3e38. With bf16, op by op as XLA's CPU backend rounds the JAX
    package's graph; the products take bf16 operands and sum in f32."""
    sd, f32 = selection_dtype, torch.float32
    M = points.shape[0]
    if points_mask is None:
        points_mask = torch.ones(M, dtype=torch.bool, device=points.device)
    center = _mean_rows(points)
    pts_c = (points - center).to(sd)
    ro_c = rays_o - center
    rays_o_c, rays_d_b = ro_c.to(sd), rays_d.to(sd)
    o_sq_b = sq_norm(ro_c).to(sd)[:, None]
    od_b = dot_last(ro_c, rays_d).to(sd)[:, None]
    d_sq_b = sq_norm(rays_d).to(sd)[:, None]
    big16 = torch.tensor(3e38, dtype=f32).to(sd)
    zlo, zhi = z_vals[:, :1].to(sd), z_vals[:, -1:].to(sd)

    def keys(lo: int, hi: int) -> Tensor:
        p, m = pts_c[lo:hi], points_mask[lo:hi]
        if sd == f32:
            pd, po = rays_d_b @ p.T, rays_o_c @ p.T
        else:
            pd = _exact_dot3(rays_d_b, p).to(sd)
            po = _exact_dot3(rays_o_c, p).to(sd)
        # the points' squared norms are bf16 whatever the selection dtype, as in JAX
        p_sq = sq_norm(p.float()).to(torch.bfloat16)[None, :].to(sd)
        t_p = (pd - od_b) / d_sq_b
        line2 = torch.clamp((p_sq - 2.0 * po + o_sq_b) - d_sq_b * t_p * t_p, min=0)
        dz = torch.minimum(torch.maximum(t_p, zlo), zhi) - t_p
        return torch.where(m[None, :], line2 + d_sq_b * dz * dz, big16)
    return keys


def knn_rays(rays_o: Tensor, rays_d: Tensor, z_vals: Tensor, points: Tensor, K: int,
             points_mask: Optional[Tensor] = None, n_candidates: int = 128,
             tile: int = KNN_TILE, selection_dtype: torch.dtype = torch.float32,
             return_candidates: bool = False):
    """Per-sample KNN for the samples z_vals [R, S] of rays (o [R, 3], d
    [R, 3]) among points [M, 3]: n_candidates points per ray by their
    distance to the ray's [z_first, z_last] segment (ray_segment_keys), then
    the exact f32 top-K of each sample among them. Returns idx [R, S, K]
    (int64, nearest first), or with return_candidates (idx, cand_idx
    [R, C], local_idx [R, S, K]) where idx == cand_idx gathered at
    local_idx.

    The selection runs over tiles of the cloud as the JAX package's does
    (its last tile padded with masked slots, whose indices run past M).
    Tied keys go to the lower point index; the JAX package's approx_min_k
    leaves their order to its sort, so a tie across the C-th place may
    pick another of the tied points there."""
    R, S = z_vals.shape
    M = points.shape[0]
    big = torch.finfo(rays_o.dtype).max / 4
    keys = ray_segment_keys(rays_o, rays_d, z_vals, points, points_mask, selection_dtype)
    big16 = torch.tensor(3e38, dtype=torch.float32).to(selection_dtype)
    tile = min(tile * 4, max(tile, M + (-M) % 256))
    C = n_candidates
    seg_all, idx_all = [], []
    for p0 in range(0, M, tile):
        seg = keys(p0, min(p0 + tile, M))
        if seg.shape[1] < tile:
            seg = torch.cat([seg, big16.to(seg.device).expand(R, tile - seg.shape[1])], dim=1)
        vals, idx = topk_first(seg, C, largest=False)
        seg_all.append(vals)
        idx_all.append(idx + p0)
    if len(seg_all) == 1:
        seg_c, cand_idx = seg_all[0], idx_all[0]
    else:
        seg_c, pos = topk_first(torch.cat(seg_all, dim=1), C, largest=False)
        cand_idx = torch.gather(torch.cat(idx_all, dim=1), 1, pos)
    cand_valid = seg_c.float() < 1.4e38

    d_sq = sq_norm(rays_d)
    cand_pts = points[torch.clamp(cand_idx, max=M - 1)]                 # [R, C, 3]
    u = cand_pts - rays_o[:, None, :]
    t_p = dot_last(u, rays_d[:, None, :].expand_as(u)) / d_sq[:, None]
    line2 = torch.clamp(sq_norm(u) - d_sq[:, None] * t_p * t_p, min=0.0)
    dz = z_vals[:, :, None] - t_p[:, None, :]                            # [R, S, C]
    d2 = line2[:, None, :] + d_sq[:, None, None] * dz * dz
    d2 = torch.where(cand_valid[:, None, :], d2, torch.full_like(d2, big))
    local = torch.sort(d2, dim=2, stable=True)[1][..., :K]
    idx = torch.gather(cand_idx[:, None, :].expand(R, S, C), 2, local)
    if return_candidates:
        return idx, cand_idx, local
    return idx


def knn_gather(features: Tensor, idx: Tensor) -> Tensor:
    """Gather [M, C] features at [N, K] indices -> [N, K, C]; indices
    outside [0, M) gather the nearest end row (callers mask them)."""
    return features[torch.clamp(idx, 0, features.shape[0] - 1)]


def proj_window(win: int) -> Tuple[Tuple[int, int], ...]:
    """(dx, dy) offsets of a win x win window, dy-major."""
    r = win // 2
    return tuple((dx, dy) for dy in range(-r, r + 1) for dx in range(-r, r + 1))


class _SplitBf16x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor):
        bits = x.float().contiguous().view(torch.int32)
        hi = (bits & -65536).view(torch.float32)
        r1 = x.float() - hi
        mid = (r1.contiguous().view(torch.int32) & -65536).view(torch.float32)
        lo = r1 - mid
        bf = torch.bfloat16
        return hi.to(bf), mid.to(bf), lo.to(bf)

    @staticmethod
    def backward(ctx, dhi: Tensor, dmid: Tensor, dlo: Tensor):
        return dhi.float() + dmid.float() + dlo.float()


def split_bf16x3(x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """f32 x -> (hi, mid, lo) bf16 parts whose f32 sum recovers x to about
    24 mantissa bits: hi and mid keep the top 16 bits of x and of x - hi
    (bit masks, so the bf16 casts are exact), lo is the rest. The gradient
    of x is the sum of the parts' gradients, as every consumer sums them."""
    return _SplitBf16x3.apply(x)


def xyz_window_channels(xyz_maps: Tensor, mask_maps: Tensor) -> Tensor:
    """[V, h, w, 3] f32 point maps + [V, h, w] validity -> [V, h, w, 10]
    bf16: the split_bf16x3 parts of xyz (hi | mid | lo) and the validity
    bit, the cell layout of the merged render table."""
    hi, mid, lo = split_bf16x3(xyz_maps)
    return torch.cat([hi, mid, lo, mask_maps[..., None].to(torch.bfloat16)], dim=-1)


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


def knn_from_candidate_planes(xyz: Tensor, cand_x: Tensor, cand_y: Tensor,
                              cand_z: Tensor, cand_valid: Tensor,
                              cand_idx: Tensor, K: int) -> Tensor:
    """knn_from_candidates with the candidates' coordinates as three
    [V, N, O] planes (the merged render table's layout)."""
    V, N, O = cand_idx.shape
    d2 = ((xyz[None, :, None, 0] - cand_x) ** 2 + (xyz[None, :, None, 1] - cand_y) ** 2
          + (xyz[None, :, None, 2] - cand_z) ** 2)
    d2 = torch.where(cand_valid, d2, torch.finfo(torch.float32).max / 4)
    d2 = d2.permute(1, 0, 2).reshape(N, V * O)
    order = torch.sort(d2, dim=1, stable=True)[1][:, :K]
    return torch.gather(cand_idx.permute(1, 0, 2).reshape(N, V * O), 1, order)
