"""Bilinear sampling and resizing on NHWC maps (counterpart of
nerfloc_tpu/ops/interp.py: `bilinear_sample` in border mode,
`resize_nearest`, `pack_bilinear_corners`, `pack_window`,
`packed_bilinear_sample_views`).

Pixel coordinates reference pixel centres: uv=(0,0) reads feat[0,0]
exactly (grid_sample align_corners=True semantics). These are plain PyTorch
gathers; the JAX package runs them as XLA ops, not Pallas kernels.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _corners(uv: Tensor, H: int, W: int):
    """Border-clamped top-left corner (u0, v0) and fractions (du, dv)."""
    u = torch.clamp(uv[..., 0], 0.0, W - 1)
    v = torch.clamp(uv[..., 1], 0.0, H - 1)
    u0 = torch.clamp(torch.floor(u), 0, W - 2).long()
    v0 = torch.clamp(torch.floor(v), 0, H - 2).long()
    return u0, v0, (u - u0)[..., None], (v - v0)[..., None]


def bilinear_sample(feat: Tensor, uv: Tensor) -> Tensor:
    """Sample [H, W, C] features at [..., 2] pixel coords (u along W);
    the coordinate is clamped to the border before interpolating."""
    H, W, C = feat.shape
    shape = uv.shape[:-1]
    u0, v0, du, dv = _corners(uv.reshape(-1, 2), H, W)
    flat = feat.reshape(H * W, C)
    base = v0 * W + u0
    c00, c01 = flat[base], flat[base + 1]
    c10, c11 = flat[base + W], flat[base + W + 1]
    if C >= 32:
        top = c00 * (1 - du) + c01 * du
        bot = c10 * (1 - du) + c11 * du
        out = top * (1 - dv) + bot * dv
    else:
        # same blend order as the reference's small-C path
        out = (c00 * (1 - du) * (1 - dv) + c01 * du * (1 - dv)
               + c10 * (1 - du) * dv + c11 * du * dv)
    return out.reshape(shape + (C,))


def bilinear_sample_views(feats: Tensor, uv: Tensor) -> Tensor:
    """bilinear_sample per view: feats [V, H, W, C], uv [V, ..., 2]."""
    return torch.stack([bilinear_sample(f, p) for f, p in zip(feats, uv)])


class _SampleMapGrad(torch.autograd.Function):
    """bilinear_sample whose feature-map gradient is built as the JAX
    package's `bilinear_sample_mm_grad` builds it: each point's four corner
    weights in the cotangent's dtype (rounded step by step below f32), the
    weighted cotangents summed in f32, the sum cast to the map's dtype. The
    sample locations get no gradient."""

    @staticmethod
    def forward(ctx, feat: Tensor, uv: Tensor) -> Tensor:
        ctx.save_for_backward(uv)
        ctx.fshape, ctx.fdtype = feat.shape, feat.dtype
        return bilinear_sample(feat, uv)

    @staticmethod
    def backward(ctx, gy: Tensor):
        uv, = ctx.saved_tensors
        H, W, C = ctx.fshape
        u0, v0, du, dv = _corners(uv.reshape(-1, 2), H, W)
        du, dv = du[:, 0].to(gy.dtype), dv[:, 0].to(gy.dtype)
        base = v0 * W + u0
        g = gy.reshape(-1, C).float()
        acc = torch.zeros(H * W, C, dtype=torch.float32, device=gy.device)
        for off, w in ((0, (1 - du) * (1 - dv)), (1, du * (1 - dv)),
                       (W, (1 - du) * dv), (W + 1, du * dv)):
            acc.index_add_(0, base + off, w.float()[:, None] * g)
        return acc.reshape(H, W, C).to(ctx.fdtype), None


def bilinear_sample_views_map_grad(feats: Tensor, uv: Tensor) -> Tensor:
    """bilinear_sample_views for the scene-context build (the JAX package's
    bilinear_sample_mm_grad): the maps' gradient as _SampleMapGrad computes
    it, none for uv."""
    return torch.stack([_SampleMapGrad.apply(f, p.detach()) for f, p in zip(feats, uv)])


def pack_bilinear_corners(feats: Tensor) -> Tensor:
    """[V, H, W, C] -> [V*H*W, 4C]; row (v, y, x) holds the 2x2 block
    [f[y,x] | f[y,x+1] | f[y+1,x] | f[y+1,x+1]] (wraparound rows are never
    addressed: sample corners clamp to size-2)."""
    V, H, W, C = feats.shape
    packed = torch.cat([feats,
                        torch.roll(feats, -1, dims=2),
                        torch.roll(feats, -1, dims=1),
                        torch.roll(feats, (-1, -1), dims=(1, 2))], dim=-1)
    return packed.reshape(V * H * W, 4 * C)


def pack_window(feats: Tensor, offsets) -> Tensor:
    """[V, H, W, C] -> [V*H*W, len(offsets)*C]; row (v, y, x) holds
    f[y+dy, x+dx] for each (dx, dy) in `offsets` (wraparound rows are never
    addressed when callers clip the window centre to the interior)."""
    V, H, W, C = feats.shape
    packed = torch.cat([torch.roll(feats, (-dy, -dx), dims=(1, 2))
                        for dx, dy in offsets], dim=-1)
    return packed.reshape(V * H * W, len(offsets) * C)


def packed_bilinear_sample_views(packed: Tensor, H: int, W: int,
                                 uv: Tensor) -> Tensor:
    """Sample a pack_bilinear_corners table at [V, N, 2] pixel coords;
    border/align-corners semantics as bilinear_sample. Returns [V, N, C] in
    the table's dtype: a bf16 table is blended with f32 weights in f32 and
    the result rounded to bf16, as the JAX package does."""
    V, N = uv.shape[0], uv.shape[1]
    C = packed.shape[-1] // 4
    u0, v0, du, dv = _corners(uv, H, W)
    base = torch.arange(V, device=uv.device)[:, None] * (H * W)
    g = packed[(base + v0 * W + u0).reshape(-1)]              # [V*N, 4C]
    du = du.reshape(-1, 1)
    dv = dv.reshape(-1, 1)
    top = g[:, :C] * (1 - du) + g[:, C:2 * C] * du
    bot = g[:, 2 * C:3 * C] * (1 - du) + g[:, 3 * C:] * du
    return (top * (1 - dv) + bot * dv).to(packed.dtype).reshape(V, N, C)


def nearest_indices(n_in: int, n_out: int, device=None) -> Tensor:
    """Source index of each output sample of a half-pixel-centred nearest
    resize: floor((i + 0.5) * n_in / n_out) (jax.image.resize 'nearest';
    torch's plain 'nearest' picks floor(i * n_in / n_out) instead)."""
    i = torch.arange(n_out, dtype=torch.float64, device=device)
    idx = torch.floor((i + 0.5) * (n_in / n_out)).long()
    return torch.clamp(idx, 0, n_in - 1)


def resize_nearest(img: Tensor, H: int, W: int) -> Tensor:
    """Nearest resize of the two leading spatial axes of [h, w, ...]."""
    yi = nearest_indices(img.shape[0], H, img.device)
    xi = nearest_indices(img.shape[1], W, img.device)
    return img[yi][:, xi]
