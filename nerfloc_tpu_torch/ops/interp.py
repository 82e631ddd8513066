"""Bilinear sampling and resizing on NHWC maps (counterpart of
nerfloc_tpu/ops/interp.py: `bilinear_sample` in border mode,
`resize_nearest`, `pack_bilinear_corners`, `pack_window`,
`packed_bilinear_sample_views`, `QuantTable`,
`quantize_pack_bilinear_corners`, `packed_bilinear_sample_selected`,
`pack_render_table`, `sample_render_table`; `resize_bilinear_aa`, the
antialiased bilinear resize of jax.image.resize).

Pixel coordinates reference pixel centres: uv=(0,0) reads feat[0,0]
exactly (grid_sample align_corners=True semantics). These are plain PyTorch
gathers; the JAX package runs them as XLA ops, not Pallas kernels.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

Tensor = torch.Tensor


@dataclass(frozen=True)
class QuantTable:
    """A pack_bilinear_corners table stored as symmetric per-channel int8
    (render.table_dtype='int8'): the blend runs on the int8 values in f32
    and is scaled once by scale[c], then cast to out_dtype."""
    q: Tensor                 # [rows, 4C] int8
    scale: Tensor             # [C] f32, amax / 127
    out_dtype: torch.dtype = torch.bfloat16


def quantize_pack_bilinear_corners(feats: Tensor, out_dtype=torch.bfloat16,
                                   eps: float = 1e-12) -> QuantTable:
    """[V, H, W, C] -> QuantTable of the pack_bilinear_corners layout:
    scale[c] = max(amax_c, eps) / 127, q = clip(round(f / scale), +-127).
    Rounding has no gradient (no straight-through estimator, as in the JAX
    package; only the scale carries one, through each channel's amax): an
    int8 table is for inference."""
    f32 = feats.float()
    amax = torch.amax(torch.abs(f32), dim=(0, 1, 2))
    # times the f32 reciprocal, as XLA rewrites the JAX package's / 127
    scale = torch.clamp(amax, min=eps) * (1.0 / 127.0)
    q = torch.clamp(torch.round(f32 / scale), -127, 127).to(torch.int8)
    return QuantTable(pack_bilinear_corners(q), scale, out_dtype)


def _blend_rows(g: Tensor, du: Tensor, dv: Tensor, C: int) -> Tensor:
    """The bilinear blend of gathered 4-corner rows [n, 4C] with f32
    weights du, dv [n, 1]."""
    top = g[:, :C] * (1 - du) + g[:, C:2 * C] * du
    bot = g[:, 2 * C:3 * C] * (1 - du) + g[:, 3 * C:] * du
    return top * (1 - dv) + bot * dv


def _gather_blend(packed, rows: Tensor, du: Tensor, dv: Tensor) -> Tensor:
    """Rows of a 4-corner table (a tensor or a QuantTable) blended -> [n, C]
    in the table's dtype (a QuantTable: dequantized, then out_dtype)."""
    if isinstance(packed, QuantTable):
        C = packed.q.shape[-1] // 4
        out = _blend_rows(packed.q[rows].float(), du, dv, C)
        return (out * packed.scale[None, :]).to(packed.out_dtype)
    C = packed.shape[-1] // 4
    return _blend_rows(packed[rows], du, dv, C).to(packed.dtype)


def _corners(uv: Tensor, H: int, W: int):
    """Border-clamped top-left corner (u0, v0) and fractions (du, dv)."""
    u = torch.clamp(uv[..., 0], 0.0, W - 1)
    v = torch.clamp(uv[..., 1], 0.0, H - 1)
    u0 = torch.clamp(torch.floor(u), 0, W - 2).long()
    v0 = torch.clamp(torch.floor(v), 0, H - 2).long()
    return u0, v0, (u - u0)[..., None], (v - v0)[..., None]


def _view_corners(uv: Tensor, H: int, W: int):
    """Top-left corner rows of uv [V, ..., 2] in a [V*H*W] table of V
    [H, W] maps (view v's rows start at v*H*W), and the fractions du, dv
    [n, 1], n = the points of all views."""
    V = uv.shape[0]
    u0, v0, du, dv = _corners(uv.reshape(V, -1, 2), H, W)
    rows = torch.arange(V, device=uv.device)[:, None] * (H * W) + v0 * W + u0
    return rows.reshape(-1), du.reshape(-1, 1), dv.reshape(-1, 1)


def bilinear_sample_views(feats: Tensor, uv: Tensor) -> Tensor:
    """Sample [V, H, W, C] features at [V, ..., 2] pixel coords of each
    view (u along W), all views at once -> [V, ..., C]; the coordinate is
    clamped to the border before interpolating."""
    V, H, W, C = feats.shape
    rows, du, dv = _view_corners(uv, H, W)
    flat = feats.reshape(V * H * W, C)
    c00, c01 = flat[rows], flat[rows + 1]
    c10, c11 = flat[rows + W], flat[rows + W + 1]
    if C >= 32:
        top = c00 * (1 - du) + c01 * du
        bot = c10 * (1 - du) + c11 * du
        out = top * (1 - dv) + bot * dv
    else:
        # same blend order as the reference's small-C path
        out = (c00 * (1 - du) * (1 - dv) + c01 * du * (1 - dv)
               + c10 * (1 - du) * dv + c11 * du * dv)
    return out.reshape(uv.shape[:-1] + (C,))


def bilinear_sample(feat: Tensor, uv: Tensor) -> Tensor:
    """Sample [H, W, C] features at [..., 2] pixel coords (u along W)."""
    return bilinear_sample_views(feat[None], uv[None])[0]


class _SampleViewsMapGrad(torch.autograd.Function):
    """bilinear_sample_views whose feature-map gradient is built as the JAX
    package's `bilinear_sample_mm_grad` builds it: each point's four corner
    weights in the cotangent's dtype (rounded step by step below f32), the
    weighted cotangents of all views summed in one f32 table, the sum cast
    to the maps' dtype. The sample locations get no gradient."""

    @staticmethod
    def forward(ctx, feats: Tensor, uv: Tensor) -> Tensor:
        ctx.save_for_backward(uv)
        ctx.fshape, ctx.fdtype = feats.shape, feats.dtype
        return bilinear_sample_views(feats, uv)

    @staticmethod
    def backward(ctx, gy: Tensor):
        uv, = ctx.saved_tensors
        V, H, W, C = ctx.fshape
        rows, du, dv = _view_corners(uv, H, W)
        du, dv = du[:, 0].to(gy.dtype), dv[:, 0].to(gy.dtype)
        g = gy.reshape(-1, C).float()
        acc = torch.zeros(V * H * W, C, dtype=torch.float32, device=gy.device)
        for off, w in ((0, (1 - du) * (1 - dv)), (1, du * (1 - dv)),
                       (W, (1 - du) * dv), (W + 1, du * dv)):
            acc.index_add_(0, rows + off, w.float()[:, None] * g)
        return acc.reshape(V, H, W, C).to(ctx.fdtype), None


def bilinear_sample_views_map_grad(feats: Tensor, uv: Tensor) -> Tensor:
    """bilinear_sample_views for the scene-context build (the JAX package's
    bilinear_sample_mm_grad): the maps' gradient as _SampleViewsMapGrad
    computes it, none for uv."""
    return _SampleViewsMapGrad.apply(feats, uv.detach())


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


def packed_bilinear_sample_views(packed, H: int, W: int, uv: Tensor) -> Tensor:
    """Sample a pack_bilinear_corners table (or a QuantTable) at [V, N, 2]
    pixel coords; border/align-corners semantics as bilinear_sample.
    Returns [V, N, C] in the table's dtype: a bf16 table is blended with f32
    weights in f32 and the result rounded to bf16, as the JAX package does."""
    V, N = uv.shape[0], uv.shape[1]
    out = _gather_blend(packed, *_view_corners(uv, H, W))
    return out.reshape(V, N, -1)


def packed_bilinear_sample_selected(packed, H: int, W: int, uv: Tensor,
                                    view_idx: Tensor) -> Tensor:
    """packed_bilinear_sample_views at per-sample selected views: uv
    [N, k, 2] pixel coords in views view_idx [N, k] -> [N, k, C]."""
    N, k = uv.shape[0], uv.shape[1]
    u0, v0, du, dv = _corners(uv, H, W)
    out = _gather_blend(packed, (view_idx * (H * W) + v0 * W + u0).reshape(-1),
                        du.reshape(-1, 1), dv.reshape(-1, 1))
    return out.reshape(N, k, -1)


# 5x5 candidate window of the merged render table, relative to the
# bilinear floor cell of the sample's projection: the nearest featmap cell
# n = round(u / stride) lies in [a, a + 2] of the floor cell a, so this
# window holds knn_proj's 3x3 window around n at every pixel
RENDER_WINDOW = tuple((dx, dy) for dy in range(-1, 4) for dx in range(-1, 4))
RENDER_WINDOW_PAD = 2    # zero ring around each view's cells
_NW = len(RENDER_WINDOW)
_WCOLS = _NW * 10


def pack_render_table(fused: Tensor, xyz10: Tensor) -> Tensor:
    """The merged render table: one row per cell of each view's featmap
    padded by a RENDER_WINDOW_PAD ring, holding [the bilinear corners of
    fused (4 Cf) | the RENDER_WINDOW cells of xyz10, channel-major
    (x_hi(25) y_hi z_hi x_mid y_mid z_mid x_lo y_lo z_lo mask(25))].

    fused [V, hf, wf, Cf] (featmaps | vis featmaps), xyz10 [V, hf, wf, 10]
    (xyz_window_channels) -> [V (hf+2p)(wf+2p), 4 Cf + 250] in fused's
    dtype. Ring rows are addressed only by window offsets; their zero mask
    marks them invalid."""
    p = RENDER_WINDOW_PAD
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, p, p, p, p))  # noqa: E731
    corners = pack_window(pad(fused), ((0, 0), (1, 0), (0, 1), (1, 1)))
    window = pack_window(pad(xyz10), RENDER_WINDOW)
    window = window.reshape(-1, _NW, 10).transpose(1, 2).reshape(-1, _WCOLS)
    return torch.cat([corners, window.to(corners.dtype)], dim=-1)


def sample_render_table(table: Tensor, Cf: int, Hs: int, Ws: int, hf: int, wf: int,
                        uv: Tensor):
    """One row per (view, sample) of a pack_render_table at full-res pixel
    coords uv [V, N, 2] -> (fused [V, N, Cf] in the table's dtype,
    cand_x, cand_y, cand_z [V, N, 25] f32 (hi + mid + lo), cand_valid
    [V, N, 25] bool, cand_idx [V, N, 25] flat indices into the [V hf wf]
    points, clipped at the borders)."""
    V, N = uv.shape[0], uv.shape[1]
    dev = uv.device
    p = RENDER_WINDOW_PAD
    hp, wp = hf + 2 * p, wf + 2 * p
    uf = torch.clamp(uv[..., 0], 0.0, Ws - 1) * ((wf - 1.0) / (Ws - 1.0))
    vf = torch.clamp(uv[..., 1], 0.0, Hs - 1) * ((hf - 1.0) / (Hs - 1.0))
    u0 = torch.clamp(torch.floor(uf), 0, wf - 2).long()
    v0 = torch.clamp(torch.floor(vf), 0, hf - 2).long()
    base_p = torch.arange(V, device=dev)[:, None] * (hp * wp)
    g = table[(base_p + (v0 + p) * wp + (u0 + p)).reshape(-1)]           # [V*N, CH]
    du = (uf - u0).reshape(-1, 1).float()
    dv = (vf - v0).reshape(-1, 1).float()
    fused = _blend_rows(g[:, :4 * Cf], du, dv, Cf).to(table.dtype).reshape(V, N, Cf)

    def plane(k):
        s = 4 * Cf + k * _NW
        return g[:, s:s + _NW].float().reshape(V, N, _NW)
    cand_x = plane(0) + plane(3) + plane(6)
    cand_y = plane(1) + plane(4) + plane(7)
    cand_z = plane(2) + plane(5) + plane(8)
    cand_valid = plane(9) > 0.5
    dxs = torch.tensor([o[0] for o in RENDER_WINDOW], device=dev)
    dys = torch.tensor([o[1] for o in RENDER_WINDOW], device=dev)
    cy = torch.clamp(v0[:, :, None] + dys, 0, hf - 1)
    cx = torch.clamp(u0[:, :, None] + dxs, 0, wf - 1)
    base_o = torch.arange(V, device=dev)[:, None, None] * (hf * wf)
    return fused, cand_x, cand_y, cand_z, cand_valid, base_o + cy * wf + cx


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


def resize_weights(n_in: int, n_out: int, device=None) -> Tensor:
    """[n_in, n_out] f32 weights of jax.image.resize(method='bilinear')
    along one axis (jax.image.scale_and_translate with the triangle kernel,
    antialiased: when shrinking, the kernel widens by n_in / n_out). Output
    sample j sits at (j + 0.5) n_in / n_out - 0.5 in input pixels; each
    column is normalised to sum 1, samples outside the input get 0."""
    f32 = torch.float32
    inv_scale = 1.0 / (n_out / n_in)      # in double, rounded where applied
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (torch.arange(n_out, dtype=f32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = torch.clamp(1 - torch.abs(x), min=0)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(torch.finfo(f32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def resize_bilinear_aa(x: Tensor, h: int, w: int) -> Tensor:
    """[V, H, W, C] -> [V, h, w, C], jax.image.resize(..., method='bilinear')
    with its default antialiasing: one weighted sum per resized axis (rows,
    then columns), the weights cast to x's dtype."""
    H, W = x.shape[1:3]
    if H != h:
        x = torch.einsum("vhwc,hH->vHwc", x, resize_weights(H, h, x.device).to(x.dtype))
    if W != w:
        x = torch.einsum("vhwc,wW->vhWc", x, resize_weights(W, w, x.device).to(x.dtype))
    return x
