"""The scene context's per-view work runs once for all support views.

The batched samplers (`ops/interp.bilinear_sample_views` and its map-grad
form), `neuray.cross_view_diff_feats` and `ConditionalNeRF._backproject_level`
against their plain per-view loops (the port's formulation before the view
axis became a batch dimension, copied below), on the CPU without JAX: the
same per-element arithmetic gives the same bits, the 3x3 products included
(one product for all views, summed as the per-view ones are at these
sizes: an FMA chain over k); the map gradient's summed contributions agree
to f32 round-off. Then the number of aten ops that `build_context` and
`query_coarse` dispatch does not grow with the number of views.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from nerfloc_tpu_torch.configs import Config, MatchingConfig, RenderConfig
from nerfloc_tpu_torch.data import device_batch, make_query_batch
from nerfloc_tpu_torch.geometry.cameras import camera_project, world_to_camera
from nerfloc_tpu_torch.models.fields.aggregator import SupportViews
from nerfloc_tpu_torch.models.fields.conditional_nerf import ConditionalNeRF
from nerfloc_tpu_torch.models.fields.neuray import (cross_view_diff_feats,
                                                    from_inverse_normalized_depth)
from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
from nerfloc_tpu_torch.ops.interp import (bilinear_sample_views,
                                          bilinear_sample_views_map_grad, resize_nearest)

# -- the plain per-view versions -------------------------------------------


def plain_bilinear_sample(feat, uv):
    H, W, C = feat.shape
    shape = uv.shape[:-1]
    uv = uv.reshape(-1, 2)
    u = torch.clamp(uv[..., 0], 0.0, W - 1)
    v = torch.clamp(uv[..., 1], 0.0, H - 1)
    u0 = torch.clamp(torch.floor(u), 0, W - 2).long()
    v0 = torch.clamp(torch.floor(v), 0, H - 2).long()
    du, dv = (u - u0)[..., None], (v - v0)[..., None]
    flat = feat.reshape(H * W, C)
    base = v0 * W + u0
    c00, c01 = flat[base], flat[base + 1]
    c10, c11 = flat[base + W], flat[base + W + 1]
    if C >= 32:
        out = (c00 * (1 - du) + c01 * du) * (1 - dv) + (c10 * (1 - du) + c11 * du) * dv
    else:
        out = (c00 * (1 - du) * (1 - dv) + c01 * du * (1 - dv)
               + c10 * (1 - du) * dv + c11 * du * dv)
    return out.reshape(shape + (C,))


def plain_sample_views(feats, uv):
    return torch.stack([plain_bilinear_sample(f, p) for f, p in zip(feats, uv)])


class PlainSampleMapGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, uv):
        ctx.save_for_backward(uv)
        ctx.fshape, ctx.fdtype = feat.shape, feat.dtype
        return plain_bilinear_sample(feat, uv)

    @staticmethod
    def backward(ctx, gy):
        uv, = ctx.saved_tensors
        H, W, C = ctx.fshape
        uv = uv.reshape(-1, 2)
        u = torch.clamp(uv[..., 0], 0.0, W - 1)
        v = torch.clamp(uv[..., 1], 0.0, H - 1)
        u0 = torch.clamp(torch.floor(u), 0, W - 2).long()
        v0 = torch.clamp(torch.floor(v), 0, H - 2).long()
        du, dv = (u - u0).to(gy.dtype), (v - v0).to(gy.dtype)
        base = v0 * W + u0
        g = gy.reshape(-1, C).float()
        acc = torch.zeros(H * W, C, dtype=torch.float32)
        for off, w in ((0, (1 - du) * (1 - dv)), (1, du * (1 - dv)),
                       (W, (1 - du) * dv), (W + 1, du * dv)):
            acc.index_add_(0, base + off, w.float()[:, None] * g)
        return acc.reshape(H, W, C).to(ctx.fdtype), None


def plain_sample_views_map_grad(feats, uv):
    return torch.stack([PlainSampleMapGrad.apply(f, p.detach()) for f, p in zip(feats, uv)])


def plain_backproject_depth(depth, K, c2w):
    H, W = depth.shape
    u = torch.arange(W, dtype=depth.dtype)
    v = torch.arange(H, dtype=depth.dtype)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    x = (uu - K[0, 2]) / K[0, 0]
    y = (vv - K[1, 2]) / K[1, 1]
    pts_cam = torch.stack([x * depth, y * depth, depth], dim=-1)
    return pts_cam @ c2w[:3, :3].transpose(-1, -2) + c2w[:3, 3]


def plain_cross_view_diff_feats(images, d_norm, Ks, c2ws, near, far):
    V, H, W = d_norm.shape
    depth = from_inverse_normalized_depth(torch.clamp(d_norm, 0.0, 1.0), near, far)
    pts = torch.stack([plain_backproject_depth(d, K, T)
                       for d, K, T in zip(depth, Ks, c2ws)]).reshape(V * H * W, 3)
    rgb_self = images.reshape(V * H * W, 3)
    inv_range = 1.0 / ((-1.0 / far) - (-1.0 / near))
    rgb_d, dpt_d, valid = [], [], []
    for img_u, depth_u, K_u, T_u in zip(images, depth, Ks, c2ws):
        u, v, z = camera_project(world_to_camera(T_u, pts), K_u)
        uv = torch.stack([u, v], dim=-1)
        ok = ((torch.abs(z) >= 1e-4) & (u >= -0.5) & (u < W - 0.5)
              & (v >= -0.5) & (v < H - 0.5))
        rgb_s = plain_bilinear_sample(img_u, uv)
        dpt_s = plain_bilinear_sample(depth_u[..., None], uv)[..., 0]
        rgb_d.append(torch.abs(rgb_s - rgb_self))
        dd = torch.abs(-1.0 / torch.clamp(dpt_s, min=1e-5) + 1.0 / torch.clamp(z, min=1e-5))
        dpt_d.append(torch.clamp(torch.abs(dd * inv_range), max=1.5))
        valid.append(ok.to(images.dtype))
    rgb_d, dpt_d, valid = torch.stack(rgb_d), torch.stack(dpt_d), torch.stack(valid)
    wsum = torch.clamp(valid.sum(0), min=1e-4)
    rgb_mean = (rgb_d * valid[..., None]).sum(0) / wsum[..., None]
    rgb_var = ((rgb_d - rgb_mean) ** 2 * valid[..., None]).sum(0) / wsum[..., None]
    dpt_mean = (dpt_d * valid).sum(0) / wsum
    dpt_var = ((dpt_d - dpt_mean) ** 2 * valid).sum(0) / wsum
    out = torch.cat([rgb_mean, rgb_var, dpt_mean[..., None], dpt_var[..., None]], -1)
    return out.reshape(V, H, W, 8)


def plain_backproject_level(dtype, sv, featmaps, stride):
    V, H, Wd = sv.depths.shape
    h, w = H // stride, Wd // stride
    pts, desc, dirs, masks = [], [], [], []
    scale = torch.tensor([1.0 / stride, 1.0 / stride, 1.0])
    for img, depth, K, c2w, feat in zip(sv.images, sv.depths, sv.Ks, sv.poses, featmaps):
        Ks = K * scale[:, None]
        d = resize_nearest(depth, h, w)
        im = resize_nearest(img, h, w)
        x = (torch.arange(w, dtype=d.dtype) - Ks[0, 2]) / Ks[0, 0]
        y = (torch.arange(h, dtype=d.dtype) - Ks[1, 2]) / Ks[1, 1]
        yy, xx = torch.meshgrid(y, x, indexing="ij")
        rays_d = torch.stack([xx, yy, torch.ones_like(xx)], dim=-1) @ c2w[:3, :3].T
        rays_d = rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
        pts_cam = torch.stack([xx * d, yy * d, d], dim=-1)
        pts.append((pts_cam @ c2w[:3, :3].T + c2w[:3, 3]).reshape(-1, 3))
        desc.append(torch.cat([im.to(dtype), feat.to(dtype)], dim=-1).reshape(h * w, -1))
        dirs.append(torch.cat([rays_d, d[..., None]], dim=-1).reshape(-1, 4))
        masks.append((d > 0).reshape(-1))
    pts_w = torch.cat(pts)
    return {"xyz": pts_w, "xyz_ndc": world_to_camera(sv.poses[0], pts_w),
            "feature": torch.cat(desc), "direction": torch.cat(dirs), "mask": torch.cat(masks)}


# -- data --------------------------------------------------------------------


def _poses(g, V):
    """V camera-to-world poses looking at the origin's neighbourhood."""
    q, _ = torch.linalg.qr(torch.randn(V, 3, 3, generator=g, dtype=torch.float64))
    q = q * torch.sign(torch.linalg.det(q))[:, None, None]
    T = torch.eye(4, dtype=torch.float64).repeat(V, 1, 1)
    T[:, :3, :3] = q
    T[:, :3, 3] = -3.0 * q[:, :, 2] + 0.3 * torch.randn(V, 3, generator=g, dtype=torch.float64)
    return T.float()


def _intrinsics(V, H, W):
    K = torch.zeros(V, 3, 3)
    K[:, 0, 0] = 0.9 * W + torch.arange(V)
    K[:, 1, 1] = 0.9 * W - torch.arange(V)
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = (W - 1) / 2, (H - 1) / 2, 1.0
    return K


def _uv(g, V, N, H, W):
    """Points inside, on the border of and outside every view."""
    uv = torch.rand(V, N, 2, generator=g) * torch.tensor([W + 6.0, H + 6.0]) - 3.0
    uv[:, :4] = torch.tensor([[0.0, 0.0], [W - 1.0, H - 1.0], [-7.5, H + 4.0], [W + 9.0, -2.0]])
    return uv


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b), (a - b).abs().max()


def _roundoff(a, b):
    """Within the round-off of a's dtype, relative to the larger magnitude."""
    assert a.dtype == b.dtype and a.shape == b.shape
    eps = torch.finfo(a.dtype).eps
    a, b = a.double(), b.double()
    tol = 4 * eps * max(b.abs().max().item(), 1.0)
    assert (a - b).abs().max().item() <= tol, ((a - b).abs().max().item(), tol)


# -- the equality test ---------------------------------------------------------

F32, BF16 = torch.float32, torch.bfloat16
CASES = {"sample_c5": ("sample", 5, F32), "sample_c40_bf16": ("sample", 40, BF16),
         "map_grad_c7": ("map_grad", 7, F32), "map_grad_c40_bf16": ("map_grad", 40, BF16),
         "cross_view": ("cross_view", 3, F32),
         "backproject_s2": ("backproject", 2, F32),
         "backproject_s3_bf16": ("backproject", 3, BF16)}


@pytest.mark.parametrize("V", [1, 3, 5])
@pytest.mark.parametrize("case", list(CASES))
def test_batched_views_equal_the_per_view_loop(case, V):
    """Odd map sizes (7x9), channels below and above 32, points on the
    border of and outside every view, depth holes; stride is the
    backprojection's (2, and 3 whose 1 / stride is rounded)."""
    kind, n, dtype = CASES[case]
    g = torch.Generator().manual_seed(100 * V + list(CASES).index(case))
    H, W = 7, 9
    if kind in ("sample", "map_grad"):
        feats = torch.randn(V, H, W, n, generator=g).to(dtype)
        uv = _uv(g, V, 37, H, W)
        if kind == "sample":
            _equal(bilinear_sample_views(feats, uv), plain_sample_views(feats, uv))
            _equal(bilinear_sample_views(feats, uv.reshape(V, 37, 1, 2)),
                   plain_sample_views(feats, uv.reshape(V, 37, 1, 2)))
            return
        cot = torch.randn(V, 37, n, generator=g)
        outs, grads = [], []
        for fn in (bilinear_sample_views_map_grad, plain_sample_views_map_grad):
            f = feats.clone().requires_grad_(True)
            out = fn(f, uv)
            grads.append(torch.autograd.grad(out, f, cot)[0])
            outs.append(out.detach())
        _equal(*outs)
        _roundoff(*grads)
        return
    Ks, poses = _intrinsics(V, H, W), _poses(g, V)
    if kind == "cross_view":
        images = torch.rand(V, H, W, 3, generator=g)
        d_norm = torch.rand(V, H, W, generator=g)
        d_norm[:, 0, 0] = 0.0                                # the far plane
        near, far = torch.tensor(1.0), torch.tensor(6.0)
        got = cross_view_diff_feats(images, d_norm, Ks, poses, near, far)
        _equal(got, plain_cross_view_diff_feats(images, d_norm, Ks, poses, near, far))
        return
    Hs, Ws = H * n, W * n
    depths = 2.0 + torch.rand(V, Hs, Ws, generator=g)
    depths[:, ::5, ::3] = 0.0                                # holes: masked points
    sv = SupportViews(images=torch.rand(V, Hs, Ws, 3, generator=g), depths=depths,
                      poses=poses, Ks=_intrinsics(V, Hs, Ws), vis_featmaps=None,
                      near=torch.tensor(1.0), far=torch.tensor(6.0))
    featmaps = torch.randn(V, H, W, 11, generator=g).to(dtype)
    got = ConditionalNeRF._backproject_level(SimpleNamespace(dtype=dtype), sv, featmaps, n)
    want = plain_backproject_level(dtype, sv, featmaps, n)
    for k in ("xyz", "xyz_ndc", "feature", "direction", "mask"):
        _equal(getattr(got, k), want[k])


# -- the mechanism: no op count that grows with the views -----------------------


class _OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched that are not views."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _context_ops(V: int) -> int:
    cfg = Config(backbone2d_fpn_dim=16, model_3d_hidden_dim=16, matcher_hidden_dim=24,
                 appearance_emb_dim=16, n_views_train=V, n_views_test=V,
                 render=RenderConfig(N_samples=8, N_rand=8, chunk=64, fused_query_agg=True),
                 matching=MatchingConfig(fine_num_3d_keypoints=8, coarse_num_3d_keypoints=8))
    model = NerfPoseEstimator(cfg, device="cpu", seed=0, dtype=torch.float32)
    batch = to_device_batch(device_batch(make_query_batch(n_views=V, H=32, W=32, seed=0)),
                            torch.device("cpu"))
    gumbel = torch.from_numpy(np.random.default_rng(0).gumbel(
        size=model.n_coarse_points(batch)).astype(np.float32))
    count = _OpCount()
    with torch.no_grad(), count:
        ctx, _ = model.build_context(batch)
        model.model_3d.query_coarse(ctx, gumbel)
    return count.n


def test_context_ops_do_not_grow_with_the_views():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        few, many = _context_ops(2), _context_ops(6)
    finally:
        torch.set_num_threads(threads)
    assert few > 100
    assert many == few, (few, many)
