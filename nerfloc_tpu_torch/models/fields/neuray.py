"""NeuRay-style visibility: depth-fusion encoder + mixture-logistics decoder
(counterpart of nerfloc_tpu/models/fields/neuray.py).

Depth math runs in inverse-normalized depth
d_norm = (-1/d + 1/near) / (1/near - 1/far). Convolutions use reflect
padding (asymmetric for even kernels) and InstanceNorm with population
variance, as the reference does. Public layout is NHWC.

`dtype` is the compute dtype (models/lowp.py). In bf16 the convolutions
and decoder layers run in bf16; each instance norm takes f32 statistics of
its bf16 input and, with its f32 affine, returns f32, so the next
convolution rounds its input again; the ray features come out bf16. The
visibility math stays f32 (the decoder's outputs meet f32 depths).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...geometry.cameras import backproject_depth, camera_project
from ...ops.interp import bilinear_sample_views, resize_bilinear_aa
from ..lowp import F32, conv, dense, normalize, sigmoid, softplus

Tensor = torch.Tensor


def to_inverse_normalized_depth(depth: Tensor, near: Tensor, far: Tensor) -> Tensor:
    near_inv, far_inv = -1.0 / near, -1.0 / far
    d = -1.0 / torch.clamp(depth, min=1e-5)
    return torch.clamp((d - near_inv) / (far_inv - near_inv), 0.0, 1.0)


def inverse_normalize_unclamped(depth: Tensor, near: Tensor, far: Tensor) -> Tensor:
    near_inv, far_inv = -1.0 / near, -1.0 / far
    d = -1.0 / torch.clamp(depth, min=1e-5)
    return (d - near_inv) / (far_inv - near_inv)


def from_inverse_normalized_depth(d_norm: Tensor, near: Tensor, far: Tensor) -> Tensor:
    """clip(-1 / d_inv, near, far) with a finite gradient everywhere.

    d_inv is exactly 0 for one f32 value of d_norm (near 1 / (1 - near/far),
    which decoded means reach), and there the plain form's gradient is
    0 * inf = NaN. Where 1 / d_inv^2 would overflow, the reciprocal takes a
    stand-in operand and the value is the clip's: far just below zero, near
    at +0 and above. Values are the plain form's, NaN included."""
    near_inv, far_inv = -1.0 / near, -1.0 / far
    d_inv = d_norm * (far_inv - near_inv) + near_inv
    ok = ~(d_inv >= -1e-18)
    depth = -1.0 / torch.where(ok, d_inv, torch.full_like(d_inv, -1.0))
    depth = torch.where(ok, depth, torch.where(torch.signbit(d_inv), far, near))
    return torch.minimum(torch.maximum(depth, near), far)


def depth2inv_dists(depth: Tensor, near: Tensor, far: Tensor) -> Tensor:
    """Sample intervals in inverse-normalized depth along the last axis;
    the last interval is 1e6."""
    d = inverse_normalize_unclamped(depth, near, far)
    return torch.cat([d[..., 1:] - d[..., :-1],
                      torch.full_like(d[..., :1], 1e6)], dim=-1)


def _reflect_pad(x: Tensor, lo: int, hi: int) -> Tensor:
    return F.pad(x, (lo, hi, lo, hi), mode="reflect") if (lo or hi) else x


class RConv(nn.Module):
    """Reflect-padded VALID conv (NCHW inside); flax name `Conv_0`."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 bias: bool = False, dtype: torch.dtype = F32):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, kernel, stride=stride, bias=bias)
        self.pad = ((kernel - 1) // 2, kernel - 1 - (kernel - 1) // 2)
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        return conv(self.Conv_0, _reflect_pad(x, *self.pad), self.dtype)


class INorm(nn.Module):
    """InstanceNorm2d(affine=True) on NCHW, eps 1e-5, population variance."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: Tensor) -> Tensor:
        y = normalize(x, (-2, -1), 1e-5, f32_out=True)
        return y * self.scale[:, None, None] + self.bias[:, None, None]


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, downsample: bool,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.conv1 = RConv(cin, planes, 3, stride, dtype=dtype)
        self.bn1 = INorm(planes)
        self.conv2 = RConv(planes, planes, 3, 1, dtype=dtype)
        self.bn2 = INorm(planes)
        if downsample:
            self.ds_conv = RConv(cin, planes, 1, stride, dtype=dtype)
            self.ds_bn = INorm(planes)
        self.downsample = downsample

    def forward(self, x: Tensor) -> Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        idt = self.ds_bn(self.ds_conv(x)) if self.downsample else x
        return F.relu(out + idt)


class ConvIN(nn.Module):
    """conv (bias) + InstanceNorm + ELU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, dtype: torch.dtype = F32):
        super().__init__()
        self.conv = RConv(cin, cout, kernel, 1, bias=True, dtype=dtype)
        self.bn = INorm(cout)

    def forward(self, x: Tensor) -> Tensor:
        return F.elu(self.bn(self.conv(x)))


def _pad_or_crop_hw(x: Tensor, th: int, tw: int) -> Tensor:
    """Centered zero-pad (extra on the high side) or crop of NCHW to (th, tw)."""
    dh, dw = th - x.shape[-2], tw - x.shape[-1]
    if dh == 0 and dw == 0:
        return x
    lo_h, hi_h = dh // 2, dh - dh // 2
    lo_w, hi_w = dw // 2, dw - dw // 2
    return F.pad(x, (lo_w, hi_w, lo_h, hi_h))     # negative pads crop


class ResEncoder(nn.Module):
    """12-channel input -> 32-channel ray feats at 1/4 resolution (NCHW)."""

    def __init__(self, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(12, 32, 8, stride=2, bias=False)
        self.bn1 = INorm(32)
        for name, cin, planes in (("layer1", 32, 32), ("layer2", 32, 64),
                                  ("layer3", 64, 128)):
            setattr(self, f"{name}_0", BasicBlock(cin, planes, 2, True, dtype))
            setattr(self, f"{name}_1", BasicBlock(planes, planes, 1, False, dtype))
        self.upconv3 = ConvIN(128, 64, dtype=dtype)
        self.iconv3 = ConvIN(128, 64, dtype=dtype)
        self.upconv2 = ConvIN(64, 32, dtype=dtype)
        self.iconv2 = ConvIN(64, 32, dtype=dtype)
        self.out_conv = nn.Conv2d(32, 32, 1)

    def _layer(self, x: Tensor, name: str) -> Tensor:
        return getattr(self, f"{name}_1")(getattr(self, f"{name}_0")(x))

    @staticmethod
    def _up(x: Tensor, skip: Tensor, up: nn.Module) -> Tensor:
        x = up(F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True))
        return torch.cat([x, _pad_or_crop_hw(skip, x.shape[-2], x.shape[-1])], dim=1)

    def forward(self, x: Tensor) -> Tensor:
        x = F.relu(self.bn1(conv(self.conv1, _reflect_pad(x, 2, 2), self.dtype)))
        x1 = self._layer(x, "layer1")
        x2 = self._layer(x1, "layer2")
        x3 = self._layer(x2, "layer3")
        u3 = self.iconv3(self._up(x3, x2, self.upconv3))
        u2 = self.iconv2(self._up(u3, x1, self.upconv2))
        return conv(self.out_conv, u2, self.dtype)


class DepthFusionNet(nn.Module):
    """images [V,H,W,3], depths [V,H,W] -> ray feats [V, H/4, W/4, 32]."""

    def __init__(self, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.fuse_net = ResEncoder(dtype)
        self.depth_skip1 = nn.Conv2d(1, 8, 2, stride=2)
        self.depth_skip2 = nn.Conv2d(8, 16, 2, stride=2)
        self.conv_out = nn.Conv2d(48, 32, 1)

    def forward(self, images: Tensor, depths: Tensor, Ks: Tensor, c2ws: Tensor,
                near: Tensor, far: Tensor) -> Tensor:
        d_norm = to_inverse_normalized_depth(depths, near, far)[..., None]
        diff = cross_view_diff_feats(images, d_norm[..., 0], Ks, c2ws, near, far)
        x = torch.cat([images, d_norm, diff], dim=-1).permute(0, 3, 1, 2)
        feats = self.fuse_net(x)
        dt = self.dtype
        ds = conv(self.depth_skip2, F.relu(conv(self.depth_skip1, d_norm.permute(0, 3, 1, 2), dt)),
                  dt)
        if ds.shape[-2:] != feats.shape[-2:]:
            # sizes that halve to odd numbers leave the two branches a pixel
            # apart: the depth skip is resized to the encoder's size as
            # jax.image.resize(method='bilinear') resizes, antialiased
            ds = resize_bilinear_aa(ds.permute(0, 2, 3, 1), *feats.shape[-2:]).permute(0, 3, 1, 2)
        out = conv(self.conv_out, torch.cat([ds, feats], dim=1), dt)
        return out.permute(0, 2, 3, 1).contiguous()


def cross_view_diff_feats(images: Tensor, d_norm: Tensor, Ks: Tensor,
                          c2ws: Tensor, near: Tensor, far: Tensor) -> Tensor:
    """Masked mean/var over source views of |rgb_u - rgb_v| and the
    inverse-depth disagreement -> [V, H, W, 8]. The points of all V depth
    maps are projected into all V source views at once ([V, V*H*W] pairs)."""
    V, H, W = d_norm.shape
    depth = from_inverse_normalized_depth(torch.clamp(d_norm, 0.0, 1.0), near, far)
    pts = backproject_depth(depth, Ks, c2ws)[0].reshape(V * H * W, 3)
    rgb_self = images.reshape(V * H * W, 3)
    inv_range = 1.0 / ((-1.0 / far) - (-1.0 / near))
    u, v, z = camera_project((pts - c2ws[:, None, :3, 3]) @ c2ws[:, :3, :3], Ks)
    uv = torch.stack([u, v], dim=-1)
    ok = ((torch.abs(z) >= 1e-4) & (u >= -0.5) & (u < W - 0.5)
          & (v >= -0.5) & (v < H - 0.5))
    rgb_d = torch.abs(bilinear_sample_views(images, uv) - rgb_self)
    dpt_s = bilinear_sample_views(depth[..., None], uv)[..., 0]
    dd = torch.abs(-1.0 / torch.clamp(dpt_s, min=1e-5) + 1.0 / torch.clamp(z, min=1e-5))
    dpt_d = torch.clamp(torch.abs(dd * inv_range), max=1.5)
    valid = ok.to(images.dtype)
    wsum = torch.clamp(valid.sum(0), min=1e-4)
    rgb_mean = (rgb_d * valid[..., None]).sum(0) / wsum[..., None]
    rgb_var = ((rgb_d - rgb_mean) ** 2 * valid[..., None]).sum(0) / wsum[..., None]
    dpt_mean = (dpt_d * valid).sum(0) / wsum
    dpt_var = ((dpt_d - dpt_mean) ** 2 * valid).sum(0) / wsum
    out = torch.cat([rgb_mean, rgb_var, dpt_mean[..., None], dpt_var[..., None]], -1)
    return out.reshape(V, H, W, 8)


class _DecoderMLP(nn.Module):
    def __init__(self, out: int, dtype: torch.dtype = F32):
        super().__init__()
        self.fc1 = nn.Linear(32, 32)
        self.fc2 = nn.Linear(32, 32)
        self.fc3 = nn.Linear(32, out)
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        dt = self.dtype
        return dense(self.fc3, F.elu(dense(self.fc2, F.elu(dense(self.fc1, x, dt)), dt)), dt)


class MixtureLogisticsDistDecoder(nn.Module):
    """32-d ray feats -> (mean[2], var[2] (+0.05), vis[1], aw[1]).

    In bf16 the decoder layers run in bf16. mean, var and vis then meet
    f32 depths, so their last step (softplus, the +0.05, sigmoid) is taken
    in f32 and they are returned f32; aw enters the bf16 mixture weights
    [aw, 1 - aw] and stays bf16."""

    def __init__(self, bias_val: float = 0.05, dtype: torch.dtype = F32):
        super().__init__()
        self.mean_decoder = _DecoderMLP(2, dtype)
        self.var_decoder = _DecoderMLP(2, dtype)
        self.vis_decoder = _DecoderMLP(1, dtype)
        self.aw_decoder = _DecoderMLP(1, dtype)
        self.bias_val = bias_val

    def forward(self, feats: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        dt = self.mean_decoder.dtype
        if dt != F32:
            var = softplus(self.var_decoder(feats)).float()
            return (softplus(self.mean_decoder(feats), f32_out=True),
                    var + float(torch.tensor(self.bias_val, dtype=dt)),
                    sigmoid(self.vis_decoder(feats), f32_out=True),
                    sigmoid(self.aw_decoder(feats)))
        mean = F.softplus(self.mean_decoder(feats))
        var = F.softplus(self.var_decoder(feats)) + self.bias_val
        vis = torch.sigmoid(self.vis_decoder(feats))
        aw = torch.sigmoid(self.aw_decoder(feats))
        return mean, var, vis, aw

    def predict_mean(self, feats: Tensor) -> Tensor:
        return softplus(self.mean_decoder(feats))


def decode_ref_depths(mean: Tensor, near: Tensor, far: Tensor) -> Tensor:
    """First mixture mean -> metric depth; a bf16 mean meets the f32 near
    and far, so the decode runs in f32 (torch would keep a 0-d f32 tensor
    from promoting it)."""
    return from_inverse_normalized_depth(mean[..., 0].float(), near, far)


def compute_visibility(depth: Tensor, mean: Tensor, var: Tensor, vis: Tensor,
                       aw: Tensor, near: Tensor, far: Tensor) -> Tensor:
    """P(surface beyond `depth`) per view; depth [..., 1] metric."""
    d = inverse_normalize_unclamped(depth, near, far)
    mix = torch.cat([aw, 1.0 - aw], dim=-1)
    cdf0 = (0.5 + 0.5 * torch.tanh((d - mean) * var)) * vis
    return torch.sum((1.0 - cdf0) * mix, dim=-1)


def compute_alpha_prob(depth: Tensor, interval: Tensor, mean: Tensor, var: Tensor,
                       vis: Tensor, aw: Tensor, near: Tensor, far: Tensor,
                       eps: float = 1e-5):
    """(alpha logit, visibility, hit probability) along query rays.

    depth [..., dn] metric projected depths; interval [..., dn] sample
    intervals in inverse-normalized depth; mean/var [..., dn, 2];
    vis/aw [..., dn, 1]. Each sample spans half the interval on each side."""
    d = inverse_normalize_unclamped(torch.clamp(depth, min=1e-5), near, far)
    half = interval / 2.0
    half_ext = torch.cat([half[..., :1], half], dim=-1)
    near_b = d - half_ext[..., :-1]
    far_b = d + half_ext[..., 1:]
    mix = torch.cat([aw, 1.0 - aw], dim=-1)
    cdf0 = (0.5 + 0.5 * torch.tanh((near_b[..., None] - mean) * var)) * vis
    cdf1 = (0.5 + 0.5 * torch.tanh((far_b[..., None] - mean) * var)) * vis
    visibility = torch.sum((1.0 - cdf0) * mix, dim=-1)
    hit_prob = torch.sum((cdf1 - cdf0) * mix, dim=-1)
    alpha_logit = torch.log(hit_prob / (visibility - hit_prob + eps) + eps)
    return alpha_logit, visibility, hit_prob
