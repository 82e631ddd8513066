"""2D feature backbone: ResNet50 (conv1..layer2) + FPN with InstanceNorm
(counterpart of nerfloc_tpu/models/backbone.py).

Public layout is NHWC as in the JAX package; convolutions run NCHW inside.
Submodule and parameter names follow the flax tree so weights.py maps
them 1:1 (FrozenBatchNorm statistics are buffers, the flax 'frozen'
collection). `dtype` is the compute dtype (models/lowp.py): the
convolutions, the frozen-BN affine (its scale and bias cast to the input's
dtype) and the FPN's instance norms run in it, so the maps come out in it.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.interp import nearest_indices
from .lowp import F32, conv as conv_in, normalize

Tensor = torch.Tensor

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
         bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias)


class FrozenBatchNorm(nn.Module):
    """y = x * w / sqrt(var + 1e-5) + (b - mean * scale), fixed statistics."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: Tensor) -> Tensor:              # NCHW
        scale = self.weight * torch.rsqrt(self.running_var + 1e-5)
        bias = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[:, None, None] + bias.to(x.dtype)[:, None, None]


class Bottleneck(nn.Module):
    """torchvision-style bottleneck (1x1 -> 3x3 (stride) -> 1x1, x4)."""

    def __init__(self, cin: int, planes: int, stride: int, downsample: bool,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = conv(cin, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = conv(planes, planes, 3, stride, 1)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm(planes * 4)
        if downsample:
            self.downsample_conv = conv(cin, planes * 4, 1, stride)
            self.downsample_bn = FrozenBatchNorm(planes * 4)
        self.downsample = downsample

    def forward(self, x: Tensor) -> Tensor:
        dt = self.dtype
        out = F.relu(self.bn1(conv_in(self.conv1, x, dt)))
        out = F.relu(self.bn2(conv_in(self.conv2, out, dt)))
        out = self.bn3(conv_in(self.conv3, out, dt))
        idt = self.downsample_bn(conv_in(self.downsample_conv, x, dt)) if self.downsample else x
        return F.relu(out + idt)


class ResNet50Trunk(nn.Module):
    def __init__(self, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = conv(3, 64, 7, 2, 3)
        self.bn1 = FrozenBatchNorm(64)
        for i in range(3):
            setattr(self, f"layer1_{i}", Bottleneck(64 if i == 0 else 256, 64, 1, i == 0,
                                                    dtype))
        for i in range(4):
            setattr(self, f"layer2_{i}", Bottleneck(256 if i == 0 else 512, 128,
                                                    2 if i == 0 else 1, i == 0, dtype))
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN)[:, None, None],
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD)[:, None, None],
                             persistent=False)

    def forward(self, x: Tensor) -> Dict[str, Tensor]:  # NCHW in [0, 1]
        x = (x - self.mean) / self.std
        conv1 = x = F.relu(self.bn1(conv_in(self.conv1, x, self.dtype)))
        x = F.max_pool2d(x, 3, 2, 1)
        for i in range(3):
            x = getattr(self, f"layer1_{i}")(x)
        layer1 = x
        for i in range(4):
            x = getattr(self, f"layer2_{i}")(x)
        return {"conv1": conv1, "layer1": layer1, "layer2": x}


def instance_norm(x: Tensor, eps: float = 1e-5) -> Tensor:
    """Per-sample, per-channel spatial normalization (population variance);
    below f32 the statistics are f32 sums rounded to x's dtype and the
    normalization runs in it."""
    return normalize(x, (-2, -1), eps)


class FPN(nn.Module):
    def __init__(self, out_channels: int, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.inner_layer1 = conv(256, out_channels, 1)
        self.inner_layer2 = conv(512, out_channels, 1)
        self.layer_layer1 = conv(out_channels, out_channels, 3, 1, 1)
        self.layer_layer2 = conv(out_channels, out_channels, 3, 1, 1)

    def forward(self, feats: Dict[str, Tensor]) -> Dict[str, Tensor]:
        dt = self.dtype
        lat1 = instance_norm(conv_in(self.inner_layer1, feats["layer1"], dt))
        top = instance_norm(conv_in(self.inner_layer2, feats["layer2"], dt))
        h, w = lat1.shape[-2:]
        yi = nearest_indices(top.shape[-2], h, top.device)
        xi = nearest_indices(top.shape[-1], w, top.device)
        up = top[:, :, yi][:, :, :, xi]
        return {"layer1": instance_norm(conv_in(self.layer_layer1, lat1 + up, dt)),
                "layer2": instance_norm(conv_in(self.layer_layer2, top, dt))}


class Backbone2D(nn.Module):
    """ResNet50 trunk + FPN: images [B, H, W, 3] in [0, 1] -> NHWC maps
    {'conv1' (s2, 64ch), 'layer1' (s4), 'layer2' (s8)}."""
    layer_to_stride = {"conv1": 2, "layer1": 4, "layer2": 8}

    def __init__(self, fpn_dim: int = 192, use_fpn: bool = True, dtype: torch.dtype = F32):
        super().__init__()
        self.trunk = ResNet50Trunk(dtype)
        self.use_fpn = use_fpn
        if use_fpn:
            self.fpn = FPN(fpn_dim, dtype)

    def forward(self, images: Tensor) -> Dict[str, Tensor]:
        feats = self.trunk(images.permute(0, 3, 1, 2))
        if self.use_fpn:
            feats = {**feats, **self.fpn(feats)}
        return {k: v.permute(0, 2, 3, 1).contiguous() for k, v in feats.items()}
