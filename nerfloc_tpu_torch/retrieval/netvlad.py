"""NetVLAD global image descriptor (counterpart of
nerfloc_tpu/retrieval/netvlad.py): VGG16 through conv5_3, soft-assignment
VLAD pooling over 64 clusters, PCA whitening to 4096.

Public layout is NHWC images in [0, 1] as in the JAX package; the
convolutions run NCHW inside. Submodule and parameter names follow the
flax tree (backbone.conv<i>, assign, centers, whiten), so
weights.load_flax_netvlad maps them 1:1.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512)
EPS = 1e-12


def l2_normalize(x: Tensor, dim: int = -1) -> Tensor:
    """x / (||x|| + 1e-12), the JAX package's epsilon-guarded norm."""
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + EPS)


class VGG16Conv(nn.Module):
    """VGG16 features through conv5_3 (no final pool), ReLU after every
    convolution but the last. `cfg`: channel widths and "M" pool markers."""

    def __init__(self, cfg: Sequence = VGG16_CFG):
        super().__init__()
        self.cfg = tuple(cfg)
        cin, i = 3, 0
        for c in self.cfg:
            if c != "M":
                setattr(self, f"conv{i}", nn.Conv2d(cin, c, 3, padding=1))
                cin, i = c, i + 1
        self.n_convs = i
        self.out_channels = cin

    def forward(self, x: Tensor) -> Tensor:                 # NCHW
        i = 0
        for c in self.cfg:
            if c == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = getattr(self, f"conv{i}")(x)
                i += 1
                if i < self.n_convs:
                    x = F.relu(x)
        return x


class NetVLAD(nn.Module):
    """images [B, H, W, 3] in [0, 1] -> L2-normalized descriptors
    [B, out_dim]. `input_scale` and `pixel_mean`: the preprocessing
    (x * input_scale clipped to [0, input_scale], minus the mean); the
    MatConvNet checkpoints take 0-255 pixels minus their average image."""

    def __init__(self, num_clusters: int = 64, out_dim: int = 4096, whiten: bool = True,
                 input_scale: float = 1.0, pixel_mean: Sequence[float] = (0.485, 0.456, 0.406),
                 vgg_cfg: Sequence = VGG16_CFG):
        super().__init__()
        self.num_clusters, self.out_dim = num_clusters, out_dim
        self.input_scale = float(input_scale)
        self.pixel_mean = tuple(float(m) for m in pixel_mean)
        self.vgg_cfg = tuple(vgg_cfg)
        self.backbone = VGG16Conv(vgg_cfg)
        C = self.backbone.out_channels
        self.assign = nn.Linear(C, num_clusters)
        self.centers = nn.Parameter(torch.randn(num_clusters, C) * 0.02)
        self.whiten = nn.Linear(num_clusters * C, out_dim) if whiten else None

    def forward(self, images: Tensor) -> Tensor:
        mean = torch.tensor(self.pixel_mean, dtype=images.dtype, device=images.device)
        x = torch.clamp(images * self.input_scale, 0.0, self.input_scale) - mean
        feat = self.backbone(x.permute(0, 3, 1, 2).contiguous())
        B, C = feat.shape[:2]
        feat = l2_normalize(feat.permute(0, 2, 3, 1).reshape(B, -1, C))   # [B, hw, C]
        assign = torch.softmax(self.assign(feat), dim=-1)                 # [B, hw, K]
        resid = feat[:, :, None, :] - self.centers[None, None]            # [B, hw, K, C]
        vlad = torch.sum(resid * assign[..., None], dim=1)                # [B, K, C]
        vlad = l2_normalize(l2_normalize(vlad).reshape(B, -1))
        if self.whiten is not None:
            vlad = l2_normalize(self.whiten(vlad))
        return vlad
