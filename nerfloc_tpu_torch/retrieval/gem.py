"""AP-GeM global descriptor, the 'dir' retrieval method (counterpart of
nerfloc_tpu/retrieval/gem.py): a ResNet101 trunk with frozen BatchNorm
statistics through layer4 (on the port's backbone Bottleneck), a
generalized-mean pool with a learnable exponent p (clipped to [1, 10],
pooled in f32), a 2048 -> out_dim projection and L2 normalization. PCA
whitening of the output is a host post-process (gem_weights.whiten_features).

Public layout is NHWC images in [0, 1]; names follow the flax tree
(trunk.conv1, trunk.bn1, trunk.layer<l>_<i>, p, whiten).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.backbone import IMAGENET_MEAN, IMAGENET_STD, Bottleneck, FrozenBatchNorm, conv
from .netvlad import l2_normalize

Tensor = torch.Tensor
RESNET101_BLOCKS = (3, 4, 23, 3)
RESNET50_BLOCKS = (3, 4, 6, 3)


class FullResNetTrunk(nn.Module):
    """conv1 .. layer4 of a bottleneck ResNet: NCHW -> [B, 2048, H/32, W/32]."""

    def __init__(self, blocks: Sequence[int] = RESNET101_BLOCKS):
        super().__init__()
        self.blocks = tuple(blocks)
        self.conv1 = conv(3, 64, 7, 2, 3)
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), self.blocks)):
            for i in range(n):
                stride = (1 if li == 0 else 2) if i == 0 else 1
                setattr(self, f"layer{li + 1}_{i}", Bottleneck(cin, planes, stride, i == 0))
                cin = planes * 4

    def forward(self, x: Tensor) -> Tensor:
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for li, n in enumerate(self.blocks):
            for i in range(n):
                x = getattr(self, f"layer{li + 1}_{i}")(x)
        return x


class GeMDescriptor(nn.Module):
    """images [B, H, W, 3] in [0, 1] -> L2-normalized descriptors [B, out_dim]."""

    def __init__(self, out_dim: int = 2048, p_init: float = 3.0,
                 blocks: Sequence[int] = RESNET101_BLOCKS,
                 mean: Tuple[float, ...] = IMAGENET_MEAN, std: Tuple[float, ...] = IMAGENET_STD):
        super().__init__()
        self.out_dim, self.blocks = out_dim, tuple(blocks)
        self.mean, self.std = tuple(mean), tuple(std)
        self.trunk = FullResNetTrunk(blocks)
        self.p = nn.Parameter(torch.tensor(float(p_init)))
        self.whiten = nn.Linear(2048, out_dim)

    def forward(self, images: Tensor) -> Tensor:
        mean = torch.tensor(self.mean, dtype=images.dtype, device=images.device)
        std = torch.tensor(self.std, dtype=images.dtype, device=images.device)
        x = self.trunk(((images - mean) / std).permute(0, 3, 1, 2).contiguous())
        p = torch.clamp(self.p, 1.0, 10.0)
        # the trunk ends in a ReLU: the clamp only guards the p-th root
        x = torch.clamp(x.float(), min=1e-6)
        pooled = torch.mean(x ** p, dim=(2, 3)) ** (1.0 / p)
        return l2_normalize(self.whiten(pooled))
