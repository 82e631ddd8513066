"""Appearance embedding + FiLM adaptation (counterpart of
nerfloc_tpu/models/appearance.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .lowp import F32, dense, leaky_relu

Tensor = torch.Tensor


def appearance_embedding(conv1_feats: Tensor) -> Tensor:
    """[B, H, W, C] conv1 features -> [B, 2C] mean || std (ddof=1); below
    f32 the mean and variance are f32 sums rounded to the features' dtype,
    and the square root is taken in it."""
    if conv1_feats.dtype == F32:
        mean = conv1_feats.mean(dim=(1, 2))
        std = conv1_feats.std(dim=(1, 2), unbiased=True)
    else:
        x = conv1_feats.float()
        mean = x.mean(dim=(1, 2)).to(conv1_feats.dtype)
        std = torch.sqrt(x.var(dim=(1, 2), unbiased=True).to(conv1_feats.dtype))
    return torch.cat([mean, std], dim=-1)


class AppearanceAdaptLayer(nn.Module):
    """y = a * x + b with (a, b) from an MLP on (target - source) embedding;
    the MLP runs in the compute dtype `dtype`."""

    def __init__(self, input_dim: int, is_rgb: bool = False, emb_dim: int = 128,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.fc1 = nn.Linear(emb_dim, 64)
        self.fc2 = nn.Linear(64, 64)
        self.fc3 = nn.Linear(64, input_dim * 2)
        self.is_rgb = is_rgb
        self.dtype = dtype

    def forward(self, x: Tensor, embedding: Tensor, target_embedding: Tensor) -> Tensor:
        """x [B, H, W, C]; embedding [B, E]; target_embedding [1, E]."""
        dt = self.dtype
        if dt == F32:
            h = F.leaky_relu(self.fc1(target_embedding - embedding), 0.01)
            h = F.leaky_relu(self.fc2(h), 0.01)
            code = self.fc3(h)
        else:
            h = leaky_relu(dense(self.fc1, target_embedding - embedding, dt))
            h = leaky_relu(dense(self.fc2, h, dt))
            code = dense(self.fc3, h, dt)
        a, b = torch.chunk(code, 2, dim=-1)
        y = a[:, None, None, :] * x + b[:, None, None, :]
        return torch.clamp(y, 0.0, 1.0) if self.is_rgb else y
