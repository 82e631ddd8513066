"""Grad-safe vector math (counterpart of nerfloc_tpu/geometry/math.py)."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def safe_norm(x: Tensor, dim: int = -1, keepdim: bool = False,
              eps: float = 1e-12) -> Tensor:
    """sqrt(sum(x^2) + eps): finite value and gradient everywhere."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


def safe_normalize(x: Tensor, dim: int = -1, eps: float = 1e-6) -> Tensor:
    """x / max(|x|, eps) with a grad-safe norm."""
    n = safe_norm(x, dim=dim, keepdim=True, eps=eps * eps)
    return x / torch.clamp(n, min=eps)


def safe_sqrt(x: Tensor, eps: float = 1e-12) -> Tensor:
    """sqrt with clamped operand (finite gradient at 0)."""
    return torch.sqrt(torch.clamp(x, min=eps))
