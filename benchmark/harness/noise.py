"""The noise a query or a step is handed, drawn from a seed on the device."""
from __future__ import annotations

import torch


def gumbel(shape, g: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)), U in [tiny, 1)."""
    u = torch.rand(shape, generator=g, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))


def distinct_pixels(H: int, W: int, n: int, g: torch.Generator, device) -> torch.Tensor:
    """n distinct flat pixel indices y * W + x."""
    return torch.randperm(H * W, generator=g, device=device)[:n]
