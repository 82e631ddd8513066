"""Positional encodings (counterpart of nerfloc_tpu/geometry/embedder.py).

- `Embedder`: NeRF frequency embedder, frequencies 2^0..2^(m-1), output
  [x (optional), sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...].
- `position_embedding_sine`: the normalized 2D lin-sine grid embedding.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


class Embedder:
    """NeRF frequency embedder; out_dim = in_dim * (include_input + 2F)."""

    def __init__(self, num_freqs: int, include_input: bool = True,
                 input_dims: int = 3):
        self.include_input = include_input
        self.input_dims = input_dims
        max_freq = num_freqs - 1
        steps = ([0.0] if num_freqs == 1 else
                 [max_freq * i / (num_freqs - 1) for i in range(num_freqs)])
        self.freqs = tuple(2.0 ** s for s in steps)
        self.out_dim = input_dims * ((1 if include_input else 0)
                                     + 2 * len(self.freqs))

    def __call__(self, x: Tensor) -> Tensor:
        f = torch.tensor(self.freqs, dtype=x.dtype, device=x.device)
        xb = x[..., None, :] * f[:, None]                     # [..., F, D]
        sc = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)  # [..., F, 2, D]
        sc = sc.reshape(x.shape[:-1] + (2 * len(self.freqs) * x.shape[-1],))
        return torch.cat([x, sc], dim=-1) if self.include_input else sc


def position_embedding_sine(H: int, W: int, num_pos_feats: int,
                            device=None, dtype=torch.float32) -> Tensor:
    """[H, W, C] sine embedding of normalized (x, y) grid coordinates:
    sin(i*pi*p) for i in 1..depth, then cos, depth = num_pos_feats // 2.
    Computed in `dtype`, each step rounded to it, the Python constants
    too (as JAX computes it for a bf16 `dtype`)."""
    def c(v: float):
        return v if dtype == torch.float32 else torch.tensor(v, dtype=dtype)

    y = (torch.arange(H, dtype=dtype, device=device) + c(0.5)) / c(H + 1e-6)
    x = (torch.arange(W, dtype=dtype, device=device) + c(0.5)) / c(W + 1e-6)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    pos = torch.stack([xx, yy], dim=-1)                       # [H, W, 2]
    depth = num_pos_feats // 2
    sins = [torch.sin(c(i * math.pi) * pos) for i in range(1, depth + 1)]
    coss = [torch.cos(c(i * math.pi) * pos) for i in range(1, depth + 1)]
    return torch.cat(sins + coss, dim=-1)
