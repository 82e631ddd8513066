"""1-D U-Net over the samples of each ray (counterpart of
nerfloc_tpu/models/fields/ray_unet.py).

k=3 convolutions with a LayerNorm over (samples, channels) and ELU, three
max-pool levels down and three transposed-convolution levels up with skip
connections, and a last convolution over [input, up]. The module boundary
is [R, S, C] as in the JAX package; inside, tensors are [R, C, S] for
nn.Conv1d. Weight names follow the flax tree (conv1/conv, conv1/ln, ...).
`dtype` is the compute dtype (models/lowp.py) of the convolutions; each
LayerNorm takes f32 statistics of its bf16 input and, with its f32 affine,
returns f32, so the U-Net's output is f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..lowp import F32, conv, normalize

Tensor = torch.Tensor


class LayerNormSC(nn.Module):
    """LayerNorm over (samples, channels) of each ray with an [S, C] affine;
    population variance, eps 1e-5. Acts on [R, C, S]."""

    def __init__(self, samples: int, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(samples, channels))
        self.bias = nn.Parameter(torch.zeros(samples, channels))

    def forward(self, x: Tensor) -> Tensor:
        # JAX's layout is [R, S, C]: S is the outer reduced axis
        y = normalize(x, (-2, -1), 1e-5, f32_out=True)
        return y * self.scale.T + self.bias.T


class ConvBlock(nn.Module):
    """conv (k=3 'same', or transposed with stride 2 doubling S) + LN + ELU."""

    def __init__(self, cin: int, cout: int, samples: int, transpose: bool = False,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.transpose = transpose
        if transpose:
            self.conv = nn.ConvTranspose1d(cin, cout, 3, stride=2, padding=1,
                                           output_padding=1)
        else:
            self.conv = nn.Conv1d(cin, cout, 3, padding=1)
        self.ln = LayerNormSC(samples, cout)

    def forward(self, x: Tensor) -> Tensor:
        if self.transpose and x.shape[-1] == 0:
            # the deepest level of a ray with S < 8 samples is empty; the JAX
            # package's transposed convolution (padding (1, 2)) still gives
            # one sample there, its bias: the first output of a zero input
            x = conv(self.conv, x.new_zeros(x.shape[:-1] + (1,)), self.dtype)[..., :1]
        else:
            x = conv(self.conv, x, self.dtype)
        return F.elu(self.ln(x))


def _pool(h: Tensor) -> Tensor:
    """Max-pool by 2 along the samples; one sample pools to none (flax's
    VALID max_pool), where torch's max_pool1d raises."""
    return F.max_pool1d(h, 2) if h.shape[-1] >= 2 else h[..., :0]


class RayUnet(nn.Module):
    """[R, S, C] -> [R, S, C] for a fixed S (the LayerNorm shapes depend on
    it) divisible by 8."""

    def __init__(self, in_channels: int, n_samples: int, dtype: torch.dtype = F32):
        super().__init__()
        S, C = n_samples, in_channels
        self.n_samples = S
        self.conv1 = ConvBlock(C, 64, S, dtype=dtype)
        self.conv2 = ConvBlock(64, 128, S // 2, dtype=dtype)
        self.conv3 = ConvBlock(128, 128, S // 4, dtype=dtype)
        self.trans_conv3 = ConvBlock(128, 128, S // 4, transpose=True, dtype=dtype)
        self.trans_conv2 = ConvBlock(256, 64, S // 2, transpose=True, dtype=dtype)
        self.trans_conv1 = ConvBlock(128, 32, S, transpose=True, dtype=dtype)
        self.conv_out = ConvBlock(C + 32, C, S, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        if x.shape[1] != self.n_samples:
            raise ValueError(f"RayUnet built for S={self.n_samples}, got {x.shape[1]}")
        x = x.transpose(1, 2)
        p1 = _pool(self.conv1(x))
        p2 = _pool(self.conv2(p1))
        p3 = _pool(self.conv3(p2))
        u3 = self.trans_conv3(p3)
        u2 = self.trans_conv2(torch.cat([p2, u3], dim=1))
        u1 = self.trans_conv1(torch.cat([p1, u2], dim=1))
        return self.conv_out(torch.cat([x, u1], dim=1)).transpose(1, 2)
