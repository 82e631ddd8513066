"""The compute dtype of the reference's modules.

At float32 every helper calls the module or function itself. Below it
(the control, and the bf16 look) a module computes plainly at its dtype:
inputs, kernels and biases cast to it, each result at it, as a flax module
built with `dtype=` does; statistics and softmax sums are taken in f32 and
rounded once. The parameters stay f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor
F32 = torch.float32


def const(v: float, like: Tensor):
    """A Python scalar applied to `like` (torch keeps like's dtype)."""
    return v


def bcast(x: Tensor, shape) -> Tensor:
    return x.expand(shape)


def add_bias(y: Tensor, b: Tensor, cdim: int = -1) -> Tensor:
    """y + b.to(y.dtype) with b [C] along axis cdim of y."""
    cdim = cdim % y.dim()
    return y + b.to(y.dtype).reshape([-1 if d == cdim else 1 for d in range(y.dim())])


def dense(lin: nn.Linear, x: Tensor, dtype: torch.dtype) -> Tensor:
    """lin at dtype: x and the weights cast to dtype."""
    if dtype == F32:
        return lin(x)
    return F.linear(x.to(dtype), lin.weight.to(dtype),
                    None if lin.bias is None else lin.bias.to(dtype))


def conv(mod: nn.Module, x: Tensor, dtype: torch.dtype) -> Tensor:
    """A Conv1d, Conv2d or ConvTranspose1d at dtype: x and the weights cast
    to dtype."""
    if dtype == F32:
        return mod(x)
    w = mod.weight.to(dtype)
    b = None if mod.bias is None else mod.bias.to(dtype)
    x = x.to(dtype)
    if isinstance(mod, nn.ConvTranspose1d):
        return F.conv_transpose1d(x, w, b, mod.stride, mod.padding, mod.output_padding,
                                  mod.groups, mod.dilation)
    if isinstance(mod, nn.Conv1d):
        return F.conv1d(x, w, b, mod.stride, mod.padding, mod.dilation, mod.groups)
    return F.conv2d(x, w, b, mod.stride, mod.padding, mod.dilation, mod.groups)


def leaky_relu(x: Tensor, slope: float = 0.01) -> Tensor:
    return F.leaky_relu(x, slope)


def sigmoid(x: Tensor, f32_out: bool = False) -> Tensor:
    """sigmoid at x's dtype; f32_out: the result as f32."""
    y = torch.sigmoid(x)
    return y.float() if f32_out else y


def softplus(x: Tensor, f32_out: bool = False) -> Tensor:
    y = F.softplus(x)
    return y.float() if f32_out else y


def softmax(x: Tensor, dim: int, f32_out: bool = False) -> Tensor:
    y = torch.softmax(x, dim=dim)
    return y.float() if f32_out else y


def normalize(x: Tensor, dims, eps: float, f32_out: bool = False) -> Tensor:
    """(x - mean) * rsqrt(var + eps) over dims (population variance), in
    f32 and rounded to x's dtype once unless f32_out."""
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = xf.var(dim=dims, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return y if f32_out or x.dtype == F32 else y.to(x.dtype)


def layer_norm(ln: nn.LayerNorm, x: Tensor) -> Tensor:
    """LayerNorm with f32 parameters: statistics and result in f32 for any
    input dtype (the result is f32)."""
    if x.dtype == F32:
        return ln(x)
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)
