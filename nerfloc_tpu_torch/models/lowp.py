"""The compute dtype of the port's modules (flax's `dtype=` argument).

The JAX package builds its model with `dtype=compute_dtype_of(cfg)` (bf16
by default) and keeps the parameters f32: every flax `Dense`/`Conv` casts
its input, kernel and bias to the compute dtype, so the product is rounded
to bf16 and the bias is added in bf16. The helpers here do the same for a
torch module; at f32 they call the module itself, so f32 paths are
unchanged.

Where rounding happens follows XLA's, which runs the JAX graph:
- every bf16 product and every bf16 elementwise result is rounded to bf16;
- except the last elementwise step before a cast to f32 (an explicit
  astype, promotion against an f32 operand, or the f32 accumulation inside
  jnp.sum/mean/var): XLA computes that step in f32 from its bf16 operands.
- A Python scalar meets a bf16 operand rounded to bf16 (JAX's weak types).
`torch.autocast` rounds elsewhere and keeps f32 where flax runs bf16, so
the port does not use it.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor
F32 = torch.float32


def const(v: float, like: Tensor):
    """A Python scalar as JAX applies it to `like`: rounded to like's dtype
    below f32 (a 0-d CPU tensor), the float itself at f32."""
    return v if like.dtype == F32 else torch.tensor(v, dtype=like.dtype)


def dense(lin: nn.Linear, x: Tensor, dtype: torch.dtype) -> Tensor:
    """flax Dense(dtype=dtype) with lin's weights: x and the kernel cast to
    dtype, the product rounded to dtype, then the bias added in dtype."""
    if dtype == F32:
        return lin(x)
    y = x.to(dtype) @ lin.weight.to(dtype).t()
    return y if lin.bias is None else y + lin.bias.to(dtype)


def conv(mod: nn.Module, x: Tensor, dtype: torch.dtype) -> Tensor:
    """flax Conv/ConvTranspose(dtype=dtype) with a torch Conv1d, Conv2d or
    ConvTranspose1d's weights: the convolution of dtype operands rounded to
    dtype, then the bias added in dtype."""
    if dtype == F32:
        return mod(x)
    w = mod.weight.to(dtype)
    x = x.to(dtype)
    if isinstance(mod, nn.ConvTranspose1d):
        y = F.conv_transpose1d(x, w, None, mod.stride, mod.padding, mod.output_padding,
                               mod.groups, mod.dilation)
    elif isinstance(mod, nn.Conv1d):
        y = F.conv1d(x, w, None, mod.stride, mod.padding, mod.dilation, mod.groups)
    else:
        y = F.conv2d(x, w, None, mod.stride, mod.padding, mod.dilation, mod.groups)
    if mod.bias is None:
        return y
    return y + mod.bias.to(dtype).reshape((-1,) + (1,) * (y.dim() - 2))


def leaky_relu(x: Tensor, slope: float = 0.01) -> Tensor:
    """flax leaky_relu: where(x >= 0, x, slope * x), the slope in x's dtype."""
    if x.dtype == F32:
        return F.leaky_relu(x, slope)
    return torch.where(x >= 0, x, x * const(slope, x))


def sigmoid(x: Tensor, f32_out: bool = False) -> Tensor:
    """jax.nn.sigmoid at x's dtype as XLA expands it, 1 / (1 + exp(-x)),
    each step rounded; f32_out: the division in f32 (its result meets an
    f32 operand)."""
    if x.dtype == F32:
        return torch.sigmoid(x)
    d = 1 + torch.exp(-x)
    return 1.0 / d.float() if f32_out else 1 / d


def softplus(x: Tensor, f32_out: bool = False) -> Tensor:
    """jax.nn.softplus at x's dtype, logaddexp(x, 0) = max(x, 0) +
    log1p(exp(-|x|)), each step rounded; f32_out: the last sum in f32."""
    if x.dtype == F32:
        return F.softplus(x)
    m, l = torch.clamp(x, min=0), torch.log1p(torch.exp(-x.abs()))
    return m.float() + l.float() if f32_out else m + l


def softmax(x: Tensor, dim: int) -> Tensor:
    """jax.nn.softmax at x's dtype: below f32, exp(x - max) is rounded for
    the numerator and summed unrounded in f32 for the denominator, which is
    rounded before the division."""
    if x.dtype == F32:
        return torch.softmax(x, dim=dim)
    e = torch.exp((x - x.amax(dim=dim, keepdim=True)).float())
    return e.to(x.dtype) / e.sum(dim=dim, keepdim=True).to(x.dtype)


def rsqrt(x: Tensor) -> Tensor:
    """1/sqrt(x) rounded to x's dtype (torch's bf16 rsqrt is an
    approximation that misses the nearest bf16 value)."""
    return torch.rsqrt(x) if x.dtype == F32 else torch.rsqrt(x.float()).to(x.dtype)


def stats(x: Tensor, dims) -> Tuple[Tensor, Tensor]:
    """(jnp.mean, jnp.var) over dims at x's dtype: f32 sums, the results
    rounded to x's dtype (population variance about the f32 mean)."""
    xf = x.float()
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    return mean.to(x.dtype), var.to(x.dtype)


def normalize(x: Tensor, dims, eps: float, f32_out: bool = False) -> Tensor:
    """(x - mean) * rsqrt(var + eps) over dims (population variance), as
    the JAX package's instance and layer norms compute it: at f32 as is;
    below f32 from rounded statistics, difference and rsqrt, the product
    rounded too unless f32_out (it meets an f32 scale: taken in f32)."""
    if x.dtype == F32:
        mean = x.mean(dim=dims, keepdim=True)
        var = x.var(dim=dims, keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + eps)
    mean, var = stats(x, dims)
    d, r = x - mean, rsqrt(var + const(eps, x))
    return d.float() * r.float() if f32_out else d * r


def layer_norm(ln: nn.LayerNorm, x: Tensor) -> Tensor:
    """flax LayerNorm with f32 parameters: statistics and result in f32 for
    any input dtype (the result is f32)."""
    if x.dtype == F32:
        return ln(x)
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)
