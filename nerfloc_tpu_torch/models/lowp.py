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

Backward, XLA rounds every step of the transposed graph, and a bf16 array
broadcast in the forward (a bias over rows, normalization statistics over
a map) transposes to a bf16 reduction, which XLA's CPU backend
accumulates in bf16 in windows of 32 (`bcast`, `add_bias`).
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


XLA_WINDOW = 32    # XLA's CPU tree-reduction window


def _bf16_sequential_sum(x: Tensor, dims) -> Tensor:
    """x summed over dims one element at a time in row-major order, each
    partial sum rounded to x's dtype."""
    keep = [d for d in range(x.dim()) if d not in dims]
    flat = x.permute(keep + list(dims)).reshape([x.shape[d] for d in keep] + [-1])
    acc = torch.zeros(flat.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(flat.shape[-1]):
        acc = acc + flat[..., i]
    return acc


def xla_cpu_sum(x: Tensor, dims) -> Tensor:
    """reduce_sum of a bf16 tensor over dims as XLA's CPU backend computes
    it: where a reduced axis is longer than 32, every reduced axis is
    zero-padded to a multiple of 32 (half the padding in front) and summed
    window by window (32 along each reduced axis), then the window sums are
    reduced the same way; each sum accumulates in bf16, row-major."""
    dims = sorted(d % x.dim() for d in dims)
    if all(x.shape[d] <= XLA_WINDOW for d in dims):
        return _bf16_sequential_sum(x, dims)
    pad = []
    for d in reversed(range(x.dim())):
        p = -x.shape[d] % XLA_WINDOW if d in dims else 0
        pad += [p // 2, p - p // 2]
    x = F.pad(x, pad)
    shape, win, outer = [], [], []
    for d in range(x.dim()):
        if d in dims:
            outer.append(len(shape) - len(win))
            shape += [x.shape[d] // XLA_WINDOW, XLA_WINDOW]
            win.append(len(shape) - 1)
        else:
            shape.append(x.shape[d])
    return xla_cpu_sum(_bf16_sequential_sum(x.reshape(shape), win), outer)


def lowp_sum(g: Tensor, dims) -> Tensor:
    """The bf16 reduction of a transposed broadcast: on a CPU tensor XLA's
    CPU reduction with the reduced axes taken in the order `dims` (the JAX
    layout's row-major order), as jax.grad computes it; on the card g
    summed in f32 and rounded once (the windowed bf16 sum would cost a
    launch per window element)."""
    dims = [d % g.dim() for d in dims]
    if g.device.type != "cpu":
        return g.float().sum(dims).to(g.dtype)
    keep = [d for d in range(g.dim()) if d not in dims]
    return xla_cpu_sum(g.permute(keep + dims), list(range(len(keep), g.dim())))


class _Broadcast(torch.autograd.Function):
    """x (keepdim shape) expanded to `shape`; backward the lowp_sum of the
    cotangent over the expanded axes, in the order `order`."""

    @staticmethod
    def forward(ctx, x: Tensor, shape, order):
        ctx.order, ctx.shape = order, x.shape
        return x.expand(shape)

    @staticmethod
    def backward(ctx, g: Tensor):
        return lowp_sum(g, ctx.order).reshape(ctx.shape), None, None


def bcast(x: Tensor, shape, order=None) -> Tensor:
    """x broadcast to `shape` as a bf16 array is in JAX: its gradient is the
    cotangent reduced over the broadcast axes (lowp_sum; `order`: those axes
    in JAX's row-major order, by default ascending). At f32 a plain expand."""
    if x.dtype == F32:
        return x.expand(shape)
    if order is None:
        order = [d for d in range(len(shape)) if x.shape[d] == 1 and shape[d] != 1]
    return _Broadcast.apply(x, tuple(shape), list(order))


def add_bias(y: Tensor, b: Tensor, cdim: int = -1) -> Tensor:
    """y + b.to(y.dtype) with b [C] along axis cdim of y; below f32 the bias
    is broadcast with bcast, rows in channels-last order (JAX's layout)."""
    cdim = cdim % y.dim()
    b = b.to(y.dtype).reshape([-1 if d == cdim else 1 for d in range(y.dim())])
    return y + bcast(b, y.shape, [d for d in range(y.dim()) if d != cdim])


def dense(lin: nn.Linear, x: Tensor, dtype: torch.dtype) -> Tensor:
    """flax Dense(dtype=dtype) with lin's weights: x and the kernel cast to
    dtype, the product rounded to dtype, then the bias added in dtype."""
    if dtype == F32:
        return lin(x)
    y = x.to(dtype) @ lin.weight.to(dtype).t()
    return y if lin.bias is None else add_bias(y, lin.bias)


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
    return y if mod.bias is None else add_bias(y, mod.bias, 1)


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


class _SoftmaxLowp(torch.autograd.Function):
    """Below f32: forward as XLA computes jax.nn.softmax (softmax's
    docstring); backward as it transposes the custom JVP y (t - sum(y t)):
    each product rounded, the sum's broadcast reduced in bf16 (lowp_sum)."""

    @staticmethod
    def forward(ctx, x: Tensor, dim: int, f32_out: bool) -> Tensor:
        dt = x.dtype
        e = torch.exp((x - x.amax(dim=dim, keepdim=True)).float())
        num, den = e.to(dt), e.sum(dim=dim, keepdim=True).to(dt)
        y = num / den
        ctx.save_for_backward(y)
        ctx.dim = dim
        return num.float() / den.float() if f32_out else y

    @staticmethod
    def backward(ctx, g: Tensor):
        y, = ctx.saved_tensors
        ct_b = y * g.to(y.dtype)
        ct_s = lowp_sum(-ct_b, [ctx.dim]).unsqueeze(ctx.dim)
        return ct_b + y * ct_s, None, None


def softmax(x: Tensor, dim: int, f32_out: bool = False) -> Tensor:
    """jax.nn.softmax at x's dtype: below f32, exp(x - max) is rounded for
    the numerator and summed unrounded in f32 for the denominator, which is
    rounded before the division; f32_out: the division in f32 (the result
    meets an f32 operand)."""
    if x.dtype == F32:
        return torch.softmax(x, dim=dim)
    return _SoftmaxLowp.apply(x, dim % x.dim(), f32_out)


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


def normalize(x: Tensor, dims, eps: float, f32_out: bool = False, order=None) -> Tensor:
    """(x - mean) * rsqrt(var + eps) over dims (population variance), as
    the JAX package's instance and layer norms compute it: at f32 as is;
    below f32 from rounded statistics, difference and rsqrt, the product
    rounded too unless f32_out (it meets an f32 scale: taken in f32); the
    statistics broadcast with bcast (order: dims in JAX's layout order)."""
    if x.dtype == F32:
        mean = x.mean(dim=dims, keepdim=True)
        var = x.var(dim=dims, keepdim=True, unbiased=False)
        return (x - mean) * torch.rsqrt(var + eps)
    mean, var = stats(x, dims)
    d = x - bcast(mean, x.shape, order)
    r = bcast(rsqrt(var + const(eps, x)), x.shape, order)
    return d.float() * r.float() if f32_out else d * r


def layer_norm(ln: nn.LayerNorm, x: Tensor) -> Tensor:
    """flax LayerNorm with f32 parameters: statistics and result in f32 for
    any input dtype (the result is f32)."""
    if x.dtype == F32:
        return ln(x)
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)
