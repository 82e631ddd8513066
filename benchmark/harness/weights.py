"""Seeded random weights, made on the device in one draw.

The scheme is the port's `init_params` (flax's default): the kernel of
every Linear / Conv1d / Conv2d / ConvTranspose1d ~ N(0, 1/fan_in) clipped
at 2 sigma (lecun normal), biases 0, every other parameter (norm scales
and shifts) the constant its constructor gives. Which parameter is which
comes from the frozen reference's modules; the values come from one
`torch.randn` of all the kernels' elements on the device, so the same seed
gives the same weights to the port and to the reference.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

KERNELS = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)
STD_CORRECTION = 0.87962566103423978   # std of N(0, 1) truncated at 2 sigma


def plan(model: nn.Module) -> List[Tuple[str, torch.Size, str, float]]:
    """(name, shape, kind, value) of every parameter: kind 'kernel' with
    its lecun std as value, or 'const' with the constant the constructor
    set (every other parameter here is one constant)."""
    mods = dict(model.named_modules())
    out = []
    for name, p in model.named_parameters():
        owner, leaf = name.rsplit(".", 1)
        m = mods[owner]
        if isinstance(m, KERNELS) and leaf == "weight":
            w_in = p.transpose(0, 1) if isinstance(m, nn.ConvTranspose1d) else p
            std = (1.0 / w_in[0].numel()) ** 0.5 / STD_CORRECTION
            out.append((name, p.shape, "kernel", std))
        elif isinstance(m, KERNELS) and leaf == "bias":
            out.append((name, p.shape, "const", 0.0))
        else:
            vals = p.detach().flatten()
            if not bool(torch.all(vals == vals[0])):
                raise ValueError(f"weights: {name} is not a constant at construction")
            out.append((name, p.shape, "const", float(vals[0])))
    return out


def make(plan_: List[Tuple[str, torch.Size, str, float]], seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor on device} for the plan, from seed."""
    n = sum(s.numel() for _, s, kind, _ in plan_ if kind == "kernel")
    g = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(n, generator=g, device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for name, shape, kind, v in plan_:
        if kind == "kernel":
            out[name] = draw[at:at + shape.numel()].view(shape) * v
            at += shape.numel()
        else:
            out[name] = torch.full(shape, v, device=device)
    return out


def load(model: nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy weights into model's parameters; the names and shapes must be
    the reference's, one for one."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        missing, extra = sorted(set(weights) - set(params)), sorted(set(params) - set(weights))
        raise ValueError(f"weights: parameters differ from the reference's "
                         f"(missing {missing[:5]}, extra {extra[:5]})")
    with torch.no_grad():
        for name, p in params.items():
            if p.shape != weights[name].shape:
                raise ValueError(f"weights: {name} has shape {tuple(p.shape)}, the "
                                 f"reference's {tuple(weights[name].shape)}")
            p.copy_(weights[name])
