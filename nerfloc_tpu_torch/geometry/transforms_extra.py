"""Extra rotation and perturbation helpers (counterpart of
nerfloc_tpu/geometry/transforms_extra.py): Euler angles to a rotation, a
random SE(3) perturbation, and arccos with linear extrapolation."""
from __future__ import annotations

import math
from typing import Optional

import torch

from .se3 import se3_exp_map

Tensor = torch.Tensor


def euler_angles_to_matrix(angles: Tensor, convention: str = "XYZ") -> Tensor:
    """[..., 3] Euler angles (radians) -> [..., 3, 3]: the product of the
    axis rotations in the convention's order."""
    def axis_rot(axis: str, a: Tensor) -> Tensor:
        c, s = torch.cos(a), torch.sin(a)
        one, zero = torch.ones_like(a), torch.zeros_like(a)
        rows = {"X": [[one, zero, zero], [zero, c, -s], [zero, s, c]],
                "Y": [[c, zero, s], [zero, one, zero], [-s, zero, c]],
                "Z": [[c, -s, zero], [s, c, zero], [zero, zero, one]]}[axis]
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    R = axis_rot(convention[0], angles[..., 0])
    for i, ax in enumerate(convention[1:], start=1):
        R = R @ axis_rot(ax, angles[..., i])
    return R


def get_pose_perturb(trans_sigma: float, rot_sigma: float,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Tensor] = None) -> Tensor:
    """A random SE(3) perturbation [4, 4]: se3_exp_map of the twist
    [rho * trans_sigma | omega * rot_sigma], (rho, omega) = noise [6] of
    standard normals, drawn from `generator` when not given."""
    if noise is None:
        noise = torch.randn(6, generator=generator)
    scale = torch.tensor([trans_sigma] * 3 + [rot_sigma] * 3, dtype=noise.dtype,
                         device=noise.device)
    return se3_exp_map(noise * scale)


def acos_linear_extrapolation(x: Tensor, bound: float = 1.0 - 1e-4) -> Tensor:
    """arccos inside [-bound, bound], continued by its tangent lines at
    +-bound outside, so the value and its gradient stay finite at +-1."""
    b = torch.tensor(bound, dtype=x.dtype, device=x.device)
    acos_b = torch.arccos(b)
    dacos_b = -1.0 / torch.sqrt(1.0 - b * b)
    upper = acos_b + (x - b) * dacos_b
    lower = math.pi - acos_b + (x + b) * dacos_b
    # minimum/maximum, not clamp: at x = +-bound they split the gradient
    # between their two sides as jnp.clip does
    inside = torch.arccos(torch.minimum(torch.maximum(x, -b), b))
    return torch.where(x > b, upper, torch.where(x < -b, lower, inside))
