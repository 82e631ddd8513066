"""SO(3)/SE(3) exponential and logarithm maps (counterpart of
nerfloc_tpu/geometry/se3.py: `hat`, `so3_exp_map`, `so3_log_map`,
`se3_exp_map`, `se3_log_map`, the left-Jacobian helpers and
`compute_pose_error`).

Small-angle limits use torch.where with safe operands, so gradients stay
finite at θ = 0; W^2 uses the elementwise identity W^2 = w w^T - |w|^2 I
and the left Jacobian is applied as cross products, never as 3x3 matrix
products. Convention: column vectors, T = [[R, t], [0, 1]], twist =
(rho, omega) with exp([rho, omega]) = [[exp(omega^), V(omega) rho], [0, 1]].
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor

_EPS = 1e-8


def hat(w: Tensor) -> Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], z], dim=-1),
    ], dim=-2)


def _sinc_coeffs(theta2: Tensor):
    """(sinθ/θ, (1-cosθ)/θ², (θ-sinθ)/θ³) from θ² alone, with Taylor
    limits below θ² = 1e-8."""
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=_EPS))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=_EPS))
    return A, B, C


def so3_exp_map(w: Tensor) -> Tensor:
    """Rodrigues formula: [..., 3] axis-angle -> [..., 3, 3] rotation."""
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_coeffs(theta2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(w.shape[:-1] + (3, 3))
    W2 = w[..., :, None] * w[..., None, :] - theta2[..., None, None] * eye
    return eye + A[..., None, None] * hat(w) + B[..., None, None] * W2


def _sign_nz(x: Tensor) -> Tensor:
    """sign(x), with +1 at 0."""
    return torch.where(x < 0, -torch.ones_like(x), torch.ones_like(x))


def so3_log_map(R: Tensor) -> Tensor:
    """[..., 3, 3] rotation -> [..., 3] axis-angle, robust at θ = π.

    Up to θ = 3π/4 the axis is the skew part scaled by θ / (2 sinθ); beyond
    it that form amplifies noise in R by 1/sinθ, so the axis is read from
    the diagonal of the symmetric part, R + Rᵀ = 2cosθ I + 2(1-cosθ) aaᵀ:
    the largest |a_k| is the pivot, the off-diagonal products fix the other
    signs, and the skew part fixes the overall sign."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w_skew = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                          R[..., 0, 2] - R[..., 2, 0],
                          R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    scale = torch.where(theta < 1e-4, 0.5 + theta * theta / 12.0,
                        theta / torch.clamp(2.0 * torch.sin(theta), min=_EPS))
    w_sin = w_skew * scale[..., None]

    one_minus = torch.clamp(1.0 - cos_theta, min=_EPS)[..., None]
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    a2 = torch.clamp((diag - cos_theta[..., None]) / one_minus, 0.0, 1.0)
    a_abs = torch.sqrt(torch.clamp(a2, min=1e-12))
    s01 = _sign_nz((R[..., 0, 1] + R[..., 1, 0]) / 2.0)
    s02 = _sign_nz((R[..., 0, 2] + R[..., 2, 0]) / 2.0)
    s12 = _sign_nz((R[..., 1, 2] + R[..., 2, 1]) / 2.0)
    one = torch.ones_like(s01)
    # signs relative to the pivot axis k (first largest a_k^2)
    signs = torch.stack([torch.stack([one, s01, s02], dim=-1),
                         torch.stack([s01, one, s12], dim=-1),
                         torch.stack([s02, s12, one], dim=-1)], dim=-2)
    k = torch.argmax(a2, dim=-1)
    sign = torch.gather(signs, -2, k[..., None, None].expand(k.shape + (1, 3)))[..., 0, :]
    a = a_abs * sign
    flip = torch.sum(a * w_skew, dim=-1, keepdim=True) < 0.0
    w_pi = theta[..., None] * torch.where(flip, -a, a)
    return torch.where((cos_theta < -0.70710678)[..., None], w_pi, w_sin)


def _apply_left_jacobian(w: Tensor, rho: Tensor) -> Tensor:
    """V(ω) rho = rho + B (w x rho) + C (w x (w x rho))."""
    _, B, C = _sinc_coeffs(torch.sum(w * w, dim=-1))
    c1 = torch.linalg.cross(w, rho)
    c2 = torch.linalg.cross(w, c1)
    return rho + B[..., None] * c1 + C[..., None] * c2


def _apply_left_jacobian_inv(w: Tensor, t: Tensor) -> Tensor:
    """V(ω)^-1 t = t - (w x t) / 2 + c (w x (w x t)), with
    c = (1 - (θ/2) cot(θ/2)) / θ² (Taylor limit below θ² = 1e-8)."""
    theta2 = torch.sum(w * w, dim=-1)
    half = torch.sqrt(torch.clamp(theta2, min=_EPS)) / 2.0
    cot = torch.where(
        theta2 < 1e-8, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS))
        / torch.clamp(theta2, min=_EPS))
    c1 = torch.linalg.cross(w, t)
    c2 = torch.linalg.cross(w, c1)
    return t - 0.5 * c1 + cot[..., None] * c2


def se3_exp_map(twist: Tensor) -> Tensor:
    """[..., 6] twist (rho, omega) -> [..., 4, 4] transform."""
    rho, w = twist[..., :3], twist[..., 3:]
    top = torch.cat([so3_exp_map(w), _apply_left_jacobian(w, rho)[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=twist.dtype, device=twist.device)
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def se3_log_map(T: Tensor) -> Tensor:
    """[..., 4, 4] transform -> [..., 6] twist (rho, omega)."""
    w = so3_log_map(T[..., :3, :3])
    return torch.cat([_apply_left_jacobian_inv(w, T[..., :3, 3]), w], dim=-1)


def compute_pose_error(T_est: Tensor, T_gt: Tensor) -> Tuple[Tensor, Tensor]:
    """(rotation error in degrees, translation L2)."""
    trace = torch.sum(T_gt[..., :3, :3] * T_est[..., :3, :3], dim=(-2, -1))
    trace = torch.clamp(trace, -1.0, 3.0)
    ang = torch.rad2deg(torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)))
    trans = torch.linalg.vector_norm(T_est[..., :3, 3] - T_gt[..., :3, 3], dim=-1)
    return ang, trans
