"""Rendering losses: NeRF-W uncertainty RGB term, inverse-depth term and
the feature term, in masked fixed-shape form (counterpart of
nerfloc_tpu/models/fields/losses.py), plus img2mse and mse2psnr."""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .neuray import to_inverse_normalized_depth

Tensor = torch.Tensor


def masked_mean(x: Tensor, mask: Tensor) -> Tensor:
    """Mean of x over the rows mask [R] selects (trailing axes of x count
    as x.numel() / mask.numel() elements per row)."""
    w = mask.to(x.dtype)
    while w.dim() < x.dim():
        w = w[..., None]
    return torch.sum(x * w) / torch.clamp(torch.sum(w) * (x.numel() / mask.numel()),
                                          min=1e-8)


def img2mse(x: Tensor, y: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    if mask is None:
        return torch.mean((x - y) ** 2)
    m = mask.to(x.dtype)[..., None]
    return torch.sum((x - y) ** 2 * m) / (torch.sum(m) * x.shape[-1] + 1e-8)


def mse2psnr(mse: Tensor) -> Tensor:
    return -10.0 * torch.log(torch.clamp(mse, min=1e-12)) / math.log(10.0)


def rendering_loss(preds: Dict[str, Tensor], targets: Dict[str, Tensor],
                   use_depth: bool = False, coef: float = 1.0) -> Tensor:
    """RGB loss over the rays `targets['mask']` (or `preds['mask']`)
    selects: with preds['beta'], the uncertainty form |rgb - t|^2 / 2
    beta^2 + 3 + log beta; the inverse-normalized depth loss (and of
    preds['depth_coarse']) where the target depth is > 0; 0.1 x the
    feature loss."""
    mask = targets.get("mask", preds.get("mask"))
    if mask is None:
        mask = torch.ones(preds["rgb"].shape[0], dtype=torch.bool,
                          device=preds["rgb"].device)
    rgb, rgb_t = preds["rgb"], targets["rgb"]
    if "beta" in preds:
        beta = preds["beta"]
        rgb_loss = masked_mean((rgb - rgb_t) ** 2 / (2.0 * beta[:, None] ** 2), mask)
        beta_loss = 3.0 + masked_mean(torch.log(torch.clamp(beta, min=1e-8)), mask)
        loss = coef * (rgb_loss + beta_loss)
    else:
        loss = coef * masked_mean((rgb - rgb_t) ** 2, mask)

    if use_depth and "depth" in targets:
        near, far = targets["depth_range"]
        d_t = targets["depth"]
        dm = (d_t > 0) & mask
        d_t_n = to_inverse_normalized_depth(d_t, near, far)
        d_n = to_inverse_normalized_depth(preds["depth"], near, far)
        loss = loss + coef * masked_mean((d_n - d_t_n) ** 2, dm)
        if "depth_coarse" in preds:
            dc_n = to_inverse_normalized_depth(preds["depth_coarse"], near, far)
            loss = loss + coef * masked_mean((dc_n - d_t_n) ** 2, dm)

    if "feat" in preds and "feat" in targets:
        loss = loss + coef * 0.1 * masked_mean((preds["feat"] - targets["feat"]) ** 2, mask)
    return loss
