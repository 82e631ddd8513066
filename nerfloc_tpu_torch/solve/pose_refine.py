"""Photometric pose refinement by differentiable rendering (counterpart of
nerfloc_tpu/solve/pose_refine.py: `refine_pose`, `sample_refine_pixels`).

The pose is an se(3) twist; a fixed set of pixels is rendered from it and
the masked squared colour error, divided by the number of rays that see
the scene, is minimised with Adam. The gradient flows through the whole
conditional-NeRF renderer into the twist; the scene context is a constant.

Adam is optax.adam written out (bias-corrected moments, eps outside the
square root), because the JAX loop's bookkeeping differs from
torch.optim.Adam's in one place that shows: a step whose loss or new twist
is not finite keeps the old twist, but its moments and count advance all
the same. Each step builds and frees one graph; nothing is read back to
the host inside the loop.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..geometry.cameras import rays_for_pixels
from ..geometry.se3 import se3_exp_map, se3_log_map
from ..ops.knn import topk_first
from ..utils.profiling import span
from .pnp import gumbel_noise

Tensor = torch.Tensor
RenderFn = Callable[[Tensor, Tensor, Tensor], Dict[str, Tensor]]
B1, B2, EPS = 0.9, 0.999, 1e-8   # optax.adam defaults
GRID_DILATION = 10               # 'grid' pixels: every 10th in both axes


def refine_pose(render_fn: RenderFn, pose_init: Tensor, K: Tensor, rgb_image: Tensor,
                uv: Tensor, max_steps: int = 50, lr: float = 1e-3,
                trace: Optional[List[Tensor]] = None) -> Tensor:
    """Refine a camera-to-world pose [4, 4].

    render_fn(rays_o [S,3], rays_d [S,3], pose [4,4]) -> {'rgb' [S,3],
    'mask' [S]} must be differentiable in rays and pose. rgb_image [H, W, 3]
    is the target; uv [S, 2] the pixel coordinates (integers as float).
    Runs max_steps Adam steps; the result is the refined pose when its loss
    is no higher than the initial pose's, at least half as many rays see
    the scene, and it is finite, else pose_init. `trace`, when given,
    receives each step's loss (0-d tensors, before the step's update)."""
    with span("refine"):
        target = rgb_image[uv[:, 1].long(), uv[:, 0].long()]

        def loss_fn(twist: Tensor):
            with span("refine.render"):
                pose = se3_exp_map(twist)
                out = render_fn(*rays_for_pixels(uv, K, pose), pose)
                m = out["mask"].to(target.dtype)[:, None]
                n_valid = torch.sum(m)
                loss = torch.sum(((out["rgb"] - target) * m) ** 2) / torch.clamp(n_valid, min=1.0)
            return loss, n_valid

        with torch.no_grad():
            twist0 = se3_log_map(pose_init)
        twist = twist0
        mu, nu = torch.zeros_like(twist0), torch.zeros_like(twist0)
        for count in range(1, max_steps + 1):
            t = twist.detach().requires_grad_(True)
            with torch.enable_grad():
                loss, _ = loss_fn(t)
                with span("refine.grad"):
                    (g,) = torch.autograd.grad(loss, t)
            loss = loss.detach()
            with torch.no_grad():
                mu = (1 - B1) * g + B1 * mu
                nu = (1 - B2) * g * g + B2 * nu
                # bias corrections in f32 as optax computes them, as host
                # scalars (a copy to the device would wait for it)
                mu_hat = mu / float(np.float32(1) - np.float32(B1) ** np.float32(count))
                nu_hat = nu / float(np.float32(1) - np.float32(B2) ** np.float32(count))
                new = twist - lr * (mu_hat / (torch.sqrt(nu_hat) + EPS))
                ok = torch.isfinite(loss) & torch.isfinite(new).all()
                twist = torch.where(ok, new, twist)
            if trace is not None:
                trace.append(loss)
        with torch.no_grad():
            loss0, n0 = loss_fn(twist0)
            final_loss, n_f = loss_fn(twist)
            pose_f = se3_exp_map(twist)
            accept = (final_loss <= loss0) & (n_f >= 0.5 * n0) & torch.isfinite(pose_f).all()
            return torch.where(accept, pose_f, pose_init)


def sample_refine_pixels(H: int, W: int, n: int, target_mask: Optional[Tensor] = None,
                         mode: str = "random", generator: Optional[torch.Generator] = None,
                         gumbel: Optional[Tensor] = None, device=None) -> Tensor:
    """Exactly n refinement pixels [n, 2] (u, v) as float.

    'random': n distinct pixels, a Gumbel top-k over [H*W] (gumbel, drawn
    from `generator` when None) restricted to target_mask [H, W] > 0 when
    given: a uniform subset without replacement. 'grid': every
    GRID_DILATION-th pixel in both axes, row-major, evenly subsampled to n
    or repeated up to n."""
    if target_mask is not None:
        device = target_mask.device
    if mode == "grid":
        d = GRID_DILATION
        gh, gw = -(-H // d), -(-W // d)
        vv, uu = torch.meshgrid(torch.arange(gh, device=device) * d,
                                torch.arange(gw, device=device) * d, indexing="ij")
        uv_all = torch.stack([uu.reshape(-1), vv.reshape(-1)], dim=-1)
        m = gh * gw
        i = torch.arange(n, device=device)
        return uv_all[(i * m) // n if m >= n else i % m].float()
    if gumbel is None:
        gumbel = gumbel_noise((H * W,), generator, device)
    if target_mask is not None:
        gumbel = torch.where(target_mask.reshape(-1) > 0, gumbel,
                             torch.full_like(gumbel, float("-inf")))
    idx = topk_first(gumbel, n)[1]
    return torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)
