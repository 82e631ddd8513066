"""Ray-parallel rendering over the mesh's `ray` groups (counterpart of
nerfloc_tpu/parallel/render.py).

Parameters and the scene context are the same on every rank (each builds
the context from the same weights and batch); each rank of a `ray` group
renders its contiguous part of the rays with ConditionalNeRF.render_rays
(one fused-aggregation launch per call on the card), and the parts are
all-gathered in the group, so every rank ends with the whole result.
Boolean outputs cross the collective as uint8.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..configs import Config
from ..geometry.cameras import get_rays
from .mesh import Mesh

Tensor = torch.Tensor


def _gather(x: Tensor, group: Optional[dist.ProcessGroup], n: int, dim: int) -> Tensor:
    """Concatenate every rank's `x` of `group` along `dim`, in rank order."""
    if group is None:
        return x
    is_bool = x.dtype == torch.bool
    t = (x.to(torch.uint8) if is_bool else x).contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    out = torch.cat(parts, dim=dim)
    return out.bool() if is_bool else out


def _split(n_items: int, n: int, i: int, what: str) -> slice:
    if n_items % n:
        raise ValueError(f"{what}: {n_items} do not split evenly over {n} ranks")
    k = n_items // n
    return slice(i * k, (i + 1) * k)


def make_context_builder(model) -> Callable:
    """build(batch) -> the scene context of one query batch (each rank
    builds the same one from the same weights)."""

    @torch.no_grad()
    def build(batch: Dict[str, Tensor]):
        return model.build_context(batch)[0]

    return build


def make_ray_sharded_render(model, cfg: Config, mesh: Mesh) -> Callable:
    """render(ctx, rays_o, rays_d, pose) -> render_rays outputs for all R
    rays, this rank rendering rows ray_index*R/n .. of them. R must divide
    by the ray width (ValueError otherwise, before any collective)."""
    n = mesh.spec.ray

    @torch.no_grad()
    def render(ctx, rays_o: Tensor, rays_d: Tensor, pose: Tensor) -> Dict[str, Tensor]:
        rows = _split(rays_o.shape[0], n, mesh.ray_index, "rays")
        out = model.model_3d.render_rays(ctx, rays_o[rows], rays_d[rows], pose, train=False)
        return {k: _gather(v, mesh.ray_group, n, 0) for k, v in out.items()}

    return render


def make_batched_ray_sharded_render(model, cfg: Config, mesh: Mesh) -> Callable:
    """The (data x ray) render: each `data` row renders its own queries,
    each query's rays split over the `ray` axis.

    Returns render(ctxs, rays_o, rays_d, poses): ctxs a sequence of Q
    scene contexts, rays_o/rays_d [Q, R, 3], poses [Q, 4, 4]; Q must divide
    by the data width and R by the ray width. The outputs are [Q, R, ...]
    on every rank of the mesh."""
    nd, nr = mesh.spec.data, mesh.spec.ray

    @torch.no_grad()
    def render(ctxs: Sequence, rays_o: Tensor, rays_d: Tensor, poses: Tensor
               ) -> Dict[str, Tensor]:
        qs = _split(rays_o.shape[0], nd, mesh.data_index, "queries")
        rows = _split(rays_o.shape[1], nr, mesh.ray_index, "rays")
        outs = [model.model_3d.render_rays(ctxs[q], rays_o[q, rows], rays_d[q, rows], poses[q],
                                           train=False)
                for q in range(qs.start, qs.stop)]
        result = {}
        for k in outs[0]:
            mine = torch.stack([o[k] for o in outs])
            result[k] = _gather(_gather(mine, mesh.ray_group, nr, 1), mesh.data_group, nd, 0)
        return result

    return render


def render_image_ray_sharded(model, cfg: Config, ctx, K: Tensor, pose: Tensor, H: int, W: int,
                             mesh: Mesh, render: Optional[Callable] = None) -> Dict[str, Tensor]:
    """A whole H x W frame with each chunk's rays split over the ray
    group: chunks of cfg.render.chunk * ray-width rays, so each rank's
    render_rays call takes cfg.render.chunk rays, as render_image's do on
    one device. The rays are padded by tiling to whole chunks (the pad may
    exceed H*W), the outputs trimmed and shaped [H, W, ...]."""
    render = render or make_ray_sharded_render(model, cfg, mesh)
    rays_o, rays_d = get_rays(H, W, K, pose)
    flat_o, flat_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
    n = flat_o.shape[0]
    chunk = cfg.render.chunk * mesh.spec.ray
    pad = (-n) % chunk
    if pad:
        reps = -(-(n + pad) // n)
        flat_o = flat_o.repeat(reps, 1)[:n + pad]
        flat_d = flat_d.repeat(reps, 1)[:n + pad]
    outs = [render(ctx, flat_o[s:s + chunk], flat_d[s:s + chunk], pose)
            for s in range(0, flat_o.shape[0], chunk)]
    return {k: torch.cat([o[k] for o in outs])[:n].reshape((H, W) + outs[0][k].shape[1:])
            for k in outs[0]}
