"""Ablation field with plain projection-average conditioning (counterpart
of nerfloc_tpu/models/fields/conditional_nerf_simple.py), selected by
cfg.simple_3d_model.

`query` does no KNN and no visibility weighting: the feature of a point is
`out_fc` of the mask-weighted mean of its projected samples [rgb | feature]
over the views that see it, and the coarse and fine descriptors are single
linear maps of that. So no query, render or train step of this model
launches the fused aggregation. It has none of ConditionalNeRF's neighbour
modules (ray_diff_fc, base_mlp, base_mlp_attn, the coordinate heads), as
the JAX model's parameter tree has none.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ...configs import Config
from ...geometry.cameras import world_to_camera
from ..lowp import F32, dense
from .conditional_nerf import ConditionalNeRF
from .context import SceneContext
from .projector import Projection, project_and_sample

Tensor = torch.Tensor


class ConditionalNeRFSimple(ConditionalNeRF):

    def __init__(self, cfg: Config, dtype: torch.dtype = F32):
        super().__init__(cfg, dtype)
        W, hd = cfg.model_3d_hidden_dim, cfg.matcher_hidden_dim
        for name in ("ray_diff_fc", "base_mlp", "base_mlp_attn", "coord_desc_mlp_coarse",
                     "coord_desc_mlp_fine"):
            if hasattr(self, name):
                delattr(self, name)
        self.out_fc = nn.Linear(self.feat_dim, W)
        self.proj_layer_3d_coarse = nn.Linear(W, hd)
        self.proj_layer_3d_fine = nn.Linear(W, hd)

    def query(self, ctx: SceneContext, xyz: Tensor, level: str, K: int,
              direction: Optional[Tensor] = None, knn_idx: Optional[Tensor] = None,
              proj: Optional[Projection] = None, cand=None, mv_samples=None
              ) -> Dict[str, Tensor]:
        """Mask-weighted mean of the projected samples of xyz [N, 3]; the
        neighbour arguments are accepted for render_rays and ignored."""
        featmaps = ctx.feat_coarse_src if level == "coarse" else ctx.feat_fine_src
        rgb, feat, mask = project_and_sample(xyz, ctx.sv.Ks, ctx.sv.poses, ctx.sv.images,
                                             featmaps)
        weight = mask / (torch.sum(mask, dim=1, keepdim=True) + 1e-8)
        mv_feat = torch.cat([rgb, feat.to(rgb.dtype)], dim=-1)             # [N, V, 3+C]
        feature_agg = dense(self.out_fc, torch.sum(mv_feat * weight, dim=1), self.dtype)
        return {"feature_agg": feature_agg, "feature": mv_feat, "weights": weight[..., 0],
                "multiview_feature": mv_feat, "multiview_visibility": mask,
                "view_sel": None}

    def query_coarse(self, ctx: SceneContext, gumbel: Optional[Tensor] = None,
                     points: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
        """-> (desc, pts3d, pts3d_ndc): desc = proj_layer_3d_coarse of the
        query feature alone, at Gumbel-sampled or given points."""
        if points is None:
            pts3d, pts3d_ndc, _ = self.sample_keypoints(
                ctx, self.cfg.matching.fine_num_3d_keypoints, gumbel)
        else:
            pts3d, pts3d_ndc = points, world_to_camera(ctx.sv.poses[0], points)
        qd = self.query(ctx, pts3d, level="coarse", K=8)
        return dense(self.proj_layer_3d_coarse, qd["feature_agg"], self.dtype), pts3d, pts3d_ndc

    def query_fine(self, ctx: SceneContext, points: Tensor) -> Tensor:
        return dense(self.proj_layer_3d_fine,
                     self.query(ctx, points, level="fine", K=1)["feature_agg"], self.dtype)

    def render_neighbours(self, ctx, rays_o, rays_d, z_vals, xyz, proj):
        """No neighbour search: query() ignores neighbours."""
        return None, None, None
