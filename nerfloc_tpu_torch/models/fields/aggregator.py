"""Multi-view feature aggregation with NeuRay visibility weighting
(counterpart of nerfloc_tpu/models/fields/aggregator.py), the NeuRay alpha
weights of the guided render pass, and the support views' depth
supervision. The render path samples either the 4-corner tables, the
merged render table, or (render.prune_views) each sample's most visible
views only.

`dtype` is the compute dtype (models/lowp.py) of the decoder and the
output head. Samples of bf16 tables come out bf16 (the packed render
tables) or f32 (bilinear blends of bf16 maps with f32 weights, as in the
context build); the visibility decode is f32 and is cast to the samples'
dtype before the fusion, which runs in that dtype.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.interp import (bilinear_sample_views, bilinear_sample_views_map_grad, nearest_indices,
                           packed_bilinear_sample_selected, packed_bilinear_sample_views,
                           sample_render_table)
from ...ops.knn import topk_first
from ..lowp import F32, const, dense
from . import neuray
from .projector import Projection, compute_projections, feature_uv, project_and_sample

Tensor = torch.Tensor
ALPHA_GROUND_STATE = -15.0   # alpha logit of empty space (guided sampling)


class SupportViews(NamedTuple):
    images: Tensor        # [V, H, W, 3]
    depths: Tensor        # [V, H, W]
    poses: Tensor         # [V, 4, 4] c2w
    Ks: Tensor            # [V, 3, 3]
    vis_featmaps: Tensor  # [V, H/4, W/4, 32]
    near: Tensor          # 0-d
    far: Tensor           # 0-d


def fused_mean_variance(x: Tensor, weight: Tensor):
    if x.dtype != F32:
        # bf16: the products go unrounded into f32 sums, rounded after
        mean = torch.sum(x.float() * weight.float(), dim=1, keepdim=True).to(x.dtype)
        sq = (x - mean) ** 2
        return mean, torch.sum(weight.float() * sq.float(), dim=1, keepdim=True).to(x.dtype)
    mean = torch.sum(x * weight, dim=1, keepdim=True)
    var = torch.sum(weight * (x - mean) ** 2, dim=1, keepdim=True)
    return mean, var


def _rf_valid(proj, H: int, W: int) -> Tensor:
    u, v = proj.uv[..., 0], proj.uv[..., 1]
    return ((torch.abs(proj.depth) >= 1e-4) & (u >= -0.5) & (u < W - 0.5)
            & (v >= -0.5) & (v < H - 0.5))


class MultiviewFeatureAggregator(nn.Module):
    def __init__(self, feat_channels: int, out_channels: int = 128,
                 hidden_dim: int = 64, dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.dist_decoder = neuray.MixtureLogisticsDistDecoder(dtype=dtype)
        self.out_fc1 = nn.Linear(2 * (3 + feat_channels) + 3, hidden_dim)
        self.out_fc2 = nn.Linear(hidden_dim, out_channels)

    def _decode_visibility(self, sv: SupportViews, ray_feats: Tensor,
                           prj_depth: Tensor, valid: Tensor):
        mean, var, vis_d, aw = self.dist_decoder(ray_feats)
        ref_depths = neuray.decode_ref_depths(mean, sv.near, sv.far)
        depth_diff = torch.abs(prj_depth - ref_depths) / (sv.far - sv.near)
        visibility = neuray.compute_visibility(
            prj_depth[..., None], mean, var, vis_d, aw, sv.near, sv.far)
        return visibility * valid.to(visibility.dtype), depth_diff

    def _sample_ray_feats(self, sv: SupportViews, xyz: Tensor,
                          vis_packed: Optional[Tensor] = None):
        """Project [N, 3] points into every view and sample the ray
        features there -> (ray_feats [V, N, 32], depth [V, N], valid [V, N]).
        vis_packed: pack_bilinear_corners table of sv.vis_featmaps."""
        V, H, W = sv.images.shape[:3]
        proj = compute_projections(xyz, sv.Ks, sv.poses, H, W)
        valid = _rf_valid(proj, H, W)
        h, w = sv.vis_featmaps.shape[1:3]
        uv_f = feature_uv(proj.uv, h, w, H, W)
        if vis_packed is not None:
            ray_feats = packed_bilinear_sample_views(vis_packed, h, w, uv_f)
        else:
            ray_feats = bilinear_sample_views(sv.vis_featmaps, uv_f)
        ray_feats = ray_feats * valid[..., None].to(ray_feats.dtype)
        return ray_feats, proj.depth, valid

    def predict_visibility(self, sv: SupportViews, xyz: Tensor):
        """(vis [V, N], depth_diff [V, N]) of world points."""
        return self._decode_visibility(sv, *self._sample_ray_feats(sv, xyz))

    def predict_ref_depths(self, sv: SupportViews) -> Tensor:
        """Depth maps [V, h, w] of the support views decoded from their ray
        features (first mixture mean)."""
        V, h, w, C = sv.vis_featmaps.shape
        mean = self.dist_decoder.predict_mean(sv.vis_featmaps.reshape(V, h * w, C))
        return neuray.decode_ref_depths(mean, sv.near, sv.far).reshape(V, h, w)

    def ref_depth_loss(self, sv: SupportViews, depths_gt: Tensor) -> Tensor:
        """Mean squared error of the decoded depths against depths_gt [V, H, W]
        (nearest-resized to [V, h, w]) in inverse-normalized depth, over the
        pixels with depth > 0."""
        pred = self.predict_ref_depths(sv)
        V, h, w = pred.shape
        yi = nearest_indices(depths_gt.shape[1], h, pred.device)
        xi = nearest_indices(depths_gt.shape[2], w, pred.device)
        gt = depths_gt[:, yi][:, :, xi]
        mask = (gt > 0).to(pred.dtype)
        gt_n = neuray.to_inverse_normalized_depth(gt, sv.near, sv.far)
        pd_n = neuray.to_inverse_normalized_depth(pred, sv.near, sv.far)
        return torch.sum((gt_n - pd_n) ** 2 * mask) / torch.clamp(torch.sum(mask), min=1.0)

    def predict_alpha_weights(self, sv: SupportViews, que_pts: Tensor,
                              que_dists: Tensor, vis_packed: Optional[Tensor] = None
                              ) -> Tensor:
        """Volume-rendering weights [rn, dn] along rays from the NeuRay
        alphas of the support views: que_pts [rn, dn, 3], que_dists [rn, dn]
        intervals in inverse-normalized depth. Views that do not see a
        sample vote the ground-state logit; a sample no view sees gets it."""
        rn, dn, _ = que_pts.shape
        ray_feats, prj_depth, valid = self._sample_ray_feats(
            sv, que_pts.reshape(rn * dn, 3), vis_packed)
        mean, var, vis_d, aw = self.dist_decoder(ray_feats)
        V = ray_feats.shape[0]
        alpha_logit, visibility, _ = neuray.compute_alpha_prob(
            prj_depth.reshape(V, rn, dn), que_dists[None].expand(V, rn, dn),
            mean.reshape(V, rn, dn, 2), var.reshape(V, rn, dn, 2),
            vis_d.reshape(V, rn, dn, 1), aw.reshape(V, rn, dn, 1), sv.near, sv.far)
        m = valid.reshape(V, rn, dn).to(alpha_logit.dtype)
        alphas = alpha_logit * m + (1.0 - m) * ALPHA_GROUND_STATE
        vis = visibility * m
        alphas = torch.sum(alphas * vis, dim=0) / torch.clamp(torch.sum(vis, dim=0), min=1e-8)
        alphas = torch.where(torch.sum(m, dim=0) == 0,
                             torch.full_like(alphas, ALPHA_GROUND_STATE), alphas)
        a = torch.sigmoid(alphas)
        shifted = torch.cat([torch.ones_like(a[:, :1]), 1.0 - a[:, :-1]], dim=-1)
        return a * torch.cumprod(shifted, dim=-1)

    def forward(self, sv: SupportViews, featmaps: Tensor, xyz: Tensor,
                fused_packed=None, rgb_packed: Optional[Tensor] = None,
                proj: Optional[Projection] = None, render_table: Optional[Tensor] = None,
                samples=None, feat_packed=None, vis_packed=None, prune_k: int = 0):
        """-> (out [N, out_channels], rgb_feat [N, Vk, 3+C], vis [N, Vk, 1],
        view_sel [N, Vk] or None): Vk = V, or prune_k views when pruning.

        fused_packed/rgb_packed: pack_bilinear_corners tables of
        [featmaps | vis_featmaps] (or its QuantTable) and sv.images (the
        scene context's); render_table: the merged render table, which
        takes fused_packed's place; samples: (rgb [V, N, 3], fused
        [V, N, C+32]) already sampled from it by the caller; feat_packed,
        vis_packed and prune_k > 0: the pruned path (_aggregate_pruned).
        proj: the projection of xyz when the caller already has it (used
        only where featmaps share the visibility maps' resolution; samples
        and pruning need it)."""
        V, H, W = sv.images.shape[:3]
        C = featmaps.shape[-1]
        if prune_k and feat_packed is not None and proj is not None:
            return self._aggregate_pruned(sv, featmaps, proj, feat_packed, rgb_packed,
                                          vis_packed, prune_k)
        if featmaps.shape[1:3] == sv.vis_featmaps.shape[1:3]:
            if proj is None:
                if samples is not None:
                    raise ValueError("samples requires the matching proj")
                proj = compute_projections(xyz, sv.Ks, sv.poses, H, W)
            h, w = featmaps.shape[1:3]
            uv_f = feature_uv(proj.uv, h, w, H, W)
            if samples is not None:
                rgb, fused = samples
            elif render_table is not None and rgb_packed is not None:
                fused = sample_render_table(render_table, C + sv.vis_featmaps.shape[-1],
                                            H, W, h, w, proj.uv)[0]
                rgb = packed_bilinear_sample_views(rgb_packed, H, W, proj.uv)
            elif fused_packed is not None and rgb_packed is not None:
                rgb = packed_bilinear_sample_views(rgb_packed, H, W, proj.uv)
                fused = packed_bilinear_sample_views(fused_packed, h, w, uv_f)
            else:
                rgb = bilinear_sample_views(sv.images, proj.uv)
                fused = bilinear_sample_views_map_grad(
                    torch.cat([featmaps, sv.vis_featmaps], dim=-1), uv_f)
            feat, ray_feats = fused[..., :C], fused[..., C:]
            valid = _rf_valid(proj, H, W)
            ray_feats = ray_feats * valid[..., None].to(ray_feats.dtype)
            vis, depth_diff = self._decode_visibility(sv, ray_feats, proj.depth, valid)
            rgb, feat = rgb.transpose(0, 1), feat.transpose(0, 1)
        else:
            rgb, feat, _ = project_and_sample(xyz, sv.Ks, sv.poses, sv.images, featmaps)
            vis, depth_diff = self.predict_visibility(sv, xyz)
        rgb_feat = torch.cat([rgb, feat], dim=-1)
        vis = vis.transpose(0, 1)[..., None].to(rgb_feat.dtype)
        out = self._fuse(rgb_feat, vis,
                         depth_diff.transpose(0, 1)[..., None].to(rgb_feat.dtype))
        return out, rgb_feat, vis, None

    def _aggregate_pruned(self, sv: SupportViews, featmaps: Tensor, proj: Projection,
                          feat_packed, rgb_packed: Tensor, vis_packed, prune_k: int):
        """render.prune_views: the visibility of every view from the 32-ch
        vis table, then the feature and rgb rows of each sample's
        min(prune_k, V) most visible views only (ties to the lower view),
        fused over those. prune_k >= V gives the unpruned result up to the
        order of the views."""
        V, H, W = sv.images.shape[:3]
        h, w = featmaps.shape[1:3]
        ray_feats = packed_bilinear_sample_views(vis_packed, h, w,
                                                 feature_uv(proj.uv, h, w, H, W))
        valid = _rf_valid(proj, H, W)
        ray_feats = ray_feats * valid[..., None].to(ray_feats.dtype)
        vis_all, dd_all = self._decode_visibility(sv, ray_feats, proj.depth, valid)
        vis_T = vis_all.T.float()                                       # [N, V]
        sel = topk_first(vis_T, min(prune_k, V))[1]                     # [N, k]
        uv_sel = torch.gather(proj.uv.transpose(0, 1), 1,
                              sel[..., None].expand(-1, -1, 2))         # [N, k, 2]
        feat = packed_bilinear_sample_selected(feat_packed, h, w,
                                               feature_uv(uv_sel, h, w, H, W), sel)
        rgb = packed_bilinear_sample_selected(rgb_packed, H, W, uv_sel, sel)
        rgb_feat = torch.cat([rgb, feat], dim=-1)
        vis = torch.gather(vis_T, 1, sel)[..., None].to(rgb_feat.dtype)
        depth_diff = torch.gather(dd_all.T.float(), 1, sel)[..., None].to(rgb_feat.dtype)
        return self._fuse(rgb_feat, vis, depth_diff), rgb_feat, vis, sel

    def _fuse(self, rgb_feat: Tensor, vis: Tensor, depth_diff: Tensor) -> Tensor:
        if vis.dtype == F32:
            weight = vis / (torch.sum(vis, dim=1, keepdim=True) + 1e-8)
            w_mean = torch.mean(weight, dim=1)
        else:
            vsum = torch.sum(vis.float(), dim=1, keepdim=True).to(vis.dtype)
            weight = vis / (vsum + const(1e-8, vis))
            w_mean = torch.mean(weight.float(), dim=1).to(vis.dtype)
        rf_mean, rf_var = fused_mean_variance(rgb_feat, weight)
        dd_mean, dd_var = fused_mean_variance(depth_diff, weight)
        globalfeat = torch.cat([rf_mean, rf_var, dd_mean, dd_var], dim=-1)[:, 0]
        feat_agg = torch.cat([globalfeat, w_mean], dim=-1)
        dt = self.dtype
        return F.elu(dense(self.out_fc2, F.elu(dense(self.out_fc1, feat_agg, dt)), dt))
