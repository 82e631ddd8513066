"""Conditional NeRF (counterpart of
nerfloc_tpu/models/fields/conditional_nerf.py): `MLP`, `_backproject_level`,
`build_scene_context` with every table mode, `sample_keypoints`, `query`
(fused and unfused, with the render branch and the one-hot geometry
assembly), `query_coarse` (sampled or given points), `query_fine`,
`sample_depths`, `render_rays` (dense and NeuRay-guided sampling, every
`knn_mode`), `render_image` and `sample_pdf_det`.

Gathered neighbour rows: the JAX package packs [xyz|dir|conf] as three
bf16 hi/mid/lo parts (exact to f32) and the features as bf16, because TPU
row gathers of f32 are slow. The port gathers the f32 geometry directly and
the features from a bf16 copy of their table, so its outputs match.

`dtype` is the compute dtype (models/lowp.py): at bf16 the MLPs, the
aggregator, the NeuRay encoder and the ray U-Net run in bf16, the points'
descriptors and the sampling tables are bf16 while their geometry stays
f32, and the fused aggregation takes bf16 mv_agg and neighbour features
(its bf16 instantiation). With cfg.use_scene_coord_memorization the
descriptors add the coordinate heads' MLP of the frequency-embedded point.

The neighbour aggregation on the card is always the fused kernel
(ops/fused_agg.py, the port of the JAX package's Pallas kernel): it is the
port's form of that step on CUDA, whatever `render.fused_query_agg` says.
On the CPU the flag picks between the reference's two formulations, the
fused one's plain version and the unfused modules, as in JAX.

The render options (cfg.render): `knn_mode` picks the samples'
neighbours, by the featmap window around their projections ('proj',
ops/knn.knn_proj, or the merged table's 5x5 window with
`use_merged_table`), by per-ray candidates ('ray', ops/knn.knn_rays, whose
candidates `geo_assembly='onehot'` turns into per-ray tables selected by a
one-hot product) or by exact KNN over the fine points ('flat');
`prune_views` keeps each sample's most visible views; `table_dtype='int8'`
stores the feature tables as int8 (no gradient through the rounding, so
for inference). Every option ends in the same `query()` tail, the fused
kernel on the card.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...configs import Config
from ...geometry.cameras import (backproject_depth, camera_dirs, get_rays, scale_intrinsics,
                                 views_times, world_to_camera)
from ...geometry.embedder import Embedder
from ...geometry.math import safe_normalize, safe_sqrt
from ...ops.fused_agg import extract_agg_params, fused_neighbor_agg
from ...ops.interp import (nearest_indices, pack_bilinear_corners, pack_render_table,
                           packed_bilinear_sample_views, quantize_pack_bilinear_corners,
                           sample_render_table)
from ...ops.knn import (knn, knn_from_candidate_planes, knn_gather, knn_proj, knn_rays,
                        pack_xyz_window, split_bf16x3, topk_first, xyz_window_channels)
from ..lowp import F32, add_bias, dense, leaky_relu, sigmoid, softmax, softplus
from ..transformer import MultiHeadAttention
from .aggregator import MultiviewFeatureAggregator, SupportViews
from .context import NeuralPoints, SceneContext
from .neuray import DepthFusionNet, depth2inv_dists
from .projector import Projection, compute_angle, compute_projections
from .ray_unet import RayUnet

Tensor = torch.Tensor


def _leaky(y: Tensor) -> Tensor:
    return leaky_relu(y, 0.01)


_ACT = {"leaky_relu": _leaky, "relu": F.relu, "sigmoid": sigmoid,
        "softplus": softplus, None: lambda y: y}


def _linspace01(n: int, like: Tensor) -> Tensor:
    """n points from 0 to 1 as jnp.linspace computes them (i / (n-1))."""
    return torch.arange(n, dtype=like.dtype, device=like.device) / max(n - 1, 1)


class MLP(nn.Module):
    """Linear layers fc0..fcN with `activation` (leaky ReLU 0.01 or ReLU)
    between them and an optional final activation, in the compute dtype."""

    def __init__(self, cin: int, features: Sequence[int],
                 final_activation: Optional[str] = None,
                 activation: str = "leaky_relu", dtype: torch.dtype = F32):
        super().__init__()
        dims = [cin, *features]
        for i in range(len(features)):
            setattr(self, f"fc{i}", nn.Linear(dims[i], dims[i + 1]))
        self.n = len(features)
        self.act = _ACT[activation]
        self.final = _ACT[final_activation]
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        for i in range(self.n):
            x = dense(getattr(self, f"fc{i}"), x, self.dtype)
            x = self.act(x) if i < self.n - 1 else self.final(x)
        return x


class ConditionalNeRF(nn.Module):
    RENDER_HEADS = ("ray_unet", "sigma_mlp", "feat_mlp", "rgb_blending_mlp", "beta_mlp")

    def __init__(self, cfg: Config, dtype: torch.dtype = F32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        W = cfg.model_3d_hidden_dim
        C = cfg.backbone2d_fpn_dim
        hd = cfg.matcher_hidden_dim
        self.feat_dim = 3 + C                       # rgb + backbone feature
        self.xyz_embed = Embedder(cfg.multires)
        self.view_embed = Embedder(cfg.multires_views)
        self.register_buffer("freqs", torch.tensor(self.xyz_embed.freqs),
                             persistent=False)
        self.ray_diff_fc = MLP(4, (16, self.view_embed.out_dim),
                               final_activation="leaky_relu", dtype=dtype)
        self.multiview_aggregator = MultiviewFeatureAggregator(C, out_channels=W, dtype=dtype)
        self.depth_fusion = DepthFusionNet(dtype)
        self.confidence_mlp = MLP(W, (64, 1), final_activation="sigmoid", dtype=dtype)
        self.keypoint_head = MLP(C, (1,), final_activation="sigmoid", dtype=dtype)
        self.base_mlp = MLP(self.feat_dim + self.xyz_embed.out_dim + self.view_embed.out_dim,
                            (W, W, W), final_activation="leaky_relu", dtype=dtype)
        self.base_mlp_attn = MultiHeadAttention(4, W, 32, 32, dtype)
        self.proj_layer_3d_coarse = nn.Linear(W + self.feat_dim, hd)
        self.proj_layer_3d_fine = nn.Linear(W + self.feat_dim, hd)
        if cfg.use_scene_coord_memorization:
            # per-scene coordinate heads on the embedded point
            self.coord_desc_mlp_coarse = MLP(self.xyz_embed.out_dim, (W, W, hd),
                                             activation="relu", dtype=dtype)
            self.coord_desc_mlp_fine = MLP(self.xyz_embed.out_dim, (W, W, hd),
                                           activation="relu", dtype=dtype)
        # render heads (RENDER_HEADS)
        self.ray_unet = RayUnet(W, cfg.render.N_samples + cfg.render.N_importance, dtype)
        self.sigma_mlp = MLP(W, (1,), final_activation="softplus", dtype=dtype)
        if cfg.render.render_feature:
            self.feat_mlp = MLP(W, (W, C), dtype=dtype)
        # input rows: [feature_agg | mv_feat (rgb + feature) | mv_vis | ray_diff]
        self.rgb_blending_mlp = MLP(W + self.feat_dim + 1 + 4, (32, 16, 1), dtype=dtype)
        if cfg.render.use_render_uncertainty:
            self.beta_mlp = MLP(W, (1,), final_activation="softplus", dtype=dtype)
        self.beta_min = 0.1

    # -- scene context ------------------------------------------------------

    def _backproject_level(self, sv: SupportViews, featmaps: Tensor,
                           stride: int) -> NeuralPoints:
        """Every featmap pixel of every view becomes a point (mask depth>0),
        all views at once."""
        V, H, Wd = sv.depths.shape
        h, w = H // stride, Wd // stride
        Ks = scale_intrinsics(sv.Ks, float(stride))
        yi = nearest_indices(H, h, sv.depths.device)
        xi = nearest_indices(Wd, w, sv.depths.device)
        d = sv.depths[:, yi][:, :, xi]
        im = sv.images[:, yi][:, :, xi]
        pts_w, mask = backproject_depth(d, Ks, sv.poses)
        pts_w = pts_w.reshape(-1, 3)
        rays_d = views_times(camera_dirs(h, w, Ks).reshape(V, h * w, 3),
                             sv.poses[:, :3, :3].transpose(-1, -2))
        rays_d = (rays_d / torch.linalg.vector_norm(rays_d, dim=-1, keepdim=True)
                  ).reshape(V, h, w, 3)
        feature = torch.cat([im.to(self.dtype), featmaps.to(self.dtype)],
                            dim=-1).reshape(V * h * w, -1)
        return NeuralPoints(xyz=pts_w, xyz_ndc=world_to_camera(sv.poses[0], pts_w),
                            feature=feature,
                            confidence=torch.ones_like(feature[:, :1]),
                            direction=torch.cat([rays_d, d[..., None]], dim=-1).reshape(-1, 4),
                            mask=mask.reshape(-1))

    def build_scene_context(self, images: Tensor, depths: Tensor, poses: Tensor,
                            Ks: Tensor, near: Tensor, far: Tensor,
                            feat_coarse_src: Tensor, feat_fine_src: Tensor,
                            stride_coarse: int, stride_fine: int) -> SceneContext:
        vis_featmaps = self.depth_fusion(images, depths, Ks, poses, near, far)
        sv = SupportViews(images=images, depths=depths, poses=poses, Ks=Ks,
                          vis_featmaps=vis_featmaps, near=near, far=far)
        coarse = self._backproject_level(sv, feat_coarse_src, stride_coarse)
        fine = self._backproject_level(sv, feat_fine_src, stride_fine)

        mv_feat = self.multiview_aggregator(sv, feat_fine_src, fine.xyz)[0]
        conf_f = self.confidence_mlp(mv_feat)
        fine = fine.replace(confidence=conf_f * fine.mask[:, None].to(conf_f.dtype))
        coarse = coarse.replace(kp_score=self.keypoint_head(coarse.feature[:, 3:]))
        return self.assemble_context(sv, coarse, fine, feat_coarse_src, feat_fine_src)

    def assemble_context(self, sv: SupportViews, coarse: NeuralPoints,
                         fine: NeuralPoints, feat_coarse_src: Tensor,
                         feat_fine_src: Tensor) -> SceneContext:
        """The scene context with its sampling tables, as the render options
        choose them where the fine featmaps share the visibility maps'
        resolution: the merged render table (use_merged_table with
        knn_mode 'proj'), or the feature-only table of the pruned path
        (prune_views > 0), or the 4-corner table of [fine features | ray
        features]; int8 (table_dtype) for the feature tables. Always the
        images' 4-corner table; the knn_proj window table unless the merged
        table holds the window; the ray features' table for guided sampling
        and pruning."""
        r = self.cfg.render
        V = sv.images.shape[0]
        hf, wf = feat_fine_src.shape[1:3]
        dt = self.dtype
        int8 = r.table_dtype == "int8"
        res_match = feat_fine_src.shape[1:3] == sv.vis_featmaps.shape[1:3]
        use_merged = r.use_merged_table and res_match and r.knn_mode == "proj"
        use_pruned = r.prune_views > 0 and res_match and not use_merged
        fused_fine_packed = render_table = xyz_window_packed = None
        feat_fine_packed = vis_corner_packed = None
        if use_pruned:
            feat_only = feat_fine_src.to(dt)
            feat_fine_packed = quantize_pack_bilinear_corners(feat_only, dt) if int8 \
                else pack_bilinear_corners(feat_only)
        elif res_match:
            fused = torch.cat([feat_fine_src.to(dt), sv.vis_featmaps.to(dt)], dim=-1)
            if use_merged:
                render_table = pack_render_table(fused, xyz_window_channels(
                    fine.xyz.reshape(V, hf, wf, 3), fine.mask.reshape(V, hf, wf)))
            elif int8:
                fused_fine_packed = quantize_pack_bilinear_corners(fused, dt)
            else:
                fused_fine_packed = pack_bilinear_corners(fused)
        if not use_merged:
            xyz_window_packed = pack_xyz_window(fine.xyz.reshape(V, hf, wf, 3),
                                                fine.mask.reshape(V, hf, wf),
                                                win=r.knn_proj_window)
        if r.N_importance > 0 or use_pruned:
            vis_corner_packed = quantize_pack_bilinear_corners(sv.vis_featmaps, dt) if int8 \
                else pack_bilinear_corners(sv.vis_featmaps.to(dt))
        return SceneContext(sv=sv, coarse=coarse, fine=fine,
                            feat_coarse_src=feat_coarse_src,
                            feat_fine_src=feat_fine_src,
                            fused_fine_packed=fused_fine_packed,
                            rgb_packed=pack_bilinear_corners(sv.images.to(dt)),
                            xyz_window_packed=xyz_window_packed,
                            vis_corner_packed=vis_corner_packed,
                            render_table=render_table,
                            feat_fine_packed=feat_fine_packed)

    # -- keypoints ----------------------------------------------------------

    def sample_keypoints(self, ctx: SceneContext, num: int, gumbel: Tensor):
        """Gumbel top-k over log keypoint scores (multinomial without
        replacement); invalid picks become the best valid point.
        gumbel: [P_coarse] standard Gumbel noise."""
        score = ctx.coarse.kp_score[:, 0]
        logits = torch.where(ctx.coarse.mask, torch.log(torch.clamp(score, min=1e-12)),
                             torch.full_like(score, float("-inf")))
        _, idx = topk_first(logits + gumbel.to(logits.dtype), num)
        best = torch.argmax(logits)
        idx = torch.where(ctx.coarse.mask[idx], idx, best)
        return ctx.coarse.xyz[idx], ctx.coarse.xyz_ndc[idx], idx

    # -- querying -----------------------------------------------------------

    @staticmethod
    def gather_neighbours(points: NeuralPoints, idx: Tensor):
        """(xyz [N,K,3], direction [N,K,4], confidence [N,K,1], feature
        [N,K,F]) of the neighbours idx [N, K]; features rounded to bf16 as
        the JAX package's gather table stores them."""
        feature = points.feature.to(torch.bfloat16)
        return (knn_gather(points.xyz, idx), knn_gather(points.direction, idx),
                knn_gather(points.confidence, idx),
                knn_gather(feature, idx).to(points.feature.dtype))

    @staticmethod
    def assemble_neighbours(points: NeuralPoints, cand_idx: Tensor, local_idx: Tensor):
        """gather_neighbours of idx = cand_idx gathered at local_idx, from
        per-ray candidate tables (geo_assembly='onehot'): cand_idx [R, C]
        rows of [xyz | direction | confidence] as split_bf16x3 parts, the
        mask and the bf16 features, selected for each of the S*K
        neighbours of a ray by a one-hot product. The product runs in f32,
        so each selected value passes through exactly, and the parts are
        summed as the JAX package sums them. -> (xyz, direction,
        confidence, feature, mask [N, K]), N = R*S."""
        R, C = cand_idx.shape
        S, K = local_idx.shape[1:]
        g8 = torch.cat([points.xyz, points.direction, points.confidence.float()], dim=-1)
        hi, mid, lo = split_bf16x3(g8)
        bf = torch.bfloat16
        table = torch.cat([hi, mid, lo, points.mask[:, None].to(bf),
                           points.feature.to(bf)], dim=-1)               # [M, 25+F]
        cand = table[torch.clamp(cand_idx, 0, table.shape[0] - 1)]      # [R, C, 25+F]
        oh = local_idx.reshape(R, S * K, 1) == torch.arange(C, device=cand_idx.device)
        nb = (oh.float() @ cand.float()).reshape(R * S, K, -1)
        g = nb[..., :8] + nb[..., 8:16] + nb[..., 16:24]
        return (g[..., :3], g[..., 3:7], g[..., 7:8], nb[..., 25:].to(points.feature.dtype),
                nb[..., 24] > 0.5)

    def query(self, ctx: SceneContext, xyz: Tensor, level: str, K: int,
              direction: Optional[Tensor] = None, knn_idx: Optional[Tensor] = None,
              proj: Optional[Projection] = None, cand=None, mv_samples=None
              ) -> Dict[str, Tensor]:
        """Aggregate a descriptor for [N, 3] points from their K nearest
        neural points and the multiview features.

        Render branch: knn_idx [N, K] are the neighbours (from knn_proj,
        the merged table's window or knn_rays); without it, the exact KNN
        among the level's points. Their distances come from the gathered
        points, masked ones at finfo.max/4. cand: (cand_idx [R, C],
        local_idx [R, S, K]) of knn_rays, R*S == N, for the one-hot
        assembly. direction [N, >=3] is the query direction (ray direction
        and depth); without it, the nearest neighbour's. proj is the
        projection of xyz, shared with the caller; mv_samples (rgb, fused)
        the merged table's samples at it. The output's view_sel [N, k] is
        each sample's views under render.prune_views (None otherwise)."""
        points = ctx.coarse if level == "coarse" else ctx.fine
        featmaps = ctx.feat_coarse_src if level == "coarse" else ctx.feat_fine_src
        fine = level == "fine"
        mv_agg, mv_feat, mv_vis, view_sel = self.multiview_aggregator(
            ctx.sv, featmaps, xyz, proj=proj,
            fused_packed=ctx.fused_fine_packed if fine else None,
            rgb_packed=ctx.rgb_packed if fine else None,
            render_table=ctx.render_table if fine else None, samples=mv_samples,
            feat_packed=ctx.feat_fine_packed if fine else None,
            vis_packed=ctx.vis_corner_packed if fine else None,
            prune_k=self.cfg.render.prune_views if fine else 0)

        idx = knn_idx
        if cand is not None:
            nb_xyz, nb_dir, nb_conf, nb_feat, nb_mask = self.assemble_neighbours(points, *cand)
        else:
            if idx is None:
                d2, idx = knn(xyz, points.xyz, K=K, points_mask=points.mask)
            nb_xyz, nb_dir, nb_conf, nb_feat = self.gather_neighbours(points, idx)
            nb_mask = knn_gather(points.mask, idx) if knn_idx is not None else None
        if nb_mask is not None:
            d = xyz[:, None, :] - nb_xyz
            d2 = torch.where(nb_mask, torch.sum(d * d, dim=-1), torch.finfo(d.dtype).max / 4)
        dists = safe_sqrt(d2)
        if direction is None:
            direction = nb_dir[:, 0, :]
        scale = ctx.sv.far - ctx.sv.near

        if self.cfg.render.fused_query_agg or xyz.is_cuda:
            params = extract_agg_params(self, nb_feat.shape[-1])
            feature_agg = fused_neighbor_agg(xyz, direction.contiguous(), mv_agg,
                                             nb_xyz.contiguous(), nb_dir.contiguous(),
                                             nb_feat.contiguous(), scale, params, self.freqs)
        else:
            dt = self.dtype
            ray_diff = safe_normalize(direction[:, None, :3] - nb_dir[..., :3])
            ray_dot = torch.sum(direction[:, None, :3] * nb_dir[..., :3], dim=-1,
                                keepdim=True)
            # f32 phases and sin/cos, only the embedding cast down
            point_feature = self.base_mlp(torch.cat([
                nb_feat,
                self.xyz_embed((xyz[:, None, :] - nb_xyz) / scale).to(dt),
                self.ray_diff_fc(torch.cat([ray_diff, ray_dot], dim=-1).to(dt)),
            ], dim=-1))
            feature_agg = self.base_mlp_attn(mv_agg[:, None, :], point_feature,
                                             point_feature)[:, 0]
        weights = (1.0 / torch.clamp(dists, min=1e-8)) * nb_conf[..., 0]
        weights = weights / torch.clamp(weights.sum(dim=1, keepdim=True), min=1e-8)
        return {
            "feature_agg": feature_agg,
            "feature": feature_agg[:, None, :].expand(-1, K, -1),
            "weights": weights,
            "multiview_feature": mv_feat,
            "multiview_visibility": mv_vis,
            "view_sel": view_sel,
        }

    def query_coarse(self, ctx: SceneContext, gumbel: Optional[Tensor] = None,
                     points: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor]:
        """-> (desc [N, hidden], pts3d, pts3d_ndc) for Gumbel-sampled coarse
        points (gumbel [P_coarse]), or for given points [N, 3] (the SfM
        keypoints), whose 2D feature is their nearest coarse point's."""
        if points is None:
            pts3d, pts3d_ndc, sample_idx = self.sample_keypoints(
                ctx, self.cfg.matching.fine_num_3d_keypoints, gumbel)
            feature_2d = ctx.coarse.feature[sample_idx]
        else:
            pts3d, pts3d_ndc = points, world_to_camera(ctx.sv.poses[0], points)
            _, idx = knn(points, ctx.coarse.xyz, K=1, points_mask=ctx.coarse.mask)
            feature_2d = knn_gather(ctx.coarse.feature, idx)[:, 0]
        qd = self.query(ctx, pts3d, level="coarse", K=8)
        desc = dense(self.proj_layer_3d_coarse, torch.cat([qd["feature_agg"], feature_2d], dim=1),
                     self.dtype)
        if self.cfg.use_scene_coord_memorization:
            desc = desc + self.coord_desc_mlp_coarse(self.xyz_embed(pts3d))
        return desc, pts3d, pts3d_ndc

    def query_fine(self, ctx: SceneContext, points: Tensor) -> Tensor:
        _, idx = knn(points, ctx.fine.xyz, K=1, points_mask=ctx.fine.mask)
        feature_2d = knn_gather(ctx.fine.feature, idx)[:, 0]
        qd = self.query(ctx, points, level="fine", K=1)
        desc = dense(self.proj_layer_3d_fine, torch.cat([qd["feature_agg"], feature_2d], dim=1),
                     self.dtype)
        if self.cfg.use_scene_coord_memorization:
            desc = desc + self.coord_desc_mlp_fine(self.xyz_embed(points))
        return desc

    # -- rendering ----------------------------------------------------------

    def sample_depths(self, n: int, near: Tensor, far: Tensor) -> Tensor:
        """n depths from near to far, evenly spaced (or in inverse depth
        with render.lindisp)."""
        t = _linspace01(n, near)
        if not self.cfg.render.lindisp:
            return near * (1.0 - t) + far * t
        return 1.0 / (1.0 / near * (1.0 - t) + 1.0 / far * t)

    def ray_depths(self, ctx: SceneContext, rays_o: Tensor, rays_d: Tensor
                   ) -> Tuple[Tensor, Optional[Tensor]]:
        """(z_vals [R, S], depth_coarse [R] or None). Dense: N_samples even
        depths. Guided (N_importance > 0): NeuRay alpha weights at N_guide
        depths place N_importance more samples by inverse CDF, merged into
        the dense ones by a sort."""
        r = self.cfg.render
        near, far = ctx.sv.near, ctx.sv.far
        R = rays_o.shape[0]
        z_vals = self.sample_depths(r.N_samples, near, far).expand(R, -1)
        if r.N_importance == 0:
            return z_vals, None
        z_c = self.sample_depths(r.N_guide, near, far).expand(R, -1)
        que_pts = rays_o[:, None, :] + rays_d[:, None, :] * z_c[..., None]
        w_c = self.multiview_aggregator.predict_alpha_weights(
            ctx.sv, que_pts, depth2inv_dists(z_c, near, far),
            vis_packed=ctx.vis_corner_packed)
        z_mid = 0.5 * (z_c[:, :-1] + z_c[:, 1:])
        z_fine = sample_pdf_det(z_mid, w_c[:, 1:-1].detach(), r.N_importance)
        z_vals = torch.sort(torch.cat([z_vals, z_fine], dim=-1), dim=-1)[0]
        return z_vals, torch.sum(w_c * z_c, dim=-1)

    def render_neighbours(self, ctx: SceneContext, rays_o: Tensor, rays_d: Tensor,
                          z_vals: Tensor, xyz: Tensor, proj: Projection):
        """(knn_idx [N, 8] or None, cand or None, mv_samples or None) of the
        R*S samples xyz [N, 3] by render.knn_mode: 'proj' windows around
        the projection in featmap pixels (image uv / stride) of the
        knn_proj table, or with the merged table its 5x5 window, whose
        fused samples the aggregator then reuses; 'ray' knn_rays (bf16
        selection) with its candidates for the one-hot assembly; 'flat'
        none, so query() runs the exact KNN."""
        r = self.cfg.render
        Hs, Ws = ctx.sv.images.shape[1:3]
        hf, wf = ctx.feat_fine_src.shape[1:3]
        if r.knn_mode == "proj":
            if ctx.render_table is None:
                return knn_proj(xyz, proj.uv / float(Hs // hf), proj.in_front,
                                ctx.xyz_window_packed, hf, wf, K=8,
                                win=r.knn_proj_window), None, None
            Cf = ctx.feat_fine_src.shape[-1] + ctx.sv.vis_featmaps.shape[-1]
            fused_s, cx, cy, cz, valid, cidx = sample_render_table(
                ctx.render_table, Cf, Hs, Ws, hf, wf, proj.uv)
            idx = knn_from_candidate_planes(xyz, cx, cy, cz, valid & proj.in_front[:, :, None],
                                            cidx, 8)
            rgb_s = packed_bilinear_sample_views(ctx.rgb_packed, Hs, Ws, proj.uv)
            return idx, None, (rgb_s, fused_s)
        if r.knn_mode == "ray":
            onehot = r.geo_assembly == "onehot"
            out = knn_rays(rays_o, rays_d, z_vals, ctx.fine.xyz, K=8,
                           points_mask=ctx.fine.mask, n_candidates=r.knn_candidates,
                           selection_dtype=torch.bfloat16, return_candidates=onehot)
            if onehot:
                idx, cand_idx, local_idx = out
                return idx.reshape(-1, 8), (cand_idx, local_idx), None
            return out.reshape(-1, 8), None, None
        if r.knn_mode == "flat":
            return None, None, None
        raise ValueError(f"render.knn_mode {r.knn_mode!r}: 'proj', 'ray' or 'flat'")

    def blend_views(self, ctx: SceneContext, xyz: Tensor, pose: Tensor,
                    feature_agg: Tensor, mv_feat: Tensor, mv_vis: Tensor,
                    view_sel: Optional[Tensor] = None) -> Tensor:
        """Colour [N, 3] of each sample: a softmax over views of the
        blending MLP's weights on the views' rgb; views that do not see the
        sample are left out. The MLP's first layer runs as partial products
        over its row blocks, so feature_agg enters once per sample and the
        [N, V, W+3+C+5] input is never built. view_sel [N, k]: the views of
        mv_feat's axis under render.prune_views."""
        fc = self.rgb_blending_mlp
        dt = self.dtype
        W, Cf = feature_agg.shape[-1], mv_feat.shape[-1]
        k_fa, k_mv, k_vis, k_rd = fc.fc0.weight.to(dt).split([W, Cf, 1, 4], dim=1)
        ray_diff = compute_angle(xyz, pose, ctx.sv.poses).transpose(0, 1)  # [N, V, 4]
        if view_sel is not None:
            ray_diff = torch.gather(ray_diff, 1, view_sel[..., None].expand(-1, -1, 4))
        if dt == F32:
            h = F.linear(feature_agg, k_fa, fc.fc0.bias)[:, None, :]
            h = h + mv_feat @ k_mv.T + mv_vis * k_vis[:, 0] + ray_diff @ k_rd.T
        else:
            # the partial sums in bf16, each product and sum rounded
            h = add_bias(feature_agg.to(dt) @ k_fa.T, fc.fc0.bias)[:, None, :]
            h = h + mv_feat.to(dt) @ k_mv.T
            h = h + mv_vis.to(dt) * k_vis[:, 0]
            h = h + ray_diff.to(dt) @ k_rd.T
        bw = dense(fc.fc2, _leaky(dense(fc.fc1, _leaky(h), dt)), dt)
        bw = torch.where(mv_vis == 0, torch.full_like(bw, -1e9), bw)
        bw = softmax(bw, dim=1)
        rgb = mv_feat[:, :, :3]
        if bw.dtype == F32:
            return torch.sum(rgb * bw, dim=1)
        return torch.sum(rgb.float() * bw.float(), dim=1).to(bw.dtype)

    def composite(self, z_vals: Tensor, sigma: Tensor, rgb: Tensor
                  ) -> Dict[str, Tensor]:
        """Alpha compositing of [R, S] densities and [R, S, 3] colours
        (last interval 1e2) -> rgb, depth, weights, depth_uncertainty."""
        deltas = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                            torch.full_like(z_vals[:, :1], 1e2)], dim=-1)
        alphas = 1.0 - torch.exp(-deltas * sigma)
        shifted = torch.cat([torch.ones_like(alphas[:, :1]), 1.0 - alphas[:, :-1]], dim=-1)
        weights = alphas * torch.cumprod(shifted, dim=-1)
        rgb_out = torch.sum(weights[..., None] * rgb, dim=1)
        if self.cfg.render.white_bkgd:
            rgb_out = rgb_out + (1.0 - torch.sum(weights, dim=-1)[:, None])
        depth = torch.sum(weights * z_vals, dim=-1)
        return {"rgb": rgb_out, "depth": depth, "weights": weights,
                "depth_uncertainty": torch.sum(weights * (z_vals - depth[:, None]) ** 2,
                                               dim=-1)}

    def render_rays(self, ctx: SceneContext, rays_o: Tensor, rays_d: Tensor,
                    pose: Tensor, train: bool = False) -> Dict[str, Tensor]:
        """Volume-render rays [R, 3] against the scene context; pose is the
        query camera's c2w (for the blending angles).

        One projection of all R*S samples serves the neighbour search
        (render_neighbours), the multiview aggregation and the validity
        mask; the neighbour aggregation is one fused_agg launch at
        N = R*S, K = 8 on the card, whatever the render options.
        Returns rgb [R,3], depth [R], weights [R,S], mask [R] (more than
        min(8, S//2) samples seen by two or more views), depth_uncertainty
        [R], depth_coarse [R] (guided), beta [R] (train) and feat [R,C]
        (render.render_feature)."""
        cfg = self.cfg
        R = rays_o.shape[0]
        z_vals, depth_coarse = self.ray_depths(ctx, rays_o, rays_d)
        S = z_vals.shape[1]
        xyz = (rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]).reshape(-1, 3)
        direction = torch.cat([rays_d[:, None, :].expand(R, S, 3).reshape(-1, 3),
                               z_vals.reshape(-1, 1)], dim=-1)
        H, W = ctx.sv.images.shape[1:3]
        proj = compute_projections(xyz, ctx.sv.Ks, ctx.sv.poses, H, W)
        knn_idx, cand, mv_samples = self.render_neighbours(ctx, rays_o, rays_d, z_vals,
                                                           xyz, proj)
        qd = self.query(ctx, xyz, level="fine", K=8, direction=direction, knn_idx=knn_idx,
                        proj=proj, cand=cand, mv_samples=mv_samples)
        feature_agg = qd["feature_agg"]

        geo = self.ray_unet(feature_agg.reshape(R, S, -1)).reshape(R * S, -1)
        # the density's softplus meets f32 intervals: its last step is f32
        sig = self.sigma_mlp
        sigma = softplus(dense(sig.fc0, geo, sig.dtype), f32_out=True).reshape(R, S)
        rgb = self.blend_views(ctx, xyz, pose, feature_agg, qd["multiview_feature"],
                               qd["multiview_visibility"], qd["view_sel"]).reshape(R, S, 3)
        out = self.composite(z_vals, sigma, rgb)
        seen = (proj.in_front & proj.inbound).T.reshape(R, S, -1).sum(dim=2) > 1
        out["mask"] = seen.sum(dim=1) > min(8, S // 2)
        if depth_coarse is not None:
            out["depth_coarse"] = depth_coarse
        if train and cfg.render.use_render_uncertainty:
            beta = self.beta_mlp(geo).reshape(R, S)
            out["beta"] = torch.sum(out["weights"] * beta, dim=-1) + self.beta_min
        if cfg.render.render_feature:
            feat = self.feat_mlp(feature_agg).reshape(R, S, -1)
            out["feat"] = torch.sum(out["weights"][..., None] * feat, dim=1)
        return out

    def render_image(self, ctx: SceneContext, K: Tensor, pose: Tensor, H: int,
                     W: int) -> Dict[str, Tensor]:
        """Render an H x W frame in chunks of render.chunk rays (the last
        chunk may be short: rays are independent) -> each render_rays
        output as [H, W, ...]."""
        rays_o, rays_d = get_rays(H, W, K, pose)
        rays_o, rays_d = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        chunk = self.cfg.render.chunk
        outs = [self.render_rays(ctx, rays_o[i:i + chunk], rays_d[i:i + chunk], pose)
                for i in range(0, H * W, chunk)]
        return {k: torch.cat([o[k] for o in outs]).reshape((H, W) + outs[0][k].shape[1:])
                for k in outs[0]}


def sample_pdf_det(bins: Tensor, weights: Tensor, N_importance: int,
                   eps: float = 1e-5) -> Tensor:
    """Deterministic inverse-CDF sampling: bins [R, M+1] are bin EDGES and
    weights [R, M] their weights -> [R, N_importance] depths at evenly
    spaced CDF levels 0..1."""
    R, M = weights.shape
    if bins.shape[1] != M + 1:
        raise ValueError(f"bins {tuple(bins.shape)} need one more column than "
                         f"weights {tuple(weights.shape)}")
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, dim=-1)], dim=-1)
    u = _linspace01(N_importance, bins).expand(R, -1).contiguous()
    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=M)
    cdf_b, cdf_a = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    bins_b, bins_a = torch.gather(bins, 1, below), torch.gather(bins, 1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_b + (u - cdf_b) / denom * (bins_a - bins_b)
