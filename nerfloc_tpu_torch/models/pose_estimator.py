"""Top-level localization model (counterpart of
nerfloc_tpu/models/pose_estimator.py: `extract_2d`, `build_context`,
`_keypoints` (as `keypoints`), `build_3d_2d_pairs`, `match`, `localize_parts`,
`localize_forward`, `train_forward`, `compute_render_loss`,
`render_image_rays`, `select_visible_mask`, `match_cascade`).

A query runs: backbone on [1+V] images -> appearance FiLM (with
cfg.encode_appearance, as the multi-scene configs set it; the per-object
fine-tunes turn it off) -> scene context
(NeuRay ray features, neural points, multiview aggregation) -> Gumbel top-k
keypoints (over the coarse points' scores, or with
keypoints_3d_source='sfm' over the batch's SfM points) -> coarse 3D
descriptors (fused aggregation, K=8) -> coarse and fine matching (fused
aggregation, K=1) -> P3P-RANSAC. cfg.simple_3d_model swaps the conditional
NeRF for its projection-average ablation (no fused aggregation). All of it stays on
the model's device; nothing is read back to the host. With
cfg.cascade_matching a second matcher re-matches the keypoints that a first
pose estimate sees (`match_cascade`); train/step.py's eval step decides
which pose to keep.

`dtype` is the compute dtype of every submodule (flax's `dtype`;
configs.compute_dtype_of resolves cfg.compute_dtype as the JAX package's
CLIs and bench do). Parameters stay f32. At bf16 the query's outputs keep
the JAX package's dtypes: the score matrix bf16, the keypoints, matches
and pose f32 (PnP takes f32 inputs). Training adds each loss term to an
f32 total as JAX promotes it (`_weighted`).

A training query replaces PnP by the losses: the keypoints projected with
the ground-truth pose give the coarse targets and the fine windows (for
the cascade matcher too, over the keypoints the ground-truth pose sees),
the support views' decoded depths are held against their sensor depths,
and N_rand rays of the query view are rendered (fused aggregation, K=8)
and held against its pixels and its fine features.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..configs import Config
from ..device import DeviceLike, resolve_device
from ..geometry.cameras import camera_project, rays_for_pixels, world_to_camera
from ..geometry.embedder import Embedder, position_embedding_sine
from ..ops.interp import bilinear_sample
from ..ops.knn import topk_first
from ..solve.pnp import gumbel_noise, ransac_pnp
from ..utils.profiling import span
from .appearance import AppearanceAdaptLayer, appearance_embedding
from .backbone import Backbone2D
from .fields.conditional_nerf import ConditionalNeRF
from .fields.conditional_nerf_simple import ConditionalNeRFSimple
from .fields.context import SceneContext
from .fields.losses import img2mse, mse2psnr, rendering_loss
from .lowp import F32, const, dense, sigmoid
from .matching import (FineMatching, FinePreprocess, S2DMatching, coarse_loss,
                       fine_loss_l2, fine_loss_l2_std, gather_windows,
                       mutual_nearest_matches)
from .transformer import SelfCrossTransformer

Tensor = torch.Tensor
Pairs = Tuple[Tensor, Tensor, Tensor]   # (j_gt, gt_mask, proj_gt_coarse)


def init_params(module: nn.Module, seed: int) -> None:
    """Seeded random weights in flax's default scheme: Linear/Conv kernels
    ~ N(0, 1/fan_in) clipped at 2 sigma (lecun normal), zero biases; norm
    scales stay 1. Drawn on the CPU, so every device gets the same values.
    The conditional NeRF's render heads are drawn last, so the other
    weights are the same as in a model without them."""
    g = torch.Generator().manual_seed(seed)
    heads = {id(m) for name, head in module.named_modules()
             if name.rsplit(".", 1)[-1] in ConditionalNeRF.RENDER_HEADS
             for m in head.modules()}
    with torch.no_grad():
        for m in sorted(module.modules(), key=lambda m: id(m) in heads):
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)):
                w_in = m.weight.transpose(0, 1) if isinstance(m, nn.ConvTranspose1d) \
                    else m.weight
                fan_in = w_in[0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                w = torch.randn(m.weight.shape, generator=g).clamp_(-2.0, 2.0) * std
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()


def select_visible_mask(pts3d: Tensor, pose_c2w: Tensor, K: Tensor, H: int,
                        W: int) -> Tensor:
    """[N] bool: the keypoints [N, 3] that project inside the H x W frame,
    in front of the camera, from a c2w pose."""
    u, v, z = camera_project(world_to_camera(pose_c2w, pts3d), K)
    return (u >= 0) & (v >= 0) & (u < W) & (v < H) & (z > 0)


def _cell_index(x: Tensor, n: int) -> Tensor:
    """clip(int(x), 0, n - 1), with int() truncating towards zero and
    saturating as XLA's float-to-int conversion does."""
    return torch.clamp(x, -1.0, float(n)).long().clamp(0, n - 1)


def _weighted(loss: Tensor, w: float, term: Tensor) -> Tensor:
    """loss + w * term into the f32 accumulator, as JAX adds a term of any
    dtype: the weight rounded to the term's dtype (a weak-typed scalar),
    the product taken in f32 (XLA computes the step before the promotion in
    f32)."""
    return loss + const(w, term) * term.float()


def to_device_batch(batch: Mapping[str, np.ndarray], device: torch.device
                    ) -> Dict[str, Tensor]:
    """Numeric batch fields (data.device_batch output) as tensors on device."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


class NerfPoseEstimator(nn.Module):
    """Localization model. `device` defaults to CUDA (raises without a GPU);
    weights are seeded random unless loaded with weights.load_flax_variables.
    `dtype`: the compute dtype (f32, or bf16 as compute_dtype_of(cfg))."""

    def __init__(self, cfg: Config, device: DeviceLike = None, seed: int = 0,
                 dtype: torch.dtype = F32):
        super().__init__()
        if dtype not in (F32, torch.bfloat16):
            raise ValueError(f"compute dtype {dtype}: the port runs float32 or bfloat16")
        self.cfg = cfg
        self.dtype = dtype
        hd, C = cfg.matcher_hidden_dim, cfg.backbone2d_fpn_dim
        self.backbone2d = Backbone2D(fpn_dim=C, use_fpn=cfg.backbone2d_use_fpn, dtype=dtype)
        self.proj_layer_2d = nn.Linear(C, hd)
        self.pos_emd_3d = Embedder(hd // 6, include_input=False)
        self.coarse_transformer = SelfCrossTransformer(hd, 8, 512, dtype)
        self.coarse_matcher = S2DMatching(hd, dtype=dtype)
        self.fine_preprocess = FinePreprocess(C, hd, dtype)
        self.fine_transformer = SelfCrossTransformer(hd, 8, 128, dtype)
        self.fine_matcher = FineMatching(hd, dtype)
        if cfg.cascade_matching:
            # the cascade pass's own matcher (match(..., second=True))
            self.coarse_transformer2 = SelfCrossTransformer(hd, 8, 512, dtype)
            self.coarse_matcher2 = S2DMatching(hd, dtype=dtype)
            self.fine_preprocess2 = FinePreprocess(C, hd, dtype)
            self.fine_transformer2 = SelfCrossTransformer(hd, 8, 128, dtype)
            self.fine_matcher2 = FineMatching(hd, dtype)
        # cfg.simple_3d_model: the projection-average ablation
        self.model_3d = (ConditionalNeRFSimple if cfg.simple_3d_model else ConditionalNeRF)(
            cfg, dtype)
        if cfg.encode_appearance:
            self.adapt_appearance_coarse = AppearanceAdaptLayer(C, dtype=dtype)
            self.adapt_appearance_fine = AppearanceAdaptLayer(C, dtype=dtype)
            if cfg.train_nerf:
                self.adapt_appearance_rgb = AppearanceAdaptLayer(3, is_rgb=True, dtype=dtype)
        init_params(self, seed)
        self.to(resolve_device(device))
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.proj_layer_2d.weight.device

    def extract_2d(self, imgs: Tensor) -> Dict[str, Tensor]:
        cfg = self.cfg
        pyr = self.backbone2d(imgs)
        return {"feat_pyramid": pyr,
                "feat_coarse": pyr[cfg.backbone2d_coarse_layer_name],
                "feat_fine": pyr[cfg.backbone2d_fine_layer_name],
                "stride_coarse": Backbone2D.layer_to_stride[cfg.backbone2d_coarse_layer_name],
                "stride_fine": Backbone2D.layer_to_stride[cfg.backbone2d_fine_layer_name]}

    def build_context(self, batch: Mapping[str, Tensor]):
        """The backbone over the query and support images (one pass over
        [query | support] when they share a size, else one pass each), FiLM
        adaptation of the support maps (with encode_appearance; without it
        the support images and maps go through unchanged), then the
        conditional-NeRF scene context."""
        cfg = self.cfg
        if batch["image"].shape == batch["topk_images"].shape[1:]:
            a2d = self.extract_2d(torch.cat([batch["image"][None], batch["topk_images"]]))
            q2d = {k: (v[:1] if torch.is_tensor(v) else v) for k, v in a2d.items()
                   if k != "feat_pyramid"}
            feat_coarse_src, feat_fine_src = a2d["feat_coarse"][1:], a2d["feat_fine"][1:]
            conv1 = a2d["feat_pyramid"]["conv1"]
            conv1_q, conv1_s = conv1[:1], conv1[1:]
        else:
            q = self.extract_2d(batch["image"][None])
            s = self.extract_2d(batch["topk_images"])
            q2d = {k: v for k, v in q.items() if k != "feat_pyramid"}
            feat_coarse_src, feat_fine_src = s["feat_coarse"], s["feat_fine"]
            conv1_q, conv1_s = q["feat_pyramid"]["conv1"], s["feat_pyramid"]["conv1"]
        topk_images = batch["topk_images"]
        if cfg.encode_appearance:
            embedding_a = appearance_embedding(conv1_q)
            embedding_src = appearance_embedding(conv1_s)
            if cfg.train_nerf:
                topk_images = self.adapt_appearance_rgb(topk_images, embedding_src,
                                                        embedding_a)
            feat_coarse_src = self.adapt_appearance_coarse(feat_coarse_src, embedding_src,
                                                           embedding_a)
            feat_fine_src = self.adapt_appearance_fine(feat_fine_src, embedding_src,
                                                       embedding_a)
        ctx = self.model_3d.build_scene_context(
            topk_images, batch["topk_depths"], batch["topk_poses"], batch["topk_Ks"],
            batch["near"], batch["far"], feat_coarse_src, feat_fine_src,
            q2d["stride_coarse"], q2d["stride_fine"])
        return ctx, q2d

    @staticmethod
    def build_3d_2d_pairs(pts3d: Tensor, depth_map: Tensor, K: Tensor, pose: Tensor,
                          H: int, W: int, stride: int, thr: float) -> Pairs:
        """Ground-truth pairs of 3D keypoints [N, 3] with the query's coarse
        cells, from their projection with the true pose -> (j_gt [N] cell
        index, gt_mask [N], proj [N, 2] at coarse scale). A pair holds when
        the keypoint projects into the frame and within `thr` of the query
        depth there; when fewer than 4 hold, every projecting one does."""
        u, v, z = camera_project(world_to_camera(pose, pts3d), K)
        proj_valid = (u >= 0) & (v >= 0) & (u < W) & (v < H) & (z > 0)
        d = depth_map[_cell_index(v, H), _cell_index(u, W)]
        pos_mask = proj_valid & (torch.abs(d - z) < thr)
        pos_mask = torch.where(pos_mask.sum() < 4, proj_valid, pos_mask)
        j_gt = (_cell_index(u / stride, W // stride)
                + _cell_index(v / stride, H // stride) * (W // stride))
        return j_gt, pos_mask, torch.stack([u, v], dim=-1) / stride

    def match(self, ctx: SceneContext, q2d, batch, desc_3d: Tensor,
              pts3d: Tensor, pts3d_ndc: Tensor, pairs: Optional[Pairs] = None,
              kp_mask: Optional[Tensor] = None, second: bool = False
              ) -> Dict[str, Tensor]:
        """Coarse S2D matching + mutual NN, then the fine window head on the
        predicted pairs (eval branch). Train branch (`pairs` from
        build_3d_2d_pairs): the fine head runs on the ground-truth pairs,
        and the output adds coarse_loss (focal loss of the score logits
        against the pairs' cells), fine_loss (cfg.fine_matching_loss_type)
        and fine_err (mean fine offset error of the pairs in pixels, no
        gradient).

        kp_mask [N] bool: keypoints left out of matching (their score
        logits are -1e9, they match nothing and, in the train branch, are
        no target). second: the cascade matcher's weights."""
        cfg = self.cfg
        sfx = "2" if second else ""
        coarse_tf, coarse_m, fine_pre, fine_tf, fine_m = (
            getattr(self, n + sfx) for n in ("coarse_transformer", "coarse_matcher",
                                             "fine_preprocess", "fine_transformer",
                                             "fine_matcher"))
        H, W = batch["image"].shape[0], batch["image"].shape[1]
        sc, sf = q2d["stride_coarse"], q2d["stride_fine"]
        hc, wc = H // sc, W // sc
        hd = cfg.matcher_hidden_dim
        dev = desc_3d.device

        desc_2d = dense(self.proj_layer_2d, q2d["feat_coarse"][0].reshape(hc * wc, -1),
                        self.dtype)
        pos_2d = position_embedding_sine(hc, wc, hd // 2, device=dev,
                                         dtype=desc_2d.dtype).reshape(hc * wc, -1)
        pos_3d = self.pos_emd_3d(pts3d_ndc)
        d3, d2 = coarse_tf(desc_3d[None], pos_3d[None], desc_2d[None], pos_2d[None])
        conf = coarse_m(d3[0], d2[0])
        if kp_mask is not None:
            conf = torch.where(kp_mask[:, None], conf, torch.full_like(conf, -1e9))
        scores = sigmoid(conf)
        match_j, match_mask = mutual_nearest_matches(scores, cfg.matching.thr)
        if kp_mask is not None:
            match_mask = match_mask & kp_mask
        j_fine, pair_mask = (match_j, match_mask) if pairs is None else pairs[:2]

        wsz = cfg.matching.fine_window_size
        ratio = sc // sf
        centers = torch.stack([(j_fine % wc) * ratio, (j_fine // wc) * ratio], dim=-1)
        desc_3d_fine = self.model_3d.query_fine(ctx, pts3d)
        patches, _ = gather_windows(q2d["feat_fine"][0], centers, wsz)
        patches = fine_pre(patches)
        pos_win = position_embedding_sine(wsz, wsz, hd // 2, device=dev, dtype=patches.dtype)
        pos_win = pos_win.reshape(1, wsz * wsz, -1).expand(patches.shape[0], -1, -1)
        f3, f2 = fine_tf(desc_3d_fine[:, None, :], pos_3d[:, None, :], patches, pos_win)
        expec_f = fine_m(f3[:, 0, :], f2)
        mkps2d_c = centers.to(expec_f.dtype)
        mkps2d_f = mkps2d_c + expec_f[:, :2] * (wsz // 2)
        out = {"score_matrix": scores, "match_j": match_j, "match_mask": match_mask,
               "expec_f": expec_f, "mkps2d_f": mkps2d_f * sf, "mkps3d": pts3d,
               "pair_mask": pair_mask}
        if pairs is None:
            return out
        j_gt, gt_mask, proj_gt = pairs
        if kp_mask is not None:
            gt_mask = gt_mask & kp_mask
        conf_gt = torch.zeros_like(conf)
        conf_gt[torch.arange(conf.shape[0], device=dev), j_gt] = gt_mask.to(conf.dtype)
        out["coarse_loss"] = coarse_loss(conf, conf_gt)
        expec_f_gt = (proj_gt * ratio - mkps2d_c) / (wsz // 2)
        fine_loss = fine_loss_l2_std if cfg.fine_matching_loss_type == "l2_with_std" \
            else fine_loss_l2
        out["fine_loss"] = fine_loss(expec_f, expec_f_gt, gt_mask)
        err = torch.linalg.vector_norm(expec_f_gt - expec_f[:, :2].detach(), dim=-1)
        denom = torch.clamp(gt_mask.sum(), min=1).to(err.dtype)
        out["fine_err"] = (torch.sum(err * gt_mask) / denom) * (wsz // 2) * sf
        return out

    def sfm_keypoints(self, batch: Mapping[str, Tensor]) -> bool:
        """Whether the keypoints come from the batch's SfM points
        (keypoints_3d_source='sfm' and a batch that carries points3d)."""
        return self.cfg.keypoints_3d_source == "sfm" and "points3d" in batch

    def keypoints(self, ctx: SceneContext, batch: Mapping[str, Tensor], kp_gumbel: Tensor):
        """(desc_3d, pts3d, pts3d_ndc) of the query's 3D keypoints: Gumbel
        top-k over the coarse points' keypoint scores, or with SfM
        keypoints a uniform Gumbel top-k over batch['points3d'] [P, >=3]
        under batch['points3d_mask'] (kp_gumbel [P], the noise)."""
        if not self.sfm_keypoints(batch):
            return self.model_3d.query_coarse(ctx, kp_gumbel)
        pts_all = batch["points3d"][:, :3]
        mask = batch.get("points3d_mask")
        logits = torch.zeros_like(kp_gumbel) if mask is None else torch.where(
            mask, torch.zeros_like(kp_gumbel), torch.full_like(kp_gumbel, float("-inf")))
        _, idx = topk_first(kp_gumbel + logits, self.cfg.matching.fine_num_3d_keypoints)
        return self.model_3d.query_coarse(ctx, points=pts_all[idx])

    def localize_parts(self, batch: Mapping[str, Tensor], kp_gumbel: Tensor):
        with span("localize"):
            with span("localize.context"):
                ctx, q2d = self.build_context(batch)
            with span("localize.keypoints"):
                desc_3d, pts3d, pts3d_ndc = self.keypoints(ctx, batch, kp_gumbel)
            with span("localize.match"):
                m = self.match(ctx, q2d, batch, desc_3d, pts3d, pts3d_ndc)
        return ctx, q2d, desc_3d, pts3d, pts3d_ndc, m

    def match_cascade(self, ctx: SceneContext, q2d, batch: Mapping[str, Tensor],
                      desc_3d: Tensor, pts3d: Tensor, pts3d_ndc: Tensor,
                      pose_init: Tensor) -> Dict[str, Tensor]:
        """The cascade pass: the second matcher over the keypoints that
        project into the query frame from pose_init [4, 4] (eval branch)."""
        H, W = batch["image"].shape[0], batch["image"].shape[1]
        vis = select_visible_mask(pts3d, pose_init, batch["K"], H, W)
        return self.match(ctx, q2d, batch, desc_3d, pts3d, pts3d_ndc, kp_mask=vis,
                          second=True)

    def n_coarse_points(self, batch: Mapping[str, Tensor]) -> int:
        """The length of the keypoint draw's Gumbel noise: the coarse
        points, or with SfM keypoints the batch's points3d."""
        if self.sfm_keypoints(batch):
            return batch["points3d"].shape[0]
        V, H, W = batch["topk_images"].shape[:3]
        s = Backbone2D.layer_to_stride[self.cfg.backbone2d_coarse_layer_name]
        return V * (H // s) * (W // s)

    @torch.no_grad()
    def localize_forward(self, batch: Mapping[str, Tensor],
                         generator: Optional[torch.Generator] = None,
                         kp_gumbel: Optional[Tensor] = None,
                         pnp_gumbel: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """Eval path: features -> 3D descriptors -> matching -> PnP-RANSAC.

        kp_gumbel [n_coarse_points(batch)] and pnp_gumbel [n_hyps, n_keypoints]: Gumbel
        noise of the keypoint draw and of the RANSAC minimal sets; drawn
        from `generator` (on the model's device) when not given."""
        dev = self.device
        if kp_gumbel is None:
            kp_gumbel = gumbel_noise((self.n_coarse_points(batch),), generator, dev)
        ctx, q2d, desc_3d, pts3d, pts3d_ndc, m = self.localize_parts(batch, kp_gumbel)
        pnp = ransac_pnp(m["mkps2d_f"].float(), m["mkps3d"].float(), m["pair_mask"],
                         batch["K"],
                         thresh_px=self.cfg.ransac_thresh,
                         n_hyps=self.cfg.shapes.pnp_hypotheses,
                         gumbel=pnp_gumbel, generator=generator)
        return {"mkps2d": m["mkps2d_f"], "mkps3d": m["mkps3d"],
                "match_mask": m["pair_mask"], "match_j": m["match_j"],
                "score_matrix": m["score_matrix"], "desc_3d": desc_3d,
                "pose": pnp.c2w, "num_inliers": pnp.num_inliers,
                "pnp_success": pnp.success}

    def train_forward(self, batch: Mapping[str, Tensor], kp_gumbel: Optional[Tensor] = None,
                      ray_idx: Optional[Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        """One training query -> its losses and what the metrics need.

        kp_gumbel [n_coarse_points(batch)]: Gumbel noise of the keypoint draw; ray_idx
        [N_rand]: distinct flat pixel indices (y * W + x) of the rendered
        rays; each is drawn from `generator` (on the model's device) when not
        given. Returns loss (the weighted sum), its terms coarse_loss,
        fine_loss, ref_depth_loss and render_loss (cfg.train_pose /
        cfg.train_nerf), coarse_loss2 and fine_loss2 (the cascade matcher
        on the keypoints the ground-truth pose sees, cfg.cascade_matching),
        the metrics fine_err and psnr, and match_j, match_mask, j_gt,
        gt_mask for matching_iou."""
        cfg = self.cfg
        dev = self.device
        H, W = batch["image"].shape[0], batch["image"].shape[1]
        if kp_gumbel is None:
            kp_gumbel = gumbel_noise((self.n_coarse_points(batch),), generator, dev)
        if ray_idx is None and cfg.train_nerf:
            ray_idx = torch.randperm(H * W, generator=generator, device=dev)[:cfg.render.N_rand]
        with span("forward.context"):
            ctx, q2d = self.build_context(batch)
        out: Dict[str, Tensor] = {}
        loss = torch.zeros((), device=dev)
        if cfg.train_pose:
            desc_3d, pts3d, pts3d_ndc = self.keypoints(ctx, batch, kp_gumbel)
            pairs = self.build_3d_2d_pairs(pts3d, batch["depth"], batch["K"], batch["pose"],
                                           H, W, q2d["stride_coarse"],
                                           cfg.matching.coarse_matching_depth_thresh)
            with span("forward.match"):
                m = self.match(ctx, q2d, batch, desc_3d, pts3d, pts3d_ndc, pairs=pairs)
            out.update({k: m[k] for k in ("coarse_loss", "fine_loss", "fine_err",
                                          "match_j", "match_mask")})
            out["j_gt"], out["gt_mask"] = pairs[:2]
            loss = _weighted(loss, cfg.coarse_loss_weight, m["coarse_loss"])
            loss = _weighted(loss, cfg.fine_loss_weight, m["fine_loss"])
            if cfg.cascade_matching:
                vis = select_visible_mask(pts3d, batch["pose"], batch["K"], H, W)
                with span("forward.match"):
                    m2 = self.match(ctx, q2d, batch, desc_3d, pts3d, pts3d_ndc, pairs=pairs,
                                    kp_mask=vis, second=True)
                out["coarse_loss2"], out["fine_loss2"] = m2["coarse_loss"], m2["fine_loss"]
                loss = _weighted(loss, cfg.coarse_loss_weight, m2["coarse_loss"])
                loss = _weighted(loss, cfg.fine_loss_weight, m2["fine_loss"])
        depths_gt = batch.get("topk_depths_gt", batch["topk_depths"])
        out["ref_depth_loss"] = self.model_3d.multiview_aggregator.ref_depth_loss(
            ctx.sv, depths_gt)
        loss = _weighted(loss, cfg.ref_depth_loss_weight, out["ref_depth_loss"])
        if cfg.train_nerf:
            with span("forward.render"):
                out["render_loss"], out["psnr"] = self.compute_render_loss(ctx, q2d, batch,
                                                                           ray_idx)
            loss = _weighted(loss, cfg.render_loss_weight, out["render_loss"])
        out["loss"] = loss
        return out

    def compute_render_loss(self, ctx: SceneContext, q2d, batch: Mapping[str, Tensor],
                            ray_idx: Tensor) -> Tuple[Tensor, Tensor]:
        """Render the query view's pixels ray_idx [N_rand] (train outputs)
        -> (rendering_loss against their colours, depths with
        cfg.use_depth_supervision, and fine features, psnr). The feature
        target samples the stride-s fine map at (p + 0.5) / s - 0.5 (the
        map upsampled to H x W, align_corners=False) and keeps its
        gradient."""
        cfg = self.cfg
        W = batch["image"].shape[1]
        ui, vi = ray_idx % W, ray_idx // W
        uv = torch.stack([ui.float(), vi.float()], dim=-1)
        rays_o, rays_d = rays_for_pixels(uv, batch["K"], batch["pose"])
        preds = self.model_3d.render_rays(ctx, rays_o, rays_d, batch["pose"], train=True)
        mask = preds["mask"]
        if "target_mask" in batch:
            mask = mask & (batch["target_mask"][vi, ui] > 0)
        targets = {"rgb": batch["image"][vi, ui], "mask": mask}
        if cfg.use_depth_supervision:
            targets["depth"] = batch["depth"][vi, ui]
            targets["depth_range"] = (batch["near"], batch["far"])
        if cfg.render.render_feature:
            s = q2d["stride_fine"]
            targets["feat"] = bilinear_sample(q2d["feat_fine"][0], (uv + 0.5) / s - 0.5)
        loss = rendering_loss(preds, targets, use_depth=cfg.use_depth_supervision)
        psnr = mse2psnr(img2mse(preds["rgb"].detach(), targets["rgb"], mask=mask))
        return loss, psnr

    @torch.no_grad()
    def render_image_rays(self, batch: Mapping[str, Tensor], rays_o: Tensor,
                          rays_d: Tensor) -> Dict[str, Tensor]:
        """Render rays [R, 3] of the query view against its support views
        (scene context, then ConditionalNeRF.render_rays at the query pose)."""
        ctx, _ = self.build_context(batch)
        return self.model_3d.render_rays(ctx, rays_o, rays_d, batch["pose"], train=False)
