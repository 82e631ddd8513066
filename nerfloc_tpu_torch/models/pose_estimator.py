"""Top-level localization model, eval path (counterpart of
nerfloc_tpu/models/pose_estimator.py: `extract_2d`, `build_context`,
`_keypoints`, the eval branch of `match`, `localize_parts`,
`localize_forward`, `render_image_rays`).

A query runs: backbone on [1+V] images -> appearance FiLM -> scene context
(NeuRay ray features, neural points, multiview aggregation) -> Gumbel top-k
keypoints -> coarse 3D descriptors (fused aggregation, K=8) -> coarse and
fine matching (fused aggregation, K=1) -> P3P-RANSAC. All of it stays on
the model's device; nothing is read back to the host.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from ..configs import Config
from ..device import DeviceLike, resolve_device
from ..geometry.embedder import Embedder, position_embedding_sine
from ..solve.pnp import gumbel_noise, ransac_pnp
from .appearance import AppearanceAdaptLayer, appearance_embedding
from .backbone import Backbone2D
from .fields.conditional_nerf import ConditionalNeRF
from .fields.context import SceneContext
from .matching import (FineMatching, FinePreprocess, S2DMatching, gather_windows,
                       mutual_nearest_matches)
from .transformer import SelfCrossTransformer

Tensor = torch.Tensor


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


def to_device_batch(batch: Mapping[str, np.ndarray], device: torch.device
                    ) -> Dict[str, Tensor]:
    """Numeric batch fields (data.device_batch output) as tensors on device."""
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


class NerfPoseEstimator(nn.Module):
    """Localization model. `device` defaults to CUDA (raises without a GPU);
    weights are seeded random unless loaded with weights.load_flax_variables."""

    def __init__(self, cfg: Config, device: DeviceLike = None, seed: int = 0):
        super().__init__()
        if cfg.cascade_matching or cfg.simple_3d_model or \
                cfg.keypoints_3d_source != "depth" or not cfg.encode_appearance:
            raise NotImplementedError(
                "the port covers the default localization path only "
                "(no cascade, no simple 3D model, depth keypoints, appearance FiLM)")
        self.cfg = cfg
        hd, C = cfg.matcher_hidden_dim, cfg.backbone2d_fpn_dim
        self.backbone2d = Backbone2D(fpn_dim=C, use_fpn=cfg.backbone2d_use_fpn)
        self.proj_layer_2d = nn.Linear(C, hd)
        self.pos_emd_3d = Embedder(hd // 6, include_input=False)
        self.coarse_transformer = SelfCrossTransformer(hd, 8, 512)
        self.coarse_matcher = S2DMatching(hd)
        self.fine_preprocess = FinePreprocess(C, hd)
        self.fine_transformer = SelfCrossTransformer(hd, 8, 128)
        self.fine_matcher = FineMatching(hd)
        self.model_3d = ConditionalNeRF(cfg)
        self.adapt_appearance_coarse = AppearanceAdaptLayer(C)
        self.adapt_appearance_fine = AppearanceAdaptLayer(C)
        if cfg.train_nerf:
            self.adapt_appearance_rgb = AppearanceAdaptLayer(3, is_rgb=True)
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
        """One backbone pass over [query | support] images, FiLM adaptation
        of the support maps, then the conditional-NeRF scene context."""
        cfg = self.cfg
        a2d = self.extract_2d(torch.cat([batch["image"][None], batch["topk_images"]]))
        q2d = {k: (v[:1] if torch.is_tensor(v) else v) for k, v in a2d.items()
               if k != "feat_pyramid"}
        feat_coarse_src, feat_fine_src = a2d["feat_coarse"][1:], a2d["feat_fine"][1:]
        conv1 = a2d["feat_pyramid"]["conv1"]
        embedding_a = appearance_embedding(conv1[:1])
        embedding_src = appearance_embedding(conv1[1:])
        topk_images = batch["topk_images"]
        if cfg.train_nerf:
            topk_images = self.adapt_appearance_rgb(topk_images, embedding_src, embedding_a)
        feat_coarse_src = self.adapt_appearance_coarse(feat_coarse_src, embedding_src,
                                                       embedding_a)
        feat_fine_src = self.adapt_appearance_fine(feat_fine_src, embedding_src, embedding_a)
        ctx = self.model_3d.build_scene_context(
            topk_images, batch["topk_depths"], batch["topk_poses"], batch["topk_Ks"],
            batch["near"], batch["far"], feat_coarse_src, feat_fine_src,
            q2d["stride_coarse"], q2d["stride_fine"])
        return ctx, q2d

    def match(self, ctx: SceneContext, q2d, batch, desc_3d: Tensor,
              pts3d: Tensor, pts3d_ndc: Tensor) -> Dict[str, Tensor]:
        """Coarse S2D matching + mutual NN, then the fine window head on the
        predicted pairs (eval branch)."""
        cfg = self.cfg
        H, W = batch["image"].shape[0], batch["image"].shape[1]
        sc, sf = q2d["stride_coarse"], q2d["stride_fine"]
        hc, wc = H // sc, W // sc
        hd = cfg.matcher_hidden_dim
        dev = desc_3d.device

        desc_2d = self.proj_layer_2d(q2d["feat_coarse"][0].reshape(hc * wc, -1))
        pos_2d = position_embedding_sine(hc, wc, hd // 2, device=dev).reshape(hc * wc, -1)
        pos_3d = self.pos_emd_3d(pts3d_ndc)
        d3, d2 = self.coarse_transformer(desc_3d[None], pos_3d[None],
                                         desc_2d[None], pos_2d[None])
        scores = torch.sigmoid(self.coarse_matcher(d3[0], d2[0]))
        match_j, match_mask = mutual_nearest_matches(scores, cfg.matching.thr)

        wsz = cfg.matching.fine_window_size
        ratio = sc // sf
        centers = torch.stack([(match_j % wc) * ratio, (match_j // wc) * ratio], dim=-1)
        desc_3d_fine = self.model_3d.query_fine(ctx, pts3d)
        patches, _ = gather_windows(q2d["feat_fine"][0], centers, wsz)
        patches = self.fine_preprocess(patches)
        pos_win = position_embedding_sine(wsz, wsz, hd // 2, device=dev)
        pos_win = pos_win.reshape(1, wsz * wsz, -1).expand(patches.shape[0], -1, -1)
        f3, f2 = self.fine_transformer(desc_3d_fine[:, None, :], pos_3d[:, None, :],
                                       patches, pos_win)
        expec_f = self.fine_matcher(f3[:, 0, :], f2)
        mkps2d_f = centers.to(expec_f.dtype) + expec_f[:, :2] * (wsz // 2)
        return {"score_matrix": scores, "match_j": match_j, "match_mask": match_mask,
                "expec_f": expec_f, "mkps2d_f": mkps2d_f * sf, "mkps3d": pts3d,
                "pair_mask": match_mask}

    def localize_parts(self, batch: Mapping[str, Tensor], kp_gumbel: Tensor):
        ctx, q2d = self.build_context(batch)
        desc_3d, pts3d, pts3d_ndc = self.model_3d.query_coarse(ctx, kp_gumbel)
        m = self.match(ctx, q2d, batch, desc_3d, pts3d, pts3d_ndc)
        return ctx, q2d, desc_3d, pts3d, pts3d_ndc, m

    def n_coarse_points(self, batch: Mapping[str, Tensor]) -> int:
        V, H, W = batch["topk_images"].shape[:3]
        s = Backbone2D.layer_to_stride[self.cfg.backbone2d_coarse_layer_name]
        return V * (H // s) * (W // s)

    @torch.no_grad()
    def localize_forward(self, batch: Mapping[str, Tensor],
                         generator: Optional[torch.Generator] = None,
                         kp_gumbel: Optional[Tensor] = None,
                         pnp_gumbel: Optional[Tensor] = None) -> Dict[str, Tensor]:
        """Eval path: features -> 3D descriptors -> matching -> PnP-RANSAC.

        kp_gumbel [P_coarse] and pnp_gumbel [n_hyps, n_keypoints]: Gumbel
        noise of the keypoint draw and of the RANSAC minimal sets; drawn
        from `generator` (on the model's device) when not given."""
        dev = self.device
        if kp_gumbel is None:
            kp_gumbel = gumbel_noise((self.n_coarse_points(batch),), generator, dev)
        ctx, q2d, desc_3d, pts3d, pts3d_ndc, m = self.localize_parts(batch, kp_gumbel)
        pnp = ransac_pnp(m["mkps2d_f"], m["mkps3d"], m["pair_mask"], batch["K"],
                         thresh_px=self.cfg.ransac_thresh,
                         n_hyps=self.cfg.shapes.pnp_hypotheses,
                         gumbel=pnp_gumbel, generator=generator)
        return {"mkps2d": m["mkps2d_f"], "mkps3d": m["mkps3d"],
                "match_mask": m["pair_mask"], "match_j": m["match_j"],
                "score_matrix": m["score_matrix"], "desc_3d": desc_3d,
                "pose": pnp.c2w, "num_inliers": pnp.num_inliers,
                "pnp_success": pnp.success}

    @torch.no_grad()
    def render_image_rays(self, batch: Mapping[str, Tensor], rays_o: Tensor,
                          rays_d: Tensor) -> Dict[str, Tensor]:
        """Render rays [R, 3] of the query view against its support views
        (scene context, then ConditionalNeRF.render_rays at the query pose)."""
        ctx, _ = self.build_context(batch)
        return self.model_3d.render_rays(ctx, rays_o, rays_d, batch["pose"], train=False)
