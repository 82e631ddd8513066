"""The train and eval steps (counterpart of nerfloc_tpu/train/step.py
`make_train_step` and `make_eval_step`).

A train step over a batch of B queries runs each query's forward and
backward in turn, with its loss divided by B: the gradients add up to the
gradient of the mean loss, and only one query's graph is alive at a time.
With a data-parallel process group of n ranks, each rank runs its B
queries of the global batch of n*B and the flat gradient and the metrics
are all-reduced to their means over the group before the update, as the
JAX package's sharded step does; the noise is drawn for the whole global
batch from the generator every rank seeds alike, each rank keeping its
rows, so the n-rank step is the one-process step at n*B up to the order
of float sums.

An eval step localizes each of its B queries in turn (the JAX package
vmaps them): the first matching pass and PnP, the cascade pass with its
own PnP and the gate that keeps its pose only if it explains the first
pass's matches about as well (cfg.cascade_matching), photometric
refinement (cfg.optimize_pose), then the pose error and the matching IoU
against the ground-truth pairs.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..configs import Config
from ..solve.pnp import count_pose_inliers, gumbel_noise, ransac_pnp
from ..solve.pose_refine import refine_pose, sample_refine_pixels
from ..utils.metrics import compute_pose_error, matching_iou
from ..utils.profiling import span
from .state import TrainState, flat_grads

Tensor = torch.Tensor
METRICS = ("loss", "coarse_loss", "fine_loss", "fine_err", "ref_depth_loss",
           "render_loss", "psnr")
NOISE = ("kp_gumbel", "pnp_gumbel", "pnp2_gumbel", "refine_uv")
CASCADE_SLACK = 0.95    # share of the first pass's inliers the cascade pose must keep
REFINE_STEPS, REFINE_LR = 50, 1e-3


def _global_noise(model, cfg: Config, batch: Mapping[str, Tensor], n_queries: int,
                       generator: Optional[torch.Generator]) -> Tuple[Tensor, Optional[Tensor]]:
    """(kp_gumbel [n_queries, P_coarse], ray_idx [n_queries, N_rand] or
    None) drawn as train_forward draws them, query after query: the noise
    a one-process step over n_queries queries of batch's shapes takes."""
    dev = model.device
    b0 = {k: v[0] for k, v in batch.items()}
    H, W = b0["image"].shape[0], b0["image"].shape[1]
    P = model.n_coarse_points(b0)
    kps, idxs = [], []
    for _ in range(n_queries):
        kps.append(gumbel_noise((P,), generator, dev))
        if cfg.train_nerf:
            idxs.append(torch.randperm(H * W, generator=generator,
                                       device=dev)[:cfg.render.N_rand])
    return torch.stack(kps), (torch.stack(idxs) if idxs else None)


def make_train_step(model, cfg: Config, group: Optional[dist.ProcessGroup] = None
                    ) -> Callable[..., Dict[str, Tensor]]:
    """Returns train_step(state, batch, kp_gumbel=None, ray_idx=None,
    generator=None) -> metrics, for a TrainState of `model`.

    batch: the query fields with a leading axis B (this rank's rows of the
    global batch under `group`). kp_gumbel [B, P_coarse] and ray_idx
    [B, N_rand] are the noise of train_forward, drawn from `generator`
    where not given; under `group` they are the global batch's
    ([n*B, ...]), given or drawn, and each rank takes its rows. The metrics
    are 0-d tensors on the model's device: the means over the (global)
    batch of loss and of its terms, fine_err, psnr and matching_iou, and
    grad_norm, the global norm of the (all-reduced) raw gradients."""

    if cfg.render.table_dtype == "int8" and cfg.train_nerf:
        warnings.warn("render.table_dtype='int8' is for inference: its rounding passes no "
                      "gradient, so the render loss trains nothing through the feature "
                      "tables", stacklevel=2)

    def train_step(state: TrainState, batch: Mapping[str, Tensor],
                   kp_gumbel: Optional[Tensor] = None, ray_idx: Optional[Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        if state.model is not model:
            raise ValueError("train_step: the state holds another model")
        with span("step"):
            B = batch["image"].shape[0]
            if group is not None:
                n, r = dist.get_world_size(group), dist.get_rank(group)
                if kp_gumbel is None:
                    kp_gumbel, drawn_idx = _global_noise(model, cfg, batch, n * B, generator)
                    ray_idx = drawn_idx if ray_idx is None else ray_idx
                rows = slice(r * B, (r + 1) * B)
                kp_gumbel = kp_gumbel[rows]
                ray_idx = None if ray_idx is None else ray_idx[rows]
            model.zero_grad(set_to_none=True)
            sums: Dict[str, Tensor] = {}
            for b in range(B):
                with span("forward"):
                    out = model.train_forward(
                        {k: v[b] for k, v in batch.items()},
                        kp_gumbel=None if kp_gumbel is None else kp_gumbel[b],
                        ray_idx=None if ray_idx is None else ray_idx[b], generator=generator)
                with span("backward"):
                    (out["loss"] / B).backward()
                vals = {k: out[k].detach() for k in METRICS if k in out}
                if "match_j" in out:
                    vals["matching_iou"] = matching_iou(out["match_j"], out["match_mask"],
                                                        out["j_gt"], out["gt_mask"])
                for k, v in vals.items():
                    sums[k] = sums[k] + v if k in sums else v
                del out
            metrics = {k: v / B for k, v in sums.items()}
            with span("update"):
                g = flat_grads(state.params)
                if group is not None:
                    n = dist.get_world_size(group)
                    dist.all_reduce(g, group=group)
                    g = g / n
                    names = sorted(metrics)
                    means = torch.stack([metrics[k].float() for k in names])
                    dist.all_reduce(means, group=group)
                    metrics = dict(zip(names, means / n))
                metrics["grad_norm"] = torch.sqrt(torch.sum(g * g))
                state.apply_gradients(g)
            return metrics

    return train_step


def make_eval_step(model, cfg: Config) -> Callable[..., Dict[str, Tensor]]:
    """Returns eval_step(batch, generator=None, noise=None) -> per-query
    outputs with a leading axis B: rot_err_deg, trans_err_m, num_inliers,
    num_matches (of the first pass), matching_iou (first pass against the
    ground-truth pairs), pose_pred [B, 4, 4] and pnp_success (first pass).

    batch: the query fields with a leading axis B, on the model's device.
    noise: optional {name: [B, ...] tensor} for any of the four random
    streams, drawn from `generator` (on the model's device; or a list of
    B generators, one per query) where not given:
    kp_gumbel [P_coarse] (keypoint draw), pnp_gumbel and pnp2_gumbel
    [n_hyps, n_keypoints] (RANSAC minimal sets of the two passes) and
    refine_uv [pose_refine_rays, 2] (refinement pixels)."""

    def one(b: Mapping[str, Tensor], generator, noise: Dict[str, Tensor]):
        dev = model.device
        H, W = b["image"].shape[0], b["image"].shape[1]
        kp = noise.get("kp_gumbel")
        if kp is None:
            kp = gumbel_noise((model.n_coarse_points(b),), generator, dev)
        ctx, q2d, desc_3d, pts3d, pts3d_ndc, m = model.localize_parts(b, kp)

        def solve(mm, gumbel):
            with span("pnp"):
                return ransac_pnp(mm["mkps2d_f"], mm["mkps3d"], mm["pair_mask"], b["K"],
                                  thresh_px=cfg.ransac_thresh,
                                  n_hyps=cfg.shapes.pnp_hypotheses, gumbel=gumbel,
                                  generator=generator)
        pnp = solve(m, noise.get("pnp_gumbel"))
        pose, num_inliers = pnp.c2w, pnp.num_inliers
        if cfg.cascade_matching:
            with span("cascade"):
                m2 = model.match_cascade(ctx, q2d, b, desc_3d, pts3d, pts3d_ndc, pose)
            pnp2 = solve(m2, noise.get("pnp2_gumbel"))
            # the cascade pose must explain the first pass's matches nearly
            # as well as the first pose: a re-match seeded by a bad pose can
            # find enough chance inliers among its own pairs
            with span("cascade"):
                n2_on_m = count_pose_inliers(pnp2.c2w, m["mkps2d_f"], m["mkps3d"],
                                             m["pair_mask"], b["K"], cfg.ransac_thresh)
            use2 = pnp2.success & (n2_on_m.float() >= CASCADE_SLACK * num_inliers.float())
            pose = torch.where(use2, pnp2.c2w, pose)
            num_inliers = torch.where(use2, pnp2.num_inliers, num_inliers)
        if cfg.optimize_pose:
            uv = noise.get("refine_uv")
            if uv is None:
                uv = sample_refine_pixels(H, W, cfg.shapes.pose_refine_rays,
                                          b.get("target_mask"), cfg.optimize_pose_sampling,
                                          generator=generator, device=dev)

            def render_fn(rays_o, rays_d, p):
                return model.model_3d.render_rays(ctx, rays_o, rays_d, p, train=False)
            pose = refine_pose(render_fn, pose, b["K"], b["image"], uv,
                               max_steps=REFINE_STEPS, lr=REFINE_LR)
        rot_err, trans_err = compute_pose_error(pose, b["pose"])
        j_gt, gt_mask, _ = model.build_3d_2d_pairs(
            pts3d, b["depth"], b["K"], b["pose"], H, W, q2d["stride_coarse"],
            cfg.matching.coarse_matching_depth_thresh)
        return {"rot_err_deg": rot_err, "trans_err_m": trans_err,
                "num_inliers": num_inliers,
                "num_matches": torch.sum(m["pair_mask"]).to(torch.int32),
                "matching_iou": matching_iou(m["match_j"], m["match_mask"], j_gt, gt_mask),
                "pose_pred": pose, "pnp_success": pnp.success}

    @torch.no_grad()
    def eval_step(batch: Mapping[str, Tensor],
                  generator: Union[None, torch.Generator, Sequence[torch.Generator]] = None,
                  noise: Optional[Mapping[str, Tensor]] = None) -> Dict[str, Tensor]:
        unknown = set(noise or {}) - set(NOISE)
        if unknown:
            raise ValueError(f"eval_step: unknown noise {sorted(unknown)}")
        B = batch["image"].shape[0]
        gens = list(generator) if isinstance(generator, (list, tuple)) else [generator] * B
        if len(gens) != B:
            raise ValueError(f"eval_step: {len(gens)} generators for {B} queries")
        outs = []
        for i in range(B):
            with span("query"):
                outs.append(one({k: v[i] for k, v in batch.items()}, gens[i],
                                {k: v[i] for k, v in (noise or {}).items()}))
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    return eval_step
