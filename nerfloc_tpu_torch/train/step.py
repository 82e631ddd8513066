"""The train step (counterpart of nerfloc_tpu/train/step.py
`make_train_step`, on one device: data parallelism comes later).

A step over a batch of B queries runs each query's forward and backward
in turn, with its loss divided by B: the gradients add up to the gradient
of the mean loss, and only one query's graph is alive at a time.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch

from ..configs import Config
from ..utils.metrics import matching_iou
from .state import TrainState, flat_grads

Tensor = torch.Tensor
METRICS = ("loss", "coarse_loss", "fine_loss", "fine_err", "ref_depth_loss",
           "render_loss", "psnr")


def make_train_step(model, cfg: Config) -> Callable[..., Dict[str, Tensor]]:
    """Returns train_step(state, batch, kp_gumbel=None, ray_idx=None,
    generator=None) -> metrics, for a TrainState of `model`.

    batch: the query fields with a leading axis B. kp_gumbel [B, P_coarse]
    and ray_idx [B, N_rand] are the noise of train_forward, drawn from
    `generator` where not given. The metrics are 0-d tensors on the model's
    device: the means over B of loss and of its terms, fine_err, psnr and
    matching_iou, and grad_norm, the global norm of the raw gradients."""

    def train_step(state: TrainState, batch: Mapping[str, Tensor],
                   kp_gumbel: Optional[Tensor] = None, ray_idx: Optional[Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> Dict[str, Tensor]:
        if state.model is not model:
            raise ValueError("train_step: the state holds another model")
        B = batch["image"].shape[0]
        model.zero_grad(set_to_none=True)
        sums: Dict[str, Tensor] = {}
        for b in range(B):
            out = model.train_forward(
                {k: v[b] for k, v in batch.items()},
                kp_gumbel=None if kp_gumbel is None else kp_gumbel[b],
                ray_idx=None if ray_idx is None else ray_idx[b], generator=generator)
            (out["loss"] / B).backward()
            vals = {k: out[k].detach() for k in METRICS if k in out}
            if "match_j" in out:
                vals["matching_iou"] = matching_iou(out["match_j"], out["match_mask"],
                                                    out["j_gt"], out["gt_mask"])
            for k, v in vals.items():
                sums[k] = sums[k] + v if k in sums else v
            del out
        metrics = {k: v / B for k, v in sums.items()}
        g = flat_grads(state.params)
        metrics["grad_norm"] = torch.sqrt(torch.sum(g * g))
        state.apply_gradients(g)
        return metrics

    return train_step
