"""Train and eval metrics (counterpart of nerfloc_tpu/utils/metrics.py:
`compute_pose_error`, `matching_iou`). The per-scene aggregation comes with
the eval harness."""
from __future__ import annotations

import torch

from ..geometry.se3 import compute_pose_error

Tensor = torch.Tensor

__all__ = ["compute_pose_error", "matching_iou"]


def matching_iou(match_j: Tensor, match_mask: Tensor, j_gt: Tensor,
                 gt_mask: Tensor) -> Tensor:
    """IoU of the predicted and ground-truth 3D->2D match sets: keypoint i
    is in the intersection when both sets hold it with the same 2D cell."""
    inter = (match_mask & gt_mask & (match_j == j_gt)).float()
    union = (match_mask | gt_mask).float()
    return torch.sum(inter) / torch.clamp(torch.sum(union), min=1.0)
