"""Train and eval metrics (counterpart of nerfloc_tpu/utils/metrics.py:
`compute_pose_error`, `matching_iou`, `pose_accuracy`,
`aggregate_per_scene`, `CAMBRIDGE_TRANS_THRESH`). The per-query metrics
are tensors on the model's device; the accuracy and the per-scene table
are numpy on the host, over the gathered per-query arrays."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..geometry.se3 import compute_pose_error

Tensor = torch.Tensor

__all__ = ["CAMBRIDGE_TRANS_THRESH", "aggregate_per_scene", "compute_pose_error",
           "matching_iou", "pose_accuracy"]

# per-scene translation thresholds (m) of the Cambridge Landmarks scenes
CAMBRIDGE_TRANS_THRESH = {
    "StMarysChurch": 0.35,
    "GreatCourt": 0.45,
    "OldHospital": 0.22,
    "KingsCollege": 0.38,
    "ShopFacade": 0.15,
}


def matching_iou(match_j: Tensor, match_mask: Tensor, j_gt: Tensor,
                 gt_mask: Tensor) -> Tensor:
    """IoU of the predicted and ground-truth 3D->2D match sets: keypoint i
    is in the intersection when both sets hold it with the same 2D cell."""
    inter = (match_mask & gt_mask & (match_j == j_gt)).float()
    union = (match_mask | gt_mask).float()
    return torch.sum(inter) / torch.clamp(torch.sum(union), min=1.0)


def pose_accuracy(rot_err_deg: np.ndarray, trans_err_m: np.ndarray,
                  rot_thresh: float = 5.0, trans_thresh: float = 0.05) -> float:
    """Share of poses with rotation error < rot_thresh degrees and
    translation error < trans_thresh metres."""
    ok = (np.asarray(rot_err_deg) < rot_thresh) & (np.asarray(trans_err_m) < trans_thresh)
    return float(np.mean(ok.astype(np.float32)))


def aggregate_per_scene(scene_ids: np.ndarray, rot_err: np.ndarray,
                        trans_err: np.ndarray, scene_names: Dict[int, str],
                        scale_factors: Optional[np.ndarray] = None,
                        rot_thresh: float = 5.0, trans_thresh: float = 0.05,
                        dataset_type: str = "",
                        extras: Optional[Dict[str, np.ndarray]] = None
                        ) -> Dict[str, Dict[str, float]]:
    """Per-scene median errors, pose accuracy and query count, and their
    mean over scenes under 'avg'.

    Translation errors are divided by each query's scale_factor (undoing
    the scene's rescaling); Cambridge scenes (dataset_type containing
    'cambridge') take their own translation threshold. extras: further
    per-query arrays (e.g. matching_iou), reduced by their mean per scene
    and over all queries."""
    if scale_factors is not None:
        trans_err = trans_err / np.maximum(scale_factors, 1e-12)
    out: Dict[str, Dict[str, float]] = {}
    accs, med_r, med_t = [], [], []
    for sid in np.unique(scene_ids):
        name = scene_names.get(int(sid), str(int(sid)))
        sel = scene_ids == sid
        r, t = rot_err[sel], trans_err[sel]
        tt = trans_thresh
        if "cambridge" in dataset_type.lower():
            tt = CAMBRIDGE_TRANS_THRESH.get(name, trans_thresh)
        acc = float(np.mean((r < rot_thresh) & (t < tt)))
        out[name] = {"median_rot_err_deg": float(np.median(r)),
                     "median_trans_err_m": float(np.median(t)),
                     "pose_acc": acc, "n": int(sel.sum())}
        for k, v in (extras or {}).items():
            out[name][k] = float(np.mean(v[sel]))
        accs.append(acc)
        med_r.append(float(np.median(r)))
        med_t.append(float(np.median(t)))
    out["avg"] = {
        "median_rot_err_deg": float(np.mean(med_r)) if med_r else float("nan"),
        "median_trans_err_m": float(np.mean(med_t)) if med_t else float("nan"),
        "pose_acc": float(np.mean(accs)) if accs else float("nan"),
        "n": int(len(scene_ids)),
    }
    for k, v in (extras or {}).items():
        out["avg"][k] = float(np.mean(v))
    return out
