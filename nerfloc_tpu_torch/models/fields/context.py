"""Per-query scene state (counterpart of
nerfloc_tpu/models/fields/context.py): built once per localization query
(or per rendered frame) and passed to every query and render call."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from .aggregator import SupportViews

Tensor = torch.Tensor


@dataclass(frozen=True)
class NeuralPoints:
    """Dense masked neural points: one slot per featmap pixel per view."""
    xyz: Tensor          # [P, 3] world
    xyz_ndc: Tensor      # [P, 3] in the first support view's camera frame
    feature: Tensor      # [P, 3+C] rgb + backbone feature
    confidence: Tensor   # [P, 1]
    direction: Tensor    # [P, 4] world view dir + view distance
    mask: Tensor         # [P] bool
    kp_score: Optional[Tensor] = None  # [P, 1] (coarse level only)

    def replace(self, **kw) -> "NeuralPoints":
        return replace(self, **kw)


@dataclass(frozen=True)
class SceneContext:
    sv: SupportViews
    coarse: NeuralPoints
    fine: NeuralPoints
    feat_coarse_src: Tensor               # [V, Hc, Wc, C]
    feat_fine_src: Tensor                 # [V, Hf, Wf, C]
    fused_fine_packed: Optional[Tensor] = None  # [V*Hf*Wf, 4*(C+32)]
    rgb_packed: Optional[Tensor] = None         # [V*H*W, 12]
    xyz_window_packed: Optional[Tensor] = None  # [V*Hf*Wf, win^2*4] knn_proj table
    vis_corner_packed: Optional[Tensor] = None  # [V*Hf*Wf, 4*32], guided sampling only
