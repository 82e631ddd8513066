"""Per-query scene state (counterpart of
nerfloc_tpu/models/fields/context.py): built once per localization query
(or per rendered frame) and passed to every query and render call."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional

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
    # 4-corner tables (ops/interp.pack_bilinear_corners); with
    # render.table_dtype='int8' the feature tables are QuantTables
    fused_fine_packed: Optional[Any] = None     # [V*Hf*Wf, 4*(C+32)]
    rgb_packed: Optional[Tensor] = None         # [V*H*W, 12]
    xyz_window_packed: Optional[Tensor] = None  # [V*Hf*Wf, win^2*4] knn_proj table
    # vis-only corners: guided sampling and the pruned path's visibility
    vis_corner_packed: Optional[Any] = None     # [V*Hf*Wf, 4*32]
    # merged render table (render.use_merged_table): fused corners and the
    # 5x5 candidate window in one row; replaces fused_fine_packed and
    # xyz_window_packed
    render_table: Optional[Tensor] = None       # [V*(Hf+4)*(Wf+4), 4*(C+32)+250]
    # feature-only corners of the pruned path (render.prune_views > 0);
    # replaces fused_fine_packed
    feat_fine_packed: Optional[Any] = None      # [V*Hf*Wf, 4*C]
