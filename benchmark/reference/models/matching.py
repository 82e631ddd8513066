"""Coarse sparse-to-dense and fine windowed matching heads and their
losses (counterpart of nerfloc_tpu/models/matching.py). `dtype` is the
compute dtype (models/lowp.py) of the scoring MLPs and the window
projection; the fine heat map meets an f32 grid, so the expected
coordinates are f32."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .lowp import F32, bcast, const, dense, sigmoid, softmax

Tensor = torch.Tensor


class ScoreMLP(nn.Module):
    """C -> 128 -> 128 -> 1 scoring head."""

    def __init__(self, cin: int, dtype: torch.dtype = F32):
        super().__init__()
        self.fc1 = nn.Linear(cin, 128)
        self.fc2 = nn.Linear(128, 128)
        self.fc3 = nn.Linear(128, 1)
        self.dtype = dtype

    def forward(self, x: Tensor) -> Tensor:
        dt = self.dtype
        h = F.relu(dense(self.fc2, F.relu(dense(self.fc1, x, dt)), dt))
        return dense(self.fc3, h, dt)[..., 0]


class S2DMatching(nn.Module):
    """Score logits [N, M] = MLP(desc3d[n] * desc2d[m]), in row tiles of
    min(row_tile, N) rows (the last one zero-padded, as the JAX package
    tiles its lax.map) so the [tile, M, C] product stays bounded."""

    def __init__(self, cin: int, row_tile: int = 64, dtype: torch.dtype = F32):
        super().__init__()
        self.mlps = ScoreMLP(cin, dtype)
        self.row_tile = row_tile

    def forward(self, desc3d: Tensor, desc2d: Tensor) -> Tensor:
        N, C = desc3d.shape
        tile = min(self.row_tile, N)
        d3 = F.pad(desc3d, (0, 0, 0, -N % tile))
        shape = (tile, desc2d.shape[0], C)
        return torch.cat([self.mlps(bcast(blk[:, None, :], shape) * bcast(desc2d[None], shape))
                          for blk in torch.split(d3, tile)], dim=0)[:N]


def sigmoid_focal_loss(logits: Tensor, targets: Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> Tensor:
    """Elementwise focal binary cross-entropy on logits."""
    pred = torch.sigmoid(logits)
    alpha_w = targets * alpha + (1.0 - targets) * (1.0 - alpha)
    pt = targets * (1.0 - pred) + (1.0 - targets) * pred
    bce = (torch.clamp(logits, min=0.0) - logits * targets
           + torch.log1p(torch.exp(-torch.abs(logits))))
    return alpha_w * torch.pow(pt, gamma) * bce


def coarse_loss(conf_logits: Tensor, conf_gt: Tensor,
                valid: Optional[Tensor] = None) -> Tensor:
    """Mean focal loss over the [N, M] score grid (over `valid` cells)."""
    loss = sigmoid_focal_loss(conf_logits, conf_gt)
    if valid is None:
        return torch.mean(loss)
    w = valid.to(loss.dtype)
    return torch.sum(loss * w) / torch.clamp(torch.sum(w), min=1.0)


def mutual_nearest_matches(scores: Tensor, thr: float) -> Tuple[Tensor, Tensor]:
    """(match_j [N], match_mask [N]) of mutual row/column maxima > thr;
    argmax takes the first maximum, as jnp.argmax does."""
    j_best = torch.argmax(scores, dim=1)
    row_max = torch.amax(scores, dim=1)
    col_max = torch.amax(scores, dim=0)
    mutual = row_max >= col_max[j_best]
    return j_best, mutual & (row_max > thr)


def gather_windows(feat: Tensor, centers: Tensor, window: int
                   ) -> Tuple[Tensor, Tensor]:
    """[window^2] patches of an [H, W, C] map around integer (x, y) centers
    [M, 2]; out-of-bounds taps are zero. -> (patches [M, ww, C], valid)."""
    H, W, C = feat.shape
    r = window // 2
    off = torch.arange(-r, r + 1, device=feat.device)
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    px = centers[:, 0:1] + ox.reshape(1, -1)
    py = centers[:, 1:2] + oy.reshape(1, -1)
    inb = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    idx = torch.clamp(py, 0, H - 1) * W + torch.clamp(px, 0, W - 1)
    patches = feat.reshape(H * W, C)[idx] * inb[..., None].to(feat.dtype)
    return patches, inb


class FinePreprocess(nn.Module):
    def __init__(self, cin: int, out_channels: int, dtype: torch.dtype = F32):
        super().__init__()
        self.proj = nn.Linear(cin, out_channels)
        self.dtype = dtype

    def forward(self, patches: Tensor) -> Tensor:
        return dense(self.proj, patches, self.dtype)


class FineMatching(nn.Module):
    """Expected window coordinate (x, y in [-1, 1]) and its spread."""

    def __init__(self, cin: int, dtype: torch.dtype = F32):
        super().__init__()
        self.mlps = ScoreMLP(cin, dtype)

    def forward(self, feat3d: Tensor, feat2d_win: Tensor) -> Tensor:
        M, WW, C = feat2d_win.shape
        W = int(round(WW ** 0.5))
        sim = self.mlps(bcast(feat3d[:, None, :], feat2d_win.shape) * feat2d_win)
        # below f32 the softmax's division meets the f32 grid (so is f32)
        heat = softmax(sim / const(C ** 0.5, sim), dim=1, f32_out=True)
        lin = torch.linspace(-1.0, 1.0, W, device=heat.device, dtype=heat.dtype)
        gy, gx = torch.meshgrid(lin, lin, indexing="ij")
        grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)
        coords = heat @ grid
        var = heat @ grid ** 2 - coords ** 2
        std = torch.sum(torch.sqrt(torch.clamp(var, min=1e-10)), dim=-1)
        return torch.cat([coords, std[:, None]], dim=-1)


def _correct_pairs(expec_f_gt: Tensor, pair_mask: Tensor, thr: float) -> Tensor:
    return (torch.amax(torch.abs(expec_f_gt), dim=1) < thr) & pair_mask


def fine_loss_l2_std(expec_f: Tensor, expec_f_gt: Tensor, pair_mask: Tensor,
                     correct_thr: float = 1.0) -> Tensor:
    """Squared offset error of the pairs whose target lies inside the
    window, each weighted by its inverse spread over the mean inverse
    spread of the pairs (the weight carries no gradient)."""
    correct = _correct_pairs(expec_f_gt, pair_mask, correct_thr)
    inv_std = 1.0 / torch.clamp(expec_f[:, 2], min=1e-10)
    w_all = pair_mask.to(inv_std.dtype)
    mean_inv = torch.sum(inv_std * w_all) / torch.clamp(torch.sum(w_all), min=1.0)
    weight = (inv_std / torch.clamp(mean_inv, min=1e-10)).detach()
    offset_l2 = torch.sum((expec_f_gt - expec_f[:, :2]) ** 2, dim=-1)
    c = correct.to(offset_l2.dtype)
    return torch.sum(offset_l2 * c * weight) / torch.clamp(torch.sum(c), min=1.0)


def fine_loss_l2(expec_f: Tensor, expec_f_gt: Tensor, pair_mask: Tensor,
                 correct_thr: float = 1.0) -> Tensor:
    """Mean squared offset error of the pairs whose target lies inside the
    window."""
    correct = _correct_pairs(expec_f_gt, pair_mask, correct_thr)
    offset_l2 = torch.sum((expec_f_gt - expec_f[:, :2]) ** 2, dim=-1)
    w = correct.to(offset_l2.dtype)
    return torch.sum(offset_l2 * w) / torch.clamp(torch.sum(w), min=1.0)
