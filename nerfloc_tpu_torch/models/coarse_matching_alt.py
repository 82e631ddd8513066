"""Alternative LoFTR-style coarse matching heads, dual-softmax and Sinkhorn
(counterpart of nerfloc_tpu/models/coarse_matching_alt.py): confidence
matrices, mutual-nearest selection in the static (match_j, match_mask)
form of matching.mutual_nearest_matches, and the focal loss on a
confidence matrix."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor
_INF = 1e9


def _mask(sim: Tensor, mask0: Optional[Tensor], mask1: Optional[Tensor]) -> Tensor:
    """-1e9 in the rows of mask0 and the columns of mask1 that are False."""
    if mask0 is not None:
        sim = torch.where(mask0[:, None], sim, torch.full_like(sim, -_INF))
    if mask1 is not None:
        sim = torch.where(mask1[None, :], sim, torch.full_like(sim, -_INF))
    return sim


def dual_softmax_confidence(feat0: Tensor, feat1: Tensor, temperature: float = 0.1,
                            mask0: Optional[Tensor] = None,
                            mask1: Optional[Tensor] = None) -> Tensor:
    """feat0 [L, C], feat1 [S, C] -> conf [L, S] = softmax over L times
    softmax over S of the scaled similarity / temperature."""
    C = feat0.shape[-1]
    sim = (feat0 / C ** 0.5) @ (feat1 / C ** 0.5).T / temperature
    sim = _mask(sim, mask0, mask1)
    return torch.softmax(sim, dim=0) * torch.softmax(sim, dim=1)


def log_optimal_transport(scores: Tensor, bin_score: Tensor, iters: int = 3) -> Tensor:
    """Sinkhorn in log space with a dustbin row and column (SuperGlue's
    formulation): scores [L, S] -> log assignment [L+1, S+1]."""
    L, S = scores.shape
    alpha = torch.as_tensor(bin_score, dtype=scores.dtype, device=scores.device).reshape(1)
    couplings = torch.cat([torch.cat([scores, alpha.expand(L, 1)], dim=1),
                           torch.cat([alpha.expand(1, S), alpha[None]], dim=1)], dim=0)
    log_n = lambda n: torch.log(torch.tensor(float(n), dtype=scores.dtype,  # noqa: E731
                                             device=scores.device))
    norm = -log_n(L + S)
    log_mu = torch.cat([norm.expand(L), (log_n(S) + norm)[None]])
    log_nu = torch.cat([norm.expand(S), (log_n(L) + norm)[None]])
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v[None, :], dim=1)
        v = log_nu - torch.logsumexp(couplings + u[:, None], dim=0)
    return couplings + u[:, None] + v[None, :] - norm


def sinkhorn_confidence(feat0: Tensor, feat1: Tensor, bin_score: Tensor, iters: int = 3,
                        mask0: Optional[Tensor] = None,
                        mask1: Optional[Tensor] = None) -> Tensor:
    """The optimal-transport assignment of the scaled similarity without
    its dustbins, exponentiated: [L, S]."""
    C = feat0.shape[-1]
    sim = _mask((feat0 / C ** 0.5) @ (feat1 / C ** 0.5).T, mask0, mask1)
    return torch.exp(log_optimal_transport(sim, bin_score, iters))[:-1, :-1]


def coarse_match_from_confidence(conf: Tensor, thr: float = 0.2) -> Tuple[Tensor, Tensor]:
    """(match_j [L], match_mask [L]): each row's best column, kept where it
    is also its column's best and above thr (ties to the lower column)."""
    row_max, j_best = torch.max(conf, dim=1)
    col_max = torch.amax(conf, dim=0)
    return j_best, (row_max >= col_max[j_best]) & (row_max > thr)


def coarse_matching_loss(conf: Tensor, conf_gt: Tensor, focal_alpha: float = 0.25,
                         focal_gamma: float = 2.0, pos_weight: float = 1.0,
                         neg_weight: float = 1.0) -> Tensor:
    """Focal BCE on conf [L, S] against the 0/1 conf_gt, averaged over the
    positives and over the negatives apart."""
    conf = torch.clamp(conf, 1e-6, 1.0 - 1e-6)
    pos = conf_gt > 0.5
    pos_loss = -focal_alpha * (1.0 - conf) ** focal_gamma * torch.log(conf)
    neg_loss = -focal_alpha * conf ** focal_gamma * torch.log(1.0 - conf)
    n_pos = torch.clamp(pos.sum(), min=1).to(conf.dtype)
    n_neg = torch.clamp((~pos).sum(), min=1).to(conf.dtype)
    zero = torch.zeros_like(conf)
    return (pos_weight * torch.sum(torch.where(pos, pos_loss, zero)) / n_pos
            + neg_weight * torch.sum(torch.where(~pos, neg_loss, zero)) / n_neg)
