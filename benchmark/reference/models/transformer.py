"""Self/cross attention blocks (counterpart of
nerfloc_tpu/models/transformer.py): one post-norm self-attention layer and
one cross-attention layer per branch, positions added to queries and keys,
LayerNorm eps 1e-6 (flax's default). The attention is plain batched matmuls.
`dtype` is the compute dtype (models/lowp.py) of the projections, scores,
softmax and feed-forward layers; the LayerNorms are f32 (f32 parameters)
and take their residual sums in f32, so each layer's output is f32.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .lowp import F32, const, dense, layer_norm, softmax

Tensor = torch.Tensor
LN_EPS = 1e-6


class DotProductAttention(nn.Module):
    """flax MultiHeadDotProductAttention: biased q/k/v/out projections,
    queries scaled by 1/sqrt(head_dim)."""

    def __init__(self, d_model: int, nhead: int, dtype: torch.dtype = F32):
        super().__init__()
        self.nhead = nhead
        self.dtype = dtype
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def forward(self, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
        B, Lq, C = q.shape
        Lk = k.shape[1]
        hd = C // self.nhead
        dt = self.dtype
        qh = dense(self.query, q, dt).reshape(B, Lq, self.nhead, hd)
        qh = qh / (hd ** 0.5 if dt == F32 else torch.tensor(hd, dtype=F32).sqrt().to(dt))
        kh = dense(self.key, k, dt).reshape(B, Lk, self.nhead, hd)
        vh = dense(self.value, v, dt).reshape(B, Lk, self.nhead, hd)
        w = softmax(torch.einsum("bqhd,bkhd->bhqk", qh, kh), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", w, vh).reshape(B, Lq, C)
        return dense(self.out, out, dt)


def _add(a: Tensor, b: Tensor) -> Tensor:
    """a + b going into a LayerNorm: f32 below f32 (XLA sums in f32 what the
    norm's f32 statistics read at once)."""
    return a + b if a.dtype == b.dtype == F32 else a.float() + b.float()


def _ln(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=LN_EPS)


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.self_attn = DotProductAttention(d_model, nhead, dtype)
        self.norm1 = _ln(d_model)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = _ln(d_model)

    def forward(self, src: Tensor, pos: Tensor) -> Tensor:
        dt = self.dtype
        q = src + pos
        src = layer_norm(self.norm1, _add(src, self.self_attn(q, q, src)))
        ff = dense(self.linear2, F.relu(dense(self.linear1, src, dt)), dt)
        return layer_norm(self.norm2, _add(src, ff))


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.dtype = dtype
        self.cross_attn = DotProductAttention(d_model, nhead, dtype)
        self.norm2 = _ln(d_model)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm3 = _ln(d_model)

    def forward(self, tgt: Tensor, memory: Tensor, query_pos: Tensor,
                pos: Tensor) -> Tensor:
        dt = self.dtype
        tgt = layer_norm(self.norm2, _add(tgt, self.cross_attn(tgt + query_pos, memory + pos,
                                                               memory)))
        ff = dense(self.linear2, F.relu(dense(self.linear1, tgt, dt)), dt)
        return layer_norm(self.norm3, _add(tgt, ff))


class SelfCrossTransformer(nn.Module):
    """Two token sets attend to themselves, then to each other."""

    def __init__(self, d_model: int = 192, nhead: int = 8,
                 dim_feedforward: int = 512, dtype: torch.dtype = F32):
        super().__init__()
        self.self0 = EncoderLayer(d_model, nhead, dim_feedforward, dtype)
        self.self1 = EncoderLayer(d_model, nhead, dim_feedforward, dtype)
        self.cross0 = DecoderLayer(d_model, nhead, dim_feedforward, dtype)
        self.cross1 = DecoderLayer(d_model, nhead, dim_feedforward, dtype)

    def forward(self, v0: Tensor, pos0: Tensor, v1: Tensor, pos1: Tensor
                ) -> Tuple[Tensor, Tensor]:
        """All inputs [B, N, C]."""
        v0 = self.self0(v0, pos0)
        v1 = self.self1(v1, pos1)
        v0b = self.cross0(v0, v1, pos0, pos1)
        return v0b, self.cross1(v1, v0b, pos1, pos0)


class MultiHeadAttention(nn.Module):
    """IBRNet-style attention with residual + LayerNorm and unbiased
    projections (the neighbour aggregation of ConditionalNeRF.query)."""

    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int,
                 dtype: torch.dtype = F32):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.dtype = dtype
        self.w_qs = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_ks = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_vs = nn.Linear(d_model, n_head * d_v, bias=False)
        self.fc = nn.Linear(n_head * d_v, d_model, bias=False)
        self.layer_norm = _ln(d_model)

    def forward(self, q: Tensor, k: Tensor, v: Tensor) -> Tensor:
        B, Lq = q.shape[:2]
        Lk = k.shape[1]
        dt = self.dtype
        qh = dense(self.w_qs, q, dt).reshape(B, Lq, self.n_head, self.d_k).transpose(1, 2)
        kh = dense(self.w_ks, k, dt).reshape(B, Lk, self.n_head, self.d_k).transpose(1, 2)
        vh = dense(self.w_vs, v, dt).reshape(B, Lk, self.n_head, self.d_v).transpose(1, 2)
        attn = softmax((qh / const(self.d_k ** 0.5, qh)) @ kh.transpose(-1, -2), dim=-1)
        out = (attn @ vh).transpose(1, 2).reshape(B, Lq, self.n_head * self.d_v)
        return layer_norm(self.layer_norm, _add(dense(self.fc, out, dt), q))
