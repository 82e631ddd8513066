"""Fused neighbour aggregation: CUDA kernel, plain version and wrapper.

Counterpart of nerfloc_tpu/ops/fused_agg.py. The TPU kernel it replaces is
the Pallas `_kernel` reached through `fused_neighbor_agg` /
`_fused_fwd_impl` (pl.pallas_call at nerfloc_tpu/ops/fused_agg.py:279). It
fuses the tail of ConditionalNeRF.query: offsets -> frequency embedding ->
ray-diff MLP -> base_mlp -> 4-head Lq=1 attention -> residual LayerNorm.

On Hopper the kernel is csrc/fused_agg.cu (hand-written CUDA C++, built by
ops/native.py), in two instantiations, as the Pallas kernel has two
(`dt`): f32, whose seven matrix products run on the tensor cores as 3xTF32
(f32 accuracy; wgmma for 64-row tiles, mma.sync for smaller ones), and
bf16 (mv_agg and nb_feat in bf16, one bf16 MMA per product; rounding where
the Pallas kernel rounds): for tiles of 64 and 128 rows `fused_agg_wide`,
whose consumer warpgroups of 64 rows share one weight ring and keep their
wgmma products in flight, and for 16- and 32-row tiles (launches too small
to fill the card with those, the query's K = 1 launch among them)
`fused_agg_cluster`, thread-block clusters of CLUSTER_CTAS CTAs that hold
the weights once between them, rounded from the f32 parameters by their
own threads (nothing packed), read across the cluster by mma.sync. The
rings are filled with cp.async.bulk ahead of need; a tile's activations
stay in shared memory, so device memory sees each input once and each
output once (see the source's header note). The output is f32 either way.

- `reference_agg`: the plain PyTorch version of JAX's reference_agg, at
  f32 or bf16. f32 CPU tensors take it; the backward replays it at the
  forward's dtype (as JAX's custom VJP does).
- `kernel_agg`: the plain version of the bf16 instantiation, rounding
  where the Pallas kernel at dt=bf16 rounds. bf16 CPU tensors take it.
- `pack_agg_weights`: the seven products in the ring's order and MMA
  layout (one of four; the bf16 mma.sync one is the layout the cluster
  tiles build in shared memory themselves), built on the device with one
  gather per call.
- `tile_options`, `tile_samples`, `tile_plan`, `tile_cluster`: the tiles a
  launch can take, the samples a tile holds, the tile a launch takes, the
  CTAs of its clusters; `weight_stream_bytes`: the weights a launch reads
  from L2.
- `fused_neighbor_agg`: the wrapper. CPU inputs -> the plain version; CUDA
  inputs -> the kernel (or an error; there is no fallback).
- `LAUNCHES`, `LAUNCHES_BF16`: launches of the f32 and of the bf16
  instantiation (plain integer attribute `n`).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..utils.profiling import span
from . import native

Tensor = torch.Tensor

N_HEAD, D_K = 4, 32
HD = N_HEAD * D_K             # 128: attention width, and the padded W
LN_EPS = 1e-6
LEAK = 0.01
# rows (T*K, padded) of one CTA, f32 and bf16
TILE_ROWS = {False: (16, 32, 64), True: (16, 32, 64, 128)}
# tiles of this many rows and more run their products as wgmma; a bf16 one
# has a consumer warpgroup for each WGMMA_ROWS rows
WGMMA_ROWS = 64
# bf16 tiles of fewer rows run as thread-block clusters of this many CTAs,
# which hold the weights once between them (csrc/fused_agg.cu,
# fused_agg_cluster)
CLUSTER_CTAS = 4
PARAM_KEYS = ("rd_w1", "rd_b1", "rd_w2", "rd_b2", "b_w0p", "b_b0", "b_w1",
              "b_b1", "b_w2", "b_b2", "a_wq", "a_wk", "a_wv", "a_wfc",
              "ln_s", "ln_b")
# products in the order the kernel's weight ring streams them
RING_KEYS = ("b_w0p", "b_w1", "b_w2", "a_wv", "a_wk", "a_wq", "a_wfc")


class LaunchCount:
    """Number of times a wrapper launched its kernel."""

    def __init__(self) -> None:
        self.n = 0


LAUNCHES = LaunchCount()
LAUNCHES_BF16 = LaunchCount()


def _leaky(x: Tensor) -> Tensor:
    """max(x, 0.01 x); below f32 the slope is rounded to x's dtype first, as
    JAX rounds a Python scalar to a bf16 operand's dtype."""
    if x.dtype == torch.float32:
        return torch.maximum(x, LEAK * x)
    return torch.maximum(x, x * torch.tensor(LEAK, dtype=x.dtype))


def emb_perm(F: int, feat_dim: int, rdfc_dim: int) -> Tuple[int, ...]:
    """Row permutation taking base_mlp fc0 from the module's input layout
    [feat | x | sin f0 | cos f0 | sin f1 | ...] to the fused layout
    [feat | x | sin f0..fF | cos f0..fF | rdfc]."""
    rows = list(range(feat_dim))
    base = feat_dim
    rows += [base + d for d in range(3)]
    for trig in (0, 1):
        for k in range(F):
            rows += [base + 3 + 6 * k + 3 * trig + d for d in range(3)]
    base2 = feat_dim + 3 + 6 * F
    rows += [base2 + d for d in range(rdfc_dim)]
    return tuple(rows)


@functools.lru_cache(maxsize=None)
def _emb_perm_index(F: int, feat_dim: int, rdfc_dim: int,
                    device: torch.device) -> Tensor:
    """`emb_perm` as an index tensor on `device`, copied there once."""
    return torch.tensor(emb_perm(F, feat_dim, rdfc_dim), device=device)


def extract_agg_params(nerf, feat_dim: int) -> Dict[str, Tensor]:
    """Fused-segment weights of a port ConditionalNeRF in [in, out] layout,
    base_mlp fc0 rows permuted by `emb_perm`."""
    rd, bm, at = nerf.ray_diff_fc, nerf.base_mlp, nerf.base_mlp_attn
    perm = _emb_perm_index(len(nerf.xyz_embed.freqs), feat_dim,
                           rd.fc1.out_features, bm.fc0.weight.device)
    t = lambda lin: lin.weight.t().contiguous()  # noqa: E731
    return {
        "rd_w1": t(rd.fc0), "rd_b1": rd.fc0.bias,
        "rd_w2": t(rd.fc1), "rd_b2": rd.fc1.bias,
        "b_w0p": bm.fc0.weight.t()[perm].contiguous(), "b_b0": bm.fc0.bias,
        "b_w1": t(bm.fc1), "b_b1": bm.fc1.bias,
        "b_w2": t(bm.fc2), "b_b2": bm.fc2.bias,
        "a_wq": t(at.w_qs), "a_wk": t(at.w_ks), "a_wv": t(at.w_vs),
        "a_wfc": t(at.fc),
        "ln_s": at.layer_norm.weight, "ln_b": at.layer_norm.bias,
    }


def _rdiff(direction: Tensor, nb_dir: Tensor) -> Tensor:
    """[normalize(dir - nb_dir) | dir . nb_dir] [N, K, 4] (f32)."""
    d3 = direction[:, None, :3]
    diff = d3 - nb_dir[..., :3]
    n = torch.sqrt(torch.sum(diff * diff, dim=-1, keepdim=True) + 1e-12)
    rd = diff / torch.clamp(n, min=1e-6)
    rdot = torch.sum(d3 * nb_dir[..., :3], dim=-1, keepdim=True)
    return torch.cat([rd, rdot], dim=-1)


def _layer_norm(y: Tensor, params: Dict[str, Tensor]) -> Tensor:
    return torch.nn.functional.layer_norm(
        y, y.shape[-1:], params["ln_s"], params["ln_b"], eps=LN_EPS)


def reference_agg(xyz: Tensor, direction: Tensor, mv_agg: Tensor,
                  nb_xyz: Tensor, nb_dir: Tensor, nb_feat: Tensor,
                  scale: Tensor, params: Dict[str, Tensor],
                  freqs: Tensor,
                  matmul: Callable[[Tensor, Tensor], Tensor] = torch.matmul,
                  dtype: torch.dtype = torch.float32) -> Tensor:
    """Plain PyTorch version of the fused segment -> feature_agg [N, W] f32.
    `matmul` computes the seven weight products (tests swap in an
    emulation of the kernel's arithmetic). dtype=bf16 casts where JAX's
    reference_agg(dt=bf16) casts: the embedding, rdiff and features, every
    weight and bias, mv_agg; the phases, sin/cos and the LayerNorm stay
    f32."""
    if dtype != torch.float32:
        return _reference_agg_lowp(xyz, direction, mv_agg, nb_xyz, nb_dir, nb_feat,
                                   scale, params, freqs, dtype)
    off = (xyz[:, None, :] - nb_xyz) / scale
    ph = off[..., None, :] * freqs[:, None]                  # [N, K, F, 3]
    emb = torch.cat([off, torch.sin(ph).flatten(-2), torch.cos(ph).flatten(-2)],
                    dim=-1)

    rdiff = _rdiff(direction, nb_dir)
    h = _leaky(rdiff @ params["rd_w1"] + params["rd_b1"])
    rdfc = _leaky(h @ params["rd_w2"] + params["rd_b2"])

    x_in = torch.cat([nb_feat, emb, rdfc], dim=-1)
    h = _leaky(matmul(x_in, params["b_w0p"]) + params["b_b0"])
    h = _leaky(matmul(h, params["b_w1"]) + params["b_b1"])
    pf = _leaky(matmul(h, params["b_w2"]) + params["b_b2"])   # [N, K, W]

    N, K = pf.shape[:2]
    q = matmul(mv_agg, params["a_wq"]) * (1.0 / D_K ** 0.5)
    kk = matmul(pf, params["a_wk"]).reshape(N, K, N_HEAD, D_K)
    vv = matmul(pf, params["a_wv"]).reshape(N, K, N_HEAD, D_K)
    s = torch.einsum("nhd,nkhd->nhk", q.reshape(N, N_HEAD, D_K), kk)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("nhk,nkhd->nhd", a, vv).reshape(N, N_HEAD * D_K)
    y = matmul(o, params["a_wfc"]) + mv_agg
    return _layer_norm(y, params)


def _reference_agg_lowp(xyz, direction, mv_agg, nb_xyz, nb_dir, nb_feat, scale,
                        params, freqs, dt: torch.dtype) -> Tensor:
    """reference_agg below f32, rounding where XLA rounds JAX's
    reference_agg(dt=bf16): each product of dt operands and each
    elementwise dt result is rounded to dt, except where the result goes
    straight into an f32 sum or an f32 cast (XLA then computes the step in
    f32): the per-head scores, the softmax's denominator and the weighted
    values are f32 sums of unrounded terms, the residual sum is f32."""
    w = {k: v.to(dt) for k, v in params.items() if k not in ("ln_s", "ln_b")}
    off = (xyz[:, None, :] - nb_xyz) / scale
    ph = off[..., None, :] * freqs[:, None]
    emb = torch.cat([off.to(dt), torch.sin(ph).flatten(-2).to(dt),
                     torch.cos(ph).flatten(-2).to(dt)], dim=-1)
    h = _leaky(_rdiff(direction, nb_dir).to(dt) @ w["rd_w1"] + w["rd_b1"])
    rdfc = _leaky(h @ w["rd_w2"] + w["rd_b2"])
    x_in = torch.cat([nb_feat.to(dt), emb, rdfc], dim=-1)
    h = _leaky(x_in @ w["b_w0p"] + w["b_b0"])
    h = _leaky(h @ w["b_w1"] + w["b_b1"])
    pf = _leaky(h @ w["b_w2"] + w["b_b2"])
    N, K = pf.shape[:2]
    mv = mv_agg.to(dt)
    q = (mv @ w["a_wq"]) * torch.tensor(1.0 / D_K ** 0.5, dtype=dt)
    kk = (pf @ w["a_wk"]).reshape(N, K, N_HEAD, D_K)
    vv = (pf @ w["a_wv"]).reshape(N, K, N_HEAD, D_K)
    s = (q.reshape(N, 1, N_HEAD, D_K).float() * kk.float()).sum(dim=-1).to(dt)  # [N, K, H]
    e = torch.exp((s - s.max(dim=1, keepdim=True)[0]).float())
    a = e.to(dt) / e.sum(dim=1, keepdim=True).to(dt)
    o = (a.float()[..., None] * vv.float()).sum(dim=1).to(dt).reshape(N, HD)
    y = (o @ w["a_wfc"]).float() + mv.float()
    return _layer_norm(y, params)


def kernel_agg(xyz: Tensor, direction: Tensor, mv_agg: Tensor, nb_xyz: Tensor,
               nb_dir: Tensor, nb_feat: Tensor, scale: Tensor,
               params: Dict[str, Tensor], freqs: Tensor) -> Tensor:
    """Plain version of the bf16 instantiation -> feature_agg [N, W] f32.

    It rounds where the Pallas `_kernel` at dt=bf16 rounds
    (nerfloc_tpu/ops/fused_agg.py:88-140): every product of bf16 operands
    is summed in f32 and rounded to bf16, then its bias added in bf16; fc0
    is the bf16 sum of its five block products (features, offsets, sin,
    cos, rdfc); leaky ReLU rounds 0.01 x; q is scaled by bf16(1/sqrt(32));
    each q.k product is rounded before the f32 per-head sums; exp(s - max)
    and 1/sum are rounded before they meet v, the sum of e v stays f32 and
    the attention output is rounded; o + mv and the LayerNorm are f32 (XLA
    computes a bf16 sum that is cast to f32 at once in f32: JAX writes
    (o + mv).astype(f32)). The CUDA kernel sums fc0's blocks alike
    (csrc/fused_agg.cu)."""
    bf = torch.bfloat16

    def mm(x: Tensor, w: Tensor, b: Optional[Tensor] = None) -> Tensor:
        y = (x.to(bf).float() @ w.to(bf).float()).to(bf)
        return y if b is None else y + b.to(bf)

    p = params
    F, NF = nb_feat.shape[-1], freqs.shape[0]
    w_feat, w_off, w_sin, w_cos, w_rdfc = p["b_w0p"].split(
        [F, 3, 3 * NF, 3 * NF, p["rd_w2"].shape[1]])
    off = (xyz[:, None, :] - nb_xyz) / scale
    ph = (off[..., None, :] * freqs[:, None]).flatten(-2)
    h0 = mm(nb_feat, w_feat) + mm(off, w_off) + mm(torch.sin(ph), w_sin) \
        + mm(torch.cos(ph), w_cos)
    rdfc = _leaky(mm(_leaky(mm(_rdiff(direction, nb_dir), p["rd_w1"], p["rd_b1"])),
                     p["rd_w2"], p["rd_b2"]))
    h = _leaky(h0 + mm(rdfc, w_rdfc) + p["b_b0"].to(bf))
    h = _leaky(mm(h, p["b_w1"], p["b_b1"]))
    pf = _leaky(mm(h, p["b_w2"], p["b_b2"]))
    N, K = pf.shape[:2]
    mv = mv_agg.to(bf)
    q = mm(mv, p["a_wq"]) * torch.tensor(1.0 / D_K ** 0.5, dtype=bf)
    kk = mm(pf, p["a_wk"]).reshape(N, K, N_HEAD, D_K)
    vv = mm(pf, p["a_wv"]).reshape(N, K, N_HEAD, D_K).float()
    s = (q.reshape(N, 1, N_HEAD, D_K) * kk).float().sum(dim=-1)   # [N, K, H]
    e = torch.exp(s - s.max(dim=1, keepdim=True)[0])
    num = (e.to(bf).float()[..., None] * vv).sum(dim=1)            # [N, H, D]
    rec = (1.0 / e.sum(dim=1)).to(bf).float()
    attn = (num * rec[..., None]).reshape(N, HD).to(bf)
    y = mm(attn, p["a_wfc"]).float() + mv.float()
    return _layer_norm(y, params)


# ---------------------------------------------------------------------------
# Weight ring layout (mirrors make_plan and gemm in csrc/fused_agg.cu)
# ---------------------------------------------------------------------------

def _emb_blocks(NF: int, RD2: int, depth: int) -> Tuple[int, int, int, int]:
    """First embedding column of the off, sin, cos and rdfc blocks: packed
    in f32, each on a whole k-step of 16 in bf16 (fc0 sums their products
    block by block there)."""
    if depth == 8:
        return 0, 3, 3 + 3 * NF, 3 + 6 * NF
    trig = -(-3 * NF // depth) * depth
    return 0, depth, depth + trig, depth + 2 * trig


def ring_widths(F: int, NF: int, RD2: int, depth: int = 8) -> Tuple[int, int]:
    """(Fp, fin_p): fc0's padded depth. The kernel reads k < Fp from the
    features (rows beyond F are zero weights) and Fp <= k < fin_p from the
    embedding [off(3) | sin(3NF) | cos(3NF) | rdfc(RD2) | 0] (its blocks
    as _emb_blocks places them); both are multiples of the MMA depth (8 in
    f32, 16 in bf16), fin_p of a ring stage (two MMA depths)."""
    Fp = -(-F // depth) * depth
    emb = _emb_blocks(NF, RD2, depth)[3] + RD2
    return Fp, -(-(Fp + emb) // (2 * depth)) * 2 * depth


def _fragment_order(m: Tensor, layout: str) -> Tensor:
    """[Kp, 128] (k, n) -> the ring's flat order, per k-step.

    "mma" (f32 16/32-row tiles, k-steps of 8): warp w's lane (g, t) =
    (lane // 4, lane % 4) reads its B fragments of n-tiles j = 2 jh + jl
    (b0: k = t, b1: k = t + 4; n = 32 w + 8 j + g) as the float4s at
    (w, jh) = 128 (2 w + jh) + 4 lane: [ks, w, jh, g, t, jl, e]. "wgmma"
    (f32 64-row tiles): core matrices of 8 n-rows x 4 k, k-half major:
    [ks, kh, ng, r, c] with k = 4 kh + c, n = 8 ng + r. "bf16" (k-steps of
    16, mma.sync m16n8k16): lane (g, t) of warp w reads the 16 bytes at
    (w, jh) of n-tiles j = 2 jh + jl, as b0 = k (2t, 2t + 1) and b1 = k
    (2t + 8, 2t + 9), two bf16 a word: [ks, w, jh, g, t, jl, kh, e] with
    k = 8 kh + 2 t + e, n = 32 w + 16 jh + 8 jl + g. "bf16_wgmma" (bf16
    64-row tiles, k-steps of 16): wgmma's core matrices of 8 n-rows x 8 k,
    k-half major: [ks, kh, ng, r, c] with k = 8 kh + c, n = 8 ng + r."""
    Kp = m.shape[0]
    if layout == "wgmma":
        return m.reshape(Kp // 8, 2, 4, 16, 8).permute(0, 1, 3, 4, 2).reshape(-1)
    if layout == "bf16_wgmma":
        return m.reshape(Kp // 16, 2, 8, 16, 8).permute(0, 1, 3, 4, 2).reshape(-1)
    if layout == "bf16":
        return m.reshape(Kp // 16, 2, 4, 2, 4, 2, 2, 8).permute(
            0, 4, 5, 7, 2, 6, 1, 3).reshape(-1)
    return m.reshape(Kp // 8, 2, 4, 4, 2, 2, 8).permute(0, 3, 4, 6, 2, 5, 1).reshape(-1)


def tf32_rna(x: Tensor) -> Tensor:
    """x rounded to TF32 (cvt.rna: nearest, ties away from zero) on the
    int32 view, as f32."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _row_maps(F: int, NF: int, RD2: int, W: int, depth: int) -> Tuple[Tensor, ...]:
    """Source row of each padded k (or -1) for the seven ring products."""
    Fp, fin_p = ring_widths(F, NF, RD2, depth)
    c = torch.arange(fin_p)
    fc0 = torch.where(c < F, c, -1)
    src = F                              # fin rows: [feat | off | sin | cos | rdfc]
    for col, n in zip(_emb_blocks(NF, RD2, depth), (3, 3 * NF, 3 * NF, RD2)):
        inside = (c >= Fp + col) & (c < Fp + col + n)
        fc0 = torch.where(inside, c - Fp - col + src, fc0)
        src += n
    k = torch.arange(HD)
    w_in = torch.where(k < W, k, -1)
    return (fc0, w_in, w_in, w_in, w_in, w_in, k)


@functools.lru_cache(maxsize=None)
def _pack_index(F: int, NF: int, RD2: int, W: int, layout: str,
                device: torch.device) -> Tensor:
    """Gather index from cat(flattened RING_KEYS tensors, [0.]) to the
    packed ring buffer of `layout` (see _fragment_order); padding points at
    the trailing zero. Built on the host once per shape and device."""
    shapes = _ring_src_shapes(F, NF, RD2, W)
    numel = [r * c for r, c in shapes]
    zero = sum(numel)
    parts, base = [], 0
    n = torch.arange(HD)
    depth = 16 if layout.startswith("bf16") else 8
    for (rows, cols), rmap, size in zip(shapes, _row_maps(F, NF, RD2, W, depth), numel):
        idx = base + rmap[:, None] * cols + n[None, :]
        valid = (rmap[:, None] >= 0) & (n[None, :] < cols)
        parts.append(_fragment_order(torch.where(valid, idx, zero), layout))
        base += size
    return torch.cat(parts).to(device)


def _ring_src_shapes(F: int, NF: int, RD2: int, W: int) -> Tuple[Tuple[int, int], ...]:
    fin = F + 3 + 6 * NF + RD2
    return ((fin, W), (W, W), (W, W), (W, HD), (W, HD), (W, HD), (HD, W))


def pack_agg_weights(params: Dict[str, Tensor], F: int, NF: int,
                     wgmma: bool = False, dtype: torch.dtype = torch.float32) -> Tensor:
    """The seven products of `params` ([in, out] layout, fc0 permuted) as
    the kernel's ring reads them: each zero-padded to [Kp, 128] (fc0 rows
    to fin_p, W to 128) and put in the fragment order of `_fragment_order`.
    For wgmma (f32 64-row tiles) each k-step's [8, 128] tile is stored
    twice, big = tf32_rna(w) then small = tf32_rna(w - big). For the bf16
    instantiation (dtype=bf16) the weights are rounded to bf16 to nearest
    even, as astype rounds, in the mma.sync or (tiles of 64 rows and more)
    the wgmma layout. One cat and one gather on the
    params' device; the index is cached, not the weights (they may change
    between calls)."""
    W = params["b_b0"].shape[0]
    RD2 = params["rd_w2"].shape[1]
    flat = [params[k].reshape(-1) for k in RING_KEYS]
    src = torch.cat(flat + [flat[0].new_zeros(1)])
    if dtype == torch.bfloat16:
        layout = "bf16_wgmma" if wgmma else "bf16"
        return src.to(dtype)[_pack_index(F, NF, RD2, W, layout, src.device)]
    if dtype != torch.float32:
        raise TypeError(f"fused_agg: no {dtype} instantiation")
    packed = src[_pack_index(F, NF, RD2, W, "wgmma" if wgmma else "mma", src.device)]
    if not wgmma:
        return packed
    tiles = packed.view(-1, 8 * HD)
    big = tf32_rna(tiles)
    return torch.stack([big, tf32_rna(tiles - big)], dim=1).reshape(-1)


def tile_options(K: int, bf16: bool = False) -> Tuple[int, ...]:
    """The tile sizes (rows of one CTA) a launch with K neighbours can take
    (TILE_ROWS: f32 tiles of up to 64 rows, bf16 ones of up to 128, 64 rows
    a consumer warpgroup from 64 on, so K <= 64)."""
    if not 1 <= K <= WGMMA_ROWS:
        raise ValueError(f"fused_agg: unsupported K={K}")
    return tuple(r for r in TILE_ROWS[bf16] if r >= K)


def tile_samples(rows: int, K: int, bf16: bool = False) -> int:
    """Samples T one CTA of `rows` rows holds: rows // K, or in bf16 tiles
    of 64 rows and more 64 // K for each warpgroup (a sample's K rows stay
    in one warpgroup)."""
    if bf16 and rows >= WGMMA_ROWS:
        return rows // WGMMA_ROWS * (WGMMA_ROWS // K)
    return rows // K


def tile_plan(N: int, K: int, n_sm: int, bf16: bool = False) -> Tuple[int, int]:
    """(rows, T): rows of one CTA and the T samples it holds (tile_samples);
    CTA b takes samples [b T, min(N, (b + 1) T)).

    f32: the largest tile that still gives every SM a CTA; launches too
    small for that take the smallest tile, to spread over more SMs.
    bf16: the 16-row cluster tile while its grid fills at most 7/8 of the
    SMs, else the 32-row one while its grid holds at most 3/2 CTAs an SM,
    else the 128-row wide tile where it gives 7/8 of the SMs a CTA, else
    the 64-row one. On the H100 a cluster CTA runs fastest alone on its SM
    and its chain is shorter than a wide CTA's, so small launches take the
    cluster tiles (N = 1024: 16 rows at K = 1, 1.31x the old 16-row tile;
    32 rows at K = 8 and N = 256-700, K = 1 and N = 2048-6000); past ~1.5
    CTAs an SM the 64-row wide tile is faster (K = 8, N = 900 and 1024),
    and at the train, refinement and render shapes the 128-row one (two
    CTAs an SM) ran ahead of 64 rows and of four-warpgroup 256-row tiles.
    PERF.md has the times of every tile at each shape, and the shapes
    where the old tiles were faster (K = 8 and N = 512, K = 1 and N =
    4096)."""
    options = tile_options(K, bf16)
    if bf16:
        if 16 in options and cluster_ctas(N, K, 16, CLUSTER_CTAS) * 8 <= n_sm * 7:
            return 16, tile_samples(16, K, True)
        if 32 in options and cluster_ctas(N, K, 32, CLUSTER_CTAS) * 2 <= n_sm * 3:
            return 32, tile_samples(32, K, True)
        rows = 128 if -(-N // tile_samples(128, K, True)) * 8 >= n_sm * 7 else 64
        return rows, tile_samples(rows, K, True)
    for rows in reversed(options):
        if -(-N // tile_samples(rows, K)) >= n_sm:
            return rows, tile_samples(rows, K)
    return options[0], tile_samples(options[0], K)


def tile_cluster(rows: int, bf16: bool = False) -> int:
    """CTAs a cluster of the tile (CLUSTER_CTAS for the bf16 tiles below
    WGMMA_ROWS), 0 for a tile of single CTAs."""
    return CLUSTER_CTAS if bf16 and rows < WGMMA_ROWS else 0


def cluster_ctas(N: int, K: int, rows: int, cluster: int) -> int:
    """CTAs of a cluster launch: a tile of T samples each, rounded up to
    whole clusters (the CTAs past N only hold their share of the weights)."""
    tiles = -(-N // tile_samples(rows, K, True))
    return -(-tiles // cluster) * cluster


def weight_stream_bytes(N: int, K: int, rows: int, F: int, NF: int, RD2: int,
                        bf16: bool = False) -> int:
    """Bytes of weights one launch reads from L2 into its CTAs' shared
    memory, by count, not measured: every CTA of single-CTA tiles streams
    the whole packed buffer once through its ring; a cluster (tile_cluster)
    reads the f32 parameters (W = HD columns) once for all its CTAs, each
    CTA its own columns (with K = 1 the key and query products are skipped
    either way)."""
    products = 6 if K > 1 else 4
    cs = tile_cluster(rows, bf16)
    if cs:
        fin = F + 3 + 6 * NF + RD2
        f32 = fin * HD + 2 * HD * HD + (products - 3) * HD * HD + HD * HD
        return cluster_ctas(N, K, rows, cs) // cs * f32 * 4
    depth = 16 if bf16 else 8
    _, fin_p = ring_widths(F, NF, RD2, depth)
    per_elem = 2 if bf16 else (8 if rows >= WGMMA_ROWS else 4)   # f32 wgmma: big and small
    stream = (fin_p + products * HD) * HD * per_elem
    return -(-N // tile_samples(rows, K, bf16)) * stream


# ---------------------------------------------------------------------------
# CUDA kernel
# ---------------------------------------------------------------------------

# argument types of the C entry point fused_agg_forward
KERNEL_ARGTYPES = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 18
                   + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    """The bound C entry point (builds the library on first use)."""
    fn = native.load("fused_agg").fused_agg_forward
    fn.argtypes = KERNEL_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def smem_plan(rows: int, T: int, K: int, F: int, NF: int, RD1: int,
              RD2: int, bf16: bool = False) -> Tuple[int, int]:
    """(shared-memory bytes, ring stages) of one CTA of the f32 or bf16
    instantiation, from the kernel's own plan (0 bytes: the tile does not
    fit; 0 stages: a cluster tile, whose weights are resident)."""
    fn = native.load("fused_agg").fused_agg_smem_bytes
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_size_t
    stages = ctypes.c_int(0)
    nbytes = fn(rows, T, K, F, NF, RD1, RD2, int(bf16), ctypes.addressof(stages))
    return int(nbytes), stages.value


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(name: str, t: Tensor, shape: Sequence[int], device,
           dtype: torch.dtype = torch.float32) -> None:
    if t.dtype != dtype:
        raise TypeError(f"fused_agg: {name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"fused_agg: {name} on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_agg: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"fused_agg: {name} must be contiguous")


def launch(xyz: Tensor, direction: Tensor, mv_agg: Tensor, nb_xyz: Tensor,
           nb_dir: Tensor, nb_feat: Tensor, scale: Tensor,
           params: Dict[str, Tensor], freqs: Tensor, rows: int = 0) -> Tensor:
    """Run the CUDA kernel on PyTorch's current stream -> [N, W] f32. The
    instantiation follows mv_agg's dtype: f32, or bf16 (then nb_feat is
    bf16 too and W even); everything else is f32. `rows` overrides
    tile_plan's tile (one of tile_options(K, bf16))."""
    dev = mv_agg.device
    if dev.type != "cuda":
        raise ValueError("fused_agg.launch needs CUDA tensors")
    act = mv_agg.dtype
    if act not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_agg: no {act} instantiation")
    bf16 = act == torch.bfloat16
    N, K, F = nb_feat.shape
    W = mv_agg.shape[1]
    NF = freqs.shape[0]
    RD1, RD2 = params["rd_w1"].shape[1], params["rd_w2"].shape[1]
    if W > HD or RD1 > 32 or RD2 > 32 or (bf16 and W % 2):
        raise ValueError(f"fused_agg: unsupported W={W}, RD1={RD1} or RD2={RD2}")
    if direction.dim() != 2 or direction.shape[0] != N or direction.shape[1] < 3:
        raise ValueError(f"fused_agg: direction has shape {tuple(direction.shape)}")
    _check("xyz", xyz, (N, 3), dev)
    _check("direction", direction, tuple(direction.shape), dev)
    _check("mv_agg", mv_agg, (N, W), dev, act)
    _check("nb_xyz", nb_xyz, (N, K, 3), dev)
    _check("nb_dir", nb_dir, (N, K, 4), dev)
    _check("nb_feat", nb_feat, (N, K, F), dev, act)
    if bf16 and mv_agg.data_ptr() % 4:
        raise ValueError("fused_agg: bf16 mv_agg must start on a 4-byte boundary")
    _check("scale", scale, (), dev)
    _check("freqs", freqs, (NF,), dev)
    shapes = {"rd_w1": (4, RD1), "rd_b1": (RD1,), "rd_w2": (RD1, RD2),
              "rd_b2": (RD2,), "b_b0": (W,), "b_b1": (W,), "b_b2": (W,),
              "ln_s": (W,), "ln_b": (W,),
              **dict(zip(RING_KEYS, _ring_src_shapes(F, NF, RD2, W)))}
    for k in PARAM_KEYS:
        _check(k, params[k], shapes[k], dev)
    if rows:
        if rows not in tile_options(K, bf16):
            raise ValueError(f"fused_agg: rows={rows} with K={K}")
        T = tile_samples(rows, K, bf16)
    else:
        rows, T = tile_plan(N, K, _sm_count(dev), bf16)
    out = torch.empty((N, W), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    # cluster tiles round their share of the f32 weights themselves
    wpack = None if tile_cluster(rows, bf16) else pack_agg_weights(
        params, F, NF, wgmma=rows >= WGMMA_ROWS, dtype=act)
    wmat = (ctypes.c_void_p * len(RING_KEYS))(*[params[k].data_ptr() for k in RING_KEYS])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _kernel_fn()(
        xyz.data_ptr(), direction.data_ptr(), direction.shape[1],
        mv_agg.data_ptr(), nb_xyz.data_ptr(), nb_dir.data_ptr(),
        nb_feat.data_ptr(), scale.data_ptr(), freqs.data_ptr(),
        *[params[k].data_ptr() for k in ("rd_w1", "rd_b1", "rd_w2", "rd_b2")],
        None if wpack is None else wpack.data_ptr(), wmat,
        *[params[k].data_ptr() for k in ("b_b0", "b_b1", "b_b2", "ln_s", "ln_b")],
        out.data_ptr(), N, K, F, W, NF, RD1, RD2, rows, T,
        1.0 / math.sqrt(D_K), int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"fused_agg kernel launch failed: CUDA error {err}")
    (LAUNCHES_BF16 if bf16 else LAUNCHES).n += 1
    return out


class _FusedAgg(torch.autograd.Function):
    """Kernel forward (bf16 on the CPU: its plain version); backward
    replays `reference_agg` at the forward's dtype under autograd (as the
    JAX custom_vjp does)."""

    @staticmethod
    def forward(ctx, xyz, direction, mv_agg, nb_xyz, nb_dir, nb_feat, scale,
                freqs, *pvals):
        params = dict(zip(PARAM_KEYS, pvals))
        ctx.save_for_backward(xyz, direction, mv_agg, nb_xyz, nb_dir, nb_feat,
                              scale, freqs, *pvals)
        fwd = kernel_agg if mv_agg.device.type == "cpu" else launch
        return fwd(xyz, direction, mv_agg, nb_xyz, nb_dir, nb_feat, scale,
                   params, freqs)

    @staticmethod
    def backward(ctx, g):
        with span("fused_agg.replay"):
            saved = ctx.saved_tensors
            freqs = saved[7]
            inputs = [t.detach().requires_grad_(need) for t, need in
                      zip(saved[:7] + saved[8:],
                          ctx.needs_input_grad[:7] + ctx.needs_input_grad[8:])]
            with torch.enable_grad():
                out = reference_agg(*inputs[:7],
                                    dict(zip(PARAM_KEYS, inputs[7:])), freqs,
                                    dtype=inputs[2].dtype)
                wrt = [t for t in inputs if t.requires_grad]
                grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
            res = [next(grads) if t.requires_grad else None for t in inputs]
            return (*res[:7], None, *res[7:])


def fused_neighbor_agg(xyz: Tensor, direction: Tensor, mv_agg: Tensor,
                       nb_xyz: Tensor, nb_dir: Tensor, nb_feat: Tensor,
                       scale: Tensor, params: Dict[str, Tensor],
                       freqs: Tensor) -> Tensor:
    """feature_agg [N, W] f32 for K-neighbour samples.

    xyz [N,3], direction [N,>=3] (contiguous), mv_agg [N,W], nb_xyz [N,K,3],
    nb_dir [N,K,4], nb_feat [N,K,F], scale 0-d, params from
    extract_agg_params, freqs [NF]. mv_agg and nb_feat f32 or both bf16 (the
    bf16 instantiation, JAX's dt=bf16); the rest f32. CPU tensors take the
    plain version (reference_agg in f32, kernel_agg in bf16); CUDA tensors
    launch the kernel."""
    if mv_agg.dtype != nb_feat.dtype or mv_agg.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_agg: mv_agg {mv_agg.dtype} with nb_feat {nb_feat.dtype} "
                        "(both f32 or both bf16)")
    if mv_agg.device.type == "cpu" and mv_agg.dtype == torch.float32:
        return reference_agg(xyz, direction, mv_agg, nb_xyz, nb_dir, nb_feat,
                             scale, params, freqs)
    return _FusedAgg.apply(xyz, direction, mv_agg, nb_xyz, nb_dir, nb_feat,
                           scale, freqs, *[params[k] for k in PARAM_KEYS])
