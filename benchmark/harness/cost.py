"""Peaks of the card and the work of the fused aggregation, counted from
the shapes of a call (frozen copies of `chip_smoke.agg_cost` and
`agg_bounds`, with the peaks they use)."""
from __future__ import annotations

from typing import Dict, Tuple

# H100 SXM (NVIDIA's data sheet, dense): FP32 outside the tensor cores,
# TF32 and bf16 on the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
HD = 128     # the aggregation's attention width


def agg_cost(N: int, K: int, F: int, W: int, param_shapes: Dict[str, Tuple[int, ...]],
             NF: int, act_bytes: int = 4) -> Tuple[int, int, int]:
    """(product FLOPs, other FLOPs, bytes) one fused aggregation of N
    samples with K neighbours of F features and width W needs: every input
    read once, the output written once; mv_agg and nb_feat take act_bytes
    each (2 in the bf16 instantiation), the rest is f32. With K=1 the
    softmax weight is 1, so the q and k products and the scores are not
    needed. param_shapes: the shape of each of the call's parameters;
    NF: the number of embedding frequencies."""
    RD1, RD2 = param_shapes["rd_w1"][1], param_shapes["rd_w2"][1]
    fin = F + 3 + 6 * NF + RD2
    n_kv = 2 if K > 1 else 1
    prod = (N * K * (2 * fin * W + 2 * 2 * W * W + n_kv * 2 * W * HD)
            + N * ((n_kv - 1) * 2 * W * HD + 2 * HD * W))
    other = (N * K * (2 * (4 * RD1 + RD1 * RD2) + 6 * NF + 3)
             + N * ((2 * 2 * K * HD if K > 1 else 0) + 8 * W))
    n_params = 0
    for s in param_shapes.values():
        n = 1
        for d in s:
            n *= d
        n_params += n
    floats = N * (3 + 4) + N * K * (3 + 4) + 1 + NF + n_params + N * W
    return prod, other, 4 * floats + act_bytes * (N * W + N * K * F)


def agg_bound_s(cost: Tuple[int, int, int], tc: str = "bf16") -> float:
    """The least time the card could take for `cost`: the largest of the
    products at the tensor cores' peak (tf32 or bf16), the other operations
    at the FP32 peak and the bytes at HBM's rate."""
    prod, other, nbytes = cost
    peak = {"tf32": PEAK_TF32_FLOPS, "bf16": PEAK_BF16_FLOPS}[tc]
    return max(prod / peak, other / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)
