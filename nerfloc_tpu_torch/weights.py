"""Weight bridge: flax variables (nested dicts of numpy arrays) -> the
port's modules.

The port's submodules are named after the flax tree, so a module's path
in `named_modules()` is its flax path. Conversions:
  Dense   [in, out]            -> nn.Linear.weight [out, in]
  Conv    [kh, kw, in, out]    -> nn.Conv2d.weight [out, in, kh, kw]
  Conv    [k, in, out] (1-D)   -> nn.Conv1d.weight [out, in, k]
  ConvTranspose [k, in, out]   -> nn.ConvTranspose1d.weight [in, out, k],
          flipped along k: flax's transposed convolution correlates the
          dilated input with the kernel as stored, torch's with its mirror
  MultiHeadDotProductAttention query/key/value [in, heads, hd] and out
          [heads, hd, out] (+ biases [heads, hd] / [out]) -> nn.Linear
  LayerNorm scale/bias         -> weight/bias
  INorm, LayerNormSC scale/bias -> scale/bias
  FrozenBatchNorm ('frozen' collection) -> buffers of the same names
`agg_params_from_flax` builds the fused kernel's weights straight from a
ConditionalNeRF flax tree, as extract_agg_params does in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch
from torch import nn

from .models.backbone import FrozenBatchNorm
from .models.fields.neuray import INorm
from .models.fields.ray_unet import LayerNormSC
from .models.transformer import DotProductAttention
from .ops.fused_agg import emb_perm

Tree = Mapping[str, Any]


def _sub(tree: Tree, path: List[str]) -> Tree:
    for p in path:
        tree = tree[p]
    return tree


def _flat(tree: Tree, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _set(t: torch.Tensor, value: np.ndarray) -> None:
    value = torch.from_numpy(np.array(value, dtype=np.float32))
    if tuple(value.shape) != tuple(t.shape):
        raise ValueError(f"shape {tuple(value.shape)} does not fit {tuple(t.shape)}")
    with torch.no_grad():
        t.copy_(value.to(t.device))


def load_flax_variables(module: nn.Module, variables: Tree) -> List[str]:
    """Copy a flax variables tree ({'params': ..., 'frozen': ...}) into
    `module`, whose flax path is the root of that tree. Every parameter and
    buffer of the module must be found. Returns the flax leaves that have
    no counterpart in the port (none for a model the port covers)."""
    params, frozen = variables["params"], variables.get("frozen", {})
    used = set()

    def take(tree: Tree, path: List[str], coll: str) -> Tree:
        sub = _sub(tree, path)
        for k in _flat(sub):
            used.add((coll,) + tuple(path) + k)
        return sub

    mha = tuple(n + "." for n, m in module.named_modules()
                if isinstance(m, DotProductAttention))
    for name, mod in module.named_modules():
        path = name.split(".") if name else []
        if isinstance(mod, DotProductAttention):
            p = take(params, path, "params")
            for proj in ("query", "key", "value"):
                k = p[proj]["kernel"]
                _set(getattr(mod, proj).weight, k.reshape(k.shape[0], -1).T)
                _set(getattr(mod, proj).bias, p[proj]["bias"].reshape(-1))
            k = p["out"]["kernel"]
            _set(mod.out.weight, k.reshape(-1, k.shape[-1]).T)
            _set(mod.out.bias, p["out"]["bias"])
        elif isinstance(mod, nn.Linear) and not (mha and name.startswith(mha)):
            p = take(params, path, "params")
            _set(mod.weight, p["kernel"].T)
            if mod.bias is not None:
                _set(mod.bias, p["bias"])
        elif isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)):
            p = take(params, path, "params")
            k = np.asarray(p["kernel"])
            if isinstance(mod, nn.ConvTranspose1d):
                k = np.transpose(k[::-1], (1, 2, 0))
            else:
                k = np.transpose(k, (k.ndim - 1, k.ndim - 2) + tuple(range(k.ndim - 2)))
            _set(mod.weight, k)
            if mod.bias is not None:
                _set(mod.bias, p["bias"])
        elif isinstance(mod, nn.LayerNorm):
            p = take(params, path, "params")
            _set(mod.weight, p["scale"])
            _set(mod.bias, p["bias"])
        elif isinstance(mod, (INorm, LayerNormSC)):
            p = take(params, path, "params")
            _set(mod.scale, p["scale"])
            _set(mod.bias, p["bias"])
        elif isinstance(mod, FrozenBatchNorm):
            p = take(frozen, path, "frozen")
            for k in ("weight", "bias", "running_mean", "running_var"):
                _set(getattr(mod, k), p[k])
    leaves = {("params",) + k for k in _flat(params)}
    leaves |= {("frozen",) + k for k in _flat(frozen)}
    return sorted("/".join(k) for k in leaves - used)


def agg_params_from_flax(nerf_params: Tree, n_freqs: int,
                         feat_dim: int) -> Dict[str, torch.Tensor]:
    """Fused-kernel weights from a ConditionalNeRF flax param tree
    ([in, out] layout, base_mlp fc0 rows permuted by emb_perm)."""
    rd, bm, at = (nerf_params["ray_diff_fc"], nerf_params["base_mlp"],
                  nerf_params["base_mlp_attn"])
    perm = np.asarray(emb_perm(n_freqs, feat_dim, rd["fc1"]["kernel"].shape[1]))
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))  # noqa: E731
    return {
        "rd_w1": t(rd["fc0"]["kernel"]), "rd_b1": t(rd["fc0"]["bias"]),
        "rd_w2": t(rd["fc1"]["kernel"]), "rd_b2": t(rd["fc1"]["bias"]),
        "b_w0p": t(bm["fc0"]["kernel"][perm]), "b_b0": t(bm["fc0"]["bias"]),
        "b_w1": t(bm["fc1"]["kernel"]), "b_b1": t(bm["fc1"]["bias"]),
        "b_w2": t(bm["fc2"]["kernel"]), "b_b2": t(bm["fc2"]["bias"]),
        "a_wq": t(at["w_qs"]["kernel"]), "a_wk": t(at["w_ks"]["kernel"]),
        "a_wv": t(at["w_vs"]["kernel"]), "a_wfc": t(at["fc"]["kernel"]),
        "ln_s": t(at["layer_norm"]["scale"]), "ln_b": t(at["layer_norm"]["bias"]),
    }
