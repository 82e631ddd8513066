"""dirtorch AP-GeM checkpoint loader and PCA whitening (counterpart of
nerfloc_tpu/retrieval/gem_weights.py).

A dirtorch checkpoint is a torch pickle holding `state_dict`
(torchvision ResNet names at the top level, `adpool.p` for the GeM
exponent, `fc.{weight,bias}` for the projection) and optionally `pca`
(fitted sklearn PCA objects keyed by whitening dataset). The port's
modules keep torchvision's OIHW kernels and [out, in] projections, so the
tensors copy as they are; BatchNorm statistics go to FrozenBatchNorm's
buffers.
"""
from __future__ import annotations

import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .gem import GeMDescriptor

BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def infer_blocks(sd: Dict[str, np.ndarray]) -> Tuple[int, ...]:
    """Bottleneck counts per layer from the state dict's keys (resnet50
    (3, 4, 6, 3), resnet101 (3, 4, 23, 3))."""
    blocks = []
    for li in range(1, 5):
        n = 0
        while f"layer{li}.{n}.conv1.weight" in sd:
            n += 1
        if n == 0:
            raise KeyError(f"state dict has no layer{li} bottlenecks")
        blocks.append(n)
    return tuple(blocks)


def _state_map(blocks: Tuple[int, ...]) -> Dict[str, str]:
    """The port module's state-dict name for each torchvision name."""
    out = {"conv1.weight": "trunk.conv1.weight"}
    out.update({f"bn1.{k}": f"trunk.bn1.{k}" for k in BN_KEYS})
    for li, n in enumerate(blocks, start=1):
        for i in range(n):
            src, dst = f"layer{li}.{i}", f"trunk.layer{li}_{i}"
            for c in (1, 2, 3):
                out[f"{src}.conv{c}.weight"] = f"{dst}.conv{c}.weight"
                out.update({f"{src}.bn{c}.{k}": f"{dst}.bn{c}.{k}" for k in BN_KEYS})
            if i == 0:
                out[f"{src}.downsample.0.weight"] = f"{dst}.downsample_conv.weight"
                out.update({f"{src}.downsample.1.{k}": f"{dst}.downsample_bn.{k}"
                            for k in BN_KEYS})
    out.update({"fc.weight": "whiten.weight", "fc.bias": "whiten.bias"})
    return out


def port_dirtorch_gem(sd: Dict[str, np.ndarray]) -> GeMDescriptor:
    """numpy state dict (dirtorch ResNet_RMAC names) -> the port's
    GeMDescriptor on the CPU. A missing adpool.p takes the reference's
    gemp = 3."""
    blocks = infer_blocks(sd)
    fc_w = np.asarray(sd["fc.weight"], np.float32)
    p = float(np.asarray(sd.get("adpool.p", 3.0)).reshape(()))
    model = GeMDescriptor(out_dim=fc_w.shape[0], p_init=p, blocks=blocks)
    state = {dst: torch.from_numpy(np.array(sd[src], dtype=np.float32))
             for src, dst in _state_map(blocks).items()}
    state["p"] = torch.tensor(p, dtype=torch.float32)
    model.load_state_dict(state)
    return model


def _to_numpy_sd(obj) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in obj.items():
        k = k[len("module."):] if k.startswith("module.") else k
        out[k] = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
    return out


def load_dirtorch(path: str):
    """(GeMDescriptor, pca) from a dirtorch checkpoint file (e.g.
    Resnet-101-AP-GeM.pt); pca is its dict of fitted PCA objects, {} when
    absent. The file is a pickle (it runs code: load only checkpoints you
    trust); old ones name sklearn.decomposition.pca, aliased as the
    reference does."""
    try:
        import sklearn.decomposition as _dec
        sys.modules.setdefault("sklearn.decomposition.pca", _dec._pca)
    except ImportError:
        pass
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    pca = ckpt.get("pca", {}) if isinstance(ckpt, dict) else {}
    return port_dirtorch_gem(_to_numpy_sd(sd)), pca


def whiten_features(X: np.ndarray, pca, whitenp: float = 0.25, whitenv: Optional[int] = None,
                    whitenm: float = 1.0, l2norm: bool = True) -> np.ndarray:
    """PCA-whiten descriptors X [N, D] (dirtorch's whiten_features):
    centre, project on the first `whitenv` components, scale by
    singular_values ** -whitenp / whitenm, then L2-normalize."""
    D = X.shape[1] if whitenv is None else whitenv
    comp = np.asarray(pca.components_, np.float32)[:D]
    mean = np.asarray(pca.mean_, np.float32)
    sv = np.asarray(pca.singular_values_, np.float32)[:D]
    out = (X.astype(np.float32) - mean) @ comp.T
    out = out / (whitenm * np.power(sv, whitenp))
    if l2norm:
        out = out / (np.linalg.norm(out, axis=-1, keepdims=True) + 1e-12)
    return out
