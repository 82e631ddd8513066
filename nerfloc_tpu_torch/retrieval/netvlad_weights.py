"""MatConvNet NetVLAD checkpoint loader (counterpart of
nerfloc_tpu/retrieval/netvlad_weights.py).

Reads an hloc `*_struct.mat` export (VGG16 convolutions, the VLAD layer's
soft-assignment projection and negated centers, the PCA whitening as a
1x1 convolution, and the 0-255 average-image preprocessing) into the
port's NetVLAD. Layouts: convolutions S x S x IN x OUT -> OIHW; the VLAD
projection D x K -> nn.Linear [K, D]; centers stored negated, D x K ->
[K, D]; the reference flattens VLAD D-major (index d*K + k) where the
module flattens K-major (k*D + d), so the whitening rows are permuted.
"""
from __future__ import annotations

import numpy as np
import torch

from .netvlad import NetVLAD


def _classify_layers(layers):
    """(VGG convolutions, the VLAD layer, the whitening layer), told apart
    by their weights' shapes: S x S x IN x OUT with S > 1; two 2-D [D, K]
    arrays; a 1x1 convolution (or, after loadmat's squeeze, a 2-D kernel
    with a 1-D bias)."""
    vgg, vlad, whiten = [], None, None
    for layer in layers:
        w = getattr(layer, "weights", None)
        if w is None or (isinstance(w, np.ndarray) and w.dtype != object and w.size == 0):
            continue
        if len(w) < 1:
            continue
        w0 = np.asarray(w[0])
        w1 = np.asarray(w[1]) if len(w) >= 2 else None
        if w0.ndim == 4 and w0.shape[0] > 1:
            vgg.append(layer)
        elif w0.ndim == 4 and w0.shape[0] == 1 and w0.shape[1] == 1:
            whiten = layer
        elif w0.ndim == 2 and w1 is not None and w1.ndim == 2:
            vlad = layer
        elif w0.ndim == 2 and w1 is not None and w1.ndim <= 1:
            whiten = layer
    return vgg, vlad, whiten


def _copy(t: torch.Tensor, value: np.ndarray) -> None:
    value = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))
    if tuple(value.shape) != tuple(t.shape):
        raise ValueError(f"shape {tuple(value.shape)} does not fit {tuple(t.shape)}")
    with torch.no_grad():
        t.copy_(value)


def load_matconvnet_netvlad(path: str, whiten: bool = True) -> NetVLAD:
    """The port's NetVLAD (on the CPU) with the weights and preprocessing
    of an hloc `*_struct.mat` checkpoint."""
    from scipy.io import loadmat

    mat = loadmat(path, struct_as_record=False, squeeze_me=True)
    vgg, vlad_layer, whiten_layer = _classify_layers(list(mat["net"].layers))
    if len(vgg) != 13 or vlad_layer is None:
        raise ValueError(f"unexpected checkpoint structure: {len(vgg)} conv layers, "
                         f"vlad={'yes' if vlad_layer is not None else 'no'}")
    if whiten and whiten_layer is None:
        raise ValueError("whiten=True but no 1x1 whitening layer in .mat")
    kernels = [np.asarray(layer.weights[0], np.float32) for layer in vgg]   # S,S,IN,OUT
    score_w = np.asarray(vlad_layer.weights[0], np.float32)                 # D,K
    centers = -np.asarray(vlad_layer.weights[1], np.float32)                # D,K
    D, K = score_w.shape
    vgg_cfg = []
    for i, k in enumerate(kernels):   # pools after convs 2, 4, 7 and 10
        vgg_cfg.append(k.shape[-1])
        if i + 1 in (2, 4, 7, 10):
            vgg_cfg.append("M")
    out_dim = 4096
    if whiten:
        ww = np.asarray(whiten_layer.weights[0], np.float32).reshape(D * K, -1)
        out_dim = ww.shape[1]
    avg = np.asarray(mat["net"].meta.normalization.averageImage, np.float32).reshape(-1)
    if avg.size == 1:
        avg = np.repeat(avg, 3)
    model = NetVLAD(num_clusters=K, out_dim=out_dim, whiten=whiten, input_scale=255.0,
                    pixel_mean=tuple(avg.tolist()), vgg_cfg=tuple(vgg_cfg))
    for i, (layer, k) in enumerate(zip(vgg, kernels)):
        conv = getattr(model.backbone, f"conv{i}")
        _copy(conv.weight, np.transpose(k, (3, 2, 0, 1)))
        _copy(conv.bias, np.asarray(layer.weights[1], np.float32).reshape(-1))
    _copy(model.assign.weight, score_w.T)
    _copy(model.assign.bias, np.zeros(K, np.float32))
    _copy(model.centers, centers.T)
    if whiten:
        # the reference's VLAD index d*K + k for the module's k*D + d
        ref_rows = (np.arange(K)[:, None] + np.arange(D)[None, :] * K).reshape(-1)
        _copy(model.whiten.weight, ww[ref_rows].T)
        _copy(model.whiten.bias, np.asarray(whiten_layer.weights[1], np.float32).reshape(-1))
    return model
