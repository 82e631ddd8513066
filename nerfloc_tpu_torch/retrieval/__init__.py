"""Image retrieval: global descriptors (NetVLAD, AP-GeM) and the pipeline
that writes each scene's image_retrieval_{split}_{method}.pkl. Methods
register a descriptor model factory by name; 'oracle' ranks by pose and
needs no model."""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from .gem import GeMDescriptor
from .netvlad import NetVLAD

_REGISTRY: Dict[str, Callable[[], nn.Module]] = {}


def register_retrieval_model(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def _torchvision_init(model: nn.Module) -> None:
    """torchvision's initialization of VGG and ResNet: convolutions He-normal
    over fan-out with zero bias, linear layers N(0, 0.01) with zero bias.
    (torch's default biases, uniform in +-1/sqrt(fan_in), outgrow the
    shrinking ReLU signal over VGG16's 13 layers, and every image then gets
    nearly the same descriptor.)"""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            if isinstance(m, nn.Conv2d):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")
            else:
                nn.init.normal_(m.weight, 0.0, 0.01)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


def get_retrieval_model(name: str, seed: int = 0) -> nn.Module:
    """The method's model on the CPU in eval mode, its weights drawn under
    `seed` as torchvision initializes VGG and ResNet (no pretrained
    weights)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown retrieval method {name!r}; known: "
                       f"{sorted(_REGISTRY) + ['oracle']}")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = _REGISTRY[name]()
        _torchvision_init(model)
    return model.eval()


@register_retrieval_model("netvlad")
def _netvlad() -> nn.Module:
    return NetVLAD()


@register_retrieval_model("dir")
def _dir() -> nn.Module:
    return GeMDescriptor()


__all__ = ["NetVLAD", "GeMDescriptor", "get_retrieval_model", "register_retrieval_model"]
