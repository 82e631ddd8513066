"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py).

Builds the JAX reference at the tiny config of `__graft_entry__._tiny_cfg()`
with `render.fused_query_agg=True`, and the port's model carrying the same
weights through nerfloc_tpu_torch.weights. Everything runs on the CPU; data
crosses between the frameworks as numpy arrays.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__ as graft
from nerfloc_tpu.models.pose_estimator import NerfPoseEstimator as JaxEstimator
from nerfloc_tpu_torch import configs as tcfg
from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
from nerfloc_tpu_torch.weights import load_flax_variables

CPU = torch.device("cpu")


def jax_cfg():
    cfg = graft._tiny_cfg()
    return dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, fused_query_agg=True))


def port_cfg(cfg):
    """The port's Config with the same field values as a JAX Config."""
    d = dataclasses.asdict(cfg)
    return tcfg.Config(**{**d, "render": tcfg.RenderConfig(**d["render"]),
                          "matching": tcfg.MatchingConfig(**d["matching"]),
                          "shapes": tcfg.StaticShapeConfig(**d["shapes"])})


def to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


class TinySetup:
    """JAX model + variables + batch, and the port model with those weights."""

    def __init__(self):
        self.cfg = jax_cfg()
        self.np_batch = graft._tiny_batch()
        self.batch = {k: jnp.asarray(v) for k, v in self.np_batch.items()}
        self.jmodel = JaxEstimator(self.cfg)
        rng = jax.random.PRNGKey(0)
        self.variables = jax.jit(self.jmodel.init)(rng, self.batch, rng)
        self.np_vars = to_numpy(self.variables)
        self.model = NerfPoseEstimator(port_cfg(self.cfg), device="cpu", seed=1)
        self.unused = load_flax_variables(self.model, self.np_vars)
        self.tbatch = to_device_batch(self.np_batch, CPU)

    def japply(self, fn, *args):
        """Run fn(module, *args) bound to the JAX model's variables."""
        return self.jmodel.apply(self.variables, *args, method=fn)
