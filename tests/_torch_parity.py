"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py).

Builds the JAX reference at the tiny config of `__graft_entry__._tiny_cfg()`
with `render.fused_query_agg=True`, and the port's model carrying the same
weights through nerfloc_tpu_torch.weights. Everything runs on the CPU; data
crosses between the frameworks as numpy arrays.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from nerfloc_tpu.models.pose_estimator import NerfPoseEstimator as JaxEstimator
from nerfloc_tpu_torch import configs as tcfg
from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
from nerfloc_tpu_torch.weights import load_flax_variables

CPU = torch.device("cpu")

# One persistent compilation cache for the suite's processes, under the
# run's temporary directory: the port's test files compile the same JAX
# reference graphs (the tiny model's init, its context build), and a
# process loads what another one compiled. A hit loads the executable the
# compile produced, so no result changes.
jax.config.update("jax_compilation_cache_dir",
                  os.path.join(tempfile.gettempdir(), "nerfloc_parity_jax_cache"))


def jax_cfg(**kw):
    """The tiny config with the fused kernel, and any field replaced."""
    cfg = graft._tiny_cfg()
    return dataclasses.replace(
        cfg, render=dataclasses.replace(cfg.render, fused_query_agg=True), **kw)


def port_cfg(cfg):
    """The port's Config with the same field values as a JAX Config."""
    d = dataclasses.asdict(cfg)
    return tcfg.Config(**{**d, "render": tcfg.RenderConfig(**d["render"]),
                          "matching": tcfg.MatchingConfig(**d["matching"]),
                          "shapes": tcfg.StaticShapeConfig(**d["shapes"])})


def to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def t(a) -> torch.Tensor:
    """numpy (or JAX) array -> tensor of the same dtype; bf16 arrays (which
    numpy holds as ml_dtypes.bfloat16) become torch.bfloat16."""
    a = np.array(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


class TinySetup:
    """JAX model + variables + batch, and the port model with those weights
    (cfg_kw: fields of the tiny config to replace)."""

    def __init__(self, **cfg_kw):
        self.cfg = jax_cfg(**cfg_kw)
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


def seeded_variables(jmodel, *init_args, seed: int):
    """A flax variables tree of jmodel's exact structure (jax.eval_shape of
    jmodel.init(key, *init_args), so nothing is compiled; a pose
    estimator's init_args are (batch, key)) with seeded numpy weights in flax's
    default scheme: kernels ~ N(0, 1/fan_in) clipped at 2 sigma (fan_in =
    the product of all but the last axis), zero biases, unit scales, and
    the frozen batch norms the identity."""
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *init_args)
    r = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            w = np.clip(r.standard_normal(s.shape), -2, 2) / 0.87962566103423978
            return (w * fan_in ** -0.5).astype(np.float32)
        one = name in ("scale", "weight", "running_var")
        return (np.ones if one else np.zeros)(s.shape, np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def port_context(model, jctx):
    """The port model's scene context from a JAX context's fields: the port
    builds its own tables (ConditionalNeRF.assemble_context) from JAX's
    support views and neural points."""
    from nerfloc_tpu_torch.models.fields.aggregator import SupportViews
    from nerfloc_tpu_torch.models.fields.context import NeuralPoints
    sv = SupportViews(**{k: t(getattr(jctx.sv, k)) for k in SupportViews._fields})

    def points(p):
        return NeuralPoints(**{f.name: None if getattr(p, f.name) is None
                               else t(getattr(p, f.name))
                               for f in dataclasses.fields(NeuralPoints)})
    return model.model_3d.assemble_context(sv, points(jctx.coarse), points(jctx.fine),
                                           t(jctx.feat_coarse_src), t(jctx.feat_fine_src))


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for the module's tests (autouse where a test
    module imports it): at these tiny sizes more threads only wait on each
    other, the more so when the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
