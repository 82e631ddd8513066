"""The two implementations a run drives through the same calls: the port
(the system under test) and the frozen reference (`benchmark/reference`).

Both expose the same modules: configs (Config, compute_dtype_of, _merge),
models.pose_estimator (NerfPoseEstimator), train.step (make_train_step,
make_eval_step and the layer functions it looks up by name), train.state
(TrainState). The reference runs at float32 with TF32 off; its control
runs it one precision below the configuration's (`control`).
"""
from __future__ import annotations

import contextlib
import importlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

PORT = "nerfloc_tpu_torch"
REFERENCE = "reference"
FP8_MAX = 448.0       # float8_e4m3fn's largest finite value


@dataclass
class System:
    package: str
    dtype_name: str                  # 'config' (the configuration's), 'float32', 'bfloat16'
    mode: Callable[[], Any] = contextlib.nullcontext
    mods: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        for short, name in (("configs", "configs"), ("pe", "models.pose_estimator"),
                            ("step", "train.step"), ("state", "train.state"),
                            ("nerf", "models.fields.conditional_nerf")):
            self.mods[short] = importlib.import_module(f"{self.package}.{name}")

    def config(self, overrides: Dict[str, Any]):
        c = self.mods["configs"]
        return c._merge(c.Config(), overrides)

    def dtype(self, cfg) -> torch.dtype:
        if self.dtype_name == "config":
            return self.mods["configs"].compute_dtype_of(cfg)
        return getattr(torch, self.dtype_name)


def port() -> System:
    return System(PORT, "config")


@contextlib.contextmanager
def exact_f32():
    """float32 matrix products and convolutions without TF32."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def reference() -> System:
    return System(REFERENCE, "float32", mode=exact_f32)


class _Rounding(TorchDispatchMode):
    """Every new result of dtype SRC rounded by `rnd`. Views and in-place
    results pass as they are (their tensors were rounded when they were
    made)."""
    SRC: torch.dtype

    @staticmethod
    def rnd(t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(r.alias_info is not None for r in func._schema.returns):
            return out
        return tree_map(lambda t: self.rnd(t) if isinstance(t, torch.Tensor)
                        and t.dtype == self.SRC else t, out)


class Fp8Rounding(_Rounding):
    """bfloat16 results rounded to float8 e4m3 (saturating at +-448): a
    bfloat16 computation run at fp8, with the sums inside each operation
    as wide as bf16's, as fp8 tensor cores keep them."""
    SRC = torch.bfloat16

    @staticmethod
    def rnd(t):
        return t.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(torch.bfloat16)


class Bf16Rounding(_Rounding):
    """float32 results rounded to bfloat16 (kept float32)."""
    SRC = torch.float32

    @staticmethod
    def rnd(t):
        return t.to(torch.bfloat16).to(torch.float32)


F32_STAGES = ("ransac_pnp", "count_pose_inliers")   # the step's float32 solvers


@contextlib.contextmanager
def _control_mode():
    step = importlib.import_module(f"{REFERENCE}.train.step")
    saved = {name: getattr(step, name) for name in F32_STAGES}

    def lowered(fn):
        def run(*a, **kw):
            with Bf16Rounding():
                return fn(*a, **kw)
        return run
    for name, fn in saved.items():
        setattr(step, name, lowered(fn))
    try:
        with Fp8Rounding():
            yield
    finally:
        for name, fn in saved.items():
            setattr(step, name, fn)


def control(config_dtype: str) -> System:
    """The reference in the program's place, one precision below what the
    configuration states: its bfloat16 compute at fp8 (every bf16 result
    rounded to e4m3), and PnP and the cascade's inlier count, which run in
    float32, at bfloat16."""
    if config_dtype != "bfloat16":
        raise ValueError(f"no control below {config_dtype}")
    return System(REFERENCE, "bfloat16", mode=_control_mode)


def reference_bf16() -> System:
    """The reference at bfloat16, as the configuration states it: the look
    that tells the port's departures from bf16's own."""
    return System(REFERENCE, "bfloat16")
