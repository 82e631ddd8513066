"""What both drivers share: the configuration a cell runs, the weight plan
and the pool of seeded inputs."""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import scene, weights
from .seeds import derive
from .systems import System, reference


def overrides(cell) -> Dict[str, Any]:
    """The configuration file's Config overrides, then the mix's."""
    out = _deep(dict(cell.config["config"]), {})
    return _deep(out, cell.mix.get("config", {}))


def _deep(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(a)
    for k, v in b.items():
        out[k] = _deep(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def frame(cell):
    H, W = cell.config["frame"]
    return int(H), int(W)


def n_views(cell, cfg) -> int:
    """The support views of the mix: a Config field's value (n_views_train,
    n_views_test) or a number."""
    v = cell.mix["views"]
    return int(getattr(cfg, v) if isinstance(v, str) else v)


def weight_plan(cell):
    """The parameters' plan from the reference's modules (built on the
    host at the cell's configuration)."""
    ref = reference()
    cfg = ref.config(overrides(cell))
    model = ref.mods["pe"].NerfPoseEstimator(cfg, device="cpu", seed=0)
    return weights.plan(model)


class Session:
    """A model of `system` at the cell's configuration on `device`, and the
    seeded weights and inputs of a run."""

    def __init__(self, cell, system: System, device, plan=None):
        self.cell, self.system, self.device = cell, system, torch.device(device)
        self.cfg = system.config(overrides(cell))
        self.dtype = system.dtype(self.cfg)
        self.H, self.W = frame(cell)
        self.V = n_views(cell, self.cfg)
        self.plan = plan if plan is not None else weight_plan(cell)
        with system.mode():
            self.model = system.mods["pe"].NerfPoseEstimator(self.cfg, device=self.device,
                                                             seed=0, dtype=self.dtype)

    def load_weights(self, seed: int) -> None:
        weights.load(self.model, weights.make(self.plan, derive(seed, "weights"), self.device))

    def make_pool(self, seed: int, n: int):
        """n seeded queries on the device."""
        return [scene.query(self.V, self.H, self.W, derive(seed, "scenes", i), self.device)
                for i in range(n)]
