"""Train state and optimizer (counterpart of nerfloc_tpu/train/state.py).

The optimizer is the JAX package's optax chain, written out:
zero_nonfinite -> clip_by_global_norm(1.0) -> scale_by_adam ->
scale_by_learning_rate(staircase exponential_decay). It differs from
torch.optim.Adam with clip_grad_norm_ in four ways that change the numbers:
non-finite gradient elements are zeroed before the clip; the clip scales
by max_norm / norm only when norm > max_norm (torch divides by norm +
1e-6); every parameter is updated with one shared count, a parameter
without a gradient taking a zero one (torch.optim skips it and counts per
parameter); and the learning rate is lrate * factor ** (count //
decay_steps) with the count before the update.

The moments live in two flat f32 vectors in the order of
model.parameters(), so an update is a handful of kernels whatever the
number of parameters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..configs import Config

Tensor = torch.Tensor
CLIP_NORM = 1.0                  # global-norm gradient clip
B1, B2, EPS = 0.9, 0.999, 1e-8   # Adam


@dataclass(frozen=True)
class AdamChain:
    """The update rule; `init` and `update` work on flat f32 vectors."""
    lrate: float
    decay_steps: int
    decay_factor: float

    def init(self, n: int, device) -> Dict[str, Tensor]:
        return {"mu": torch.zeros(n, device=device), "nu": torch.zeros(n, device=device)}

    def learning_rate(self, count: int) -> Tensor:
        """f32 staircase exponential decay at the update count `count`."""
        lr = torch.tensor(self.lrate)
        if count <= 0 or self.decay_steps <= 0 or self.decay_factor == 0:
            return lr
        return lr * torch.tensor(self.decay_factor) ** float(count // self.decay_steps)

    def update(self, grads: Tensor, state: Dict[str, Tensor], count: int
               ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """(parameter increment, new state) for the flat gradient `grads` at
        update count `count` (0 for the first update)."""
        g = torch.where(torch.isfinite(grads), grads, torch.zeros_like(grads))
        g_norm = torch.sqrt(torch.sum(g * g))
        g = torch.where(g_norm < CLIP_NORM, g, (g / g_norm) * CLIP_NORM)
        mu = (1 - B1) * g + B1 * state["mu"]
        nu = (1 - B2) * g ** 2 + B2 * state["nu"]
        c = float(count + 1)
        mu_hat = mu / (1 - torch.tensor(B1) ** c).to(mu.device)
        nu_hat = nu / (1 - torch.tensor(B2) ** c).to(nu.device)
        u = mu_hat / (torch.sqrt(nu_hat) + EPS)
        step = (-self.learning_rate(count)).to(u.device)
        return step * u, {"mu": mu, "nu": nu}


def make_optimizer(cfg: Config) -> AdamChain:
    """Adam, staircase step decay, gradient clip at global norm 1.0."""
    return AdamChain(lrate=cfg.lrate, decay_steps=cfg.lrate_decay_steps,
                     decay_factor=cfg.lrate_decay_factor)


def flat_grads(params: List[nn.Parameter]) -> Tensor:
    """The parameters' gradients as one f32 vector, zeros where a
    parameter has none."""
    return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])


class TrainState:
    """A model, the optimizer's moments for its parameters and the number of
    updates taken."""

    def __init__(self, model: nn.Module, cfg: Config):
        self.model = model
        self.tx = make_optimizer(cfg)
        self.params = list(model.parameters())
        self.step = 0
        self.opt_state = self.tx.init(sum(p.numel() for p in self.params), model_device(model))

    def broadcast(self, group: dist.ProcessGroup) -> None:
        """Make every rank of `group` hold its first rank's state: the
        model's parameters and buffers, the moments and the update count."""
        src = dist.get_global_rank(group, 0)
        for t in [*self.model.state_dict().values(), *self.opt_state.values()]:
            dist.broadcast(t, src, group=group)
        step = torch.tensor([self.step], dtype=torch.int64, device=model_device(self.model))
        dist.broadcast(step, src, group=group)
        self.step = int(step)

    def apply_gradients(self, grads: Tensor) -> None:
        """One update from the flat gradient of every parameter
        (flat_grads(self.params))."""
        upd, self.opt_state = self.tx.update(grads, self.opt_state, self.step)
        sizes = [p.numel() for p in self.params]
        with torch.no_grad():
            torch._foreach_add_(self.params, [u.view_as(p) for u, p in
                                              zip(upd.split(sizes), self.params)])
        self.step += 1

    def state_dict(self) -> Dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "opt_state": dict(self.opt_state)}

    def load_state_dict(self, sd: Dict) -> None:
        self.model.load_state_dict(sd["model"])
        dev = model_device(self.model)
        self.opt_state = {k: v.to(dev) for k, v in sd["opt_state"].items()}
        self.step = int(sd["step"])


def model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device
