"""The comparison of training steps with the reference.

Set-up drives the port's train state through the mix's warm-up steps (the
window's own call and feed, on distinct pool items), and the window's
first `follow` steps go on from there. The reference follows all of these
steps from the same weights, inputs and noise, drawing at each step the
keypoints the port drew (the draw turns on the keypoint scores, so a
last-bit difference changes which keypoints carry the matching losses).
What each side leaves is read through the port's public calls: the
model's parameters, the flat gradient handed to
`TrainState.apply_gradients`, and the keypoint draw of
`sample_keypoints`. Compared:

- kp_missed: the first step's draw by itself: the share of the
  reference's own draw that the port's left out;
- render_missed: the first step's render of the batch's rays: the share
  of rays whose origin, direction or colour differs from the
  reference's (harness/query_check.render_missed);
- grad_gap: the first step's gradient as handed to the optimizer: per
  parameter leaf, the norm of the difference between the two sides over
  the larger of the reference's norm of that leaf and of the median leaf;
  the median over the leaves;
- window_grad_gap: the same at the window's first step;
- window_change_gap: the parameters' change over the window's first
  `follow` steps: per leaf, the gap between the two sides' norms of the
  change over the larger of the reference's norm of the leaf's change and
  of the median leaf's; the median over the leaves, leaving out the
  leaves whose reference gradient at the window's first step is under a
  thousandth of the median leaf's (they move under Adam by round-off
  alone, as the attention keys' biases under softmax). Adam moves each
  element by about its step size whatever the sign of a gradient that
  rounding decides, so the change's norm, not its difference, is steady.

Each step's loss is not compared (PERF.md gives the readings).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from .probe import Patches
from .query_check import render_missed, rendered

SMALL_GRAD = 1e-3       # of the median leaf's reference gradient norm


def _flat(params) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1).float() for p in params])


def forced_gumbel(idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Keypoint noise under which the draw picks exactly the points idx."""
    g = torch.full_like(like, -1e4)
    g[..., idx] = 1e4
    return g


class Recorder:
    """While `on`: each step's keypoint draw, the first step's first
    render, the gradient handed to the optimizer at the steps in
    grad_steps (counted from 0), and the parameters where snapshot() is
    called."""

    def __init__(self, drv, grad_steps):
        self.model = drv.s.model
        self.layout = [(n, p.numel()) for n, p in self.model.named_parameters()]
        self.draws: List[torch.Tensor] = []
        self.grads: Dict[int, torch.Tensor] = {}
        self.params: Dict[str, torch.Tensor] = {}
        self.render: Dict[str, torch.Tensor] = {}
        self.steps, self.on = 0, True
        self.patches = Patches()

        def draw(fn):
            def run(*a, **kw):
                out = fn(*a, **kw)
                if self.on:
                    self.draws.append(out[2])
                return out
            return run

        def update(fn):
            def run(grads, *a, **kw):
                if self.on:
                    if self.steps in grad_steps:
                        self.grads[self.steps] = grads.detach().float().clone()
                    self.steps += 1
                return fn(grads, *a, **kw)
            return run
        def render(fn):
            def run(*a, **kw):
                out = fn(*a, **kw)
                if self.on and self.steps == 0 and not self.render:
                    self.render = rendered(a, out)
                return out
            return run
        self.patches.replace(self.model.model_3d, "sample_keypoints", draw)
        self.patches.replace(self.model.model_3d, "render_rays", render)
        self.patches.replace(drv.state, "apply_gradients", update)

    def snapshot(self, key: str) -> None:
        self.params[key] = _flat(self.model.parameters()).clone()

    def close(self) -> None:
        """Stop recording; the patches stay until undo()."""
        self.on, self.model = False, None

    def undo(self) -> None:
        self.patches.undo()


def own_draw(drv, i: int) -> torch.Tensor:
    """The keypoints drv's model draws for pool item i at its weights."""
    b = {k: v[0] for k, v in drv.pool[i].items()}
    m = drv.s.model
    with drv.s.system.mode(), torch.no_grad():
        ctx, _ = m.build_context(b)
        return m.model_3d.sample_keypoints(ctx, drv.s.cfg.matching.fine_num_3d_keypoints,
                                           drv.noise[i]["kp_gumbel"][0])[2]


def leaves(flat: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    out, at = {}, 0
    for name, n in layout:
        out[name] = flat[at:at + n]
        at += n
    return out


def median_leaf_gap(port: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                    skip=(), of_norms: bool = False) -> float:
    """Per leaf, the norm of the difference (of_norms: the gap between the
    norms) over the larger of the reference's norm of the leaf and of the
    median leaf; the median over the leaves."""
    names = [n for n in ref if n not in skip]

    def norms(f):
        return torch.stack([torch.linalg.vector_norm(f(n)) for n in names])
    rn = norms(lambda n: ref[n].double())
    dn = ((norms(lambda n: port[n].double()) - rn).abs() if of_norms
          else norms(lambda n: port[n].double() - ref[n].double()))
    return float(torch.median(dn / torch.clamp(rn, min=float(torch.median(rn)))))


def gaps(port: Recorder, ref: Recorder, warm: int) -> Dict[str, float]:
    lay = ref.layout

    def g(rec, step):
        return leaves(rec.grads[step], lay)
    norms = {n: float(torch.linalg.vector_norm(v)) for n, v in g(ref, warm).items()}
    median = float(torch.median(torch.tensor(list(norms.values()))))
    skip = {n for n, v in norms.items() if v < SMALL_GRAD * median}
    dp = leaves(port.params["end"] - port.params["start"], lay)
    dr = leaves(ref.params["end"] - ref.params["start"], lay)
    return {"grad_gap": median_leaf_gap(g(port, 0), g(ref, 0)),
            "window_grad_gap": median_leaf_gap(g(port, warm), g(ref, warm)),
            "window_change_gap": median_leaf_gap(dp, dr, skip, of_norms=True),
            "render_missed": (render_missed(port.render, ref.render)
                              if port.render and ref.render else 1.0)}


def compare(drv, make_reference) -> Dict[str, float]:
    """The reference follows drv's warm-up steps and the window's first
    `follow` steps on drv's inputs, each step i on pool item i drawing the
    keypoints the port drew; kp_missed checks the first draw by itself."""
    port, warm = drv.recorder, drv.warm
    ref = make_reference()
    ref.s.load_weights(drv.seed)
    ref.state = ref.s.system.mods["state"].TrainState(ref.s.model, ref.s.cfg)
    ref.pool, ref.noise = drv.pool, drv.noise
    own = set(own_draw(ref, 0).tolist())
    ref.noise = [dict(n, kp_gumbel=forced_gumbel(k, n["kp_gumbel"]))
                 for n, k in zip(drv.noise, port.draws)]
    rec = Recorder(ref, (0, warm))
    if rec.layout != port.layout:
        raise ValueError("train check: the port's parameters are not the reference's")
    for i in range(len(port.draws)):
        if i == warm:
            rec.snapshot("start")
        ref.train_step(i)
    rec.snapshot("end")
    rec.close()
    rec.undo()
    out = gaps(port, rec, warm)
    out["kp_missed"] = 1.0 - len(own & set(port.draws[0].tolist())) / max(len(own), 1)
    return out
