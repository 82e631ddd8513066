"""Faults planted under a run's timed path, to show that the comparison
fails them (the CPU tests, and the readings on the card that set the
limits). Each replaces a name the driver's step looks up, through the
driver's `fault_patches`.

- stale: the train step leaves the state as it was (no update);
- half_rays: the step's rays (a train step's render batch, a query's
  refinement pixels) are the first half twice over, so the mean is taken
  over half of them;
- half_keypoints: the train step's keypoint draw is its first half twice
  over;
- altered: a query's answer changed where it is made: every match of the
  mutual-nearest step moved to the next query cell;
- dropped: every other match of the mutual-nearest step left out.

One card: no exchange between cards to leave out. A query carries no state
from one query to the next. A cell's data may list the faults it can have
(`faults`): a query without refinement has no rays to halve.
"""
from __future__ import annotations

import torch

TRAIN = ("stale", "half_rays", "half_keypoints")
QUERY = ("altered", "dropped", "half_rays")


def of_cell(cell) -> tuple:
    """The faults a cell can have: its data's `faults`, or every fault of
    its driver's kind."""
    kind = cell.driver().Driver.KIND
    return tuple(cell.data.get("faults", TRAIN if kind == "train" else QUERY))


def _halved(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """t's first half along dim, twice over."""
    h = t.narrow(dim, 0, t.shape[dim] // 2)
    return torch.cat([h, h, t.narrow(dim, 2 * h.shape[dim], t.shape[dim] - 2 * h.shape[dim])],
                     dim=dim)


def plant(drv, name: str) -> None:
    p = drv.fault_patches
    if name not in (TRAIN if drv.KIND == "train" else QUERY):
        raise ValueError(f"no {drv.KIND} fault {name!r}")
    model = drv.s.model
    if name == "stale":
        p.replace(drv.state, "apply_gradients", lambda fn: (lambda grads: None))
    elif name == "half_rays" and drv.KIND == "train":
        def rays(fn):
            def run(*a, ray_idx=None, **kw):
                return fn(*a, ray_idx=None if ray_idx is None else _halved(ray_idx), **kw)
            return run
        p.replace(model, "train_forward", rays)
    elif name == "half_rays":
        def pixels(fn):
            def run(render_fn, pose, K, image, uv, *a, **kw):
                return fn(render_fn, pose, K, image, _halved(uv, 0), *a, **kw)
            return run
        p.replace(drv.s.system.mods["step"], "refine_pose", pixels)
    elif name == "half_keypoints":
        def draw(fn):
            def run(*a, **kw):
                return tuple(_halved(t, 0) for t in fn(*a, **kw))
            return run
        p.replace(model.model_3d, "sample_keypoints", draw)
    else:
        def matches(fn):
            def run(scores, thr):
                j, mask = fn(scores, thr)
                if name == "altered":
                    return (j + 1) % scores.shape[1], mask
                return j, mask & (torch.arange(len(mask), device=mask.device) % 2 == 0)
            return run
        p.replace(drv.s.system.mods["pe"], "mutual_nearest_matches", matches)
