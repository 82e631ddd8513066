"""Checkpoints: a recency stream for resuming, metric-keyed best-k streams,
and a shape-matched partial restore (counterpart of
nerfloc_tpu/train/checkpoint.py, in the port's own format: each
checkpoint is one torch.save file of {"step", "model" state_dict,
"opt_state"}, written to a temporary name and renamed into place).

Layout under `directory`:
  <step>/state.pt, <step>/metrics.json         recency stream (max_to_keep)
  best_<metric>/<step>/state.pt, metrics.json  the best save of each metric:
                                               a later, worse save never
                                               evicts it
"""
from __future__ import annotations

import json
import math
import os
import shutil
from typing import Any, Dict, List, Mapping, Optional

import torch

STATE_FILE, METRICS_FILE = "state.pt", "metrics.json"
# the best-checkpoint metrics and their directions: pose_acc and
# median_trans_err_m of eval_dataset's 'avg' row, psnr_test of
# render_psnr_eval
DEFAULT_METRIC_MODES = {"pose_acc": "max", "median_trans_err_m": "min",
                        "psnr_test": "max"}


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isfile(os.path.join(directory, n, STATE_FILE)))


def _write(directory: str, step: int, saveable: Mapping, metrics: Mapping) -> None:
    d = os.path.join(directory, str(step))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, STATE_FILE + ".tmp")
    torch.save(saveable, tmp)
    with open(os.path.join(d, METRICS_FILE), "w") as f:
        json.dump(dict(metrics), f)
    os.replace(tmp, os.path.join(d, STATE_FILE))


def _scalars(metrics: Optional[Mapping]) -> Dict[str, float]:
    out = {}
    for k, v in (metrics or {}).items():
        try:
            out[k] = float(v)
        except (TypeError, ValueError, RuntimeError):
            pass
    return out


class CheckpointManager:
    """Step-keyed checkpoints: the `max_to_keep` most recent ones, plus for
    each metric in `metric_keys` ({name: 'max' | 'min'}) the best one among
    saves whose metrics hold a finite value of it."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 metric_keys: Optional[Dict[str, str]] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.metric_keys = dict(metric_keys or {})
        for key, mode in self.metric_keys.items():
            if mode not in ("max", "min"):
                raise ValueError(f"bad mode for {key}: {mode}")
        os.makedirs(self.directory, exist_ok=True)

    def _best_dir(self, metric: str) -> str:
        return os.path.join(self.directory, f"best_{metric}")

    def save(self, step: int, state: Any, metrics: Optional[Mapping] = None) -> None:
        """Save `state` (a TrainState or a state dict) as `step`; metrics
        also feed the best-k streams."""
        saveable = state.state_dict() if hasattr(state, "state_dict") else state
        scalars = _scalars(metrics)
        _write(self.directory, step, saveable, scalars)
        for old in _steps(self.directory)[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        for key in self.metric_keys:
            if math.isfinite(scalars.get(key, math.nan)):
                d = self._best_dir(key)
                _write(d, step, saveable, scalars)
                for old in self._ranked(key)[1:]:
                    shutil.rmtree(os.path.join(d, str(old)))

    def _ranked(self, metric: str) -> List[int]:
        """Steps of the metric's best stream, best first (ties: the earlier
        step first)."""
        d = self._best_dir(metric)
        sign = -1.0 if self.metric_keys.get(metric, "max") == "max" else 1.0
        vals = {}
        for s in _steps(d):
            with open(os.path.join(d, str(s), METRICS_FILE)) as f:
                vals[s] = sign * float(json.load(f)[metric])
        return sorted(vals, key=lambda s: (vals[s], s))

    def latest_step(self) -> Optional[int]:
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def best_step(self, metric: Optional[str] = None) -> Optional[int]:
        """Step of the best retained checkpoint for `metric` (default: the
        first configured one); None without a stream or a save."""
        metric = metric or next(iter(self.metric_keys), None)
        if metric not in self.metric_keys:
            return None
        ranked = self._ranked(metric)
        return ranked[0] if ranked else None

    def restore(self, step: Optional[int] = None, best: Optional[str] = None
                ) -> Optional[Dict]:
        """The saved state dict of `step` (default: the latest) from the
        recency stream, or with best=<metric> (best='' for the first
        configured metric) from that metric's best stream (default: its
        best step), on the CPU. None when there is nothing to restore."""
        directory = self.directory
        if best is not None:
            metric = best or next(iter(self.metric_keys), None)
            best_step = self.best_step(metric)
            if best_step is not None:
                directory = self._best_dir(metric)
                step = best_step if step is None else step
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return torch.load(os.path.join(directory, str(step), STATE_FILE),
                          map_location="cpu", weights_only=True)


def discover_best_dirs(directory: str) -> Dict[str, str]:
    """Metric name -> best-stream directory, for the streams on disk."""
    out = {}
    if os.path.isdir(directory):
        for name in sorted(os.listdir(directory)):
            if name.startswith("best_") and os.path.isdir(os.path.join(directory, name)):
                out[name[len("best_"):]] = os.path.join(directory, name)
    return out


def restorable(current: Mapping[str, torch.Tensor],
               restored: Mapping[str, torch.Tensor]) -> List[str]:
    """The keys of `current` that `restored` holds with the same shape."""
    return [k for k, v in current.items()
            if torch.is_tensor(restored.get(k)) and restored[k].shape == v.shape]


def partial_restore(current: Mapping[str, torch.Tensor],
                    restored: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A state dict holding `restored`'s entry wherever the same key exists
    with the same shape (cast to the current dtype and device), and
    `current`'s elsewhere: warm-starts a model whose heads changed."""
    out = dict(current)
    for k in restorable(current, restored):
        out[k] = restored[k].to(dtype=current[k].dtype, device=current[k].device)
    return out
