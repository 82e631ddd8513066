"""Phase timing and tracing (counterpart of nerfloc_tpu/utils/profiling.py):
`PhaseTimer` accumulates wall time per named phase, fencing the device
at a phase's end when given a tensor; `trace` records a torch.profiler
trace into a directory (TensorBoard's format) or does nothing."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class PhaseTimer:
    """Wall seconds and counts per phase name. `fence`: a tensor (or any
    object) whose device is synchronised before the phase's clock stops,
    so a CUDA phase counts its kernels and not only their launch."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, fence=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.is_tensor(fence) and fence.is_cuda:
                torch.cuda.synchronize(fence.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": self.totals[k], "count": self.counts[k],
                    "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1)}
                for k in self.totals}

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return "\n".join(f"{k:30s} {v:8.3f}s  x{self.counts[k]}" for k, v in rows)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """A torch.profiler trace of the block (CPU, and CUDA where available)
    written to log_dir; without log_dir, nothing."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
