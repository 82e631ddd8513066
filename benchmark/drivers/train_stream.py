"""Train steps back to back on a pool of seeded batches resident on the
device, as a fine-tune or a multi-scene run feeds them (no loader).

Mix parameters: `pool` seeded batches of B=1 (a query and `views` RGB-D
support views at the configuration's frame size, with its keypoint noise
and its rendered rays) made in set-up; `warmup` steps in set-up on the
pool's first items; the window's steps cycle through the pool from there.
The reference follows the warm-up steps and the window's first `follow`
(harness/train_check.py). The loss is read on the host every `log_every`
steps and after the last one. A traced run profiles `profile_items` steps
after its window, with the port's tracer on from its window's start to the
end of the profiled steps (harness/spans.recording).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

import torch

from harness import faults, train_check, spans as port_spans
from harness.dev import peak_bytes, reset_peak, sync
from harness.noise import distinct_pixels, gumbel
from harness.probe import Patches, Spans, profile_items
from harness.record import Record
from harness.seeds import derive
from harness.session import Session

KIND = "train"


class Driver:
    KIND = KIND

    def __init__(self, cell, system, device, plan=None, fault=None):
        self.cell, self.mix, self.fault = cell, cell.mix, fault
        self.fault_patches = Patches()
        self.s = Session(cell, system, device, plan)
        self.step = system.mods["step"].make_train_step(self.s.model, self.s.cfg)

    def prepare(self, seed: int) -> None:
        """Weights, optimizer state, the pool and its noise from seed; the
        warm-up steps, with what the comparison reads of them."""
        s = self.s
        self.seed = seed
        s.load_weights(seed)
        if getattr(self, "recorder", None) is not None:
            self.recorder.undo()
        self.fault_patches.undo()
        self.state = s.system.mods["state"].TrainState(s.model, s.cfg)
        if self.fault:
            faults.plant(self, self.fault)
        self.pool = [{k: v[None] for k, v in q.items()}
                     for q in s.make_pool(seed, int(self.mix["pool"]))]
        self.noise = [self._noise(q, derive(seed, "noise", i)) for i, q in enumerate(self.pool)]
        self.warm, self.follow = int(self.mix["warmup"]), int(self.mix["follow"])
        if self.warm + self.follow > len(self.pool):
            raise ValueError("train_stream: the followed steps need distinct pool items")
        self.recorder = train_check.Recorder(self, (0, self.warm))
        for i in range(self.warm):
            self.train_step(i)
        self.recorder.snapshot("start")
        sync(s.device)

    def _noise(self, q, seed: int) -> Dict[str, torch.Tensor]:
        s = self.s
        g = torch.Generator(device=s.device).manual_seed(seed)
        P = s.model.n_coarse_points({k: v[0] for k, v in q.items()})
        return {"kp_gumbel": gumbel((1, P), g, s.device),
                "ray_idx": distinct_pixels(s.H, s.W, s.cfg.render.N_rand, g, s.device)[None]}

    def train_step(self, i: int) -> Dict[str, torch.Tensor]:
        with self.s.system.mode():
            return self.step(self.state, self.pool[i], **self.noise[i])

    def window(self, seconds: float, trace: bool, min_items: int = 1):
        """Steps for `seconds`, at least the `follow` steps the reference
        follows, closed by a synchronize; with trace, spans in the window
        and then `profile_items` steps under the profiler. Returns (Record,
        None, [host losses read])."""
        model, dev = self.s.model, self.s.device
        patches = Patches()
        rec = Record(kind=KIND, trace=trace)
        spans = None
        log_every = int(self.mix["log_every"])
        losses: List[float] = []
        warm, rec_ = self.warm, self.recorder
        min_items = max(min_items, self.follow)
        try:
            reset_peak(dev)
            if trace:
                spans = Spans(patches)
                spans.wrap(model, "train_forward", "forward")
                spans.mark_end(self.state, "apply_gradients", "update")
            with port_spans.recording(self.s.system, rec, trace):
                sync(dev)
                t0 = time.perf_counter()
                n = 0
                while True:
                    if spans:
                        spans.item = n
                    m = self.train_step((warm + n) % len(self.pool))
                    n += 1
                    if n == self.follow:
                        rec_.snapshot("end")
                        rec_.close()
                    if n % log_every == 0:
                        losses.append(float(m["loss"]))
                    if time.perf_counter() - t0 >= seconds and n >= min_items:
                        break
                sync(dev)
                rec.window_s, rec.items = time.perf_counter() - t0, n
                losses.append(float(m["loss"]))
                rec.peak_bytes = peak_bytes(dev)
                if trace:
                    rec.span_ms["forward"] = spans.per_item_ms("forward", range(n))
                    rec.span_ms["backward"] = spans.between_ms("forward", "update", range(n))
                    rec.profile_items = int(self.mix.get("profile_items", 1))
                    after = warm + n
                    spans.item = -1
                    prof = profile_items(rec, patches, self.s.system.mods["nerf"], lambda k: (
                        self.train_step((after + k) % len(self.pool))))
            if trace:
                rec.profile = prof.read()
        finally:
            patches.undo()
        return rec, None, losses

    def failed(self, losses) -> int:
        return sum(1 for v in losses if not torch.isfinite(torch.tensor(v)))

    def release(self) -> None:
        """Drop the model, its state and its step; the pool, the noise and
        what the followed steps left stay for the comparison."""
        self.recorder.undo()
        self.fault_patches.undo()
        del self.step, self.state, self.s.model

    def check(self, seed: int, cap, done, make_reference) -> Dict[str, float]:
        return train_check.compare(self, make_reference)
