"""A closed loop of one client sending localization queries through the
port's eval step, the next once the last pose is back on the host.

Mix parameters: `pool` seeded queries (a query image and `views` RGB-D
support views at the configuration's frame size) made in set-up and kept
on the host, cycled through the window; each query's host-to-device copy
is inside the window; its noise (keypoint draw, both RANSAC draws,
refinement pixels) is drawn from the seed in set-up and handed to
eval_step. `warmup` queries run in set-up. `config` switches the eval
path's options (cascade matching, pose refinement). A traced run times
the layers `probe_spans` names (of localize, pnp_cascade, refine; all
three where the mix does not say) by CUDA events over its window, and
profiles `profile_items` queries after it. After the window, `sample`
distinct queries drawn from the seed are compared with the reference
(harness/query_check.py); what they are compared on is kept for the
window's first pass over the pool alone.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

import torch

from harness import faults, query_check, spans as port_spans
from harness.dev import peak_bytes, reset_peak, sync
from harness.noise import distinct_pixels, gumbel
from harness.probe import Capture, Patches, Spans, profile_items
from harness.record import Record
from harness.seeds import derive
from harness.session import Session

KIND = "query"
NOISE = ("kp_gumbel", "pnp_gumbel", "pnp2_gumbel", "refine_uv")
PROBE_SPANS = ("localize", "pnp_cascade", "refine")


class Driver:
    KIND = KIND

    def __init__(self, cell, system, device, plan=None, fault=None):
        self.cell, self.mix, self.fault = cell, cell.mix, fault
        self.fault_patches = Patches()
        self.s = Session(cell, system, device, plan)
        self.step = system.mods["step"].make_eval_step(self.s.model, self.s.cfg)

    # -- set-up --------------------------------------------------------------

    def prepare(self, seed: int) -> None:
        """Weights, the pool and its noise from seed; the warm-up queries."""
        s = self.s
        s.load_weights(seed)
        self.fault_patches.undo()
        if self.fault:
            faults.plant(self, self.fault)
        pool = s.make_pool(seed, int(self.mix["pool"]))
        self.noise = [self._noise(q, derive(seed, "noise", i)) for i, q in enumerate(pool)]
        pin = s.device.type == "cuda"
        self.pool = [{k: (v.cpu().pin_memory() if pin else v.cpu()) for k, v in q.items()}
                     for q in pool]
        for i in range(int(self.mix["warmup"])):
            self.query(i % len(self.pool))
        sync(s.device)

    def _noise(self, q, seed: int) -> Dict[str, torch.Tensor]:
        s, cfg = self.s, self.s.cfg
        g = torch.Generator(device=s.device).manual_seed(seed)
        P = s.model.n_coarse_points(q)
        hyps = (cfg.shapes.pnp_hypotheses, cfg.matching.fine_num_3d_keypoints)
        idx = distinct_pixels(s.H, s.W, cfg.shapes.pose_refine_rays, g, s.device)
        uv = torch.stack([(idx % s.W).float(), (idx // s.W).float()], dim=-1)
        return {"kp_gumbel": gumbel((P,), g, s.device), "pnp_gumbel": gumbel(hyps, g, s.device),
                "pnp2_gumbel": gumbel(hyps, g, s.device), "refine_uv": uv}

    def device_batch(self, i: int):
        return {k: v.to(self.s.device, non_blocking=True)[None] for k, v in self.pool[i].items()}

    def query(self, i: int):
        """One query of pool item i through eval_step; the pose on the host."""
        with self.s.system.mode():
            out = self.step(self.device_batch(i), noise={k: v[None] for k, v in
                                                         self.noise[i].items()})
        return out["pose_pred"][0].cpu()

    # -- the window ----------------------------------------------------------

    def window(self, seconds: float, trace: bool, min_items: int = 1):
        """Queries for `seconds`; with trace, spans in the window and then
        `profile_items` queries under the profiler. Returns (Record,
        capture, [(pool item, host pose)] of the window's queries)."""
        model, step_mod, dev = self.s.model, self.s.system.mods["step"], self.s.device
        patches = Patches()
        cap = query_check.install_capture(Capture(patches), model, step_mod)
        rec = Record(kind=KIND, trace=trace)
        spans = None
        warm = int(self.mix["warmup"])
        done: List[Any] = []
        ends = [] if trace else None
        layers = self.mix.get("probe_spans", PROBE_SPANS) if trace else ()
        try:
            reset_peak(dev)
            if layers:
                spans = Spans(patches)
            if "localize" in layers:
                spans.wrap(model, "localize_parts", "localize")
            if "pnp_cascade" in layers:
                for owner, attr in ((step_mod, "ransac_pnp"), (model, "match_cascade"),
                                    (step_mod, "count_pose_inliers")):
                    spans.wrap(owner, attr, "pnp_cascade")
            if "refine" in layers:
                spans.wrap(step_mod, "refine_pose", "refine")
            with port_spans.recording(self.s.system, rec, trace):
                sync(dev)
                t0 = time.perf_counter()
                while True:
                    k = len(done)
                    i = (warm + k) % len(self.pool)
                    cap.item = k if k < len(self.pool) else None
                    if spans:
                        spans.item = k
                    done.append((i, self.query(i)))
                    now = time.perf_counter()
                    if ends is not None:
                        ends.append(now)
                    if now - t0 >= seconds and len(done) >= min_items:
                        break
                rec.window_s, rec.items = time.perf_counter() - t0, len(done)
                rec.peak_bytes = peak_bytes(dev)
                if trace:
                    rec.item_ms = [1e3 * (b - a) for a, b in zip([t0] + ends, ends)]
                    sync(dev)
                    for layer in layers:
                        rec.span_ms[layer] = spans.per_item_ms(layer, range(len(done)))
                    rec.profile_items = int(self.mix.get("profile_items", 1))
                    after = warm + len(done)
                    cap.item = None
                    prof = profile_items(rec, patches, self.s.system.mods["nerf"], lambda k: (
                        self.query((after + k) % len(self.pool))))
            if trace:
                rec.profile = prof.read()
        finally:
            patches.undo()
        return rec, cap, done

    def failed(self, done) -> int:
        return sum(1 for _, pose in done if not bool(torch.isfinite(pose).all()))

    def release(self) -> None:
        """Drop the model and its step; the pool, the noise and the
        captured outputs stay for the comparison."""
        self.fault_patches.undo()
        del self.step, self.s.model

    def check(self, seed: int, cap, done, make_reference) -> Dict[str, float]:
        """The compared numbers (harness/query_check.py); make_reference()
        gives a Driver of the reference at this cell."""
        return query_check.compare(self, seed, cap, done, make_reference)
