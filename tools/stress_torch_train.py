#!/usr/bin/env python3
"""How often a full-width train step meets a non-finite gradient, and
where, on the GPU, in the PyTorch port (nerfloc_tpu_torch).

    python3 tools/stress_torch_train.py [--runs 6] [--steps 3] [--replays 3]
                                        [--anomaly] [--plain] [--out stress.json]

Each run builds the model afresh and takes --steps steps of
make_train_step at full width as chip_smoke.py's train phase does (default
Config with render.fused_query_agg=True, V=5 at 240x320, B=1, weights
from seed 0, the batch of make_query_batch(seed=0), the noise of
chip_smoke.train_noise(seed=step)), then replays the next step's forward
and backward --replays times without updating (the device's sums are not
deterministic, so a replay can differ from the step it repeats). For
every step and replay it reports the loss, the gradient's global norm,
the parameters with a non-finite gradient element, and how many depths
`from_inverse_normalized_depth` decoded with d_inv = d_norm * (1/near -
1/far) - 1/near exactly 0 (where clip(-1/d_inv, near, far) has a NaN
gradient) or within 1e-3 of 1/near of it. Exact zeros are counted apart
inside build_scene_context, whose aggregation over the fine points feeds
only the confidence weights, which no loss reads: a NaN there never
reaches a gradient. --plain decodes them with that
clip, as the JAX package does, instead of the port's grad-safe form.
With --anomaly the
replays run under torch.autograd.detect_anomaly, which stops at the
first backward function that returns NaN and names the forward call that
made it. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402  (card_line, train_noise)


def grad_report(model):
    """(global norm of the gradients, names of parameters with a
    non-finite gradient element)."""
    import torch
    from nerfloc_tpu_torch.train.state import flat_grads
    g = flat_grads(list(model.parameters()))
    norm = float(torch.sqrt(torch.sum(g * g)))
    bad = [] if math.isfinite(norm) else [
        n for n, p in model.named_parameters()
        if p.grad is not None and not bool(torch.isfinite(p.grad).all())]
    return norm, bad


def plain_decode(d_norm, near, far):
    """The JAX package's form: clip(-1 / d_inv, near, far)."""
    import torch
    near_inv, far_inv = -1.0 / near, -1.0 / far
    d_inv = d_norm * (far_inv - near_inv) + near_inv
    return torch.minimum(torch.maximum(-1.0 / d_inv, near), far)


class DepthCounter:
    """Wraps neuray.from_inverse_normalized_depth (with plain_decode in its
    place if `plain`); counts on the device the decoded depths whose d_inv
    is exactly 0, outside and inside build_scene_context, and those within
    1e-3 / near."""

    def __init__(self, dev, plain: bool = False):
        import torch
        from nerfloc_tpu_torch.models.fields import neuray
        from nerfloc_tpu_torch.models.fields.conditional_nerf import ConditionalNeRF
        self.neuray, self.orig = neuray, neuray.from_inverse_normalized_depth
        self.cls, self.orig_ctx = ConditionalNeRF, ConditionalNeRF.build_scene_context
        decode = plain_decode if plain else self.orig
        self.counts = torch.zeros(3, dtype=torch.long, device=dev)
        self.in_context = False

        def build_scene_context(*a, **kw):
            self.in_context = True
            try:
                return self.orig_ctx(*a, **kw)
            finally:
                self.in_context = False

        def counted(d_norm, near, far):
            with torch.no_grad():
                near_inv, far_inv = -1.0 / near, -1.0 / far
                d_inv = d_norm * (far_inv - near_inv) + near_inv
                self.counts[int(self.in_context)] += (d_inv == 0).sum()
                self.counts[2] += (torch.abs(d_inv) <= 1e-3 * torch.abs(near_inv)).sum()
            return decode(d_norm, near, far)
        neuray.from_inverse_normalized_depth = counted
        ConditionalNeRF.build_scene_context = build_scene_context

    def take(self):
        zero, zero_ctx, near = (int(v) for v in self.counts)
        self.counts.zero_()
        return {"d_inv_zero": zero, "d_inv_zero_context": zero_ctx, "d_inv_near": near}

    def restore(self):
        self.neuray.from_inverse_normalized_depth = self.orig
        self.cls.build_scene_context = self.orig_ctx


def replay(model, batch, kp, idx, anomaly: bool):
    """One forward and backward of a train query, no update."""
    import torch
    model.zero_grad(set_to_none=True)
    row = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            with torch.autograd.set_detect_anomaly(anomaly, check_nan=True):
                out = model.train_forward({k: v[0] for k, v in batch.items()},
                                          kp_gumbel=kp[0], ray_idx=idx[0])
                row["loss"] = float(out["loss"])
                out["loss"].backward()
        except RuntimeError as e:
            row["anomaly"] = str(e).splitlines()[0]
    traces = [str(w.message) for w in caught if "Traceback of forward call" in str(w.message)]
    if traces:
        row["forward_trace"] = traces[0][-3000:]
    row["grad_norm"], row["nonfinite"] = grad_report(model)
    return row


def run(dev, r: int, steps: int, replays: int, anomaly: bool, plain: bool):
    import torch
    from nerfloc_tpu_torch.configs import Config, RenderConfig
    from nerfloc_tpu_torch.data import device_batch, make_query_batch, stack_batches
    from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
    from nerfloc_tpu_torch.train.state import TrainState
    from nerfloc_tpu_torch.train.step import make_train_step
    cfg = Config(render=RenderConfig(fused_query_agg=True))
    model = NerfPoseEstimator(cfg, device=dev, seed=0)
    batch = to_device_batch(stack_batches([device_batch(make_query_batch(
        n_views=5, H=240, W=320, seed=0))]), dev)
    state, step = TrainState(model, cfg), make_train_step(model, cfg)
    rows, counter = [], DepthCounter(dev, plain)
    for i in range(steps + replays):
        kp, idx = (v.to(dev) for v in cs.train_noise(model, batch, seed=min(i, steps)))
        if i < steps:
            m = step(state, batch, kp_gumbel=kp, ray_idx=idx)
            row = {"loss": float(m["loss"])}
            row["grad_norm"], row["nonfinite"] = grad_report(model)
        else:
            row = replay(model, batch, kp, idx, anomaly)
        row = {"run": r, "step": min(i, steps), "replay": max(i - steps + 1, 0), **row,
               **counter.take()}
        rows.append(row)
        what = f"step {row['step']}" + (f" replay {row['replay']}" if row["replay"] else "")
        print(f"run {r} {what}: loss {row.get('loss', float('nan')):.6g} grad_norm {row['grad_norm']:.6g} "
              f"d_inv==0 {row['d_inv_zero']} (context {row['d_inv_zero_context']}) "
              f"|d_inv|<=1e-3/near {row['d_inv_near']} "
              f"non-finite leaves {len(row['nonfinite'])} {row['nonfinite'][:4]}"
              + (f" ANOMALY {row['anomaly']}" if "anomaly" in row else ""), flush=True)
        if "forward_trace" in row:
            print(row["forward_trace"], flush=True)
    counter.restore()
    del model, state, batch
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--steps", type=int, default=3, help="updates per run")
    ap.add_argument("--replays", type=int, default=3, help="replays of the next step")
    ap.add_argument("--anomaly", action="store_true", help="replays under detect_anomaly")
    ap.add_argument("--plain", action="store_true",
                    help="decode depths with the JAX package's clip(-1/d_inv, near, far)")
    ap.add_argument("--out", default=None, help="write the result as JSON here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("stress_torch_train: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    rows = [row for r in range(args.runs)
            for row in run(dev, r, args.steps, args.replays, args.anomaly, args.plain)]
    bad = [(x["run"], x["step"], x["replay"]) for x in rows
           if "anomaly" in x or not math.isfinite(x["grad_norm"])]
    print(f"{len(rows)} forward+backward passes ({args.runs} runs x {args.steps} steps + "
          f"{args.replays} replays{', replays under detect_anomaly' if args.anomaly else ''}"
          f"{', plain decoded depth' if args.plain else ''}): "
          f"{len(bad)} with a non-finite gradient {bad}; decoded depths with d_inv == 0: "
          f"{sum(x['d_inv_zero'] for x in rows)} (in the context's aggregation: "
          f"{sum(x['d_inv_zero_context'] for x in rows)}), within 1e-3 / near: "
          f"{sum(x['d_inv_near'] for x in rows)}; {card}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "args": vars(args), "nonfinite": bad, "rows": rows}, f,
                      indent=1)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
