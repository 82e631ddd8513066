"""The comparison of served queries with the reference.

Random weights make a query's discrete choices (the keypoint draw, the
mutual-nearest matches, RANSAC's hypotheses, the cascade's gate, the
refinement's acceptance) turn on small differences, and a different match
set gives PnP a different pose. So the reference follows the port stage by
stage from the port's own state, and each stage is judged by what it
returns given its inputs:

- kp_missed: the share of the reference's keypoint draw (its own scene
  context, the same Gumbel noise) that the port's draw left out;
- score_gap: the reference scores the port's keypoints against the query
  cells (first pass, and the cascade pass from the port's first PnP pose);
  the widest gap by which a match the port made lies below the best score
  of its keypoint's row, as a served token's logit is held against the
  reference's best; 1 where the port made no match and the reference did;
- match_wrong: in each pass, the share of keypoints whose match (or
  none) differs from the mutual-nearest selection that the reference's
  rule makes on the port's own scores, rerun on each score matrix as the
  port makes it (keeping the matrices would raise the window's peak
  memory): exact, the scores themselves judged by score_gap;
- pnp_gap: both RANSAC passes rerun by the reference on the port's
  matches with the same hypotheses' noise, and the cascade's gate taken
  by the reference from the port's two solves: the largest difference of
  a [R | t] entry between the port's pose and the reference's;
- render_missed: the share of the refinement's first rays whose origin or
  direction differs from the reference's at the port's starting pose by
  more than RAY_TOL, or whose colour differs by more than RGB_TOL in a
  channel or is not finite.

Each is the largest over `sample` distinct queries of the window, drawn
from the seed. The refinement's gradients at bf16 and the refined pose,
which turns on the first bit of difference through 50 Adam steps, are not
compared: PERF.md gives their readings and why.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict, List

import numpy as np
import torch

from .seeds import derive
from .systems import REFERENCE

COORD_TOL = 1e-4          # a port keypoint is the reference coarse point this near
RGB_TOL = 0.01            # a ray's colour that differs by more (or is not finite) is missed
RAY_TOL = 1e-4            # a ray whose origin or direction differs by more is missed


def _m(m, select) -> Dict[str, torch.Tensor]:
    """The matches a pass made, and the reference's selection on its scores."""
    j, mask = select(m["score_matrix"])
    return {"match_j": m["match_j"], "match_mask": m["match_mask"],
            "ref_j": j, "ref_mask": mask}


def match_wrong(port) -> float:
    mask = port["match_mask"].bool()
    wrong = (mask != port["ref_mask"]) | (mask & (port["match_j"] != port["ref_j"]))
    return float(wrong.float().mean())


def install_capture(cap, model, step_mod):
    """Keep, per item: the keypoints and the first pass's matches, each
    RANSAC call's inputs and result, the cascade's matches, the pose into
    refinement, and the rays and colours of its first render. Nothing while
    cap.item is None: the driver names only the items that can be sampled
    (the window's first pass over its pool), so what is kept on the card
    does not grow with the queries a window completes."""
    rule = importlib.import_module(f"{REFERENCE}.models.matching").mutual_nearest_matches
    thr = model.cfg.matching.thr

    def select(scores):
        return rule(scores, thr)

    def take_localize(rec, a, kw, out):
        rec["pts3d"], rec["m1"] = out[3], _m(out[5], select)

    def take_pnp(rec, a, kw, out):
        rec.setdefault("pnp", []).append({"args": a, "kw": kw, "c2w": out.c2w,
                                          "num_inliers": out.num_inliers,
                                          "success": out.success})

    def take_cascade(rec, a, kw, out):
        rec["m2"] = _m(out, select)
    cap.keep(model, "localize_parts", take_localize)
    cap.keep(step_mod, "ransac_pnp", take_pnp)
    cap.keep(model, "match_cascade", take_cascade)

    def refine(fn):
        def run(*a, **kw):
            if cap.item is None:
                return fn(*a, **kw)
            rec = cap.items[cap.item]
            rec["want_render"] = True
            out = fn(*a, **kw)
            rec["refine_in"] = a[1]
            return out
        return run

    def render(fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            if cap.item is None:
                return out
            rec = cap.items[cap.item]
            if rec.get("want_render"):
                rec["want_render"] = False
                rec["render"] = rendered(a, out)
            return out
        return run
    cap.patches.replace(step_mod, "refine_pose", refine)
    cap.patches.replace(model.model_3d, "render_rays", render)
    return cap


def rendered(args, out) -> Dict[str, torch.Tensor]:
    """The rays and colours of a render_rays(ctx, rays_o, rays_d, ...) call."""
    return {"rays_o": args[1].detach(), "rays_d": args[2].detach(),
            "rgb": out["rgb"].detach()}


def render_missed(port: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> float:
    """The share of rays whose origin or direction differs by more than
    RAY_TOL, or whose colour differs by more than RGB_TOL or is not finite."""
    def off(k, tol):
        return ~((port[k].float() - ref[k].float()).abs().amax(dim=-1) <= tol)
    missed = off("rays_o", RAY_TOL) | off("rays_d", RAY_TOL) | off("rgb", RGB_TOL)
    return float(missed.float().mean())


def score_gap(port, ref) -> float:
    """The widest gap by which a match the port made lies below the
    reference's best score in its keypoint's row (scores in [0, 1]); 1
    where the port made none and the reference some."""
    mask = port["match_mask"].bool()
    if not bool(mask.any()):
        return 1.0 if bool(ref["match_mask"].any()) else 0.0
    s = ref["score_matrix"].float()[mask]
    chosen = s.gather(1, port["match_j"][mask].long()[:, None])[:, 0]
    return float((s.max(dim=1).values - chosen).max())


def pose_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a[:3, :4].float() - b[:3, :4].float()).abs().max())


def pnp_gap(rec, step_mod) -> float:
    """Both RANSAC passes rerun on the port's inputs, and the cascade's gate
    on the port's two solves, against what the port returned."""
    calls = rec.get("pnp", [])
    gaps = [pose_gap(c["c2w"], step_mod.ransac_pnp(*c["args"], **c["kw"]).c2w)
            for c in calls]
    if len(calls) == 2 and "refine_in" in rec:
        p1, p2 = calls
        n2_on_m1 = step_mod.count_pose_inliers(p2["c2w"], *p1["args"][:4],
                                               p1["kw"]["thresh_px"])
        use2 = p2["success"] & (n2_on_m1.float()
                                >= step_mod.CASCADE_SLACK * p1["num_inliers"].float())
        gaps.append(pose_gap(rec["refine_in"], torch.where(use2, p2["c2w"], p1["c2w"])))
    return max(gaps, default=0.0)


def refine_check(R, geometry, ctx, b, nz, rec) -> float:
    """render_missed of the reference's first refinement render (at the
    port's starting pose, through its twist as refine_pose starts) against
    the port's."""
    cameras, se3 = geometry
    uv = nz["refine_uv"]
    pose = se3.se3_exp_map(se3.se3_log_map(rec["refine_in"].float()))
    rays_o, rays_d = cameras.rays_for_pixels(uv, b["K"], pose)
    out = R.model_3d.render_rays(ctx, rays_o, rays_d, pose, train=False)
    return render_missed(rec["render"], rendered((ctx, rays_o, rays_d), out))


def sample_items(seed: int, done, n: int) -> List[tuple]:
    """(window index, pool item) of n distinct pool items of the window,
    each at its first occurrence: the window cycles its pool, so that lies
    in the first len(pool) queries, the ones the capture keeps."""
    first = {}
    for k, (i, _) in enumerate(done):
        first.setdefault(i, k)
    keys = sorted(first)
    rng = np.random.default_rng(derive(seed, "sample"))
    pick = rng.choice(len(keys), size=min(n, len(keys)), replace=False)
    return [(first[keys[j]], keys[j]) for j in sorted(pick)]


def compare(drv, seed: int, cap, done, make_reference) -> Dict[str, float]:
    ref = make_reference()
    ref.s.load_weights(seed)
    R, rs = ref.s.model, ref.s.system
    step_mod = rs.mods["step"]
    geometry = tuple(importlib.import_module(f"{rs.package}.geometry.{m}")
                     for m in ("cameras", "se3"))
    nkp = ref.s.cfg.matching.fine_num_3d_keypoints
    out: Dict[str, List[float]] = {}

    def put(k, v):
        out.setdefault(k, []).append(v)
    for k, i in sample_items(seed, done, int(drv.mix["sample"])):
        rec: Dict[str, Any] = cap.items[k]
        b = {key: v[0] for key, v in drv.device_batch(i).items()}
        nz = drv.noise[i]
        with rs.mode(), torch.no_grad():
            ctx, q2d = R.build_context(b)
            _, _, idx_r = R.model_3d.sample_keypoints(ctx, nkp, nz["kp_gumbel"])
            pts = rec["pts3d"].float()
            dmin, idx_p = torch.cdist(pts, ctx.coarse.xyz.float(),
                                       compute_mode="donot_use_mm_for_euclid_dist").min(dim=1)
            kept = set(idx_p[dmin < COORD_TOL].tolist())
            want = set(idx_r.tolist())
            put("kp_missed", 1.0 - len(kept & want) / max(len(want), 1))
            desc, pts3d, ndc = R.model_3d.query_coarse(ctx, points=pts)
            passes = [("m1", R.match(ctx, q2d, b, desc, pts3d, ndc))]
            if "m2" in rec:
                passes.append(("m2", R.match_cascade(ctx, q2d, b, desc, pts3d, ndc,
                                                     rec["pnp"][0]["c2w"])))
            for key, m in passes:
                put("score_gap", score_gap(rec[key], m))
                put("match_wrong", match_wrong(rec[key]))
            del passes
            put("pnp_gap", pnp_gap(rec, step_mod))
            if "refine_in" in rec:
                put("render_missed", refine_check(R, geometry, ctx, b, nz, rec))
        del ctx, q2d
    return {k: max(v) for k, v in out.items()}
