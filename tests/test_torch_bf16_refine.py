"""Photometric pose refinement through the bf16 renderer: the PyTorch
port's refine_pose with a render_fn of the model at dtype=torch.bfloat16
against the JAX package's at dtype=jnp.bfloat16, on the CPU, at
`__graft_entry__._tiny_cfg()` with render.fused_query_agg=True (JAX's
fused kernel in Pallas interpret mode, its backward the replayed
reference_agg at bf16 on both sides).

As tests/test_torch_eval.py does in f32, a pose near the ground truth (the
ground truth moved by a fixed twist) is refined against JAX's scene
context (bf16 here; the port builds its tables from its fields), and the
JAX side is refine_pose's own step written out around one compiled
value_and_grad of its loss per dtype. The f32 references render the same
context cast to f32. The loss is taken in the target's dtype, f32, and the
twist and the Adam moments are f32 on both sides.

d loss / d twist at the initial pose and the first per-step losses hold
the yardstick of tests/test_torch_bf16.py, c = 1: rms(port16 - jax16) <=
rms(jax16 - jax32) and rms(port16 - port32) >= 0.5 rms(jax16 - jax32); the
whole trajectory and the refined pose as test_refinement_trajectory_bf16
says. `-s` prints the ratios.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfloc_tpu.geometry import cameras as jcam
from nerfloc_tpu.geometry import se3 as jse3
from nerfloc_tpu.solve.pose_refine import sample_refine_pixels as j_sample_pixels
from nerfloc_tpu_torch.geometry import cameras as tcam
from nerfloc_tpu_torch.geometry import se3 as tse3
from nerfloc_tpu_torch.solve.pose_refine import refine_pose

from _torch_parity import few_threads, t  # noqa: F401
from test_torch_bf16 import Bf16Setup, f32tree, port_context, rms, yardstick

REFINE_RAYS, STEPS, LR = 64, 50, 1e-3
EARLY = 10            # steps before the loss surface's first switch
PERTURB = 2.0 ** -22
TWIST = [0.02, -0.01, 0.015, 0.01, -0.015, 0.01]


@pytest.fixture(scope="module")
def run():
    S = Bf16Setup()
    b = S.np_batch
    H, W = b["image"].shape[:2]
    m16 = S.jm[16]
    ctx = {16: jax.jit(lambda v, bb: m16.apply(v, bb, method=m16.build_context)[0])(
        S.variables, S.batch)}
    ctx[32] = f32tree(ctx[16])
    # the bf16 context's floating fields scaled by 1 + 2^-22: the spread of
    # each package's bf16 trajectory under a change far below bf16's step
    ctx["16+"] = jax.tree.map(lambda a: (a.astype(jnp.float32) * (1 + PERTURB)).astype(a.dtype)
                              if jnp.issubdtype(a.dtype, jnp.floating) else a, ctx[16])
    pose0 = (np.asarray(jse3.se3_exp_map(jnp.asarray(TWIST, jnp.float32))) @ b["pose"]
             ).astype(np.float32)
    uv = np.asarray(j_sample_pixels(jax.random.PRNGKey(3), H, W, REFINE_RAYS))
    target = jnp.asarray(b["image"])[uv[:, 1].astype(np.int32), uv[:, 0].astype(np.int32)]
    out, vgs = {}, {}
    for d in (16, 32, "16+"):
        dt = 16 if d == "16+" else d
        m = S.jm[dt]

        def j_loss(twist, c, m=m):
            pose = jse3.se3_exp_map(twist)
            ro, rd = jcam.rays_for_pixels(jnp.asarray(uv), S.batch["K"], pose)
            o = m.apply(S.variables, method=lambda mm: mm.model_3d.render_rays(
                c, ro, rd, pose, False))
            msk = o["mask"].astype(target.dtype)[:, None]
            n = jnp.sum(msk)
            return jnp.sum(((o["rgb"] - target) * msk) ** 2) / jnp.maximum(n, 1.0), n
        vg = vgs.setdefault(dt, jax.jit(jax.value_and_grad(j_loss, has_aux=True)))
        twist0 = jse3.se3_log_map(jnp.asarray(pose0))
        opt = optax.adam(LR, b1=0.9, b2=0.999)
        twist, state = twist0, opt.init(twist0)
        losses, grad0 = [], None
        for _ in range(STEPS):
            (loss, _), g = vg(twist, ctx[d])
            grad0 = np.asarray(g) if grad0 is None else grad0
            upd, state = opt.update(g, state, twist)
            new = optax.apply_updates(twist, upd)
            twist = jnp.where(jnp.isfinite(loss) & jnp.all(jnp.isfinite(new)), new, twist)
            losses.append(float(loss))
        (l0, n0), _ = vg(twist0, ctx[d])
        (lf, nf), _ = vg(twist, ctx[d])
        pose_f = jse3.se3_exp_map(twist)
        accept = bool((lf <= l0) & (nf >= 0.5 * n0) & jnp.all(jnp.isfinite(pose_f)))
        out[("jax", d)] = dict(grad0=grad0, losses=np.array(losses), accept=accept,
                               pose=np.asarray(pose_f) if accept else pose0)

        pm = S.pm[dt]
        pctx = port_context(pm, ctx[d])

        def render_fn(rays_o, rays_d, p, pm=pm, pctx=pctx):
            return pm.model_3d.render_rays(pctx, rays_o, rays_d, p, train=False)
        x = tse3.se3_log_map(t(pose0)).requires_grad_(True)
        pose = tse3.se3_exp_map(x)
        o = render_fn(*tcam.rays_for_pixels(t(uv), t(b["K"]), pose), pose)
        assert o["rgb"].dtype == torch.float32
        msk = o["mask"].float()[:, None]
        loss0 = torch.sum(((o["rgb"] - t(np.asarray(target))) * msk) ** 2) / msk.sum().clamp(min=1)
        trace = []
        tpose = refine_pose(render_fn, t(pose0), t(b["K"]), t(b["image"]), t(uv),
                            max_steps=STEPS, lr=LR, trace=trace)
        out[("port", d)] = dict(grad0=torch.autograd.grad(loss0, x)[0].numpy(),
                                losses=torch.stack(trace).numpy(), pose=tpose.numpy(),
                                accept=not np.array_equal(tpose.numpy(), pose0))
    out["n0"] = float(n0)
    return out


def _check(run, key, name):
    return yardstick(name, run[("port", 16)][key], run[("jax", 16)][key],
                     run[("jax", 32)][key], run[("port", 32)][key], 1.0)


def test_loss_gradient_in_the_twist_bf16(run):
    """d loss / d twist at the initial pose: through the bf16 renderer, the
    fused kernel's replayed bf16 backward into the samples' positions and
    directions, the table sampling's blend weights and the ray geometry."""
    assert run["n0"] >= 0.5 * REFINE_RAYS, "too few rays see the scene"
    _check(run, "grad0", "d loss / d twist")


def test_refinement_trajectory_bf16(run):
    """The per-step losses and the refined pose. Every side accepts its
    refinement and its losses fall. The first EARLY steps hold the
    yardstick. Later the loss is not smooth in the twist (a sample's
    neighbours and the ray mask switch discretely, tests/test_torch_eval.py)
    and a bf16 trajectory meets a switch a few steps earlier or later: the
    whole trajectory and the refined pose are held after removing, in
    quadrature, each package's own spread under a 2^-22 change of the
    context: rms(port16 - jax16)^2 <= rms(jax16 - jax32)^2 + spread_jax^2
    + spread_port^2 (c = 1)."""
    for side in ("jax", "port"):
        for d in (16, 32, "16+"):
            r = run[(side, d)]
            assert np.isfinite(r["losses"]).all() and r["losses"][-1] < r["losses"][0], (side, d)
            assert r["accept"], (side, d)
    yardstick(f"first {EARLY} losses", *(run[k]["losses"][:EARLY] for k in (
        ("port", 16), ("jax", 16), ("jax", 32), ("port", 32))), 1.0)
    for key in ("losses", "pose"):
        p16, j16, j32 = (run[k][key].astype(np.float64) for k in (
            ("port", 16), ("jax", 16), ("jax", 32)))
        sj = rms(j16 - run[("jax", "16+")][key])
        sp = rms(p16 - run[("port", "16+")][key])
        close, ref = rms(p16 - j16), rms(j16 - j32)
        print(f"{key}: rms |port16-jax16| {close:.3g}, |jax16-jax32| {ref:.3g}, spreads jax "
              f"{sj:.3g} port {sp:.3g}; ratio {close / np.sqrt(ref ** 2 + sj ** 2 + sp ** 2):.3f}")
        assert close ** 2 <= ref ** 2 + sj ** 2 + sp ** 2
