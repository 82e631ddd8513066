"""The train slice: the PyTorch port's losses, train_forward, gradients,
optimizer, train step and checkpoints against the JAX package, at
`__graft_entry__._tiny_cfg()` with render.fused_query_agg=True (V=3 at
32x32), on the CPU.

Both sides get the same weights and the same noise: the test draws it on
the JAX side, splitting the key as train_forward does (rng -> rng_kp,
rng_ray), and hands the numbers to the port. JAX's gradients cross into
port layout through the weight bridge (its transposes, flips and
reshapes are linear). Bounds, all f32: losses 1e-4 of their scale;
gradients per leaf ||g_port - g_jax|| <= 1e-3 ||g_jax|| + 1e-8 ||g_jax||
over all leaves (the second term covers the leaves whose gradient is zero
in exact arithmetic: biases before a normalization or a softmax);
optimizer updates 1e-6.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloc_tpu.models.fields import losses as jlosses
from nerfloc_tpu.models.fields.aggregator import SupportViews as JSupport
from nerfloc_tpu.models import matching as jmatching
from nerfloc_tpu.train.state import make_optimizer as j_make_optimizer
from nerfloc_tpu.utils.metrics import matching_iou as j_matching_iou
from nerfloc_tpu_torch.data import device_batch, make_query_batch, stack_batches
from nerfloc_tpu_torch.geometry.math import safe_normalize, safe_sqrt
from nerfloc_tpu_torch.models.fields import losses as tlosses
from nerfloc_tpu_torch.models.fields.aggregator import SupportViews as TSupport
from nerfloc_tpu_torch.models import matching as tmatching
from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
from nerfloc_tpu_torch.train import checkpoint as ckpt
from nerfloc_tpu_torch.train.state import AdamChain, TrainState, flat_grads
from nerfloc_tpu_torch.train.step import make_train_step
from nerfloc_tpu_torch.utils.metrics import matching_iou as t_matching_iou
from nerfloc_tpu_torch.weights import load_flax_variables

from _torch_parity import CPU, TinySetup, port_cfg, t

TERMS = ("loss", "coarse_loss", "fine_loss", "fine_err", "ref_depth_loss",
         "render_loss", "psnr")
GRAD_REL, GRAD_FLOOR = 1e-3, 1e-8


def rng(seed):
    return np.random.default_rng(seed)


def close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def jax_noise(S, key):
    """(kp_gumbel, ray_idx) of JAX train_forward under `key`."""
    rng_kp, rng_ray = jax.random.split(key)
    H, W = S.np_batch["image"].shape[:2]
    P = S.model.n_coarse_points(S.tbatch)
    kp = jax.random.gumbel(rng_kp, (P,), dtype=jnp.float32)
    idx = jax.random.choice(rng_ray, H * W, (S.cfg.render.N_rand,), replace=False)
    return t(np.asarray(kp)), t(np.asarray(idx))


def port_grads(model):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).clone()
            for n, p in model.named_parameters()}


def grads_in_port_layout(S, jgrads):
    """JAX parameter gradients carried into a port model's layout."""
    G = NerfPoseEstimator(port_cfg(S.cfg), device="cpu", seed=1)
    unused = load_flax_variables(G, {"params": jax.tree.map(np.asarray, jgrads),
                                     "frozen": S.np_vars["frozen"]})
    assert unused == []
    return {n: p.detach().clone() for n, p in G.named_parameters()}


def leaf_errors(got, want):
    """{leaf: (||got - want||, ||want||)} and ||want|| over all leaves."""
    errs = {n: (float((got[n] - w).double().norm()), float(w.double().norm()))
            for n, w in want.items()}
    return errs, sum(s * s for _, s in errs.values()) ** 0.5


def outside_bound(errs, total, slack=None):
    """Leaves whose error exceeds GRAD_REL ||want|| + GRAD_FLOOR ||want||_all
    (+ slack[leaf])."""
    return [(n, d, s) for n, (d, s) in errs.items()
            if d > GRAD_REL * s + GRAD_FLOOR * total + (slack or {}).get(n, 0.0)]


def worst_leaves(errs, total, n=3):
    """The largest relative errors among leaves whose gradient is not
    zero in exact arithmetic (norm above 1e-6 of the total)."""
    rows = sorted(((d / s, name) for name, (d, s) in errs.items() if s > 1e-6 * total),
                  reverse=True)
    return rows[:n]


@pytest.fixture(scope="module")
def run():
    S = TinySetup()
    key = jax.random.PRNGKey(0)
    m = S.jmodel

    def loss(params, variables, batch):
        out = m.apply({**variables, "params": params}, batch, key,
                      method=m.train_forward)
        return out["loss"], out

    # the batch and variables enter as constants of the compiled function,
    # as they are to the reference gradient (test_reference_gradient_spread
    # compiles the other way)
    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        lambda p: loss(p, S.variables, S.batch), has_aux=True))(S.variables["params"])
    kp, idx = jax_noise(S, key)
    S.model.zero_grad(set_to_none=True)
    tout = S.model.train_forward(S.tbatch, kp_gumbel=kp, ray_idx=idx)
    tout["loss"].backward()
    tgrads = port_grads(S.model)
    S.model.zero_grad(set_to_none=True)
    return dict(S=S, loss=loss, jout={k: np.asarray(v) for k, v in jout.items()},
                tout={k: v.detach().numpy() for k, v in tout.items()},
                jgrads=jgrads, want=grads_in_port_layout(S, jgrads), got=tgrads,
                kp=kp, idx=idx)


# -- losses and metrics, module by module -----------------------------------

def test_focal_and_coarse_loss_match_jax():
    logits = (rng(0).standard_normal((40, 60)) * 4).astype(np.float32)
    gt = (rng(1).uniform(size=(40, 60)) < 0.05).astype(np.float32)
    valid = rng(2).uniform(size=(40, 60)) < 0.7
    close(tmatching.sigmoid_focal_loss(t(logits), t(gt)),
          jmatching.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(gt)))
    close(tmatching.coarse_loss(t(logits), t(gt)),
          jmatching.coarse_loss(jnp.asarray(logits), jnp.asarray(gt)))
    close(tmatching.coarse_loss(t(logits), t(gt), t(valid)),
          jmatching.coarse_loss(jnp.asarray(logits), jnp.asarray(gt), jnp.asarray(valid)))


@pytest.mark.parametrize("kind", ["l2_with_std", "l2"])
def test_fine_losses_and_gradients_match_jax(kind):
    """Value and gradient: l2_with_std's weight carries no gradient."""
    expec = np.concatenate([rng(3).uniform(-1, 1, (64, 2)),
                            rng(4).uniform(0.05, 1.5, (64, 1))], -1).astype(np.float32)
    gt = rng(5).uniform(-1.4, 1.4, (64, 2)).astype(np.float32)
    mask = rng(6).uniform(size=64) < 0.8
    jf = jmatching.fine_loss_l2_std if kind == "l2_with_std" else jmatching.fine_loss_l2
    tf = tmatching.fine_loss_l2_std if kind == "l2_with_std" else tmatching.fine_loss_l2
    jv, jg = jax.value_and_grad(jf)(jnp.asarray(expec), jnp.asarray(gt), jnp.asarray(mask))
    x = t(expec).requires_grad_(True)
    tv = tf(x, t(gt), t(mask))
    tv.backward()
    close(tv.detach(), jv)
    close(x.grad, jg)


@pytest.mark.parametrize("beta", [False, True])
@pytest.mark.parametrize("depth", [False, True])
def test_rendering_loss_matches_jax(beta, depth):
    R, C = 48, 32
    r = rng(7)
    preds = {"rgb": r.uniform(0, 1, (R, 3)), "depth": r.uniform(0.5, 6, R),
             "depth_coarse": r.uniform(0.5, 6, R), "feat": r.standard_normal((R, C)),
             "mask": r.uniform(size=R) < 0.8}
    if beta:
        preds["beta"] = r.uniform(0.1, 2, R)
    targets = {"rgb": r.uniform(0, 1, (R, 3)), "feat": r.standard_normal((R, C)),
               "depth": np.where(r.uniform(size=R) < 0.8, r.uniform(0.5, 6, R), 0.0),
               "mask": r.uniform(size=R) < 0.9}
    cast = lambda d, f: {k: f(np.asarray(v, np.float32) if v.dtype != bool else v)  # noqa: E731
                         for k, v in d.items()}
    jp, jt_ = cast(preds, jnp.asarray), cast(targets, jnp.asarray)
    tp, tt = cast(preds, t), cast(targets, t)
    jt_["depth_range"] = (jnp.float32(0.5), jnp.float32(6.0))
    tt["depth_range"] = (torch.tensor(0.5), torch.tensor(6.0))
    close(tlosses.rendering_loss(tp, tt, use_depth=depth),
          jlosses.rendering_loss(jp, jt_, use_depth=depth))
    close(tlosses.mse2psnr(tlosses.img2mse(tp["rgb"], tt["rgb"], tt["mask"])),
          jlosses.mse2psnr(jlosses.img2mse(jp["rgb"], jt_["rgb"], jt_["mask"])))


def test_matching_iou_matches_jax():
    r = rng(8)
    mj, gj = r.integers(0, 6, 50), r.integers(0, 6, 50)
    mm, gm = r.uniform(size=50) < 0.6, r.uniform(size=50) < 0.6
    close(t_matching_iou(t(mj), t(mm), t(gj), t(gm)),
          j_matching_iou(*map(jnp.asarray, (mj, mm, gj, gm))), rel=1e-6)


@pytest.mark.parametrize("depth", ["query", "far"])
def test_build_3d_2d_pairs_matches_jax(run, depth):
    """Indices and masks exact; 'far' fails every depth check, so the
    pairs fall back to the projecting keypoints."""
    S = run["S"]
    b = S.np_batch
    H, W = b["image"].shape[:2]
    uv = rng(9).integers(0, 32, (40, 2))
    d = b["depth"][uv[:, 1], uv[:, 0]]
    pc = np.concatenate([uv + 0.5, np.ones((40, 1))], -1) @ np.linalg.inv(b["K"]).T * d[:, None]
    pts = np.concatenate([pc @ b["pose"][:3, :3].T + b["pose"][:3, 3],
                          b["pose"][:3, 3] + rng(10).uniform(-3, 3, (40, 3))]).astype(np.float32)
    dmap = b["depth"] if depth == "query" else np.full_like(b["depth"], 100.0)
    args = (pts, dmap, b["K"], b["pose"])
    want = S.japply(lambda mod, *a: mod.build_3d_2d_pairs(*a, H, W, 8, 2.0),
                    *map(jnp.asarray, args))
    got = NerfPoseEstimator.build_3d_2d_pairs(*map(t, args), H, W, 8, 2.0)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert 4 <= int(got[1].sum()) < 80
    close(got[2], want[2], rel=1e-6)


def test_ref_depth_loss_matches_jax(run):
    S = run["S"]
    b = S.np_batch
    V = b["topk_images"].shape[0]
    fields = dict(images=b["topk_images"], depths=b["topk_depths"], poses=b["topk_poses"],
                  Ks=b["topk_Ks"], near=b["near"], far=b["far"],
                  vis_featmaps=rng(10).standard_normal((V, 8, 8, 32)).astype(np.float32))
    jsv = JSupport(**{k: jnp.asarray(v) for k, v in fields.items()})
    tsv = TSupport(**{k: t(v) for k, v in fields.items()})
    want = S.japply(lambda mod, sv, d: mod.model_3d.multiview_aggregator.ref_depth_loss(sv, d),
                    jsv, jnp.asarray(b["topk_depths"]))
    with torch.no_grad():
        got = S.model.model_3d.multiview_aggregator.ref_depth_loss(tsv, t(b["topk_depths"]))
    close(got, want)


def test_safe_math_gradients_are_finite():
    """At 0 and at the finfo.max/4 distance of masked render neighbours."""
    big = torch.finfo(torch.float32).max / 4
    x = torch.tensor([0.0, 1e-30, 2.0, big], requires_grad=True)
    safe_sqrt(x).sum().backward()
    assert bool(torch.isfinite(x.grad).all())
    v = torch.zeros(2, 3, requires_grad=True)
    (safe_normalize(v) * torch.arange(6.0).view(2, 3)).sum().backward()
    assert bool(torch.isfinite(v.grad).all())


def test_decoded_depth_matches_jax_with_finite_gradients():
    """from_inverse_normalized_depth around the d_norm whose d_inv is exactly
    0 (the plain clip's gradient is NaN there), at +-0, tiny and large d_inv
    and inside the range: values equal JAX's, gradients finite, and equal to
    JAX's wherever JAX's are."""
    from nerfloc_tpu.models.fields.neuray import from_inverse_normalized_depth as j_fn
    from nerfloc_tpu_torch.models.fields.neuray import from_inverse_normalized_depth as t_fn
    near, far = np.float32(0.5), np.float32(2.0 * 2.0 * np.sqrt(3.0))
    c = np.float32(-1.0 / far) - np.float32(-1.0 / near)
    x0 = np.float32(np.float32(1.0 / near) / c)
    xs = [x0]
    for _ in range(3):
        xs = [np.nextafter(xs[0], np.float32(-9)), *xs, np.nextafter(xs[-1], np.float32(9))]
    d_norm = np.array(xs + [-0.5, 0.0, 0.3, 0.99, 1.0, 1.05, 3.0, 1e30], np.float32)
    d_inv = d_norm * c + np.float32(-1.0 / near)
    assert (d_inv == 0).any(), "no d_norm hits d_inv == 0 exactly"
    jval, jgrad = jax.vmap(jax.value_and_grad(lambda x: j_fn(x, near, far)))(jnp.asarray(d_norm))
    x = torch.tensor(d_norm, requires_grad=True)
    got = t_fn(x, torch.tensor(near), torch.tensor(far))
    got.sum().backward()
    assert np.array_equal(got.detach().numpy(), np.asarray(jval))
    assert bool(torch.isfinite(x.grad).all())
    jg = np.asarray(jgrad)
    fin = np.isfinite(jg)
    assert not fin.all(), "JAX's gradient is finite everywhere: the point is not hit"
    np.testing.assert_allclose(x.grad.numpy()[fin], jg[fin], rtol=1e-6, atol=0)
    assert np.all(x.grad.numpy()[~fin] == 0)


# -- train_forward and its gradients ---------------------------------------------

@pytest.mark.parametrize("key", TERMS)
def test_train_forward_matches_jax(run, key):
    print(f"{key}: port {run['tout'][key]!r}, jax {run['jout'][key]!r}")
    close(run["tout"][key], run["jout"][key])


@pytest.mark.parametrize("key", ["match_j", "match_mask", "j_gt", "gt_mask"])
def test_train_forward_discrete_outputs_match_jax(run, key):
    assert np.array_equal(run["tout"][key], run["jout"][key])


def test_parameter_gradients_match_jax(run):
    errs, total = leaf_errors(run["got"], run["want"])
    print(f"worst gradient leaves (relative error): {worst_leaves(errs, total)}")
    assert all(bool(torch.isfinite(g).all()) for g in run["got"].values())
    assert not outside_bound(errs, total)


def test_reference_gradient_spread(run):
    """The reference's own gradient moves with how XLA compiles it: with
    the batch and variables as arguments instead of constants it differs
    by up to a few percent on the DepthFusionNet leaves nearest its input
    (InstanceNorm over 2x2..15x15 maps). The port lies within that spread
    of the argument-compiled gradient, leaf by leaf."""
    S = run["S"]
    jg2 = jax.jit(jax.grad(lambda p, v, b: run["loss"](p, v, b)[0]))(
        S.variables["params"], S.variables, S.batch)
    other = grads_in_port_layout(S, jg2)
    spread, total = leaf_errors(other, run["want"])
    port, _ = leaf_errors(run["got"], other)
    print(f"reference spread {worst_leaves(spread, total)}; port vs argument-compiled "
          f"{worst_leaves(port, total)}")
    assert not outside_bound(port, total, {n: 1.5 * d for n, (d, _) in spread.items()})


def test_unfused_path_has_the_same_gradients(run):
    """render.fused_query_agg=False (the module chain in query()) against
    the fused plain version, same weights and noise."""
    S = run["S"]
    cfg = dataclasses.replace(S.model.cfg, render=dataclasses.replace(
        S.model.cfg.render, fused_query_agg=False))
    m = NerfPoseEstimator(cfg, device="cpu", seed=1)
    m.load_state_dict(S.model.state_dict())
    out = m.train_forward(S.tbatch, kp_gumbel=run["kp"], ray_idx=run["idx"])
    out["loss"].backward()
    close(out["loss"].detach(), run["tout"]["loss"], rel=1e-5)
    assert not outside_bound(*leaf_errors(port_grads(m), run["got"]))


# -- optimizer, train step, checkpoints --------------------------------------------

def test_optimizer_matches_optax():
    """zero_nonfinite -> clip 1.0 -> Adam -> staircase decay on identical
    gradients: a NaN and an Inf element, a norm above 1, and the decay
    boundary (decay every 2 updates)."""
    from nerfloc_tpu.configs import Config as JConfig
    tx = j_make_optimizer(JConfig(lrate_decay_steps=2))
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    jstate = tx.init(params)
    ours = AdamChain(lrate=5e-4, decay_steps=2, decay_factor=0.5)
    tstate = ours.init(17, CPU)
    r = rng(11)
    for count, scale in enumerate((0.01, 3.0, 0.2, 5.0, 0.05)):
        g = {k: (r.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}
        if count == 1:
            g["a"][0, 0], g["b"][2] = np.nan, np.inf
        jupd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, params)
        tupd, tstate = ours.update(torch.cat([t(g[k]).reshape(-1) for k in ("a", "b")]),
                                   tstate, count)
        want = np.concatenate([np.asarray(jupd[k]).reshape(-1) for k in ("a", "b")])
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(tupd.numpy(), want, rtol=0, atol=min(1e-6, 1e-4 * scale))
        assert scale > 1e-5


def _two_query_batch():
    items = [device_batch(make_query_batch(n_views=3, H=32, W=32, seed=s)) for s in (0, 1)]
    return to_device_batch(stack_batches(items), CPU), items


def test_train_step_b2_is_the_mean_of_its_queries(run):
    S = run["S"]
    batch, items = _two_query_batch()
    g = torch.Generator().manual_seed(5)
    P = S.model.n_coarse_points(S.tbatch)
    kp = torch.randn(2, P, generator=g)
    idx = torch.stack([torch.randperm(32 * 32, generator=g)[:S.cfg.render.N_rand]
                       for _ in range(2)])
    ref = copy.deepcopy(S.model)
    per_query, losses = [], []
    for b in range(2):
        ref.zero_grad(set_to_none=True)
        out = ref.train_forward(to_device_batch(items[b], CPU), kp_gumbel=kp[b],
                                ray_idx=idx[b])
        out["loss"].backward()
        per_query.append(port_grads(ref))
        losses.append(float(out["loss"].detach()))
    model = copy.deepcopy(S.model)
    state = TrainState(model, model.cfg)
    metrics = make_train_step(model, model.cfg)(state, batch, kp_gumbel=kp, ray_idx=idx)
    close(metrics["loss"], np.mean(losses), rel=1e-6)
    mean = {n: (per_query[0][n] + per_query[1][n]) / 2 for n in per_query[0]}
    assert not outside_bound(*leaf_errors(port_grads(model), mean))
    assert set(metrics) >= set(TERMS) | {"grad_norm", "matching_iou"}
    assert state.step == 1
    expected = torch.sqrt(sum(torch.sum(v ** 2) for v in port_grads(model).values()))
    close(metrics["grad_norm"], expected, rel=1e-5)


def _steps(model, n, seed0=0):
    """n train steps at fixed noise -> the last metrics."""
    state = TrainState(model, model.cfg) if not isinstance(model, TrainState) else model
    step = make_train_step(state.model, state.model.cfg)
    batch = to_device_batch(stack_batches([device_batch(make_query_batch(
        n_views=3, H=32, W=32, seed=0))]), CPU)
    P = state.model.n_coarse_points({k: v[0] for k, v in batch.items()})
    for i in range(n):
        g = torch.Generator().manual_seed(seed0 + state.step)
        step(state, batch, kp_gumbel=torch.randn(1, P, generator=g),
             ray_idx=torch.randperm(32 * 32, generator=g)[None, :32])
    return state


@pytest.fixture
def deterministic():
    """CPU convolution backward sums in a thread-dependent order unless
    deterministic algorithms are asked for."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def test_resume_equals_an_uninterrupted_run(run, tmp_path, deterministic):
    S = run["S"]
    straight = _steps(copy.deepcopy(S.model), 3)
    mgr = ckpt.CheckpointManager(str(tmp_path / "ckpts"), max_to_keep=2)
    first = _steps(copy.deepcopy(S.model), 1)
    mgr.save(first.step, first)
    fresh = NerfPoseEstimator(S.model.cfg, device="cpu", seed=7)
    resumed = TrainState(fresh, fresh.cfg)
    resumed.load_state_dict(mgr.restore())
    assert resumed.step == 1
    _steps(resumed, 2)
    for (n, a), b in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), n
    for k in ("mu", "nu"):
        assert torch.equal(straight.opt_state[k], resumed.opt_state[k])
    assert resumed.step == straight.step == 3


def test_checkpoint_round_trip_and_retention(tmp_path):
    """Recency keeps max_to_keep; a later, worse save never evicts the best
    one; restore(best=...) returns it; a fresh manager finds the streams."""
    def st(i, v):
        return {"step": i, "model": {"w": torch.full((3,), float(v))},
                "opt_state": {"mu": torch.zeros(3), "nu": torch.ones(3)}}
    d = str(tmp_path / "ckpts")
    mgr = ckpt.CheckpointManager(d, max_to_keep=2, metric_keys={
        "pose_acc": "max", "median_trans_err_m": "min"})
    assert mgr.restore() is None and mgr.best_step("pose_acc") is None
    mgr.save(1, st(1, 1.0), metrics={"pose_acc": 0.5, "median_trans_err_m": 0.10})
    mgr.save(2, st(2, 2.0), metrics={"pose_acc": torch.tensor(0.9),
                                     "median_trans_err_m": 0.03})
    mgr.save(3, st(3, 3.0), metrics={"pose_acc": 0.4, "median_trans_err_m": 0.20})
    mgr.save(4, st(4, 4.0))
    assert mgr.latest_step() == 4
    assert mgr.best_step("pose_acc") == 2 and mgr.best_step("median_trans_err_m") == 2
    assert torch.equal(mgr.restore(best="pose_acc")["model"]["w"], torch.full((3,), 2.0))
    assert torch.equal(mgr.restore()["model"]["w"], torch.full((3,), 4.0))
    assert mgr.restore(step=3)["step"] == 3
    assert ckpt._steps(d) == [3, 4]
    assert set(ckpt.discover_best_dirs(d)) == {"pose_acc", "median_trans_err_m"}
    assert ckpt.CheckpointManager(d, metric_keys={"pose_acc": "max"}).best_step() == 2


def test_partial_restore_matches_shapes():
    current = {"a.w": torch.zeros(3, 3), "a.b": torch.zeros(4), "new.w": torch.ones(2, 2)}
    restored = {"a.w": torch.full((3, 3), 7.0, dtype=torch.float64), "a.b": torch.zeros(9)}
    out = ckpt.partial_restore(current, restored)
    assert torch.equal(out["a.w"], torch.full((3, 3), 7.0)) and out["a.w"].dtype == torch.float32
    assert out["a.b"].shape == (4,)
    assert torch.equal(out["new.w"], torch.ones(2, 2))


def test_flat_grads_fill_missing_with_zeros():
    """A parameter without a gradient (keypoint_head's: the keypoint draw
    is a top-k) takes a zero one, so every parameter shares the count."""
    a, b = torch.nn.Parameter(torch.ones(2)), torch.nn.Parameter(torch.ones(3))
    a.grad = torch.full((2,), 5.0)
    assert flat_grads([a, b]).tolist() == [5.0, 5.0, 0.0, 0.0, 0.0]
