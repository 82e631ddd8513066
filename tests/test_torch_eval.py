"""The eval slice on the CPU: the PyTorch port's cascade matching, pose
inlier count, per-scene table, photometric refinement through the
renderer, eval step and eval harness against the JAX package, at
`__graft_entry__._tiny_cfg()` with render.fused_query_agg=True,
cascade_matching=True and optimize_pose=True (V=3 at 32x32; JAX's fused
Pallas kernel runs in interpret mode). To keep the CPU time of JAX's
compiled programs down, the eval step refines with 32 rays and the
refinement test with 64 (the full-width path uses 512).

Both sides get the same weights and the same noise: the test draws it on
the JAX side, splitting the keys as make_eval_step does (rng -> one key
per query -> r_match, r_pnp, r_pnp2, r_ref), and hands the numbers to the
port. Bounds, all f32, as measured on the CPU: the inlier count, the
visibility mask and the per-scene table exact; the cascade losses 5e-6 of
their scale; the second matcher's gradient leaves 1e-3 of their norm plus
1e-8 of the total (as tests/test_torch_train.py holds the others).

The refinement refines a pose near the ground truth (the ground truth
moved by a fixed twist of 0.02 rad and 2 cm) against the JAX scene context
(the port builds its tables from JAX's fields, so only the refinement is
compared); the JAX side is refine_pose's own step written out around one
compiled value_and_grad of its loss. The gradient of the loss in the twist
is held to 1e-4 of its norm. Then the two trajectories part slowly: Adam
divides each component by its own root mean square, so a component near 0
moves by about lr whatever the sign of its last-bit noise, and the loss is
not smooth in the twist (a sample's 8 neighbours and the ray mask switch
discretely). So the first 10 steps' losses are held to EARLY_LOSS_REL of
the initial loss, every step's to TRAJ_LOSS_REL and the refined pose to
POSE_TOL (measured values beside them). The eval step's discrete outputs
are exact and its poses and errors within EVAL_POSE_TOL, EVAL_ROT_TOL and
EVAL_TRANS_TOL (see there for why they are wider than the refinement's
own bounds).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfloc_tpu.configs import StaticShapeConfig
from nerfloc_tpu.geometry import cameras as jcam
from nerfloc_tpu.geometry import se3 as jse3
from nerfloc_tpu.models.pose_estimator import select_visible_mask as j_visible
from nerfloc_tpu.parallel.mesh import MeshSpec, make_mesh, shard_batch
from nerfloc_tpu.solve.pnp import count_pose_inliers as j_count_inliers
from nerfloc_tpu.solve.pose_refine import sample_refine_pixels as j_sample_pixels
from nerfloc_tpu.train.step import make_eval_step as j_make_eval_step
from nerfloc_tpu.utils import metrics as jmetrics
from nerfloc_tpu_torch.data import device_batch, make_query_batch, stack_batches
from nerfloc_tpu_torch.geometry import cameras as tcam
from nerfloc_tpu_torch.geometry import se3 as tse3
from nerfloc_tpu_torch.models.pose_estimator import (NerfPoseEstimator, select_visible_mask,
                                                     to_device_batch)
from nerfloc_tpu_torch.solve.pnp import count_pose_inliers
from nerfloc_tpu_torch.solve.pose_refine import refine_pose
from nerfloc_tpu_torch.train.checkpoint import DEFAULT_METRIC_MODES
from nerfloc_tpu_torch.train.evaluate import (eval_dataset, make_render_psnr_fn,
                                              render_psnr_eval)
from nerfloc_tpu_torch.train.step import make_eval_step
from nerfloc_tpu_torch.utils import metrics as tmetrics

from _torch_parity import CPU, TinySetup, few_threads, port_cfg, port_context, t  # noqa: F401
from test_torch_train import (grads_in_port_layout, leaf_errors, outside_bound, port_grads,
                              worst_leaves)

LOSS_REL = 5e-6
REFINE_RAYS, STEPS, LR = 64, 50, 1e-3
GRAD_REL = 1e-4
# measured: the gradient 5.4e-6; the first 10 steps' losses 3.3e-6 of the
# first, every step's 2.3e-3 (step 46; 8 of 50 above 1e-4, each where a
# switch falls between the two twists); the refined pose 8.9e-4, of a move
# of 5.4e-2 (1.2e-4 to 8.9e-4 as Adam's bias correction, the ray count or
# the thread count change the last bits)
EARLY_STEPS, EARLY_LOSS_REL, TRAJ_LOSS_REL, POSE_TOL = 10, 1e-5, 1e-2, 5e-3
SECOND = ("coarse_transformer2", "coarse_matcher2", "fine_preprocess2", "fine_transformer2",
          "fine_matcher2")
# The eval step's poses (measured on the CPU): before refinement
# they agree to 3.5e-6. The port builds its own scene context, which differs
# from JAX's by ~1e-4 relative (DepthFusionNet, tests/test_torch_modules.py);
# on the same context the refinement follows JAX's closely (the trajectory
# test), but the context's difference moves the loss surface, and 50 Adam
# steps of about lr each, in a loss that jumps where a sample's neighbours
# switch, carry it on: the refined poses differ by 1.4e-3 (rot_err 0.058
# deg, trans_err 3.9e-4 m); with 128 refinement rays by 5.0e-3 to 5.9e-3
# (rot_err 0.087-0.099 deg), as Adam's bias correction rounds one f32 ulp
# either way.
EVAL_POSE_TOL, EVAL_ROT_TOL, EVAL_TRANS_TOL = 2e-2, 0.5, 1e-2


def rng(seed):
    return np.random.default_rng(seed)


def close(got, want, rel):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.fixture(scope="module")
def S():
    return TinySetup(cascade_matching=True, optimize_pose=True,
                     shapes=StaticShapeConfig(pose_refine_rays=32))


# -- small pieces -----------------------------------------------------------------

def test_select_visible_mask_matches_jax():
    K = np.array([[50.0, 0, 32.0], [0, 50.0, 32.0], [0, 0, 1.0]], np.float32)
    pts = np.array([[0, 0, 2.0], [0, 0, -2.0], [10, 0, 1.0]], np.float32)
    assert select_visible_mask(t(pts), torch.eye(4), t(K), 64, 64).tolist() == \
        [True, False, False]
    r = rng(0)
    pts = r.uniform(-3, 3, (200, 3)).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.linalg.qr(r.standard_normal((3, 3)))[0] * [1, 1, -1]
    pose[:3, 3] = r.uniform(-0.5, 0.5, 3)
    got = select_visible_mask(t(pts), t(pose), t(K), 48, 64).numpy()
    want = np.asarray(j_visible(*map(jnp.asarray, (pts, pose, K)), 48, 64))
    assert np.array_equal(got, want) and 0 < got.sum() < 200


def test_count_pose_inliers_matches_jax():
    """A pose, 300 matches of which 40 % are outliers and 10 % masked; the
    threshold in pixels as ransac_pnp reads it."""
    r = rng(1)
    K = np.array([[200.0, 0, 160], [0, 190.0, 120], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.linalg.qr(r.standard_normal((3, 3)))[0]
    pose[:3, :3] *= np.sign(np.linalg.det(pose[:3, :3]))
    pose[:3, 3] = r.standard_normal(3)
    pc = np.concatenate([r.uniform(-1, 1, (300, 2)), r.uniform(2, 6, (300, 1))], -1)
    pc[:, :2] *= pc[:, 2:]
    pw = (pc @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)
    uv = pc[:, :2] / pc[:, 2:] * [K[0, 0], K[1, 1]] + K[:2, 2]
    uv += np.where(r.uniform(size=(300, 1)) < 0.4, r.uniform(-60, 60, (300, 2)),
                   r.normal(0, 2, (300, 2)))
    mask = r.uniform(size=300) < 0.9
    args = (pose, uv.astype(np.float32), pw, mask, K)
    for thr in (2.0, 8.0):
        got = count_pose_inliers(*map(t, args), thresh_px=thr)
        want = j_count_inliers(*map(jnp.asarray, args), thresh_px=thr)
        assert got.dtype == torch.int32 and int(got) == int(want)
        assert 0 < int(got) < mask.sum()


@pytest.mark.parametrize("dataset_type", ["video_7scenes", "cambridge"])
def test_aggregate_per_scene_matches_jax(dataset_type):
    """Three scenes (two Cambridge names), scale factors, the IoU extra."""
    r = rng(2)
    n = 30
    sids = r.integers(0, 3, n)
    rot = r.uniform(0, 10, n).astype(np.float32)
    trans = r.uniform(0, 0.6, n).astype(np.float32)
    scales = r.uniform(0.5, 2.0, n).astype(np.float32)
    iou = r.uniform(0, 1, n).astype(np.float32)
    names = {0: "ShopFacade", 1: "KingsCollege", 2: "chess"}
    kw = dict(rot_thresh=5.0, trans_thresh=0.05, dataset_type=dataset_type,
              extras={"matching_iou": iou})
    got = tmetrics.aggregate_per_scene(sids, rot, trans, names, scales, **kw)
    want = jmetrics.aggregate_per_scene(sids, rot, trans, names, scales, **kw)
    assert got == want
    assert tmetrics.pose_accuracy(rot, trans) == float(jmetrics.pose_accuracy(
        jnp.asarray(rot), jnp.asarray(trans)))
    assert tmetrics.CAMBRIDGE_TRANS_THRESH == jmetrics.CAMBRIDGE_TRANS_THRESH


# -- the cascade matcher ----------------------------------------------------------------

def test_cascade_model_loads_every_jax_leaf(S):
    assert S.unused == []
    names = {n.split(".")[0] for n, _ in S.model.named_parameters()}
    assert set(SECOND) <= names


# encode_appearance=False is ported (tests/test_torch_finetune.py holds it
# against JAX), and so are these two now (tests/test_torch_model_options.py
# holds them against JAX): neither raises, and a query runs
@pytest.mark.parametrize("option", [dict(simple_3d_model=True),
                                    dict(keypoints_3d_source="sfm")],
                         ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_unported_options_still_raise(S, option):
    model = NerfPoseEstimator(port_cfg(dataclasses.replace(S.cfg, **option)), device="cpu")
    b = dict(S.tbatch)
    b["points3d"] = S.tbatch["topk_poses"][0, :3, 3] + torch.linspace(-1, 1, 120)[:, None]
    with torch.no_grad():
        out = model.localize_forward(b, generator=torch.Generator().manual_seed(0))
    assert out["mkps3d"].shape == (S.cfg.matching.fine_num_3d_keypoints, 3)
    assert bool(torch.isfinite(out["pose"]).all())


@pytest.fixture(scope="module")
def cascade(S):
    """Both packages' first pass and cascade pass (the cascade seeded with
    the ground-truth pose, so that most keypoints stay in it)."""
    m = S.jmodel
    key = jax.random.PRNGKey(4)

    @jax.jit
    def run(v, b):
        ctx, q2d, desc, pts, ndc, m1 = m.apply(v, b, key, method=m.localize_parts)
        m2 = m.apply(v, ctx, q2d, b, desc, pts, ndc, b["pose"], method=m.match_cascade)
        return m1, m2
    jm1, jm2 = run(S.variables, S.batch)
    kp = t(np.asarray(jax.random.gumbel(key, (S.model.n_coarse_points(S.tbatch),))))
    with torch.no_grad():
        ctx, q2d, desc, pts, ndc, tm1 = S.model.localize_parts(S.tbatch, kp)
        tm2 = S.model.match_cascade(ctx, q2d, S.tbatch, desc, pts, ndc, S.tbatch["pose"])
    return [({k: np.asarray(v) for k, v in j.items()}, {k: v.numpy() for k, v in p.items()})
            for j, p in ((jm1, tm1), (jm2, tm2))]


@pytest.mark.parametrize("which", [0, 1], ids=["first", "cascade"])
def test_match_cascade_matches_jax(cascade, which):
    want, got = cascade[which]
    assert sorted(got) == sorted(want)
    for k in ("match_j", "match_mask", "pair_mask"):
        assert np.array_equal(got[k], want[k]), k
    for k in ("score_matrix", "expec_f", "mkps3d"):
        close(got[k], want[k], 1e-4)
    close(got["mkps2d_f"], want["mkps2d_f"], 1e-5)
    if which:
        # the masked keypoints match nothing; some remain
        vis = got["score_matrix"].max(axis=1) > 0
        assert 0 < vis.sum() and not got["match_mask"][~vis].any()


@pytest.fixture(scope="module")
def train(S):
    key = jax.random.PRNGKey(0)
    m = S.jmodel
    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        lambda p: (lambda o: (o["loss"], o))(m.apply({**S.variables, "params": p}, S.batch,
                                                     key, method=m.train_forward)),
        has_aux=True))(S.variables["params"])
    rng_kp, rng_ray = jax.random.split(key)
    H, W = S.np_batch["image"].shape[:2]
    kp = jax.random.gumbel(rng_kp, (S.model.n_coarse_points(S.tbatch),), dtype=jnp.float32)
    idx = jax.random.choice(rng_ray, H * W, (S.cfg.render.N_rand,), replace=False)
    S.model.zero_grad(set_to_none=True)
    tout = S.model.train_forward(S.tbatch, kp_gumbel=t(np.asarray(kp)), ray_idx=t(np.asarray(idx)))
    tout["loss"].backward()
    got = port_grads(S.model)
    S.model.zero_grad(set_to_none=True)
    return dict(jout={k: np.asarray(v) for k, v in jout.items()},
                tout={k: v.detach().numpy() for k, v in tout.items()},
                got=got, want=grads_in_port_layout(S, jgrads))


@pytest.mark.parametrize("key", ["coarse_loss2", "fine_loss2", "coarse_loss", "loss"])
def test_train_forward_with_the_cascade_matches_jax(train, key):
    print(f"{key}: port {train['tout'][key]!r}, jax {train['jout'][key]!r}")
    close(train["tout"][key], train["jout"][key], LOSS_REL)


def test_cascade_matcher_gradients_match_jax(train):
    errs, total = leaf_errors(train["got"], train["want"])
    second = {n: e for n, e in errs.items() if n.split(".")[0] in SECOND}
    print(f"worst second-matcher leaves (relative error): {worst_leaves(second, total)}")
    assert len(second) > 50
    assert all(bool(torch.isfinite(train["got"][n]).all()) for n in second)
    assert sum(s for _, s in second.values()) > 0
    assert not outside_bound(second, total)


# -- refine_pose through the renderer ---------------------------------------------------

@pytest.fixture(scope="module")
def run(S):
    """The JAX and port refinement of one pose, near the ground truth,
    through the real renderer on the JAX scene context."""
    m = S.jmodel
    b = S.np_batch
    H, W = b["image"].shape[:2]
    jctx = jax.jit(lambda v, bb: m.apply(v, bb, method=m.build_context)[0])(S.variables, S.batch)
    pose0 = np.asarray(jse3.se3_exp_map(jnp.asarray([0.02, -0.01, 0.015, 0.01, -0.015, 0.01],
                                                    jnp.float32))) @ b["pose"]
    pose0 = pose0.astype(np.float32)
    uv = np.asarray(j_sample_pixels(jax.random.PRNGKey(3), H, W, REFINE_RAYS))
    img = jnp.asarray(b["image"])
    ui, vi = uv[:, 0].astype(np.int32), uv[:, 1].astype(np.int32)
    target = img[vi, ui]

    def j_loss(twist, ctx):
        # refine_pose's loss_fn, with the eval step's render_fn
        pose = jse3.se3_exp_map(twist)
        ro, rd = jcam.rays_for_pixels(jnp.asarray(uv), S.batch["K"], pose)
        out = m.apply(S.variables, method=lambda mm: mm.model_3d.render_rays(
            ctx, ro, rd, pose, False))
        msk = out["mask"].astype(jnp.float32)[:, None]
        n_valid = jnp.sum(msk)
        return jnp.sum(((out["rgb"] - target) * msk) ** 2) / jnp.maximum(n_valid, 1.0), n_valid
    vg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))

    # refine_pose's scan body, one compiled loss and gradient per step
    twist0 = jse3.se3_log_map(jnp.asarray(pose0))
    opt = optax.adam(LR, b1=0.9, b2=0.999)
    twist, state = twist0, opt.init(twist0)
    jlosses, jgrads = [], []
    for _ in range(STEPS):
        (loss, _), g = vg(twist, jctx)
        upd, state = opt.update(g, state, twist)
        new = optax.apply_updates(twist, upd)
        twist = jnp.where(jnp.isfinite(loss) & jnp.all(jnp.isfinite(new)), new, twist)
        jlosses.append(float(loss))
        jgrads.append(np.asarray(g))
    (loss0, n0), _ = vg(twist0, jctx)
    (loss_f, n_f), _ = vg(twist, jctx)
    pose_f = jse3.se3_exp_map(twist)
    accept = bool((loss_f <= loss0) & (n_f >= 0.5 * n0) & jnp.all(jnp.isfinite(pose_f)))
    jpose = np.asarray(pose_f) if accept else pose0

    ctx = port_context(S.model, jctx)

    def render_fn(rays_o, rays_d, p):
        return S.model.model_3d.render_rays(ctx, rays_o, rays_d, p, train=False)
    x = tse3.se3_log_map(t(pose0)).requires_grad_(True)
    pose = tse3.se3_exp_map(x)
    out = render_fn(*tcam.rays_for_pixels(t(uv), t(b["K"]), pose), pose)
    msk = out["mask"].float()[:, None]
    tloss0 = torch.sum(((out["rgb"] - t(np.asarray(target))) * msk) ** 2) / msk.sum().clamp(min=1)
    tgrad0 = torch.autograd.grad(tloss0, x)[0]
    trace = []
    tpose = refine_pose(render_fn, t(pose0), t(b["K"]), t(b["image"]), t(uv),
                        max_steps=STEPS, lr=LR, trace=trace)
    return dict(jlosses=np.array(jlosses), jgrad0=jgrads[0], n0=float(n0), accept=accept,
                jpose=jpose, pose0=pose0, tlosses=torch.stack(trace).numpy(),
                tgrad0=tgrad0.numpy(), tpose=tpose.numpy())


def test_loss_gradient_in_the_twist_matches_jax(run):
    """d loss / d twist at the initial pose: through the ray origins and
    directions, the samples, the packed table sampling's blend weights,
    the fused kernel's xyz and direction inputs, and the blending angles."""
    g, want = run["tgrad0"], run["jgrad0"]
    print(f"d loss/d twist: port {g}, jax {want}; relative error "
          f"{np.linalg.norm(g - want) / np.linalg.norm(want):.3g}")
    assert run["n0"] >= 0.5 * REFINE_RAYS, "too few rays see the scene for a meaningful gradient"
    assert np.linalg.norm(g - want) <= GRAD_REL * np.linalg.norm(want)


def test_refine_pose_follows_the_jax_trajectory(run):
    got, want = run["tlosses"], run["jlosses"]
    d = np.abs(got - want) / want[0]
    print(f"losses: port {got[[0, 1, 10, -1]]}, jax {want[[0, 1, 10, -1]]}; relative to the "
          f"first: worst of the first {EARLY_STEPS} {d[:EARLY_STEPS].max():.3g}, worst "
          f"{d.max():.3g} at step {d.argmax()}, {np.sum(d > 1e-4)} steps above 1e-4")
    assert np.isfinite(want).all() and want[-1] < want[0]
    np.testing.assert_allclose(got[:EARLY_STEPS], want[:EARLY_STEPS], rtol=0,
                               atol=EARLY_LOSS_REL * want[0])
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAJ_LOSS_REL * want[0])
    print(f"refined pose: max |port - jax| {np.abs(run['tpose'] - run['jpose']).max():.3g}, "
          f"moved {np.abs(run['jpose'] - run['pose0']).max():.3g}, accepted {run['accept']}")
    assert run["accept"]
    np.testing.assert_allclose(run["tpose"], run["jpose"], rtol=0, atol=POSE_TOL)


# -- the eval step ------------------------------------------------------------------

@pytest.fixture(scope="module")
def evaluated(S):
    """JAX make_eval_step (one CPU device) and the port's eval step over
    the same two queries with JAX's noise. The key gives the queries 4 and
    6 first-pass matches: with fewer than 3 a RANSAC minimal set takes
    masked points and the solve is ill-posed."""
    items = [device_batch(make_query_batch(n_views=3, H=32, W=32, seed=s)) for s in (0, 1)]
    host = stack_batches(items)
    key = jax.random.PRNGKey(14)
    mesh = make_mesh(MeshSpec(data=1, ray=1))
    with mesh:
        jout = j_make_eval_step(S.jmodel, S.cfg, mesh)(S.variables, shard_batch(host, mesh), key)
    jout = {k: np.asarray(v) for k, v in jout.items()}
    H, W = host["image"].shape[1:3]
    P = S.model.n_coarse_points({k: t(v[0]) for k, v in host.items()})
    n_kp, n_hyps = S.cfg.matching.fine_num_3d_keypoints, S.cfg.shapes.pnp_hypotheses
    noise = {k: [] for k in ("kp_gumbel", "pnp_gumbel", "pnp2_gumbel", "refine_uv")}
    for r in jax.random.split(key, 2):
        r_match, r_pnp, r_pnp2, r_ref = jax.random.split(r, 4)
        noise["kp_gumbel"].append(jax.random.gumbel(r_match, (P,)))
        noise["pnp_gumbel"].append(jax.random.gumbel(r_pnp, (n_hyps, n_kp)))
        noise["pnp2_gumbel"].append(jax.random.gumbel(r_pnp2, (n_hyps, n_kp)))
        noise["refine_uv"].append(j_sample_pixels(r_ref, H, W, S.cfg.shapes.pose_refine_rays,
                                                  None, mode=S.cfg.optimize_pose_sampling))
    noise = {k: t(np.stack([np.asarray(x) for x in v])) for k, v in noise.items()}
    tout = make_eval_step(S.model, S.model.cfg)(to_device_batch(host, CPU), noise=noise)
    return jout, {k: v.numpy() for k, v in tout.items()}


def test_eval_step_outputs_match_jax(evaluated):
    jout, tout = evaluated
    assert sorted(tout) == sorted(jout)
    for k, v in jout.items():
        assert tout[k].shape == v.shape and tout[k].dtype == v.dtype, k
    for k in ("num_inliers", "num_matches", "pnp_success", "matching_iou"):
        assert np.array_equal(tout[k], jout[k]), (k, tout[k], jout[k])
    print(f"eval step: max |port - jax| pose_pred "
          f"{np.abs(tout['pose_pred'] - jout['pose_pred']).max():.3g}, rot_err "
          f"{np.abs(tout['rot_err_deg'] - jout['rot_err_deg']).max():.3g} deg, trans_err "
          f"{np.abs(tout['trans_err_m'] - jout['trans_err_m']).max():.3g} m")
    np.testing.assert_allclose(tout["pose_pred"], jout["pose_pred"], rtol=0, atol=EVAL_POSE_TOL)
    np.testing.assert_allclose(tout["rot_err_deg"], jout["rot_err_deg"], rtol=0,
                               atol=EVAL_ROT_TOL)
    np.testing.assert_allclose(tout["trans_err_m"], jout["trans_err_m"], rtol=0,
                               atol=EVAL_TRANS_TOL)


def test_eval_step_draws_its_own_noise(S):
    """Without noise the step draws from its generator: same seed, same
    poses; without the cascade and refinement it is the localization."""
    cfg = dataclasses.replace(S.model.cfg, optimize_pose=False)
    model = NerfPoseEstimator(cfg, device="cpu")
    model.load_state_dict(S.model.state_dict())
    batch = {k: v[None] for k, v in S.tbatch.items()}
    step = make_eval_step(model, cfg)
    outs = [step(batch, generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert torch.equal(outs[0]["pose_pred"], outs[1]["pose_pred"])
    with pytest.raises(ValueError, match="unknown noise"):
        step(batch, noise={"kp": torch.zeros(1)})


# -- the harness ----------------------------------------------------------------------

class Items:
    """A sequence of synthetic query items over two scenes."""

    def __init__(self, seeds):
        self.items = []
        for i, s in enumerate(seeds):
            it = make_query_batch(n_views=3, H=32, W=32, seed=s)
            it.update(scene=f"scene{i % 2}", scale_factor=np.float32(1.0 + i),
                      filename=f"q{i}")
            self.items.append(it)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_eval_dataset_pads_the_last_batch(S):
    """Five items in batches of two: the last batch repeats its item, and
    only the real outputs reach the table. A stand-in step returns each
    query's own numbers, so the table is known: rot = pose[0, 3] + 3,
    trans = 2 scale_factor (divided back by the scale factor to 2)."""
    ds = Items(range(5))
    calls = []

    def step(batch, generator=None):
        calls.append(batch["image"].shape[0])
        B = batch["image"].shape[0]
        return {"rot_err_deg": batch["pose"][:, 0, 3] + 3.0,
                "trans_err_m": 2.0 * batch["scale_factor"],
                "matching_iou": torch.full((B,), 0.25), "pose_pred": batch["pose"]}
    res = eval_dataset(ds, step, 2, {0: "scene0", 1: "scene1"}, S.model.cfg, device="cpu",
                       collect_poses=True)
    assert calls == [2, 2, 2]
    rot = np.array([it["pose"][0, 3] + 3.0 for it in ds.items], np.float32)
    for sid in (0, 1):
        sel = [i for i in range(5) if i % 2 == sid]
        row = res[f"scene{sid}"]
        assert row["n"] == len(sel)
        assert row["median_rot_err_deg"] == pytest.approx(float(np.median(rot[sel])))
        assert row["median_trans_err_m"] == pytest.approx(2.0)
        assert row["matching_iou"] == pytest.approx(0.25)
    assert res["avg"]["n"] == 5 and res["avg"]["files"] == 5
    assert res["_poses"]["filenames"] == [f"q{i}" for i in range(5)]
    np.testing.assert_array_equal(res["_poses"]["poses_pred"], res["_poses"]["poses_gt"])
    assert set(DEFAULT_METRIC_MODES) - {"psnr_test"} <= set(res["avg"])


def test_eval_dataset_runs_the_eval_step(S):
    """The port's eval step (cascade on, refinement off) over two items of
    two scenes: a finite table, pose_acc in [0, 1]."""
    cfg = dataclasses.replace(S.model.cfg, optimize_pose=False)
    model = NerfPoseEstimator(cfg, device="cpu")
    model.load_state_dict(S.model.state_dict())
    res = eval_dataset(Items((0, 1)), make_eval_step(model, cfg), 2,
                       {0: "scene0", 1: "scene1"}, cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    assert sorted(res) == ["avg", "scene0", "scene1"]
    for row in res.values():
        assert all(np.isfinite(v) for v in row.values())
        assert 0.0 <= row["pose_acc"] <= 1.0
    assert res["avg"]["n"] == 2


def test_render_psnr_eval(S):
    res = render_psnr_eval(make_render_psnr_fn(S.model), Items((0, 1, 2)), max_views=1)
    assert res["n_rendered"] == 1 and np.isfinite(res["psnr_test"])
    assert render_psnr_eval(None, Items(()), max_views=2) == {"n_rendered": 0}
    assert DEFAULT_METRIC_MODES["psnr_test"] == "max"
