"""The train step at the bf16 compute dtype: the PyTorch port at
dtype=torch.bfloat16 against the JAX package at dtype=jnp.bfloat16, on the
CPU, at `__graft_entry__._tiny_cfg()` with render.fused_query_agg=True.

JAX runs under jax.jit (its fused kernel in Pallas interpret mode), one
compiled value_and_grad of train_forward per dtype with the batch as a
constant (as tests/test_torch_train.py compiles it). Both sides get the same weights, batch
and noise (the keypoint Gumbel noise drawn at bf16 as JAX's bf16 model
draws it, the rendered pixels).

Each value is held with the yardstick of tests/test_torch_bf16.py:
rms(port16 - jax16) <= c rms(jax16 - jax32) with c = 1, and
rms(port16 - port32) >= 0.5 rms(jax16 - jax32). Two things need more than
that, both measured here:
- The decoded NeuRay depth clip(-1 / d_inv, near, far) jumps from far to
  near where d_inv crosses 0, and a decoded mean one bf16 step either side
  of that point moves ref_depth_loss by ~1/#pixels. The port's bf16 scene
  context differs from JAX's by about half of JAX's own bf16-vs-f32
  distance (tests/test_torch_bf16.py), enough to move a pixel across. The
  test shows that the pixels whose decoded depth differs sit within two
  bf16 steps of the jump on JAX's side, and holds the loss over the other
  pixels to the yardstick.
- The gradient leaves of the support-image path (the RGB FiLM layer, the
  backbone's first convolution, DepthFusionNet) are chaotic in JAX's bf16:
  a 2^-22 relative change of the weights moves JAX's bf16 gradient there
  by 0.9-1.2 of its bf16-vs-f32 distance (the port's by 0.2-0.5). One JAX
  sample is then a noisy reference, so each leaf's distance from JAX is
  held after removing, in quadrature, both packages' own spread under that
  weight change: rms(port16 - jax16)^2 <= c^2 rms(jax16 - jax32)^2
  + spread_jax^2 + spread_port^2, c = 1; and its distance from f32 against
  JAX's with JAX's spread removed: rms(port16 - port32)^2
  >= 0.25 (rms(jax16 - jax32)^2 - spread_jax^2), besides the yardstick's
  0.5 over all leaves together.

`-s` prints every ratio. To see where XLA rounds, dump
jax.jit(jax.grad(f)).lower(...).compile().as_text() and read the convert
pairs; nerfloc_tpu_torch/models/lowp.py mirrors what those show.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloc_tpu.models import matching as jmatching
from nerfloc_tpu.train.state import make_optimizer as j_make_optimizer
from nerfloc_tpu_torch.data import device_batch, make_query_batch, stack_batches
from nerfloc_tpu_torch.models import matching as tmatching
from nerfloc_tpu_torch.models.lowp import xla_cpu_sum
from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
from nerfloc_tpu_torch.ops.interp import nearest_indices
from nerfloc_tpu_torch.train import checkpoint as ckpt
from nerfloc_tpu_torch.train.state import TrainState
from nerfloc_tpu_torch.train.step import make_train_step

from _torch_parity import CPU, few_threads, t, to_numpy  # noqa: F401
from test_torch_bf16 import BF, JBF, Bf16Setup, f64, rms, yardstick
from test_torch_train import grads_in_port_layout, port_grads

TERMS = ("loss", "coarse_loss", "fine_loss", "render_loss", "fine_err", "psnr")
DISCRETE = ("match_j", "match_mask", "j_gt", "gt_mask")
PERTURB = 2.0 ** -22


def jax_noise(S, key, dt):
    """(kp_gumbel, ray_idx) of JAX train_forward under `key` at compute
    dtype dt (the keypoint Gumbel noise is drawn in it)."""
    rng_kp, rng_ray = jax.random.split(key)
    H, W = S.np_batch["image"].shape[:2]
    P = S.pm[32].n_coarse_points(S.tbatch)
    kp = jax.random.gumbel(rng_kp, (P,), dtype=dt).astype(jnp.float32)
    idx = jax.random.choice(rng_ray, H * W, (S.cfg.render.N_rand,), replace=False)
    return t(np.asarray(kp)), t(np.asarray(idx))


def port_run(model, batch, kp, idx):
    model.zero_grad(set_to_none=True)
    out = model.train_forward(batch, kp_gumbel=kp, ray_idx=idx)
    out["loss"].backward()
    grads = port_grads(model)
    model.zero_grad(set_to_none=True)
    return {k: v.detach() for k, v in out.items()}, grads


def perturbed(model):
    m = copy.deepcopy(model)
    with torch.no_grad():
        for p in m.parameters():
            p.mul_(1 + PERTURB)
    return m


@pytest.fixture(scope="module")
def R():
    S = Bf16Setup()
    S.np_vars = to_numpy(S.variables)
    key = jax.random.PRNGKey(0)

    def loss(m):
        def f(p, v, b):
            out = m.apply({**v, "params": p}, b, key, method=m.train_forward)
            return out["loss"], out
        return f

    def leaves(g):
        return {n: v.numpy() for n, v in grads_in_port_layout(S, g).items()}

    # the batch and variables as constants of the compiled function, as
    # tests/test_torch_train.py compiles it; the bf16 one also at weights
    # scaled by 1 + PERTURB
    J = {}
    bumped = jax.tree.map(lambda a: a * (1 + PERTURB), S.variables["params"])
    for d, runs in ((32, (("32", S.variables["params"]),)),
                    (16, (("16", S.variables["params"]), ("16+", bumped)))):
        f = loss(S.jm[d])
        vg = jax.jit(jax.value_and_grad(lambda p: f(p, S.variables, S.batch), has_aux=True))
        for name, p in runs:
            (_, out), g = vg(p)
            J[name] = ({k: np.asarray(v.astype(jnp.float32)) for k, v in out.items()},
                       leaves(g))
    noise = {d: jax_noise(S, key, dt) for d, dt in ((16, JBF), (32, jnp.float32))}
    P = {str(d): port_run(m, S.tbatch, *noise[d]) for d, m in S.pm.items()}
    P["16+"] = port_run(perturbed(S.pm[16]), S.tbatch, *noise[16])

    # the decoded support depths of each bf16 context
    def jdepths(v, b):
        m = S.jm[16]
        ctx, _ = m.apply(v, b, method=m.build_context)
        mean = m.apply(v, ctx.sv.vis_featmaps, method=lambda mm, f: mm.model_3d
                       .multiview_aggregator.dist_decoder.predict_mean(f))
        depths = m.apply(v, ctx.sv, method=lambda mm, sv: mm.model_3d
                         .multiview_aggregator.predict_ref_depths(sv))
        return ctx.sv.near, ctx.sv.far, mean[..., 0], depths
    jd = jax.jit(jdepths)(S.variables, S.batch)
    with torch.no_grad():
        ctx, _ = S.pm[16].build_context(S.tbatch)
        agg = S.pm[16].model_3d.multiview_aggregator
        tmean = agg.dist_decoder.predict_mean(ctx.sv.vis_featmaps)[..., 0]
        td = agg.predict_ref_depths(ctx.sv)
        ctx32, _ = S.pm[32].build_context(S.tbatch)
        td32 = S.pm[32].model_3d.multiview_aggregator.predict_ref_depths(ctx32.sv)
    total32 = np.sqrt(sum(np.sum(np.square(v, dtype=np.float64)) for v in J["32"][1].values()))
    return dict(S=S, J=J, P=P, noise=noise, key=key, total32=total32,
                jdepths=[np.asarray(a, np.float64) for a in jd], tdepths=f64(td),
                tdepths32=f64(td32),
                tmean=f64(tmean))


# -- the pieces ------------------------------------------------------------------------

def test_focal_loss_and_its_gradient_equal_jax_at_bf16():
    """coarse_loss on bf16 logits and targets: forward and the mirrored
    backward (matching._FocalMeanLowp) bit-equal to jitted JAX."""
    r = np.random.default_rng(0)
    logits = (r.standard_normal((40, 70)) * 4).astype(np.float32)
    gt = np.zeros((40, 70), np.float32)
    gt[np.arange(40), r.integers(0, 70, 40)] = r.uniform(size=40) < 0.6

    def f(lg, g):
        return jmatching.coarse_loss(lg, g).astype(jnp.float32) * 1e4
    jv, jg = jax.jit(jax.value_and_grad(f))(jnp.asarray(logits, JBF), jnp.asarray(gt, JBF))
    x = t(logits).to(BF).requires_grad_(True)
    v = tmatching.coarse_loss(x, t(gt).to(BF)).float() * 1e4
    v.backward()
    assert float(v) == float(jv)
    assert torch.equal(x.grad.float(), t(np.asarray(jg.astype(jnp.float32))))


@pytest.mark.parametrize("shape,dims", [((300, 4), (0,)), ((301, 5), (0,)), ((16, 16, 3), (0, 1)),
                                        ((7, 33, 9, 4), (0, 1, 2)), ((4, 300), (1,)),
                                        ((50, 70), (0, 1))])
def test_bf16_reduction_follows_xla(shape, dims):
    """The bf16 sum of a transposed broadcast (a bias, normalization
    statistics) bit-equal to jitted jnp.sum(..., dtype=bf16): XLA's CPU
    backend sums in bf16 in windows of 32."""
    a = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    want = jax.jit(lambda v: jnp.sum(v, axis=dims, dtype=JBF))(jnp.asarray(a, JBF))
    got = xla_cpu_sum(t(a).to(BF), list(dims))
    assert torch.equal(got.float(), t(np.asarray(want.astype(jnp.float32))))


def test_decoded_depth_at_bf16_matches_jax_with_finite_gradients():
    """decode_ref_depths on bf16 means around d_inv == 0 (f32 near and far,
    as the scene context holds them): values equal JAX's, gradients
    finite."""
    from nerfloc_tpu.models.fields.neuray import decode_ref_depths as j_decode
    from nerfloc_tpu_torch.models.fields.neuray import decode_ref_depths as t_decode
    near, far = np.float32(0.5), np.float32(2.0 * 2.0 * np.sqrt(3.0))
    c = np.float32(-1.0 / far) - np.float32(-1.0 / near)
    x0 = float(np.float32(1.0 / near) / c)
    grid = np.asarray(jnp.asarray(np.linspace(x0 - 0.05, x0 + 0.05, 41), JBF)
                      .astype(jnp.float32))
    mean = np.stack([np.concatenate([grid, [0.0, 0.3, 1.0, 3.0]])] * 2, -1).astype(np.float32)
    jm = jnp.asarray(mean, JBF)
    jval = jax.jit(lambda m: j_decode(m, near, far))(jm)
    x = t(mean).to(BF).requires_grad_(True)
    got = t_decode(x, torch.tensor(near), torch.tensor(far))
    got.sum().backward()
    assert got.dtype == torch.float32
    assert np.array_equal(got.detach().numpy(), np.asarray(jval))
    assert bool(torch.isfinite(x.grad.float()).all())
    assert (np.abs(mean[:, 0] - x0) < 0.01).sum() >= 2


# -- train_forward -----------------------------------------------------------------------

@pytest.mark.parametrize("key", TERMS)
def test_train_forward_terms_bf16(R, key):
    """Each term and the total at bf16, c = 1 (coarse_loss is bf16 on both
    sides, the rest f32; the total starts from an f32 zero and adds each
    term with its weight rounded to the term's dtype)."""
    J, P = R["J"], R["P"]
    assert str(P["16"][0][key].dtype).split(".")[-1] == \
        ("bfloat16" if key == "coarse_loss" else "float32")
    yardstick(key, P["16"][0][key], J["16"][0][key], J["32"][0][key], P["32"][0][key], 1.0)


@pytest.mark.parametrize("key", DISCRETE)
def test_train_forward_discrete_outputs_bf16(R, key):
    assert np.array_equal(R["P"]["16"][0][key].numpy(), R["J"]["16"][0][key])


def test_ref_depth_loss_bf16(R):
    """The decoded depths jump (by more than a quarter of far - near)
    exactly where the two packages' decoded means lie on either side of the
    jump at d_inv == 0, and the means there differ by no more than they do
    elsewhere; ref_depth_loss over the other pixels is within c = 1 of
    JAX's bf16-vs-f32 distance there."""
    S = R["S"]
    near, far, jmean, jd = R["jdepths"]
    td, tmean = R["tdepths"], R["tmean"]
    c = (-1.0 / far) - (-1.0 / near)
    x0 = (1.0 / near) / c
    moved = np.abs(td - jd) > 0.25 * (far - near)
    straddle = (jmean > x0) != (tmean > x0)
    diff = np.abs(tmean - jmean)
    print(f"ref depths: {moved.sum()} of {moved.size} pixels jump; decoded means there: JAX "
          f"{jmean[moved]}, port {tmean[moved]} (jump at {x0:.5f}); largest mean difference "
          f"{diff.max():.4g}, elsewhere {diff[~moved].max():.4g}")
    assert np.array_equal(moved, straddle)
    assert moved.sum() <= 0.05 * moved.size
    assert not moved.any() or diff[moved].max() <= diff[~moved].max()

    def loss(pred, gt_n, mask):
        pd_n = np.clip(((-1.0 / np.maximum(pred, 1e-5)) + 1.0 / near) / c, 0.0, 1.0)
        return np.sum((gt_n - pd_n) ** 2 * mask) / max(np.sum(mask), 1.0)
    V, h, w = jd.shape
    depths = S.np_batch["topk_depths"]
    gt = depths[:, nearest_indices(depths.shape[1], h, CPU).numpy()][
        :, :, nearest_indices(depths.shape[2], w, CPU).numpy()].astype(np.float64)
    gt_n = np.clip(((-1.0 / np.maximum(gt, 1e-5)) + 1.0 / near) / c, 0.0, 1.0)
    all_jax = loss(jd, gt_n, gt > 0)
    assert abs(all_jax - float(R["J"]["16"][0]["ref_depth_loss"])) <= 1e-5 * all_jax
    keep = (gt > 0) & ~moved
    got, want = loss(td, gt_n, keep), loss(jd, gt_n, keep)
    print(f"ref_depth_loss over the {keep.sum()} other pixels: port {got:.6g}, jax {want:.6g}; "
          f"with every pixel: port {float(R['P']['16'][0]['ref_depth_loss']):.6g}, jax "
          f"{float(R['J']['16'][0]['ref_depth_loss']):.6g}, jax f32 "
          f"{float(R['J']['32'][0]['ref_depth_loss']):.6g}")
    # the f32 reference on those pixels: the port's f32 depths, which equal
    # JAX's within 1e-4 (tests/test_torch_train.py)
    ref = abs(want - loss(R["tdepths32"], gt_n, keep))
    print(f"  f32 over them {loss(R['tdepths32'], gt_n, keep):.6g}: ratio {abs(got - want) / ref:.3f}")
    assert abs(got - want) <= ref


def test_parameter_gradients_bf16(R):
    """Every parameter-gradient leaf at bf16 against jax.grad of the bf16
    model (bounds in the module docstring); the gradients of the f32
    parameters are f32 and finite."""
    J, P = R["J"], R["P"]
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in P["16"][1].values())
    rows, far16, far32 = [], 0.0, 0.0
    for n, w16 in J["16"][1].items():
        j16, j32 = np.asarray(w16, np.float64), np.asarray(J["32"][1][n], np.float64)
        jp = np.asarray(J["16+"][1][n], np.float64)
        p16, p32, pp = (f64(P[k][1][n]) for k in ("16", "32", "16+"))
        ref, sj, sp = rms(j16 - j32), rms(j16 - jp), rms(p16 - pp)
        close, real = rms(p16 - j16), rms(p16 - p32)
        far16 += np.sum((p16 - p32) ** 2)
        far32 += np.sum((j16 - j32) ** 2)
        bound = np.sqrt(ref ** 2 + sj ** 2 + sp ** 2)
        # a leaf whose gradient is zero in exact arithmetic (a bias before
        # a normalization or a softmax) is rounding noise at either dtype
        zero = np.sqrt(np.sum(j32 ** 2)) <= 1e-6 * R["total32"]
        rows.append((close / bound if bound else 0.0, n, close / ref if ref else 0.0,
                     real / ref if ref else 1.0, sj / ref if ref else 0.0,
                     sp / ref if ref else 0.0,
                     zero or real ** 2 >= 0.25 * (ref ** 2 - sj ** 2)))
    rows.sort(reverse=True)
    print(f"{len(rows)} leaves; worst (close / noise-aware bound, close / ref, real / ref, "
          f"JAX spread / ref, port spread / ref): " + "; ".join(
              f"{r[1]} {r[0]:.3f} {r[2]:.3f} {r[3]:.3f} {r[4]:.3f} {r[5]:.3f}" for r in rows[:8]))
    over = [r for r in rows if r[2] > 1]
    near32 = [r for r in rows if r[3] < 0.5]
    print(f"over c = 1 against rms(jax16 - jax32) alone: {len(over)} (" + ", ".join(
        f"{r[1]} {r[2]:.3f}" for r in over) + f"); real < 0.5 alone: {len(near32)} (from "
        f"{min((r[3] for r in near32), default=0):.3f}); all leaves together: real "
        f"{np.sqrt(far16 / far32):.3f}")
    assert [r[1] for r in rows if r[0] > 1.0] == []
    assert [r[1] for r in rows if not r[6]] == []
    assert np.sqrt(far16 / far32) >= 0.5


# -- the train step, optimizer, checkpoints ---------------------------------------------

def _twice(batch):
    return {k: torch.stack([v, v]) for k, v in batch.items()}


def _step(model, batch, kp, idx):
    state = TrainState(model, model.cfg)
    before = torch.cat([p.detach().reshape(-1).clone() for p in state.params])
    metrics = make_train_step(model, model.cfg)(state, _twice(batch), kp_gumbel=torch.stack([kp, kp]),
                                                ray_idx=torch.stack([idx, idx]))
    assert state.step == 1
    return torch.cat([p.detach().reshape(-1) for p in state.params]) - before, metrics


def test_train_step_bf16_update_matches_optax(R):
    """One make_train_step at bf16 over B=2 (the query twice, with JAX's
    noise): each query's loss / B backward in turn, then the update. The
    update against optax's (zero_nonfinite, clip 1.0, Adam, the schedule)
    on JAX's bf16 gradient, over all parameters, and the metrics against
    JAX's (the yardstick, c = 1; f32 references from f32)."""
    S, J = R["S"], R["J"]
    got, metrics = _step(copy.deepcopy(S.pm[16]), S.tbatch, *R["noise"][16])
    p32, m32 = _step(copy.deepcopy(S.pm[32]), S.tbatch, *R["noise"][32])
    tx = j_make_optimizer(S.cfg)
    names = [n for n, _ in S.pm[16].named_parameters()]

    def optax_update(grads):
        g = {n: jnp.asarray(grads[n]) for n in names}
        upd, _ = tx.update(g, tx.init(g), g)
        return np.concatenate([np.asarray(upd[n]).reshape(-1) for n in names])
    yardstick("update", got, optax_update(J["16"][1]), optax_update(J["32"][1]), p32, 1.0)
    for k in ("loss", "coarse_loss", "render_loss"):
        yardstick(f"step {k}", metrics[k], J["16"][0][k], J["32"][0][k], m32[k], 1.0)
    assert bool(torch.isfinite(metrics["grad_norm"]))


@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def _steps(state, n):
    step = make_train_step(state.model, state.model.cfg)
    batch = to_device_batch(stack_batches([device_batch(make_query_batch(
        n_views=3, H=32, W=32, seed=0))]), CPU)
    P = state.model.n_coarse_points({k: v[0] for k, v in batch.items()})
    for _ in range(n):
        g = torch.Generator().manual_seed(state.step)
        step(state, batch, kp_gumbel=torch.randn(1, P, generator=g),
             ray_idx=torch.randperm(32 * 32, generator=g)[None, :32])
    return state


def test_resume_bf16_equals_an_uninterrupted_run(R, tmp_path, deterministic):
    S = R["S"]
    m = S.pm[16]
    straight = _steps(TrainState(copy.deepcopy(m), m.cfg), 3)
    mgr = ckpt.CheckpointManager(str(tmp_path / "ckpts"), max_to_keep=2)
    first = _steps(TrainState(copy.deepcopy(m), m.cfg), 1)
    mgr.save(first.step, first)
    fresh = NerfPoseEstimator(m.cfg, device="cpu", seed=7, dtype=BF)
    resumed = TrainState(fresh, fresh.cfg)
    resumed.load_state_dict(mgr.restore())
    _steps(resumed, 2)
    for (n, a), b in zip(straight.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), n
    for k in ("mu", "nu"):
        assert torch.equal(straight.opt_state[k], resumed.opt_state[k])
    assert resumed.step == 3 and all(v.dtype == torch.float32 for v in resumed.opt_state.values())


@pytest.mark.parametrize("src,dst", [(32, 16), (16, 32)])
def test_checkpoint_restores_across_compute_dtypes(R, tmp_path, src, dst):
    """The parameter tree does not depend on the compute dtype: a
    checkpoint of one restores into a model of the other, and the restored
    model computes what a model of that dtype with those weights computes."""
    S = R["S"]
    state = _steps(TrainState(copy.deepcopy(S.pm[src]), S.pm[src].cfg), 1)
    mgr = ckpt.CheckpointManager(str(tmp_path / "c"), max_to_keep=1)
    mgr.save(state.step, state)
    dt = BF if dst == 16 else torch.float32
    target = NerfPoseEstimator(S.pm[dst].cfg, device="cpu", seed=9, dtype=dt)
    restored = TrainState(target, target.cfg)
    restored.load_state_dict(mgr.restore())
    assert target.dtype == dt and restored.step == 1
    for (n, a), b in zip(state.model.state_dict().items(), target.state_dict().values()):
        assert torch.equal(a, b), n
    kp, idx = R["noise"][dst]
    twin = copy.deepcopy(S.pm[dst])
    twin.load_state_dict(state.model.state_dict())
    with torch.no_grad():
        a = target.train_forward(S.tbatch, kp_gumbel=kp, ray_idx=idx)["loss"]
        b = twin.train_forward(S.tbatch, kp_gumbel=kp, ray_idx=idx)["loss"]
    assert torch.equal(a, b) and bool(torch.isfinite(a))
