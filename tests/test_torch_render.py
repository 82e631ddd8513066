"""The render slice on the CPU: the PyTorch port's render path against the
JAX package at `__graft_entry__._tiny_cfg()` with render.fused_query_agg
=True (V=3 at 32x32; JAX's fused Pallas kernel runs in interpret mode).

Module tests feed the same seeded numpy inputs to both packages. The slice
tests render the same rays against the same scene context: JAX builds it,
and its fields cross over as numpy arrays, from which the port builds its
own tables (so the render path alone is compared). Dense sampling is S=8;
guided is 4+4 with N_guide 8, so one JAX init serves both (RayUnet's
shapes depend on S only). Bounds, all f32: 1e-4 of the output's scale
unless a test states a tighter one; neighbour indices and masks exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloc_tpu.geometry import cameras as jcam
from nerfloc_tpu.models.fields import neuray as jneuray
from nerfloc_tpu.models.fields import projector as jproj
from nerfloc_tpu.models.fields.conditional_nerf import sample_pdf_det as j_sample_pdf
from nerfloc_tpu.models.fields.ray_unet import ConvBlock as JConvBlock
from nerfloc_tpu.models.pose_estimator import NerfPoseEstimator as JaxEstimator
from nerfloc_tpu.ops import interp as jinterp
from nerfloc_tpu.ops.knn import _proj_window as j_proj_window
from nerfloc_tpu.ops.knn import knn_proj as j_knn_proj
from nerfloc_tpu.ops.knn import pack_xyz_window as j_pack_xyz_window
from nerfloc_tpu_torch.geometry import cameras as tcam
from nerfloc_tpu_torch.models.fields import neuray as tneuray
from nerfloc_tpu_torch.models.fields import projector as tproj
from nerfloc_tpu_torch.models.fields.aggregator import SupportViews as TSupport
from nerfloc_tpu_torch.models.fields.conditional_nerf import sample_pdf_det as t_sample_pdf
from nerfloc_tpu_torch.models.fields.context import NeuralPoints as TPoints
from nerfloc_tpu_torch.models.fields.ray_unet import ConvBlock as TConvBlock
from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator
from nerfloc_tpu_torch.ops import interp as tinterp
from nerfloc_tpu_torch.ops import knn as tknn
from nerfloc_tpu_torch.weights import load_flax_variables

from _torch_parity import TinySetup, port_cfg, t

N_RAYS = 24


def close(got, want, rel=1e-4):
    """|got - want| <= rel * max(1, max|want|) elementwise."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def rng(seed):
    return np.random.default_rng(seed)


def guided(cfg):
    return dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, N_samples=4, N_importance=4, N_guide=8))


class RenderSetup:
    """TinySetup plus a guided-sampling model pair, seeded rays of the
    query view, and each JAX model's scene context."""

    def __init__(self):
        self.base = S = TinySetup()
        self.models = {"dense": (S.jmodel, S.model)}
        jg = JaxEstimator(guided(S.cfg))
        tg = NerfPoseEstimator(port_cfg(guided(S.cfg)), device="cpu", seed=2)
        assert load_flax_variables(tg, S.np_vars) == []
        self.models["guided"] = (jg, tg)
        b = S.np_batch
        H, W = b["image"].shape[:2]
        uv = np.stack([rng(30).uniform(0, W - 1, N_RAYS),
                       rng(31).uniform(0, H - 1, N_RAYS)], -1).astype(np.float32)
        ro, rd = jcam.rays_for_pixels(jnp.asarray(uv), S.batch["K"], S.batch["pose"])
        self.uv, self.rays = uv, (np.asarray(ro), np.asarray(rd))
        self.jctx = {k: jax.jit(lambda v, bb, m=m: m.apply(v, bb, method=m.build_context)[0])(
            S.variables, S.batch) for k, (m, _) in self.models.items()}

    def port_ctx(self, kind):
        """The port's scene context from the JAX context's fields."""
        jc = self.jctx[kind]
        sv = TSupport(**{k: t(getattr(jc.sv, k)) for k in TSupport._fields})

        def points(p):
            return TPoints(**{f.name: None if getattr(p, f.name) is None
                              else t(getattr(p, f.name))
                              for f in dataclasses.fields(TPoints)})
        return self.models[kind][1].model_3d.assemble_context(
            sv, points(jc.coarse), points(jc.fine), t(jc.feat_coarse_src),
            t(jc.feat_fine_src))

    def jax_render(self, kind, train, rays):
        m = self.models[kind][0]

        @jax.jit
        def run(v, ctx, ro, rd, pose):
            return m.apply(v, method=lambda mm: mm.model_3d.render_rays(
                ctx, ro, rd, pose, train))
        out = run(self.base.variables, self.jctx[kind], *map(jnp.asarray, rays),
                  self.base.batch["pose"])
        return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def R():
    return RenderSetup()


# -- modules -----------------------------------------------------------------

def test_rays_for_pixels_matches_jax():
    r = rng(1)
    uv = r.uniform(-5, 40, (50, 2)).astype(np.float32)
    K = np.array([[30.0, 0, 15.5], [0, 28.0, 16.5], [0, 0, 1]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.linalg.qr(r.standard_normal((3, 3)))[0]
    pose[:3, 3] = r.standard_normal(3)
    for g, w in zip(tcam.rays_for_pixels(t(uv), t(K), t(pose)),
                    jcam.rays_for_pixels(*map(jnp.asarray, (uv, K, pose)))):
        close(g, w, rel=1e-6)


def test_compute_angle_matches_jax(R):
    """The normalized difference of two nearly equal unit vectors turns
    last-bit differences into 1e-5: default bound."""
    b = R.base.np_batch
    xyz = (b["pose"][:3, 3] + rng(2).uniform(-2, 2, (40, 3))).astype(np.float32)
    got = tproj.compute_angle(t(xyz), t(b["pose"]), t(b["topk_poses"]))
    want = jproj.compute_angle(*map(jnp.asarray, (xyz, b["pose"], b["topk_poses"])))
    assert got.shape == (b["topk_poses"].shape[0], 40, 4)
    close(got, want)


def test_depth2inv_dists_matches_jax():
    z = np.sort(rng(3).uniform(0.5, 6.0, (7, 9)), axis=1).astype(np.float32)
    near, far = np.float32(0.3), np.float32(8.0)
    got = tneuray.depth2inv_dists(t(z), t(near), t(far))
    close(got, jneuray.depth2inv_dists(*map(jnp.asarray, (z, near, far))), rel=1e-7)
    assert float(got[0, -1]) == 1e6


def test_compute_alpha_prob_matches_jax():
    r = rng(4)
    V, rn, dn = 3, 5, 6
    depth = r.uniform(-0.5, 6.0, (V, rn, dn)).astype(np.float32)
    interval = np.broadcast_to(r.uniform(0.01, 0.1, (rn, dn)), (V, rn, dn)).astype(np.float32)
    mean = r.uniform(0, 1, (V, rn, dn, 2)).astype(np.float32)
    var = r.uniform(0.05, 3, (V, rn, dn, 2)).astype(np.float32)
    vis = r.uniform(0, 1, (V, rn, dn, 1)).astype(np.float32)
    aw = r.uniform(0, 1, (V, rn, dn, 1)).astype(np.float32)
    args = (depth, interval, mean, var, vis, aw, np.float32(0.3), np.float32(8.0))
    got = tneuray.compute_alpha_prob(*map(t, args))
    want = jneuray.compute_alpha_prob(*map(jnp.asarray, args))
    # the hit probability is a difference of two CDFs; where it is ~1e-5
    # its log (the alpha logit) magnifies last-bit differences, so the logit
    # is held as the alpha it stands for
    close(torch.sigmoid(got[0]), jax.nn.sigmoid(want[0]), rel=1e-5)
    for g, w in zip(got[1:], want[1:]):
        close(g, w, rel=1e-5)


def test_pack_window_matches_jax():
    feats = rng(5).standard_normal((2, 6, 7, 3)).astype(np.float32)
    offs = j_proj_window(5)
    assert tknn.proj_window(5) == offs
    close(tinterp.pack_window(t(feats), offs), jinterp.pack_window(jnp.asarray(feats), offs),
          rel=0)


@pytest.mark.parametrize("win", [3, 5])
def test_pack_xyz_window_matches_jax(win):
    """The JAX table's bf16 hi+mid+lo parts sum to the port's f32 xyz
    exactly; the validity channel is the same bit."""
    r = rng(6)
    xyz = (r.standard_normal((2, 8, 9, 3)) * 3).astype(np.float32)
    mask = r.uniform(size=(2, 8, 9)) > 0.3
    want = np.asarray(j_pack_xyz_window(jnp.asarray(xyz), jnp.asarray(mask), win=win),
                      np.float32).reshape(2 * 8 * 9, win * win, 10)
    got = tknn.pack_xyz_window(t(xyz), t(mask), win=win).reshape(-1, win * win, 4).numpy()
    want_xyz = (want[..., 0:3] + want[..., 3:6]) + want[..., 6:9]
    assert np.array_equal(got[..., :3], want_xyz)
    assert np.array_equal(got[..., 3], want[..., 9])


@pytest.mark.parametrize("win", [3, 5])
def test_knn_proj_indices_equal_jax(R, win):
    """Samples along the test rays against the JAX context's fine points:
    the same 8 neighbours in the same order (stable re-rank)."""
    jc = R.jctx["dense"]
    V, hf, wf = jc.feat_fine_src.shape[:3]
    H, W = jc.sv.images.shape[1:3]
    ro, rd = R.rays
    z = np.linspace(0.2, 6.0, 16, dtype=np.float32)
    xyz = (ro[:, None] + rd[:, None] * z[:, None]).reshape(-1, 3).astype(np.float32)
    proj = jproj.compute_projections(jnp.asarray(xyz), jc.sv.Ks, jc.sv.poses, H, W)
    uv_fm = np.asarray(proj.uv) / float(H // hf)
    front = np.asarray(proj.in_front)
    fxyz = np.asarray(jc.fine.xyz).reshape(V, hf, wf, 3)
    fmask = np.asarray(jc.fine.mask).reshape(V, hf, wf)
    jtab = j_pack_xyz_window(jnp.asarray(fxyz), jnp.asarray(fmask), win=win)
    want = j_knn_proj(jnp.asarray(xyz), jnp.asarray(uv_fm), jnp.asarray(front),
                         jtab, hf, wf, K=8, win=win)
    ttab = tknn.pack_xyz_window(t(fxyz), t(fmask), win=win)
    got = tknn.knn_proj(t(xyz), t(uv_fm), t(front), ttab, hf, wf, K=8, win=win)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("block", ["conv", "transpose"])
def test_ray_unet_conv_block_matches_flax(block):
    """The k=3 conv maps straight; flax's transposed conv needs its kernel
    flipped along k (weights.load_flax_variables does it)."""
    r = rng(7)
    S, cin, cout = 8, 6, 5
    x = r.standard_normal((4, S // 2 if block == "transpose" else S, cin)).astype(np.float32)
    jb = JConvBlock(cout, S, transpose=block == "transpose")
    v = jb.init(jax.random.PRNGKey(1), jnp.asarray(x))
    v = jax.tree.map(lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(2), a.shape), v)
    tb = TConvBlock(cin, cout, S, transpose=block == "transpose")
    assert load_flax_variables(tb, jax.tree.map(np.asarray, v)) == []
    with torch.no_grad():
        got = tb(t(x).transpose(1, 2)).transpose(1, 2)
    close(got, jb.apply(v, jnp.asarray(x)), rel=1e-5)


def test_ray_unet_matches_jax(R):
    S = R.base
    W = S.cfg.model_3d_hidden_dim
    x = rng(8).standard_normal((5, 8, W)).astype(np.float32)
    want = S.japply(lambda m, a: m.model_3d.ray_unet(a), jnp.asarray(x))
    with torch.no_grad():
        got = S.model.model_3d.ray_unet(t(x))
    close(got, want)


def test_sample_pdf_det_matches_jax():
    r = rng(9)
    bins = np.sort(r.uniform(0.5, 6.0, (10, 12)), axis=1).astype(np.float32)
    w = r.uniform(0, 1, (10, 11)).astype(np.float32) ** 4
    w[3] = 0.0                                       # flat CDF: eps only
    got = t_sample_pdf(t(bins), t(w), 7)
    close(got, j_sample_pdf(jnp.asarray(bins), jnp.asarray(w), 7), rel=1e-5)
    assert bool((got[:, 1:] >= got[:, :-1]).all())


@pytest.mark.parametrize("packed", [False, True])
def test_predict_alpha_weights_matches_jax(R, packed):
    jc = R.jctx["guided"]
    jm, tm = R.models["guided"]
    ro, rd = R.rays
    z = np.broadcast_to(np.linspace(0.3, 6.0, 8, dtype=np.float32), (N_RAYS, 8))
    pts = (ro[:, None] + rd[:, None] * z[..., None]).astype(np.float32)
    dists = np.asarray(jneuray.depth2inv_dists(jnp.asarray(z), jc.sv.near, jc.sv.far))
    want = jm.apply(R.base.variables, method=lambda m: m.model_3d.multiview_aggregator
                    .predict_alpha_weights(jc.sv, jnp.asarray(pts), jnp.asarray(z),
                                           jnp.asarray(dists),
                                           vis_packed=jc.vis_corner_packed if packed else None))
    ctx = R.port_ctx("guided")
    with torch.no_grad():
        got = tm.model_3d.multiview_aggregator.predict_alpha_weights(
            ctx.sv, t(pts), t(dists), vis_packed=ctx.vis_corner_packed if packed else None)
    close(got, want)


@pytest.mark.parametrize("lindisp", [False, True])
def test_sample_depths_matches_jax(R, lindisp):
    """Evenly spaced as jnp.linspace computes them (i / (n-1))."""
    S = R.base
    cfg = dataclasses.replace(S.cfg, render=dataclasses.replace(S.cfg.render,
                                                                lindisp=lindisp))
    jm = JaxEstimator(cfg)
    want = jm.apply(S.variables, method=lambda m: m.model_3d.sample_depths(
        64, S.batch["near"], S.batch["far"]))
    tm = NerfPoseEstimator(port_cfg(cfg), device="cpu", seed=0)
    got = tm.model_3d.sample_depths(64, t(S.np_batch["near"]), t(S.np_batch["far"]))
    close(got, want, rel=1e-6)


# -- the slice -----------------------------------------------------------------

@pytest.mark.parametrize("kind,train", [("dense", False), ("dense", True),
                                        ("guided", False), ("guided", True)])
def test_render_rays_matches_jax(R, kind, train):
    """Every output key of render_rays, on the same context and rays."""
    want = R.jax_render(kind, train, R.rays)
    ctx = R.port_ctx(kind)
    model = R.models[kind][1]
    with torch.no_grad():
        got = model.model_3d.render_rays(ctx, *map(t, R.rays), t(R.base.np_batch["pose"]),
                                         train=train)
    assert sorted(got) == sorted(want)
    assert ("beta" in got) == train and ("depth_coarse" in got) == (kind == "guided")
    assert np.array_equal(got["mask"].numpy(), want["mask"])
    for k in sorted(set(want) - {"mask"}):
        close(got[k], want[k])


def test_render_image_equals_render_rays(R):
    """A 16x16 frame in chunks of 64 rays (the tiny config's chunk) gives
    what one render_rays call over all its rays gives."""
    S = R.base
    model = S.model.model_3d
    assert S.cfg.render.chunk == 64
    ctx = R.port_ctx("dense")
    K, pose = t(S.np_batch["K"]).clone(), t(S.np_batch["pose"])
    K[:2] /= 2.0                                      # a 16x16 frame of the 32x32 view
    with torch.no_grad():
        img = model.render_image(ctx, K, pose, 16, 16)
        ro, rd = tcam.get_rays(16, 16, K, pose)
        ref = model.render_rays(ctx, ro.reshape(-1, 3), rd.reshape(-1, 3), pose)
    assert sorted(img) == sorted(ref)
    for k, v in ref.items():
        assert img[k].shape == (16, 16) + v.shape[1:]
        close(img[k].reshape(v.shape).float(), v.float(), rel=1e-6)


def test_render_image_rays_matches_jax(R):
    """The estimator's entry point: the port builds its own scene context
    (backbone, DepthFusionNet, neural points) from the batch. The context's
    own f32 differences (DepthFusionNet, 1e-4 relative) carry through."""
    S = R.base
    m = S.jmodel
    want = jax.jit(lambda v, b, ro, rd: m.apply(v, b, ro, rd, method=m.render_image_rays))(
        S.variables, S.batch, *map(jnp.asarray, R.rays))
    got = S.model.render_image_rays(S.tbatch, *map(t, R.rays))
    assert sorted(got) == sorted(want)
    assert np.array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
    for k in sorted(set(want) - {"mask"}):
        close(got[k], want[k])


def test_load_flax_variables_leaves_no_leaf_unused(R):
    assert R.base.unused == []


@pytest.mark.parametrize("option", [dict(knn_mode="ray"), dict(knn_mode="flat"),
                                    dict(use_merged_table=True), dict(prune_views=2),
                                    dict(table_dtype="int8"),
                                    dict(geo_assembly="onehot")],
                         ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_unported_render_options_raise(R, option):
    """Every render option is ported now: none raises; the model builds its
    context and renders finite outputs of the default's shapes
    (tests/test_torch_render_options.py holds each against JAX)."""
    S = R.base
    cfg = port_cfg(dataclasses.replace(S.cfg, render=dataclasses.replace(S.cfg.render,
                                                                         **option)))
    model = NerfPoseEstimator(cfg, device="cpu", seed=0)
    with torch.no_grad():
        ctx, _ = model.build_context(S.tbatch)
        got = model.model_3d.render_rays(ctx, *map(t, R.rays), t(S.np_batch["pose"]))
        want = S.model.model_3d.render_rays(R.port_ctx("dense"), *map(t, R.rays),
                                            t(S.np_batch["pose"]))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert bool(torch.isfinite(got[k].float()).all()), k
