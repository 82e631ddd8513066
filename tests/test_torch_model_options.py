"""The model options that are off by default, the port against the JAX
package on the CPU at `__graft_entry__._tiny_cfg()` (V=3 at 32x32):
simple_3d_model (the projection-average ablation), keypoints_3d_source=
'sfm' (keypoints drawn from the batch's SfM points), the alternative
coarse matching heads (models/coarse_matching_alt.py), and the
antialiased resize that DepthFusionNet takes where its depth skip and its
encoder differ in size (support views whose side is 8 mod 16).

Weights are seeded (`_torch_parity.seeded_variables`, no JAX init
compiled), render.fused_query_agg off (JAX's default). Both sides get the
same Gumbel noise: the test draws it on the JAX side, splitting the key as
localize_forward and train_forward do, and hands the numbers to the port.
Bounds, all f32: descriptors, scores, losses and pose 1e-4 of their scale,
matched keypoints 1e-3 px, discrete outputs exact; the matching heads'
confidences 1e-6; the resize 1e-6 and DepthFusionNet 1e-4 of the scale.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from nerfloc_tpu.data import device_batch as j_device_batch
from nerfloc_tpu.data import make_query_batch as j_make_query_batch
from nerfloc_tpu.models.pose_estimator import NerfPoseEstimator as JaxEstimator
from nerfloc_tpu_torch.models import coarse_matching_alt as talt
from nerfloc_tpu_torch.models.fields.neuray import DepthFusionNet
from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
from nerfloc_tpu_torch.ops import interp as tinterp
from nerfloc_tpu_torch.weights import load_flax_variables

from _torch_parity import CPU, port_cfg, seeded_variables, t

jalt = importlib.import_module("nerfloc_tpu.models.coarse_matching_alt")
jneuray = importlib.import_module("nerfloc_tpu.models.fields.neuray")
N_SFM = 200


def close(got, want, rel):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def sfm_points(b, n: int, seed: int):
    """n points back-projected from seeded query pixels with depth (the
    SfM points of the query's scene), the last tenth masked out."""
    r = np.random.default_rng(seed)
    H, W = b["depth"].shape
    v, u = np.nonzero(b["depth"] > 0)
    pick = r.choice(len(u), n, replace=False)
    u, v = u[pick].astype(np.float32), v[pick].astype(np.float32)
    d = b["depth"][v.astype(int), u.astype(int)]
    K, c2w = b["K"], b["pose"]
    cam = np.stack([(u - K[0, 2]) / K[0, 0] * d, (v - K[1, 2]) / K[1, 1] * d, d], -1)
    pts = cam @ c2w[:3, :3].T + c2w[:3, 3]
    mask = np.arange(n) < n - n // 10
    return pts.astype(np.float32), mask


class ModelSetup:
    """A JAX model and the port's, same seeded weights, for cfg fields kw,
    with the tiny batch and its SfM points."""

    def __init__(self, **kw):
        self.cfg = dataclasses.replace(graft._tiny_cfg(), **kw)
        b = graft._tiny_batch()
        b["points3d"], b["points3d_mask"] = sfm_points(b, N_SFM, seed=9)
        self.np_batch = b
        self.batch = {k: jnp.asarray(v) for k, v in b.items()}
        self.tbatch = to_device_batch(b, CPU)
        self.jmodel = JaxEstimator(self.cfg)
        self.variables = seeded_variables(self.jmodel, self.batch, jax.random.PRNGKey(0),
                                          seed=11)
        self.model = NerfPoseEstimator(port_cfg(self.cfg), device="cpu", seed=1)
        self.unused = load_flax_variables(self.model, jax.tree.map(np.asarray,
                                                                   self.variables))

    def localize(self, key):
        """(JAX outputs, port outputs) of localize_forward under key, with
        desc_3d from localize_parts."""
        m = self.jmodel

        @jax.jit
        def run(v, b, r):
            out = m.apply(v, b, r, method=m.localize_forward)
            out["desc_3d"] = m.apply(v, b, jax.random.split(r)[0],
                                     method=m.localize_parts)[2]
            return out
        jout = {k: np.asarray(v) for k, v in run(self.variables, self.batch, key).items()}
        rng_kp, rng_pnp = jax.random.split(key)
        kp = jax.random.gumbel(rng_kp, (self.model.n_coarse_points(self.tbatch),))
        pnp = jax.random.gumbel(rng_pnp, (self.cfg.shapes.pnp_hypotheses,
                                          jout["mkps2d"].shape[0]))
        tout = self.model.localize_forward(self.tbatch, kp_gumbel=t(kp), pnp_gumbel=t(pnp))
        return jout, {k: v.numpy() for k, v in tout.items()}

    def train_terms(self, key):
        m = self.jmodel
        jout = jax.jit(lambda v, b, r: m.apply(v, b, r, method=m.train_forward))(
            self.variables, self.batch, key)
        rng_kp, rng_ray = jax.random.split(key)
        H, W = self.np_batch["image"].shape[:2]
        kp = jax.random.gumbel(rng_kp, (self.model.n_coarse_points(self.tbatch),))
        idx = jax.random.choice(rng_ray, H * W, (self.cfg.render.N_rand,), replace=False)
        with torch.no_grad():
            tout = self.model.train_forward(self.tbatch, kp_gumbel=t(kp), ray_idx=t(idx).long())
        return ({k: np.asarray(v) for k, v in jout.items()},
                {k: v.numpy() for k, v in tout.items()})


@pytest.fixture(scope="module")
def simple():
    S = ModelSetup(simple_3d_model=True)
    key = jax.random.PRNGKey(3)
    return S, S.localize(key), S.train_terms(jax.random.PRNGKey(4))


@pytest.fixture(scope="module")
def sfm():
    S = ModelSetup(keypoints_3d_source="sfm")
    return S, S.localize(jax.random.PRNGKey(5)), S.train_terms(jax.random.PRNGKey(6))


LOCALIZE_VALUES = [("desc_3d", 1e-4), ("score_matrix", 1e-4), ("mkps3d", 1e-6),
                   ("pose", 1e-4)]
DISCRETE = ["match_j", "match_mask", "num_inliers", "pnp_success"]
TERMS = ["loss", "coarse_loss", "fine_loss", "ref_depth_loss", "render_loss", "psnr"]


def test_simple_model_carries_every_flax_leaf(simple):
    S = simple[0]
    assert S.unused == []
    names = {n.split(".")[1] for n, _ in S.model.named_parameters()
             if n.startswith("model_3d.")}
    assert "out_fc" in names
    assert not names & {"base_mlp", "base_mlp_attn", "ray_diff_fc"}


@pytest.mark.parametrize("key,rel", LOCALIZE_VALUES)
def test_simple_model_localize_values_match_jax(simple, key, rel):
    jout, tout = simple[1]
    close(tout[key], jout[key], rel)


@pytest.mark.parametrize("key", DISCRETE + ["mkps2d"])
def test_simple_model_localize_discrete_outputs_match_jax(simple, key):
    jout, tout = simple[1]
    if key == "mkps2d":
        np.testing.assert_allclose(tout[key], jout[key], rtol=0, atol=1e-3)
    else:
        assert np.array_equal(tout[key], jout[key])


@pytest.mark.parametrize("term", TERMS)
def test_simple_model_train_terms_match_jax(simple, term):
    jout, tout = simple[2]
    close(tout[term], jout[term], 1e-4)


def test_simple_model_launches_no_fused_kernel(simple, monkeypatch):
    """The ablation's query does no KNN: neither a render nor a query
    reaches the fused aggregation (on the card, no launch)."""
    from nerfloc_tpu_torch.models.fields import conditional_nerf as cn
    calls = []
    monkeypatch.setattr(cn, "fused_neighbor_agg", lambda *a, **k: calls.append(1))
    S = simple[0]
    with torch.no_grad():
        S.model.localize_forward(S.tbatch, generator=torch.Generator().manual_seed(0))
        S.model.train_forward(S.tbatch, generator=torch.Generator().manual_seed(0))
    assert calls == []


@pytest.mark.parametrize("key,rel", LOCALIZE_VALUES)
def test_sfm_keypoints_localize_values_match_jax(sfm, key, rel):
    S, (jout, tout), _ = sfm
    close(tout[key], jout[key], rel)
    if key == "mkps3d":
        # the keypoints are the batch's valid SfM points
        pts, mask = S.np_batch["points3d"], S.np_batch["points3d_mask"]
        assert all(mask[np.flatnonzero((pts == p).all(1))].any() for p in tout[key])


@pytest.mark.parametrize("key", DISCRETE + ["mkps2d"])
def test_sfm_keypoints_localize_discrete_outputs_match_jax(sfm, key):
    _, (jout, tout), _ = sfm
    if key == "mkps2d":
        np.testing.assert_allclose(tout[key], jout[key], rtol=0, atol=1e-3)
    else:
        assert np.array_equal(tout[key], jout[key])


@pytest.mark.parametrize("term", TERMS)
def test_sfm_keypoints_train_terms_match_jax(sfm, term):
    _, _, (jout, tout) = sfm
    close(tout[term], jout[term], 1e-4)


# -- alternative coarse matching heads ---------------------------------------

@pytest.fixture(scope="module")
def feats():
    r = np.random.default_rng(12)
    f0 = r.standard_normal((40, 24)).astype(np.float32)
    f1 = r.standard_normal((56, 24)).astype(np.float32)
    f1[:30] = f0[:30] + 0.1 * r.standard_normal((30, 24)).astype(np.float32)
    return f0, f1, r.uniform(size=40) > 0.1, r.uniform(size=56) > 0.1


@pytest.mark.parametrize("head", ["dual_softmax", "sinkhorn"])
def test_coarse_matching_alt_matches_jax(feats, head):
    """Confidences within 1e-6, the mutual-nearest matches equal, the
    focal loss against a seeded target within 1e-6 of its scale."""
    f0, f1, m0, m1 = feats
    if head == "dual_softmax":
        want = jax.jit(lambda *a: jalt.dual_softmax_confidence(*a[:2], 0.1, *a[2:]))(
            f0, f1, m0, m1)
        got = talt.dual_softmax_confidence(*map(torch.from_numpy, (f0, f1)), 0.1,
                                           *map(torch.from_numpy, (m0, m1)))
    else:
        want = jax.jit(lambda *a: jalt.sinkhorn_confidence(*a[:2], a[2], 3, *a[3:]))(
            f0, f1, np.float32(0.5), m0, m1)
        got = talt.sinkhorn_confidence(torch.from_numpy(f0), torch.from_numpy(f1),
                                       torch.tensor(0.5), 3, *map(torch.from_numpy, (m0, m1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    jj, jm = jax.jit(jalt.coarse_match_from_confidence)(want)
    tj, tm = talt.coarse_match_from_confidence(got)
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert np.array_equal(tj.numpy()[tm.numpy()], np.asarray(jj)[np.asarray(jm)])
    gt = np.zeros(got.shape, np.float32)
    gt[np.arange(30), np.arange(30)] = 1.0
    want_loss = jax.jit(jalt.coarse_matching_loss)(want, gt)
    close(talt.coarse_matching_loss(got, torch.from_numpy(gt)), want_loss, 1e-6)


# -- the antialiased resize --------------------------------------------------

@pytest.mark.parametrize("shape,out", [((2, 8, 8, 3), (7, 7)), ((2, 7, 9, 3), (8, 8)),
                                       ((2, 30, 40, 5), (15, 20)), ((1, 10, 10, 16), (12, 12))],
                         ids=lambda v: "x".join(map(str, v)))
def test_resize_bilinear_aa_matches_jax_image_resize(shape, out):
    x = np.random.default_rng(13).standard_normal(shape).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (shape[0], *out, shape[-1]), method="bilinear")
    close(tinterp.resize_bilinear_aa(torch.from_numpy(x), *out), want, 1e-6)


def test_depth_fusion_net_reaches_the_resize():
    """At 40x40 support views the encoder gives 12x12 and the depth skip
    10x10: the skip is resized as JAX resizes it."""
    b = j_device_batch(j_make_query_batch(n_views=3, H=40, W=40, seed=0))
    args = [b[k] for k in ("topk_images", "topk_depths", "topk_Ks", "topk_poses",
                           "near", "far")]
    jm = jneuray.DepthFusionNet()
    v = seeded_variables(jm, *map(jnp.asarray, args), seed=14)
    want = jax.jit(lambda vv, *a: jm.apply(vv, *a))(v, *map(jnp.asarray, args))
    assert want.shape[1:3] == (12, 12)
    tm = DepthFusionNet()
    assert load_flax_variables(tm, jax.tree.map(np.asarray, v)) == []
    with torch.no_grad():
        got = tm(*map(t, args))
    close(got, want, 1e-4)
