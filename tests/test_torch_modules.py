"""Module-level parity of the PyTorch port against the JAX package.

Weights come from one JAX NerfPoseEstimator init at the tiny config of
__graft_entry__ (carried over by nerfloc_tpu_torch.weights), inputs are
seeded numpy arrays, and both sides run on the CPU in f32. Default bound:
1e-4 relative to the output's scale; wider bounds carry their reason.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloc_tpu.geometry import cameras as jcam
from nerfloc_tpu.geometry import embedder as jemb
from nerfloc_tpu.geometry import se3 as jse3
from nerfloc_tpu.models.appearance import appearance_embedding as j_app_emb
from nerfloc_tpu.models.fields.aggregator import SupportViews as JSupport
from nerfloc_tpu.models.matching import gather_windows as j_gather_windows
from nerfloc_tpu.models.matching import mutual_nearest_matches as j_mutual
from nerfloc_tpu.ops import interp as jinterp
from nerfloc_tpu.ops.knn import knn as j_knn
from nerfloc_tpu.solve.pnp import ransac_pnp as j_ransac
from nerfloc_tpu_torch.geometry import cameras as tcam
from nerfloc_tpu_torch.geometry import embedder as temb
from nerfloc_tpu_torch.geometry import se3 as tse3
from nerfloc_tpu_torch.models.appearance import appearance_embedding as t_app_emb
from nerfloc_tpu_torch.models.fields.aggregator import SupportViews as TSupport
from nerfloc_tpu_torch.models.matching import gather_windows as t_gather_windows
from nerfloc_tpu_torch.models.matching import mutual_nearest_matches as t_mutual
from nerfloc_tpu_torch.ops import interp as tinterp
from nerfloc_tpu_torch.ops import knn as tknn
from nerfloc_tpu_torch.solve.pnp import ransac_pnp as t_ransac

from _torch_parity import TinySetup, t


@pytest.fixture(scope="module")
def S():
    return TinySetup()


def close(got, want, rel=1e-4):
    """|got - want| <= rel * max(1, max|want|) elementwise."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def rng(seed):
    return np.random.default_rng(seed)


def test_weight_bridge_leaves_only_render_modules(S):
    """The render head is ported too, so no flax leaf is left over."""
    assert S.unused == []


def _images(S):
    return np.concatenate([S.np_batch["image"][None], S.np_batch["topk_images"]])


def test_backbone_matches_jax(S):
    imgs = _images(S)
    want = S.japply(lambda m, x: m.backbone2d(x), jnp.asarray(imgs))
    with torch.no_grad():
        got = S.model.backbone2d(t(imgs))
    for k in ("conv1", "layer1", "layer2"):
        close(got[k], want[k])


def test_appearance_matches_jax(S):
    x = rng(1).standard_normal((4, 8, 8, 64)).astype(np.float32)
    feat = rng(2).standard_normal((3, 4, 4, 32)).astype(np.float32)
    close(t_app_emb(t(x)), j_app_emb(jnp.asarray(x)))
    emb = np.asarray(j_app_emb(jnp.asarray(x)))
    want = S.japply(lambda m, f, e, a: m.adapt_appearance_coarse(f, e, a),
                    jnp.asarray(feat), emb[1:], emb[:1])
    with torch.no_grad():
        got = S.model.adapt_appearance_coarse(t(feat), t(emb[1:]), t(emb[:1]))
    close(got, want)


def _support(S):
    b = S.np_batch
    args = (b["topk_images"], b["topk_depths"], b["topk_Ks"], b["topk_poses"],
            b["near"], b["far"])
    vis = S.japply(lambda m, *a: m.model_3d.depth_fusion(*a), *map(jnp.asarray, args))
    fields = dict(images=b["topk_images"], depths=b["topk_depths"], poses=b["topk_poses"],
                  Ks=b["topk_Ks"], vis_featmaps=np.asarray(vis), near=b["near"],
                  far=b["far"])
    return (JSupport(**{k: jnp.asarray(v) for k, v in fields.items()}),
            TSupport(**{k: t(v) for k, v in fields.items()}), args)


def test_depth_fusion_matches_jax(S):
    """A 13-conv encoder whose InstanceNorms run over 2x2..8x8 maps at this
    size magnifies f32 sum-order differences: bound 1e-3."""
    jsv, tsv, args = _support(S)
    with torch.no_grad():
        got = S.model.model_3d.depth_fusion(*[t(a) for a in args])
    close(got, jsv.vis_featmaps, rel=1e-3)


@pytest.mark.parametrize("level", ["fine", "coarse", "fine_packed"])
def test_aggregator_matches_jax(S, level):
    jsv, tsv, _ = _support(S)
    V = jsv.images.shape[0]
    h = 8 if level.startswith("fine") else 4
    C = S.cfg.backbone2d_fpn_dim
    feats = rng(3).standard_normal((V, h, h, C)).astype(np.float32)
    xyz = (S.np_batch["topk_poses"][0, :3, 3]
           + rng(4).uniform(-1.5, 1.5, (50, 3))).astype(np.float32)
    kw_j, kw_t = {}, {}
    if level == "fine_packed":
        fused = np.concatenate([feats, np.asarray(jsv.vis_featmaps)], -1)
        kw_j = dict(fused_packed=jinterp.pack_bilinear_corners(jnp.asarray(fused)),
                    rgb_packed=jinterp.pack_bilinear_corners(jsv.images))
        kw_t = dict(fused_packed=tinterp.pack_bilinear_corners(t(fused)),
                    rgb_packed=tinterp.pack_bilinear_corners(tsv.images))
    want = S.japply(lambda m, *a: m.model_3d.multiview_aggregator(*a, **kw_j),
                    jsv, jnp.asarray(feats), jnp.asarray(xyz))
    with torch.no_grad():
        got = S.model.model_3d.multiview_aggregator(tsv, t(feats), t(xyz), **kw_t)
    for g, w in zip(got, want[:3]):
        close(g, w)


def test_self_cross_transformer_matches_jax(S):
    hd = S.cfg.matcher_hidden_dim
    r = rng(5)
    x = [r.standard_normal((1, n, hd)).astype(np.float32) for n in (20, 20, 16, 16)]
    want = S.japply(lambda m, *a: m.coarse_transformer(*a), *map(jnp.asarray, x))
    with torch.no_grad():
        got = S.model.coarse_transformer(*[t(a) for a in x])
    for g, w in zip(got, want):
        close(g, w)


def test_s2d_matching_and_mutual_nn_match_jax(S):
    hd = S.cfg.matcher_hidden_dim
    d3 = rng(6).standard_normal((150, hd)).astype(np.float32)
    d2 = rng(7).standard_normal((16, hd)).astype(np.float32)
    want = S.japply(lambda m, a, b: jax.nn.sigmoid(m.coarse_matcher(a, b)),
                    jnp.asarray(d3), jnp.asarray(d2))
    with torch.no_grad():
        got = torch.sigmoid(S.model.coarse_matcher(t(d3), t(d2)))
    close(got, want)
    jj, jm = j_mutual(want, S.cfg.matching.thr)
    tj, tm = t_mutual(got, S.cfg.matching.thr)
    assert np.array_equal(tj.numpy(), np.asarray(jj))
    assert np.array_equal(tm.numpy(), np.asarray(jm))


def test_fine_matching_matches_jax(S):
    C, hd, wsz = S.cfg.backbone2d_fpn_dim, S.cfg.matcher_hidden_dim, 7
    feat = rng(8).standard_normal((8, 8, C)).astype(np.float32)
    centers = rng(9).integers(-2, 10, (12, 2)).astype(np.int32)
    jp, jv = j_gather_windows(jnp.asarray(feat), jnp.asarray(centers), wsz)
    tp, tv = t_gather_windows(t(feat), t(centers).long(), wsz)
    close(tp, jp)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    f3 = rng(10).standard_normal((12, hd)).astype(np.float32)
    want = S.japply(lambda m, a, p: m.fine_matcher(a, m.fine_preprocess(p)),
                    jnp.asarray(f3), jp)
    with torch.no_grad():
        got = S.model.fine_matcher(t(f3), S.model.fine_preprocess(tp))
    close(got, want)


@pytest.mark.parametrize("K", [1, 8])
def test_exact_knn_matches_jax(K):
    r = rng(11 + K)
    pts = r.uniform(-1, 1, (500, 3)).astype(np.float32)
    q = r.uniform(-1, 1, (64, 3)).astype(np.float32)
    mask = r.uniform(size=500) > 0.3
    jd, ji = j_knn(jnp.asarray(q), jnp.asarray(pts), K=K, points_mask=jnp.asarray(mask))
    td, ti = tknn.knn(t(q), t(pts), K=K, points_mask=t(mask))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    close(td, jd, rel=1e-5)


def _pnp_problem(seed, n=200, outliers=0.4):
    """Correspondences of a known camera with a share of outliers."""
    r = rng(seed)
    K = np.array([[200.0, 0, 160], [0, 200.0, 120], [0, 0, 1]], np.float32)
    R = np.asarray(jse3.so3_exp_map(jnp.asarray(r.normal(0, 0.4, 3), jnp.float32)))
    tvec = r.normal(0, 0.3, 3).astype(np.float32)
    pc = np.stack([r.uniform(-1, 1, n), r.uniform(-1, 1, n), r.uniform(2, 5, n)], -1)
    pw = ((pc - tvec) @ R).astype(np.float32)                 # R^T (pc - t)
    uv = (pc @ K.T)[:, :2] / pc[:, 2:3] + r.normal(0, 0.5, (n, 2))
    bad = r.uniform(size=n) < outliers
    uv[bad] = r.uniform(0, 320, (bad.sum(), 2))
    mask = r.uniform(size=n) > 0.1
    return uv.astype(np.float32), pw, mask, K


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_pnp_matches_jax(seed):
    """Same Gumbel noise on both sides (drawn by JAX), so both solve the
    same minimal sets."""
    uv, pw, mask, K = _pnp_problem(seed)
    key = jax.random.PRNGKey(seed)
    want = j_ransac(*map(jnp.asarray, (uv, pw, mask, K)), key, thresh_px=8.0, n_hyps=128)
    g = np.asarray(jax.random.gumbel(key, (128, uv.shape[0]), dtype=jnp.float32))
    got = t_ransac(t(uv), t(pw), t(mask), t(K), thresh_px=8.0, n_hyps=128, gumbel=t(g))
    assert int(got.num_inliers) == int(want.num_inliers)
    assert np.array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    close(got.c2w, want.c2w, rel=1e-4)


def _op_cases():
    """name -> (JAX function, port function, numpy inputs)."""
    r = rng(20)
    feat3 = r.standard_normal((9, 11, 3)).astype(np.float32)
    feat40 = r.standard_normal((9, 11, 40)).astype(np.float32)
    uv = r.uniform(-2, 12, (30, 2)).astype(np.float32)
    maps = r.standard_normal((2, 6, 7, 5)).astype(np.float32)
    uvv = r.uniform(-1, 8, (2, 13, 2)).astype(np.float32)
    img = r.standard_normal((24, 20, 3)).astype(np.float32)
    pts = r.uniform(-1, 1, (17, 3)).astype(np.float32)
    w = r.normal(0, 1.0, (6, 3)).astype(np.float32)
    K = np.array([[30.0, 0, 9.5], [0, 28.0, 7.5], [0, 0, 1]], np.float32)
    pose = np.asarray(jse3.se3_exp_map(jnp.asarray(r.normal(0, 0.5, 6), jnp.float32)))
    return {
        "bilinear_c3": (jinterp.bilinear_sample, tinterp.bilinear_sample, (feat3, uv)),
        "bilinear_c40": (jinterp.bilinear_sample, tinterp.bilinear_sample, (feat40, uv)),
        "packed_views": (
            lambda a, b: jinterp.packed_bilinear_sample_views(
                jinterp.pack_bilinear_corners(a), 6, 7, b),
            lambda a, b: tinterp.packed_bilinear_sample_views(
                tinterp.pack_bilinear_corners(a), 6, 7, b), (maps, uvv)),
        "resize_down4": (lambda a: jinterp.resize_nearest(a, 6, 5),
                         lambda a: tinterp.resize_nearest(a, 6, 5), (img,)),
        "resize_up2": (lambda a: jinterp.resize_nearest(a, 48, 40),
                       lambda a: tinterp.resize_nearest(a, 48, 40), (img,)),
        "embedder": (jemb.Embedder(10), temb.Embedder(10), (pts,)),
        "pos_embed_3d": (jemb.Embedder(8, include_input=False),
                         temb.Embedder(8, include_input=False), (pts,)),
        "so3_exp": (jse3.so3_exp_map, tse3.so3_exp_map, (w,)),
        "get_rays": (lambda a, b: jcam.get_rays(6, 5, a, b)[1],
                     lambda a, b: tcam.get_rays(6, 5, a, b)[1], (K, pose)),
    }


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_small_ops_match_jax(name):
    jfn, tfn, args = _op_cases()[name]
    close(tfn(*[t(a) for a in args]), jfn(*map(jnp.asarray, args)), rel=1e-5)


def test_position_embedding_and_pose_error_match_jax():
    close(temb.position_embedding_sine(5, 7, 24), jemb.position_embedding_sine(5, 7, 24),
          rel=1e-5)
    r = rng(21)
    a = np.asarray(jse3.se3_exp_map(jnp.asarray(r.normal(0, 0.5, 6), jnp.float32)))
    b = np.asarray(jse3.se3_exp_map(jnp.asarray(r.normal(0, 0.5, 6), jnp.float32)))
    for g, w in zip(tse3.compute_pose_error(t(a), t(b)), jse3.compute_pose_error(a, b)):
        close(g, w, rel=1e-5)
