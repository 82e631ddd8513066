"""Two configurations of the query beside the default one, in f32 on the
CPU, the PyTorch port against the JAX package at
`__graft_entry__._tiny_cfg()` with render.fused_query_agg=True:

- use_scene_coord_memorization=True (set by 30 of the 34 YAMLs under
  configs/): the per-scene coordinate heads add an MLP of the embedded
  point to every coarse and fine descriptor. localize_forward is held to
  the bounds of tests/test_torch_localize.py (descriptors and scores 1e-4
  of their scale, keypoints 1e-3 px, pose 1e-4, discrete outputs exact),
  and the weight bridge leaves no flax leaf unused;
- support views at another resolution than the query (64x64 against
  32x32): build_context runs the backbone once for the query and once for
  the support views, as JAX does. The scene context is held to 1e-3 of its
  scale (the NeuRay encoder's bound in tests/test_torch_modules.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from nerfloc_tpu_torch.models.pose_estimator import to_device_batch

from _torch_parity import CPU, TinySetup, few_threads, t  # noqa: F401


def close(got, want, rel):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.fixture(scope="module")
def coord():
    """The coordinate-head model's query on both sides, with JAX's noise."""
    S = TinySetup(use_scene_coord_memorization=True)
    rng = jax.random.PRNGKey(0)
    rng_kp, rng_pnp = jax.random.split(rng)
    m = S.jmodel

    @jax.jit
    def query(v, b, r):
        out = m.apply(v, b, r, method=m.localize_forward)
        desc = m.apply(v, b, jax.random.split(r)[0], method=m.localize_parts)[2]
        return out, desc

    jout, jdesc = query(S.variables, S.batch, rng)
    jout = {k: np.asarray(v) for k, v in jout.items()}
    jout["desc_3d"] = np.asarray(jdesc)
    P = S.model.n_coarse_points(S.tbatch)
    kp = np.asarray(jax.random.gumbel(rng_kp, (P,), dtype=jnp.float32))
    pnp = np.asarray(jax.random.gumbel(
        rng_pnp, (S.cfg.shapes.pnp_hypotheses, jout["mkps2d"].shape[0]), dtype=jnp.float32))
    with torch.no_grad():
        tout = S.model.localize_forward(S.tbatch, kp_gumbel=t(kp), pnp_gumbel=t(pnp))
    return S, jout, {k: v.numpy() for k, v in tout.items()}


def test_coord_heads_carry_every_leaf(coord):
    S, _, _ = coord
    assert S.unused == []
    assert hasattr(S.model.model_3d, "coord_desc_mlp_coarse")
    assert hasattr(S.model.model_3d, "coord_desc_mlp_fine")


@pytest.mark.parametrize("key,rel", [("desc_3d", 1e-4), ("score_matrix", 1e-4),
                                     ("mkps3d", 1e-6), ("pose", 1e-4)])
def test_coord_heads_localize_values_match_jax(coord, key, rel):
    _, jout, tout = coord
    close(tout[key], jout[key], rel)


def test_coord_heads_localize_keypoints_match_jax(coord):
    _, jout, tout = coord
    np.testing.assert_allclose(tout["mkps2d"], jout["mkps2d"], rtol=0, atol=1e-3)


@pytest.mark.parametrize("key", ["match_j", "match_mask", "num_inliers", "pnp_success"])
def test_coord_heads_discrete_outputs_match_jax(coord, key):
    _, jout, tout = coord
    assert np.array_equal(tout[key], jout[key]), (tout[key], jout[key])


def test_coord_heads_term_is_not_negligible(coord):
    """Each head adds a term of the descriptors' own scale (so the parity
    above would see it missing)."""
    S, jout, tout = coord
    nerf = S.model.model_3d
    with torch.no_grad():
        emb = nerf.xyz_embed(t(tout["mkps3d"]))
        for heads in (nerf.coord_desc_mlp_coarse, nerf.coord_desc_mlp_fine):
            assert float(heads(emb).abs().max()) > 0.1 * float(np.abs(jout["desc_3d"]).max())


def test_context_with_support_views_at_another_resolution(coord):
    """Query 32x32, support views 64x64 (their own cameras and depths), on
    the coordinate-head model (the heads play no part in the context)."""
    S = coord[0]
    nb = dict(S.np_batch)
    other = graft._tiny_batch(H=64, W=64, seed=1)
    for k in ("topk_images", "topk_depths", "topk_Ks", "topk_poses"):
        nb[k] = other[k]
    m = S.jmodel
    jctx, jq2d = jax.jit(lambda v, b: m.apply(v, b, method=m.build_context))(
        S.variables, {k: jnp.asarray(v) for k, v in nb.items()})
    with torch.no_grad():
        tctx, tq2d = S.model.build_context(to_device_batch(nb, CPU))
    assert tq2d["feat_coarse"].shape[1:3] == (4, 4)
    assert tctx.feat_coarse_src.shape[1:3] == (8, 8)
    close(tq2d["feat_coarse"], jq2d["feat_coarse"], 1e-3)
    close(tctx.sv.vis_featmaps, jctx.sv.vis_featmaps, 1e-3)
    for name in ("xyz", "feature", "kp_score", "mask"):
        close(getattr(tctx.coarse, name), getattr(jctx.coarse, name), 1e-3)
    for name in ("xyz", "feature", "confidence", "direction"):
        close(getattr(tctx.fine, name), getattr(jctx.fine, name), 1e-3)
    close(tctx.feat_fine_src, jctx.feat_fine_src, 1e-3)
