"""The per-scene fine-tune configurations' model on the CPU, the PyTorch
port against the JAX package at `__graft_entry__._tiny_cfg()` with
render.fused_query_agg (30 of the 34 experiment YAMLs fine-tune one scene
or object: use_scene_coord_memorization, and for the six OnePose objects
encode_appearance false). tests/test_torch_finetune_grads.py holds the
fine-tune model's gradients, tests/test_torch_finetune_cli.py the CLIs.

(a) The model without appearance FiLM (encode_appearance=False): the
    weight bridge carries a JAX model leaf for leaf with none unused and no
    adapt_appearance modules; localize_forward at f32 within
    tests/test_torch_localize.py's bounds (descriptors and scores 1e-4 of
    their scale, keypoints 1e-3 px, pose 1e-4, discrete outputs exact);
    at bf16 the scene context and the coarse descriptors within
    tests/test_torch_bf16.py's yardstick (rms(port16 - jax16) <= c
    rms(jax16 - jax32), c = 1 for these deep stages, and rms(port16 -
    port32) >= 0.5 rms(jax16 - jax32)), JAX under jax.jit.
(b) Warm start across models: a checkpoint of the multi-object model
    (appearance on, no coordinate heads: configs/onepose_all.yaml)
    restored into the per-object one (configs/onepose/0447.yaml's
    switches) takes exactly the parameters JAX's partial_restore takes,
    leaves the coordinate heads fresh, ignores the appearance layers and
    starts the Adam moments fresh.

`-s` prints the ratios.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloc_tpu.models.pose_estimator import NerfPoseEstimator as JaxEstimator
from nerfloc_tpu.train.checkpoint import partial_restore as j_partial_restore
from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator
from nerfloc_tpu_torch.train.checkpoint import partial_restore
from nerfloc_tpu_torch.train.state import TrainState

from _torch_parity import few_threads, jax_cfg, port_cfg, t, to_numpy  # noqa: F401
from test_torch_bf16 import BF, JBF, Bf16Setup, yardstick

COORD_HEADS = ("model_3d.coord_desc_mlp_coarse", "model_3d.coord_desc_mlp_fine")


def close(got, want, rel):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


# ---------------------------------------------------------------- (a)

@pytest.fixture(scope="module")
def plain():
    """The model without appearance FiLM at both dtypes, its query on both
    sides with JAX's noise."""
    S = Bf16Setup(encode_appearance=False)
    rng = jax.random.PRNGKey(0)
    rng_kp, rng_pnp = jax.random.split(rng)
    m = S.jm[32]

    @jax.jit
    def query(v, b, r):
        out = m.apply(v, b, r, method=m.localize_forward)
        desc = m.apply(v, b, jax.random.split(r)[0], method=m.localize_parts)[2]
        return out, desc

    jout, jdesc = query(S.variables, S.batch, rng)
    jout = {k: np.asarray(v) for k, v in jout.items()}
    jout["desc_3d"] = np.asarray(jdesc)
    P = S.pm[32].n_coarse_points(S.tbatch)
    kp = np.asarray(jax.random.gumbel(rng_kp, (P,), dtype=jnp.float32))
    pnp = np.asarray(jax.random.gumbel(
        rng_pnp, (S.cfg.shapes.pnp_hypotheses, jout["mkps2d"].shape[0]), dtype=jnp.float32))
    with torch.no_grad():
        tout = S.pm[32].localize_forward(S.tbatch, kp_gumbel=t(kp), pnp_gumbel=t(pnp))
    return S, jout, {k: v.numpy() for k, v in tout.items()}


def test_no_appearance_model_carries_every_leaf(plain):
    S = plain[0]
    from nerfloc_tpu_torch.weights import load_flax_variables
    for m in S.pm.values():
        assert load_flax_variables(m, to_numpy(S.variables)) == []
        assert not any("adapt_appearance" in n for n, _ in m.named_modules())
    assert not any(k.startswith("adapt_appearance") for k in S.variables["params"])


@pytest.mark.parametrize("key,rel", [("desc_3d", 1e-4), ("score_matrix", 1e-4),
                                     ("mkps3d", 1e-6), ("pose", 1e-4)])
def test_no_appearance_localize_values_match_jax(plain, key, rel):
    _, jout, tout = plain
    close(tout[key], jout[key], rel)


def test_no_appearance_localize_keypoints_match_jax(plain):
    _, jout, tout = plain
    np.testing.assert_allclose(tout["mkps2d"], jout["mkps2d"], rtol=0, atol=1e-3)


@pytest.mark.parametrize("key", ["match_j", "match_mask", "num_inliers", "pnp_success"])
def test_no_appearance_discrete_outputs_match_jax(plain, key):
    _, jout, tout = plain
    assert np.array_equal(tout[key], jout[key]), (tout[key], jout[key])


def test_no_appearance_context_and_descriptors_bf16(plain):
    """build_context and query_coarse at bf16 (deep, c = 1): the support
    images and maps go unadapted into the context on both sides."""
    S = plain[0]
    rng_kp = jax.random.split(jax.random.PRNGKey(0))[0]

    def jfn(m, b):
        ctx, _ = m.build_context(b)
        desc, pts, _ = m.model_3d.query_coarse(ctx, None, rng_kp)
        return ctx, desc, pts
    j = {d: jax.jit(lambda v, b, m=m: m.apply(v, b, method=jfn))(S.variables, S.batch)
         for d, m in S.jm.items()}
    P = S.pm[32].n_coarse_points(S.tbatch)
    kp = {d: t(np.asarray(jax.random.gumbel(rng_kp, (P,), dtype=dt).astype(jnp.float32)))
          for d, dt in ((16, JBF), (32, jnp.float32))}
    p = {}
    with torch.no_grad():
        for d, m in S.pm.items():
            ctx, _ = m.build_context(S.tbatch)
            desc, pts = m.model_3d.query_coarse(ctx, kp[d])[:2]
            p[d] = (ctx, desc, pts)
    fields = {"vis_featmaps": lambda c: c.sv.vis_featmaps,
              "coarse.feature": lambda c: c.coarse.feature,
              "fine.confidence": lambda c: c.fine.confidence,
              "feat_fine_src": lambda c: c.feat_fine_src}
    for name, get in fields.items():
        assert get(p[16][0]).dtype == BF, name
        yardstick(f"context {name}", get(p[16][0]), get(j[16][0]), get(j[32][0]),
                  get(p[32][0]), 1.0)
    # the same keypoints on both sides (JAX's bf16 noise ranks them)
    assert np.array_equal(p[16][2].numpy(), np.asarray(j[16][2]))
    if np.array_equal(p[32][2].numpy(), np.asarray(j[16][2])) and \
            np.array_equal(np.asarray(j[32][2]), np.asarray(j[16][2])):
        yardstick("desc_3d", p[16][1], j[16][1], j[32][1], p[32][1], 1.0)


# ---------------------------------------------------------------- (b)

def _switches(path):
    """The model switches a YAML sets (the rest of the tiny config stays)."""
    from nerfloc_tpu_torch.configs import load_config
    c = load_config(path)
    return dict(encode_appearance=c.encode_appearance, train_nerf=c.train_nerf,
                use_scene_coord_memorization=c.use_scene_coord_memorization)


def _module_paths(names):
    return {n.rsplit(".", 1)[0] for n in names}


def test_warm_start_takes_what_jax_takes():
    """onepose_all -> onepose/0447 at the tiny widths. JAX: its two models
    initialized from different keys, partial_restore of the first's
    variables into the second's; a leaf is taken where the result equals
    the source. Port: the same two models' state dicts through
    train.checkpoint.partial_restore, as cli.train warm-starts."""
    src_sw, dst_sw = _switches("configs/onepose_all.yaml"), _switches("configs/onepose/0447.yaml")
    assert src_sw["encode_appearance"] and not dst_sw["encode_appearance"]
    assert dst_sw["use_scene_coord_memorization"] and not src_sw["use_scene_coord_memorization"]
    import __graft_entry__ as graft
    batch = {k: jnp.asarray(v) for k, v in graft._tiny_batch().items()}
    jvars = {}
    for name, sw, seed in (("src", src_sw, 1), ("dst", dst_sw, 2)):
        m = JaxEstimator(jax_cfg(**sw))
        jvars[name] = to_numpy(jax.jit(m.init)(jax.random.PRNGKey(seed), batch,
                                               jax.random.PRNGKey(seed)))
    merged = j_partial_restore(jvars["dst"], jvars["src"])
    flat = lambda tree: dict(jax.tree_util.tree_flatten_with_path(tree)[0])  # noqa: E731
    fm, fs = flat(merged), flat(jvars["src"])
    jtaken = {p for p, v in fm.items() if p in fs and np.array_equal(np.asarray(v), fs[p])}
    jfresh = set(fm) - jtaken

    def path_name(p):   # ('params'|'frozen', module..., leaf) -> 'module.path'
        return ".".join(k.key for k in p[1:-1])

    src = NerfPoseEstimator(port_cfg(jax_cfg(**src_sw)), device="cpu", seed=1)
    dst = NerfPoseEstimator(port_cfg(jax_cfg(**dst_sw)), device="cpu", seed=2)
    state = TrainState(dst, dst.cfg)
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    restored = partial_restore(dst.state_dict(), src.state_dict())
    dst.load_state_dict(restored)
    flax_leafy = {n for n, _ in dst.named_parameters()} | \
        {n for n, b in dst.named_buffers() if n.rsplit(".", 1)[-1] in
         ("weight", "bias", "running_mean", "running_var")}
    ptaken = {k for k in flax_leafy if k in src.state_dict()
              and torch.equal(dst.state_dict()[k], src.state_dict()[k])}
    pfresh = flax_leafy - ptaken
    assert _module_paths(ptaken) == {path_name(p) for p in jtaken}
    assert _module_paths(pfresh) == {path_name(p) for p in jfresh} == {
        f"{h}.fc{i}" for h in COORD_HEADS for i in range(3)}
    assert len(pfresh) == 12
    assert all(torch.equal(dst.state_dict()[k], before[k]) for k in pfresh)
    assert any(k.startswith("adapt_appearance") for k in src.state_dict())
    assert state.step == 0 and all(float(v.abs().max()) == 0.0
                                   for v in state.opt_state.values())
