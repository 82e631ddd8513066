"""The bf16 compute dtype: the PyTorch port at dtype=torch.bfloat16 against
the JAX package at dtype=jnp.bfloat16, on the CPU, at
`__graft_entry__._tiny_cfg()` with render.fused_query_agg=True.

Every JAX function runs under jax.jit, as the JAX package runs it: XLA
rounds a jitted bf16 graph at other places than op-by-op execution (the
last elementwise step before an f32 cast is taken in f32), and the two
differ by as much as bf16 differs from f32. The port mirrors the jitted
rounding (nerfloc_tpu_torch/models/lowp.py).

bf16 cannot be held to exact values, so each comparison is held to two
bounds at once, in RMS over the output (max abs printed beside it, `-s`):
- close to JAX's bf16: rms(port_bf16 - jax_bf16) <= c rms(jax_bf16 - jax_f32),
  c = 0.5 for the shallow modules (the fused segment, the MLPs, attention,
  the matcher) and c = 1.0 for the deep ones (the backbone, the NeuRay
  encoder, the scene context, the render path);
- really in bf16: rms(port_bf16 - port_f32) >= 0.5 rms(jax_bf16 - jax_f32).
The measured ratios (port distance / JAX's own bf16-vs-f32 distance) are
in each test's docstring. A stage of the query is fed JAX's bf16 inputs
(its scene context, descriptors, Gumbel noise), in f32 and in bf16 on both
sides, so each stage's own rounding is measured. Torch runs on two threads.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from nerfloc_tpu.models.matching import mutual_nearest_matches as j_mutual
from nerfloc_tpu.models.pose_estimator import NerfPoseEstimator as JaxEstimator
from nerfloc_tpu.ops import fused_agg as jfa
from nerfloc_tpu_torch.configs import compute_dtype_of
from nerfloc_tpu_torch.models.fields.aggregator import SupportViews as TSupport
from nerfloc_tpu_torch.models.fields.context import NeuralPoints as TPoints
from nerfloc_tpu_torch.models.matching import mutual_nearest_matches as t_mutual
from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
from nerfloc_tpu_torch.ops import fused_agg as tfa
from nerfloc_tpu_torch.weights import agg_params_from_flax, load_flax_variables

from _torch_parity import CPU, few_threads, jax_cfg, port_cfg, t, to_numpy  # noqa: F401

BF = torch.bfloat16
JBF = jnp.bfloat16
N_RAYS = 24


def f64(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().double().numpy()
    return np.asarray(np.asarray(a).astype(np.float32), np.float64)


def rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a)))) if a.size else 0.0


def yardstick(name, p16, j16, j32, p32, c):
    """Both bounds of the module docstring; returns the two ratios."""
    p16, j16, j32, p32 = map(f64, (p16, j16, j32, p32))
    assert p16.shape == j16.shape == j32.shape == p32.shape, name
    ref = rms(j16 - j32)
    close, real = rms(p16 - j16), rms(p16 - p32)
    print(f"{name}: rms |port16-jax16| {close:.3g} (max {np.abs(p16 - j16).max():.3g}), "
          f"|jax16-jax32| {ref:.3g} (max {np.abs(j16 - j32).max():.3g}), |port16-port32| "
          f"{real:.3g}; ratios {close / ref:.3f} (<= {c}), {real / ref:.3f} (>= 0.5)")
    assert ref > 0, f"{name}: JAX's bf16 equals its f32"
    assert close <= c * ref, f"{name}: port bf16 {close / ref:.3f} x JAX's bf16 distance"
    assert real >= 0.5 * ref, f"{name}: port bf16 only {real / ref:.3f} x away from f32"
    return close / ref, real / ref


def jit_apply(model, fn):
    return jax.jit(lambda v, *a: model.apply(v, *a, method=fn))


class Bf16Setup:
    """One JAX init; the JAX model at f32 and at bf16, the port at f32 and
    at bf16 (compute_dtype_of of the default Config), all with its weights."""

    def __init__(self, **cfg_kw):
        self.cfg = jax_cfg(**cfg_kw)
        self.np_batch = graft._tiny_batch()
        self.batch = {k: jnp.asarray(v) for k, v in self.np_batch.items()}
        self.jm = {32: JaxEstimator(self.cfg), 16: JaxEstimator(self.cfg, dtype=JBF)}
        rng = jax.random.PRNGKey(0)
        self.variables = jax.jit(self.jm[32].init)(rng, self.batch, rng)
        np_vars = to_numpy(self.variables)
        pcfg = port_cfg(self.cfg)
        self.pm = {32: NerfPoseEstimator(pcfg, device="cpu", seed=1),
                   16: NerfPoseEstimator(pcfg, device="cpu", seed=1,
                                         dtype=compute_dtype_of(pcfg))}
        for m in self.pm.values():
            assert load_flax_variables(m, np_vars) == []
        self.tbatch = to_device_batch(self.np_batch, CPU)

    def jax(self, fn, *args):
        """fn(module, *args) under jit at f32 and at bf16 -> {32: .., 16: ..}."""
        return {k: jit_apply(m, fn)(self.variables, *args) for k, m in self.jm.items()}

    def port(self, fn, *args):
        """fn(module, *args) at f32 and at bf16, inputs as tensors."""
        with torch.no_grad():
            return {k: fn(m, *args) for k, m in self.pm.items()}


@pytest.fixture(scope="module")
def S():
    return Bf16Setup()


def check(name, S_out_p, S_out_j, c):
    return yardstick(name, S_out_p[16], S_out_j[16], S_out_j[32], S_out_p[32], c)


def rng(seed):
    return np.random.default_rng(seed)


def test_compute_dtype_of_resolves_the_config():
    cfg = port_cfg(jax_cfg())
    assert compute_dtype_of(cfg) == BF
    assert compute_dtype_of(dataclasses.replace(cfg, compute_dtype="float32")) == torch.float32


# ---------------------------------------------------------------------------
# 1. the fused segment
# ---------------------------------------------------------------------------

def _agg_inputs(S, N, K, seed):
    cfg = S.cfg
    F, W = 3 + cfg.backbone2d_fpn_dim, cfg.model_3d_hidden_dim
    r = rng(seed)
    xyz = r.uniform(-1, 1, (N, 3)).astype(np.float32)
    nb_dir = r.standard_normal((N, K, 4)).astype(np.float32)
    x = dict(xyz=xyz, direction=np.ascontiguousarray(nb_dir[:, 0]),
             mv_agg=r.standard_normal((N, W)).astype(np.float32),
             nb_xyz=(xyz[:, None] + 0.1 * r.standard_normal((N, K, 3))).astype(np.float32),
             nb_dir=nb_dir, nb_feat=r.standard_normal((N, K, F)).astype(np.float32),
             scale=np.float32(3.5))
    freqs = tuple(2.0 ** i for i in range(cfg.multires))
    params = S.variables["params"]["model_3d"]
    jp = jfa.extract_agg_params(params, len(freqs), F)
    tp = agg_params_from_flax(to_numpy(params), len(freqs), F)
    return x, freqs, jp, tp


ORDER = ("xyz", "direction", "mv_agg", "nb_xyz", "nb_dir", "nb_feat", "scale")


def _jx(x, dt):
    a = [jnp.asarray(x[k]) for k in ORDER]
    a[2], a[5] = a[2].astype(dt), a[5].astype(dt)
    return a


def _tx(x, dt):
    return {k: t(v).to(dt) if k in ("mv_agg", "nb_feat") else t(v) for k, v in x.items()}


@pytest.mark.parametrize("N,K", [(32, 8), (32, 1), (300, 8)])
def test_plain_bf16_forward_matches_pallas_kernel(S, N, K):
    """The port's plain bf16 forward (kernel_agg, what bf16 CPU tensors
    run) against JAX `fused_neighbor_agg(dt=bf16)`, which runs the Pallas
    `_kernel` in interpret mode, at the tiny config's query shapes and a
    ragged N (300 against the 256-row tile). Bound: half of JAX's own
    `_kernel`-vs-`reference_agg` bf16 distance, and the yardsticks with
    c = 0.5. Measured: RMS ratio to the kernel-vs-reference distance
    0.000-0.007, yardstick ratios 0.000-0.004 and 1.00."""
    x, freqs, jp, tp = _agg_inputs(S, N, K, seed=N + K)
    fused = jax.jit(lambda a, dt: jfa.fused_neighbor_agg(*a, jp, freqs, dt), static_argnums=1)
    ref = jax.jit(lambda a: jfa.reference_agg(*a, jp, freqs, JBF))
    j16, j32 = np.asarray(fused(_jx(x, JBF), JBF)), np.asarray(fused(_jx(x, jnp.float32),
                                                                      jnp.float32))
    jref16 = np.asarray(ref(_jx(x, JBF)))
    tfreqs = torch.tensor(freqs, dtype=torch.float32)
    p16 = tfa.fused_neighbor_agg(**_tx(x, BF), params=tp, freqs=tfreqs)
    assert p16.dtype == torch.float32
    p32 = tfa.fused_neighbor_agg(**_tx(x, torch.float32), params=tp, freqs=tfreqs)
    between = rms(f64(j16) - f64(jref16))
    got = rms(f64(p16) - f64(j16))
    print(f"N={N} K={K}: rms |kernel_agg - _kernel| {got:.3g}, "
          f"|_kernel - reference_agg| (JAX, bf16) {between:.3g}")
    assert got <= 0.5 * between
    yardstick(f"fused N={N} K={K}", p16, j16, j32, p32, 0.5)


def test_reference_agg_bf16_and_its_gradients_match_jax(S):
    """The replayed backward: the port's reference_agg at bf16 against
    JAX reference_agg(dt=bf16), forward and the gradients of the inputs
    and weights against jax.vjp of it (jitted). Bounds (RMS, against JAX's
    own bf16-vs-f32 distance): the forward 0.5; each gradient 1.0, since
    every step of the backward rounds its cotangent where XLA's transposed
    graph may not. Measured: forward 0.000; gradients xyz 0.05, direction
    0.09, mv_agg 0.39, nb_feat 0.06, rd_w1 0.06, b_w0p 0.06, b_w1 0.07,
    a_wq 0.95, a_wk 0.96, a_wv, a_wfc and ln_s 0.00."""
    x, freqs, jp, tp = _agg_inputs(S, 64, 8, seed=3)
    g = rng(4).standard_normal((64, S.cfg.model_3d_hidden_dim)).astype(np.float32)

    def jgrad(dt):
        def f(a, p):
            return jfa.reference_agg(*a, p, freqs, dt)
        out, vjp = jax.vjp(f, _jx(x, dt), jp)
        ga, gp = vjp(jnp.asarray(g))
        return out, dict(zip(ORDER, ga)), gp

    j16, j32 = jax.jit(lambda: jgrad(JBF))(), jax.jit(lambda: jgrad(jnp.float32))()

    def pgrad(dt):
        xs = {k: v.requires_grad_(k != "scale") for k, v in _tx(x, dt).items()}
        ps = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        out = tfa.reference_agg(**xs, params=ps, freqs=torch.tensor(freqs), dtype=dt)
        out.backward(t(g))
        return out, {k: v.grad for k, v in xs.items() if k != "scale"}, \
            {k: v.grad for k, v in ps.items()}

    p16, p32 = pgrad(BF), pgrad(torch.float32)
    yardstick("reference_agg", p16[0], j16[0], j32[0], p32[0], 0.5)
    for k in ("xyz", "direction", "mv_agg", "nb_feat"):
        close = rms(f64(p16[1][k]) - f64(j16[1][k]))
        ref = rms(f64(j16[1][k]) - f64(j32[1][k]))
        print(f"d/d{k}: {close:.3g} vs {ref:.3g}")
        assert close <= ref, k
    for k in ("rd_w1", "b_w0p", "b_w1", "a_wq", "a_wk", "a_wv", "a_wfc", "ln_s"):
        want16, want32 = f64(j16[2][k]).reshape(-1), f64(j32[2][k]).reshape(-1)
        close = rms(f64(p16[2][k]).reshape(-1) - want16)
        ref = rms(want16 - want32)
        print(f"d/d{k}: {close:.3g} vs {ref:.3g}")
        assert close <= ref, k


def _unpack_ring_bf16(packed, F, NF, RD2, wgmma):
    """Read the bf16 ring back the way the kernel does -> each product's
    [Kp, 128] matrix. mma.sync (16/32-row tiles): k-step ks, warp w, lane
    (g, t) = (lane // 4, lane % 4) and half h read the 16 bytes at
    ks*2048 + w*512 + h*256 + 8*lane (bf16 elements): words (jl, b) = (0, 0),
    (0, 1), (1, 0), (1, 1), each two bf16 (k, k + 1) with k = 2t + 8b,
    n = 32w + 8(2h + jl) + g. wgmma (64-row tiles): core matrices of 8 n-rows
    x 8 k, (k = 8 kh + c, n = 8 ng + r) at ks*2048 + kh*1024 + ng*64 + r*8 + c."""
    Fp, fin_p = tfa.ring_widths(F, NF, RD2, 16)
    lane = np.arange(32)
    g, tt = lane // 4, lane % 4
    kh, ng, r, c = np.meshgrid(np.arange(2), np.arange(16), np.arange(8), np.arange(8),
                               indexing="ij")
    out, base = [], 0
    for kp in (fin_p,) + (128,) * 6:
        blk = packed[base:base + kp * 128]
        base += kp * 128
        m = np.full((kp, 128), np.nan, np.float32)
        for ks in range(kp // 16):
            if wgmma:
                m[16 * ks + 8 * kh + c, 8 * ng + r] = blk[ks * 2048 + kh * 1024 + ng * 64
                                                          + r * 8 + c]
                continue
            for w in range(4):
                for h in range(2):
                    for jl in range(2):
                        for b in range(2):
                            for e in range(2):
                                at = (ks * 2048 + w * 512 + h * 256 + lane * 8
                                      + (2 * jl + b) * 2 + e)
                                m[16 * ks + 2 * tt + 8 * b + e,
                                  32 * w + 8 * (2 * h + jl) + g] = blk[at]
        out.append(m)
    assert base == packed.shape[0]
    return out


@pytest.mark.parametrize("wgmma", [False, True])
@pytest.mark.parametrize("F,NF,W", [(195, 10, 128), (35, 5, 32)])
def test_bf16_weight_pack_round_trips(F, NF, W, wgmma):
    """The bf16 ring, in both layouts: every slot written once; fc0 holds
    the features, then the off, sin, cos and rdfc blocks each from a whole
    k-step of 16 (the kernel sums their products block by block), zeros
    between; all weights rounded to nearest even (as astype)."""
    r = rng(40)
    RD1, RD2 = 16, 27
    fin = F + 3 + 6 * NF + RD2
    shapes = dict(rd_w1=(4, RD1), rd_b1=(RD1,), rd_w2=(RD1, RD2), rd_b2=(RD2,),
                  b_w0p=(fin, W), b_b0=(W,), b_w1=(W, W), b_b1=(W,), b_w2=(W, W),
                  b_b2=(W,), a_wq=(W, 128), a_wk=(W, 128), a_wv=(W, 128), a_wfc=(128, W),
                  ln_s=(W,), ln_b=(W,))
    p = {k: torch.from_numpy(r.standard_normal(s).astype(np.float32)) for k, s in shapes.items()}
    packed = tfa.pack_agg_weights(p, F, NF, wgmma=wgmma, dtype=BF)
    assert packed.dtype == BF
    Fp, fin_p = tfa.ring_widths(F, NF, RD2, 16)
    got = _unpack_ring_bf16(packed.float().numpy(), F, NF, RD2, wgmma)
    fc0 = np.zeros((fin_p, 128), np.float32)
    src = p["b_w0p"].to(BF).float().numpy()
    fc0[:F, :W] = src[:F]
    row = F
    for col, n in zip(tfa._emb_blocks(NF, RD2, 16), (3, 3 * NF, 3 * NF, RD2)):
        assert col % 16 == 0
        fc0[Fp + col:Fp + col + n, :W] = src[row:row + n]
        row += n
    np.testing.assert_array_equal(got[0], fc0)
    for m, key in zip(got[1:], tfa.RING_KEYS[1:]):
        want = np.zeros((128, 128), np.float32)
        w = p[key].to(BF).float().numpy()
        want[:w.shape[0], :w.shape[1]] = w
        np.testing.assert_array_equal(m, want)


def test_wrapper_refuses_mixed_dtypes(S):
    """mv_agg and nb_feat are both f32 or both bf16: anything else raises,
    on the CPU as on the card."""
    x, freqs, _, tp = _agg_inputs(S, 8, 8, seed=1)
    tx = _tx(x, torch.float32)
    for mv, feat in ((BF, torch.float32), (torch.float32, BF), (torch.float16, torch.float16)):
        with pytest.raises(TypeError):
            tfa.fused_neighbor_agg(**dict(tx, mv_agg=tx["mv_agg"].to(mv),
                                          nb_feat=tx["nb_feat"].to(feat)),
                                   params=tp, freqs=torch.tensor(freqs))


def test_bf16_cpu_path_replays_reference_agg_backward(S):
    """On the CPU the bf16 wrapper runs kernel_agg forward and, as on the
    card and as JAX's custom VJP does, replays reference_agg(dtype=bf16)
    backward: its gradients equal autograd's through that replay."""
    x, freqs, _, tp = _agg_inputs(S, 16, 8, seed=2)
    g = t(rng(3).standard_normal((16, S.cfg.model_3d_hidden_dim)).astype(np.float32))
    grads = []
    for fn in (tfa.fused_neighbor_agg,
               lambda **kw: tfa.reference_agg(**kw, dtype=BF)):
        xs = {k: v.requires_grad_(k in ("xyz", "mv_agg", "nb_feat"))
              for k, v in _tx(x, BF).items()}
        ps = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        fn(**xs, params=ps, freqs=torch.tensor(freqs)).backward(g)
        grads.append([xs["xyz"].grad, xs["mv_agg"].grad, xs["nb_feat"].grad, ps["b_w1"].grad])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# 2. the modules
# ---------------------------------------------------------------------------

def test_backbone_bf16(S):
    """ResNet50 trunk + FPN (deep, c = 1). Measured ratios: conv1 0.00,
    layer1 0.48, layer2 0.51 (f32 sum-order flips of bf16 roundings,
    carried through ten blocks; one block alone is 99.75 % bit-equal);
    1.00-1.01 from f32."""
    imgs = np.concatenate([S.np_batch["image"][None], S.np_batch["topk_images"]])
    j = S.jax(lambda m, x: m.backbone2d(x), jnp.asarray(imgs))
    p = S.port(lambda m, x: m.backbone2d(x), t(imgs))
    assert p[16]["layer1"].dtype == BF and j[16]["layer1"].dtype == JBF
    for k in ("conv1", "layer1", "layer2"):
        check(f"backbone {k}", {d: p[d][k] for d in p}, {d: j[d][k] for d in j}, 1.0)


def test_appearance_bf16(S):
    """The embedding and the FiLM layer (an MLP, c = 0.5) on bf16 maps.
    Measured: 0.00 (bit-equal)."""
    x = rng(1).standard_normal((4, 8, 8, 64)).astype(np.float32)
    feat = rng(2).standard_normal((3, 4, 4, 32)).astype(np.float32)

    def jfn(m, x, f):
        from nerfloc_tpu.models.appearance import appearance_embedding
        e = appearance_embedding(x.astype(m.dtype))
        return e, m.adapt_appearance_coarse(f.astype(m.dtype), e[1:], e[:1])

    def pfn(m, x, f):
        from nerfloc_tpu_torch.models.appearance import appearance_embedding
        e = appearance_embedding(x.to(m.dtype))
        return e, m.adapt_appearance_coarse(f.to(m.dtype), e[1:], e[:1])
    j = S.jax(jfn, jnp.asarray(x), jnp.asarray(feat))
    p = S.port(pfn, t(x), t(feat))
    for i, name in enumerate(("embedding", "film")):
        check(f"appearance {name}", {d: p[d][i] for d in p}, {d: j[d][i] for d in j}, 0.5)


def _support_args(S):
    b = S.np_batch
    return [b["topk_images"], b["topk_depths"], b["topk_Ks"], b["topk_poses"],
            b["near"], b["far"]]


def test_depth_fusion_bf16(S):
    """DepthFusionNet: the NeuRay encoder's 15 convolutions and instance
    norms (deep, c = 1). Measured: 0.52 of JAX's distance, 1.08 from f32."""
    args = _support_args(S)
    j = S.jax(lambda m, *a: m.model_3d.depth_fusion(*a), *map(jnp.asarray, args))
    p = S.port(lambda m, *a: m.model_3d.depth_fusion(*a), *map(t, args))
    assert p[16].dtype == BF
    check("depth_fusion", p, j, 1.0)


def _sv(S, vis16):
    b = S.np_batch
    fields = dict(images=b["topk_images"], depths=b["topk_depths"], poses=b["topk_poses"],
                  Ks=b["topk_Ks"], vis_featmaps=vis16, near=b["near"], far=b["far"])
    from nerfloc_tpu.models.fields.aggregator import SupportViews as JSupport
    return (JSupport(**{k: jnp.asarray(v) for k, v in fields.items()}),
            TSupport(**{k: t(v) for k, v in fields.items()}))


@pytest.mark.parametrize("path", ["context", "render"])
def test_aggregator_bf16(S, path):
    """The multiview aggregator on bf16 maps: the context path (maps
    sampled with f32 weights, f32 samples) and the render path (packed
    bf16 tables, bf16 samples); its visibility decode, fusion and output
    head. The output head is an MLP over the fused statistics (c = 0.5).
    Measured: context out 0.26, vis 0.09; render out 0.41, vis 0.00."""
    from nerfloc_tpu.ops import interp as jinterp
    from nerfloc_tpu_torch.ops import interp as tinterp
    vis = np.asarray(jit_apply(S.jm[16], lambda m, *a: m.model_3d.depth_fusion(*a))(
        S.variables, *map(jnp.asarray, _support_args(S))))
    jsv, tsv = _sv(S, vis)
    C = S.cfg.backbone2d_fpn_dim
    feats = rng(3).standard_normal((3, 8, 8, C)).astype(np.float32)
    xyz = (S.np_batch["topk_poses"][0, :3, 3]
           + rng(4).uniform(-1.5, 1.5, (50, 3))).astype(np.float32)

    def jfn(m, sv, f, x):
        f = f.astype(m.dtype)
        kw = {}
        if path == "render":
            kw = dict(fused_packed=jinterp.pack_bilinear_corners(jnp.concatenate(
                [f, sv.vis_featmaps.astype(m.dtype)], -1)),
                rgb_packed=jinterp.pack_bilinear_corners(sv.images.astype(m.dtype)))
        return m.model_3d.multiview_aggregator(sv, f, x, **kw)[:3]

    def pfn(m, sv, f, x):
        f = f.to(m.dtype)
        kw = {}
        if path == "render":
            kw = dict(fused_packed=tinterp.pack_bilinear_corners(torch.cat(
                [f, sv.vis_featmaps.to(m.dtype)], -1)),
                rgb_packed=tinterp.pack_bilinear_corners(sv.images.to(m.dtype)))
        return m.model_3d.multiview_aggregator(sv, f, x, **kw)
    j = S.jax(jfn, jsv, jnp.asarray(feats), jnp.asarray(xyz))
    p = S.port(pfn, tsv, t(feats), t(xyz))
    for i, name in enumerate(("out", "rgb_feat", "vis")):
        assert str(p[16][i].dtype).split(".")[-1] == str(j[16][i].dtype), name
    check(f"aggregator {path} out", {d: p[d][0] for d in p}, {d: j[d][0] for d in j}, 0.5)
    check(f"aggregator {path} vis", {d: p[d][2] for d in p}, {d: j[d][2] for d in j}, 0.5)


def test_ray_unet_bf16(S):
    """RayUnet over [R, S, C] (seven convolutions with LayerNorms, deep,
    c = 1). Measured: 0.00 (within f32 sum order)."""
    x = rng(5).standard_normal((20, 8, S.cfg.model_3d_hidden_dim)).astype(np.float32)
    j = S.jax(lambda m, a: m.model_3d.ray_unet(a), jnp.asarray(x))
    p = S.port(lambda m, a: m.model_3d.ray_unet(a), t(x))
    check("ray_unet", p, j, 1.0)


def test_self_cross_transformer_bf16(S):
    """SelfCrossTransformer on bf16 descriptors with f32 positions (the
    coarse matcher's inputs; attention, c = 0.5). Measured: 0.00."""
    hd = S.cfg.matcher_hidden_dim
    r = rng(6)
    x = [r.standard_normal((1, n, hd)).astype(np.float32) for n in (20, 20, 16, 16)]

    def jfn(m, a, pa, b, pb):
        return m.coarse_transformer(a.astype(m.dtype), pa, b.astype(m.dtype),
                                    pb.astype(m.dtype))

    def pfn(m, a, pa, b, pb):
        return m.coarse_transformer(a.to(m.dtype), pa, b.to(m.dtype), pb.to(m.dtype))
    j = S.jax(jfn, *map(jnp.asarray, x))
    p = S.port(pfn, *map(t, x))
    for i in range(2):
        check(f"transformer v{i}", {d: p[d][i] for d in p}, {d: j[d][i] for d in j}, 0.5)


def test_neighbour_attention_bf16(S):
    """The unfused query's attention (MultiHeadAttention with residual and
    LayerNorm, c = 0.5) over bf16 point features. Measured: 0.00."""
    W = S.cfg.model_3d_hidden_dim
    q = rng(7).standard_normal((30, 1, W)).astype(np.float32)
    kv = rng(8).standard_normal((30, 8, W)).astype(np.float32)
    j = S.jax(lambda m, a, b: m.model_3d.base_mlp_attn(a.astype(m.dtype), b.astype(m.dtype),
                                                       b.astype(m.dtype))[0],
              jnp.asarray(q), jnp.asarray(kv))
    p = S.port(lambda m, a, b: m.model_3d.base_mlp_attn(a.to(m.dtype), b.to(m.dtype),
                                                        b.to(m.dtype)), t(q), t(kv))
    check("base_mlp_attn", p, j, 0.5)


def test_matchers_bf16(S):
    """S2DMatching's score MLP, FinePreprocess and FineMatching (c = 0.5);
    the fine coordinates are f32 on both sides. Measured: 0.00 (scores and
    window projection bit-equal)."""
    hd, C = S.cfg.matcher_hidden_dim, S.cfg.backbone2d_fpn_dim
    d3 = rng(9).standard_normal((40, hd)).astype(np.float32)
    d2 = rng(10).standard_normal((16, hd)).astype(np.float32)
    win = rng(11).standard_normal((12, 49, C)).astype(np.float32)
    f3 = rng(12).standard_normal((12, hd)).astype(np.float32)

    def jfn(m, a, b, w, f):
        pre = m.fine_preprocess(w.astype(m.dtype))
        return m.coarse_matcher(a, b), pre, m.fine_matcher(f, pre.astype(jnp.float32))

    def pfn(m, a, b, w, f):
        pre = m.fine_preprocess(w.to(m.dtype))
        return m.coarse_matcher(a, b), pre, m.fine_matcher(f, pre.float())
    j = S.jax(jfn, *map(jnp.asarray, (d3, d2, win, f3)))
    p = S.port(pfn, *map(t, (d3, d2, win, f3)))
    assert p[16][2].dtype == torch.float32 and j[16][2].dtype == jnp.float32
    for i, name in enumerate(("s2d scores", "fine preprocess", "fine expectation")):
        check(name, {d: p[d][i] for d in p}, {d: j[d][i] for d in j}, 0.5)


def test_mlps_bf16(S):
    """The conditional NeRF's MLP heads (confidence, keypoint score,
    descriptor projection, sigma; c = 0.5). Measured: 0.00 (bit-equal)."""
    W, C = S.cfg.model_3d_hidden_dim, S.cfg.backbone2d_fpn_dim
    x = rng(13).standard_normal((50, W)).astype(np.float32)
    f = rng(14).standard_normal((50, C)).astype(np.float32)
    y = rng(15).standard_normal((50, W + 3 + C)).astype(np.float32)
    heads = ("confidence_mlp", "keypoint_head", "proj_layer_3d_coarse", "sigma_mlp")

    def jfn(m, a, b, c):
        n = m.model_3d
        return n.confidence_mlp(a), n.keypoint_head(b), n.proj_layer_3d_coarse(c), \
            n.sigma_mlp(a)
    j = S.jax(jfn, *map(jnp.asarray, (x, f, y)))
    from nerfloc_tpu_torch.models.lowp import dense

    def pfn(m, a, b, c):
        n = m.model_3d
        return n.confidence_mlp(a), n.keypoint_head(b), \
            dense(n.proj_layer_3d_coarse, c, n.dtype), n.sigma_mlp(a)
    p = S.port(pfn, *map(t, (x, f, y)))
    for i, name in enumerate(heads):
        check(name, {d: p[d][i] for d in p}, {d: j[d][i] for d in j}, 0.5)


# ---------------------------------------------------------------------------
# 3. localize_forward, stage by stage, and 4. render_rays
# ---------------------------------------------------------------------------

def port_context(model, jc):
    """The port's scene context from a JAX context's fields (bf16 ones stay
    bf16); the port builds its own tables."""
    sv = TSupport(**{k: t(getattr(jc.sv, k)) for k in TSupport._fields})

    def points(p):
        return TPoints(**{f.name: None if getattr(p, f.name) is None
                          else t(getattr(p, f.name)) for f in dataclasses.fields(TPoints)})
    return model.model_3d.assemble_context(sv, points(jc.coarse), points(jc.fine),
                                           t(jc.feat_coarse_src), t(jc.feat_fine_src))


@pytest.fixture(scope="module")
def Q(S):
    """JAX's bf16 query (one jit: localize_forward with localize_parts), the
    JAX f32 model's stages on the bf16 stage inputs, the Gumbel noise."""
    rng_ = jax.random.PRNGKey(0)
    rng_kp, rng_pnp = jax.random.split(rng_)
    m16 = S.jm[16]

    @jax.jit
    def query(v, b, r):
        out = m16.apply(v, b, r, method=m16.localize_forward)
        ctx, q2d, desc, pts, ndc, m = m16.apply(v, b, jax.random.split(r)[0],
                                                method=m16.localize_parts)
        return out, ctx, {k: q2d[k] for k in ("feat_coarse", "feat_fine")}, desc, pts, ndc

    out, ctx, q2d, desc, pts, ndc = query(S.variables, S.batch, rng_)
    P = S.pm[16].n_coarse_points(S.tbatch)
    kp = np.asarray(jax.random.gumbel(rng_kp, (P,), dtype=JBF).astype(jnp.float32))
    pnp = np.asarray(jax.random.gumbel(
        rng_pnp, (S.cfg.shapes.pnp_hypotheses, out["mkps2d"].shape[0]), dtype=jnp.float32))
    return dict(out=out, ctx=ctx, q2d=q2d, desc=desc, pts=pts, ndc=ndc, kp=kp, pnp=pnp)


def test_scene_context_bf16(S):
    """build_context at bf16 from the query batch (deep, c = 1): the ray
    features, the points' descriptors, keypoint scores and confidences,
    the adapted feature maps. Measured: 0.20-0.65 of JAX's distance."""
    j = S.jax(lambda m, b: m.build_context(b)[0], S.batch)
    p = S.port(lambda m, b: m.build_context(b)[0], S.tbatch)
    fields = {"vis_featmaps": lambda c: c.sv.vis_featmaps,
              "coarse.feature": lambda c: c.coarse.feature,
              "coarse.kp_score": lambda c: c.coarse.kp_score,
              "fine.confidence": lambda c: c.fine.confidence,
              "feat_fine_src": lambda c: c.feat_fine_src}
    for name, get in fields.items():
        assert get(p[16]).dtype == BF and get(j[16]).dtype == JBF, name
        check(f"context {name}", {d: get(p[d]) for d in p}, {d: get(j[d]) for d in j}, 1.0)


def f32tree(tree):
    """A JAX pytree with its floating arrays cast to f32: a stage's f32
    reference runs on the bf16 stage inputs, cast."""
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def test_coarse_descriptors_bf16(S, Q):
    """query_coarse on JAX's bf16 scene context with JAX's bf16 Gumbel
    noise (c = 0.5). The f32 references take the same keypoints in the same
    order (JAX through query_coarse's explicit points, the port through
    noise that ranks them first). Measured: 0.42."""
    rng_kp = jax.random.split(jax.random.PRNGKey(0))[0]
    n = S.cfg.matching.fine_num_3d_keypoints
    m16 = S.jm[16]
    desc16, pts, _ = jit_apply(m16, lambda m, c: m.model_3d.query_coarse(c, None, rng_kp))(
        S.variables, Q["ctx"])
    _, _, idx = jit_apply(m16, lambda m, c: m.model_3d.sample_keypoints(c, rng_kp, n))(
        S.variables, Q["ctx"])
    ctx32 = f32tree(Q["ctx"])
    desc32 = jit_apply(S.jm[32], lambda m, c, p: m.model_3d.query_coarse(c, p)[0])(
        S.variables, ctx32, pts)
    forced = np.full(Q["kp"].shape, -1e6, np.float32)
    forced[np.asarray(idx)] = 1e6 - np.arange(n, dtype=np.float32) * 1e3
    with torch.no_grad():
        p16 = S.pm[16].model_3d.query_coarse(port_context(S.pm[16], Q["ctx"]), t(Q["kp"]))
        p32 = S.pm[32].model_3d.query_coarse(port_context(S.pm[32], ctx32), t(forced))
    assert p16[0].dtype == BF
    np.testing.assert_array_equal(p16[1].numpy(), np.asarray(pts))
    np.testing.assert_array_equal(p32[1].numpy(), np.asarray(pts))
    yardstick("desc_3d", p16[0], desc16, desc32, p32[0], 0.5)


def test_score_matrix_and_matches_bf16(S, Q):
    """match on JAX's bf16 context, descriptors and keypoints: the score
    matrix (c = 0.5; bf16 on both sides), then mutual nearest matches from
    JAX's own score matrix, which must be equal. Measured: 0.00."""
    def jfn(m, c, q2d, desc, pts, ndc):
        q = dict(q2d, stride_coarse=8, stride_fine=4)
        return m.match(c, q, S.batch, desc, pts, ndc, False)["score_matrix"]
    args = (Q["ctx"], Q["q2d"], Q["desc"], Q["pts"], Q["ndc"])
    j = {16: jit_apply(S.jm[16], jfn)(S.variables, *args),
         32: jit_apply(S.jm[32], jfn)(S.variables, *f32tree(args))}

    def pfn(m, c, q2d, desc, pts, ndc):
        q = {k: t(v) for k, v in q2d.items()}
        q.update(stride_coarse=8, stride_fine=4)
        return m.match(port_context(m, c), q, S.tbatch, t(desc), t(pts), t(ndc))["score_matrix"]
    with torch.no_grad():
        p = {16: pfn(S.pm[16], *args), 32: pfn(S.pm[32], *f32tree(args))}
    assert p[16].dtype == BF and j[16].dtype == JBF
    check("score_matrix", p, j, 0.5)
    jj, jm = j_mutual(j[16], S.cfg.matching.thr)
    tj, tm = t_mutual(t(j[16]), S.cfg.matching.thr)
    assert np.array_equal(tj.numpy(), np.asarray(jj))
    assert np.array_equal(tm.numpy(), np.asarray(jm))


def test_localize_forward_bf16_end_to_end(S, Q):
    """The whole query at bf16 with JAX's noise: every floating output has
    JAX's dtype (score_matrix bf16, the rest f32; the integer outputs keep
    the port's f32 dtypes), the pose is a rotation. The
    share of equal match_j is recorded, not bound (bf16 moves the scores
    by a quarter of their scale). Measured: 0.94 of match_j equal."""
    with torch.no_grad():
        out = S.pm[16].localize_forward(S.tbatch, kp_gumbel=t(Q["kp"]), pnp_gumbel=t(Q["pnp"]))
    for k, v in Q["out"].items():
        if jnp.issubdtype(v.dtype, jnp.floating):
            assert str(out[k].dtype).split(".")[-1] == str(v.dtype), (k, out[k].dtype, v.dtype)
    assert out["score_matrix"].dtype == BF and out["pose"].dtype == torch.float32
    R = out["pose"][:3, :3].double().numpy()
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
    assert abs(np.linalg.det(R) - 1.0) < 1e-5
    same = float(np.mean(out["match_j"].numpy() == np.asarray(Q["out"]["match_j"])))
    print(f"match_j equal to JAX's: {same:.3f}")


def _guided(cfg):
    return dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, N_samples=4, N_importance=4, N_guide=8))


@pytest.mark.parametrize("kind", ["dense", "guided"])
def test_render_rays_bf16(S, Q, kind):
    """render_rays on JAX's bf16 scene context (deep, c = 1), dense S=8 and
    guided 4+4 (N_guide 8), 24 rays of the query view: rgb, depth and the
    weights. Measured: rgb 0.62-0.64, depth 0.63-0.70, weights 0.56-0.83."""
    from nerfloc_tpu.geometry import cameras as jcam
    cfg = S.cfg if kind == "dense" else _guided(S.cfg)
    jm = {32: JaxEstimator(cfg), 16: JaxEstimator(cfg, dtype=JBF)}
    pm = {32: NerfPoseEstimator(port_cfg(cfg), device="cpu", seed=2),
          16: NerfPoseEstimator(port_cfg(cfg), device="cpu", seed=2, dtype=BF)}
    for m in pm.values():
        load_flax_variables(m, to_numpy(S.variables))
    b = S.np_batch
    H, W = b["image"].shape[:2]
    uv = np.stack([rng(30).uniform(0, W - 1, N_RAYS),
                   rng(31).uniform(0, H - 1, N_RAYS)], -1).astype(np.float32)
    ro, rd = jcam.rays_for_pixels(jnp.asarray(uv), S.batch["K"], S.batch["pose"])
    ctx = {16: Q["ctx"], 32: f32tree(Q["ctx"])}
    j = {d: jax.jit(lambda v, c, a, r, m=m: m.apply(v, method=lambda mm: mm.model_3d.render_rays(
        c, a, r, S.batch["pose"], False)))(S.variables, ctx[d], ro, rd)
        for d, m in jm.items()}
    with torch.no_grad():
        p = {d: m.model_3d.render_rays(port_context(m, ctx[d]), t(ro), t(rd),
                                       S.tbatch["pose"]) for d, m in pm.items()}
    for k in ("rgb", "depth", "weights"):
        assert p[16][k].dtype == torch.float32 and j[16][k].dtype == jnp.float32
        check(f"render {kind} {k}", {d: p[d][k] for d in p}, {d: j[d][k] for d in j}, 1.0)
    assert torch.equal(p[16]["mask"], t(j[16]["mask"]))


def test_render_image_bf16_is_finite(S, Q):
    """render_image at bf16 over an 8x8 frame of the query camera."""
    m = S.pm[16]
    with torch.no_grad():
        ctx = port_context(m, Q["ctx"])
        out = m.model_3d.render_image(ctx, S.tbatch["K"] / 4, S.tbatch["pose"], 8, 8)
    assert out["rgb"].shape == (8, 8, 3)
    for k in ("rgb", "depth"):
        assert bool(torch.isfinite(out[k]).all()), k
