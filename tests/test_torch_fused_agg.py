"""Fused neighbour aggregation: the PyTorch port against the JAX package.

The port's plain `reference_agg` (what CPU tensors run) is held against the
JAX Pallas kernel in interpret mode and against the JAX `reference_agg`,
with the same weights (weights.agg_params_from_flax) and the same inputs
(numpy, seeded). The CUDA kernel itself runs only on a GPU (marked `cuda`).
Tolerances: 2e-4 abs/rel, as tests/test_fused_agg.py holds the Pallas
kernel to the unfused path (f32, different sum orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloc_tpu.models.fields.conditional_nerf import ConditionalNeRF as JaxNeRF
from nerfloc_tpu.ops import fused_agg as jfa
from nerfloc_tpu_torch.models.fields.conditional_nerf import ConditionalNeRF
from nerfloc_tpu_torch.ops import fused_agg as tfa
from nerfloc_tpu_torch.weights import agg_params_from_flax, load_flax_variables

from _torch_parity import port_cfg, t, to_numpy
from test_fields import tiny_cfg, tiny_scene

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(tiny_cfg(), render=dataclasses.replace(
        tiny_cfg().render, fused_query_agg=True))
    jmodel = JaxNeRF(cfg)
    images, depths, poses, Ks, feat_c, feat_f = tiny_scene()
    args = (images, depths, poses, Ks, jnp.float32(0.5), jnp.float32(4.0),
            feat_c, feat_f)
    variables = jax.jit(jmodel.init, static_argnums=(9, 10))(
        jax.random.PRNGKey(0), *args, 8, 4, jax.random.PRNGKey(7))
    jctx = jax.jit(lambda v, *a: jmodel.apply(v, *a, 8, 4,
                                              method="build_scene_context"))(
        variables, *args)
    nerf = ConditionalNeRF(port_cfg(cfg))
    unused = load_flax_variables(nerf, to_numpy(variables))
    with torch.no_grad():
        tctx = nerf.build_scene_context(*[t(a) for a in args], 8, 4)
    return cfg, jmodel, variables, jctx, nerf, tctx, unused


def _inputs(N, K, F, W, seed):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    nb_xyz = (xyz[:, None] + 0.1 * rng.standard_normal((N, K, 3))).astype(np.float32)
    nb_dir = rng.standard_normal((N, K, 4)).astype(np.float32)
    return dict(xyz=xyz, direction=np.ascontiguousarray(nb_dir[:, 0]),
                mv_agg=rng.standard_normal((N, W)).astype(np.float32),
                nb_xyz=nb_xyz, nb_dir=nb_dir,
                nb_feat=rng.standard_normal((N, K, F)).astype(np.float32),
                scale=np.float32(3.5))


def _both(setup, N, K, seed=0):
    cfg, jmodel, variables, *_ = setup
    F = 3 + cfg.backbone2d_fpn_dim
    x = _inputs(N, K, F, cfg.model_3d_hidden_dim, seed)
    freqs = tuple(2.0 ** i for i in range(cfg.multires))
    jp = jfa.extract_agg_params(variables["params"], len(freqs), F)
    tp = agg_params_from_flax(to_numpy(variables["params"]), len(freqs), F)
    tx = {k: t(v) for k, v in x.items()}
    jx = [jnp.asarray(x[k]) for k in ("xyz", "direction", "mv_agg", "nb_xyz",
                                      "nb_dir", "nb_feat", "scale")]
    return x, jx, jp, freqs, tx, tp, torch.tensor(freqs, dtype=torch.float32)


@pytest.mark.parametrize("N,K", [(64, 8), (64, 1), (300, 8), (37, 3)])
def test_reference_agg_matches_pallas_kernel(setup, N, K):
    """N=300 is ragged against the Pallas tile (256)."""
    x, jx, jp, freqs, tx, tp, tfreqs = _both(setup, N, K)
    want = np.asarray(jfa.fused_neighbor_agg(*jx, jp, freqs, jnp.float32))
    got = tfa.reference_agg(**tx, params=tp, freqs=tfreqs).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("N,K", [(64, 8), (64, 1)])
def test_reference_agg_matches_jax_reference(setup, N, K):
    x, jx, jp, freqs, tx, tp, tfreqs = _both(setup, N, K, seed=1)
    want = np.asarray(jfa.reference_agg(*jx, jp, freqs, jnp.float32))
    got = tfa.reference_agg(**tx, params=tp, freqs=tfreqs).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_wrapper_takes_plain_version_on_cpu(setup):
    x, jx, jp, freqs, tx, tp, tfreqs = _both(setup, 16, 8, seed=2)
    launches = tfa.LAUNCHES.n
    got = tfa.fused_neighbor_agg(**tx, params=tp, freqs=tfreqs)
    want = tfa.reference_agg(**tx, params=tp, freqs=tfreqs)
    assert torch.equal(got, want)
    assert tfa.LAUNCHES.n == launches


def test_reference_agg_gradient_matches_jax(setup):
    """The CUDA path's backward replays reference_agg; its gradients must
    be those of the JAX reference (which the JAX custom_vjp replays)."""
    x, jx, jp, freqs, tx, tp, tfreqs = _both(setup, 24, 8, seed=3)
    w = np.random.default_rng(4).standard_normal((24, x["mv_agg"].shape[1]))
    w = w.astype(np.float32)

    def jloss(mv, feat, w1):
        args = list(jx)
        args[2], args[5] = mv, feat
        out = jfa.reference_agg(*args, {**jp, "b_w1": w1}, freqs, jnp.float32)
        return jnp.sum(out * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jx[2], jx[5], jp["b_w1"])
    mv = tx["mv_agg"].clone().requires_grad_(True)
    feat = tx["nb_feat"].clone().requires_grad_(True)
    w1 = tp["b_w1"].clone().requires_grad_(True)
    out = tfa.reference_agg(**{**tx, "mv_agg": mv, "nb_feat": feat},
                            params={**tp, "b_w1": w1}, freqs=tfreqs)
    (out * t(w)).sum().backward()
    for got, want in zip((mv.grad, feat.grad, w1.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("F,feat_dim,rd", [(10, 19, 27), (4, 7, 5)])
def test_emb_perm_matches_jax(F, feat_dim, rd):
    assert tfa.emb_perm(F, feat_dim, rd) == jfa._emb_perm(F, feat_dim, rd)


def test_weight_bridge_covers_the_field(setup):
    *_, unused = setup
    render_only = ("ray_unet", "sigma_mlp", "feat_mlp", "rgb_blending_mlp", "beta_mlp")
    assert all(u.split("/")[1] in render_only for u in unused), unused


def test_scene_context_matches_jax(setup):
    cfg, jmodel, variables, jctx, nerf, tctx, _ = setup
    pairs = [(jctx.coarse.xyz, tctx.coarse.xyz), (jctx.fine.xyz, tctx.fine.xyz),
             (jctx.coarse.feature, tctx.coarse.feature),
             (jctx.fine.direction, tctx.fine.direction),
             (jctx.coarse.kp_score, tctx.coarse.kp_score),
             (jctx.fine.confidence, tctx.fine.confidence),
             (jctx.rgb_packed, tctx.rgb_packed)]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    # NeuRay ray features come out of a 13-conv encoder whose InstanceNorms
    # run over 2x2..8x8 maps at this size, which magnifies f32 sum-order
    # differences; 1e-3 bounds them
    for want, got in ((jctx.sv.vis_featmaps, tctx.sv.vis_featmaps),
                      (jctx.fused_fine_packed, tctx.fused_fine_packed)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-4)
    assert np.array_equal(tctx.fine.mask.numpy(), np.asarray(jctx.fine.mask))


def _port_query(nerf, ctx, xyz, level, K, fused):
    cfg = nerf.cfg
    nerf.cfg = dataclasses.replace(cfg, render=dataclasses.replace(
        cfg.render, fused_query_agg=fused))
    try:
        with torch.no_grad():
            return nerf.query(ctx, xyz, level, K)
    finally:
        nerf.cfg = cfg


@pytest.mark.parametrize("level,K", [("fine", 8), ("fine", 1), ("coarse", 8)])
def test_port_fused_query_matches_unfused(setup, level, K):
    *_, nerf, tctx, _ = setup
    xyz = tctx.fine.xyz[:40] + 0.01
    f = _port_query(nerf, tctx, xyz, level, K, True)
    u = _port_query(nerf, tctx, xyz, level, K, False)
    for k in ("feature_agg", "feature"):
        np.testing.assert_allclose(f[k].numpy(), u[k].numpy(), **TOL)


@pytest.mark.parametrize("level,K", [("fine", 8), ("coarse", 8), ("fine", 1)])
def test_port_query_matches_jax(setup, level, K):
    cfg, jmodel, variables, jctx, nerf, tctx, _ = setup
    xyz = np.asarray(jctx.fine.xyz[:40]) + 0.01
    want = jmodel.apply(variables, jctx, jnp.asarray(xyz), level, K, method="query")
    got = _port_query(nerf, tctx, t(xyz), level, K, True)
    for k in ("feature_agg", "weights"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **TOL)


def _main_width_params(rng, F=195, W=128, NF=10, RD1=16, RD2=27):
    """Seeded weights at the main path's widths, [in, out] layout."""
    fin = F + 3 + 6 * NF + RD2
    shapes = {"rd_w1": (4, RD1), "rd_b1": (RD1,), "rd_w2": (RD1, RD2),
              "rd_b2": (RD2,), "b_w0p": (fin, W), "b_b0": (W,), "b_w1": (W, W),
              "b_b1": (W,), "b_w2": (W, W), "b_b2": (W,), "a_wq": (W, 128),
              "a_wk": (W, 128), "a_wv": (W, 128), "a_wfc": (128, W),
              "ln_s": (W,), "ln_b": (W,)}
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0] if len(s) == 2 else 10)
             ).astype(np.float32) for k, s in shapes.items()}
    p["ln_s"] += 1.0
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _unpack_ring(packed, F, NF, RD2, wgmma):
    """Read the packed buffer back the way the kernel does -> for each
    product a [Kp, 128] matrix (mma.sync layout) or its (big, small) pair
    (wgmma layout).

    mma.sync: for k-step ks, warp w, lane (g, t) and n-tile j, b0 = (k = 8 ks
    + t, n = 32 w + 8 j + g) and b1 = (k + 4, n) sit at float4 (w, j // 2)
    of the k-step, lane slot 4 lane + 2 (j % 2) + {0, 1}. wgmma: each k-step
    holds a big then a small [8, 128] tile of core matrices (k-half kh,
    n-group ng) of 8 n-rows x 4 k: (k = 4 kh + c, n = 8 ng + r) at
    512 kh + 32 ng + 4 r + c."""
    Fp, fin_p = tfa.ring_widths(F, NF, RD2)
    out, base = [], 0
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    kh, ng, r, c = np.meshgrid(np.arange(2), np.arange(16), np.arange(8), np.arange(4),
                               indexing="ij")
    for kp in (fin_p,) + (128,) * 6:
        size = kp * 128 * (2 if wgmma else 1)
        blk = packed[base:base + size]
        base += size
        if wgmma:
            pair = []
            for half in range(2):
                m = np.full((kp, 128), np.nan, np.float32)
                for ks in range(kp // 8):
                    tile = blk[ks * 2048 + half * 1024:ks * 2048 + (half + 1) * 1024]
                    m[8 * ks + 4 * kh + c, 8 * ng + r] = tile[512 * kh + 32 * ng + 4 * r + c]
                pair.append(m)
            out.append(tuple(pair))
            continue
        m = np.full((kp, 128), np.nan, np.float32)
        for ks in range(kp // 8):
            for w in range(4):
                for j in range(4):
                    at = ks * 1024 + w * 256 + (j // 2) * 128 + lane * 4 + 2 * (j % 2)
                    n = 32 * w + 8 * j + g
                    m[8 * ks + t, n] = blk[at]
                    m[8 * ks + t + 4, n] = blk[at + 1]
        out.append(m)
    assert base == packed.shape[0]
    return out


def _padded(params, F, NF, RD2):
    """The seven products zero-padded to the ring's [Kp, 128] (numpy)."""
    W = params["b_b0"].shape[0]
    Fp, fin_p = tfa.ring_widths(F, NF, RD2)
    fin = F + 3 + 6 * NF + RD2
    fc0 = np.zeros((fin_p, 128), np.float32)
    fc0[:F, :W] = params["b_w0p"].numpy()[:F]
    fc0[Fp:Fp + fin - F, :W] = params["b_w0p"].numpy()[F:]
    mats = [fc0]
    for key in tfa.RING_KEYS[1:]:
        want = params[key].numpy()
        m = np.zeros((128, 128), np.float32)
        m[:want.shape[0], :want.shape[1]] = want
        mats.append(m)
    return mats


def _check_ring_round_trip(params, F, NF, wgmma):
    """Every slot is written once; the products (fc0 with its feature rows,
    a zero row up to Fp, then [off | sin | cos | rdfc]) come back, padding
    rows and columns are zero, and wgmma's halves are the 3xTF32 split."""
    RD2 = params["rd_w2"].shape[1]
    packed = tfa.pack_agg_weights(params, F, NF, wgmma=wgmma).numpy()
    for got, want in zip(_unpack_ring(packed, F, NF, RD2, wgmma), _padded(params, F, NF, RD2)):
        if wgmma:
            big, small = got
            want_big = _tf32(torch.from_numpy(want)).numpy()
            np.testing.assert_array_equal(big, want_big)
            np.testing.assert_array_equal(
                small, _tf32(torch.from_numpy(want - want_big)).numpy())
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wgmma", [False, True])
def test_weight_pack_round_trips_main_widths(wgmma):
    """(a) at W=128, F=195: the features pad to 200, fin 285 to 304."""
    params = _main_width_params(np.random.default_rng(0))
    assert tfa.ring_widths(195, 10, 27) == (200, 304)
    _check_ring_round_trip(params, 195, 10, wgmma)


@pytest.mark.parametrize("wgmma", [False, True])
def test_weight_pack_round_trips_module_params(setup, wgmma):
    """(a) from extract_agg_params of the port module (W=32 pads to 128)."""
    cfg, *_, nerf, tctx, _ = setup
    F = 3 + cfg.backbone2d_fpn_dim
    with torch.no_grad():
        params = tfa.extract_agg_params(nerf, F)
    _check_ring_round_trip(params, F, cfg.multires, wgmma)


def test_extract_agg_params_reuses_its_permutation_index(setup):
    """The fc0 row permutation reaches the device once per shape, not per
    query."""
    cfg, *_, nerf, tctx, _ = setup
    F = 3 + cfg.backbone2d_fpn_dim
    tfa._emb_perm_index.cache_clear()
    for _ in range(3):
        tfa.extract_agg_params(nerf, F)
    info = tfa._emb_perm_index.cache_info()
    assert (info.misses, info.hits) == (1, 2)


def _tf32(x):
    """cvt.rna.tf32.f32: round to nearest (ties away) on the int32 view,
    dropping the low 13 mantissa bits."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """The kernel's product: big = rna(x), small = rna(x - big), f32 sum of
    a_s b_b + a_b b_s + a_b b_b, small terms first."""
    ab, bb = _tf32(a), _tf32(b)
    a_s, b_s = _tf32(a - ab), _tf32(b - bb)
    return (a_s @ bb + ab @ b_s) + ab @ bb


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


@pytest.mark.parametrize("K", [1, 8])
def test_3xtf32_products_hold_the_kernel_tolerance(K):
    """(b) The 3xTF32 split keeps reference_agg within the kernel's
    1e-4 + 1e-4 |ref| at W=128, F=195, 10 bands; one TF32 pass is far
    coarser (which is why the kernel splits)."""
    rng = np.random.default_rng(K)
    params = _main_width_params(rng)
    x = {k: t(v) for k, v in _inputs(64, K, 195, 128, seed=10 + K).items()}
    freqs = torch.tensor([2.0 ** i for i in range(10)])
    ref = tfa.reference_agg(**x, params=params, freqs=freqs)
    got = tfa.reference_agg(**x, params=params, freqs=freqs, matmul=_mm_3xtf32)
    err3 = (got - ref).abs()
    assert bool((err3 <= 1e-4 + 1e-4 * ref.abs()).all()), float(err3.max())
    err1 = (tfa.reference_agg(**x, params=params, freqs=freqs,
                              matmul=_mm_1xtf32) - ref).abs()
    assert float(err1.max()) > 20 * float(err3.max())


def test_tf32_rounding_emulation():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                         -(1.0 + 2.0 ** -10), 1.0])
    assert torch.equal(_tf32(x), want)


@pytest.mark.parametrize("N", [1, 1000, 1024, 32768, 65536, 262144])
@pytest.mark.parametrize("K", [1, 8])
def test_tile_plan_covers_every_row_once(N, K):
    """(c) CTA b takes samples [b T, min(N, (b + 1) T)): every sample (so
    every row n K + k) lands in exactly one CTA, within its rows; f32 tiles
    stay at 64 rows or fewer, bf16 ones may take the wide tiles."""
    for bf16 in (False, True):
        rows, T = tfa.tile_plan(N, K, n_sm=132, bf16=bf16)
        assert rows in tfa.tile_options(K, bf16) and 1 <= T and T * K <= rows
        assert T == tfa.tile_samples(rows, K, bf16)
        grid = -(-N // T)
        count = np.zeros(N, np.int64)
        starts = np.arange(grid) * T
        np.add.at(count, np.concatenate([np.arange(s, min(N, s + T)) for s in starts]), 1)
        assert (count == 1).all()
        assert grid * T >= N > (grid - 1) * T


@pytest.mark.parametrize("N", [32768, 65536, 262144])
def test_tile_plan_takes_128_row_bf16_tiles_at_the_step_shapes(N):
    """At the refinement, train and render shapes (K=8) the bf16 launch
    takes the 128-row tile, the fastest measured there; f32 stays at 64."""
    assert tfa.tile_plan(N, 8, n_sm=132, bf16=True) == (128, 16)
    assert tfa.tile_plan(N, 8, n_sm=132) == (64, 8)


@pytest.mark.parametrize("K", [1, 3, 8, 12, 64])
def test_wide_tiles_keep_each_sample_in_one_warpgroup(K):
    """bf16 tiles of 64 rows and more are warpgroups of 64 rows, each with
    whole samples (the attention of a sample reads its K rows in its own
    warpgroup): T = (rows / 64) (64 // K); f32 has no such tiles."""
    assert max(tfa.tile_options(K)) == 64
    for rows in tfa.tile_options(K, bf16=True):
        T = tfa.tile_samples(rows, K, bf16=True)
        if rows < tfa.WGMMA_ROWS:
            assert T == rows // K
            continue
        wgs = rows // tfa.WGMMA_ROWS
        assert T % wgs == 0 and (T // wgs) * K <= tfa.WGMMA_ROWS < (T // wgs + 1) * K
    with pytest.raises(ValueError):
        tfa.tile_options(65, bf16=True)


@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("rows,bf16", [(32, False), (64, False), (16, True), (32, True),
                                       (128, True)])
def test_weight_stream_bytes_count_the_packed_ring(K, rows, bf16):
    """weight_stream_bytes: every CTA of the launch reads the packed buffer
    pack_agg_weights builds for its tile once, less the key and query
    products when K = 1 (the kernel skips them); a cluster tile (bf16
    below 64 rows) reads the f32 weights of the products it runs once for
    its CLUSTER_CTAS CTAs, and the grid is rounded up to whole clusters."""
    params = _main_width_params(np.random.default_rng(1))
    N = 5000
    cs = tfa.tile_cluster(rows, bf16)
    if cs:
        keys = [k for k in tfa.RING_KEYS if K > 1 or k not in ("a_wk", "a_wq")]
        per_cluster = sum(params[k].numel() * 4 for k in keys)
        clusters = -(-(-(-N // tfa.tile_samples(rows, K, bf16))) // cs)
        assert tfa.weight_stream_bytes(N, K, rows, 195, 10, 27, bf16) == clusters * per_cluster
        return
    packed = tfa.pack_agg_weights(params, 195, 10, wgmma=rows >= tfa.WGMMA_ROWS,
                                  dtype=torch.bfloat16 if bf16 else torch.float32)
    per_cta = packed.numel() * packed.element_size()
    if K == 1:
        per_cta -= 2 * 128 * 128 * packed.element_size() * (2 if rows >= 64 and not bf16 else 1)
    grid = -(-N // tfa.tile_samples(rows, K, bf16))
    assert tfa.weight_stream_bytes(N, K, rows, 195, 10, 27, bf16) == grid * per_cta


@pytest.mark.parametrize("N,K,rows", [
    (1024, 8, 64), (1000, 8, 64), (1001, 8, 64), (37, 8, 16), (1024, 1, 16), (1000, 1, 16),
    (999, 1, 16), (37, 1, 16), (256, 8, 32), (384, 8, 32), (512, 8, 32), (700, 8, 32),
    (900, 8, 64), (100, 12, 16), (200, 12, 32), (300, 3, 16), (2048, 1, 32), (4096, 1, 32),
    (6000, 1, 32), (8192, 1, 64), (32768, 1, 128)])
def test_bf16_query_plan_covers_every_row_once(N, K, rows):
    """The bf16 plan of launches up to a query's size (N=1024 keypoints,
    K=8 and K=1, ragged N, K=3 and 12): on the H100 (132 SMs) it takes,
    among this kernel's tiles, the one measured fastest at each shape timed
    (PERF.md, tools/compare_fused_agg.py --shapes): a cluster tile while
    its clusters hold about a CTA an SM, 16 rows before 32, then the wide
    tiles. A cluster tile's grid is whole clusters of CLUSTER_CTAS (the
    CTAs past N, fewer than a cluster, hold weights only); CTA b takes
    samples [b T, min(N, (b + 1) T)) of its own rows, so every sample lands
    in exactly one CTA."""
    assert tfa.tile_plan(N, K, n_sm=132, bf16=True) == (rows, tfa.tile_samples(rows, K, True))
    T = tfa.tile_samples(rows, K, True)
    cs = tfa.tile_cluster(rows, bf16=True)
    assert cs == (tfa.CLUSTER_CTAS if rows < tfa.WGMMA_ROWS else 0)
    ctas = tfa.cluster_ctas(N, K, rows, cs) if cs else -(-N // T)
    assert ctas % max(cs, 1) == 0 and 0 <= ctas - -(-N // T) < max(cs, 1)
    count = np.zeros(N, np.int64)
    for b in range(ctas):
        np.add.at(count, np.arange(b * T, min(N, (b + 1) * T)), 1)
    assert (count == 1).all()


def test_cluster_ctas_hold_disjoint_column_blocks():
    """Each CTA of a cluster holds the weights of its own columns
    (fused_agg_cluster's load_share places them as pack_agg_weights places
    the mma.sync layout, k-step by k-step): CTA c's 32-column block c of
    every k-step holds the columns [32 c, 32 c + 32) and no other, so the
    CTAs' shares are disjoint and cover every weight once; and warp w of
    any CTA, reading lane l's 16 bytes at half w % 2 of CTA w // 2, gets
    the B fragments of its columns [16 w, 16 w + 16)."""
    cs = tfa.CLUSTER_CTAS
    F, NF = 195, 10
    params = _main_width_params(np.random.default_rng(2))
    # every weight is its column + 1 (exact in bf16; padding stays 0)
    col = {k: torch.arange(1, v.shape[-1] + 1, dtype=torch.float32).expand_as(v).contiguous()
           if v.dim() == 2 else v for k, v in params.items()}
    packed = tfa.pack_agg_weights(col, F, NF, dtype=torch.bfloat16).float()
    blocks = packed.view(-1, cs, 2, 32, 8)   # [k-step, CTA, half, lane, 8 bf16]
    seen = set()
    for c in range(cs):
        vals = set(blocks[:, c].unique().tolist()) - {0.0}
        assert vals == set(float(v) for v in range(32 * c + 1, 32 * c + 33))
        assert not vals & seen
        seen |= vals
    assert seen == set(float(v) for v in range(1, 129))
    g = torch.arange(32) // 4
    for w in range(8):
        frag = blocks[:, w // 2, w % 2]   # [k-step, lane, 8]
        for jl in range(2):   # the bf16 (jl, kh, e): n-tile jl's column is 16 w + 8 jl + g
            cols = frag[:, :, 4 * jl:4 * jl + 4]
            nz = cols != 0
            want = (16 * w + 8 * jl + g + 1).float()[None, :, None].expand_as(cols)
            assert torch.equal(cols[nz], want[nz]), (w, jl)


@pytest.mark.cuda
@pytest.mark.parametrize("N,K", [(1024, 8), (1024, 1), (1000, 8), (262144, 8)])
def test_cuda_kernel_matches_reference(setup, N, K):
    """Runs on a GPU only: the hand-written kernel vs the plain version
    (on the card, TF32 off), at every tile size the shape admits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    x, jx, jp, freqs, tx, tp, tfreqs = _both(setup, N, K, seed=5)
    dev = torch.device("cuda")
    cx = {k: v.to(dev) for k, v in tx.items()}
    cp = {k: v.to(dev) for k, v in tp.items()}
    want = tfa.reference_agg(**cx, params=cp, freqs=tfreqs.to(dev))
    plans = [0] if N > 100_000 else [0, *tfa.tile_options(K)]
    for rows in plans:
        got = tfa.launch(**cx, params=cp, freqs=tfreqs.to(dev), rows=rows)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [65536, 32768, 262144])
def test_cuda_bf16_wide_tiles_match_kernel_agg(N):
    """Runs on a GPU only: the bf16 instantiation at the train (N=65536),
    refinement (N=32768) and render (N=262144) shapes, K=8, main widths,
    at every wgmma tile (64 and 128 rows), against its plain version
    kernel_agg: within 0.2x (RMS) and 1.0x (max) of kernel_agg's own
    distance from the f32 reference_agg, as chip_smoke.py holds it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    params = {k: v.to(dev) for k, v in _main_width_params(np.random.default_rng(N)).items()}
    x = {k: t(v).to(dev) for k, v in _inputs(N, 8, 195, 128, seed=N).items()}
    freqs = torch.tensor([2.0 ** i for i in range(10)], device=dev)
    xb = dict(x, mv_agg=x["mv_agg"].to(torch.bfloat16), nb_feat=x["nb_feat"].to(torch.bfloat16))
    want = tfa.kernel_agg(**xb, params=params, freqs=freqs)
    yard = want - tfa.reference_agg(**x, params=params, freqs=freqs)
    for rows in [r for r in tfa.tile_options(8, bf16=True) if r >= tfa.WGMMA_ROWS]:
        err = tfa.launch(**xb, params=params, freqs=freqs, rows=rows) - want
        assert bool(torch.isfinite(err).all())
        assert float(err.pow(2).mean().sqrt()) <= 0.2 * float(yard.pow(2).mean().sqrt()), rows
        assert float(err.abs().max()) <= float(yard.abs().max()), rows


@pytest.mark.cuda
@pytest.mark.parametrize("N,K", [(1024, 8), (1024, 1), (1000, 8), (300, 3), (100, 12),
                                 (999, 1), (1001, 8), (512, 8), (200, 12)])
def test_cuda_bf16_query_tiles_match_kernel_agg(N, K):
    """Runs on a GPU only: the bf16 instantiation at the query shapes (N=1024
    keypoints, K=8 and K=1), ragged N (999 and 1001 leave a partial last
    tile and CTAs past N that only hold weights, at 16 and 32 rows), K=3
    and 12, and the small K > 1 launches that take the 32-row cluster tile,
    main widths, at the plan's tile and every tile the launch can take,
    against kernel_agg as chip_smoke.py holds it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    params = {k: v.to(dev) for k, v in _main_width_params(np.random.default_rng(N + K)).items()}
    x = {k: t(v).to(dev) for k, v in _inputs(N, K, 195, 128, seed=N + K).items()}
    freqs = torch.tensor([2.0 ** i for i in range(10)], device=dev)
    xb = dict(x, mv_agg=x["mv_agg"].to(torch.bfloat16), nb_feat=x["nb_feat"].to(torch.bfloat16))
    want = tfa.kernel_agg(**xb, params=params, freqs=freqs)
    yard = want - tfa.reference_agg(**x, params=params, freqs=freqs)
    for rows in [0, *tfa.tile_options(K, bf16=True)]:
        err = tfa.launch(**xb, params=params, freqs=freqs, rows=rows) - want
        assert bool(torch.isfinite(err).all())
        assert float(err.pow(2).mean().sqrt()) <= 0.2 * float(yard.pow(2).mean().sqrt()), rows
        assert float(err.abs().max()) <= float(yard.abs().max()), rows
