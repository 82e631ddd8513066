"""The render options that are off by default, the port against the JAX
package on the CPU at `__graft_entry__._tiny_cfg()` (V=3 at 32x32, dense
S=8, 24 rays): knn_mode 'flat' and 'ray' (gather and one-hot assembly),
the merged render table, int8 tables and view pruning, and the ops behind
them.

Both packages run the same seeded weights (`_torch_parity.seeded_variables`:
no JAX init is compiled) with render.fused_query_agg off, JAX's default
and pure XLA; the port's CPU path then takes the same unfused formulation,
and tests/test_torch_fused_agg.py holds the fused tail. Each option's JAX
scene context comes from JAX's build_context under that option; the port
builds its own tables from that context's fields
(ConditionalNeRF.assemble_context), so only the option's render path is
compared. Bounds: rendered outputs within 1e-4 of their scale (f32), masks
and neighbour indices exact. Where the JAX package's order of exactly
tied keys is left to its sort (approx_min_k's top-C selection; the flat
KNN's approx_min_k), the port takes the lower index, and the comparison
allows any member of the tied group at that place.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from nerfloc_tpu.geometry import cameras as jcam
from nerfloc_tpu.models.pose_estimator import NerfPoseEstimator as JaxEstimator
from nerfloc_tpu.ops import interp as jinterp
from nerfloc_tpu_torch.models.fields.projector import compute_projections
from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
from nerfloc_tpu_torch.ops import interp as tinterp
from nerfloc_tpu_torch.ops import knn as tknn
from nerfloc_tpu_torch.weights import load_flax_variables

from _torch_parity import CPU, port_cfg, port_context, seeded_variables, t

jknn = importlib.import_module("nerfloc_tpu.ops.knn")

N_RAYS = 24
OPTIONS = {
    "flat": dict(knn_mode="flat"),
    "ray": dict(knn_mode="ray"),
    "ray_onehot": dict(knn_mode="ray", geo_assembly="onehot"),
    "merged": dict(use_merged_table=True),
    "int8": dict(table_dtype="int8"),
    "prune2": dict(prune_views=2),
}


def close(got, want, rel=1e-4):
    """|got - want| <= rel * max(1, max|want|) elementwise."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def option_cfg(cfg, **render):
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **render))


class OptionSetup:
    """Seeded weights, the tiny batch and rays, and per option: the JAX
    model and its scene context, the port model and its context."""

    def __init__(self):
        self.cfg = graft._tiny_cfg()
        self.np_batch = graft._tiny_batch()
        self.batch = {k: jnp.asarray(v) for k, v in self.np_batch.items()}
        self.tbatch = to_device_batch(self.np_batch, CPU)
        self.variables = seeded_variables(JaxEstimator(self.cfg), self.batch,
                                          jax.random.PRNGKey(0), seed=7)
        np_vars = jax.tree.map(np.asarray, self.variables)
        H, W = self.np_batch["image"].shape[:2]
        r = np.random.default_rng(30)
        uv = np.stack([r.uniform(0, W - 1, N_RAYS), r.uniform(0, H - 1, N_RAYS)],
                      -1).astype(np.float32)
        ro, rd = jcam.rays_for_pixels(jnp.asarray(uv), self.batch["K"], self.batch["pose"])
        self.rays = (np.asarray(ro), np.asarray(rd))
        self.jax, self.port, ctx_by_tables = {}, {}, {}
        for name, opt in {"proj": {}, **OPTIONS}.items():
            cfg = option_cfg(self.cfg, **opt)
            jm = JaxEstimator(cfg)
            # the knn mode and the assembly do not change the context's tables
            tables = (cfg.render.use_merged_table, cfg.render.table_dtype,
                      cfg.render.prune_views)
            if tables not in ctx_by_tables:
                ctx_by_tables[tables] = jax.jit(
                    lambda v, b, m=jm: m.apply(v, b, method=m.build_context)[0])(
                        self.variables, self.batch)
            tm = NerfPoseEstimator(port_cfg(cfg), device="cpu", seed=1)
            assert load_flax_variables(tm, np_vars) == []
            self.jax[name] = (jm, ctx_by_tables[tables])
            self.port[name] = (tm, port_context(tm, ctx_by_tables[tables]))

    def jax_render(self, name):
        m, ctx = self.jax[name]
        run = jax.jit(lambda v, c, o, d, p: m.apply(
            v, method=lambda mm: mm.model_3d.render_rays(c, o, d, p)))
        out = run(self.variables, ctx, *map(jnp.asarray, self.rays), self.batch["pose"])
        return {k: np.asarray(v) for k, v in out.items()}

    def samples(self):
        """The port's z_vals [R, S], sample points [R*S, 3] and projection
        for the rays (dense sampling)."""
        m, ctx = self.port["proj"]
        ro, rd = map(t, self.rays)
        z = m.model_3d.ray_depths(ctx, ro, rd)[0]
        xyz = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(-1, 3)
        H, W = ctx.sv.images.shape[1:3]
        return z, xyz, compute_projections(xyz, ctx.sv.Ks, ctx.sv.poses, H, W)


@pytest.fixture(scope="module")
def O():
    return OptionSetup()


def assert_sets_equal_up_to_ties(got_cand, want_cand, keys):
    """Per row, the candidate sets are equal, or differ only in members
    whose key equals the row's largest selected key (a tie across the
    C-th place)."""
    for g, w, k in zip(got_cand, want_cand, keys):
        diff = set(g.tolist()) ^ set(w.tolist())
        if diff:
            kth = k[g].max()
            assert all(k[i] == kth for i in diff), (sorted(diff), kth)


# -- ops ---------------------------------------------------------------------

def test_split_bf16x3_bit_equal_and_its_vjp():
    r = np.random.default_rng(1)
    x = (r.standard_normal(2000) * np.exp(3 * r.standard_normal(2000))).astype(np.float32)
    want = jax.jit(jknn.split_bf16x3)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tknn.split_bf16x3(xt)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert np.array_equal(g.detach().float().numpy().view(np.int32),
                              np.asarray(w.astype(jnp.float32)).view(np.int32))
    # hi + mid + lo recovers x to 2^-22 of its scale (tests/test_knn_proj.py)
    recon = sum(p.float() for p in got).detach().numpy()
    assert np.abs(recon - x).max() <= np.abs(x).max() * 2 ** -22
    c = [r.standard_normal(2000).astype(np.float32) for _ in range(3)]
    gw = jax.grad(lambda a: sum(jnp.sum(p.astype(jnp.float32) * ci) for p, ci in
                                zip(jknn.split_bf16x3(a), c)))(jnp.asarray(x))
    sum(torch.sum(p.float() * torch.from_numpy(ci)) for p, ci in zip(got, c)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gw), rtol=0, atol=1e-6)


@pytest.mark.parametrize("M,tile", [(192, 8192), (300, 64)], ids=["one_tile", "two_tiles"])
@pytest.mark.parametrize("onehot,sd", [(False, "bfloat16"), (True, "bfloat16"),
                                       (False, "float32")],
                         ids=["idx", "candidates", "f32_selection"])
def test_knn_rays_matches_jax(M, tile, onehot, sd):
    """bf16 selection as the render path runs it (and the f32 one, the
    function's default): the neighbours equal, the candidate sets equal
    up to a tie at the C-th key."""
    r = np.random.default_rng(M)
    R, S, C = 24, 8, 128
    ro = r.standard_normal((R, 3)).astype(np.float32)
    rd = r.standard_normal((R, 3)).astype(np.float32)
    z = np.sort(r.uniform(1, 3, (R, S)), 1).astype(np.float32)
    pts = (2 * r.standard_normal((M, 3))).astype(np.float32)
    mask = r.uniform(size=M) > 0.1
    want = jax.jit(lambda *a: jknn.knn_rays(
        *a[:4], K=8, points_mask=a[4], n_candidates=C, tile=tile,
        selection_dtype=jnp.dtype(sd), return_candidates=onehot))(ro, rd, z, pts, mask)
    args = [torch.from_numpy(a) for a in (ro, rd, z, pts)]
    got = tknn.knn_rays(*args, K=8, points_mask=torch.from_numpy(mask), n_candidates=C,
                        tile=tile, selection_dtype=getattr(torch, sd),
                        return_candidates=onehot)
    if not onehot:
        assert np.array_equal(got.numpy(), np.asarray(want))
        return
    idx, cand, local = got
    assert np.array_equal(idx.numpy(), np.asarray(want[0]))
    assert torch.equal(torch.gather(cand[:, None, :].expand(R, S, C), 2, local), idx)
    keys = tknn.ray_segment_keys(*args, torch.from_numpy(mask), torch.bfloat16)(0, M)
    keys = torch.cat([keys, torch.full((R, C), 3e38).to(keys.dtype)], 1).float().numpy()
    assert_sets_equal_up_to_ties(cand.numpy(), np.asarray(want[1]), keys)


def test_knn_from_candidate_planes_matches_jax():
    r = np.random.default_rng(2)
    V, N, O = 3, 200, 25
    xyz = r.standard_normal((N, 3)).astype(np.float32)
    planes = [r.standard_normal((V, N, O)).astype(np.float32) for _ in range(3)]
    valid = r.uniform(size=(V, N, O)) > 0.2
    idx = r.integers(0, 1000, (V, N, O)).astype(np.int32)
    want = jax.jit(lambda *a: jknn.knn_from_candidate_planes(*a, 8))(xyz, *planes, valid, idx)
    got = tknn.knn_from_candidate_planes(*map(torch.from_numpy, (xyz, *planes, valid, idx)), 8)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_tiled_knn_equals_untiled_and_jax(monkeypatch):
    """Integer-grid clouds tie at almost every distance: the tiled KNN
    equals the untiled one bit for bit, ties in index order; against JAX
    the distances are equal and so is every index whose distance is not
    tied within its row."""
    r = np.random.default_rng(3)
    q = r.integers(0, 4, (300, 3)).astype(np.float32)
    p = r.integers(0, 4, (5000, 3)).astype(np.float32)
    mask = r.uniform(size=5000) > 0.2
    args = (torch.from_numpy(q), torch.from_numpy(p), 8, torch.from_numpy(mask))
    d0, i0 = tknn.knn(*args)
    monkeypatch.setattr(tknn, "KNN_TILE", 512)
    monkeypatch.setattr(tknn, "KNN_QUERY_CHUNK", 64)
    d1, i1 = tknn.knn(*args)
    assert torch.equal(d0, d1) and torch.equal(i0, i1)
    jd, ji = jax.jit(lambda a, b, m: jknn.knn(a, b, 8, m))(q, p, mask)
    assert np.array_equal(d0.numpy(), np.asarray(jd))
    d = d0.numpy()
    # every index agrees where its distance is unique in the row
    untied = np.array([[(d[i] == d[i, k]).sum() == 1 for k in range(8)]
                       for i in range(d.shape[0])])
    assert np.array_equal(i0.numpy()[untied], np.asarray(ji)[untied])
    # and the port's tie order is by index
    for i in range(d.shape[0]):
        for k in range(7):
            if d[i, k] == d[i, k + 1]:
                assert i0[i, k] < i0[i, k + 1]


def test_quantized_tables_match_jax():
    r = np.random.default_rng(4)
    V, H, W, C = 3, 8, 8, 16
    feats = r.standard_normal((V, H, W, C)).astype(np.float32) * np.linspace(
        0.1, 3, C, dtype=np.float32)
    jq = jax.jit(jinterp.quantize_pack_bilinear_corners, static_argnums=1)(
        jnp.asarray(feats), jnp.float32)
    tq = tinterp.quantize_pack_bilinear_corners(torch.from_numpy(feats), torch.float32)
    assert tq.q.dtype == torch.int8
    assert np.array_equal(tq.q.numpy(), np.asarray(jq.q))
    assert np.array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    uv = np.stack([r.uniform(-1, W, (V, 50)), r.uniform(-1, H, (V, 50))], -1).astype(np.float32)
    want = jax.jit(lambda q, u: jinterp.packed_bilinear_sample_views(q, H, W, u))(jq, uv)
    close(tinterp.packed_bilinear_sample_views(tq, H, W, torch.from_numpy(uv)), want, 1e-6)
    # the dequantized sample stays within half a step of the f32 one
    # (tests/test_render_table.py's bound)
    f32 = tinterp.packed_bilinear_sample_views(
        tinterp.pack_bilinear_corners(torch.from_numpy(feats)), H, W, torch.from_numpy(uv))
    amax = np.abs(feats).max(axis=(0, 1, 2))
    err = np.abs(tinterp.packed_bilinear_sample_views(tq, H, W, torch.from_numpy(uv)).numpy()
                 - f32.numpy())
    assert (err <= amax / 254.0 * 1.05 + 1e-6).all()


@pytest.mark.parametrize("table", ["f32", "int8"])
def test_packed_bilinear_sample_selected_matches_jax(table):
    r = np.random.default_rng(5)
    V, H, W, C, N, k = 4, 8, 10, 12, 60, 2
    feats = r.standard_normal((V, H, W, C)).astype(np.float32)
    jt = jinterp.pack_bilinear_corners(jnp.asarray(feats))
    tt = tinterp.pack_bilinear_corners(torch.from_numpy(feats))
    if table == "int8":
        jt = jinterp.quantize_pack_bilinear_corners(jnp.asarray(feats), jnp.float32)
        tt = tinterp.quantize_pack_bilinear_corners(torch.from_numpy(feats), torch.float32)
    uv = np.stack([r.uniform(-1, W, (N, k)), r.uniform(-1, H, (N, k))], -1).astype(np.float32)
    sel = r.integers(0, V, (N, k)).astype(np.int32)
    want = jax.jit(lambda tb, u, s: jinterp.packed_bilinear_sample_selected(tb, H, W, u, s))(
        jt, uv, sel)
    got = tinterp.packed_bilinear_sample_selected(tt, H, W, torch.from_numpy(uv),
                                                  torch.from_numpy(sel).long())
    close(got, want, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_table_matches_jax(dtype):
    """pack_render_table bit-equal, and sample_render_table's fused samples
    (f32 within 1e-6 of their scale; bf16, rounded from an f32 blend,
    within one bf16 step, 2^-8 of the scale), candidate planes
    (bit-equal), validity and indices."""
    r = np.random.default_rng(6)
    V, hf, wf, Cf, Hs, Ws, N = 3, 8, 8, 12, 32, 32, 80
    fused = r.standard_normal((V, hf, wf, Cf)).astype(np.float32)
    xyz = r.standard_normal((V, hf, wf, 3)).astype(np.float32)
    mask = r.uniform(size=(V, hf, wf)) > 0.2
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jtab = jax.jit(lambda f, x, m: jinterp.pack_render_table(
        f.astype(jdt), jknn.xyz_window_channels(x, m)))(fused, xyz, mask)
    ttab = tinterp.pack_render_table(torch.from_numpy(fused).to(tdt), tknn.xyz_window_channels(
        torch.from_numpy(xyz), torch.from_numpy(mask)))
    assert ttab.dtype == tdt
    assert np.array_equal(ttab.float().numpy(), np.asarray(jtab.astype(jnp.float32)))
    uv = np.stack([r.uniform(-3, Ws + 2, (V, N)), r.uniform(-3, Hs + 2, (V, N))],
                  -1).astype(np.float32)
    want = jax.jit(lambda tb, u: jinterp.sample_render_table(tb, Cf, Hs, Ws, hf, wf, u))(jtab, uv)
    got = tinterp.sample_render_table(ttab, Cf, Hs, Ws, hf, wf, torch.from_numpy(uv))
    close(got[0], np.asarray(want[0].astype(jnp.float32)),
          1e-6 if dtype == "float32" else 2 ** -8)
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), np.asarray(w))


# -- the render slice under each option --------------------------------------

@pytest.mark.parametrize("name", list(OPTIONS))
def test_render_option_matches_jax(O, name):
    want = O.jax_render(name)
    model, ctx = O.port[name]
    with torch.no_grad():
        got = model.model_3d.render_rays(ctx, *map(t, O.rays), t(O.np_batch["pose"]))
    assert sorted(got) == sorted(want)
    assert np.array_equal(got["mask"].numpy(), want["mask"])
    for k in sorted(set(want) - {"mask"}):
        close(got[k], want[k])


@pytest.mark.parametrize("name", ["flat", "ray", "ray_onehot", "merged"])
def test_render_neighbours_match_jax(O, name):
    """The option's neighbours of the render samples: knn_idx equal to
    JAX's (the flat KNN's up to exactly tied distances), the one-hot
    candidates equal up to a tie at the C-th key."""
    z, xyz, proj = O.samples()
    model, ctx = O.port[name]
    jm, jctx = O.jax[name]
    r = model.cfg.render
    ro, rd = O.rays
    idx, cand, samples = model.model_3d.render_neighbours(ctx, *map(t, O.rays), z, xyz, proj)
    fine_xyz, fine_mask = np.asarray(jctx.fine.xyz), np.asarray(jctx.fine.mask)
    if name == "flat":
        assert idx is None and cand is None and samples is None
        jd, ji = jax.jit(lambda a, b, m: jknn.knn(a, b, 8, m))(xyz.numpy(), fine_xyz, fine_mask)
        td, ti = tknn.knn(xyz, ctx.fine.xyz, 8, ctx.fine.mask)
        assert np.array_equal(td.numpy(), np.asarray(jd))
        d = td.numpy()
        untied = np.array([[(row == row[k]).sum() == 1 for k in range(8)] for row in d])
        assert np.array_equal(ti.numpy()[untied], np.asarray(ji)[untied])
        return
    if name == "merged":
        Hs, Ws = O.np_batch["topk_images"].shape[1:3]
        hf, wf = np.asarray(jctx.feat_fine_src).shape[1:3]
        Cf = np.asarray(jctx.feat_fine_src).shape[-1] + np.asarray(jctx.sv.vis_featmaps).shape[-1]

        def jmerged(tab, x, uv, front):
            f, cx, cy, cz, valid, cidx = jinterp.sample_render_table(tab, Cf, Hs, Ws, hf, wf, uv)
            return jknn.knn_from_candidate_planes(x, cx, cy, cz, valid & front[:, :, None],
                                                  cidx, 8), f
        want, fused = jax.jit(jmerged)(jctx.render_table, xyz.numpy(), proj.uv.numpy(),
                                       proj.in_front.numpy())
        assert np.array_equal(idx.numpy(), np.asarray(want))
        close(samples[1], np.asarray(fused), 1e-6)
        return
    onehot = r.geo_assembly == "onehot"
    want = jax.jit(lambda *a: jknn.knn_rays(
        *a[:4], K=8, points_mask=a[4], n_candidates=r.knn_candidates,
        selection_dtype=jnp.bfloat16, return_candidates=onehot))(
            ro, rd, z.numpy(), fine_xyz, fine_mask)
    want_idx = np.asarray(want[0] if onehot else want).reshape(-1, 8)
    assert np.array_equal(idx.numpy(), want_idx)
    if onehot:
        M = fine_xyz.shape[0]
        keys = tknn.ray_segment_keys(*map(t, O.rays), z, ctx.fine.xyz, ctx.fine.mask,
                                     torch.bfloat16)(0, M).float().numpy()
        assert_sets_equal_up_to_ties(cand[0].numpy(), np.asarray(want[1]), keys)
        nb = model.model_3d.assemble_neighbours(ctx.fine, *cand)
        gathered = model.model_3d.gather_neighbours(ctx.fine, idx)
        for a, b in zip(nb[:3], gathered[:3]):
            # hi + mid + lo against the f32 gather: 2^-22 of the scale
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=float(b.abs().max()) * 2 ** -22)
        assert torch.equal(nb[3], gathered[3])


def test_pruned_render_with_every_view_equals_unpruned(O):
    """prune_views = V reorders the views only: the render equals the
    unpruned one within 2e-4 relative (tests/test_prune_views.py)."""
    cfg = option_cfg(O.cfg, prune_views=3)
    model = NerfPoseEstimator(port_cfg(cfg), device="cpu", seed=1)
    assert load_flax_variables(model, jax.tree.map(np.asarray, O.variables)) == []
    base_model, base_ctx = O.port["proj"]
    with torch.no_grad():
        got = model.model_3d.render_rays(port_context(model, O.jax["prune2"][1]),
                                         *map(t, O.rays), t(O.np_batch["pose"]))
        want = base_model.model_3d.render_rays(base_ctx, *map(t, O.rays),
                                               t(O.np_batch["pose"]))
    for k in ("rgb", "depth", "weights"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=k)
    assert torch.equal(got["mask"], want["mask"])


def test_int8_table_passes_no_gradient_through_rounding():
    """As in JAX, the int8 table's rounding has no straight-through
    gradient: only the per-channel scale (through the channel's amax)
    carries one, so every feature but each channel's largest gets 0."""
    r = np.random.default_rng(8)
    feats = torch.from_numpy(r.standard_normal((2, 6, 6, 4)).astype(np.float32))
    feats.requires_grad_(True)
    uv = torch.from_numpy(r.uniform(0, 5, (2, 30, 2)).astype(np.float32))
    qt = tinterp.quantize_pack_bilinear_corners(feats, torch.float32)
    tinterp.packed_bilinear_sample_views(qt, 6, 6, uv).sum().backward()
    jg = jax.grad(lambda f: jnp.sum(jinterp.packed_bilinear_sample_views(
        jinterp.quantize_pack_bilinear_corners(f, jnp.float32), 6, 6, jnp.asarray(uv.numpy()))))(
            jnp.asarray(feats.detach().numpy()))
    np.testing.assert_allclose(feats.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)
    amax_at = (feats.abs() == feats.abs().amax(dim=(0, 1, 2))).detach()
    assert bool((feats.grad[~amax_at] == 0).all())
