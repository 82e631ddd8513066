"""Data and ray parallelism of the PyTorch port over torch.distributed, on
the CPU: ranks are processes of a gloo group (tests/_torch_ranks.py, which
imports no JAX), the JAX references run on this process's virtual CPU
devices (tests/conftest.py).

  * process_shard_indices, shard_batch's rows and allgather_metrics against
    the JAX package's on the 7-query fixture of tests/test_multihost.py
    (JAX's gather emulated in one process: its process_allgather returns
    both processes' payloads);
  * 2 ranks of the data-parallel train step at a global batch of 2, 2
    steps, against one process at B=2: ranks bit-equal, parameters within
    1e-6 relative per leaf (the one-process step against JAX's mesh step
    is tests/test_torch_parallel_step.py);
  * render_image_ray_sharded over a (1, 2) mesh and the batched render
    over a (2, 2) mesh against JAX's parallel/render.py on the same scene
    contexts, within 1.2e-5 of the output's scale (max(1, max |want|));
  * eval_dataset on 2 ranks equals 1 rank (per-query noise by index), with
    the poses and file names; fewer items than ranks raises;
  * cli.train on 2 ranks for two epochs and a resumed third, and cli.test
    on 2 ranks with --ray_shards 2, on tiny written scenes, against one
    process.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from nerfloc_tpu.geometry.cameras import rays_for_pixels
from nerfloc_tpu.parallel import multihost as jmultihost
from nerfloc_tpu.parallel.mesh import MeshSpec as JMeshSpec
from nerfloc_tpu.parallel.mesh import make_mesh as j_make_mesh
from nerfloc_tpu.parallel.mesh import shard_batch as j_shard_batch
from nerfloc_tpu.parallel.render import (make_batched_ray_sharded_render as j_batched_render,
                                         make_context_builder as j_context_builder,
                                         render_image_ray_sharded as j_render_image)
from nerfloc_tpu_torch.data import device_batch, make_query_batch, stack_batches
from nerfloc_tpu_torch.data.synthetic import SCENE_VARIANTS, write_scene
from nerfloc_tpu_torch.models.fields.aggregator import SupportViews
from nerfloc_tpu_torch.models.fields.context import NeuralPoints
from nerfloc_tpu_torch.parallel.mesh import Mesh, MeshSpec, make_mesh, shard_batch
from nerfloc_tpu_torch.parallel.multihost import process_shard_indices
from nerfloc_tpu_torch.parallel.render import make_ray_sharded_render

from _torch_parity import TinySetup, few_threads, t  # noqa: F401
from _torch_ranks import run_ranks

RENDER_REL = 1.2e-5


def close(got, want, rel):
    """|got - want| <= rel * max(1, max|want|) elementwise."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= rel * scale, f"max error {err} > {rel} * {scale}"
    return err / scale


def leafwise_close(got, want, rel):
    for k, w in want.items():
        d = float((got[k].double() - w.double()).norm())
        assert d <= rel * float(w.double().norm()), (k, d)


@pytest.fixture(scope="module")
def S():
    return TinySetup()


# -- shards and the gather ---------------------------------------------------------

@pytest.mark.parametrize("n_items,nprocs", [(1, 1), (2, 2), (7, 2), (7, 3), (8, 3)])
def test_process_shard_indices_match_jax(n_items, nprocs):
    for rank in range(nprocs):
        assert process_shard_indices(n_items, rank, nprocs) == \
            jmultihost.process_shard_indices(n_items, rank, nprocs)


def test_shard_batch_rows_match_jax():
    """P("data") over 2 devices against this rank's rows; leaves without a
    leading axis that 2 divides are replicated."""
    r = np.random.default_rng(0)
    host = {"image": r.standard_normal((4, 3, 5)).astype(np.float32),
            "idx": np.arange(6), "odd": np.arange(3.0), "scalar": np.float32(2.5)}
    jb = j_shard_batch(host, j_make_mesh(JMeshSpec(data=2, ray=1)))
    for rank in range(2):
        got = shard_batch(host, Mesh(MeshSpec(data=2), (rank, 0)))
        for k, v in jb.items():
            shard = v.addressable_shards[rank]
            assert shard.device == jax.devices()[rank]
            assert np.array_equal(got[k], np.asarray(shard.data)), k


def test_make_mesh_needs_enough_ranks():
    assert make_mesh(MeshSpec()).coords == (0, 0)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(MeshSpec(data=1, ray=2))


def _jax_allgather(locals_, indices, n_items, monkeypatch):
    """JAX's allgather_metrics as process 0 of 2 sees it, its
    process_allgather returning both processes' payloads."""
    from jax.experimental import multihost_utils
    payloads = []

    def capture(payload):
        payloads.append({k: np.asarray(v) for k, v in payload.items()})
        return {k: np.stack([np.asarray(v)] * 2) for k, v in payload.items()}

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(multihost_utils, "process_allgather", capture)
    for rank in (0, 1):
        jmultihost.allgather_metrics(locals_[rank], indices[rank], n_items)
    both = {k: np.stack([payloads[0][k], payloads[1][k]]) for k in payloads[0]}
    monkeypatch.setattr(multihost_utils, "process_allgather", lambda payload: both)
    return jmultihost.allgather_metrics(locals_[0], indices[0], n_items)


def test_allgather_metrics_match_jax(tmp_path, monkeypatch):
    ranks = run_ranks("allgather", 2, str(tmp_path), {"n_items": 7})
    want = _jax_allgather([r["local"] for r in ranks], [r["indices"] for r in ranks], 7,
                          monkeypatch)
    for r in ranks:
        assert sorted(r["gathered"]) == sorted(want)
        for k, v in want.items():
            assert r["gathered"][k].dtype == v.dtype, k
            assert np.array_equal(r["gathered"][k], v), k
        assert r["names"] == [f"seq-01/frame-{i:06d}.png" for i in range(7)]
    assert np.array_equal(want["rot"], np.arange(7) * 1.5)


# -- the data-parallel train step ---------------------------------------------------

def test_two_rank_train_steps_equal_one_process(S, tmp_path):
    host = stack_batches([device_batch(make_query_batch(n_views=3, H=32, W=32, seed=s))
                          for s in (0, 1)])
    args = {"cfg": S.model.cfg, "state": S.model.state_dict(), "host_batch": host,
            "seed": 5, "steps": 2}
    two = run_ranks("train_steps", 2, str(tmp_path / "two"), args)
    one = run_ranks("train_steps", 0, str(tmp_path / "one"), args)[0]
    for k in one["model"]:
        assert torch.equal(two[0]["model"][k], two[1]["model"][k]), k
    for k in ("mu", "nu"):
        assert torch.equal(two[0]["opt"][k], two[1]["opt"][k])
    assert two[0]["step"] == one["step"] == 2
    leafwise_close(two[0]["model"], one["model"], 1e-6)
    leafwise_close(two[0]["opt"], one["opt"], 1e-6)
    for m2, m1 in zip(two[0]["metrics"], one["metrics"]):
        assert two[1]["metrics"] == two[0]["metrics"]
        assert sorted(m2) == sorted(m1)
        for k in m1:
            assert abs(m2[k] - m1[k]) <= 1e-6 * max(abs(m1[k]), 1e-6), k


# -- ray-sharded renders -------------------------------------------------------------

def _context_fields(jctx):
    return {"sv": {k: t(getattr(jctx.sv, k)) for k in SupportViews._fields},
            "coarse": {f.name: None if getattr(jctx.coarse, f.name) is None
                       else t(getattr(jctx.coarse, f.name))
                       for f in dataclasses.fields(NeuralPoints)},
            "fine": {f.name: None if getattr(jctx.fine, f.name) is None
                     else t(getattr(jctx.fine, f.name))
                     for f in dataclasses.fields(NeuralPoints)},
            "feat_coarse_src": t(jctx.feat_coarse_src),
            "feat_fine_src": t(jctx.feat_fine_src)}


def _rays(batch, n_rays, lo=2.0, hi=29.0):
    uv = jnp.stack([jnp.linspace(lo, hi, n_rays), jnp.linspace(hi, lo, n_rays)], axis=-1)
    return rays_for_pixels(uv, batch["K"], batch["pose"])


def test_ray_sharded_renders_match_jax(S, tmp_path):
    """4 ranks: ranks 0-1 render a 12x12 frame over a (1, 2) mesh (chunks
    of 2 x 64 rays, the last one padded), all four the batched render of
    two queries x 16 rays over (2, 2); JAX renders both on its meshes."""
    H = W = 12
    batches = [S.batch, {k: jnp.asarray(v) for k, v in graft._tiny_batch(seed=1).items()}]
    mesh_r = j_make_mesh(JMeshSpec(data=1, ray=2))
    build = j_context_builder(S.jmodel, mesh_r)
    jctxs = [build(S.variables, b) for b in batches]
    want_img = j_render_image(S.jmodel, S.cfg, S.variables, jctxs[0], batches[0]["K"],
                              batches[0]["pose"], H, W, mesh_r)
    rays = [_rays(b, 16) for b in batches]
    mesh_2d = j_make_mesh(JMeshSpec(data=2, ray=2))
    ctx2 = j_context_builder(S.jmodel, mesh_2d)
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *[ctx2(S.variables, b) for b in batches])
    rays_o = jnp.stack([r[0] for r in rays])
    rays_d = jnp.stack([r[1] for r in rays])
    poses = jnp.stack([b["pose"] for b in batches])
    want_b = j_batched_render(S.jmodel, S.cfg, mesh_2d)(S.variables, stacked, rays_o, rays_d,
                                                         poses)
    args = {"cfg": S.model.cfg, "state": S.model.state_dict(),
            "contexts": [_context_fields(c) for c in jctxs], "hw": (H, W),
            "K": t(batches[0]["K"]), "poses": t(poses), "rays_o": t(rays_o),
            "rays_d": t(rays_d), "batched": True}
    ranks = run_ranks("renders", 4, str(tmp_path), args)
    worst = 0.0
    for r in ranks[:2]:
        assert sorted(r["image"]) == sorted(want_img)
        for k, v in want_img.items():
            if k == "mask":
                assert np.array_equal(r["image"][k].numpy(), np.asarray(v))
            else:
                worst = max(worst, close(r["image"][k], v, RENDER_REL))
    for r in ranks:
        assert "image" not in r or r is ranks[0] or r is ranks[1]
        assert sorted(r["batched"]) == sorted(want_b)
        for k, v in want_b.items():
            if k == "mask":
                assert np.array_equal(r["batched"][k].numpy(), np.asarray(v))
            else:
                worst = max(worst, close(r["batched"][k], v, RENDER_REL))
    print(f"worst render error {worst:.3g} of scale")


def test_uneven_ray_split_raises(S):
    render = make_ray_sharded_render(S.model, S.model.cfg, Mesh(MeshSpec(ray=2), (0, 0)))
    with pytest.raises(ValueError, match="do not split evenly"):
        render(None, torch.zeros(3, 3), torch.zeros(3, 3), torch.eye(4))


# -- the multi-process eval ------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 2 ** 16, 2 ** 40, (2 ** 63 - 1, 7), (-1, 3)])
def test_query_generator_takes_any_seed(seed):
    """Any int seed or (seed, epoch) tuple seeds a generator (a shift of a
    seed of 2^16 or more once passed 2^64); the stream is a function of
    the seed and the index, and both change it."""
    from nerfloc_tpu_torch.train.evaluate import query_generator
    dev = torch.device("cpu")

    def draw(s, i):
        return torch.rand(4, generator=query_generator(s, i, dev))
    assert torch.equal(draw(seed, 5), draw(seed, 5))
    assert not torch.equal(draw(seed, 5), draw(seed, 6))
    other = (seed[0], seed[1] + 1) if isinstance(seed, tuple) else seed + 1
    assert not torch.equal(draw(seed, 5), draw(other, 5))


def test_two_rank_eval_equals_one_rank(S, tmp_path):
    """Three queries of two scenes on 2 ranks (shards [0, 2] and [1]) in
    batches of 2, cascade on (the port's seeded weights: the cascade heads
    are not in the tiny JAX init), against one process in batches of 2."""
    cfg = dataclasses.replace(S.model.cfg, cascade_matching=True)
    items = []
    for i in range(3):
        it = device_batch(make_query_batch(n_views=3, H=32, W=32, seed=10 + i))
        it.update(scene=f"s{i % 2}", scale_factor=1.0 + i, filename=f"s{i % 2}/f{i}.png")
        items.append(it)
    args = {"cfg": cfg, "items": items, "batch": 2,
            "scene_names": {0: "s0", 1: "s1"}, "seed": 3}
    two = run_ranks("eval_items", 2, str(tmp_path / "two"), args)
    one = run_ranks("eval_items", 0, str(tmp_path / "one"), args)[0]
    assert one["few_items"] is None
    for r in two:
        assert "world size" in r["few_items"]
        res, want = dict(r["results"]), dict(one["results"])
        poses, want_poses = res.pop("_poses"), want.pop("_poses")
        assert res == want
        assert poses["filenames"] == want_poses["filenames"] == [it["filename"] for it in items]
        for k in ("poses_pred", "poses_gt"):
            assert np.array_equal(poses[k], want_poses[k]), k
    assert one["results"]["avg"]["n"] == 3 and one["results"]["avg"]["files"] == 3


# -- the CLIs -------------------------------------------------------------------------

SCENES, N_TRAIN, N_TEST = ["box0", "box1"], 3, 2


def _write_scenes(root):
    for i, name in enumerate(SCENES):
        tex, bh, rs = SCENE_VARIANTS[i]
        write_scene(str(root), scene=name, n_train=N_TRAIN, n_test=N_TEST, n_support=4,
                    tex=tex, box_half=bh, radius_scale=rs, H=32, W=32)
    data = root / "data.yaml"
    data.write_text(f"name: boxes\nbase_dir: {root}\nscenes: [{', '.join(SCENES)}]\n"
                    "AUG_TRANSFORM:\n  - RandomRotate: {aug_rotation: 15}\n")
    cfg = root / "cfg.yaml"
    cfg.write_text(f"""expname: par
dataset_type: {data}
backbone2d_fpn_dim: 16
model_3d_hidden_dim: 16
matcher_hidden_dim: 24
n_views_train: 2
n_views_test: 3
max_epochs: 1
cascade_matching: true
render: {{N_samples: 4, N_rand: 8, chunk: 256}}
matching: {{coarse_num_3d_keypoints: 16, fine_num_3d_keypoints: 16,
            max_kp2d: 16, max_fine_pairs: 16, coarse_matching_depth_thresh: 0.5}}
shapes: {{n_views: 3, image_h: 32, image_w: 32, n_rays_train: 8,
          pnp_hypotheses: 64, pose_refine_rays: 32}}
""")
    return str(cfg)


def test_clis_on_two_ranks(tmp_path):
    """cli.train at global batch 2 (one query per rank) for two epochs in
    one run, each followed by its eval, then resumed for a third; cli.test
    with the cascade and renders, the renders' rays over both ranks. One
    process: --batch 2 and a plain render. The train CLIs log and save on
    rank 0 only; the tables, the weights after all three epochs and the
    render PSNR agree (the epoch eval draws its own noise, so epoch 1
    trains on the same noise in both)."""
    cfg = _write_scenes(tmp_path)
    runs = {}
    for kind, n in (("two", 2), ("one", 0)):
        base = str(tmp_path / kind)
        common = ["--config", cfg, "--basedir", base, "--batch", "2", "--device", "cpu",
                  "--train_render_views", "1"]
        test = ["--config", cfg, "--ckpt", os.path.join(base, "par", "default", "ckpts"),
                "--load_latest", "--vis_rendering", "--test_render_interval", "3",
                "--out", os.path.join(base, "eval", "r.json"), "--device", "cpu"]
        if n:
            common += ["--dist_backend", "gloo"]
            test += ["--ray_shards", "2"]
        args = {"train": [common + ["--max_epochs", "2"], common + ["--max_epochs", "3"]],
                "test": [test]}
        out = run_ranks("clis", n, str(tmp_path / f"w_{kind}"), args)
        assert all(o == {"train0": 0, "train1": 0, "test0": 0} for o in out)
        runs[kind] = base
    logs = {}
    for kind, base in runs.items():
        run_dir = os.path.join(base, "par", "default")
        logs[kind] = [json.loads(line) for line in open(os.path.join(run_dir, "log.jsonl"))]
        assert [(r["epoch"], r["step"]) for r in logs[kind] if "loss" in r] == \
            [(0, 1), (1, 4), (2, 7)]
        assert [r["epoch"] for r in logs[kind] if "eval" in r] == [0, 1, 2]
    for a, b in zip(logs["two"], logs["one"]):
        if "loss" in a:
            for k in ("loss", "grad_norm", "psnr"):
                assert abs(a[k] - b[k]) <= 1e-5 * max(abs(b[k]), 1.0), k
    ck = {kind: torch.load(os.path.join(base, "par", "default", "ckpts", "9", "state.pt"),
                           weights_only=True) for kind, base in runs.items()}
    leafwise_close(ck["two"]["model"], ck["one"]["model"], 1e-6)
    tables = {kind: json.load(open(os.path.join(base, "eval", "r.json")))["per_scene"]
              for kind, base in runs.items()}
    render = {kind: tab.pop("render") for kind, tab in tables.items()}
    for kind in tables:
        for row in tables[kind].values():
            row.pop("psnr", None)
    assert tables["two"] == tables["one"]
    assert render["two"]["n_rendered"] == render["one"]["n_rendered"] == 2
    assert abs(render["two"]["psnr_mean"] - render["one"]["psnr_mean"]) <= 1e-4
    for i in (0, 3):
        assert os.path.exists(os.path.join(runs["two"], "eval", f"render_{i:05d}.png"))
