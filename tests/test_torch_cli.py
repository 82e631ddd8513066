"""The file-dataset slice end to end on the CPU: scenes written to disk, read
by both packages' build_dataset, localized by both packages' models with
the same weights; then the port's train and test CLIs at the size of
tests/test_cli_e2e.py (fpn 16, hidden 16, matcher 24, 4 samples per ray,
16 keypoints), with 32x32 frames so that the file stays well inside its
time budget.

(a) JAX `localize_forward` on JAX's file-read test items against the
    port's on its own items, f32, the weights carried across from a JAX
    init. The items are bit-equal (asserted first: test mode runs no
    augmentation, and these frames need no resize), so the bounds are
    test_torch_localize.py's, with nothing added for the items, with one
    exception: the coarse descriptors end to end carry DepthFusionNet's
    known difference from JAX (ROADMAP Queue 3: up to ~1e-4 relative,
    bounded at 1e-3 by test_torch_modules.py; 6.7e-4 on these support
    views' visibility features, 1.1e-4 of scale on one descriptor value),
    so they are held at that 1e-3, and the same descriptors computed by
    the port from JAX's scene context at test_torch_localize.py's 1e-4.
    Support views whose camera sits in the scene's mirror plane give
    exact distance ties, whose order JAX leaves implementation-defined:
    the items with such ties are compared apart (see the last test of (a)).
(b) `cli.train.main` for 2 epochs, then again with --max_epochs 3: it
    resumes at epoch 2.
(c) `cli.test.main` with the cascade and refinement on, over the best
    checkpoint of (b): the per-scene table, the render dumps and the
    trajectory.
(d) Without --device the CLIs ask for CUDA and raise here.
(e) cli.train warm-starts from --ckpt only, as the JAX CLI does (the
    config's `ckpt:` is not read).
"""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfloc_tpu.data import build_dataset as jax_build_dataset
from nerfloc_tpu.data import device_batch as jax_device_batch
from nerfloc_tpu_torch.cli import test as cli_test
from nerfloc_tpu_torch.cli import train as cli_train
from nerfloc_tpu_torch.data import build_dataset, device_batch
from nerfloc_tpu_torch.data.synthetic import SCENE_VARIANTS, write_scene
from nerfloc_tpu_torch.models.fields.ray_unet import RayUnet
from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator, to_device_batch
from nerfloc_tpu_torch.train.checkpoint import discover_best_dirs
from nerfloc_tpu_torch.weights import load_flax_variables

from _torch_parity import CPU, TinySetup, few_threads, port_cfg, port_context, t  # noqa: F401

SCENES = ["box0", "box1"]
N_TRAIN, N_TEST = 3, 2   # per scene


def _cfg_text(data_yaml: str, epochs: int, full: bool, extra: str = "") -> str:
    """tests/test_cli_e2e.py's tiny config; `full` turns the cascade and
    the refinement on."""
    return f"""expname: cli_torch
dataset_type: {data_yaml}
backbone2d_fpn_dim: 16
model_3d_hidden_dim: 16
matcher_hidden_dim: 24
n_views_train: 2
n_views_test: 3
lrate: 5.0e-4
max_epochs: {epochs}
cascade_matching: {str(full).lower()}
optimize_pose: {str(full).lower()}
render: {{N_samples: 4, N_rand: 8}}
matching: {{coarse_num_3d_keypoints: 16, fine_num_3d_keypoints: 16,
            max_kp2d: 16, max_fine_pairs: 16,
            coarse_matching_depth_thresh: 0.5}}
shapes: {{n_views: 3, image_h: 32, image_w: 32, n_rays_train: 8,
          pnp_hypotheses: 64, pose_refine_rays: 32}}
{extra}"""


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    for i, name in enumerate(SCENES):
        tex, bh, rs = SCENE_VARIANTS[i]
        write_scene(str(root), scene=name, n_train=N_TRAIN, n_test=N_TEST, n_support=4,
                    tex=tex, box_half=bh, radius_scale=rs, H=32, W=32)
    data = root / "data.yaml"
    data.write_text(f"""name: cli_torch_boxes
base_dir: {root}
scenes: [{", ".join(SCENES)}]
AUG_TRANSFORM:
  - RandomZoom: {{aug_scale_min: 0.8, aug_scale_max: 1.25}}
  - RandomRotate: {{aug_rotation: 15}}
  - ColorJitter: {{brightness: 0.1, contrast: 0.1, saturation: 0.1, hue: 0.1}}
aug_ref_depth: true
""")
    return root, str(data)


# ---------------------------------------------------------------- (a)

def test_ray_unet_at_four_samples_matches_jax():
    """The CLIs' 4-sample rays leave the U-Net's deepest level empty; the
    JAX package still gives it one sample (its transposed convolution's
    bias)."""
    from nerfloc_tpu.models.fields.ray_unet import RayUnet as JaxRayUnet
    for S in (4, 8):
        x = np.random.default_rng(S).normal(size=(3, S, 16)).astype(np.float32)
        jm = JaxRayUnet(16, S)
        v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
        want = np.asarray(jm.apply(v, jnp.asarray(x)))
        holder = torch.nn.Module()
        holder.ray_unet = RayUnet(16, S)
        assert load_flax_variables(holder, {"params": {"ray_unet": jax.tree.map(
            np.asarray, v["params"])}}) == []
        got = holder.ray_unet(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def file_items(tmp_path_factory):
    """Every test item of two scenes of 5 train views, read by both
    packages' build_dataset; the JAX model and the port's with the same
    weights."""
    root = tmp_path_factory.mktemp("items")
    for i, name in enumerate(SCENES):
        tex, bh, rs = SCENE_VARIANTS[i]
        write_scene(str(root), scene=name, n_train=5, n_test=N_TEST, n_support=4, tex=tex,
                    box_half=bh, radius_scale=rs, H=32, W=32)
    data = root / "data.yaml"
    data.write_text(f"base_dir: {root}\nscenes: [{', '.join(SCENES)}]\n")
    S = TinySetup(dataset_type=str(data), n_views_test=3)
    jds, tds = jax_build_dataset(S.cfg, "test"), build_dataset(port_cfg(S.cfg), "test")
    return S, [(jax_device_batch(jds[i]), device_batch(tds[i])) for i in range(len(jds))]


def test_file_items_are_bit_equal(file_items):
    _, items = file_items
    assert len(items) == len(SCENES) * N_TEST
    for jitem, titem in items:
        assert jitem.keys() == titem.keys()
        for k in jitem:
            assert jitem[k].dtype == titem[k].dtype and np.array_equal(jitem[k], titem[k]), k


@pytest.fixture(scope="module")
def localized(file_items):
    """Per item: JAX's and the port's localize_forward outputs (the same
    noise), and the keypoints whose neighbours the two packages' KNN order
    differently (coarse K=8 and fine K=1, on JAX's context)."""
    from nerfloc_tpu.ops.knn import knn as jax_knn
    from nerfloc_tpu_torch.ops.knn import knn as port_knn
    S, items = file_items
    m = S.jmodel
    rng = jax.random.PRNGKey(0)
    rng_kp, rng_pnp = jax.random.split(rng)

    @jax.jit
    def jax_run(v, b, r):
        out = m.apply(v, b, r, method=m.localize_forward)
        ctx, _, desc, pts3d, _, mm = m.apply(v, b, jax.random.split(r)[0],
                                             method=m.localize_parts)
        return out, desc, pts3d, mm["mkps3d"], ctx

    runs = []
    for jitem, titem in items:
        out, desc, pts3d, mkps3d, jctx = jax_run(
            S.variables, {k: jnp.asarray(v) for k, v in jitem.items()}, rng)
        coarse, fine = jctx.coarse, jctx.fine
        jout = {k: np.asarray(v) for k, v in out.items()}
        jout["desc_3d"] = np.asarray(desc)
        tb = to_device_batch(titem, CPU)
        kp = np.asarray(jax.random.gumbel(rng_kp, (S.model.n_coarse_points(tb),)))
        pnp = np.asarray(jax.random.gumbel(
            rng_pnp, (S.cfg.shapes.pnp_hypotheses, jout["mkps2d"].shape[0])))
        tout = {k: v.numpy() for k, v in S.model.localize_forward(
            tb, kp_gumbel=t(kp), pnp_gumbel=t(pnp)).items()}
        tout["desc_3d"] = S.model.localize_parts(tb, t(kp))[2].detach().numpy()
        tout["desc_3d_on_jax_context"] = S.model.model_3d.query_coarse(
            port_context(S.model, jctx), t(kp))[0].detach().numpy()
        ties = []
        for q, pts, K in ((pts3d, coarse, 8), (mkps3d, fine, 1)):
            jd, ji = (np.asarray(x) for x in jax_knn(q, pts.xyz, K, pts.mask))
            td, ti = (x.numpy() for x in port_knn(t(q), t(pts.xyz), K, t(pts.mask)))
            rows = np.flatnonzero((ji != ti).any(1))
            # a reordering is only allowed between points at exactly the
            # same distance
            assert np.array_equal(jd[rows], td[rows]), (K, rows)
            ties.append(rows)
        runs.append((jout, tout, ties))
    return runs


def _tie_free(localized):
    runs = [(j, p) for j, p, ties in localized if not any(len(r) for r in ties)]
    assert runs, "no test item without exact KNN ties"
    return runs


@pytest.mark.parametrize("key,rel", [("desc_3d_on_jax_context", 1e-4), ("desc_3d", 1e-3),
                                     ("score_matrix", 1e-4), ("mkps3d", 1e-6),
                                     ("pose", 1e-4)])
def test_localize_on_file_items_matches_jax(localized, key, rel):
    for jout, tout in _tie_free(localized):
        want, got = jout[key.replace("_on_jax_context", "")], tout[key]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=rel * max(1.0, float(np.abs(want).max())))


def test_localize_on_file_items_discrete_outputs_match_jax(localized):
    for jout, tout in _tie_free(localized):
        np.testing.assert_allclose(tout["mkps2d"], jout["mkps2d"], rtol=0, atol=1e-3)
        for key in ("match_j", "match_mask", "num_inliers", "pnp_success"):
            assert np.array_equal(tout[key], jout[key]), key


def test_localize_with_exact_knn_ties_differs_only_at_the_tied_keypoints(localized):
    """A support view whose camera sits in the scene's mirror plane (eye
    height 0, the first train view of every write_scene orbit) gives
    mirror-image points at exactly equal distances. The port orders such
    ties by point index; JAX's approx_min_k over its 8192-point tile leaves
    their order implementation-defined. The other keypoints' descriptors
    still hold test_torch_localize.py's bound."""
    tied_items = 0
    for jout, tout, (coarse_rows, fine_rows) in localized:
        if not (len(coarse_rows) or len(fine_rows)):
            continue
        tied_items += 1
        keep = np.ones(len(jout["desc_3d"]), bool)
        keep[coarse_rows] = False
        scale = max(1.0, float(np.abs(jout["desc_3d"]).max()))
        np.testing.assert_allclose(tout["desc_3d_on_jax_context"][keep],
                                   jout["desc_3d"][keep], rtol=0, atol=1e-4 * scale)
    print(f"{tied_items} of {len(localized)} test items have exact KNN ties")


# ------------------------------------------------------------ (b) - (d)

@pytest.fixture(scope="module")
def trained(scenes):
    root, data = scenes
    cfg = root / "train.yaml"
    cfg.write_text(_cfg_text(data, epochs=2, full=False))
    runs = str(root / "runs")
    argv = ["--config", str(cfg), "--basedir", runs, "--batch", "1", "--eval_interval", "1",
            "--train_render_views", "1", "--device", "cpu"]
    assert cli_train.main(argv) == 0
    log = os.path.join(runs, "cli_torch", "default", "log.jsonl")
    first = [json.loads(line) for line in open(log)]
    assert cli_train.main(argv + ["--max_epochs", "3"]) == 0
    return root, runs, first, [json.loads(line) for line in open(log)][len(first):]


def test_train_cli_logs_evals_and_best_streams(trained):
    _, runs, first, _ = trained
    steps = [r for r in first if "loss" in r]
    evals = [r for r in first if "eval" in r]
    assert [r["epoch"] for r in steps] == [0, 1] and [r["it"] for r in steps] == [0, 0]
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in steps)
    assert [r["epoch"] for r in evals] == [0, 1]
    avg = evals[-1]["eval"]["avg"]
    assert math.isfinite(avg["psnr_test"]) and avg["n"] == len(SCENES) * N_TEST
    ckpts = os.path.join(runs, "cli_torch", "default", "ckpts")
    assert {"pose_acc", "median_trans_err_m", "psnr_test"} <= set(discover_best_dirs(ckpts))


def test_train_cli_resumes_at_the_next_epoch(trained):
    _, runs, first, resumed = trained
    per_epoch = len(SCENES) * N_TRAIN
    assert [r["epoch"] for r in resumed if "eval" in r] == [2]
    assert [(r["epoch"], r["step"]) for r in resumed if "loss" in r] == [(2, 2 * per_epoch + 1)]
    steps = sorted(int(n) for n in os.listdir(os.path.join(runs, "cli_torch", "default", "ckpts"))
                   if n.isdigit())
    assert steps[-1] == 3 * per_epoch


def test_train_cli_warm_starts_and_test_loader_restores_shape_matched(trained, capsys):
    root, runs, _, _ = trained
    data = str(root / "data.yaml")
    ckpts = os.path.join(runs, "cli_torch", "default", "ckpts")
    cfg = root / "finetune.yaml"
    cfg.write_text(_cfg_text(data, epochs=0, full=False,
                             extra="use_scene_coord_memorization: true\nexpname: ft\n"))
    assert cli_train.main(["--config", str(cfg), "--basedir", runs, "--ckpt", ckpts,
                           "--device", "cpu"]) == 0
    assert "warm-started from" in capsys.readouterr().out
    from nerfloc_tpu_torch.configs import load_config
    c = load_config(str(cfg))
    fresh = NerfPoseEstimator(c, device="cpu", seed=0)
    model = NerfPoseEstimator(c, device="cpu", seed=0)
    what = cli_test.load_checkpoint(model, ckpts, load_latest=True, best_metric="pose_acc")
    assert what.startswith("latest")
    saved = torch.load(os.path.join(ckpts, str(3 * len(SCENES) * N_TRAIN), "state.pt"),
                       weights_only=True)["model"]
    for k, v in model.state_dict().items():
        want = saved[k] if k in saved else fresh.state_dict()[k]
        assert torch.equal(v, want), k
    assert any("coord_desc_mlp" in k for k in model.state_dict() if k not in saved)


def test_test_cli_table_with_cascade_and_refinement(trained):
    root, runs, _, _ = trained
    cfg = root / "test.yaml"
    cfg.write_text(_cfg_text(str(root / "data.yaml"), epochs=2, full=True,
                             extra="vis_trajectory: true\ntest_render_interval: 2\n"))
    out = root / "eval" / "results.json"
    ckpts = os.path.join(runs, "cli_torch", "default", "ckpts")
    assert cli_test.main(["--config", str(cfg), "--ckpt", ckpts, "--out", str(out),
                          "--vis_rendering", "--device", "cpu"]) == 0
    per_scene = json.load(open(out))["per_scene"]
    for name in SCENES + ["avg"]:
        m = per_scene[name]
        assert math.isfinite(m["median_rot_err_deg"]) and math.isfinite(m["median_trans_err_m"])
        assert 0.0 <= m["pose_acc"] <= 1.0
    assert per_scene["avg"]["n"] == len(SCENES) * N_TEST
    assert per_scene["render"]["n_rendered"] == 2
    for i in (0, 2):
        assert (root / "eval" / f"render_{i:05d}.png").exists()
        assert (root / "eval" / f"depth_{i:05d}.png").exists()
    assert (root / "eval" / "trajectory.pkl").exists()


@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


def test_train_cli_warm_starts_only_from_the_flag(scenes, tmp_path, deterministic, capsys):
    """A repaired fault (ROADMAP Queue 3 item 7): the port's cli.train
    warm-started from the config's `ckpt:` (which every per-scene YAML
    sets) and raised when that directory was missing. The JAX CLI
    (nerfloc_tpu/cli/train.py:100-105) warm-starts from the --ckpt flag
    only, and trains from the fresh init when nothing is restored there:
    its CheckpointManager creates the directory and restore() returns None,
    shown here without running the JAX CLI. A tiny config whose `ckpt:`
    points nowhere trains without --ckpt, and gives the same weights with
    --ckpt at an empty directory."""
    from nerfloc_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
    assert JaxCheckpointManager(str(tmp_path / "jax_missing")).restore() is None
    _, data = scenes
    cfg = tmp_path / "c.yaml"
    cfg.write_text(_cfg_text(data, epochs=1, full=False,
                             extra=f"ckpt: {tmp_path / 'nowhere'}\n"))
    finals = []
    for name, extra in (("plain", []), ("flag", ["--ckpt", str(tmp_path / "empty")])):
        if extra:
            os.makedirs(extra[1])
        runs = str(tmp_path / name)
        assert cli_train.main(["--config", str(cfg), "--basedir", runs, "--eval_interval", "9",
                               "--device", "cpu"] + extra) == 0
        ckpts = os.path.join(runs, "cli_torch", "default", "ckpts")
        last = max(int(n) for n in os.listdir(ckpts) if n.isdigit())
        finals.append(torch.load(os.path.join(ckpts, str(last), "state.pt"),
                                 weights_only=True)["model"])
    assert "nothing to warm-start from" in capsys.readouterr().out
    assert not (tmp_path / "nowhere").exists()
    for k, v in finals[0].items():
        assert torch.equal(v, finals[1][k]), k


def test_clis_default_to_cuda(scenes, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device does not raise")
    root, data = scenes
    cfg = tmp_path / "c.yaml"
    cfg.write_text(_cfg_text(data, epochs=1, full=False))
    for main in (cli_train.main, cli_test.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--config", str(cfg)])


def test_test_cli_refuses_what_is_not_ported(scenes, tmp_path):
    """--ray_shards 2 needs a ray group of 2 ranks: one process without
    torchrun raises, as the JAX CLI's mesh does with too few devices
    (tests/test_torch_parallel.py runs it on 2 ranks). vis_3d_box is
    ported: on scenes without an object box the CLI draws nothing, as the
    JAX CLI skips items without bbox3d_corners (tests/test_torch_finetune.py
    draws boxes)."""
    _, data = scenes
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        cli_test.main(["--ray_shards", "2", "--device", "cpu"])
    cfg = tmp_path / "c.yaml"
    cfg.write_text(_cfg_text(data, epochs=1, full=False,
                             extra="vis_3d_box: true\ntest_render_interval: 1\n"))
    out = tmp_path / "eval" / "r.json"
    assert cli_test.main(["--config", str(cfg), "--out", str(out), "--device", "cpu"]) == 0
    assert out.exists() and not list((tmp_path / "eval").glob("box_*.png"))
