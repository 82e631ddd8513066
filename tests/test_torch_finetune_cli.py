"""The per-object fine-tune through the port's CLIs on the CPU, at
tests/test_torch_cli.py's tiny size (fpn 16, hidden 16, matcher 24, 4
samples per ray, 16 keypoints, 32x32 frames), on object scenes written by
data/synthetic.write_object_scene (OnePose's layout: PNG colour, float32
MVS depth as TIFF, a 3D box, in-box points):

(a) cli.train on an onepose_all-style config (appearance FiLM on, two
    objects), then the per-object fine-tune on an onepose/0447-style one
    (coordinate heads on, appearance off, coreset support views, its YAML
    `ckpt:` pointing nowhere) with --ckpt at (a)'s checkpoints: every
    parameter both models have comes from (a)'s checkpoint, the coordinate
    heads keep their fresh init.
(b) cli.test on the fine-tuned checkpoint with vis_3d_box: one box PNG per
    test_render_interval-th item, decodable by data/png.read and equal to
    the item's image with the box drawn at the predicted pose (random
    weights put it anywhere; at the true pose the box is in view); a finite
    per-scene table.
(c) draw_box3d (data/imgproc.line) against the JAX package's (cv2.line)
    on a test item at poses moved off its own: equal.
"""
import json
import math
import os
import pickle

import numpy as np
import pytest
import torch

from nerfloc_tpu.utils.visualization import draw_box3d as j_draw_box3d
from nerfloc_tpu_torch.cli import test as cli_test
from nerfloc_tpu_torch.cli import train as cli_train
from nerfloc_tpu_torch.configs import load_config
from nerfloc_tpu_torch.data import build_dataset, png
from nerfloc_tpu_torch.data.synthetic import write_object_scene
from nerfloc_tpu_torch.models.pose_estimator import NerfPoseEstimator
from nerfloc_tpu_torch.utils.visualization import draw_box3d

from _torch_parity import few_threads  # noqa: F401

OBJECTS = ["0447-a-box", "0450-b-box"]
N_TRAIN, N_TEST = 4, 2
COORD_HEADS = ("model_3d.coord_desc_mlp_coarse", "model_3d.coord_desc_mlp_fine")


def _cfg(data_yaml, expname, scenes, extra=""):
    return f"""expname: {expname}
dataset_type: {data_yaml}
scenes: [{", ".join(scenes)}]
backbone2d_fpn_dim: 16
model_3d_hidden_dim: 16
matcher_hidden_dim: 24
max_epochs: 1
use_depth_supervision: false
lrate: 5.0e-4
render: {{N_samples: 4, N_rand: 8, render_feature: true}}
matching: {{coarse_num_3d_keypoints: 16, fine_num_3d_keypoints: 16,
            max_kp2d: 16, max_fine_pairs: 16,
            coarse_matching_depth_thresh: 0.5}}
shapes: {{n_views: 3, image_h: 32, image_w: 32, n_rays_train: 8,
          pnp_hypotheses: 64, pose_refine_rays: 32}}
{extra}"""


@pytest.fixture(scope="module")
def objects(tmp_path_factory):
    root = tmp_path_factory.mktemp("objects")
    for i, name in enumerate(OBJECTS):
        write_object_scene(str(root), scene=name, n_train=N_TRAIN, n_test=N_TEST, n_support=3,
                           H=32, W=32, tex=i + 1)
    data = root / "onepose.yaml"
    data.write_text(f"""base_dir: {root}
scenes: []
tempo_interval: 1
aug_ref_depth: false
AUG_TRANSFORM:
  - ColorJitter: {{brightness: 0.1, contrast: 0.1, saturation: 0.1, hue: 0.1}}
""")
    return root, str(data)


@pytest.fixture(scope="module")
def finetuned(objects):
    root, data = objects
    runs = str(root / "runs")
    all_cfg = root / "all.yaml"
    all_cfg.write_text(_cfg(data, "all", OBJECTS, "encode_appearance: true\ntrain_nerf: true\n"
                                                  "n_views_train: 2\nn_views_test: 3\n"))
    assert cli_train.main(["--config", str(all_cfg), "--basedir", runs, "--eval_interval", "1",
                           "--train_render_views", "1", "--device", "cpu"]) == 0
    all_ckpts = os.path.join(runs, "all", "default", "ckpts")
    obj_cfg = root / "obj.yaml"
    obj_cfg.write_text(_cfg(data, OBJECTS[0], OBJECTS[:1], f"""use_scene_coord_memorization: true
encode_appearance: false
ckpt: {root / "nowhere"}
n_views_train: 3
n_views_test: 3
support_image_selection: coreset
coreset_sampler: FPS
image_core_set_size: 3
ref_depth_loss_weight: 1.0
render_loss_weight: 1.0
"""))
    assert cli_train.main(["--config", str(obj_cfg), "--basedir", runs, "--ckpt", all_ckpts,
                           "--eval_interval", "1", "--train_render_views", "1",
                           "--device", "cpu"]) == 0
    return root, runs, all_ckpts, str(obj_cfg)


def test_finetune_warm_starts_from_the_multi_object_run(finetuned):
    root, runs, all_ckpts, obj_cfg = finetuned
    log = os.path.join(runs, OBJECTS[0], "default", "log.jsonl")
    records = [json.loads(line) for line in open(log)]
    assert all(math.isfinite(r["loss"]) for r in records if "loss" in r)
    assert any("eval" in r for r in records)
    # cli.train's own record of the warm start: the fresh tensors are
    # exactly the coordinate heads' (2 MLPs x 3 layers x weight, bias)
    ws = [r for r in records if "warm_start" in r]
    assert len(ws) == 1 and ws[0]["warm_start"] == all_ckpts
    assert len(ws[0]["fresh"]) == 12 and all(k.startswith(COORD_HEADS) for k in ws[0]["fresh"])
    # the fine-tune's first step starts from (a)'s weights where the
    # models share a parameter, from the fresh init in the coordinate heads
    c = load_config(obj_cfg)
    saved = torch.load(os.path.join(all_ckpts, str(len(OBJECTS) * N_TRAIN), "state.pt"),
                       weights_only=True)["model"]
    model = NerfPoseEstimator(c, device="cpu", seed=0)
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    msg = cli_test.load_checkpoint(model, all_ckpts, load_latest=True, best_metric="pose_acc")
    assert msg.startswith("latest")
    taken = [k for k in model.state_dict() if k in saved]
    assert taken and all(torch.equal(model.state_dict()[k], saved[k]) for k in taken)
    kept = [k for k in model.state_dict() if k not in saved]
    assert kept and all(k.startswith(COORD_HEADS) for k in kept)
    assert all(torch.equal(model.state_dict()[k], fresh[k]) for k in kept)
    assert any(k.startswith("adapt_appearance") for k in saved)
    assert not (root / "nowhere").exists() or not os.listdir(root / "nowhere")


def test_test_cli_draws_the_boxes(finetuned):
    root, runs, _, obj_cfg = finetuned
    out = root / "eval" / "results.json"
    ckpts = os.path.join(runs, OBJECTS[0], "default", "ckpts")
    cfg = root / "obj_test.yaml"
    cfg.write_text(open(obj_cfg).read() + "vis_3d_box: true\nvis_trajectory: true\n"
                   "cascade_matching: true\noptimize_pose: true\n")
    assert cli_test.main(["--config", str(cfg), "--ckpt", ckpts, "--out", str(out),
                          "--test_render_interval", "1", "--device", "cpu"]) == 0
    table = json.load(open(out))["per_scene"]
    for name in (OBJECTS[0], "avg"):
        assert math.isfinite(table[name]["median_rot_err_deg"])
        assert math.isfinite(table[name]["median_trans_err_m"])
    boxes = sorted((root / "eval").glob("box_*.png"))
    assert [p.name for p in boxes] == [f"box_{i:05d}.png" for i in range(N_TEST)]
    # each overlay is the item's image with the box at the predicted pose
    # (random weights: the box may lie out of view), and at the true pose
    # the box is in view
    poses = pickle.load(open(root / "eval" / "trajectory.pkl", "rb"))["poses_pred"]
    ds = build_dataset(load_config(str(cfg)), "test", mode="test")
    for i, p in enumerate(boxes):
        item = ds[i]
        img = (np.asarray(item["image"]) * 255).astype(np.uint8)
        over = png.read(str(p))
        assert np.array_equal(over, draw_box3d(img, item["bbox3d_corners"][:8], item["K"],
                                               poses[i]))
        at_gt = draw_box3d(img, item["bbox3d_corners"][:8], item["K"], item["pose"])
        assert ((at_gt[..., 0] == 0) & (at_gt[..., 1] == 255) & (at_gt[..., 2] == 0)).any()


def test_draw_box3d_equals_jax(finetuned):
    root, _, _, obj_cfg = finetuned
    ds = build_dataset(load_config(obj_cfg), "test", mode="test")
    item = ds[0]
    img = (np.asarray(item["image"]) * 255).astype(np.uint8)
    r = np.random.default_rng(0)
    for k in range(4):
        pose = item["pose"].astype(np.float64).copy()
        pose[:3, 3] += r.normal(0, 0.05 * (k + 1), 3)
        a = draw_box3d(img, item["bbox3d_corners"][:8], item["K"], pose)
        b = j_draw_box3d(img, item["bbox3d_corners"][:8], item["K"], pose)
        assert np.array_equal(a, b), k
        assert (a != img).any()
