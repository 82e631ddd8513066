"""The scene families with their own layouts (COLMAP workspaces, DTU,
Blender/NeRF-synthetic, LLFF) and the pose-proximity retrieval: the port's
stores and build_dataset items against the JAX package's on the CPU, on
scenes written with the port's writers at 96x128 (data/synthetic.py's
write_colmap_workspace; the DTU, Blender and LLFF layouts below).

Bounds: store fields equal (arrays exactly); items in test mode equal
(every array exactly); items in train mode, whose augmentation runs the
cubic warp and ColorJitter, equal but for at most AUG_IMAGE_SHARE of the
image values (tests/test_torch_data.py's bound: the warp's float32 sum
order is not OpenCV's).
"""
import dataclasses
import json
import os

import numpy as np
import pytest

from nerfloc_tpu import configs as jconfigs
from nerfloc_tpu.data import factory as jfactory
from nerfloc_tpu.data import scene_store as jstore
from nerfloc_tpu.data.blender_scene import blender_scene_store as jblender
from nerfloc_tpu.data.colmap_scene import colmap_scene_store as jcolmap
from nerfloc_tpu.data.dtu_scene import dtu_scene_store as jdtu
from nerfloc_tpu.data.llff_scene import llff_scene_store as jllff
from nerfloc_tpu_torch import configs as tconfigs
from nerfloc_tpu_torch.data import factory as tfactory
from nerfloc_tpu_torch.data import png
from nerfloc_tpu_torch.data import scene_store as tstore
from nerfloc_tpu_torch.data.blender_scene import blender_scene_store as tblender
from nerfloc_tpu_torch.data.colmap_scene import colmap_scene_store as tcolmap
from nerfloc_tpu_torch.data.dtu_scene import dtu_scene_store as tdtu
from nerfloc_tpu_torch.data.llff_scene import llff_scene_store as tllff
from nerfloc_tpu_torch.data.synthetic import look_at_pose, render_box_view, \
    write_colmap_workspace

AUG_IMAGE_SHARE = 0.005
H, W = 96, 128
DATA_CFG = {
    "TRANSFORM": [{"ResizeAndCrop": {"target_size": 48, "base_image_size": 16}},
                  {"PadToSize": {"height": 48, "width": 80}}],
    "AUG_TRANSFORM": [{"RandomZoom": {"aug_scale_min": 0.666667, "aug_scale_max": 1.5}},
                      {"RandomRotate": {"aug_rotation": 30.0}},
                      {"ColorJitter": {"brightness": 0.1, "contrast": 0.1, "saturation": 0.1,
                                       "hue": 0.1}}],
}


def _rgb8(rgb):
    return (rgb * 255).astype(np.uint8)


def _write_pfm(path, data):
    data = np.flipud(np.asarray(data, np.float32))
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        data.astype("<f4").tofile(f)


def write_dtu(base, scan="scan1", n=9):
    """MVSNet's rectified DTU layout: quarter-resolution cam.txt
    intrinsics, rectified PNGs, PFM depth (one view without)."""
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    for sub in ("Cameras/train", f"Rectified/{scan}_train", f"Depths/{scan}_train"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    for i in range(n):
        ang = 0.3 * i
        c2w = look_at_pose(np.array([0.3 * np.cos(ang), 0.1, 0.3 * np.sin(ang)]),
                           np.array([2.0, 0.2 * np.sin(ang), 0.0]))
        rgb, depth = render_box_view(c2w, K, H, W)
        png.write(os.path.join(base, f"Rectified/{scan}_train/rect_{i + 1:03d}_3_r5000.png"),
                  _rgb8(rgb))
        if i != 2:
            _write_pfm(os.path.join(base, f"Depths/{scan}_train/depth_map_{i:04d}.pfm"), depth)
        ext = "\n".join(" ".join(f"{v:.8f}" for v in row) for row in np.linalg.inv(c2w))
        intr = "\n".join(" ".join(f"{v:.8f}" for v in row) for row in K / 4.0)
        with open(os.path.join(base, f"Cameras/train/{i:08d}_cam.txt"), "w") as fh:
            fh.write(f"extrinsic\n{ext}\n\nintrinsic\n{intr}\n\n1.0 0.026 192 6.0\n")


def write_blender(root, scene="lego"):
    """NeRF-synthetic layout: RGBA PNG renders, OpenGL camera-to-world
    matrices in transforms_{split}.json, .npy depth beside the train
    frames."""
    angle_x = 0.8
    f = 0.5 * W / np.tan(0.5 * angle_x)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    sd = os.path.join(root, scene)
    gl2cv = np.diag([1.0, -1.0, -1.0, 1.0])
    for split, n in (("train", 5), ("test", 2)):
        os.makedirs(os.path.join(sd, split), exist_ok=True)
        frames = []
        for i in range(n):
            ang = 0.4 * i + (0.2 if split == "test" else 0.0)
            c2w = look_at_pose(np.array([0.2 * np.cos(ang), 0.0, 0.2 * np.sin(ang)]),
                               np.array([2.0, 0, 0.0]))
            rgb, depth = render_box_view(c2w, K, H, W)
            rel = f"{split}/r_{i}"
            rgba = np.concatenate([_rgb8(rgb), np.full((H, W, 1), 255, np.uint8)], axis=2)
            png.write(os.path.join(sd, rel + ".png"), rgba)
            if split == "train":
                np.save(os.path.join(sd, rel + "_depth.npy"), depth)
            frames.append({"file_path": "./" + rel,
                           "transform_matrix": (c2w @ gl2cv).tolist()})
        with open(os.path.join(sd, f"transforms_{split}.json"), "w") as fh:
            json.dump({"camera_angle_x": angle_x, "frames": frames}, fh)


def write_llff(root, scene="fern", n=10, factor=4):
    """LLFF layout: poses_bounds.npy ([down, right, back] axes, full-size
    H, W, focal) and the images downsampled by `factor` in images_<factor>."""
    sd = os.path.join(root, scene)
    os.makedirs(os.path.join(sd, f"images_{factor}"), exist_ok=True)
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    poses = np.zeros((n, 3, 5))
    for i in range(n):
        c2w = look_at_pose(np.array([0.05 * i - 0.2, 0.02 * i, 0.0]), np.array([0.0, 0.0, 2.0]))
        poses[i, :, 0], poses[i, :, 1], poses[i, :, 2] = c2w[:3, 1], c2w[:3, 0], -c2w[:3, 2]
        poses[i, :, 3] = c2w[:3, 3]
        poses[i, :, 4] = [H * factor, W * factor, f * factor]
        rgb, _ = render_box_view(c2w, K, H, W)
        png.write(os.path.join(sd, f"images_{factor}", f"im_{i:03d}.png"), _rgb8(rgb))
    bounds = np.stack([np.full(n, 0.5), np.full(n, 4.0) + 0.1 * np.arange(n)], 1)
    np.save(os.path.join(sd, "poses_bounds.npy"),
            np.concatenate([poses.reshape(n, -1), bounds], axis=1))


def _equal(a, b, where):
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b), where
    elif isinstance(b, dict):
        assert a.keys() == b.keys(), where
        for k in b:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, where


def _assert_stores_equal(a, b):
    for f in dataclasses.fields(b):
        _equal(getattr(a, f.name), getattr(b, f.name), f.name)


def _assert_items_equal(a, b, aug: bool):
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(y, str):
            assert x == y, k
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype, k
        if aug and k in ("image", "topk_images"):
            assert float(np.mean(x != y)) <= AUG_IMAGE_SHARE, k
        else:
            assert np.array_equal(x, y), k


# family -> (writer(root) -> scene name, store builders (port, jax), data_cfg)
FAMILIES = {
    "colmap": (lambda root: (write_colmap_workspace(os.path.join(root, "ws"), H=H, W=W), "ws")[1],
               lambda root, s: (tcolmap(os.path.join(root, s), scene=s),
                                jcolmap(os.path.join(root, s), scene=s)), {}),
    "dtu": (lambda root: (write_dtu(root), "scan1")[1],
            lambda root, s: (tdtu(root, s), jdtu(root, s)), {"light": "3"}),
    "blender": (lambda root: (write_blender(root), "lego")[1],
                lambda root, s: (tblender(root, s, near=0.5, far=7.0),
                                 jblender(root, s, near=0.5, far=7.0)),
                {"near": 0.5, "far": 7.0}),
    "llff": (lambda root: (write_llff(root), "fern")[1],
             lambda root, s: (tllff(root, s), jllff(root, s)), {"factor": 4}),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp(request.param))
    write, stores, dc = FAMILIES[request.param]
    return request.param, root, write(root), stores, dc


def test_family_store_equals_jax(family):
    name, root, scene, stores, _ = family
    t, j = stores(root, scene)
    _assert_stores_equal(t, j)
    assert len(t.train_frames) > 0 and len(t.test_frames) > 0
    if name == "dtu":
        assert all(len(f["top_k"]) > 0 for f in t.train_frames + t.test_frames)


@pytest.mark.parametrize("mode", ["test", "train"])
def test_family_items_equal_jax(family, mode):
    """build_dataset no longer raises for the family, and its items are
    JAX's (train mode: epochs 0 and 1, augmentation on)."""
    name, root, scene, _, dc = family
    ov = {"dataset_type": name, "datadir": root, "scenes": [scene], "n_views_train": 2,
          "n_views_test": 3}
    data_cfg = {**DATA_CFG, **dc}
    t = tfactory.build_dataset(tconfigs.load_config(None, ov), mode, mode=mode, data_cfg=data_cfg)
    j = jfactory.build_dataset(jconfigs.load_config(None, ov), mode, mode=mode, data_cfg=data_cfg)
    assert len(t) == len(j) > 0 and t.scene_names() == j.scene_names() == [scene]
    for epoch in ((0, 1) if mode == "train" else (0,)):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        for i in range(len(j)):
            a, b = t[i], j[i]
            _assert_items_equal(a, b, aug=mode == "train")
            assert a["image"].shape == (48, 80, 3)
            assert a["topk_images"].shape == (3 if mode == "test" else 2, 48, 80, 3)
            if name != "llff":   # LLFF has no depth
                assert (a["topk_depths"] > 0).any()


def test_pose_retrieval_equals_jax(tmp_path):
    """attach_pose_retrieval (the oracle top-k by pose proximity) on a
    store of write_scene's orbit, against JAX's."""
    from nerfloc_tpu_torch.data.synthetic import write_scene
    write_scene(str(tmp_path), scene="s", n_train=7, n_test=3, n_support=2, H=24, W=32)
    a = tstore.attach_pose_retrieval(tstore.SceneStore.load(str(tmp_path), "s"), k=4)
    b = jstore.attach_pose_retrieval(jstore.SceneStore.load(str(tmp_path), "s"), k=4)
    _assert_stores_equal(a, b)
    assert all(len(f["top_k"]) == 4 for f in a.train_frames + a.test_frames)
    assert all(f["file_name"] not in f["top_k"] for f in a.train_frames)
