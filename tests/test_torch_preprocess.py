"""The port's offline scene preparation (nerfloc_tpu_torch/preprocess/,
data/colmap_io.py, data/colmap_db.py) against the JAX package's on the CPU,
on raw scenes written by the port's writers (data/synthetic.write_*_raw) at
small frame sizes: each package preprocesses its own copy of the same raw
scene.

Bounds: info pkls equal key by key, exactly (the port's PNG/TIFF readers
are bit-equal to OpenCV's); every file JAX writes byte for byte (COLMAP
.bin models, bboxes_3d.npy, in_box_pc.ply and the 12-Scenes and Cambridge
pc.ply); the 7-Scenes pc.ply, which comes from TSDF fusion, within
tests/test_torch_tsdf.py's rule: the same voxels in the same order,
centres within XYZ_TOL, colours at most one 8-bit level apart (a colour within 1e-5
can round to the next level; the differing share is printed with -s). The module constants of
7-Scenes (FOCAL, CX, CY) are patched in both packages for the small frames.
"""
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import nerfloc_tpu.preprocess.cambridge as jcam
import nerfloc_tpu.preprocess.onepose as jone
import nerfloc_tpu.preprocess.seven_scenes as jseven
import nerfloc_tpu.preprocess.twelve_scenes as jtwelve
from nerfloc_tpu.data import colmap_db as jdb
from nerfloc_tpu.data import colmap_io as jio
from nerfloc_tpu_torch.data import colmap_db as tdb
from nerfloc_tpu_torch.data import colmap_io as tio
from nerfloc_tpu_torch.data import png
from nerfloc_tpu_torch.data import synthetic as syn
from nerfloc_tpu_torch.data.ply import read_ply_points
from nerfloc_tpu_torch.data.scene_store import SceneStore
from nerfloc_tpu_torch.preprocess import cambridge as tcam
from nerfloc_tpu_torch.preprocess import onepose as tone
from nerfloc_tpu_torch.preprocess import seven_scenes as tseven
from nerfloc_tpu_torch.preprocess import twelve_scenes as ttwelve

XYZ_TOL = 1e-6
H, W = 96, 128


def _copies(tmp_path, write):
    """Two copies (jax/, port/) of one raw scene written by `write(root)`."""
    write(str(tmp_path / "jax"))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    return str(tmp_path / "jax"), str(tmp_path / "port")


def _assert_pkls_equal(a_dir, b_dir):
    for split in ("train", "test"):
        a = pickle.load(open(os.path.join(a_dir, f"info_{split}.pkl"), "rb"))
        b = pickle.load(open(os.path.join(b_dir, f"info_{split}.pkl"), "rb"))
        assert len(a) == len(b), split
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                if isinstance(y[k], np.ndarray):
                    assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
                else:
                    assert type(x[k]) is type(y[k]) and x[k] == y[k], k
    return len(a)


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


# ------------------------------------------------------------------ COLMAP IO

def _model():
    rng = np.random.default_rng(0)
    cameras = {1: tio.Camera(1, "PINHOLE", 640, 480, np.array([500.0, 500.0, 320.0, 240.0])),
               2: tio.Camera(2, "SIMPLE_PINHOLE", 320, 240, np.array([250.0, 160.0, 120.0]))}
    R = syn.look_at_pose(np.zeros(3), np.array([0.3, 0.1, 1.0]))[:3, :3]
    images = {7: tio.Image(7, tio.rotmat2qvec(R), np.array([0.1, 0.2, 0.3]), 1,
                           "seq/frame0.png", rng.uniform(0, 640, (5, 2)),
                           np.array([0, 1, 2, -1, 4], np.int64)),
              9: tio.Image(9, tio.rotmat2qvec(R.T), np.array([-1.0, 0.5, 2.0]), 2,
                           "seq/frame1.png", np.zeros((0, 2)), np.zeros(0, np.int64))}
    points = {3: tio.Point3D(3, np.array([1.0, 2.0, 3.0]), np.array([255, 0, 10]), 0.5,
                             np.array([7]), np.array([2])),
              4: tio.Point3D(4, np.array([-1.5, 0.25, 4.0]), np.array([1, 2, 3]), 1.25,
                             np.array([7, 9]), np.array([0, 3]))}
    return cameras, images, points


def _assert_models_equal(a, b):
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            for f in vars(y[k]):
                u, v = getattr(x[k], f), getattr(y[k], f)
                assert np.array_equal(u, v) if isinstance(v, np.ndarray) else u == v, (k, f)


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_colmap_model_round_trip_and_cross_reads(tmp_path, ext):
    cameras, images, points = _model()
    tio.write_model(str(tmp_path / "t"), cameras, images, points, ext=ext)
    jio.write_model(str(tmp_path / "j"), cameras, images, points, ext=ext)
    for name in ("cameras", "images", "points3D"):
        assert _same_bytes(tmp_path / "t" / (name + ext), tmp_path / "j" / (name + ext)), name
    back = tio.read_model(str(tmp_path / "t"), ext=ext)
    np.testing.assert_allclose(back[1][7].qvec, images[7].qvec, atol=1e-12)
    np.testing.assert_allclose(back[1][7].xys, images[7].xys, atol=1e-9)
    assert back[0][2].K()[0, 2] == 160.0 and back[1][9].name == "seq/frame1.png"
    _assert_models_equal(back, (cameras, images, points))
    # each package reads what the other writes as it reads its own, but the
    # JAX text reader skips image 9's empty observation line and loses it
    _assert_models_equal(tio.read_model(str(tmp_path / "j"), ext=ext), back)
    jax_back = jio.read_model(str(tmp_path / "t"), ext=ext)
    if ext == ".txt":
        assert 9 not in jax_back[1]
        del back[1][9]
    _assert_models_equal(jax_back, back)


def test_qvec_rotmat_equal_jax():
    rng = np.random.default_rng(1)
    for _ in range(20):
        q = rng.standard_normal(4)
        q /= np.linalg.norm(q)
        R = tio.qvec2rotmat(q)
        assert np.array_equal(R, jio.qvec2rotmat(q))
        assert np.array_equal(tio.rotmat2qvec(R), jio.rotmat2qvec(R))
        np.testing.assert_allclose(tio.qvec2rotmat(tio.rotmat2qvec(R)), R, atol=1e-9)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_colmap_database_round_trip_and_cross_reads(tmp_path, writer):
    w, r = (tdb, jdb) if writer == "port" else (jdb, tdb)
    path = str(tmp_path / "db.db")
    db = w.COLMAPDatabase.connect(path)
    db.create_tables()
    cam = db.add_camera(1, 640, 480, np.array([500.0, 500, 320, 240]))
    i1 = db.add_image("a.jpg", cam)
    i2 = db.add_image("b.jpg", cam, prior_q=(1.0, 0.0, 0.0, 0.0))
    kps = np.random.default_rng(0).uniform(0, 640, (10, 2)).astype(np.float32)
    db.add_keypoints(i1, kps)
    db.add_descriptors(i1, np.arange(10 * 128, dtype=np.uint8).reshape(10, 128))
    matches = np.array([[0, 3], [1, 5], [2, 7]], np.uint32)
    db.add_matches(i2, i1, matches)  # reversed ids exercise the swap
    db.commit()
    db.close()
    for mod in (w, r):
        db = mod.COLMAPDatabase.connect(path)
        np.testing.assert_array_equal(db.read_keypoints(i1), kps)
        np.testing.assert_array_equal(db.read_matches(i2, i1), matches)
        np.testing.assert_array_equal(db.read_matches(i1, i2), matches[:, ::-1])
        assert db.read_keypoints(99) is None and db.read_matches(1, 99) is None
        db.close()
    assert tdb.pair_id_to_image_ids(tdb.image_ids_to_pair_id(7, 3)) == (3, 7)
    assert tdb.image_ids_to_pair_id(7, 3) == jdb.image_ids_to_pair_id(3, 7)


# -------------------------------------------------------------------- 7-Scenes

def _assert_fused_ply_equal(a_path, b_path, voxel):
    a_xyz, a_rgb = read_ply_points(a_path)
    b_xyz, b_rgb = read_ply_points(b_path)
    # lattice offsets from one point (both clouds lie on one lattice)
    ia, ib = (np.round((x - b_xyz[0]) / np.float32(voxel)).astype(np.int64)
              for x in (a_xyz, b_xyz))
    assert len(ia) == len(ib) and np.array_equal(ia, ib)
    assert np.abs(a_xyz - b_xyz).max() <= XYZ_TOL
    levels = np.abs(np.round(a_rgb * 255) - np.round(b_rgb * 255))
    print(f"pc.ply: {len(a_xyz)} points, colours one level apart: "
          f"{float(np.mean(levels > 0)):.2e}")
    assert levels.max() <= 1
    return len(a_xyz)


@pytest.mark.parametrize("rendered_depth", [False, True])
def test_seven_scenes_equals_jax(tmp_path, monkeypatch, rendered_depth):
    scene = "chess"
    jroot, troot = _copies(tmp_path, lambda root: syn.write_seven_scenes_raw(
        root, scene, n_frames=5, H=H, W=W, focal=0.9 * W, rendered_depth=rendered_depth))
    for mod in (jseven, tseven):
        monkeypatch.setattr(mod, "FOCAL", 0.9 * W)
        monkeypatch.setattr(mod, "CX", W / 2)
        monkeypatch.setattr(mod, "CY", H / 2)
    jseven.process_scene(jroot, scene, frame_stride=2, voxel_size=0.08)
    tseven.process_scene(troot, scene, frame_stride=2, voxel_size=0.08, device="cpu")
    jd, td = os.path.join(jroot, scene), os.path.join(troot, scene)
    assert _assert_pkls_equal(jd, td) == 5
    train = pickle.load(open(os.path.join(td, "info_train.pkl"), "rb"))
    assert len(train) == 10
    assert train[0]["depth_file_name"].endswith(".tiff" if rendered_depth else ".depth.png")
    n = _assert_fused_ply_equal(os.path.join(jd, "pc.ply"), os.path.join(td, "pc.ply"), 0.08)
    assert n > 100
    store = SceneStore.load(troot, scene)
    assert len(store.train_frames) == 10 and len(store.test_frames) == 5
    assert np.abs(store.points).max() < 2.7


def test_seven_scenes_cli_device(tmp_path):
    syn.write_seven_scenes_raw(str(tmp_path), "heads", train_seqs=(1,), test_seqs=(2,),
                               n_frames=2, H=48, W=64, focal=50.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tseven.main([str(tmp_path), "heads"])
        assert not os.path.exists(tmp_path / "heads" / "info_train.pkl")
    assert tseven.main([str(tmp_path), "heads", "--device", "cpu"]) == 0
    assert os.path.exists(tmp_path / "heads" / "pc.ply")


# ------------------------------------------------------------------- 12-Scenes

def test_twelve_scenes_equals_jax(tmp_path):
    jroot, troot = _copies(tmp_path, lambda root: syn.write_twelve_scenes_raw(
        root, "apt1", "kitchen", n_train=5, n_test=3, H=97, W=130, depth_hw=(48, 64),
        inf_frames=(1, 5)))
    jtwelve.process_scene(jroot, "apt1", "kitchen")
    ttwelve.process_scene(troot, "apt1", "kitchen")
    jd, td = (os.path.join(r, "apt1", "kitchen") for r in (jroot, troot))
    _assert_pkls_equal(jd, td)
    train = pickle.load(open(os.path.join(td, "info_train.pkl"), "rb"))
    test = pickle.load(open(os.path.join(td, "info_test.pkl"), "rb"))
    assert len(train) == 4 and len(test) == 2     # the INF poses skipped
    assert train[0]["frame_dim"] == (97, 130)
    assert _same_bytes(os.path.join(jd, "pc.ply"), os.path.join(td, "pc.ply"))
    xyz, rgb = read_ply_points(os.path.join(td, "pc.ply"))
    assert len(xyz) == 6 * 81 and rgb is not None


# --------------------------------------------------------------------- OnePose

def test_onepose_box_filter():
    corners = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=np.float64)
    pts = np.array([[0.5, 0.5, 0.5], [1.5, 0.5, 0.5], [-0.1, 0, 0], [0.99, 0.99, 0.99]])
    assert tone.is_inside_box3d(pts, corners).tolist() == [True, False, False, True]
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 2, (500, 3))
    assert np.array_equal(tone.is_inside_box3d(pts, corners),
                          jone.is_inside_box3d(pts, corners))


def test_onepose_equals_jax(tmp_path):
    scene = "0447-synthetic-box"
    jroot, troot = _copies(tmp_path, lambda root: syn.write_onepose_raw(
        root, scene, n_seqs=3, n_frames=3, H=96, W=96, n_points=600))
    for mod, root in ((jone, jroot), (tone, troot)):
        mod.H = mod.W = 96
        try:
            mod.process_scene(root, scene)
        finally:
            mod.H = mod.W = 512
    jd, td = os.path.join(jroot, scene), os.path.join(troot, scene)
    _assert_pkls_equal(jd, td)
    for name in ("bboxes_3d.npy", "in_box_pc.ply"):
        assert _same_bytes(os.path.join(jd, name), os.path.join(td, name)), name
    train = pickle.load(open(os.path.join(td, "info_train.pkl"), "rb"))
    test = pickle.load(open(os.path.join(td, "info_test.pkl"), "rb"))
    # 2 train sequences of 3 frames, frame 1 without MVS depth; the last
    # sequence is the test split
    assert len(train) == 4 and len(test) == 3
    assert {f["sequence_id"] for f in test} == {f"{scene}-3"}


# ------------------------------------------------------------------- Cambridge

def test_cambridge_equals_jax(tmp_path):
    scene = "KingsCollege"
    jroot, troot = _copies(tmp_path, lambda root: syn.write_cambridge_raw(
        root, scene, n_train=4, n_test=2, H=90, W=160, n_points=300))
    jcam.process_scene(jroot, scene, run_mvs=False)
    tcam.process_scene(troot, scene, run_mvs=False)
    jd, td = os.path.join(jroot, scene), os.path.join(troot, scene)
    _assert_pkls_equal(jd, td)
    for name in ("colmap/sparse/cameras.bin", "colmap/sparse/images.bin",
                 "colmap/sparse/points3D.bin", "pc.ply"):
        assert _same_bytes(os.path.join(jd, name), os.path.join(td, name)), name
    train = pickle.load(open(os.path.join(td, "info_train.pkl"), "rb"))
    test = pickle.load(open(os.path.join(td, "info_test.pkl"), "rb"))
    # the test frame without a PNG and the outlier camera are skipped
    assert len(train) == 4 and len(test) == 2
    assert train[0]["frame_dim"] == (90, 160)
    cams, images, _ = tio.read_model(os.path.join(td, "colmap", "sparse"))
    assert len(images) == 6 and cams[0].width == 160


def test_cambridge_mvs_skips_without_colmap(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert tcam.run_colmap_mvs("sparse", "images", "dense") is False
    assert "colmap binary not found" in capsys.readouterr().out


def test_image_hw_reads_the_png_header(tmp_path):
    img = (np.random.default_rng(0).random((37, 53, 3)) * 255).astype(np.uint8)
    png.write(str(tmp_path / "a.png"), img)
    assert tcam.image_hw(str(tmp_path), "a.png") == (37, 53)
    assert png.size(str(tmp_path / "a.png")) == png.read(str(tmp_path / "a.png")).shape[:2]
    (tmp_path / "bad.png").write_bytes(b"not an image at all, not a PNG header either")
    assert tcam.image_hw(str(tmp_path), "bad.png") is None
    assert tcam.image_hw(str(tmp_path), "missing.png") is None
