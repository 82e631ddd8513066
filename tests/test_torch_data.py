"""The port's file-data path against the JAX package's on the CPU: the YAML
reader and load_config, the PNG codec and the frame readers, the
resamplers and transforms, the samplers, the scene store, build_dataset's
items and the loader's order.

The JAX package reads with OpenCV and PyYAML, which this test machine has:
they are the reference. Bounds: YAML documents and configs equal; PNG
pixels, depth, masks, K and Tcw exact; the resamplers bit-exact except the
cubic warp, whose float32 sum runs in another order than OpenCV's (at most
0.5 % of its uint8 values one level apart; the test prints the share);
dataset items of the same keys and support files, every non-image array
exact, images equal except where the cubic warp's last-bit differences
pass through ColorJitter (its hue shift round-trips through 8-bit HSV and
its result is truncated to uint8, so a one-level difference can move a
value by several levels): at most 0.5 % of the image values differ.
"""
import dataclasses
import glob
import os
import pickle
import sys
import time

import cv2
import numpy as np
import pytest
import yaml

from nerfloc_tpu import configs as jconfigs
from nerfloc_tpu.data import factory as jfactory
from nerfloc_tpu.data import prefetch as jprefetch
from nerfloc_tpu.data import reader as jreader
from nerfloc_tpu.data import samplers as jsamplers
from nerfloc_tpu.data import scene_store as jstore
from nerfloc_tpu.data import transforms as jtf
from nerfloc_tpu_torch import configs as tconfigs
from nerfloc_tpu_torch.configs.yaml_subset import YAMLSubsetError, safe_load
from nerfloc_tpu_torch.data import factory as tfactory
from nerfloc_tpu_torch.data import imgproc, png
from nerfloc_tpu_torch.data import prefetch as tprefetch
from nerfloc_tpu_torch.data import reader as treader
from nerfloc_tpu_torch.data import samplers as tsamplers
from nerfloc_tpu_torch.data import scene_store as tstore
from nerfloc_tpu_torch.data import transforms as ttf
from nerfloc_tpu_torch.data.synthetic import SCENE_VARIANTS, write_object_scene, write_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))
DATA_YAMLS = sorted(glob.glob(os.path.join(ROOT, "nerfloc_tpu", "configs", "data", "*.yaml")))
CUBIC_SHARE = 0.005          # cubic warp: uint8 values allowed one level apart
AUG_IMAGE_SHARE = 0.005      # augmented dataset images: values allowed to differ


def _rel(p):
    return os.path.relpath(p, ROOT)


# --------------------------------------------------------------------- YAML

def test_repo_has_the_yaml_files_the_issue_counts():
    assert len(REPO_CONFIGS) == 34 and len(DATA_YAMLS) == 4


@pytest.mark.parametrize("path", REPO_CONFIGS + DATA_YAMLS, ids=_rel)
def test_yaml_reader_equals_pyyaml(path):
    text = open(path).read()
    assert safe_load(text) == yaml.safe_load(text)


def test_port_data_yamls_are_the_jax_packages():
    for p in DATA_YAMLS:
        q = os.path.join(ROOT, "nerfloc_tpu_torch", "configs", "data", os.path.basename(p))
        assert open(q).read() == open(p).read()


def _cli_e2e_yamls(tmp_path):
    """The YAMLs tests/test_cli_e2e.py and tools/e2e_pose_study.py write."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from e2e_pose_study import write_cfg
    from test_cli_e2e import _write_tiny_cfg
    data = tmp_path / "data.yaml"
    data.write_text(f"""name: cli_e2e_boxes
base_dir: {tmp_path}
scenes: [{", ".join(["box0", "box1"])}]
AUG_TRANSFORM:
  - RandomZoom: {{aug_scale_min: 0.8, aug_scale_max: 1.25}}
  - RandomRotate: {{aug_rotation: 15}}
  - ColorJitter: {{brightness: 0.1, contrast: 0.1, saturation: 0.1, hue: 0.1}}
aug_ref_depth: true
""")
    _write_tiny_cfg(str(tmp_path / "cfg.yaml"), str(data), epochs=2)
    write_cfg(str(tmp_path / "study.yaml"), str(data), 3, full_features=True)
    write_cfg(str(tmp_path / "study_g.yaml"), str(data), 3, full_features=False,
              n_importance=8)
    return [data, tmp_path / "cfg.yaml", tmp_path / "study.yaml", tmp_path / "study_g.yaml"]


def test_yaml_reader_equals_pyyaml_on_written_yamls(tmp_path):
    for p in _cli_e2e_yamls(tmp_path):
        text = p.read_text()
        assert safe_load(text) == yaml.safe_load(text), p.name


SCALARS = [
    "a: 1e-3\nb: 5.0e-4\nc: 0447\nd: yes\ne: ~\nf:\ng: 1_000\nh: 0x1F\ni: '1e3'\n",
    "j: \"x\\ty\"\nk: .inf\nl: -1.5\nm: 1:30\nn: 0b101\no: -.inf\np: .NaN\nq: On\nr: off\n",
    "x: -1\ny: +2\nz: 1.\nw: .5\nv: 1.0e+3\nu: 1.0e3\nt: NULL\ns: 'it''s'\n",
    "x:\n- a\n- b: 1\n  c: 2\n- [1, 2,\n   3]\ny: {a: [1, {b: c}], d: 'e f', g: h i}\n",
    "- - 1\n  - 2\n- 3\n",
    "a:\n  b:\n    - x: 1\n      y: [1,\n         2]\n  c: 'q'  # comment\n",
    "k: a#b\nm: 'q # not'\nn: [a, 'b, c']\no: {}\np: [ ]\n\"r s\": 2\n",
]


@pytest.mark.parametrize("text", SCALARS, ids=range(len(SCALARS)))
def test_yaml_scalars_resolve_as_pyyaml(text):
    mine, ref = safe_load(text), yaml.safe_load(text)
    assert repr(mine) == repr(ref)


UNSUPPORTED = ["a: &x 1\n", "a: *x\n", "a: !!str 1\n", "a: |\n  x\n", "a: >\n  x\n",
               "---\na: 1\n", "a: b\n  c\n", "a: 2001-12-14\n", "a: [1, 2\n"]


@pytest.mark.parametrize("text", UNSUPPORTED, ids=range(len(UNSUPPORTED)))
def test_yaml_unsupported_constructs_raise_with_the_line(text):
    with pytest.raises(YAMLSubsetError, match="line"):
        safe_load(text)


@pytest.mark.parametrize("path", REPO_CONFIGS, ids=_rel)
def test_load_config_equals_jax(path):
    assert dataclasses.asdict(tconfigs.load_config(path)) == \
        dataclasses.asdict(jconfigs.load_config(path))


def test_overrides_and_args_equal_jax():
    import argparse
    path = os.path.join(ROOT, "configs", "7scenes_all.yaml")
    ov = {"scenes": ["a"], "render": {"N_rand": 8}, "max_epochs": 1}
    args = argparse.Namespace(lrate=1e-3, basedir="runs", expname=None, seed=3)
    t = tconfigs.override_cfg_with_args(tconfigs.load_config(path, ov), args)
    j = jconfigs.override_cfg_with_args(jconfigs.load_config(path, ov), args)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    with pytest.raises(KeyError):
        tconfigs.load_config(None, {"no_such_key": 1})


# ---------------------------------------------------------------------- PNG

def _smooth_rgb(H=48, W=64):
    yy, xx = np.mgrid[:H, :W]
    return np.stack([(xx * 3.3 + yy) % 256, (xx * yy * 0.07) % 256,
                     np.sin(xx / 7.0) * 100 + 120], -1).astype(np.uint8)


def test_png_reads_cv2_written_files_bit_equal(tmp_path):
    rng = np.random.default_rng(0)
    rgb, gray = _smooth_rgb(), rng.integers(0, 256, (48, 64), dtype=np.uint8)
    depth = rng.integers(0, 65536, (48, 64), dtype=np.uint16)
    depth[:4] = 65535
    cv2.imwrite(str(tmp_path / "rgb.png"), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    cv2.imwrite(str(tmp_path / "gray.png"), gray)
    cv2.imwrite(str(tmp_path / "depth.png"), depth)
    for name in ("rgb.png", "gray.png", "depth.png"):
        p = str(tmp_path / name)
        assert np.array_equal(treader.load_image(p), jreader.load_image(p)), name
    p = str(tmp_path / "depth.png")
    assert np.array_equal(treader.load_depth(p), jreader.load_depth(p))
    assert np.array_equal(png.read(p), cv2.imread(p, cv2.IMREAD_ANYDEPTH))


IMAGES = {"rgb": lambda r: r.integers(0, 256, (37, 53, 3), dtype=np.uint8),
          "rgba": lambda r: r.integers(0, 256, (20, 33, 4), dtype=np.uint8),
          "gray": lambda r: r.integers(0, 256, (25, 41), dtype=np.uint8),
          "depth16": lambda r: r.integers(0, 65536, (30, 44), dtype=np.uint16),
          "smooth": lambda r: _smooth_rgb()}


@pytest.mark.parametrize("kind", sorted(IMAGES))
@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "mixed", png.ADAPTIVE])
def test_png_each_filter_type_decodes_bit_equal(tmp_path, kind, filters):
    rng = np.random.default_rng(1)
    img = IMAGES[kind](rng)
    ftypes = rng.integers(0, 5, img.shape[0]) if filters == "mixed" else filters
    p = str(tmp_path / "x.png")
    png.write(p, img, ftypes)
    want = img[..., :3] if img.ndim == 3 else img
    assert np.array_equal(png.read(p), want)
    ref = cv2.imread(p, cv2.IMREAD_UNCHANGED)   # OpenCV decodes the port's file too
    if ref.ndim == 3:
        ref = cv2.cvtColor(ref, cv2.COLOR_BGRA2RGBA if ref.shape[2] == 4 else cv2.COLOR_BGR2RGB)
    assert np.array_equal(ref, img)


@pytest.mark.parametrize("ftype", [2, 3, 4])
@pytest.mark.parametrize("bpp", [1, 2, 3, 4])
def test_native_unfilter_equals_python(ftype, bpp):
    rng = np.random.default_rng(ftype * 10 + bpp)
    filt = rng.integers(0, 256, 50 * bpp, dtype=np.uint8)
    for prior in (rng.integers(0, 256, filt.size, dtype=np.uint8),
                  np.zeros(filt.size, np.uint8)):
        raw = np.stack([np.concatenate([[0], prior]), np.concatenate([[ftype], filt])]
                       ).astype(np.uint8)   # the native helper takes the type-2-4 row
        assert np.array_equal(png.unfilter(raw, bpp)[1],
                              png.unfilter_row_py(ftype, filt, prior, bpp))


def test_numpy_unfilter_equals_python():
    rng = np.random.default_rng(5)
    bpp, H, stride = 3, 12, 30
    raw = rng.integers(0, 256, (H, 1 + stride), dtype=np.uint8)
    raw[:, 0] = rng.integers(0, 5, H)
    out = png.unfilter(raw, bpp)
    prior = np.zeros(stride, np.uint8)
    for y in range(H):
        row = png.unfilter_row_py(int(raw[y, 0]), raw[y, 1:], prior, bpp)
        assert np.array_equal(out[y], row), y
        prior = row


def test_native_unfilter_decodes_a_paeth_frame_fast(tmp_path):
    """The rows of a 480x640 RGB frame of Paeth rows unfilter in under 30
    ms (the pure-Python unfilter takes about a second); the whole frame
    decodes to itself."""
    p = str(tmp_path / "paeth.png")
    img = np.tile(_smooth_rgb(), (10, 10, 1))
    png.write(p, img, 4)
    assert np.array_equal(png.read(p), img)
    raw = png.filter_rows(img.reshape(img.shape[0], -1), 3, 4)
    assert np.array_equal(png.unfilter(raw, 3), img.reshape(img.shape[0], -1))
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        png.unfilter(raw, 3)
        times.append(time.perf_counter() - t0)
    print(f"480x640 Paeth frame: unfilter {1e3 * min(times):.2f} ms (best of 5)")
    assert min(times) < 0.030


@pytest.mark.parametrize("kind", sorted(IMAGES))
def test_adaptive_filter_picks_least_sum_of_abs(kind):
    """png.ADAPTIVE picks, per row, the filter type whose filtered bytes
    read as signed have the least sum of absolute values (the lowest type
    on a tie), as libpng's default heuristic does."""
    img = IMAGES[kind](np.random.default_rng(2))
    data = png.encode(img, png.ADAPTIVE)
    rows = (img.astype(">u2").view(np.uint8) if img.dtype == np.uint16 else img
            ).reshape(img.shape[0], -1)
    bpp = rows.shape[1] // img.shape[1]
    got = png.filter_types(data)
    for y in range(len(rows)):
        prior = rows[y - 1] if y else np.zeros_like(rows[0])
        costs = []
        for ftype in range(5):
            f = png.filter_rows(np.stack([prior, rows[y]]), bpp, [0, ftype])[1, 1:]
            costs.append(int(np.abs(f.view(np.int8).astype(np.int64)).sum()))
        assert got[y] == int(np.argmin(costs)), (y, costs)


def test_png_and_readers_raise_on_unsupported(tmp_path):
    img = _smooth_rgb()
    with pytest.raises(png.PNGError, match="not a PNG"):
        png.decode(b"GIF89a" + bytes(100))
    good = png.encode(img)
    with pytest.raises(png.PNGError, match="CRC"):
        png.decode(good[:40] + bytes([good[40] ^ 1]) + good[41:])
    # JPEG and TIFF frames read as the JAX package reads them (through
    # OpenCV); tests/test_torch_formats.py holds both codecs to it in full
    for ext in (".jpg", ".tiff"):
        q = str(tmp_path / f"f{ext}")
        cv2.imwrite(q, img)
        assert np.array_equal(treader.load_image(q), jreader.load_image(q)), ext
    with pytest.raises(NotImplementedError, match="LMDB"):
        treader.LMDBReader(str(tmp_path))


def test_png_rejects_interlaced_and_palette():
    import struct
    import zlib

    def chunk(t, b):
        return struct.pack(">I", len(b)) + t + b + struct.pack(">I", zlib.crc32(t + b))
    for ctype, interlace, what in ((2, 1, "interlaced"), (3, 0, "palette")):
        head = png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 8, ctype, 0, 0,
                                                          interlace))
        if ctype == 3:
            head += chunk(b"PLTE", bytes(6))
        data = head + chunk(b"IDAT", zlib.compress(bytes(20))) + chunk(b"IEND", b"")
        with pytest.raises(png.PNGError, match=what):
            png.decode(data)


# --------------------------------------------------------------- other readers

def test_colmap_pfm_npy_depth_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    d = rng.random((12, 17)).astype(np.float32) * 3
    d[0, :3] = 1e-6
    p = tmp_path / "x.geometric.bin"
    with open(p, "wb") as f:
        f.write(b"17&12&1&")
        f.write(d.tobytes())
    np.save(tmp_path / "d.npy", d)
    (tmp_path / "depth_est").mkdir()
    (tmp_path / "mask").mkdir()
    pfm = tmp_path / "depth_est" / "00.pfm"
    with open(pfm, "wb") as f:
        f.write(b"Pf\n17 12\n-1.0\n")
        f.write(np.flipud(d).astype("<f4").tobytes())
    cv2.imwrite(str(tmp_path / "mask" / "00_final.png"),
                (rng.random((12, 17)) > 0.3).astype(np.uint8) * 255)
    for path in (p, tmp_path / "d.npy", pfm):
        got, want = treader.load_depth(str(path)), jreader.load_depth(str(path))
        assert got.dtype == want.dtype and np.array_equal(got, want), path.name
    assert np.array_equal(treader.read_colmap_array(str(p)), jreader.read_colmap_array(str(p)))
    assert np.array_equal(treader.intrinsic_to_K([5, 6, 7, 8]),
                          jreader.intrinsic_to_K([5, 6, 7, 8]))


# ------------------------------------------------------------- resamplers

def _share(a, b):
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    return int(d.max()), float(np.mean(d > 0))


def _test_images():
    rng = np.random.default_rng(3)
    return {"random": rng.integers(0, 256, (480, 640, 3), dtype=np.uint8),
            "smooth": np.tile(_smooth_rgb(), (10, 10, 1))}


@pytest.mark.parametrize("src,dst", [((480, 640), (256, 341)), ((96, 128), (64, 85)),
                                     ((480, 640), (240, 320)), ((61, 77), (40, 50))])
def test_resize_area_equals_cv2(src, dst):
    for name, img in _test_images().items():
        x = img[:src[0], :src[1]]
        mx, share = _share(imgproc.resize_area(x, dst[1], dst[0]),
                           cv2.resize(x, dst[::-1], interpolation=cv2.INTER_AREA))
        print(f"INTER_AREA {src}->{dst} {name}: max {mx}, share {share:.2e}")
        assert mx <= 1 and share <= 0.005


@pytest.mark.parametrize("s", [0.666667, 0.7, 0.8, 1.0, 1.25, 1.4, 1.5])
def test_resize_linear_equals_cv2(s):
    for img in _test_images().values():
        x = img[:256, :352]
        th, tw = int(256 * s), int(352 * s)
        assert np.array_equal(imgproc.resize_linear(x, tw, th),
                              cv2.resize(x, (tw, th), interpolation=cv2.INTER_LINEAR))


@pytest.mark.parametrize("src,dst", [((480, 640), (256, 341)), ((256, 352), (384, 528)),
                                     ((256, 352), (170, 234)), ((37, 53), (64, 96))])
def test_resize_nearest_equals_cv2(src, dst):
    rng = np.random.default_rng(4)
    for x in (rng.random(src).astype(np.float32), rng.integers(0, 2, src, dtype=np.uint8)):
        assert np.array_equal(imgproc.resize_nearest(x, *dst),
                              cv2.resize(x, dst[::-1], interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("angle", [-29.3, -7.1, 0.5, 3.0, 12.7, 30.0])
def test_warp_affine_equals_cv2(angle):
    rng = np.random.default_rng(5)
    h, w = 256, 352
    c = (w / 2 - 0.5, h / 2 - 0.5)
    M = cv2.getRotationMatrix2D(c, angle, 1.0)
    assert np.array_equal(imgproc.rotation_matrix(c, angle, 1.0), M)
    for name, img in _test_images().items():
        mx, share = _share(imgproc.warp_affine(img[:h, :w], M, w, h, cubic=True),
                           cv2.warpAffine(img[:h, :w], M, (w, h), flags=cv2.INTER_CUBIC))
        print(f"cubic warp {angle} deg {name}: max {mx}, share {share:.2e}")
        assert mx <= 1 and share <= CUBIC_SHARE
    for x in (rng.random((h, w)).astype(np.float32), rng.random((64, 96)).astype(np.float32)):
        hh, ww = x.shape
        M2 = cv2.getRotationMatrix2D((ww / 2 - 0.5, hh / 2 - 0.5), angle, 1.0)
        assert np.array_equal(imgproc.warp_affine(x, M2, ww, hh, cubic=False),
                              cv2.warpAffine(x, M2, (ww, hh), flags=cv2.INTER_NEAREST))


@pytest.mark.parametrize("width", [1, 31, 64, 95])
def test_hsv_round_trip_equals_cv2(width):
    rng = np.random.default_rng(6)
    rgb = rng.integers(0, 256, (200, width, 3), dtype=np.uint8)
    hsv = cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV)
    assert np.array_equal(imgproc.rgb_to_hsv(rgb), hsv)
    hsv2 = rng.integers(0, 256, (200, width, 3), dtype=np.uint8)
    hsv2[..., 0] %= 180
    for x in (hsv, hsv2):
        assert np.array_equal(imgproc.hsv_to_rgb(x), cv2.cvtColor(x, cv2.COLOR_HSV2RGB))


# -------------------------------------------------------------- transforms

def _frame(rng, H=96, W=128):
    img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    depth = (rng.random((H, W)) * 4).astype(np.float32)
    mask = rng.random((H, W)) > 0.5
    Tcw = np.concatenate([np.linalg.qr(rng.normal(size=(3, 3)))[0], rng.normal(size=(3, 1))], 1)
    K = np.array([[80.0, 0, 64], [0, 80.0, 48], [0, 0, 1]])
    return img, depth, Tcw, K, mask


TRANSFORMS = [("ResizeAndCrop", {"target_size": 64, "base_image_size": 16}),
              ("ResizeAndCrop", {"target_size": 48, "base_image_size": 16}),
              ("PadToSize", {"height": 112, "width": 144}),
              ("RandomZoom", {"aug_scale_min": 0.666667, "aug_scale_max": 1.5}),
              ("RandomRotate", {"aug_rotation": 30.0}),
              ("ColorJitter", {}),
              ("DownSample", {"factor": 2.0}),
              ("RandomCrop", {})]


@pytest.mark.parametrize("name,kw", TRANSFORMS, ids=[t[0] + str(i) for i, t in
                                                     enumerate(TRANSFORMS)])
def test_transforms_equal_jax(name, kw):
    rng = np.random.default_rng(7)
    spec = [{name: kw}]
    jt, tt = jtf.build_transforms(spec), ttf.build_transforms(spec)
    worst = 0.0
    for trial in range(6):
        frame = _frame(rng)
        seed = 100 + trial
        pj = jt.sample_params(np.random.default_rng(seed))
        pt = tt.sample_params(np.random.default_rng(seed))
        assert pj == pt
        a, b = jt(*frame, params=pj), tt(*frame, params=pt)
        mx, share = _share(a[0], b[0])
        worst = max(worst, share)
        limit = (1, CUBIC_SHARE) if name == "RandomRotate" else (0, 0.0)
        assert a[0].dtype == b[0].dtype and mx <= limit[0] and share <= limit[1], (mx, share)
        for x, y in zip(a[1:], b[1:]):
            assert np.array_equal(x, y)
    print(f"{name}: share of uint8 values that differ (worst of 6) {worst:.2e}")


# ---------------------------------------------------------- samplers, store

def test_samplers_equal_jax():
    rng = np.random.default_rng(8)
    c2ws = np.stack([np.concatenate([np.concatenate([np.linalg.qr(rng.normal(size=(3, 3)))[0],
                                                     rng.normal(size=(3, 1))], 1),
                                     [[0, 0, 0, 1]]]) for _ in range(30)])
    assert np.array_equal(tsamplers.fps_poses(c2ws, 8, np.random.default_rng(1)),
                          jsamplers.fps_poses(c2ws, 8, np.random.default_rng(1)))
    pts = rng.normal(size=(500, 3)) * 2
    w2cs = np.linalg.inv(c2ws)
    Ks = np.tile(np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]]), (30, 1, 1))
    a = tsamplers.CovisibilitySampler(pts, w2cs, Ks, max_num_pts=300,
                                      rng=np.random.default_rng(2)).sample(10)
    b = jsamplers.CovisibilitySampler(pts, w2cs, Ks, max_num_pts=300,
                                      rng=np.random.default_rng(2)).sample(10)
    assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Two small scenes written by the port, with a data YAML carrying the
    7-Scenes transform pipeline scaled to their size."""
    root = tmp_path_factory.mktemp("scenes")
    for i, name in enumerate(["box0", "box1"]):
        tex, bh, rs = SCENE_VARIANTS[i]
        write_scene(str(root), scene=name, n_train=6, n_test=3, n_support=4, tex=tex,
                    box_half=bh, radius_scale=rs, H=72, W=96)
    data = root / "data.yaml"
    data.write_text(f"""base_dir: {root}
scenes: [box0, box1]
tempo_interval: 1
aug_ref_depth: true
TRANSFORM:
  - ResizeAndCrop: {{target_size: 48, base_image_size: 16}}
  - PadToSize: {{height: 48, width: 80}}
AUG_TRANSFORM:
  - RandomZoom: {{aug_scale_min: 0.666667, aug_scale_max: 1.5}}
  - RandomRotate: {{aug_rotation: 30.0}}
  - ColorJitter: {{brightness: 0.1, contrast: 0.1, saturation: 0.1, hue: 0.1}}
""")
    return str(root), str(data)


def test_scene_writer_equals_jax_tools(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from e2e_pose_study import write_scene as jwrite
    jwrite(str(tmp_path / "j"), scene="s", n_train=7, n_test=2, n_support=3, tex=1,
           box_half=1.5, radius_scale=0.9)
    write_scene(str(tmp_path / "t"), scene="s", n_train=7, n_test=2, n_support=3, tex=1,
                box_half=1.5, radius_scale=0.9)
    for name in ("info_train.pkl", "info_test.pkl", "image_retrieval_train_netvlad.pkl",
                 "image_retrieval_test_netvlad.pkl"):
        a = pickle.load(open(tmp_path / "j" / "s" / name, "rb"))
        b = pickle.load(open(tmp_path / "t" / "s" / name, "rb"))
        assert repr(a) == repr(b), name
    for fr in pickle.load(open(tmp_path / "t" / "s" / "info_train.pkl", "rb")):
        for key, read in (("file_name", jreader.load_image), ("depth_file_name",
                                                               jreader.load_depth)):
            assert np.array_equal(read(str(tmp_path / "t" / fr[key])),
                                  read(str(tmp_path / "j" / fr[key])))
    from nerfloc_tpu.data.ply import read_ply_points
    a, b = (read_ply_points(str(tmp_path / d / "s" / "pc.ply"))[0] for d in "jt")
    assert np.array_equal(a, b)


def test_scene_store_equals_jax(scenes):
    root, _ = scenes
    for kw in ({}, {"rescale_far_limit": 10.0}, {"near": 0.3, "far": 5.0, "scale_factor": 0.5},
               {"tempo_interval": 2}):
        a = tstore.SceneStore.load(root, "box1", **kw)
        b = jstore.SceneStore.load(root, "box1", **kw)
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert repr(x) == repr(y) if not isinstance(y, np.ndarray) else \
                np.array_equal(x, y), (kw, f.name)


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
            share = float(np.mean(x != y))
            assert share <= AUG_IMAGE_SHARE, (k, share)
        else:
            assert np.array_equal(x, y), k


def test_build_dataset_items_equal_jax(scenes):
    _, data = scenes
    ov = {"dataset_type": data, "n_views_train": 2, "n_views_test": 3,
          "support_image_selection": "retrieval"}
    tcfg, jcfg = tconfigs.load_config(None, ov), jconfigs.load_config(None, ov)
    for mode in ("train", "test"):
        t = tfactory.build_dataset(tcfg, mode, mode=mode)
        j = jfactory.build_dataset(jcfg, mode, mode=mode)
        assert len(t) == len(j) and t.scene_names() == j.scene_names()
        for epoch in ((0, 1) if mode == "train" else (0,)):
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            for i in range(len(j)):
                a, b = t[i], j[i]
                _assert_items_equal(a, b, aug=mode == "train")


@pytest.mark.parametrize("mode", ["coreset", "coreset+retrieval", "mvs"])
def test_support_modes_equal_jax(scenes, mode):
    _, data = scenes
    ov = {"dataset_type": data, "n_views_train": 3, "n_views_test": 3,
          "support_image_selection": mode, "image_core_set_size": 2}
    t = tfactory.build_dataset(tconfigs.load_config(None, ov), "test")
    j = jfactory.build_dataset(jconfigs.load_config(None, ov), "test")
    for i in range(len(j)):
        _assert_items_equal(t[i], j[i], aug=False)


def test_test_time_color_jitter_equals_jax(scenes):
    _, data = scenes
    ov = {"dataset_type": data, "n_views_test": 2, "test_time_color_jitter": True}
    t = tfactory.build_dataset(tconfigs.load_config(None, ov), "test")
    j = jfactory.build_dataset(jconfigs.load_config(None, ov), "test")
    _assert_items_equal(t[0], j[0], aug=False)


def test_factory_rejects_what_is_not_ported(scenes, tmp_path):
    # the blender, llff, dtu and colmap families are ported: their parity
    # tests are in tests/test_torch_scene_families.py
    bad = tmp_path / "bad.yaml"
    bad.write_text(open(scenes[1]).read().replace("TRANSFORM:", "transforms:", 1))
    with pytest.raises(ValueError, match="TRANSFORM"):
        tfactory.build_dataset(tconfigs.Config(dataset_type=str(bad)), "test")
    # object scenes (bboxes_3d.npy, in_box_pc.ply) build as the JAX package
    # builds them, their target masks included
    root = tmp_path / "obj"
    write_object_scene(str(root), scene="o", n_train=3, n_test=1, n_support=1, H=96, W=96)
    ov = {"dataset_type": scenes[1], "datadir": str(root), "scenes": ["o"], "n_views_test": 2}
    t = tfactory.build_dataset(tconfigs.load_config(None, ov), "test")
    j = jfactory.build_dataset(jconfigs.load_config(None, ov), "test")
    _assert_items_equal(t[0], j[0], aug=False)
    assert t[0]["target_mask"].any()


# ----------------------------------------------------------------- loader

class _Indexed:
    def __init__(self, n):
        self.n, self.epochs = n, []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"image": np.full((2,), i, np.float32)}

    def set_epoch(self, e):
        self.epochs.append(e)


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_order_equals_jax(drop_last):
    orders = []
    for mod in (tprefetch, jprefetch):
        ds = _Indexed(11)
        loader = mod.BatchLoader(ds, 3, shuffle=True, seed=5, num_workers=3,
                                 drop_last=drop_last)
        seen = [[b["image"][:, 0].astype(int).tolist() for b in loader.epoch(e)]
                for e in range(2)]
        orders.append((len(loader), seen, ds.epochs))
    assert orders[0] == orders[1]


def test_loader_raises_a_workers_error():
    class Broken(_Indexed):
        def __getitem__(self, i):
            raise RuntimeError("bad item")
    with pytest.raises(RuntimeError, match="bad item"):
        list(tprefetch.BatchLoader(Broken(4), 2).epoch(0))
