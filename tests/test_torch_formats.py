"""The port's JPEG and TIFF readers, its rasterizers and its object-scene
items against OpenCV and the JAX package on the CPU.

The JAX package reads frames with cv2.imread and draws with cv2.fillPoly
and cv2.line; this test machine has OpenCV (5.0, its JPEG codec
libjpeg-turbo 3.1): it is the reference. Bounds:
- JPEG (cv2-written at quality 75 and 95, 4:4:4, 4:2:2, 4:2:0 and gray,
  with and without restart markers, at sizes that are not multiples of the
  MCU; and the port's own encoder's files): the helper's decode, the plain
  decode_py and the JAX package's load_image bit-equal. Subsampled chroma
  too: the fancy upsampling and the integer colour tables are
  libjpeg-turbo's.
- TIFF (cv2-written uint8 RGB, uint16 and float32 under compression none,
  LZW, Adobe Deflate, Deflate and PackBits with each predictor OpenCV
  writes; the port writer's strips and tiles in both byte orders): equal
  to cv2.imread(IMREAD_UNCHANGED) and the JAX package's load_depth, bit for
  bit.
- fill_poly equal to cv2.fillPoly on seeded convex hulls (inside the image,
  touching and crossing its border), thin slivers, triangles, and concave
  and self-crossing polygons inside the image. (OpenCV 5's scan conversion
  is taken as computing each edge's x at the row exactly and filling to
  the pixel before the right edge's; concave polygons that cross the
  border are not claimed: their clipped edges can differ.) line equal to
  cv2.line at thickness 1 and 2 on seeded segments, some with ends off the
  image (OpenCV 5 first clips a thick line to the image grown by its
  thickness).
- build_dataset items of an object scene (write_object_scene: PNG frames,
  float32 TIFF depth, the hull target mask) and of a 12-Scenes-layout
  scene whose JPEG frames cv2 wrote, in test and train mode: equal to the
  JAX package's, the train mode's images within test_torch_data.py's
  share for the cubic warp (the 12-Scenes transforms rotate).
"""
import pickle
import struct

import cv2
import numpy as np
import pytest
from scipy.spatial import ConvexHull

from nerfloc_tpu import configs as jconfigs
from nerfloc_tpu.data import factory as jfactory
from nerfloc_tpu.data import reader as jreader
from nerfloc_tpu.data.video_dataset import compute_target_mask as j_target_mask
from nerfloc_tpu_torch import configs as tconfigs
from nerfloc_tpu_torch.data import factory as tfactory
from nerfloc_tpu_torch.data import imgproc, jpeg, tiff
from nerfloc_tpu_torch.data import reader as treader
from nerfloc_tpu_torch.data.synthetic import write_object_scene, write_twelve_scenes_scene
from nerfloc_tpu_torch.data.video_dataset import compute_target_mask

AUG_IMAGE_SHARE = 0.005      # test_torch_data.py's bound for augmented images


def _natural(H, W, seed=0, gray=False):
    """Smooth colour waves plus noise: every DCT band and every chroma
    level the codec rounds."""
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 11.0 - c) for c in range(3)], -1)
    img = np.clip(img + r.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


# ---------------------------------------------------------------------- JPEG

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


@pytest.mark.parametrize("size", [(37, 53), (9, 5), (64, 48)])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "gray"])
@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("rst", [0, 3])
def test_jpeg_decodes_cv2_files_bit_equal(tmp_path, size, sampling, quality, rst):
    H, W = size
    img = _natural(H, W, seed=H * W, gray=sampling == "gray")
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling != "gray":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
        img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    if rst:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
    path = str(tmp_path / "f.jpg")
    assert cv2.imwrite(path, img, params)
    data = open(path, "rb").read()
    want = jreader.load_image(path)
    got = treader.load_image(path)
    assert got.dtype == np.uint8 and got.shape == want.shape == (H, W, 3)
    assert np.array_equal(got, want)
    assert np.array_equal(jpeg.decode_py(data), got)


@pytest.mark.parametrize("subsampling", ["420", "444"])
@pytest.mark.parametrize("quality", [50, 90])
def test_jpeg_own_encoder_files_decode_as_cv2_decodes_them(tmp_path, subsampling, quality):
    img = _natural(45, 70, seed=quality)
    path = str(tmp_path / "f.jpg")
    jpeg.write(path, img, quality, subsampling)
    got = treader.load_image(path)
    assert np.array_equal(got, jreader.load_image(path))
    assert np.array_equal(jpeg.decode_py(open(path, "rb").read()), got)
    # a lossy copy of the source
    psnr = 10 * np.log10(255 ** 2 / np.mean((got.astype(float) - img) ** 2))
    assert psnr > 25, psnr


def test_jpeg_helper_decodes_a_12scenes_frame(tmp_path):
    """A 1296x968 4:2:0 frame (12-Scenes' colour size) through the helper,
    against cv2."""
    img = _natural(968, 1296, seed=3)
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                           [cv2.IMWRITE_JPEG_QUALITY, 90])
    want = cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    assert np.array_equal(jpeg.decode(buf.tobytes()), want)


def _exif_orientation(o: int) -> bytes:
    ifd = struct.pack("<H", 1) + struct.pack("<HHIHH", 0x0112, 3, 1, o, 0) + struct.pack("<I", 0)
    tiff_hdr = b"II" + struct.pack("<HI", 42, 8) + ifd
    payload = b"Exif\0\0" + tiff_hdr
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


def test_jpeg_raises_on_what_it_does_not_decode(tmp_path):
    img = _natural(24, 40)
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError, match="progressive"):
        jpeg.decode(prog.tobytes())
    data = jpeg.encode(img)
    with pytest.raises(NotImplementedError, match="orientation 6"):
        jpeg.decode(data[:2] + _exif_orientation(6) + data[2:])
    assert np.array_equal(jpeg.decode(data[:2] + _exif_orientation(1) + data[2:]),
                          jpeg.decode(data))
    sof = data.index(b"\xff\xc0")
    with pytest.raises(ValueError, match="marker"):
        jpeg.decode(data[:sof] + b"\x12" + data[sof + 1:])
    ok, rst = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_RST_INTERVAL, 1])
    b = bytearray(rst.tobytes())
    at = b.index(b"\xff\xd0", b.index(b"\xff\xda"))
    b[at + 1] = 0xD3                       # a restart marker out of sequence
    with pytest.raises(ValueError, match="restart"):
        jpeg.decode(bytes(b))
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode(b"GIF89a" + bytes(64))


# ---------------------------------------------------------------------- TIFF

def _tiff_sources():
    r = np.random.default_rng(0)
    f32 = r.uniform(100, 3000, (37, 53)).astype(np.float32)
    f32[3:9, 4:20] = 0
    u16 = r.uniform(0, 5000, (37, 53)).astype(np.uint16)
    u16[0, :5] = 65535
    return {"u16": u16, "f32": f32, "u8c3": r.integers(0, 255, (37, 53, 3)).astype(np.uint8)}


CV2_TIFF = [(c, p) for c in (1, 5, 8, 32946, 32773) for p in (None, 1, 2, 3)]


@pytest.mark.parametrize("kind", ["u16", "f32", "u8c3"])
def test_tiff_reads_cv2_files_bit_equal(tmp_path, kind):
    img = _tiff_sources()[kind]
    written = 0
    for comp, pred in CV2_TIFF:
        path = str(tmp_path / f"{comp}_{pred}.tiff")
        params = [cv2.IMWRITE_TIFF_COMPRESSION, comp]
        if pred is not None:
            params += [cv2.IMWRITE_TIFF_PREDICTOR, pred]
        try:
            if not cv2.imwrite(path, img, params):
                continue
        except cv2.error:
            continue                      # a predictor OpenCV refuses for this type
        written += 1
        got = tiff.read(path)
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if got.ndim == 3:
            want = want[..., ::-1]        # OpenCV's BGR
        assert got.dtype == want.dtype and np.array_equal(got, want), (comp, pred)
        assert np.array_equal(got, img if got.ndim == 2 else img[..., ::-1]), (comp, pred)
        if kind != "u8c3":
            assert np.array_equal(treader.load_depth(path), jreader.load_depth(path)), (comp, pred)
        else:
            assert np.array_equal(treader.load_image(path), jreader.load_image(path)), (comp, pred)
    assert written >= 12


@pytest.mark.parametrize("kind", ["u16", "f32", "u8c3"])
@pytest.mark.parametrize("comp", [tiff.NONE, tiff.LZW, tiff.DEFLATE])
def test_tiff_writer_files_read_back_in_both_packages(tmp_path, kind, comp):
    img = _tiff_sources()[kind]
    preds = [1] if comp == tiff.NONE else ([1, 2, 3] if kind == "f32" else [1, 2])
    for pred in preds:
        for tile in (None, (16, 32)):
            for big in (False, True):
                path = str(tmp_path / "w.tiff")
                tiff.write(path, img, comp, pred, rows_per_strip=5, tile=tile, big_endian=big)
                want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
                got = tiff.read(path)
                if got.ndim == 3:
                    want = want[..., ::-1]
                assert np.array_equal(got, want) and np.array_equal(got, img), (pred, tile, big)


def test_tiff_lzw_helper_equals_python_and_unsupported_raises(tmp_path):
    img = _tiff_sources()["f32"]
    raw = img.tobytes() * 3
    enc = tiff.lzw_encode(raw)
    assert tiff.lzw_decode(enc, len(raw)) == tiff.lzw_decode_py(enc, len(raw)) == raw
    path = str(tmp_path / "x.tiff")
    tiff.write(path, img, tiff.LZW)
    buf = bytearray(open(path, "rb").read())
    at = buf.index(struct.pack("<HHI", 259, 3, 1))
    buf[at + 8:at + 10] = struct.pack("<H", 7)        # JPEG-in-TIFF
    open(path, "wb").write(bytes(buf))
    with pytest.raises(NotImplementedError, match="Compression=7"):
        tiff.read(path)
    tiff.write(path, img.astype(np.float32), tiff.NONE)
    with pytest.raises(NotImplementedError, match="float32 TIFF"):
        treader.load_image(path)


# --------------------------------------------------------------- rasterizers

def _polygons():
    r = np.random.default_rng(0)
    out = []
    for t in range(60):
        H, W = (int(r.integers(40, 300)),) * 2
        k = t % 6
        if k == 0:                          # a hull inside
            pts = r.uniform(0.1 * W, 0.9 * W, (15, 2))
            pts = pts[ConvexHull(pts).vertices]
        elif k == 1:                        # a hull crossing the border
            pts = r.uniform(-0.3 * W, 1.3 * W, (15, 2))
            pts = pts[ConvexHull(pts).vertices]
        elif k == 2:                        # a hull touching the border
            pts = r.uniform(0, W - 1, (12, 2))
            pts[:2, 0] = [0, W - 1]
            pts = pts[ConvexHull(pts).vertices]
        elif k == 3:                        # a thin sliver
            a, b = r.uniform(0, W, (2, 2))
            pts = np.array([a, b, b + r.uniform(-1.5, 1.5, 2)])
        elif k == 4:                        # concave, inside
            c = np.full(2, W / 2) + r.uniform(-1, 1, 2)
            ang = np.sort(r.uniform(0, 2 * np.pi, 9))
            rad = r.uniform(2, 0.45 * W, 9)
            pts = c + np.stack([rad * np.cos(ang), rad * np.sin(ang)], 1)
        else:                               # self-crossing, inside
            pts = r.uniform(0, W, (6, 2))
        out.append((H, W, pts.astype(np.int32)))
    return out


@pytest.mark.parametrize("case", range(60))
def test_fill_poly_equals_cv2(case):
    H, W, poly = _polygons()[case]
    want = np.zeros((H, W), np.uint8)
    cv2.fillPoly(want, [poly], 255)
    got = imgproc.fill_poly(np.zeros((H, W), np.uint8), poly, 255)
    assert np.array_equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("thickness", [1, 2])
def test_line_equals_cv2(thickness):
    r = np.random.default_rng(thickness)
    for t in range(300):
        H, W = (int(v) for v in r.integers(10, 90, 2))
        p = r.integers(0, [W, H])
        q = r.integers([-W, -H], [2 * W, 2 * H]) if t % 3 == 0 else r.integers(0, [W, H])
        if t % 7 == 0:
            q = p + r.integers(-2, 3, 2)
        want = np.zeros((H, W, 3), np.uint8)
        cv2.line(want, tuple(int(v) for v in p), tuple(int(v) for v in q), (0, 255, 0), thickness)
        got = imgproc.line(np.zeros((H, W, 3), np.uint8), p, q, (0, 255, 0), thickness)
        assert np.array_equal(got, want), (t, p, q)


def test_target_mask_equals_jax():
    r = np.random.default_rng(4)
    pts = r.uniform(-0.3, 0.3, (400, 3))
    K = np.array([[300.0, 0, 128], [0, 300, 96], [0, 0, 1]])
    for k in range(8):
        w2c = np.eye(4)
        w2c[:3, 3] = [r.uniform(-0.5, 0.5), r.uniform(-0.4, 0.4), r.uniform(0.6, 2.0)]
        a = compute_target_mask(pts, K, w2c, (192, 256))
        assert np.array_equal(a, j_target_mask(pts, K, w2c, (192, 256))), k
        assert 0 < a.sum() < a.size


# --------------------------------------------------------------------- items

def _items_equal(a, b, aug):
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


@pytest.fixture(scope="module")
def format_scenes(tmp_path_factory):
    """An object scene (OnePose layout) and a 12-Scenes-layout scene whose
    colour frames cv2 re-encodes, with data YAMLs carrying the families'
    transforms scaled to their size."""
    root = tmp_path_factory.mktemp("formats")
    write_object_scene(str(root), scene="obj", n_train=6, n_test=2, H=96, W=96)
    write_twelve_scenes_scene(str(root), scene="apt/k", n_train=5, n_test=2, H=100, W=130,
                              depth_hw=(48, 64))
    for fr in pickle.load(open(root / "apt" / "k" / "info_train.pkl", "rb")) + \
            pickle.load(open(root / "apt" / "k" / "info_test.pkl", "rb")):
        p = str(root / fr["file_name"])
        cv2.imwrite(p, cv2.imread(p), [cv2.IMWRITE_JPEG_QUALITY, 85])
    yamls = {}
    for name, aug in (("obj", "  - ColorJitter: {brightness: 0.1, contrast: 0.1, "
                              "saturation: 0.1, hue: 0.1}\n"),
                      ("apt/k", "  - RandomZoom: {aug_scale_min: 0.666667, aug_scale_max: 1.5}\n"
                                "  - RandomRotate: {aug_rotation: 30.0}\n"
                                "  - ColorJitter: {brightness: 0.1, contrast: 0.1, "
                                "saturation: 0.1, hue: 0.1}\n")):
        y = root / f"{name.replace('/', '_')}.yaml"
        y.write_text(f"base_dir: {root}\nscenes: [{name}]\ntempo_interval: 1\n"
                     "TRANSFORM:\n  - ResizeAndCrop: {target_size: 48, base_image_size: 16}\n"
                     "  - PadToSize: {height: 48, width: 64}\nAUG_TRANSFORM:\n" + aug)
        yamls[name] = str(y)
    return root, yamls


@pytest.mark.parametrize("scene", ["obj", "apt/k"])
@pytest.mark.parametrize("mode", ["test", "train"])
def test_items_equal_jax(format_scenes, scene, mode):
    _, yamls = format_scenes
    ov = {"dataset_type": yamls[scene], "n_views_train": 3, "n_views_test": 4,
          "support_image_selection": "coreset", "image_core_set_size": 4}
    t = tfactory.build_dataset(tconfigs.load_config(None, ov), mode, mode=mode)
    j = jfactory.build_dataset(jconfigs.load_config(None, ov), mode, mode=mode)
    assert len(t) == len(j) > 0
    for i in range(len(j)):
        a, b = t[i], j[i]
        _items_equal(a, b, aug=mode == "train" and scene != "obj")
        if scene == "obj":
            assert a["target_mask"].dtype == bool and 0 < a["target_mask"].sum()
            assert a["bbox3d_corners"].shape == (8, 3)


def test_object_scene_layout_is_the_onepose_preprocessors(format_scenes):
    root, _ = format_scenes
    sd = root / "obj"
    assert np.load(sd / "bboxes_3d.npy").shape == (1, 8, 3)
    test = pickle.load(open(sd / "info_test.pkl", "rb"))
    train = pickle.load(open(sd / "info_train.pkl", "rb"))
    assert {f["sequence_id"] for f in test} == {"obj-2"} and \
        {f["sequence_id"] for f in train} == {"obj-1"}
    fr = train[0]
    assert fr["depth_file_name"].endswith("_mvs.tiff") and fr["frame_dim"] == (96, 96)
    assert fr["camera_intrinsic"].shape == (6,)
    raw = tiff.read(str(root / fr["depth_file_name"]))
    assert raw.dtype == np.float32 and np.array_equal(raw, cv2.imread(
        str(root / fr["depth_file_name"]), cv2.IMREAD_UNCHANGED))
    depth = treader.load_depth(str(root / fr["depth_file_name"]))
    assert np.array_equal(depth, jreader.load_depth(str(root / fr["depth_file_name"])))
    assert fr["near"] <= depth.max() and depth.min() > 0
