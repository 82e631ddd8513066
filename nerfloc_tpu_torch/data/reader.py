"""Frame IO: RGB images and depth maps (counterpart of
nerfloc_tpu/data/reader.py). The JAX package reads frames with OpenCV; the
port has its own decoders: PNG (data/png.py), baseline JPEG (data/jpeg.py,
libjpeg-turbo's arithmetic, as OpenCV decodes) and baseline TIFF
(data/tiff.py).

16-bit depth PNGs and TIFFs are millimetres (65535 = invalid), float TIFF
depth (OnePose's MVS maps) goes through the same arithmetic, as the JAX
package puts it (raw == 65535 -> 0, then / 1000, then < 1e-5 -> 0);
COLMAP `.geometric.bin` arrays and `.npy` files are metres, PFM depth keeps
the photometric mask beside it; depth is nearest-resized to the RGB
resolution and sub-millimetre values are zeroed. Colour TIFFs must hold
8-bit samples. LMDB stores raise NotImplementedError.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from . import jpeg, png, tiff
from .imgproc import resize_nearest

_JPEG = (".jpg", ".jpeg")
_TIFF = (".tif", ".tiff")


def _ext(path: str) -> str:
    return os.path.splitext(path)[1].lower()


def read_colmap_array(path: str) -> np.ndarray:
    """COLMAP dense array format (width&height&channels& header + f32 data)."""
    with open(path, "rb") as f:
        header = b""
        count = 0
        while count < 3:
            c = f.read(1)
            header += c
            if c == b"&":
                count += 1
        w, h, c = (int(x) for x in header[:-1].decode("ascii").split("&"))
        data = np.fromfile(f, dtype=np.float32, count=w * h * c)
    return data.reshape(h, w, c).squeeze()


def load_image(path: str) -> np.ndarray:
    """RGB uint8 [H, W, 3] (gray replicated, alpha dropped, 16-bit PNG
    samples cut to their high byte, as OpenCV's IMREAD_COLOR reads them)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    ext = _ext(path)
    if ext in _JPEG:
        return jpeg.read(path)
    if ext in _TIFF:
        img = tiff.read(path)
        if img.dtype != np.uint8:
            raise NotImplementedError(f"{path}: a {img.dtype} TIFF where an 8-bit colour "
                                      "image is read")
    else:
        img = png.read(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 3:
        img = img[..., :3]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    return img


def read_pfm(path: str) -> np.ndarray:
    """Portable float map (casMVSNet depth output)."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"{path}: not a PFM file")
        channels = 3 if header == b"PF" else 1
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, dtype=endian + "f4", count=w * h * channels)
    img = data.reshape(h, w, channels) if channels > 1 else data.reshape(h, w)
    return np.flipud(img).copy()  # PFM rows are bottom-up


def _read_gray(path: str) -> np.ndarray:
    """A one-channel PNG or TIFF at its own depth (OpenCV's
    IMREAD_ANYDEPTH)."""
    img = tiff.read(path) if _ext(path) in _TIFF else png.read(path)
    if img.ndim != 2:
        raise NotImplementedError(f"{path}: a colour image where a one-channel map is read")
    return img


def load_depth(path: str) -> np.ndarray:
    """Depth in metres, float32; invalid pixels = 0."""
    if path.endswith(".geometric.bin"):
        depth = read_colmap_array(path).astype(np.float32)
    elif path.endswith(".pfm"):
        depth = read_pfm(path).astype(np.float32)
        # casMVSNet layout keeps a photometric-consistency mask next to the
        # depth
        mask_path = path.replace("depth_est", "mask").replace(".pfm", "_final.png")
        if os.path.exists(mask_path):
            m = _read_gray(mask_path)
            if m.shape == depth.shape:
                depth = depth * (m > 0).astype(np.float32)
    elif path.endswith(".npy"):
        depth = np.load(path).astype(np.float32)
    else:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        raw = _read_gray(path).astype(np.float32)
        raw[raw == 65535] = 0  # 7Scenes invalid marker
        depth = raw / 1000.0  # mm -> m
    depth[depth < 1e-5] = 0.0
    return depth


class LMDBReader:
    """LMDB image stores are not ported: the port reads scene files."""

    def __init__(self, path: str):
        raise NotImplementedError(f"{path}: LMDB scene stores are not supported by the port")


def load_frame(base_dir: str, meta: Dict) -> Tuple[np.ndarray, np.ndarray,
                                                   np.ndarray, np.ndarray]:
    """(rgb uint8, depth m float32 at rgb res, Tcw [3,4], K [3,3]).

    meta keys follow the preprocessors' info pkl contract: file_name,
    depth_file_name, extrinsic_Tcw, camera_intrinsic.
    """
    img = load_image(os.path.join(base_dir, meta["file_name"]))
    H, W = img.shape[:2]
    dpath = os.path.join(base_dir, meta["depth_file_name"])
    if os.path.exists(dpath):
        depth = load_depth(dpath)
        if depth.shape[:2] != (H, W):
            depth = resize_nearest(depth, H, W)
    else:
        depth = np.zeros((H, W), dtype=np.float32)
    Tcw = np.asarray(meta["extrinsic_Tcw"], dtype=np.float64)[:3]
    K = intrinsic_to_K(meta["camera_intrinsic"])
    return img, depth.astype(np.float32), Tcw, K


def intrinsic_to_K(intr) -> np.ndarray:
    """Accept both encodings: a 3x3 matrix, or the preprocessors'
    [fx, fy, cx, cy, ...] parameter vector."""
    intr = np.asarray(intr, dtype=np.float64)
    if intr.ndim == 2:
        return intr
    K = np.eye(3)
    K[0, 0], K[1, 1], K[0, 2], K[1, 2] = intr[0], intr[1], intr[2], intr[3]
    return K
