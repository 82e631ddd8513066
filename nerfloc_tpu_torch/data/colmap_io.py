"""COLMAP sparse-model IO, text and binary (a copy of
nerfloc_tpu/data/colmap_io.py): cameras, images and points3D in both
encodings (format: colmap.github.io/format.html), and the quaternion <->
rotation conversions. numpy and struct only. One repair: the text reader
keeps an image whose observation line is empty (the JAX package's skips
that blank line and loses the image).
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

# camera model id -> (name, #params); subset used by the datasets
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
CAMERA_NUM_PARAMS = {name: n for _, (name, n) in CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    def K(self) -> np.ndarray:
        p = self.params
        if self.model == "SIMPLE_PINHOLE" or self.model == "SIMPLE_RADIAL":
            f, cx, cy = p[0], p[1], p[2]
            return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
        return np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]])


@dataclass
class Image:
    id: int
    qvec: np.ndarray    # [4] w,x,y,z world->cam rotation
    tvec: np.ndarray    # [3]
    camera_id: int
    name: str
    xys: np.ndarray     # [N, 2]
    point3D_ids: np.ndarray  # [N]

    def w2c(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = qvec2rotmat(self.qvec)
        T[:3, 3] = self.tvec
        return T


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion (w, x, y, z), Shepperd's method."""
    t = np.trace(R)
    if t > 0:
        w = 0.5 * np.sqrt(1.0 + t)
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0))
        v = np.zeros(3)
        v[i] = 0.5 * s
        s = 0.5 / max(s, 1e-12)
        w = (R[k, j] - R[j, k]) * s
        v[j] = (R[j, i] + R[i, j]) * s
        v[k] = (R[k, i] + R[i, k]) * s
        x, y, z = v
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


# ---------------------------------------------------------------------------
# binary encoding
# ---------------------------------------------------------------------------

def _rd(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path: str) -> Dict[int, Camera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _rd(f, "<Q")
        for _ in range(n):
            cid, mid, w, h = _rd(f, "<iiQQ")
            name, np_ = CAMERA_MODELS[mid]
            params = np.array(_rd(f, f"<{np_}d"))
            out[cid] = Camera(cid, name, int(w), int(h), params)
    return out


def write_cameras_bin(path: str, cameras: Dict[int, Camera]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for c in cameras.values():
            mid = CAMERA_MODEL_IDS[c.model]
            f.write(struct.pack("<iiQQ", c.id, mid, c.width, c.height))
            f.write(struct.pack(f"<{len(c.params)}d", *c.params))


def read_images_bin(path: str) -> Dict[int, Image]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _rd(f, "<Q")
        for _ in range(n):
            iid = _rd(f, "<i")[0]
            qvec = np.array(_rd(f, "<4d"))
            tvec = np.array(_rd(f, "<3d"))
            cam_id = _rd(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _rd(f, "<Q")
            if npts:
                raw = _rd(f, "<" + "ddq" * npts)
                xys = np.array(raw).reshape(-1, 3)[:, :2]
                pids = np.array(raw[2::3], dtype=np.int64)
            else:
                xys = np.zeros((0, 2))
                pids = np.zeros((0,), np.int64)
            out[iid] = Image(iid, qvec, tvec, cam_id, name.decode("utf-8"),
                             xys, pids)
    return out


def write_images_bin(path: str, images: Dict[int, Image]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            npts = len(im.xys)
            f.write(struct.pack("<Q", npts))
            for xy, pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", xy[0], xy[1], int(pid)))


def read_points3d_bin(path: str) -> Dict[int, Point3D]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _rd(f, "<Q")
        for _ in range(n):
            (pid,) = _rd(f, "<Q")
            xyz = np.array(_rd(f, "<3d"))
            rgb = np.array(_rd(f, "<3B"))
            (err,) = _rd(f, "<d")
            (track_len,) = _rd(f, "<Q")
            track = np.array(_rd(f, f"<{2 * track_len}i")).reshape(-1, 2) \
                if track_len else np.zeros((0, 2), np.int32)
            out[pid] = Point3D(int(pid), xyz, rgb, err,
                               track[:, 0], track[:, 1])
    return out


def write_points3d_bin(path: str, points: Dict[int, Point3D]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack("<Q", p.id))
            f.write(struct.pack("<3d", *p.xyz))
            f.write(struct.pack("<3B", *p.rgb.astype(np.uint8)))
            f.write(struct.pack("<d", p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for iid, p2 in zip(p.image_ids, p.point2D_idxs):
                f.write(struct.pack("<ii", int(iid), int(p2)))


# ---------------------------------------------------------------------------
# text encoding
# ---------------------------------------------------------------------------

def write_cameras_txt(path: str, cameras: Dict[int, Camera]):
    with open(path, "w") as f:
        f.write("# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for c in cameras.values():
            params = " ".join(repr(float(x)) for x in c.params)
            f.write(f"{c.id} {c.model} {c.width} {c.height} {params}\n")


def read_cameras_txt(path: str) -> Dict[int, Camera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out[int(parts[0])] = Camera(
                int(parts[0]), parts[1], int(parts[2]), int(parts[3]),
                np.array([float(x) for x in parts[4:]]))
    return out


def write_images_txt(path: str, images: Dict[int, Image]):
    with open(path, "w") as f:
        f.write("# Image list: IMAGE_ID, QW QX QY QZ, TX TY TZ, CAMERA_ID, "
                "NAME then POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for im in images.values():
            q = " ".join(repr(float(x)) for x in im.qvec)
            t = " ".join(repr(float(x)) for x in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            obs = " ".join(f"{x} {y} {int(pid)}" for (x, y), pid in
                           zip(im.xys, im.point3D_ids))
            f.write(obs + "\n")


def read_images_txt(path: str) -> Dict[int, Image]:
    """Two lines per image: its header, then its observations (an empty
    line for an image without any; blank lines are not skipped there)."""
    out = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if not ln.startswith("#")]
    i = 0
    while i < len(lines):
        head = lines[i]
        if not head:
            i += 1
            continue
        obs = lines[i + 1] if i + 1 < len(lines) else ""
        i += 2
        p = head.split()
        iid = int(p[0])
        toks = obs.split()
        if toks:
            arr = np.array(toks, dtype=np.float64).reshape(-1, 3)
            xys, pids = arr[:, :2], arr[:, 2].astype(np.int64)
        else:
            xys = np.zeros((0, 2))
            pids = np.zeros((0,), np.int64)
        out[iid] = Image(iid, np.array([float(x) for x in p[1:5]]),
                         np.array([float(x) for x in p[5:8]]), int(p[8]),
                         p[9], xys, pids)
    return out


def write_points3d_txt(path: str, points: Dict[int, Point3D]):
    with open(path, "w") as f:
        f.write("# 3D point list: POINT3D_ID, X Y Z, R G B, ERROR, "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        for pt in points.values():
            xyz = " ".join(repr(float(x)) for x in pt.xyz)
            rgb = " ".join(str(int(x)) for x in pt.rgb)
            track = " ".join(f"{int(i)} {int(j)}" for i, j in
                             zip(pt.image_ids, pt.point2D_idxs))
            f.write(f"{pt.id} {xyz} {rgb} {pt.error} {track}\n")


def read_points3d_txt(path: str) -> Dict[int, Point3D]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            pid = int(p[0])
            track = np.array(p[8:], dtype=np.int64).reshape(-1, 2) \
                if len(p) > 8 else np.zeros((0, 2), np.int64)
            out[pid] = Point3D(pid, np.array([float(x) for x in p[1:4]]),
                               np.array([int(x) for x in p[4:7]]),
                               float(p[7]), track[:, 0], track[:, 1])
    return out


# ---------------------------------------------------------------------------
# model-level helpers
# ---------------------------------------------------------------------------

def read_model(path: str, ext: str = ".bin"):
    r = {".bin": (read_cameras_bin, read_images_bin, read_points3d_bin),
         ".txt": (read_cameras_txt, read_images_txt, read_points3d_txt)}[ext]
    return (r[0](os.path.join(path, "cameras" + ext)),
            r[1](os.path.join(path, "images" + ext)),
            r[2](os.path.join(path, "points3D" + ext)))


def write_model(path: str, cameras, images, points, ext: str = ".bin"):
    os.makedirs(path, exist_ok=True)
    w = {".bin": (write_cameras_bin, write_images_bin, write_points3d_bin),
         ".txt": (write_cameras_txt, write_images_txt, write_points3d_txt)}[ext]
    w[0](os.path.join(path, "cameras" + ext), cameras)
    w[1](os.path.join(path, "images" + ext), images)
    w[2](os.path.join(path, "points3D" + ext), points)
