"""Procedural synthetic RGB-D scenes for tests and benchmarks.

A camera inside an axis-aligned textured box gives analytically consistent
multi-view RGB-D: depth = ray/box exit distance, color = smooth 3D texture
at the hit point. `make_query_batch` builds one in-memory query with the
per-item dict contract (image/pose/K/depth/near/far/topk_* fields);
`write_scene` writes a whole scene to disk in the preprocessors' layout
(PNG frames through data/png.py, info and retrieval pkls, pc.ply), as the
JAX package's tools/e2e_pose_study.write_scene does; `write_object_scene`
writes an object scene in the OnePose preprocessor's layout (a textured
object box inside the room, float32 MVS depth as TIFF) and
`write_twelve_scenes_scene` a scene in the 12-Scenes preprocessor's layout
(JPEG colour frames larger than their 16-bit depth PNGs). The
`write_*_raw` writers produce the datasets' raw layouts, which the
preprocessors read (7-Scenes, 12-Scenes, OnePose, Cambridge Landmarks), and
`write_colmap_workspace` a COLMAP dense workspace.
"""
from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import numpy as np

from . import jpeg, png, tiff
from .colmap_io import Camera, Image, Point3D, rotmat2qvec, write_model
from .ply import write_ply_points

# (texture variant, box half-extent, camera orbit radius scale) of visually
# distinct scenes
SCENE_VARIANTS = [
    (0, 2.0, 1.0),
    (1, 1.5, 0.9),
    (2, 2.6, 1.2),
    (3, 2.2, 0.8),
]


def texture(p: np.ndarray, tex: int = 0) -> np.ndarray:
    """Smooth 3D color field in [0, 1]; p [..., 3] -> [..., 3].

    tex selects a texture variant: 0 is the original field (golden-pinned by
    existing tests); tex > 0 draws deterministic frequencies/phases so
    multi-scene studies get visually DISTINCT scenes one conditional model
    must disambiguate purely via its support views (the reference's
    scene-agnostic claim, pl/model.py:192-261 per-scene table)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    if tex == 0:
        r = 0.5 + 0.35 * np.sin(1.7 * x + 0.3) + 0.15 * np.sin(3.1 * y * z)
        g = 0.5 + 0.35 * np.sin(2.3 * y - 1.1) + 0.15 * np.sin(2.9 * x * z + 1.0)
        b = 0.5 + 0.35 * np.cos(1.9 * z + 0.7) + 0.15 * np.sin(2.2 * x * y - 0.5)
    else:
        rng = np.random.default_rng(1000 + tex)
        f = rng.uniform(1.2, 3.2, size=(3,))
        g2 = rng.uniform(1.8, 3.4, size=(3,))
        ph = rng.uniform(0.0, 2 * np.pi, size=(6,))
        axes = [x, y, z]
        order = rng.permutation(3)
        cross = [axes[order[0]] * axes[order[1]],
                 axes[order[1]] * axes[order[2]],
                 axes[order[2]] * axes[order[0]]]
        r = 0.5 + 0.35 * np.sin(f[0] * axes[order[0]] + ph[0]) \
            + 0.15 * np.sin(g2[0] * cross[0] + ph[3])
        g = 0.5 + 0.35 * np.sin(f[1] * axes[order[1]] + ph[1]) \
            + 0.15 * np.sin(g2[1] * cross[1] + ph[4])
        b = 0.5 + 0.35 * np.cos(f[2] * axes[order[2]] + ph[2]) \
            + 0.15 * np.sin(g2[2] * cross[2] + ph[5])
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)


def render_box_view(c2w: np.ndarray, K: np.ndarray, H: int, W: int,
                    box_half: float = 2.0, tex: int = 0):
    """Render RGB + z-depth of the textured box interior from one camera."""
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64), indexing="xy")
    d_cam = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                      np.ones_like(u)], axis=-1)  # [H, W, 3], z=1
    R, t = c2w[:3, :3], c2w[:3, 3]
    d_w = d_cam @ R.T
    o = t

    # exit distance from the box |p_i| <= box_half along each axis
    with np.errstate(divide="ignore", invalid="ignore"):
        t_axis = np.where(
            np.abs(d_w) < 1e-12, np.inf,
            (np.sign(d_w) * box_half - o) / d_w,
        )
    t_hit = np.min(np.where(t_axis > 0, t_axis, np.inf), axis=-1)  # [H, W]
    pts = o + d_w * t_hit[..., None]
    rgb = texture(pts, tex).astype(np.float32)
    depth = t_hit.astype(np.float32)  # z-depth: d_cam z-component is 1
    return rgb, depth


def look_at_pose(eye: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)):
    """OpenCV-convention camera-to-world (z forward, y down)."""
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, dtype=np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = x, y, z, eye
    return T


def make_query_batch(n_views: int = 5, H: int = 48, W: int = 64,
                     seed: int = 0, box_half: float = 2.0) -> Dict[str, np.ndarray]:
    """One localization query + support set over the synthetic box scene,
    matching the reference batch contract (dataset.py:478-499)."""
    rng = np.random.default_rng(seed)
    f = 0.8 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], dtype=np.float64)

    def sample_pose(angle):
        eye = np.array([0.35 * np.cos(angle), 0.1 * np.sin(2 * angle),
                        0.35 * np.sin(angle)])
        target = np.array([2.0 * np.cos(angle), 0.3 * np.sin(angle),
                           2.0 * np.sin(angle)])
        return look_at_pose(eye, target)

    base = rng.uniform(0, 2 * np.pi)
    query_pose = sample_pose(base)
    support_angles = base + np.linspace(-0.25, 0.25, n_views) + \
        rng.normal(0, 0.02, n_views)
    topk_poses = np.stack([sample_pose(a) for a in support_angles])

    img_q, depth_q = render_box_view(query_pose, K, H, W, box_half)
    imgs, depths = [], []
    for p in topk_poses:
        im, de = render_box_view(p, K, H, W, box_half)
        imgs.append(im)
        depths.append(de)

    return {
        "image": img_q,
        "depth": depth_q,
        "pose": query_pose.astype(np.float32),
        "K": K.astype(np.float32),
        "near": np.float32(0.5),
        "far": np.float32(2.0 * box_half * np.sqrt(3.0)),
        "topk_images": np.stack(imgs),
        "topk_depths": np.stack(depths),
        "topk_poses": topk_poses.astype(np.float32),
        "topk_Ks": np.tile(K.astype(np.float32), (n_views, 1, 1)),
        "scene": "synthetic_box",
        "scale_factor": np.float32(1.0),
        "filename": f"synthetic_{seed}",
    }


def _orbit(n: int, angle0: float, step: float, r_eye: float, r_tgt: float,
           orbit_jitter: float):
    """Camera-to-world poses and angles of n views on write_scene's orbit:
    eyes on a circle of radius r_eye (a little up and down), each looking
    at the point at angle `ang` on the circle of radius r_tgt (the centre
    when r_tgt is 0)."""
    poses, angles = [], []
    for i in range(n):
        ang = angle0 + step * i
        # orbit_jitter > 0 modulates the orbit's radius and height
        # (deterministically): depth parallax breaks the near-planar PnP
        # gauge of a constant-radius orbit
        rj = 1.0 + orbit_jitter * np.sin(2.39996 * ang + 0.7)
        hj = 1.0 + 3.0 * orbit_jitter * np.cos(1.61803 * ang)
        eye = np.array([r_eye * rj * np.cos(ang),
                        r_eye / 6.0 * hj * np.sin(3 * ang),
                        r_eye * rj * np.sin(ang)])
        tgt = np.array([r_tgt * np.cos(ang), 0.0, r_tgt * np.sin(ang)])
        poses.append(look_at_pose(eye, tgt))
        angles.append(ang)
    return poses, np.asarray(angles)


def _write_splits(sd: str, train, test, a_train, a_test, n_support: int) -> None:
    """info_{train,test}.pkl and image_retrieval_{train,test}_netvlad.pkl:
    the n_support train views nearest in orbit angle (itself excluded for a
    train view)."""
    for split, frames in (("train", train), ("test", test)):
        with open(os.path.join(sd, f"info_{split}.pkl"), "wb") as fh:
            pickle.dump(frames, fh)

    def nearest_train(ang, exclude=None):
        d = np.abs(np.angle(np.exp(1j * (a_train - ang))))
        order = [j for j in np.argsort(d) if train[j]["file_name"] != exclude]
        return [train[j]["file_name"] for j in order[:n_support]]

    retrieval = {fr["file_name"]: nearest_train(ang, fr["file_name"])
                 for fr, ang in zip(train, a_train)}
    retrieval.update({fr["file_name"]: nearest_train(ang) for fr, ang in zip(test, a_test)})
    for split in ("train", "test"):
        with open(os.path.join(sd, f"image_retrieval_{split}_netvlad.pkl"), "wb") as fh:
            pickle.dump(retrieval, fh)


def _backproject(c2ws, K, W: int, H: int, render, h: int = 24, w: int = 32) -> np.ndarray:
    """World points of a sparse (h x w) back-projection of each view's
    depth (render(c2w, K, h, w) -> rgb, depth), as the JAX package's
    tools/e2e_pose_study.write_scene makes them: the depth rendered with
    the full-size intrinsics, lifted with the scaled ones."""
    pts = []
    for c2w in c2ws:
        _, depth = render(c2w, K, h, w)
        f2 = K.copy()
        f2[0] *= w / W
        f2[1] *= h / H
        u, v = np.meshgrid(np.arange(w), np.arange(h))
        x = (u - f2[0, 2]) / f2[0, 0] * depth
        y = (v - f2[1, 2]) / f2[1, 1] * depth
        pc = np.stack([x, y, depth], -1).reshape(-1, 3)
        pts.append(pc @ c2w[:3, :3].T + c2w[:3, 3])
    return np.concatenate(pts)


def write_scene(root: str, scene: str = "box", n_train: int = 48, n_test: int = 8,
                n_support: int = 6, tex: int = 0, box_half: float = 2.0,
                radius_scale: float = 1.0, orbit_jitter: float = 0.0,
                H: int = 96, W: int = 128) -> None:
    """Write `root/scene`: train views on a full circle of an orbit inside
    the box and test views between them, as H x W RGB PNGs and 16-bit
    millimetre depth PNGs (each row filtered as libpng chooses by default,
    png.ADAPTIVE: mostly Paeth in the RGB frames, Up in the depth);
    info_{train,test}.pkl; the `n_support` nearest
    train views of each frame (itself excluded for train frames) as
    image_retrieval_{split}_netvlad.pkl; and pc.ply from a sparse
    back-projection of every sixth train view."""
    sd = os.path.join(root, scene)
    os.makedirs(os.path.join(sd, "seq0"), exist_ok=True)
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    near = 0.25 * box_half
    far = 2.0 * box_half * np.sqrt(3.0) + 0.1
    r_eye = 0.3 * radius_scale * box_half / 2.0

    def render(c2w, K_, h, w):
        return render_box_view(c2w, K_, h, w, box_half=box_half, tex=tex)

    def make_frames(n, split, angle0, step):
        poses, angles = _orbit(n, angle0, step, r_eye, box_half, orbit_jitter)
        frames = []
        for i, c2w in enumerate(poses):
            rgb, depth = render(c2w, K, H, W)
            img_name = f"{scene}/seq0/{split}_frame{i}.png"
            dep_name = f"{scene}/seq0/{split}_frame{i}.depth.png"
            png.write(os.path.join(root, img_name), (rgb * 255).astype(np.uint8),
                      png.ADAPTIVE)
            png.write(os.path.join(root, dep_name), (depth * 1000).astype(np.uint16),
                      png.ADAPTIVE)
            frames.append({
                "file_name": img_name,
                "depth_file_name": dep_name,
                "extrinsic_Tcw": np.linalg.inv(c2w)[:3],
                "camera_intrinsic": K,
                "near": near,
                "far": far,
                "sequence_id": "seq0",
                "frame_id": i,
            })
        return frames, angles

    train, a_train = make_frames(n_train, "train", 0.0, 2 * np.pi / n_train)
    test, a_test = make_frames(n_test, "test", 2 * np.pi / n_train * 0.37,
                               2 * np.pi / n_test)
    _write_splits(sd, train, test, a_train, a_test, n_support)
    c2ws = [np.linalg.inv(np.vstack([fr["extrinsic_Tcw"], [0, 0, 0, 1]])) for fr in train[::6]]
    write_ply_points(os.path.join(sd, "pc.ply"), _backproject(c2ws, K, W, H, render))


# the object box's corners in OnePose's order: 0 the origin corner; 1, 3
# and 4 its neighbours along the three edges
_BOX_SIGNS = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                       [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float64)


def render_object_view(c2w: np.ndarray, K: np.ndarray, H: int, W: int,
                       obj_half, room_half: float = 3.0, tex: int = 1):
    """RGB + z-depth of an axis-aligned textured object box (half extents
    obj_half [3], texture variant tex) at the origin, inside the textured
    room of render_box_view (half extent room_half, texture 0)."""
    rgb, depth = render_box_view(c2w, K, H, W, box_half=room_half, tex=0)
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64),
                       indexing="xy")
    d = np.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1], np.ones_like(u)],
                 axis=-1) @ c2w[:3, :3].T
    o = c2w[:3, 3]
    h = np.asarray(obj_half, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        t1, t2 = (-h - o) / d, (h - o) / d
    tmin = np.max(np.minimum(t1, t2), axis=-1)
    tmax = np.min(np.maximum(t1, t2), axis=-1)
    hit = (tmax >= tmin) & (tmin > 0) & (tmin < depth)
    pts = o + d * tmin[..., None]
    obj_rgb = texture(pts * 4.0, tex).astype(np.float32)
    rgb = np.where(hit[..., None], obj_rgb, rgb)
    depth = np.where(hit, tmin, depth).astype(np.float32)
    return rgb, depth


def write_object_scene(root: str, scene: str = "0000-synthetic-box", n_train: int = 20,
                       n_test: int = 2, n_support: int = 6, H: int = 512, W: int = 512,
                       obj_half=(0.35, 0.25, 0.3), tex: int = 1, radius: float = 1.6,
                       n_points: int = 4096) -> None:
    """An object scene in the OnePose preprocessor's output layout under
    root/scene: bboxes_3d.npy [1, 8, 3], pc.ply and in_box_pc.ply (the
    points inside the box), <scene>-1 (train) and <scene>-2 (test, the last
    sequence) with color/<i>.png and depth/<i>_mvs.tiff (float32 millimetres, which
    the readers divide by 1000 as they do OnePose's; Deflate with the
    floating-point predictor), info_{train,test}.pkl as
    the preprocessor writes them (intrinsics as [fx, fy, cx, cy, 0, 0],
    frame_dim, near/far from the visible object points), and retrieval
    pkls. Cameras orbit the object, looking at it."""
    sd = os.path.join(root, scene)
    seqs = (f"{scene}-1", f"{scene}-2")
    for seq in seqs:
        for sub in ("color", "depth"):
            os.makedirs(os.path.join(sd, seq, sub), exist_ok=True)
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    corners = _BOX_SIGNS * np.asarray(obj_half)
    np.save(os.path.join(sd, "bboxes_3d.npy"), corners[None])

    def render(c2w, K_, h, w):
        return render_object_view(c2w, K_, h, w, obj_half, tex=tex)

    rng = np.random.default_rng(tex)
    surface = rng.uniform(-1, 1, (n_points, 3)) * np.asarray(obj_half)
    face = rng.integers(0, 3, n_points)
    rows = np.arange(n_points)
    surface[rows, face] = np.sign(surface[rows, face]) * np.asarray(obj_half)[face]

    def make_frames(n, seq, angle0, step):
        poses, angles = _orbit(n, angle0, step, radius, 0.0, 0.15)
        frames = []
        for i, c2w in enumerate(poses):
            rgb, depth = render(c2w, K, H, W)
            name = os.path.join(scene, seq, "color", f"{i}.png")
            dname = os.path.join(scene, seq, "depth", f"{i}_mvs.tiff")
            png.write(os.path.join(root, name), (rgb * 255).astype(np.uint8))
            tiff.write(os.path.join(root, dname), depth * np.float32(1000), tiff.DEFLATE,
                       predictor=3)
            Tcw = np.linalg.inv(c2w)
            z = (surface @ Tcw[:3, :3].T + Tcw[:3, 3])[:, 2]
            frames.append({
                "file_name": name,
                "frame_id": i,
                "sequence_id": seq,
                "depth_file_name": dname,
                "extrinsic_Tcw": Tcw[:3].astype(np.float32),
                "camera_intrinsic": np.array([f, f, W / 2, H / 2, 0.0, 0.0], np.float32),
                "frame_dim": (H, W),
                "near": float(z[z > 0].min()),
                "far": float(z[z > 0].max()),
            })
        return frames, angles

    # the orbits start off the axes: a view at eye height 0 on an axis sees
    # a mirror-symmetric room (exact KNN ties)
    train, a_train = make_frames(n_train, seqs[0], 0.05, 2 * np.pi / n_train)
    test, a_test = make_frames(n_test, seqs[1], 2 * np.pi / n_train * 0.37,
                               2 * np.pi / max(n_test, 1))
    _write_splits(sd, train, test, a_train, a_test, n_support)
    room = _backproject([np.linalg.inv(np.vstack([fr["extrinsic_Tcw"], [0, 0, 0, 1]]))
                         for fr in train[::4]], K, W, H, render)
    write_ply_points(os.path.join(sd, "pc.ply"), np.concatenate([room, surface]))
    write_ply_points(os.path.join(sd, "in_box_pc.ply"), surface.astype(np.float32))


def write_twelve_scenes_scene(root: str, scene: str = "apt1/kitchen", n_train: int = 20,
                              n_test: int = 2, n_support: int = 6, H: int = 968,
                              W: int = 1296, depth_hw=(480, 640), tex: int = 2,
                              box_half: float = 2.0, quality: int = 90) -> None:
    """A scene in the 12-Scenes preprocessor's output layout under
    root/<place>/<scene>: data/frame-XXXXXX.color.jpg (H x W, 4:2:0, the
    port's JPEG encoder), data/frame-XXXXXX.depth.png (depth_hw, 16-bit
    millimetres), info_{train,test}.pkl as the preprocessor writes them
    (the test frames first, intrinsics [f, f, W/2, H/2, 0, 0], sequence
    "0", frame_dim (H, W), per-frame near/far as depth percentiles),
    retrieval pkls and pc.ply. write_scene's orbit inside the textured
    room."""
    sd = os.path.join(root, scene)
    os.makedirs(os.path.join(sd, "data"), exist_ok=True)
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    dh, dw = depth_hw
    Kd = K.copy()
    Kd[0] *= dw / W
    Kd[1] *= dh / H
    r_eye = 0.3 * box_half / 2.0
    counter = [0]

    def make_frames(n, angle0, step):
        poses, angles = _orbit(n, angle0, step, r_eye, box_half, 0.3)
        frames = []
        for c2w in poses:
            fid = counter[0]
            counter[0] += 1
            rgb, _ = render_box_view(c2w, K, H, W, box_half=box_half, tex=tex)
            _, depth = render_box_view(c2w, Kd, dh, dw, box_half=box_half, tex=tex)
            name = os.path.join(scene, "data", f"frame-{fid:06d}.color.jpg")
            dname = name.replace("color.jpg", "depth.png")
            jpeg.write(os.path.join(root, name), (rgb * 255).astype(np.uint8), quality)
            mm = (depth * 1000).astype(np.uint16)
            png.write(os.path.join(root, dname), mm)
            d = mm.astype(np.float32).reshape(-1) / 1000.0
            frames.append({
                "file_name": name,
                "depth_file_name": dname,
                "extrinsic_Tcw": np.linalg.inv(c2w)[:3].astype(np.float32),
                "camera_intrinsic": np.array([f, f, W / 2, H / 2, 0.0, 0.0], np.float32),
                "near": float(np.percentile(d, 0.1)),
                "far": float(np.percentile(d, 99.9)),
                "sequence_id": "0",
                "frame_id": fid,
                "frame_dim": (H, W),
            })
        return frames, angles

    test, a_test = make_frames(n_test, 2 * np.pi / n_train * 0.37, 2 * np.pi / max(n_test, 1))
    train, a_train = make_frames(n_train, 0.05, 2 * np.pi / n_train)
    _write_splits(sd, train, test, a_train, a_test, n_support)

    def render(c2w, K_, h, w):
        return render_box_view(c2w, K_, h, w, box_half=box_half, tex=tex)
    c2ws = [np.linalg.inv(np.vstack([fr["extrinsic_Tcw"], [0, 0, 0, 1]])) for fr in train[::6]]
    write_ply_points(os.path.join(sd, "pc.ply"), _backproject(c2ws, K, W, H, render))


# ---------------------------------------------------------------------------
# Raw dataset layouts: what the preprocessors (nerfloc_tpu_torch/preprocess/)
# read, as the datasets ship it. The writers above produce their output.
# ---------------------------------------------------------------------------

def _mm(depth: np.ndarray, max_depth=None) -> np.ndarray:
    """Depth in metres -> uint16 millimetres, 65535 (the sensors' invalid
    marker) beyond max_depth."""
    mm = (depth * 1000).astype(np.uint16)
    if max_depth is not None:
        mm[depth > max_depth] = 65535
    return mm


def _each(fn, jobs) -> None:
    """fn(job) for every job on a few threads (numpy and zlib release the
    interpreter lock in their loops)."""
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for _ in pool.map(fn, jobs):
            pass


def write_seven_scenes_raw(root: str, scene: str = "chess", train_seqs=(1, 2),
                           test_seqs=(3,), n_frames: int = 30, H: int = 480, W: int = 640,
                           focal: float = 525.0, box_half: float = 2.0, tex: int = 0,
                           max_depth=3.5, rendered_depth: bool = False) -> None:
    """A scene in 7-Scenes' raw layout under root/scene:
    seq-XX/frame-XXXXXX.{color.png,depth.png,pose.txt} (RGB PNG, 16-bit
    millimetre depth PNG with 65535 beyond max_depth as the Kinect leaves
    it, 4x4 camera-to-world text), TrainSplit.txt and TestSplit.txt
    ('sequenceN' lines) and, with rendered_depth, the train frames' full
    depth as 16-bit millimetre TIFFs under
    rendered_depth/train/depth/seqXX_frame-XXXXXX.pose.depth.tiff. The
    frames (H x W, focal length `focal`, principal point at the centre)
    look at the walls of render_box_view's textured room; each sequence
    sweeps its own arc of n_frames views."""
    sd = os.path.join(root, scene)
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1.0]])
    r_eye = 0.3 * box_half / 2.0
    rd = os.path.join(sd, "rendered_depth", "train", "depth")
    if rendered_depth:
        os.makedirs(rd, exist_ok=True)
    jobs = []
    for k, seq in enumerate((*train_seqs, *test_seqs)):
        os.makedirs(os.path.join(sd, f"seq-{seq:02d}"), exist_ok=True)
        poses, _ = _orbit(n_frames, 0.05 + 2.1 * k, 1.5 / n_frames, r_eye, box_half, 0.2)
        jobs += [(seq, i, c2w) for i, c2w in enumerate(poses)]

    def write(job):
        seq, i, c2w = job
        rgb, depth = render_box_view(c2w, K, H, W, box_half=box_half, tex=tex)
        stem = os.path.join(sd, f"seq-{seq:02d}", f"frame-{i:06d}")
        png.write(stem + ".color.png", (rgb * 255).astype(np.uint8))
        png.write(stem + ".depth.png", _mm(depth, max_depth))
        np.savetxt(stem + ".pose.txt", c2w)
        if rendered_depth and seq in train_seqs:
            tiff.write(os.path.join(rd, f"seq{seq:02d}_frame-{i:06d}.pose.depth.tiff"),
                       _mm(depth))
    _each(write, jobs)
    for name, seqs in (("TrainSplit.txt", train_seqs), ("TestSplit.txt", test_seqs)):
        with open(os.path.join(sd, name), "w") as f:
            f.write("".join(f"sequence{s}\n" for s in seqs))


def _write_mesh_ply(path: str, xyz: np.ndarray, rgb: np.ndarray, faces: np.ndarray) -> None:
    """A binary PLY mesh: vertices (float xyz, uchar rgb) then triangles."""
    n, m = len(xyz), len(faces)
    head = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
            "property float x", "property float y", "property float z",
            "property uchar red", "property uchar green", "property uchar blue",
            f"element face {m}", "property list uchar int vertex_indices", "end_header"]
    vert = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    vert["xyz"] = xyz
    vert["rgb"] = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    face = np.zeros(m, dtype=[("n", "u1"), ("idx", "<i4", 3)])
    face["n"] = 3
    face["idx"] = faces
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode("ascii"))
        f.write(vert.tobytes())
        f.write(face.tobytes())


# 12-Scenes' colour intrinsics (its info.txt), at 1296x968
TWELVE_FX, TWELVE_FY, TWELVE_CX, TWELVE_CY = 1169.62, 1167.11, 646.295, 489.927


def write_twelve_scenes_raw(root: str, place: str = "apt1", scene: str = "kitchen",
                            n_train: int = 12, n_test: int = 4, H: int = 968, W: int = 1296,
                            depth_hw=(480, 640), inf_frames=(1,), tex: int = 2,
                            box_half: float = 2.0, quality: int = 90) -> None:
    """A scene in 12-Scenes' raw layout under root/place/scene:
    data/frame-XXXXXX.{color.jpg,depth.png,pose.txt} (the test frames
    first; JPEG colour at H x W, 16-bit millimetre depth at depth_hw; the
    frames in `inf_frames` with INF poses, as the dataset marks lost
    tracking), info.txt (the dataset's header lines: colour size and
    intrinsics scaled to W x H), split.txt ('sequence0 [frames=n_test]'
    first) and a mesh PLY of the room (<place>_<scene>.ply). The colour
    frames are rendered with the focal length the preprocessor reads (the
    mean of fx and fy) and the centre as principal point."""
    sd = os.path.join(root, place, scene)
    os.makedirs(os.path.join(sd, "data"), exist_ok=True)
    sx, sy = W / 1296.0, H / 968.0
    fx, fy, cx, cy = TWELVE_FX * sx, TWELVE_FY * sy, TWELVE_CX * sx, TWELVE_CY * sy
    f = (fx + fy) / 2.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    dh, dw = depth_hw
    Kd = K.copy()
    Kd[0] *= dw / W
    Kd[1] *= dh / H
    n = n_test + n_train
    poses, _ = _orbit(n, 0.05, 2 * np.pi / n, 0.3 * box_half / 2.0, box_half, 0.3)
    def write(job):
        i, c2w = job
        stem = os.path.join(sd, "data", f"frame-{i:06d}")
        rgb, _ = render_box_view(c2w, K, H, W, box_half=box_half, tex=tex)
        _, depth = render_box_view(c2w, Kd, dh, dw, box_half=box_half, tex=tex)
        jpeg.write(stem + ".color.jpg", (rgb * 255).astype(np.uint8), quality)
        png.write(stem + ".depth.png", _mm(depth))
        if i in inf_frames:
            with open(stem + ".pose.txt", "w") as fh:
                fh.write("-INF -INF -INF -INF\n" * 4)
        else:
            np.savetxt(stem + ".pose.txt", c2w)
    _each(write, list(enumerate(poses)))
    with open(os.path.join(sd, "info.txt"), "w") as fh:
        fh.write(f"m_versionNumber = 4\nm_sensorName = StructureSensor\n"
                 f"m_colorWidth = {W}\nm_colorHeight = {H}\n"
                 f"m_depthWidth = {dw}\nm_depthHeight = {dh}\nm_depthShift = 1000\n"
                 f"m_calibrationColorIntrinsic = {fx} 0 {cx} 0 0 {fy} {cy} 0 0 0 1 0 0 0 0 1 \n"
                 f"m_calibrationColorExtrinsic = 1 0 0 0 0 1 0 0 0 0 1 0 0 0 0 1 \n"
                 f"m_frames.size = {n}\n")
    with open(os.path.join(sd, "split.txt"), "w") as fh:
        fh.write(f"sequence0 [frames={n_test}]  [start=0 ; end={n_test - 1}]\n"
                 f"sequence1 [frames={n_train}]  [start={n_test} ; end={n - 1}]\n")
    # the mesh: a grid of vertices on each wall, two triangles per cell
    g = np.linspace(-box_half, box_half, 9)
    u, v = (a.reshape(-1) for a in np.meshgrid(g, g, indexing="ij"))
    xyz, faces = [], []
    for axis in range(3):
        for sign in (-1.0, 1.0):
            p = np.zeros((len(u), 3))
            p[:, axis] = sign * box_half
            p[:, (axis + 1) % 3], p[:, (axis + 2) % 3] = u, v
            base = sum(len(x) for x in xyz)
            c = (np.arange(8)[:, None] * 9 + np.arange(8)[None, :]).reshape(-1) + base
            faces += [np.stack([c, c + 9, c + 1], 1), np.stack([c + 1, c + 9, c + 10], 1)]
            xyz.append(p)
    xyz = np.concatenate(xyz)
    _write_mesh_ply(os.path.join(sd, f"{place}_{scene}.ply"), xyz, texture(xyz, tex),
                   np.concatenate(faces))


def write_onepose_raw(root: str, scene: str = "0447-synthetic-box", n_seqs: int = 3,
                      n_frames: int = 6, H: int = 512, W: int = 512,
                      obj_half=(0.35, 0.25, 0.3), tex: int = 1, radius: float = 1.6,
                      n_points: int = 4096, missing_depth=(1,)) -> None:
    """An object scene in OnePose's raw layout under root/scene:
    <scene>-k/{color/<i>.png, intrin_ba/<i>.txt (3x3 K), poses_ba/<i>.txt
    (4x4 world-to-camera), depth/<i>_mvs.tiff (float32 millimetres)} for k
    = 1..n_seqs (the last sequence is the test split and has no depth; in
    the others the frames in `missing_depth` have none either),
    box3d_corners.txt (the object box's 8 corners in OnePose's order) and
    pc.ply (room and object surface points: write_object_scene's
    geometry)."""
    sd = os.path.join(root, scene)
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    corners = _BOX_SIGNS * np.asarray(obj_half)
    os.makedirs(sd, exist_ok=True)
    np.savetxt(os.path.join(sd, "box3d_corners.txt"), corners)
    rng = np.random.default_rng(tex)
    surface = rng.uniform(-1, 1, (n_points, 3)) * np.asarray(obj_half)
    face = rng.integers(0, 3, n_points)
    rows = np.arange(n_points)
    surface[rows, face] = np.sign(surface[rows, face]) * np.asarray(obj_half)[face]

    def render(c2w, K_, h, w):
        return render_object_view(c2w, K_, h, w, obj_half, tex=tex)

    jobs = []
    for k in range(1, n_seqs + 1):
        seq_dir = os.path.join(sd, f"{scene}-{k}")
        for sub in ("color", "intrin_ba", "poses_ba", "depth"):
            os.makedirs(os.path.join(seq_dir, sub), exist_ok=True)
        poses, _ = _orbit(n_frames, 0.05 + 2.0 * k, 2 * np.pi / (n_seqs * n_frames),
                          radius, 0.0, 0.15)
        jobs += [(k, seq_dir, i, c2w) for i, c2w in enumerate(poses)]

    def write(job):
        k, seq_dir, i, c2w = job
        rgb, depth = render(c2w, K, H, W)
        png.write(os.path.join(seq_dir, "color", f"{i}.png"), (rgb * 255).astype(np.uint8))
        np.savetxt(os.path.join(seq_dir, "intrin_ba", f"{i}.txt"), K)
        np.savetxt(os.path.join(seq_dir, "poses_ba", f"{i}.txt"), np.linalg.inv(c2w))
        if k < n_seqs and i not in missing_depth:
            tiff.write(os.path.join(seq_dir, "depth", f"{i}_mvs.tiff"),
                       depth * np.float32(1000), tiff.DEFLATE, predictor=3)
    _each(write, jobs)
    views = [c2w for *_, c2w in jobs]
    room = _backproject(views[::4], K, W, H, render)
    write_ply_points(os.path.join(sd, "pc.ply"), np.concatenate([room, surface]))


def write_colmap_array(path: str, depth: np.ndarray) -> None:
    """A COLMAP dense array (`W&H&1&` and float32 rows), as patch_match_stereo
    writes its .geometric.bin depth maps."""
    h, w = depth.shape
    with open(path, "wb") as f:
        f.write(f"{w}&{h}&1&".encode("ascii"))
        f.write(np.ascontiguousarray(depth, dtype="<f4").tobytes())


def write_cambridge_raw(root: str, scene: str = "KingsCollege", n_train: int = 4,
                        n_test: int = 2, H: int = 1080, W: int = 1920, n_points: int = 2000,
                        box_half: float = 15.0, tex: int = 3) -> None:
    """A scene in Cambridge Landmarks' raw layout under root/scene:
    seq1/frameXXXXX.png (train) and seq2/frameXXXXX.png (test) at H x W,
    dataset_{train,test}.txt (3 header lines, then 'name X Y Z W P Q R'),
    reconstruction.nvm (VisualSfM: every camera as 'name.jpg focal qw qx qy
    qz Cx Cy Cz 0 0', world-to-camera rotation and camera centre, then the
    sparse points on the room's walls with the views that see them,
    measurements relative to the image centre), and for the train frames
    the geometric depth maps patch_match_stereo would write
    (colmap/dense/stereo/depth_maps/<name>.geometric.bin), so that train
    metas exist without running MVS. Beside them, two listed test frames
    the preprocessor skips: one whose PNG is missing, one whose NVM camera
    has an outlier centre."""
    sd = os.path.join(root, scene)
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    rng = np.random.default_rng(tex)
    pts = rng.uniform(-box_half, box_half, (n_points, 3))
    face = rng.integers(0, 3, n_points)
    pts[np.arange(n_points), face] = rng.choice([-1.0, 1.0], n_points) * box_half
    cols = (texture(pts / box_half * 2.0, tex) * 255).astype(np.int64)
    frames = []
    poses, _ = _orbit(n_train + n_test + 1, 0.05, 2 * np.pi / (n_train + n_test + 1),
                      0.2 * box_half, box_half, 0.2)
    for i, c2w in enumerate(poses):
        seq = "seq1" if i < n_train else "seq2"
        frames.append((f"{seq}/frame{i + 1:05d}", c2w))
    dm = os.path.join(sd, "colmap", "dense", "stereo", "depth_maps", "seq1")
    for d in (os.path.join(sd, "seq1"), os.path.join(sd, "seq2"), dm):
        os.makedirs(d, exist_ok=True)

    def write(job):
        name, c2w = job
        rgb, depth = render_box_view(c2w, K, H, W, box_half=box_half, tex=tex)
        png.write(os.path.join(sd, name + ".png"), (rgb * 255).astype(np.uint8))
        if name.startswith("seq1"):
            write_colmap_array(os.path.join(dm, name.split("/")[1] + ".png.geometric.bin"),
                               depth)
    # the last listed frame's image is missing
    _each(write, frames[:-1])
    cams, obs = [], [[] for _ in range(n_points)]
    n_feat = [0] * len(frames)   # measurements per image so far: the feature index
    for idx, (name, c2w) in enumerate(frames):
        w2c = np.linalg.inv(c2w)
        cams.append((name, w2c, c2w[:3, 3]))
        if idx == len(frames) - 1:
            continue
        pc = pts @ w2c[:3, :3].T + w2c[:3, 3]
        uv = pc[:, :2] / np.maximum(pc[:, 2:], 1e-8) * f
        seen = (pc[:, 2] > 0) & (np.abs(uv[:, 0]) < W / 2) & (np.abs(uv[:, 1]) < H / 2)
        for p in np.nonzero(seen)[0]:
            obs[p].append((idx, n_feat[idx], uv[p]))
            n_feat[idx] += 1
    outlier = np.eye(4)
    outlier[:3, 3] = [2e4, 0.0, 0.0]
    cams.append(("seq2/frame09999", np.linalg.inv(outlier), outlier[:3, 3]))
    lines = ["NVM_V3", "", str(len(cams))]
    for name, w2c, C in cams:
        q = rotmat2qvec(w2c[:3, :3])
        lines.append(f"{name}.jpg {f!r} " + " ".join(repr(float(x)) for x in (*q, *C))
                     + " 0 0")
    lines += ["", str(n_points)]
    for p in range(n_points):
        o = " ".join(f"{c} {j} {float(x)!r} {float(y)!r}" for c, j, (x, y) in obs[p])
        lines.append(" ".join(repr(float(x)) for x in pts[p]) + " "
                     + " ".join(str(int(c)) for c in cols[p]) + f" {len(obs[p])} {o}".rstrip())
    lines += ["", "0", ""]
    with open(os.path.join(sd, "reconstruction.nvm"), "w") as fh:
        fh.write("\n".join(lines))
    listed = frames + [("seq2/frame09999", outlier)]
    for split, seq in (("train", "seq1"), ("test", "seq2")):
        with open(os.path.join(sd, f"dataset_{split}.txt"), "w") as fh:
            fh.write("Visual Landmark Dataset V1\nImageFile, Camera Position [X Y Z W P Q R]\n\n")
            for name, c2w in listed:
                if name.startswith(seq):
                    q = rotmat2qvec(np.linalg.inv(c2w)[:3, :3])
                    fh.write(f"{name}.png " + " ".join(repr(float(x)) for x in
                                                       (*c2w[:3, 3], *q)) + "\n")


def write_colmap_workspace(root: str, n_train: int = 6, n_test: int = 2, H: int = 96,
                           W: int = 128, n_points: int = 300, depth: bool = True,
                           box_half: float = 2.0, quality: int = 90) -> None:
    """A COLMAP dense workspace at root: sparse/{cameras,images,points3D}.bin
    (one PINHOLE camera, the views' poses, points inside the room),
    images/seq0 (train) and images/seq1 (test) as JPEGs, train.txt and
    test.txt naming the sequences, and with `depth` each view's
    stereo/depth_maps/<seq>/<frame>.jpg.geometric.bin."""
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    cameras = {1: Camera(1, "PINHOLE", W, H, np.array([f, f, W / 2, H / 2]))}
    pts = np.random.default_rng(0).uniform(-0.95 * box_half, 0.95 * box_half, (n_points, 3))
    points3D = {i: Point3D(i, pts[i], np.array([100, 120, 140]), 0.1, np.zeros(0, np.int64),
                           np.zeros(0, np.int64)) for i in range(n_points)}
    images = {}
    for i in range(n_train + n_test):
        seq = "seq0" if i < n_train else "seq1"
        ang = 0.25 * i
        c2w = look_at_pose(np.array([0.3 * np.cos(ang), 0.05, 0.3 * np.sin(ang)]),
                           np.array([2 * np.cos(ang), 0, 2 * np.sin(ang)]))
        rgb, d = render_box_view(c2w, K, H, W, box_half=box_half)
        name = f"{seq}/frame{i:04d}.jpg"
        os.makedirs(os.path.join(root, "images", seq), exist_ok=True)
        jpeg.write(os.path.join(root, "images", name), (rgb * 255).astype(np.uint8), quality)
        if depth:
            dm = os.path.join(root, "stereo", "depth_maps", seq)
            os.makedirs(dm, exist_ok=True)
            write_colmap_array(os.path.join(root, "stereo", "depth_maps",
                                            name + ".geometric.bin"), d)
        w2c = np.linalg.inv(c2w)
        images[i + 1] = Image(i + 1, rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], 1, name,
                              np.zeros((0, 2)), np.zeros(0, np.int64))
    write_model(os.path.join(root, "sparse"), cameras, images, points3D)
    for split, seq in (("train", "seq0"), ("test", "seq1")):
        with open(os.path.join(root, f"{split}.txt"), "w") as fh:
            fh.write(seq + "\n")
