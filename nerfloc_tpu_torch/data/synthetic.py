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
(JPEG colour frames larger than their 16-bit depth PNGs).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np

from . import jpeg, png, tiff
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
