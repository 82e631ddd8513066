"""Procedural synthetic RGB-D scenes for tests and benchmarks.

A camera inside an axis-aligned textured box gives analytically consistent
multi-view RGB-D: depth = ray/box exit distance, color = smooth 3D texture
at the hit point. `make_query_batch` builds one in-memory query with the
per-item dict contract (image/pose/K/depth/near/far/topk_* fields);
`write_scene` writes a whole scene to disk in the preprocessors' layout
(PNG frames through data/png.py, info and retrieval pkls, pc.ply), as the
JAX package's tools/e2e_pose_study.write_scene does.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np

from . import png
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
    r_tgt = box_half

    def make_frames(n, split, angle0, step):
        frames, angles = [], []
        for i in range(n):
            ang = angle0 + step * i
            # orbit_jitter > 0 modulates the orbit's radius and height
            # (deterministically): depth parallax breaks the near-planar
            # PnP gauge of a constant-radius orbit
            rj = 1.0 + orbit_jitter * np.sin(2.39996 * ang + 0.7)
            hj = 1.0 + 3.0 * orbit_jitter * np.cos(1.61803 * ang)
            eye = np.array([r_eye * rj * np.cos(ang),
                            r_eye / 6.0 * hj * np.sin(3 * ang),
                            r_eye * rj * np.sin(ang)])
            tgt = np.array([r_tgt * np.cos(ang), 0.0, r_tgt * np.sin(ang)])
            c2w = look_at_pose(eye, tgt)
            rgb, depth = render_box_view(c2w, K, H, W, box_half=box_half, tex=tex)
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
            angles.append(ang)
        return frames, np.asarray(angles)

    train, a_train = make_frames(n_train, "train", 0.0, 2 * np.pi / n_train)
    test, a_test = make_frames(n_test, "test", 2 * np.pi / n_train * 0.37,
                               2 * np.pi / n_test)
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

    pts = []
    h, w = 24, 32
    for fr in train[::6]:
        c2w = np.linalg.inv(np.vstack([fr["extrinsic_Tcw"], [0, 0, 0, 1]]))
        _, depth = render_box_view(c2w, K, h, w, box_half=box_half, tex=tex)
        f2 = K.copy()
        f2[0] *= w / W
        f2[1] *= h / H
        u, v = np.meshgrid(np.arange(w), np.arange(h))
        x = (u - f2[0, 2]) / f2[0, 0] * depth
        y = (v - f2[1, 2]) / f2[1, 1] * depth
        pc = np.stack([x, y, depth], -1).reshape(-1, 3)
        pts.append(pc @ c2w[:3, :3].T + c2w[:3, 3])
    write_ply_points(os.path.join(sd, "pc.ply"), np.concatenate(pts))
