"""OnePose preprocessor (counterpart of nerfloc_tpu/preprocess/onepose.py).

Layout:
  <root>/<scene>/<seq>/{color,intrin_ba,poses_ba,depth}/<frame>.{png,txt}
  <root>/<scene>/box3d_corners.txt   (8 corners of the object box)
  <root>/<scene>/pc.ply              (the OnePose SfM point cloud)

Emits bboxes_3d.npy, in_box_pc.ply (the points inside the 3D box) and
info_{train,test}.pkl (the last sequence is the test split; a train frame
needs its MVS depth; near/far from the visible in-box points).

Usage: python -m nerfloc_tpu_torch.preprocess.onepose <data_root> [scenes...]
"""
from __future__ import annotations

import glob
import os
import sys

import numpy as np

from ..data.ply import read_ply_points, write_ply_points
from .common import write_info

SCENES = ["0447-nabati-box", "0450-hlychocpie-box",
          "0488-jijiantoothpaste-box", "0493-haochidianeggroll-box",
          "0494-qvduoduocookies-box", "0594-martinBootsLeft-others"]
H, W = 512, 512


def load_box_corners(path: str) -> np.ndarray:
    return np.loadtxt(path).reshape(-1, 3)[:8]


def is_inside_box3d(pts: np.ndarray, corners: np.ndarray) -> np.ndarray:
    """Points inside the (possibly rotated) box spanned by 8 corners: project
    onto the box's three edge axes and bound-check."""
    origin = corners[0]
    # OnePose corner order: 0 origin; 1, 3, 4 adjacent along the three edges
    axes = np.stack([corners[1] - origin, corners[3] - origin,
                     corners[4] - origin])
    lens = np.linalg.norm(axes, axis=1)
    axes = axes / lens[:, None]
    local = (pts - origin) @ axes.T
    return np.all((local >= 0) & (local <= lens[None, :]), axis=1)


def process_scene(root: str, scene: str):
    scene_dir = os.path.join(root, scene)
    corners = load_box_corners(os.path.join(scene_dir, "box3d_corners.txt"))
    np.save(os.path.join(scene_dir, "bboxes_3d.npy"), corners[None])

    xyz, rgb = read_ply_points(os.path.join(scene_dir, "pc.ply"))
    inside = is_inside_box3d(xyz, corners)
    write_ply_points(os.path.join(scene_dir, "in_box_pc.ply"), xyz[inside],
                     rgb[inside] if rgb is not None else None)
    xyz_world = xyz[inside]

    seqs = sorted(os.path.basename(p) for p in glob.glob(scene_dir + "/*")
                  if os.path.isdir(p) and "colmap" not in p)
    train, test = [], []
    for seq in seqs:
        seq_dir = os.path.join(scene_dir, seq)
        names = sorted(os.listdir(os.path.join(seq_dir, "color")),
                       key=lambda x: int(x.split(".")[0]))
        for name in names:
            fid = name.split(".")[0]
            K = np.loadtxt(os.path.join(seq_dir, "intrin_ba", f"{fid}.txt"))
            Tcw44 = np.loadtxt(os.path.join(seq_dir, "poses_ba", f"{fid}.txt"))
            R, t = Tcw44[:3, :3], Tcw44[:3, 3]
            xyz_cam = xyz_world @ R.T + t
            z = xyz_cam[:, 2]
            uv = (xyz_cam[:, :2] @ K[:2, :2].T) \
                / np.maximum(z, 1e-8)[:, None] + K[:2, 2]
            ok = (uv[:, 0] >= 0) & (uv[:, 1] >= 0) & (uv[:, 0] < W) & \
                 (uv[:, 1] < H) & (z > 0)
            if ok.sum() == 0:
                continue
            zv = z[z > 0]
            depth_rel = os.path.join(scene, seq, "depth",
                                     name.replace(".png", "_mvs.tiff"))
            info = {
                "file_name": os.path.join(scene, seq, "color", name),
                "frame_id": int(fid),
                "sequence_id": seq,
                "depth_file_name": depth_rel,
                "extrinsic_Tcw": Tcw44[:3].astype(np.float32),
                "camera_intrinsic": np.array(
                    [K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0.0, 0.0],
                    dtype=np.float32),
                "frame_dim": (H, W),
                "near": float(zv.min()),
                "far": float(zv.max()),
            }
            if seq == seqs[-1]:
                test.append(info)  # the last sequence is the test split
            elif os.path.exists(os.path.join(root, depth_rel)):
                train.append(info)  # a train frame needs its depth
    write_info(scene_dir, "train", train)
    write_info(scene_dir, "test", test)
    print(f"{scene}: train={len(train)} test={len(test)}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = argv[0]
    for scene in (argv[1:] or SCENES):
        process_scene(root, scene)
    return 0


if __name__ == "__main__":
    sys.exit(main())
