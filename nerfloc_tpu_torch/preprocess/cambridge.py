"""Cambridge Landmarks preprocessor (counterpart of
nerfloc_tpu/preprocess/cambridge.py).

Pipeline:
  1. parse the VisualSfM `reconstruction.nvm` (cameras and sparse points),
  2. write a COLMAP sparse model (SIMPLE_PINHOLE) of the images listed in
     dataset_{train,test}.txt (data/colmap_io.py),
  3. optionally, with the colmap binary on PATH, run image_undistorter and
     patch_match_stereo for per-view geometric depth maps (skipped, with a
     message, where colmap is absent; `--no-mvs` skips it always),
  4. emit info_{train,test}.pkl, near/far from the sparse points each view
     sees (percentiles 0.1 and 99), depth_file_name the MVS output (a train
     frame needs its depth map),
  5. emit pc.ply from the NVM's sparse points.

Image sizes come from the PNG headers (data/png.py); no pixel is decoded.

Usage: python -m nerfloc_tpu_torch.preprocess.cambridge <data_root> [scenes...] [--no-mvs]
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
from typing import Dict, List

import numpy as np

from ..data import png
from ..data.colmap_io import (
    Camera,
    Image,
    Point3D,
    qvec2rotmat,
    rotmat2qvec,
    write_model,
)
from ..data.ply import write_ply_points
from .common import make_meta, write_info

SCENES = ["KingsCollege", "OldHospital", "GreatCourt", "ShopFacade",
          "StMarysChurch"]
MAX_DEPTH = 500.0


def parse_nvm(path: str):
    """Parse an NVM reconstruction: returns (cams, points).

    cams: list of dicts {name, focal, qvec(wxyz), C (camera center)}.
    points: list of dicts {xyz, rgb, obs: [(cam_idx, (x, y)), ...]}.
    NVM stores rotation as world->cam quaternion and the CAMERA CENTER
    (not tvec): t = -R @ C.
    """
    with open(path) as f:
        lines = f.readlines()
    n_cams = int(lines[2])
    cams = []
    for i in range(n_cams):
        p = lines[3 + i].split()
        cams.append({
            "name": p[0],
            "focal": float(p[1]),
            "qvec": np.array([float(x) for x in p[2:6]]),
            "C": np.array([float(x) for x in p[6:9]]),
        })
    n_pts = int(lines[n_cams + 4])
    points = []
    start = n_cams + 5
    for i in range(n_pts):
        p = lines[start + i].split()
        xyz = np.array([float(x) for x in p[0:3]])
        rgb = np.array([int(x) for x in p[3:6]])
        n_obs = int(p[6])
        obs = []
        for j in range(n_obs):
            cam_idx = int(p[7 + 4 * j])
            xy = (float(p[9 + 4 * j]), float(p[10 + 4 * j]))
            obs.append((cam_idx, xy))
        points.append({"xyz": xyz, "rgb": rgb, "obs": obs})
    return cams, points


def nvm_cam_pose(cam) -> np.ndarray:
    """w2c 4x4 from an NVM camera entry."""
    R = qvec2rotmat(cam["qvec"] / np.linalg.norm(cam["qvec"]))
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = -R @ cam["C"]
    return T


def read_dataset_list(scene_dir: str, split: str) -> Dict[str, List[str]]:
    """dataset_{train,test}.txt: header(3) then 'name ... qw qx qy qz' rows.
    Returns name -> row tokens."""
    out = {}
    with open(os.path.join(scene_dir, f"dataset_{split}.txt")) as f:
        for ln in f.readlines()[3:]:
            p = ln.split()
            if p:
                out[p[0]] = p
    return out


def image_hw(scene_dir: str, name: str):
    """(H, W) of the PNG frame, or None for a missing or unreadable file."""
    try:
        return png.size(os.path.join(scene_dir, name))
    except (OSError, png.PNGError):
        return None


def build_colmap_model(scene_dir: str, cams, points, wanted_names):
    cameras, images = {}, {}
    points3D = {}
    # per-image observation lists, feature ids assigned in order
    obs_per_cam: Dict[int, List] = {i: [] for i in range(len(cams))}
    for pid, pt in enumerate(points):
        image_ids, p2d_idxs = [], []
        for cam_idx, xy in pt["obs"]:
            image_ids.append(cam_idx)
            p2d_idxs.append(len(obs_per_cam[cam_idx]))
            obs_per_cam[cam_idx].append((pid, xy))
        points3D[pid] = Point3D(pid, pt["xyz"], pt["rgb"], 0.0,
                                np.array(image_ids), np.array(p2d_idxs))
    for idx, cam in enumerate(cams):
        name = cam["name"][:-3] + "png"
        if name not in wanted_names:
            continue
        hw = image_hw(scene_dir, name)
        if hw is None:
            continue
        H, W = hw
        T = nvm_cam_pose(cam)
        obs = obs_per_cam[idx]
        images[idx] = Image(
            idx, rotmat2qvec(T[:3, :3]), T[:3, 3], idx, name,
            np.array([xy for _, xy in obs]).reshape(-1, 2),
            np.array([pid for pid, _ in obs], dtype=np.int64))
        cameras[idx] = Camera(idx, "SIMPLE_PINHOLE", W, H,
                              np.array([cam["focal"], W * 0.5, H * 0.5]))
    out = os.path.join(scene_dir, "colmap", "sparse")
    write_model(out, cameras, images, points3D, ext=".bin")
    return cameras, images


def run_colmap_mvs(sparse_path: str, image_path: str, dense_path: str):
    """colmap image_undistorter + patch_match_stereo. Needs the colmap
    binary; without it, says so and returns False."""
    if shutil.which("colmap") is None:
        print("colmap binary not found; skipping MVS (test-split near/far "
              "come from sparse points; train depth maps will be missing)")
        return False
    subprocess.run(["colmap", "image_undistorter",
                    "--image_path", image_path, "--input_path", sparse_path,
                    "--output_path", dense_path, "--output_type", "COLMAP",
                    "--max_image_size", "2000"], check=True)
    subprocess.run(["colmap", "patch_match_stereo",
                    "--workspace_path", dense_path,
                    "--workspace_format", "COLMAP",
                    "--PatchMatchStereo.geom_consistency", "true"],
                   check=True)
    return True


def process_scene(root: str, scene: str, run_mvs: bool = True):
    scene_dir = os.path.join(root, scene)
    cams, points = parse_nvm(os.path.join(scene_dir, "reconstruction.nvm"))
    xyz_world = np.stack([p["xyz"] for p in points])

    lists = {s: read_dataset_list(scene_dir, s) for s in ("train", "test")}
    wanted = set(lists["train"]) | set(lists["test"])
    build_colmap_model(scene_dir, cams, points, wanted)
    if run_mvs:
        run_colmap_mvs(os.path.join(scene_dir, "colmap", "sparse"), scene_dir,
                       os.path.join(scene_dir, "colmap", "dense"))

    write_ply_points(os.path.join(scene_dir, "pc.ply"), xyz_world,
                     np.stack([p["rgb"] for p in points]) / 255.0)

    for split in ("train", "test"):
        metas = []
        names = lists[split]
        for idx, cam in enumerate(cams):
            name = cam["name"][:-3] + "png"
            if name not in names:
                continue
            T = nvm_cam_pose(cam)
            if np.abs(T[:3, 3]).max() > 10000:  # an outlier camera
                continue
            hw = image_hw(scene_dir, name)
            if hw is None:
                continue
            H, W = hw
            f = cam["focal"]
            K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
            # near/far from the sparse points visible in this view
            xyz_cam = xyz_world @ T[:3, :3].T + T[:3, 3]
            z = xyz_cam[:, 2]
            uv = (xyz_cam[:, :2] @ K[:2, :2].T) / np.maximum(z, 1e-8)[:, None] \
                + K[:2, 2]
            ok = (uv[:, 0] >= 0) & (uv[:, 1] >= 0) & (uv[:, 0] < W) & \
                 (uv[:, 1] < H) & (z > 0) & (z < MAX_DEPTH)
            if ok.sum() == 0:
                continue
            near = float(np.percentile(z[ok], 0.1))
            far = float(np.percentile(z[ok], 99.0))
            seq, frame = name.split(".")[0].split("/")
            depth_rel = os.path.join(
                scene, "colmap", "dense", "stereo", "depth_maps",
                f"{name}.geometric.bin")
            if split == "train" and \
                    not os.path.exists(os.path.join(root, depth_rel)):
                continue  # a train frame needs its MVS depth
            meta = make_meta(os.path.join(scene, name), depth_rel,
                             np.linalg.inv(T), f, f, W / 2, H / 2,
                             near, far, seq,
                             int(frame.replace("frame", "")),
                             frame_dim=(H, W))
            metas.append(meta)
        write_info(scene_dir, split, metas)
        print(f"{scene}/{split}: {len(metas)} frames")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    run_mvs = "--no-mvs" not in argv
    root = args[0]
    for scene in (args[1:] or SCENES):
        process_scene(root, scene, run_mvs=run_mvs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
