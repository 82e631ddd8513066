"""7-Scenes preprocessor (counterpart of nerfloc_tpu/preprocess/seven_scenes.py).

Layout:
  <root>/<scene>/seq-XX/frame-XXXXXX.{color.png,depth.png,pose.txt}
  <root>/<scene>/{TrainSplit,TestSplit}.txt with 'sequenceN' lines
Optional rendered depth at
  <root>/<scene>/rendered_depth/train/depth/seqXX_frame-XXXXXX.pose.depth.tiff
(used for train depth when present: the Kinect depth is not aligned with
the colour).

Emits info_{train,test}.pkl and pc.ply (TSDF fusion of every
frame_stride-th train frame, on the card unless --device cpu).

Usage: python -m nerfloc_tpu_torch.preprocess.seven_scenes <data_root> [scenes...]
           [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import glob
import os
import re
import sys
from typing import List, Optional

import numpy as np

from ..data.reader import load_depth, load_image
from ..device import DeviceLike, resolve_device
from .common import frame_near_far, fuse_scene_tsdf, load_pose_txt, make_meta, write_info

FOCAL = 525.0
CX, CY = 320.0, 240.0
SCENES = ["chess", "fire", "heads", "office", "pumpkin", "redkitchen",
          "stairs"]


def read_split(scene_dir: str, name: str):
    with open(os.path.join(scene_dir, name)) as f:
        return [int(ln.strip().replace("sequence", ""))
                for ln in f if ln.strip()]


def frame_paths(scene_dir: str, seq: int):
    for img in sorted(glob.glob(os.path.join(scene_dir, f"seq-{seq:02d}",
                                             "*color.png"))):
        i = int(re.search(r"frame-(\d+)", img).group(1))
        yield i, img


def depth_path(root: str, scene: str, seq: int, i: int, split: str) -> str:
    rendered = os.path.join(
        scene, "rendered_depth", "train", "depth",
        f"seq{seq:02d}_frame-{i:06d}.pose.depth.tiff")
    if split == "train" and os.path.exists(os.path.join(root, rendered)):
        return rendered
    return os.path.join(scene, f"seq-{seq:02d}", f"frame-{i:06d}.depth.png")


def process_scene(root: str, scene: str, frame_stride: int = 5,
                  voxel_size: float = 0.02, device: DeviceLike = None):
    dev = resolve_device(device)
    scene_dir = os.path.join(root, scene)
    K = np.array([[FOCAL, 0, CX], [0, FOCAL, CY], [0, 0, 1.0]])

    for split, split_file in (("train", "TrainSplit.txt"),
                              ("test", "TestSplit.txt")):
        seqs = read_split(scene_dir, split_file)
        metas = []
        fuse_frames = []
        for seq in seqs:
            for i, img_path in frame_paths(scene_dir, seq):
                rel_img = os.path.relpath(img_path, root)
                rel_depth = depth_path(root, scene, seq, i, split)
                Twc = load_pose_txt(img_path.replace("color.png", "pose.txt"))
                depth = load_depth(os.path.join(root, rel_depth))
                near, far = frame_near_far(depth)
                metas.append(make_meta(rel_img, rel_depth, Twc, FOCAL, FOCAL,
                                       CX, CY, near, far, seq, i))
                if split == "train" and i % frame_stride == 0:
                    rgb = load_image(img_path).astype(np.float32) / 255.0
                    fuse_frames.append((rgb, depth, K, Twc))
        write_info(scene_dir, split, metas)
        print(f"{scene}/{split}: {len(metas)} frames")
        if split == "train" and fuse_frames:
            n = fuse_scene_tsdf(fuse_frames,
                                os.path.join(scene_dir, "pc.ply"),
                                voxel_size=voxel_size, frame_stride=1, device=dev)
            print(f"{scene}: pc.ply with {n} points")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("root")
    p.add_argument("scenes", nargs="*")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the TSDF fusion (default cuda; raises without a GPU)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    for scene in args.scenes or SCENES:
        process_scene(args.root, scene, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
