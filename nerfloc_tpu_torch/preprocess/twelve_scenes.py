"""12-Scenes preprocessor (counterpart of nerfloc_tpu/preprocess/twelve_scenes.py).

Layout:
  <root>/<place>/<scene>/data/frame-XXXXXX.{color.jpg,depth.png,pose.txt}
  <root>/<place>/<scene>/split.txt  ('sequenceN' boundary: the first N
                                     frames are the test split)
  <root>/<place>/<scene>/info.txt   (colour resolution and intrinsics)
  <root>/<place>/<scene>/*.ply      (the scene mesh, copied to pc.ply)

Frames with INF poses are skipped. No TSDF fusion: the scene ships its
mesh. Usage:
  python -m nerfloc_tpu_torch.preprocess.twelve_scenes <data_root> [place/scene...]
"""
from __future__ import annotations

import glob
import os
import sys

from ..data.ply import read_ply_points, write_ply_points
from ..data.reader import load_depth
from .common import frame_near_far, load_pose_txt, make_meta, write_info

PLACES = {
    "apt1": ["kitchen", "living"],
    "apt2": ["bed", "kitchen", "living", "luke"],
    "office1": ["gates362", "gates381", "lounge", "manolis"],
    "office2": ["5a", "5b"],
}


def read_info_txt(scene_dir: str):
    with open(os.path.join(scene_dir, "info.txt")) as f:
        lines = f.readlines()
    width = int(lines[2].split()[-1])
    height = int(lines[3].split()[-1])
    # line 7: m_calibrationColorIntrinsic = fx 0 cx 0 | 0 fy cy 0 | ...
    vals = lines[7].split()
    focal = (float(vals[2]) + float(vals[7])) / 2.0
    return focal, width, height


def read_split_boundary(scene_dir: str) -> int:
    with open(os.path.join(scene_dir, "split.txt")) as f:
        first = f.readline()
    # "sequence0 [frames=NNN] ...": the NNN of the second token
    return int(first.split()[1][8:-1])


def pose_is_valid(path: str) -> bool:
    with open(path) as f:
        return "INF" not in f.read().upper()


def process_scene(root: str, place: str, scene: str):
    scene_dir = os.path.join(root, place, scene)
    data_dir = os.path.join(scene_dir, "data")
    focal, width, height = read_info_txt(scene_dir)
    boundary = read_split_boundary(scene_dir)

    images = sorted(os.path.basename(p) for p in
                    glob.glob(os.path.join(data_dir, "*color.jpg")))

    def build(metas_images):
        metas = []
        for image in metas_images:
            pose_path = os.path.join(data_dir,
                                     image.replace("color.jpg", "pose.txt"))
            if not pose_is_valid(pose_path):
                continue
            Twc = load_pose_txt(pose_path)
            rel = os.path.join(place, scene, "data", image)
            rel_depth = rel.replace("color.jpg", "depth.png")
            depth = load_depth(os.path.join(root, rel_depth))
            near, far = frame_near_far(depth)
            metas.append(make_meta(rel, rel_depth, Twc, focal, focal,
                                   width / 2, height / 2, near, far, "0",
                                   int(image.split(".")[0].split("-")[1]),
                                   frame_dim=(height, width)))
        return metas

    # the first `boundary` frames are the test split
    write_info(scene_dir, "test", build(images[:boundary]))
    train = build(images[boundary:])
    write_info(scene_dir, "train", train)
    print(f"{place}/{scene}: train={len(train)} test={boundary}")

    plys = [p for p in glob.glob(os.path.join(scene_dir, "*.ply"))
            if not p.endswith("pc.ply")]
    if plys:
        xyz, rgb = read_ply_points(plys[0])
        write_ply_points(os.path.join(scene_dir, "pc.ply"), xyz, rgb)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = argv[0]
    targets = argv[1:]
    if targets:
        pairs = [t.split("/") for t in targets]
    else:
        pairs = [(p, s) for p, ss in PLACES.items() for s in ss]
    for place, scene in pairs:
        process_scene(root, place, scene)
    return 0


if __name__ == "__main__":
    sys.exit(main())
