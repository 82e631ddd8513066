"""SceneStore of a COLMAP dense workspace (counterpart of
nerfloc_tpu/data/colmap_scene.py), so VideoDataset's transforms, padding and
support selection run unchanged on COLMAP scenes:

  <dense_path>/sparse/{cameras,images,points3D}.bin   sparse model
  <dense_path>/images/<seq>/<frame>.jpg               undistorted images
  <dense_path>/stereo/depth_maps/<name>.geometric.bin colmap depth, or
  <dense_path>/casmvsnet/depth_est/NNNNNNNN.pfm       casMVSNet depth
  <dense_path>/{train,test}.txt                       sequence-name splits
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from .colmap_io import read_model
from .scene_store import SceneStore


def colmap_scene_store(dense_path: str, depth_type: str = "colmap",
                       scene: str = "colmap") -> SceneStore:
    sparse = os.path.join(dense_path, "sparse")
    cameras, images, points3D = read_model(sparse, ext=".bin")

    image_ids = sorted(images.keys(), key=lambda i: images[i].name)
    id_order = {img_id: i for i, img_id in enumerate(sorted(images.keys()))}
    xyz = np.stack([p.xyz for p in points3D.values()]).astype(np.float32)
    rgb = np.stack([p.rgb for p in points3D.values()]).astype(np.float32) / 255.0

    def split_ids(split: str) -> List[int]:
        path = os.path.join(dense_path, f"{split}.txt")
        if not os.path.exists(path):
            # no split file: alternate 1-in-8 frames for test
            return [i for k, i in enumerate(image_ids)
                    if (k % 8 == 7) == (split == "test")]
        with open(path) as f:
            seqs = {ln.strip() for ln in f if ln.strip()}
        return [i for i in image_ids
                if images[i].name.split("/")[-2] in seqs]

    def depth_rel(img) -> str:
        if depth_type == "colmap":
            name = "/".join(img.name.split("/")[-2:])
            return os.path.join("stereo", "depth_maps",
                                f"{name}.geometric.bin")
        return os.path.join("casmvsnet", "depth_est",
                            f"{id_order[img.id]:08d}.pfm")

    def frame_meta(img_id: int):
        img = images[img_id]
        cam = cameras[img.camera_id]
        K = cam.K()
        w2c = img.w2c()
        # near/far from the visible sparse points
        cam_pts = xyz @ w2c[:3, :3].T + w2c[:3, 3]
        z = cam_pts[:, 2]
        uv = (cam_pts[:, :2] @ K[:2, :2].T) / np.maximum(z, 1e-8)[:, None] \
            + K[:2, 2]
        ok = (uv[:, 0] >= 0) & (uv[:, 1] >= 0) & (uv[:, 0] < cam.width) & \
             (uv[:, 1] < cam.height) & (z > 0)
        if ok.sum() == 0:
            return None
        return {
            "file_name": os.path.join("images", img.name),
            "depth_file_name": depth_rel(img),
            "extrinsic_Tcw": w2c[:3].astype(np.float32),
            "camera_intrinsic": K.astype(np.float32),
            "near": float(np.percentile(z[ok], 0.1)),
            "far": float(np.percentile(z[ok], 99.0)),
            "sequence_id": img.name.split("/")[-2] if "/" in img.name else "0",
            "frame_id": int(img_id),
        }

    store = SceneStore(base_dir=dense_path, scene=scene)
    store.train_frames = [m for m in (frame_meta(i) for i in split_ids("train"))
                          if m is not None]
    store.test_frames = [m for m in (frame_meta(i) for i in split_ids("test"))
                         if m is not None]
    store.points = xyz
    store.point_colors = rgb
    store.near = min(f["near"] for f in store.train_frames)
    store.far = max(f["far"] for f in store.train_frames)
    store._recenter()
    store._rescale(1.0)
    return store
