"""Per-scene metadata store (counterpart of nerfloc_tpu/data/scene_store.py).

Loads `info_{train,test}.pkl` + `image_retrieval_{split}_{method}.pkl` +
`pc.ply` (+ `bboxes_3d.npy`), recenters the world origin to the mean
training-camera position, rescales by `scale_factor` (or
`rescale_far_limit / far`), and resolves global near/far.

Frame meta contract (what the preprocessors emit):
  file_name, depth_file_name, extrinsic_Tcw [3,4] or [4,4],
  camera_intrinsic [3,3], near, far, sequence_id, frame_id

The pkl files are the scene's own metadata (written by the preprocessors
or data/synthetic.write_scene); unpickling runs code, so load only scenes
you trust.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .ply import read_ply_points


@dataclass
class SceneStore:
    base_dir: str
    scene: str
    train_frames: List[Dict] = field(default_factory=list)
    test_frames: List[Dict] = field(default_factory=list)
    train_retrieval: Dict[str, List[str]] = field(default_factory=dict)
    test_retrieval: Dict[str, List[str]] = field(default_factory=dict)
    points: Optional[np.ndarray] = None       # [N, 3] float32 (post-transform)
    point_colors: Optional[np.ndarray] = None
    bboxes_3d: Optional[np.ndarray] = None    # [B, 8, 3]
    near: float = 0.1
    far: float = 10.0
    scale_factor: float = 1.0
    recenter_T: np.ndarray = field(default_factory=lambda: np.eye(4))

    @property
    def scene_dir(self) -> str:
        return os.path.join(self.base_dir, self.scene)

    # -- construction ----------------------------------------------------

    @classmethod
    def load(cls, base_dir: str, scene: str,
             retrieval_method_train: str = "netvlad",
             retrieval_method_test: str = "netvlad",
             near: Optional[float] = None, far: Optional[float] = None,
             scale_factor: Optional[float] = None,
             rescale_far_limit: Optional[float] = None,
             tempo_interval: int = 1) -> "SceneStore":
        sd = os.path.join(base_dir, scene)
        store = cls(base_dir=base_dir, scene=scene)
        store.train_frames, store.train_retrieval = _load_split(
            sd, "train", retrieval_method_train)
        store.test_frames, store.test_retrieval = _load_split(
            sd, "test", retrieval_method_test)
        if tempo_interval > 1:
            store.train_frames = store.train_frames[::tempo_interval]
            store.test_frames = store.test_frames[::tempo_interval]

        bbox_path = os.path.join(sd, "bboxes_3d.npy")
        if os.path.exists(bbox_path):
            store.bboxes_3d = np.load(bbox_path)[:, :8, :]
        pc_name = "in_box_pc.ply" if store.bboxes_3d is not None else "pc.ply"
        pc_path = os.path.join(sd, pc_name)
        if os.path.exists(pc_path):
            store.points, store.point_colors = read_ply_points(pc_path)

        # global near/far = min/max over training frames
        if near is not None and far is not None:
            store.near, store.far = float(near), float(far)
        else:
            nears = [f["near"] for f in store.train_frames if "near" in f]
            fars = [f["far"] for f in store.train_frames if "far" in f]
            store.near = float(min(nears)) if nears else 0.1
            store.far = float(max(fars)) if fars else 10.0

        store._recenter()
        if scale_factor is None and rescale_far_limit is not None:
            scale_factor = float(rescale_far_limit) / store.far
        store._rescale(scale_factor if scale_factor is not None else 1.0)
        return store

    def _recenter(self):
        """Move the world origin to the mean training camera center."""
        centers = []
        for f in self.train_frames:
            Tcw = _tcw44(f["extrinsic_Tcw"])
            centers.append(np.linalg.inv(Tcw)[:3, 3])
        if not centers:
            return
        center_T = np.eye(4)
        center_T[:3, 3] = -np.mean(centers, axis=0)
        self.recenter_T = center_T
        inv = np.linalg.inv(center_T)
        for frames in (self.train_frames, self.test_frames):
            for f in frames:
                f["extrinsic_Tcw"] = (_tcw44(f["extrinsic_Tcw"]) @ inv)[:3]
        if self.points is not None:
            self.points = (self.points @ center_T[:3, :3].T
                           + center_T[:3, 3]).astype(np.float32)
        if self.bboxes_3d is not None:
            self.bboxes_3d = self.bboxes_3d + center_T[:3, 3]

    def _rescale(self, s: float):
        """Scale translations/depth-ranges/points by s."""
        self.scale_factor = float(s)
        if s == 1.0:
            return
        for frames in (self.train_frames, self.test_frames):
            for f in frames:
                Tcw = np.asarray(f["extrinsic_Tcw"], dtype=np.float64)
                Tcw[:, 3] *= s
                f["extrinsic_Tcw"] = Tcw
                f["near"] = f.get("near", self.near) * s
                f["far"] = f.get("far", self.far) * s
        self.near *= s
        self.far *= s
        if self.points is not None:
            self.points = self.points * np.float32(s)
        if self.bboxes_3d is not None:
            self.bboxes_3d = self.bboxes_3d * s

    # -- lookups ----------------------------------------------------------

    def frames(self, split: str) -> List[Dict]:
        return self.train_frames if split == "train" else self.test_frames

    def retrieval(self, split: str) -> Dict[str, List[str]]:
        return self.train_retrieval if split == "train" else self.test_retrieval

    def train_index(self) -> Dict[str, int]:
        return {f["file_name"]: i for i, f in enumerate(self.train_frames)}

    def train_c2ws(self) -> np.ndarray:
        return np.stack([np.linalg.inv(_tcw44(f["extrinsic_Tcw"]))
                         for f in self.train_frames])


def _tcw44(Tcw) -> np.ndarray:
    Tcw = np.asarray(Tcw, dtype=np.float64)
    if Tcw.shape[0] == 3:
        Tcw = np.concatenate([Tcw, np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)
    return Tcw


def _load_split(scene_dir: str, split: str, retrieval_method: str):
    meta_path = os.path.join(scene_dir, f"info_{split}.pkl")
    with open(meta_path, "rb") as f:
        frames = pickle.load(f)
    rpath = os.path.join(scene_dir,
                         f"image_retrieval_{split}_{retrieval_method}.pkl")
    retrieval: Dict[str, List[str]] = {}
    if os.path.exists(rpath):
        with open(rpath, "rb") as f:
            retrieval = pickle.load(f)
    for fr in frames:
        fr["top_k"] = retrieval.get(fr["file_name"], [])
    return frames, retrieval


def attach_pose_retrieval(store: SceneStore, k: int = 10) -> SceneStore:
    """Fill train/test retrieval by ground-truth pose proximity (the k
    nearest training cameras), for stores whose layout carries no
    retrieval pkl (dtu)."""
    from ..retrieval.pipeline import retrieve_top_k_oracle

    def poses_of(frames):
        return {f["file_name"]: np.linalg.inv(_tcw44(f["extrinsic_Tcw"]))
                for f in frames}

    db = poses_of(store.train_frames)
    if not db:
        return store
    store.train_retrieval = retrieve_top_k_oracle(
        poses_of(store.train_frames), db, k, allow_self_match=False)
    store.test_retrieval = retrieve_top_k_oracle(
        poses_of(store.test_frames), db, k, allow_self_match=True)
    for frames, retrieval in ((store.train_frames, store.train_retrieval),
                              (store.test_frames, store.test_retrieval)):
        for fr in frames:
            fr["top_k"] = retrieval.get(fr["file_name"], [])
    return store
