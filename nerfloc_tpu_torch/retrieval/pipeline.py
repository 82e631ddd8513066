"""Image-retrieval pipeline (counterpart of nerfloc_tpu/retrieval/pipeline.py):
descriptors or the pose oracle -> top-k lists -> recall.

Per scene, the top-k training frames of every train and test frame are
written to `image_retrieval_{split}_{method}.pkl` ({query file_name: [db
file_names]}), which the datasets read for their support views. 'oracle'
ranks by pose distance (rotation angle + translation); 'netvlad' and
'dir' by descriptor cosine similarity. Descriptors are computed on the
card unless the caller asks for the CPU.

    python -m nerfloc_tpu_torch.retrieval.pipeline --config <yaml> \\
        [--method netvlad|dir|oracle] [--ckpt <netvlad *_struct.mat>] [--device cuda]
"""
from __future__ import annotations

import argparse
import os
import pickle
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.imgproc import resize_area
from ..data.reader import load_image
from ..device import DeviceLike, resolve_device


def retrieve_top_k(query_desc: np.ndarray, query_names: List[str], db_desc: np.ndarray,
                   db_names: List[str], k: int, allow_self_match: bool = False,
                   interval: int = 1) -> Dict[str, List[str]]:
    """Cosine-similarity top-k over L2-normalized descriptors; candidates
    with a similarity <= 0 are dropped."""
    db_desc = db_desc[::interval]
    db_names = list(db_names)[::interval]
    sim = query_desc @ db_desc.T
    if not allow_self_match:
        same = np.asarray(query_names)[:, None] == np.asarray(db_names)[None]
        sim = np.where(same, -np.inf, sim)
    k = min(k, sim.shape[1])
    idx = np.argpartition(-sim, kth=k - 1, axis=1)[:, :k]
    out = {}
    for qi, name in enumerate(query_names):
        cand = idx[qi]
        cand = cand[np.argsort(-sim[qi, cand])]
        out[name] = [db_names[j] for j in cand if sim[qi, j] > 0]
    return out


def pose_distance(T_query: np.ndarray, T_db: np.ndarray, rot_weight: float = 1.0) -> np.ndarray:
    """Rotation angle (rad) times rot_weight plus translation distance
    from one query pose to each db pose."""
    R1 = T_query[None, :3, :3]
    R2 = T_db[:, :3, :3]
    tr = np.trace(np.matmul(R2.transpose(0, 2, 1), R1), axis1=1, axis2=2)
    rot = np.arccos(np.clip((tr - 1) / 2.0, -1 + 1e-8, 1 - 1e-8))
    trans = np.linalg.norm(T_db[:, :3, 3] - T_query[None, :3, 3], axis=1)
    return rot_weight * rot + trans


def retrieve_top_k_oracle(query_poses: Dict[str, np.ndarray], db_poses: Dict[str, np.ndarray],
                          k: int, allow_self_match: bool = False,
                          interval: int = 1) -> Dict[str, List[str]]:
    """Top-k by ground-truth pose distance."""
    db_names = list(db_poses.keys())[::interval]
    T_db = np.stack([db_poses[n] for n in db_names])
    out = {}
    for name, T_q in query_poses.items():
        d = pose_distance(T_q, T_db)
        if not allow_self_match:
            d = np.where(np.asarray(db_names) == name, np.inf, d)
        out[name] = [db_names[j] for j in np.argsort(d)[:k]]
    return out


def evaluate_retrieval(db_poses: Dict[str, np.ndarray], query_poses: Dict[str, np.ndarray],
                       top_k: Dict[str, List[str]], rot_thresh: float = 30.0,
                       trans_thresh: float = 0.5, max_k: int = 5) -> Dict:
    """Recall: the share of queries with at least 1 (2) of their first
    max_k + 1 retrievals within (rot_thresh deg, trans_thresh m)."""
    correct = []
    for name, db_names in top_k.items():
        T_q = query_poses[name]
        cnt = 0
        for db_name in db_names[:max_k + 1]:
            T_d = db_poses[db_name]
            rel = T_d[:3, :3].T @ T_q[:3, :3]
            rot = np.degrees(np.arccos(np.clip((np.trace(rel) - 1) / 2.0, -1.0, 1.0)))
            trans = np.linalg.norm(T_q[:3, 3] - T_d[:3, 3])
            cnt += int(rot < rot_thresh and trans < trans_thresh)
        correct.append(cnt)
    correct = np.asarray(correct)
    return {f"Avg-Recall@{rot_thresh}_{trans_thresh}_{n}": float((correct >= n).mean())
            for n in (1, 2)}


def retrieval_model(method: str, ckpt: Optional[str] = None, seed: int = 0):
    """The descriptor model of `method` on the CPU: an hloc NetVLAD
    checkpoint's weights with `ckpt`, else seeded random ones."""
    from . import get_retrieval_model
    if ckpt is not None and method == "netvlad":
        from .netvlad_weights import load_matconvnet_netvlad
        return load_matconvnet_netvlad(ckpt).eval()
    return get_retrieval_model(method, seed)


def load_retrieval_images(frames, base_dir: str, image_size: int) -> List[np.ndarray]:
    """Each frame's image resized (area) to image_size x image_size, f32 in [0, 1]."""
    return [resize_area(load_image(os.path.join(base_dir, fr["file_name"])), image_size,
                        image_size).astype(np.float32) / 255.0 for fr in frames]


@torch.no_grad()
def extract_descriptors(frames, base_dir: str, method: str = "netvlad", batch: int = 8,
                        image_size: int = 224, model=None, ckpt: Optional[str] = None,
                        device: DeviceLike = None) -> np.ndarray:
    """Global descriptors [N, D] of a frame list, in batches of `batch`
    (the last one padded with its last image); `model` defaults to
    retrieval_model(method, ckpt). Runs on `device` (CUDA unless the
    caller asks for another)."""
    dev = resolve_device(device)
    model = (model if model is not None else retrieval_model(method, ckpt)).to(dev).eval()
    imgs = load_retrieval_images(frames, base_dir, image_size)
    descs = []
    for s in range(0, len(imgs), batch):
        buf = imgs[s:s + batch]
        x = np.stack(buf + [buf[-1]] * (batch - len(buf)))
        descs.append(model(torch.from_numpy(x).to(dev)).float().cpu().numpy()[:len(buf)])
    return np.concatenate(descs, axis=0)


def _poses_of(frames) -> Dict[str, np.ndarray]:
    out = {}
    for f in frames:
        T = np.eye(4)
        T[:3] = np.asarray(f["extrinsic_Tcw"], np.float64)[:3]
        out[f["file_name"]] = np.linalg.inv(T)
    return out


def run_scene_retrieval(store, method: str, k: int, interval_train: int = 1,
                        interval_test: int = 1, model=None, ckpt: Optional[str] = None,
                        device: DeviceLike = None) -> Dict:
    """Write both pkls of one SceneStore and return the test split's
    recall. `model` (netvlad / dir) defaults to retrieval_model(method,
    ckpt), one model for both splits."""
    train_poses = _poses_of(store.train_frames)
    test_poses = _poses_of(store.test_frames)
    if method == "oracle":
        train_to_train = retrieve_top_k_oracle(train_poses, train_poses, k,
                                               interval=interval_train)
        test_to_train = retrieve_top_k_oracle(test_poses, train_poses, k,
                                              interval=interval_test)
    else:
        model = model if model is not None else retrieval_model(method, ckpt)
        train_names = [f["file_name"] for f in store.train_frames]
        test_names = [f["file_name"] for f in store.test_frames]
        d_train = extract_descriptors(store.train_frames, store.base_dir, method,
                                      model=model, device=device)
        d_test = extract_descriptors(store.test_frames, store.base_dir, method,
                                     model=model, device=device)
        train_to_train = retrieve_top_k(d_train, train_names, d_train, train_names, k,
                                        interval=interval_train)
        test_to_train = retrieve_top_k(d_test, test_names, d_train, train_names, k,
                                       interval=interval_test)
    metrics = evaluate_retrieval(train_poses, test_poses, test_to_train, max_k=k)
    for split, table in (("train", train_to_train), ("test", test_to_train)):
        with open(os.path.join(store.scene_dir, f"image_retrieval_{split}_{method}.pkl"),
                  "wb") as f:
            pickle.dump(table, f)
    return metrics


def main(argv: Optional[List[str]] = None) -> int:
    from ..configs import load_config
    from ..data.factory import load_data_yaml
    from ..data.scene_store import SceneStore

    p = argparse.ArgumentParser()
    p.add_argument("--config", type=str, required=True)
    p.add_argument("--method", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None,
                   help="hloc NetVLAD *_struct.mat checkpoint (netvlad only)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; raises without a GPU)")
    args = p.parse_args(argv)
    cfg = load_config(args.config)
    method = args.method or cfg.image_retrieval_method
    dev = resolve_device(args.device)
    dc = load_data_yaml(cfg.dataset_type)
    base_dir = cfg.datadir or dc.get("base_dir", "")
    scenes = list(cfg.scenes) or list(dc.get("scenes", []))
    model = None if method == "oracle" else retrieval_model(method, args.ckpt)
    for scene in scenes:
        store = SceneStore.load(base_dir, scene)
        m = run_scene_retrieval(store, method, cfg.image_core_set_size,
                                cfg.image_retrieval_interval_train,
                                cfg.image_retrieval_interval_test, model=model, device=dev)
        print(scene, m)
    return 0


if __name__ == "__main__":
    sys.exit(main())
