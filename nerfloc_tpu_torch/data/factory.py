"""Dataset factory (counterpart of nerfloc_tpu/data/factory.py).

`dataset_type` names a data YAML under configs/data/ (the `video_*`
families: 7-Scenes, 12-Scenes, Cambridge, OnePose layouts) or is a direct
path to one, or names one of the families `blender`, `llff`, `dtu` and
`colmap` (their own layouts: data/*_scene.py); its per-scene stores are
wrapped in a MultiSceneDataset. A data YAML declares base_dir, the scene
list, the TRANSFORM / AUG_TRANSFORM pipelines and near/far/scale
overrides (`data_cfg` adds to it).
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from ..configs import Config, load_yaml
from .blender_scene import blender_scene_store
from .colmap_scene import colmap_scene_store
from .dtu_scene import dtu_scene_store
from .llff_scene import llff_scene_store
from .scene_store import SceneStore
from .transforms import build_transforms
from .video_dataset import DataOptions, MultiSceneDataset, VideoDataset

_CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs", "data")


def _blender(base_dir: str, scene: str, dc: Dict[str, Any]) -> SceneStore:
    return blender_scene_store(base_dir, scene, near=float(dc.get("near", 2.0)),
                               far=float(dc.get("far", 6.0)))


def _llff(base_dir: str, scene: str, dc: Dict[str, Any]) -> SceneStore:
    return llff_scene_store(base_dir, scene, factor=int(dc.get("factor", 4)))


def _dtu(base_dir: str, scene: str, dc: Dict[str, Any]) -> SceneStore:
    return dtu_scene_store(base_dir, scene, light=str(dc.get("light", "3")),
                           intrinsic_scale=float(dc.get("intrinsic_scale", 4.0)))


def _colmap(base_dir: str, scene: str, dc: Dict[str, Any]) -> SceneStore:
    # one dense workspace per "scene" path
    return colmap_scene_store(os.path.join(base_dir, scene) if base_dir else scene,
                              depth_type=dc.get("depth_type", "colmap"), scene=scene)


# the families with their own layouts: dataset_type -> store builder
_FAMILY_STORES = {"blender": _blender, "llff": _llff, "dtu": _dtu, "colmap": _colmap}


def load_data_yaml(dataset_type: str) -> Dict[str, Any]:
    if dataset_type.endswith((".yaml", ".yml")) and os.path.exists(dataset_type):
        path = dataset_type  # direct-path dataset declaration
    else:
        path = os.path.join(_CONFIG_DIR, f"{dataset_type}.yaml")
    if not os.path.exists(path):
        return {}
    return load_yaml(path) or {}


def build_dataset(cfg: Config, split: str, mode: Optional[str] = None,
                  data_cfg: Optional[Dict[str, Any]] = None) -> MultiSceneDataset:
    """split: 'train' | 'test'; mode defaults to split."""
    mode = mode or ("train" if split == "train" else "test")
    dc = dict(load_data_yaml(cfg.dataset_type))
    if data_cfg:
        dc.update(data_cfg)

    base_dir = cfg.datadir or dc.get("base_dir", "")
    scenes: List[str] = list(cfg.scenes) or list(dc.get("scenes", []))
    if not scenes:
        raise ValueError("no scenes configured (cfg.scenes or data yaml)")

    # fail fast on near-miss keys: a lowercase 'transforms:' section would
    # otherwise be silently ignored
    bad = [k for k in dc if k.lower() in
           ("transform", "transforms", "aug_transform", "aug_transforms")
           and k not in ("TRANSFORM", "AUG_TRANSFORM")]
    if bad:
        raise ValueError(
            f"unknown data-yaml key(s) {bad}: transform pipelines are "
            "declared as TRANSFORM / AUG_TRANSFORM ([{'ResizeAndCrop': {...}}, ...])")
    transforms = build_transforms(dc.get("TRANSFORM", []))
    aug_transforms = build_transforms(dc.get("AUG_TRANSFORM", []))

    n_views = cfg.n_views_train if mode == "train" else cfg.n_views_test
    opts = DataOptions(
        n_views=n_views,
        support_image_selection=cfg.support_image_selection,
        image_core_set_size=cfg.image_core_set_size,
        coreset_sampler=cfg.coreset_sampler,
        max_points=cfg.matching.keypoints_3d_sampling_max_keep,
        aug_ref_depth=bool(dc.get("aug_ref_depth", False)),
    )

    family = _FAMILY_STORES.get(cfg.dataset_type)
    if family is not None:
        return MultiSceneDataset([VideoDataset(family(base_dir, scene, dc), split, transforms,
                                               aug_transforms, opts, mode)
                                  for scene in scenes])

    datasets = []
    for scene in scenes:
        store = SceneStore.load(
            base_dir, scene,
            retrieval_method_train=cfg.image_retrieval_method_train,
            retrieval_method_test=cfg.image_retrieval_method_test,
            near=dc.get("near"), far=dc.get("far"),
            scale_factor=dc.get("scale_factor"),
            rescale_far_limit=dc.get("rescale_far_limit"),
            tempo_interval=int(dc.get("tempo_interval", 1)),
        )
        datasets.append(VideoDataset(
            store, split, transforms, aug_transforms, opts, mode,
            test_time_color_jitter=cfg.test_time_color_jitter,
            test_time_style_change=cfg.test_time_style_change))
    return MultiSceneDataset(datasets)
