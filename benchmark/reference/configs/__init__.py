"""Typed config tree: a copy of the JAX package's frozen dataclasses
(nerfloc_tpu/configs/__init__.py), kept here so the port imports nothing of
that package. Field names and defaults are identical; see the original for
the rationale behind each TPU-era knob. The benchmark builds a Config from
its configuration file's overrides (`_merge`); nothing here reads YAML.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch



@dataclass(frozen=True)
class RenderConfig:
    N_samples: int = 64
    N_importance: int = 0
    N_guide: int = 64
    N_rand: int = 1024
    chunk: int = 2048
    lindisp: bool = False
    white_bkgd: bool = False
    use_render_uncertainty: bool = True
    render_feature: bool = True
    knn_mode: str = "proj"
    knn_proj_window: int = 3
    use_merged_table: bool = False
    prune_views: int = 0
    knn_candidates: int = 128
    geo_assembly: str = "gather"
    # 'int8' quantizes the feature gather tables (ops/interp.QuantTable):
    # an inference knob only, since rounding passes no gradient, so a train
    # step with it gets no render-loss gradient into the feature maps
    table_dtype: str = "bf16"
    # neighbour aggregation in query() through the fused kernel
    # (ops/fused_agg.py) instead of the unfused module chain
    fused_query_agg: bool = False


@dataclass(frozen=True)
class MatchingConfig:
    keypoints_3d_sampling: str = "random"
    keypoints_3d_sampling_max_keep: int = 100000
    coarse_matching_depth_thresh: float = 2.0
    coarse_num_3d_keypoints: int = 1024
    fine_num_3d_keypoints: int = 1024
    max_kp2d: int = 2048
    max_fine_pairs: int = 1024
    fine_window_size: int = 7
    thr: float = 0.2


@dataclass(frozen=True)
class StaticShapeConfig:
    n_views: int = 10
    image_h: int = 256
    image_w: int = 256
    n_rays_train: int = 1024
    pnp_hypotheses: int = 512
    pose_refine_rays: int = 512


@dataclass(frozen=True)
class Config:
    expname: str = ""
    basedir: str = ""
    datadir: str = ""
    version: str = "default"
    ckpt: str = ""
    dataset_type: str = "video_7scenes"
    scenes: Tuple[str, ...] = ()

    max_epochs: int = 50
    lrate: float = 5e-4
    lrate_decay_steps: int = 50000
    lrate_decay_factor: float = 0.5

    train_nerf: bool = True
    train_pose: bool = True

    backbone2d: str = "cotr"
    backbone2d_fpn_dim: int = 192
    backbone2d_use_fpn: bool = True
    backbone2d_coarse_layer_name: str = "layer2"
    backbone2d_fine_layer_name: str = "layer1"

    support_image_selection: str = "retrieval"
    n_views_train: int = 5
    n_views_test: int = 10
    image_core_set_size: int = 16
    image_retrieval_method: str = "netvlad"
    image_retrieval_method_train: str = "netvlad"
    image_retrieval_method_test: str = "netvlad"
    image_retrieval_interval_train: int = 1
    image_retrieval_interval_test: int = 1
    coreset_sampler: str = "FPS"

    model_3d_hidden_dim: int = 128
    use_scene_coord_memorization: bool = False

    encode_appearance: bool = True
    appearance_emb_dim: int = 128

    simple_3d_model: bool = False

    multires: int = 10
    multires_views: int = 4
    i_embed: int = 0

    render: RenderConfig = field(default_factory=RenderConfig)

    use_depth_supervision: bool = False
    coarse_loss_weight: float = 10000.0
    fine_loss_weight: float = 10.0
    render_loss_weight: float = 1.0
    ref_depth_loss_weight: float = 0.1

    keypoints_3d_source: str = "depth"
    matcher_hidden_dim: int = 192
    matching: MatchingConfig = field(default_factory=MatchingConfig)
    fine_matching_loss_type: str = "l2_with_std"

    ransac_thresh: float = 8.0
    rotation_eval_thresh: float = 5.0
    translation_eval_thresh: float = 0.05

    cascade_matching: bool = False
    optimize_pose: bool = False
    optimize_pose_sampling: str = "random"
    test_time_color_jitter: bool = False
    test_time_style_change: bool = False
    test_render_interval: int = 50
    vis_3d_box: bool = False
    vis_rendering: bool = False
    vis_trajectory: bool = False

    shapes: StaticShapeConfig = field(default_factory=StaticShapeConfig)

    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    mesh_data_axis: int = 1
    mesh_ray_axis: int = 1

    def __post_init__(self):
        # the 3D positional embedding packs sin+cos x 3 axes per band
        if self.matcher_hidden_dim % 6 != 0:
            raise ValueError(
                f"matcher_hidden_dim={self.matcher_hidden_dim} must be "
                "divisible by 6 (3D positional embedding packs "
                "sin+cos x 3 axes per band)")


def compute_dtype_of(cfg: Config) -> torch.dtype:
    """cfg.compute_dtype as a torch dtype: the model's compute dtype, as the
    JAX package's CLIs and bench build it (parameters stay f32)."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.compute_dtype]


def _merge(obj: Any, overrides: Dict[str, Any]) -> Any:
    """Recursively apply a nested dict onto a (frozen) dataclass tree."""
    if not dataclasses.is_dataclass(obj):
        return overrides
    kwargs = {}
    names = {f.name for f in dataclasses.fields(obj)}
    for k, v in overrides.items():
        if k not in names:
            raise KeyError(f"unknown config key: {k!r}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            kwargs[k] = _merge(cur, v)
        elif isinstance(cur, tuple) and isinstance(v, list):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    return dataclasses.replace(obj, **kwargs)


def get_cfg_defaults() -> Config:
    return Config()


def override_cfg_with_args(cfg: Config, args: Any) -> Config:
    """Apply argparse namespace values onto matching top-level config keys
    (None means not given)."""
    names = {f.name for f in dataclasses.fields(cfg)}
    updates = {k: v for k, v in vars(args).items() if k in names and v is not None}
    return dataclasses.replace(cfg, **updates)
