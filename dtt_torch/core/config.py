"""Immutable configuration tree of the PyTorch port.

A JAX-free copy of ``dtt.core.config``: the same frozen dataclasses, fields,
defaults and YAML keys, so one YAML file configures both packages. ``yaml``
is imported only inside ``load_config``/``save_config``.

Fields that steer the JAX program only are accepted and ignored here:
``EvalConfig.split_video_step`` works around an XLA scheduling artifact
that eager PyTorch does not have, and ``nms_select_block`` shapes JAX
programs. ``ModelConfig.remat`` recomputes each bottleneck in the backward
(``torch.utils.checkpoint``); ``ModelConfig.scan_blocks`` is a parameter
layout only (the stacked stages of ``dtt``'s trees and checkpoints), the
model runs its blocks one by one either way.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Tuple


class _Replaceable:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class AnchorConfig(_Replaceable):
    """Anchor lattice (ref: lib/model/rpn/generate_anchors.py defaults)."""

    base_size: int = 16
    scales: Tuple[float, ...] = (4.0, 8.0, 16.0, 32.0)
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    feat_stride: int = 16

    @property
    def num_anchors(self) -> int:
        return len(self.scales) * len(self.ratios)


@dataclass(frozen=True)
class RPNConfig(_Replaceable):
    """RPN head + proposal filtering (ref: lib/model/rpn/{rpn,proposal_layer}.py)."""

    channels: int = 512
    pre_nms_top_n_train: int = 6000
    post_nms_top_n_train: int = 300
    pre_nms_top_n_test: int = 6000
    post_nms_top_n_test: int = 300
    nms_thresh: float = 0.7
    min_size: float = 16.0
    nms_select_block: int = 32
    batch_size: int = 256
    fg_fraction: float = 0.5
    positive_overlap: float = 0.7
    negative_overlap: float = 0.3
    clobber_positives: bool = False
    bbox_inside_weight: float = 1.0
    positive_weight: float = -1.0  # -1 => uniform 1/num_examples


@dataclass(frozen=True)
class RoIConfig(_Replaceable):
    """Proposal-target sampling + PSRoI heads (ref: proposal_target_layer_cascade.py)."""

    batch_size: int = 128
    fg_fraction: float = 0.25
    fg_thresh: float = 0.5
    bg_thresh_hi: float = 0.5
    bg_thresh_lo: float = 0.0
    bbox_normalize_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    bbox_normalize_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    bbox_normalize_targets_precomputed: bool = True
    ps_grid: int = 7
    pooling_mode: str = "psroi"    # "psroi" | "align" | "pool" | "crop"
    class_agnostic: bool = True
    eval_pool_impl: str = "direct"  # "direct" | "pallas_mm" | "gather"
    train_pool_impl: str = "direct"


@dataclass(frozen=True)
class TrackConfig(_Replaceable):
    """Cross-frame correlation + tracking head (D&T paper §3.2-3.3)."""

    max_displacement: int = 8
    stride: int = 2                # displacement stride => (2d/s+1)^2 = 81 channels
    normalize: bool = True         # cosine correlation
    scales: Tuple[str, ...] = ("c3", "c4", "c5")
    bbox_normalize_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    bbox_normalize_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)

    @property
    def num_corr_channels(self) -> int:
        d = 2 * (self.max_displacement // self.stride) + 1
        return d * d


@dataclass(frozen=True)
class ModelConfig(_Replaceable):
    backbone: str = "resnet101"
    num_classes: int = 31          # ImageNet VID: 30 classes + background
    reduced_channels: int = 1024   # 1x1 conv after conv5 (R-FCN "new conv")
    rpn: RPNConfig = field(default_factory=RPNConfig)
    anchors: AnchorConfig = field(default_factory=AnchorConfig)
    roi: RoIConfig = field(default_factory=RoIConfig)
    track: TrackConfig = field(default_factory=TrackConfig)
    dtype: str = "bfloat16"        # compute dtype for backbone/heads
    frozen_stages: int = 2
    remat: bool = False
    scan_blocks: bool = False


@dataclass(frozen=True)
class InputConfig(_Replaceable):
    """Host input pipeline (ref: lib/roi_data_layer/minibatch.py, utils/blob.py)."""

    target_short_side: int = 600
    canvas_height: int = 608
    canvas_width: int = 1088
    pixel_means: Tuple[float, ...] = (102.9801, 115.9465, 122.7717)  # BGR, Caffe
    use_flipped: bool = True
    max_gt_boxes: int = 30
    synthetic_objects: Tuple[int, int] = (1, 3)
    det_fraction: float = -1.0


@dataclass(frozen=True)
class TrainConfig(_Replaceable):
    """Optimizer + schedule (ref: trainval_net.py defaults)."""

    learning_rate: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 5e-4
    double_bias_lr: bool = True
    bias_decay: bool = False
    gamma: float = 0.1
    lr_decay_steps: Tuple[int, ...] = (80000,)
    warmup_steps: int = 0
    clip_gradients: float = 10.0
    batch_size_per_chip: int = 1
    total_steps: int = 120000
    ohem: bool = True
    ohem_top_k: int = 128
    ohem_nms_thresh: float = 0.7
    seed: int = 3
    checkpoint_every: int = 5000
    log_every: int = 100


@dataclass(frozen=True)
class EvalConfig(_Replaceable):
    score_thresh: float = 1e-3
    nms_thresh: float = 0.3
    max_dets_per_frame: int = 100
    max_per_class: int = 20        # padded per-class detections entering linking
    tube_score_boost: str = "mean_top_half"
    max_tubes_per_class: int = 20
    link_iou_weight: float = 1.0
    nms_select_block: int = 32
    split_video_step: bool = True  # accepted and ignored by the port


@dataclass(frozen=True)
class Config(_Replaceable):
    model: ModelConfig = field(default_factory=ModelConfig)
    input: InputConfig = field(default_factory=InputConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    exp_name: str = "dtt"


def _merge_into(obj, data: dict):
    """Return a copy of frozen dataclass `obj` with dict `data` merged in."""
    updates = {}
    fields = {f.name: f for f in dataclasses.fields(obj)}
    for key, value in data.items():
        if key not in fields:
            raise KeyError(f"unknown config key {key!r} for {type(obj).__name__}")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            updates[key] = _merge_into(current, value)
        elif isinstance(value, dict):
            raise TypeError(
                f"config key {key!r} of {type(obj).__name__} is a scalar, "
                f"cannot assign nested value {value!r}"
            )
        elif isinstance(value, list):
            updates[key] = tuple(value)
        else:
            updates[key] = value
    return dataclasses.replace(obj, **updates)


def config_from_dict(data: dict) -> Config:
    """A Config from a nested dict, as a YAML file or ``dataclasses.asdict``
    (lists for tuples) gives it; missing keys keep their defaults."""
    return _merge_into(Config(), data)


def apply_overrides(cfg: Config, overrides: list[str] | None) -> Config:
    """`cfg` with ``dotted.key=value`` overrides applied, e.g.
    ``model.roi.ps_grid=3`` or ``train.learning_rate=0.01``."""
    import yaml

    for item in overrides or []:
        key, _, raw = item.partition("=")
        if not _:
            raise ValueError(f"override {item!r} must be key=value")
        value = yaml.safe_load(raw)
        tree: Any = value
        for part in reversed(key.strip().split(".")):
            tree = {part: tree}
        cfg = _merge_into(cfg, tree)
    return cfg


def load_config(yaml_path: str | None = None, overrides: list[str] | None = None) -> Config:
    """Build a Config from defaults, an optional YAML file, and CLI overrides
    (see `apply_overrides`)."""
    import yaml

    cfg = Config()
    if yaml_path:
        with open(yaml_path) as f:
            cfg = config_from_dict(yaml.safe_load(f) or {})
    return apply_overrides(cfg, overrides)


def save_config(cfg: Config, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f, sort_keys=False)
