"""Data-dependent frozen-BN calibration, LSUV style (counterpart of
``dtt.utils.calibrate``).

The backbone's BatchNorms are frozen per-channel affines. With pretrained
weights they hold folded running statistics; at random init they are the
identity, and a deep backbone then has no normalization and cannot train
from scratch. Calibration estimates the missing statistics from data:
each affine, in topological order, is rescaled so its output over a
calibration batch has zero mean and unit variance per channel, which is
what folding true running statistics would give. Later affines see
calibrated earlier ones, so one sweep suffices (Mishkin & Matas, "All you
need is a good init", ICLR 2016).

Each group of affines of one topological rank is measured by one backbone
forward, stopped once the group's outputs are captured; the outputs are
cast to float32 before their statistics, as ``dtt`` casts its captured
intermediates.
"""

from __future__ import annotations

import numpy as np
import torch

from dtt_torch.models.dnt import DnT
from dtt_torch.models.resnet import FrozenAffine, ResNetBackbone


def _order_key(name: str):
    """Topological rank of a backbone affine: the stem, then (layer, block,
    bn position); bn3 and downsample_bn are parallel branches of a block
    and share a rank."""
    if name == "bn1":
        return (0, 0, 0)
    layer, block, bn = name.split(".")
    return (int(layer.removeprefix("layer")), int(block.removeprefix("block")),
            {"bn1": 0, "bn2": 1, "bn3": 2, "downsample_bn": 2}[bn])


def affine_groups(backbone: ResNetBackbone) -> list[list[str]]:
    """The backbone's FrozenAffine module names grouped by topological rank
    (one forward measures a group), in ``dtt``'s order."""
    names = sorted((n for n, m in backbone.named_modules()
                    if isinstance(m, FrozenAffine)), key=_order_key)
    groups: list[list[str]] = []
    last = None
    for n in names:
        if _order_key(n) != last:
            groups.append([])
            last = _order_key(n)
        groups[-1].append(n)
    return groups


class _Captured(Exception):
    pass


@torch.no_grad()
def affine_stats(backbone: ResNetBackbone, images: torch.Tensor,
                 names: list[str]) -> dict:
    """Per-channel (mean, var) float32 tensors of the outputs of the
    affines `names` over `images` (N, C, H, W, in the compute dtype), from
    one forward that stops once all of them ran."""
    modules = dict(backbone.named_modules())
    stats: dict = {}

    def hook(name):
        def fn(_module, _inputs, y):
            var, mean = torch.var_mean(y.float(), dim=(0, 2, 3),
                                       unbiased=False)
            stats[name] = (mean, var)
            if len(stats) == len(names):
                raise _Captured
        return fn

    handles = [modules[n].register_forward_hook(hook(n)) for n in names]
    try:
        backbone(images)
    except _Captured:
        pass
    finally:
        for h in handles:
            h.remove()
    return stats


@torch.no_grad()
def calibrate_backbone(backbone: ResNetBackbone, images: torch.Tensor,
                       eps: float = 1e-5) -> ResNetBackbone:
    """Set every FrozenAffine of `backbone`, in place, so its output over
    `images` (N, C, H, W, mean-subtracted, in the compute dtype) is
    ~N(0, 1) per channel."""
    modules = dict(backbone.named_modules())
    for group in affine_groups(backbone):
        stats = affine_stats(backbone, images, group)
        for name in group:
            mean, var = stats[name]
            std = torch.sqrt(var + eps)
            m = modules[name]
            # y = x * s + b  ->  (y - mean) / std
            m.scale.copy_(m.scale / std)
            m.bias.copy_((m.bias - mean) / std)
    return backbone


def calibrate_model_backbone(cfg, model: DnT, pair_images) -> DnT:
    """Calibrate `model`'s backbone in place from `pair_images`, (B, 2, H,
    W, 3) mean-subtracted frame pairs (numpy or a tensor; one training
    batch), both frames of each pair as samples. Raises under the
    scan_blocks layout, as ``dtt`` does."""
    if cfg.model.scan_blocks:
        raise ValueError(
            "calibrate_backbone does not support the scan_blocks parameter "
            "layout (calibration is a from-scratch tool; scanned backbones "
            "are for pretrained production configs): set "
            "model.scan_blocks=false")
    calibrate_backbone(model.backbone, backbone_input(model, pair_images))
    return model


def backbone_input(model: DnT, pair_images) -> torch.Tensor:
    """(B, 2, H, W, 3) mean-subtracted pairs as the backbone's input: the
    2B frames NCHW (channels-last) in the compute dtype, on the model's
    device."""
    images = torch.as_tensor(np.asarray(pair_images, np.float32)
                             if not isinstance(pair_images, torch.Tensor)
                             else pair_images)
    images = images.reshape(-1, *images.shape[2:]).to(
        next(model.parameters()).device)
    return images.permute(0, 3, 1, 2).to(model.dtype).contiguous(
        memory_format=torch.channels_last)
