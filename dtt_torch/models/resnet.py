"""Dilated ResNet with frozen BatchNorm (counterpart of ``dtt.models.resnet``).

* Parameters are float32 and cast to the input's (compute) dtype at use,
  as the reference casts its float32 params; gradients reach the float32
  copies.
* Frozen BN is a per-channel affine ``x * scale + bias`` held in float32
  buffers, so it takes no gradient (the reference's ``stop_gradient``).
* ``frozen_stages`` stops the gradient at the stem (>= 1), layer1 (>= 2)
  and layer2 (>= 3) outputs, as the reference does.
* Stride sits on the 3x3 conv of each bottleneck (torchvision layout);
  layer4 has no stride and dilation 2, so c5 stays at stride 16.
* Paddings are the reference's: ``d*(k//2)`` per conv, 3 on the 7x7/2
  stem, and a 3x3/2 max-pool with padding 1.
* Modules take NCHW tensors; the model keeps them channels-last in memory.
* ``remat`` runs each bottleneck under ``torch.utils.checkpoint``
  (``use_reentrant=False``) when gradients are recorded: its activations
  are recomputed in the backward instead of kept, as ``nn.remat`` does.

Returns c3 (stride 8), c4 (stride 16) and c5 (stride 16, dilated).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


class Conv2d(nn.Conv2d):
    """nn.Conv2d with float32 weight and bias cast to the input's dtype at
    use (the reference's ``param_dtype=float32, dtype=compute``)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class FrozenAffine(nn.Module):
    """Frozen BatchNorm: per-channel float32 scale and bias buffers, cast
    to the input's dtype at use."""

    def __init__(self, features: int, **factory):
        super().__init__()
        self.register_buffer("scale", torch.ones(features, **factory))
        self.register_buffer("bias", torch.zeros(features, **factory))

    def forward(self, x):
        scale = self.scale.to(x.dtype)[:, None, None]
        return x * scale + self.bias.to(x.dtype)[:, None, None]


def _conv(cin, cout, k, stride, dilation, **factory):
    return Conv2d(cin, cout, k, stride=stride, padding=dilation * (k // 2),
                  dilation=dilation, bias=False, **factory)


class Bottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False, **factory):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1, 1, 1, **factory)
        self.bn1 = FrozenAffine(planes, **factory)
        self.conv2 = _conv(planes, planes, 3, stride, dilation, **factory)
        self.bn2 = FrozenAffine(planes, **factory)
        self.conv3 = _conv(planes, planes * 4, 1, 1, 1, **factory)
        self.bn3 = FrozenAffine(planes * 4, **factory)
        if downsample:
            self.downsample_conv = _conv(inplanes, planes * 4, 1, stride, 1,
                                         **factory)
            self.downsample_bn = FrozenAffine(planes * 4, **factory)
        else:
            self.downsample_conv = None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample_conv is not None:
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + x)


class ResNetStage(nn.Sequential):
    def __init__(self, inplanes: int, planes: int, blocks: int,
                 stride: int = 1, dilation: int = 1, remat: bool = False,
                 **factory):
        super().__init__()
        self.remat = remat
        self.add_module("block0", Bottleneck(inplanes, planes, stride, dilation,
                                             downsample=True, **factory))
        for i in range(1, blocks):
            self.add_module(f"block{i}", Bottleneck(planes * 4, planes, 1,
                                                    dilation, **factory))

    def forward(self, x):
        for block in self:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        return x


class ResNetBackbone(nn.Module):
    """Dilated ResNet returning (c3, c4, c5)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3),
                 frozen_stages: int = 2, remat: bool = False, **factory):
        super().__init__()
        self.frozen_stages = frozen_stages
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                            **factory)
        self.bn1 = FrozenAffine(64, **factory)
        self.layer1 = ResNetStage(64, 64, layers[0], remat=remat, **factory)
        self.layer2 = ResNetStage(256, 128, layers[1], stride=2, remat=remat,
                                  **factory)
        self.layer3 = ResNetStage(512, 256, layers[2], stride=2, remat=remat,
                                  **factory)
        self.layer4 = ResNetStage(1024, 512, layers[3], dilation=2,
                                  remat=remat, **factory)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        if self.frozen_stages >= 1:
            x = x.detach()
        x = self.layer1(x)
        if self.frozen_stages >= 2:
            x = x.detach()
        c3 = self.layer2(x)
        if self.frozen_stages >= 3:
            c3 = c3.detach()
        c4 = self.layer3(c3)
        c5 = self.layer4(c4)
        return c3, c4, c5
