"""Region Proposal Network: head, static-shape proposal layer and loss
(counterpart of ``dtt.models.rpn``).

The proposal layer keeps fixed pre/post-NMS budgets and a validity mask
instead of dynamic filtering, batched over frames.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dtt_torch.core import boxes as box_ops
from dtt_torch.core.config import RPNConfig
from dtt_torch.models.resnet import Conv2d
from dtt_torch.ops.nms import nms_padded_fast, take_along


class RPNHead(nn.Module):
    """3x3 conv + twin 1x1 heads. Takes NCHW; returns NHWC float32 logits
    laid out (..., A, 2) per cell (anchor-major) and box deltas (..., A*4).
    Float32 parameters, computed in the input's dtype."""

    def __init__(self, in_channels: int, num_anchors: int,
                 channels: int = 512, **factory):
        super().__init__()
        self.conv = Conv2d(in_channels, channels, 3, padding=1, **factory)
        self.cls_score = Conv2d(channels, num_anchors * 2, 1, **factory)
        self.bbox_pred = Conv2d(channels, num_anchors * 4, 1, **factory)

    def forward(self, feat):
        x = F.relu(self.conv(feat))
        nhwc = lambda t: t.float().permute(0, 2, 3, 1)
        return nhwc(self.cls_score(x)), nhwc(self.bbox_pred(x))


class Proposals(NamedTuple):
    rois: torch.Tensor    # (B, K_post, 4)
    scores: torch.Tensor  # (B, K_post)
    valid: torch.Tensor   # (B, K_post) bool


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last dim in the reference's form:
    exp(x - max) / sum(exp(x - max))."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _per_frame(x):
    """A per-frame (B,) tensor as (B, 1), to broadcast over the anchors;
    numbers and 0-d tensors as they are."""
    return x[:, None] if isinstance(x, torch.Tensor) and x.dim() == 1 else x


def proposal_layer(rpn_cls: torch.Tensor,     # (B, H, W, 2A)
                   rpn_bbox: torch.Tensor,    # (B, H, W, 4A)
                   anchors: torch.Tensor,     # (H*W*A, 4)
                   im_height, im_width, im_scale,
                   cfg: RPNConfig, train: bool = False) -> Proposals:
    """Decode -> clip -> min-size filter -> top-K -> NMS -> top-N, at the
    train or test budgets. The image size and scale are numbers, 0-d
    tensors or per-frame (B,) tensors. In train mode the inputs are
    detached: proposals carry no gradient, as in the reference. The top-K
    is a stable descending sort, so tied scores keep the lower index
    first, as ``lax.top_k`` does. The NMS is the multi-select form in both
    modes (`cfg.nms_select_block` candidates a step), as in ``dtt``."""
    if train:
        rpn_cls, rpn_bbox = rpn_cls.detach(), rpn_bbox.detach()
    b = rpn_cls.shape[0]
    fg_scores = softmax(rpn_cls.reshape(b, -1, 2))[..., 1]
    proposals = box_ops.decode_boxes(anchors, rpn_bbox.reshape(b, -1, 4))
    proposals = box_ops.clip_boxes(proposals, _per_frame(im_height),
                                   _per_frame(im_width))

    ws = proposals[..., 2] - proposals[..., 0] + 1.0
    hs = proposals[..., 3] - proposals[..., 1] + 1.0
    if isinstance(im_scale, torch.Tensor):
        min_size = _per_frame(im_scale.float() * np.float32(cfg.min_size))
    else:
        min_size = float(np.float32(cfg.min_size) * np.float32(im_scale))
    keep = (ws >= min_size) & (hs >= min_size)
    scores = torch.where(keep, fg_scores, torch.full_like(fg_scores, -1.0))

    k_pre = min(cfg.pre_nms_top_n_train if train else cfg.pre_nms_top_n_test,
                scores.shape[-1])
    k_post = cfg.post_nms_top_n_train if train else cfg.post_nms_top_n_test
    top_scores, top_idx = torch.sort(scores, dim=-1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k_pre], top_idx[:, :k_pre]
    top_boxes = take_along(proposals, top_idx)
    keep_idx, keep_valid = nms_padded_fast(
        top_boxes, top_scores, cfg.nms_thresh, k_post,
        valid=top_scores >= 0.0, score_threshold=-0.5,
        select_block=cfg.nms_select_block)
    rois = take_along(top_boxes, keep_idx) * keep_valid[..., None]
    out_scores = torch.where(keep_valid, torch.gather(top_scores, -1, keep_idx),
                             torch.zeros_like(top_scores[:, :1]))
    return Proposals(rois=rois, scores=out_scores, valid=keep_valid)


def rpn_loss(rpn_cls: torch.Tensor,        # (B, H, W, 2A)
             rpn_bbox: torch.Tensor,       # (B, H, W, 4A)
             labels: torch.Tensor,         # (B, HWA) in {-1, 0, 1}
             bbox_targets: torch.Tensor,   # (B, HWA, 4)
             bbox_weights: torch.Tensor,   # (B, HWA) outside weights
             sigma: float = 3.0, inside_weight: float = 1.0):
    """Per-frame RPN losses (cls (B,), box (B,)) over the anchor map with
    ignore masking (ref rpn.py). `inside_weight` scales the regression
    difference before the smooth-L1 hinge, as the reference's
    RPN_BBOX_INSIDE_WEIGHTS does."""
    b = rpn_cls.shape[0]
    logp = torch.log_softmax(rpn_cls.reshape(b, -1, 2), dim=-1)
    use = labels >= 0
    ce = -torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    n_cls = use.sum(-1).clamp(min=1)
    cls_loss = torch.where(use, ce, 0.0).sum(-1) / n_cls
    pred = rpn_bbox.reshape(b, -1, 4)
    box_loss = (smooth_l1(inside_weight * pred, inside_weight * bbox_targets,
                          sigma) * bbox_weights[..., None]).sum(dim=(-2, -1))
    return cls_loss, box_loss


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, sigma: float = 1.0
              ) -> torch.Tensor:
    """Elementwise smooth-L1 with the Fast R-CNN sigma convention
    (ref: lib/model/utils/net_utils.py _smooth_l1_loss)."""
    s2 = sigma * sigma
    diff = pred - target
    ad = diff.abs()
    return torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)
