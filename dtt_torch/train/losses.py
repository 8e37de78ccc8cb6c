"""D&T training loss: RPN + R-FCN (with OHEM) + tracking, batched over
the 2B frames of B pairs (counterpart of ``dtt.train.losses.batch_loss``).

Detection losses are computed on both frames of each pair, the tracking
smooth-L1 on frame-t RoIs against the matched track's frame-t+1 ground
truth. Frames run pair-major (pair 0 frame t, pair 0 frame t+1, pair 1
...), as ``dtt`` flattens them; each per-frame loss is averaged over the
pairs and summed over the two frame positions, as ``dtt`` does. Both
frames of all pairs share one proposal-layer call, one target assignment,
one pool per map and one OHEM NMS, which take the same per-frame
decisions as ``dtt``'s per-frame calls.

The step splits into three stages a profile can time one by one:
`forward_heads` (trunk, heads, correlation, track maps), `assign_targets`
(anchor targets, detached proposals, RoI targets) and `head_losses`
(pools and losses); `batch_loss` runs them in order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dtt_torch.core.config import Config
from dtt_torch.models.dnt import (DnT, FrameFeats, normalize_device_images,
                                  pool_vote_batched)
from dtt_torch.models.rpn import Proposals, proposal_layer, rpn_loss, smooth_l1
from dtt_torch.models.targets import (AnchorTargets, Draws, RoITargets,
                                      _top_k_idx, anchor_target,
                                      label_all_rois, proposal_target)
from dtt_torch.ops.nms import nms_padded


class LossBreakdown(NamedTuple):
    total: torch.Tensor
    rpn_cls: torch.Tensor
    rpn_box: torch.Tensor
    rfcn_cls: torch.Tensor
    rfcn_box: torch.Tensor
    track: torch.Tensor
    num_fg: torch.Tensor
    # mean CE over foreground RoIs only: rfcn_cls averages fg and bg, so
    # confident background can hide a chance-level classifier
    fg_ce: torch.Tensor


class Assignment(NamedTuple):
    """What `assign_targets` decides for the 2B frames (pair-major)."""

    anchors: AnchorTargets
    proposals: Proposals
    rois: RoITargets


def _frames(x: torch.Tensor) -> torch.Tensor:
    """(B, 2, ...) per-pair tensor -> (2B, ...) pair-major frames."""
    return x.reshape(-1, *x.shape[2:])


def _pair_sum(per_frame: torch.Tensor) -> torch.Tensor:
    """(2B,) per-frame values -> the mean over pairs of frame t plus that
    of frame t+1."""
    means = per_frame.reshape(-1, 2).mean(dim=0)
    return means[0] + means[1]


def _rfcn_losses(cfg: Config, cls_score: torch.Tensor,
                 bbox_pred: torch.Tensor, tgts: RoITargets):
    """Per-frame cls CE + box smooth-L1, OHEM-ranked if configured:
    (cls (F,), box (F,), fg_ce (F,), sel (F, N)) for F frames of N RoIs,
    where `sel` marks the RoIs the losses average over (the OHEM selection,
    else every valid RoI).

    OHEM with ``ohem_nms_thresh > 0`` runs NMS over the loss-ranked RoIs
    first (R-FCN practice), so near-duplicates of one hard object cannot
    crowd out the other hard examples; the selection carries no gradient.
    """
    mcfg = cfg.model
    labels = tgts.labels
    logp = torch.log_softmax(cls_score, dim=-1)
    ce = -torch.gather(logp, -1, labels[..., None])[..., 0]
    fg_mask = tgts.valid & (labels > 0)
    fg_ce = (torch.where(fg_mask, ce, 0.0).sum(-1)
             / fg_mask.sum(-1).clamp(min=1))

    if mcfg.roi.class_agnostic:
        pred = bbox_pred[..., 4:8]       # fg half of the (bg, fg) pair
    else:
        idx = labels[..., None] * 4 + torch.arange(4, device=labels.device)
        pred = torch.gather(bbox_pred, -1, idx)
    box = smooth_l1(pred, tgts.bbox_targets, sigma=1.0).sum(-1)
    box = box * tgts.bbox_weights

    valid = tgts.valid
    per_roi = torch.where(valid, ce + box, 0.0)
    if not cfg.train.ohem:
        denom = valid.sum(-1).clamp(min=1)
        return (torch.where(valid, ce, 0.0).sum(-1) / denom,
                box.sum(-1) / denom, fg_ce, valid)
    k = min(cfg.train.ohem_top_k, per_roi.shape[-1])
    ranked = per_roi.detach()
    if cfg.train.ohem_nms_thresh > 0:
        keep_idx, keep_valid = nms_padded(
            tgts.rois, ranked, cfg.train.ohem_nms_thresh, k, valid=valid,
            score_threshold=-0.5)
        # invalid slots point at index 0: a count keeps them from clearing
        # a real selection there
        hits = torch.zeros_like(ranked).scatter_add(-1, keep_idx,
                                                    keep_valid.float())
        sel = (hits > 0) & valid
    else:
        idx = _top_k_idx(torch.where(valid, ranked, -torch.inf), k)
        sel = torch.zeros_like(valid).scatter(-1, idx, True) & valid
    denom = sel.sum(-1).clamp(min=1)
    return (torch.where(sel, ce, 0.0).sum(-1) / denom,
            torch.where(sel, box, 0.0).sum(-1) / denom, fg_ce, sel)


def forward_heads(cfg: Config, model: DnT, batch: dict):
    """Normalize the (B, 2, H, W, 3) images on the device, run
    ``frame_features`` over the 2B frames and ``track_psmaps`` over the B
    pairs: (features of the 2B frames, (B, H, W, k^2*4) track maps)."""
    images = _frames(batch["images"])
    sizes = batch["im_size"].repeat_interleave(2, dim=0)
    images = normalize_device_images(images, sizes, cfg.input.pixel_means)
    feats = model.frame_features(images)
    track_maps = model.track_psmaps(feats.slice(slice(0, None, 2)),
                                    feats.slice(slice(1, None, 2)))
    return feats, track_maps


def assign_targets(cfg: Config, feats: FrameFeats, anchors: torch.Tensor,
                   batch: dict, draws: Draws) -> Assignment:
    """Anchor targets, train-mode proposals (detached) and RoI targets for
    the 2B frames: OHEM labels every proposal (``label_all_rois``),
    otherwise a sampled batch (``proposal_target``). Track targets point
    from each frame's RoIs to the other frame's ground truth."""
    mcfg = cfg.model
    gt_boxes = _frames(batch["gt_boxes"])
    gt_valid = _frames(batch["gt_valid"])
    other_boxes = _frames(batch["gt_boxes"].flip(1))
    other_valid = _frames(batch["gt_valid"].flip(1))
    gt_labels = batch["gt_labels"].repeat_interleave(2, dim=0)
    sizes = batch["im_size"].repeat_interleave(2, dim=0)
    scales = batch["im_scale"].repeat_interleave(2, dim=0)
    at = anchor_target(anchors, gt_boxes, gt_valid, sizes[:, 0], sizes[:, 1],
                       _frames(draws.anchor_pos), _frames(draws.anchor_neg),
                       mcfg.rpn)
    props = proposal_layer(feats.rpn_cls, feats.rpn_bbox, anchors,
                           sizes[:, 0], sizes[:, 1], scales, mcfg.rpn,
                           train=True)
    if cfg.train.ohem:
        tgts = label_all_rois(props.rois, props.valid, gt_boxes, gt_labels,
                              gt_valid, other_boxes, other_valid, mcfg.roi,
                              mcfg.track)
    else:
        tgts = proposal_target(props.rois, props.valid, gt_boxes, gt_labels,
                               gt_valid, other_boxes, other_valid,
                               _frames(draws.roi_fg), _frames(draws.roi_slot),
                               mcfg.roi, mcfg.track)
    return Assignment(at, props, tgts)


def head_losses(cfg: Config, feats: FrameFeats, track_maps: torch.Tensor,
                assignment: Assignment) -> LossBreakdown:
    """RPN losses, the pooled R-FCN losses of both frames and the track
    loss of frame t, from the features and the assignment."""
    mcfg = cfg.model
    at, tgts = assignment.anchors, assignment.rois
    spatial_scale = 1.0 / mcfg.anchors.feat_stride
    impl = mcfg.roi.train_pool_impl
    l_cls, l_box = rpn_loss(feats.rpn_cls, feats.rpn_bbox, at.labels,
                            at.bbox_targets, at.bbox_weights, sigma=3.0,
                            inside_weight=mcfg.rpn.bbox_inside_weight)

    cls_score = pool_vote_batched(mcfg, feats.cls_maps, tgts.rois,
                                  spatial_scale, impl)
    bbox_pred = pool_vote_batched(mcfg, feats.bbox_maps, tgts.rois,
                                  spatial_scale, impl)
    l_rcls, l_rbox, l_fg_ce, _ = _rfcn_losses(cfg, cls_score, bbox_pred,
                                              tgts)

    # tracking head: frame-t RoIs regressed to the frame-t+1 ground truth
    t = slice(0, None, 2)
    trk_pred = pool_vote_batched(mcfg, track_maps, tgts.rois[t],
                                 spatial_scale, impl)
    tw = tgts.track_weights[t]
    tl = smooth_l1(trk_pred, tgts.track_targets[t], sigma=1.0).sum(-1) * tw
    track_loss = (tl.sum(-1) / tw.sum(-1).clamp(min=1.0)).mean()

    rpn_cls, rpn_box = _pair_sum(l_cls), _pair_sum(l_box)
    rfcn_cls, rfcn_box = _pair_sum(l_rcls), _pair_sum(l_rbox)
    total = rpn_cls + rpn_box + rfcn_cls + rfcn_box + track_loss
    return LossBreakdown(total=total, rpn_cls=rpn_cls, rpn_box=rpn_box,
                         rfcn_cls=rfcn_cls, rfcn_box=rfcn_box,
                         track=track_loss,
                         num_fg=_pair_sum(tgts.bbox_weights.sum(-1)),
                         fg_ce=0.5 * _pair_sum(l_fg_ce))


def batch_loss(cfg: Config, model: DnT, anchors: torch.Tensor, batch: dict,
               draws: Draws) -> tuple[torch.Tensor, LossBreakdown]:
    """Mean D&T loss over a batch of B pairs on the model's device.

    batch: images (B, 2, H, W, 3) uint8 or mean-subtracted float,
    gt_boxes (B, 2, G, 4), gt_labels (B, G) int64, gt_valid (B, 2, G),
    im_scale (B,), im_size (B, 2). `draws`: the sampling uniforms
    (``sample_draws``).
    """
    feats, track_maps = forward_heads(cfg, model, batch)
    assignment = assign_targets(cfg, feats, anchors, batch, draws)
    lb = head_losses(cfg, feats, track_maps, assignment)
    return lb.total, lb
