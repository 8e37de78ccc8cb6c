"""Static-shape target assignment for RPN anchors and RoIs, batched over
frames (counterpart of ``dtt.models.targets``).

Fixed sample budgets and validity masks instead of dynamic shapes, as in
the reference: subsampling is a top-k over random priorities. The random
numbers are an explicit input (`Draws`), one uniform per candidate, where
``dtt`` draws them from JAX keys inside each function: `sample_draws`
makes them from a ``torch.Generator``, and a parity test hands in the
arrays JAX draws so both packages take the same decisions.

D&T extension: the RoI targets also carry *tracking* regression targets,
the encoded displacement from an RoI in frame t to the same track's ground
truth in the other frame (slot g holds the same track in both frames).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dtt_torch.core import boxes as box_ops
from dtt_torch.core.config import Config, RoIConfig, RPNConfig, TrackConfig
from dtt_torch.ops.nms import take_along

_NEG = -1e9


def roi_norm_params(cfg: RoIConfig):
    """(means, stds) for RCNN bbox-target normalization (identity when the
    targets are not normalized)."""
    if cfg.bbox_normalize_targets_precomputed:
        return cfg.bbox_normalize_means, cfg.bbox_normalize_stds
    return (0.0, 0.0, 0.0, 0.0), (1.0, 1.0, 1.0, 1.0)


class Draws(NamedTuple):
    """Uniforms in [0, 1) for the target sampling of a batch of B pairs,
    indexed (pair, frame, candidate), as ``dtt.train.losses.batch_loss``
    draws them per frame from its keys."""

    anchor_pos: torch.Tensor   # (B, 2, A) positive-anchor priorities
    anchor_neg: torch.Tensor   # (B, 2, A) negative-anchor priorities
    roi_fg: torch.Tensor       # (B, 2, R) foreground-RoI priorities
    roi_slot: torch.Tensor     # (B, 2, R) RoI slot priorities


def sample_draws(cfg: Config, batch: int, generator=None,
                 device=None) -> Draws:
    """Draws for `batch` pairs at ``cfg``'s canvas: A anchors per frame
    and R = post-NMS train proposals + max gt boxes candidate RoIs."""
    m = cfg.model
    a = ((cfg.input.canvas_height // m.anchors.feat_stride)
         * (cfg.input.canvas_width // m.anchors.feat_stride)
         * m.anchors.num_anchors)
    r = m.rpn.post_nms_top_n_train + cfg.input.max_gt_boxes
    u = lambda n: torch.rand((batch, 2, n), generator=generator,
                             device=device)
    return Draws(anchor_pos=u(a), anchor_neg=u(a), roi_fg=u(r), roi_slot=u(r))


def _top_k_idx(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last dim, ties to the
    lower index (as ``lax.top_k``)."""
    return torch.sort(score, dim=-1, descending=True, stable=True)[1][..., :k]


def _capped_random_mask(eligible: torch.Tensor, cap: int,
                        u: torch.Tensor) -> torch.Tensor:
    """(..., n) mask selecting at most `cap` eligible entries: those with
    the largest uniforms `u`."""
    idx = _top_k_idx(torch.where(eligible, u, _NEG),
                     min(cap, eligible.shape[-1]))
    return torch.zeros_like(eligible).scatter(-1, idx, True) & eligible


class AnchorTargets(NamedTuple):
    labels: torch.Tensor         # (B, A) in {-1 ignore, 0 neg, 1 pos}
    bbox_targets: torch.Tensor   # (B, A, 4) unnormalized encode() deltas
    bbox_weights: torch.Tensor   # (B, A) loss weight rows (pos / num_examples)


def anchor_target(anchors: torch.Tensor,      # (A, 4)
                  gt_boxes: torch.Tensor,     # (B, G, 4)
                  gt_valid: torch.Tensor,     # (B, G) bool
                  im_height: torch.Tensor,    # (B,)
                  im_width: torch.Tensor,     # (B,)
                  u_pos: torch.Tensor,        # (B, A) uniforms
                  u_neg: torch.Tensor,        # (B, A) uniforms
                  cfg: RPNConfig) -> AnchorTargets:
    """RPN anchor labels and regression targets per frame: positives by
    IoU >= positive_overlap or as a gt's best inside anchor, negatives
    below negative_overlap, anchors outside the true image extent ignored;
    at most fg_fraction * batch_size positives and negatives filling the
    batch, sampled by the uniforms."""
    a = anchors.shape[0]
    inside = ((anchors[:, 0] >= 0) & (anchors[:, 1] >= 0)
              & (anchors[:, 2] < im_width[:, None])
              & (anchors[:, 3] < im_height[:, None]))            # (B, A)

    iou = box_ops.pairwise_iou(anchors[None], gt_boxes)          # (B, A, G)
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    max_iou, argmax_gt = iou.max(dim=-1)

    # per-gt best anchors (ties included), restricted to inside anchors
    iou_in = torch.where(inside[..., None], iou, -1.0)
    gt_best = iou_in.max(dim=1).values[:, None, :]               # (B, 1, G)
    is_best = ((iou_in == gt_best) & gt_valid[:, None, :]
               & (gt_best > 0)).any(dim=-1)

    neg = max_iou < cfg.negative_overlap
    pos = is_best | (max_iou >= cfg.positive_overlap)
    if cfg.clobber_positives:
        pos = pos & ~neg
    else:
        neg = neg & ~pos
    pos = pos & inside
    neg = neg & inside

    max_pos = int(cfg.fg_fraction * cfg.batch_size)
    pos_sel = _capped_random_mask(pos, max_pos, u_pos)
    num_pos = pos_sel.sum(-1)

    # negatives fill the remaining budget: a top-k at the static batch
    # size, the dynamic budget enforced by rank
    k_budget = min(cfg.batch_size, a)
    neg_idx = _top_k_idx(torch.where(neg, u_neg, _NEG), k_budget)
    rank = torch.arange(k_budget, device=anchors.device)
    neg_rank_keep = rank < (cfg.batch_size - num_pos)[:, None]
    neg_sel = torch.zeros_like(neg).scatter(-1, neg_idx, neg_rank_keep) & neg

    labels = torch.where(pos_sel, 1, torch.where(neg_sel, 0, -1))
    matched = take_along(gt_boxes, argmax_gt)
    bbox_targets = torch.where(pos_sel[..., None],
                               box_ops.encode_boxes(anchors, matched), 0.0)
    num_examples = (num_pos + neg_sel.sum(-1)).clamp(min=1)[:, None]
    if cfg.positive_weight < 0:
        w = pos_sel.float() / num_examples
    else:
        w = pos_sel.float() * (cfg.positive_weight
                               / num_pos.clamp(min=1)[:, None])
    return AnchorTargets(labels=labels, bbox_targets=bbox_targets,
                         bbox_weights=w)


class RoITargets(NamedTuple):
    rois: torch.Tensor            # (B, S, 4) boxes (frame t)
    labels: torch.Tensor          # (B, S) int64 class ids, 0 = background
    valid: torch.Tensor           # (B, S) slot holds a real roi
    bbox_targets: torch.Tensor    # (B, S, 4) normalized deltas to matched gt
    bbox_weights: torch.Tensor    # (B, S) 1.0 for fg
    track_targets: torch.Tensor   # (B, S, 4) normalized deltas roi -> gt(other)
    track_weights: torch.Tensor   # (B, S) 1.0 where fg & track visible there


def _match(rois, roi_valid, gt_boxes, gt_valid):
    """Candidates = proposals + gt boxes; each one's best gt IoU and
    index (first maximum, as ``argmax``)."""
    all_rois = torch.cat([rois, gt_boxes], dim=1)
    all_valid = torch.cat([roi_valid, gt_valid], dim=1)
    iou = box_ops.pairwise_iou(all_rois, gt_boxes)
    iou = torch.where(gt_valid[:, None, :] & all_valid[..., None], iou, -1.0)
    max_iou, argmax_gt = iou.max(dim=-1)
    return all_rois, all_valid, max_iou, argmax_gt


def _regression_targets(rois, fg, arg, gt_boxes, gt_valid_tau, gt_boxes_tau,
                        cfg: RoIConfig, track_cfg: TrackConfig | None):
    """bbox targets to the matched gt and track targets to the matched
    track's box in the other frame, zero where not foreground (track: or
    where the track is not visible there, or without `track_cfg`)."""
    means, stds = roi_norm_params(cfg)
    bbox_targets = torch.where(
        fg[..., None],
        box_ops.encode_boxes(rois, take_along(gt_boxes, arg), means, stds),
        0.0)
    if track_cfg is None:
        return (bbox_targets, torch.zeros_like(bbox_targets),
                torch.zeros_like(fg, dtype=torch.float32))
    trk_ok = fg & torch.gather(gt_valid_tau, -1, arg)
    track_targets = torch.where(
        trk_ok[..., None],
        box_ops.encode_boxes(rois, take_along(gt_boxes_tau, arg),
                             track_cfg.bbox_normalize_means,
                             track_cfg.bbox_normalize_stds), 0.0)
    return bbox_targets, track_targets, trk_ok.float()


def proposal_target(rois: torch.Tensor,          # (B, R, 4) proposals
                    roi_valid: torch.Tensor,     # (B, R)
                    gt_boxes: torch.Tensor,      # (B, G, 4)
                    gt_labels: torch.Tensor,     # (B, G) int64 class ids
                    gt_valid: torch.Tensor,      # (B, G)
                    gt_boxes_tau: torch.Tensor,  # (B, G, 4) other frame
                    gt_valid_tau: torch.Tensor,  # (B, G)
                    u_fg: torch.Tensor,          # (B, R + G) uniforms
                    u_slot: torch.Tensor,        # (B, R + G) uniforms
                    cfg: RoIConfig,
                    track_cfg: TrackConfig | None = None) -> RoITargets:
    """Sample a fixed fg/bg RoI batch + regression/tracking targets: gt
    boxes join the candidates, fg/bg split by IoU thresholds, at most
    fg_fraction * batch_size fg and bg filling the batch. Slots left
    holding neither are invalid, never relabelled background."""
    all_rois, all_valid, max_iou, argmax_gt = _match(rois, roi_valid,
                                                     gt_boxes, gt_valid)
    fg = all_valid & (max_iou >= cfg.fg_thresh)
    bg = (all_valid & (max_iou < cfg.bg_thresh_hi)
          & (max_iou >= cfg.bg_thresh_lo))

    fg_sel = _capped_random_mask(fg, int(round(cfg.fg_fraction
                                               * cfg.batch_size)), u_fg)
    priority = torch.where(fg_sel, 3.0 + u_slot,
                           torch.where(bg, 2.0 + u_slot, u_slot - 10.0))
    slot_idx = _top_k_idx(priority, cfg.batch_size)

    sel_rois = take_along(all_rois, slot_idx)
    sel_fg = torch.gather(fg_sel, -1, slot_idx)
    sel_valid = sel_fg | torch.gather(bg, -1, slot_idx)
    sel_arg = torch.gather(argmax_gt, -1, slot_idx)
    labels = torch.where(sel_fg, torch.gather(gt_labels, -1, sel_arg), 0)
    labels = torch.where(sel_valid, labels, 0)
    bbox_targets, track_targets, track_weights = _regression_targets(
        sel_rois, sel_fg, sel_arg, gt_boxes, gt_valid_tau, gt_boxes_tau, cfg,
        track_cfg)
    return RoITargets(rois=sel_rois, labels=labels, valid=sel_valid,
                      bbox_targets=bbox_targets,
                      bbox_weights=sel_fg.float(),
                      track_targets=track_targets,
                      track_weights=track_weights)


def label_all_rois(rois: torch.Tensor, roi_valid: torch.Tensor,
                   gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                   gt_valid: torch.Tensor, gt_boxes_tau: torch.Tensor,
                   gt_valid_tau: torch.Tensor, cfg: RoIConfig,
                   track_cfg: TrackConfig | None = None) -> RoITargets:
    """OHEM path: label every candidate (proposals + gt boxes), with no
    sampling; the loss ranks hardness. Every valid non-fg RoI is
    background."""
    all_rois, all_valid, max_iou, argmax_gt = _match(rois, roi_valid,
                                                     gt_boxes, gt_valid)
    fg = all_valid & (max_iou >= cfg.fg_thresh)
    labels = torch.where(fg, torch.gather(gt_labels, -1, argmax_gt), 0)
    bbox_targets, track_targets, track_weights = _regression_targets(
        all_rois, fg, argmax_gt, gt_boxes, gt_valid_tau, gt_boxes_tau, cfg,
        track_cfg)
    return RoITargets(rois=all_rois, labels=labels, valid=all_valid,
                      bbox_targets=bbox_targets, bbox_weights=fg.float(),
                      track_targets=track_targets,
                      track_weights=track_weights)
