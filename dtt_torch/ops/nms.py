"""Static-shape greedy NMS on torch tensors (counterpart of
``dtt.ops.nms``), batched over any leading dims (frames, classes).

A fixed trip count of `max_outputs` steps, each selecting the current best
score and masking every box whose IoU with it is strictly greater than the
threshold: the decisions of ``nms_padded``, and of ``nms_padded_fast``'s
multi-select form. Ties go to the lower index, as ``argmax`` and
``lax.top_k`` take them (``torch.max`` returns the first maximal index).
No step reads a value back to the host, so the loop queues its work on the
device without waiting.
"""

from __future__ import annotations

import torch

from dtt_torch.core import boxes as box_ops

_NEG = -1e10


def take_along(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (*batch, K, *rest), idx (*batch, M) -> (*batch, M, *rest)."""
    nb = idx.dim() - 1
    rest = x.shape[nb + 1:]
    ix = idx.reshape(*idx.shape, *([1] * len(rest))).expand(*idx.shape, *rest)
    return torch.gather(x, nb, ix)


def nms_padded(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold,
               max_outputs: int, valid: torch.Tensor | None = None,
               score_threshold=_NEG / 2):
    """Greedy NMS over K padded boxes per batch entry.

    Args:
      boxes: (..., K, 4) in (x1, y1, x2, y2).
      scores: (..., K).
      iou_threshold: suppress iff IoU > threshold.
      max_outputs: number of kept slots (padded).
      valid: optional (..., K) bool mask of real inputs.
      score_threshold: selections with score <= this are marked invalid.

    Returns:
      keep_idx: (..., max_outputs) int64 indices into K (0 where invalid).
      keep_valid: (..., max_outputs) bool.
    """
    s = scores.float()
    if valid is not None:
        s = s.masked_fill(~valid, _NEG)
    batch = s.shape[:-1]
    area = box_ops.box_area(boxes)
    keep_idx = torch.zeros((*batch, max_outputs), dtype=torch.int64,
                           device=s.device)
    keep_valid = torch.zeros((*batch, max_outputs), dtype=torch.bool,
                             device=s.device)
    for i in range(max_outputs):
        best, j = s.max(dim=-1)
        ok = best > score_threshold
        jj = j[..., None]
        # elementwise_iou's arithmetic, with the areas computed once
        sel = take_along(boxes, jj)                        # (..., 1, 4)
        ix = (torch.minimum(sel[..., 2], boxes[..., 2])
              - torch.maximum(sel[..., 0], boxes[..., 0]) + 1.0)
        iy = (torch.minimum(sel[..., 3], boxes[..., 3])
              - torch.maximum(sel[..., 1], boxes[..., 1]) + 1.0)
        inter = ix.clamp(min=0.0) * iy.clamp(min=0.0)
        union = torch.gather(area, -1, jj) + area - inter
        iou = torch.where(union > 0, inter / union, torch.zeros_like(inter))
        # retire the selected box itself, so the loop always progresses
        new_s = s.masked_fill(iou > iou_threshold, _NEG).scatter(-1, jj, _NEG)
        s = torch.where(ok[..., None], new_s, s)
        keep_idx[..., i] = torch.where(ok, j, torch.zeros_like(j))
        keep_valid[..., i] = ok
    return keep_idx, keep_valid


def nms_gather(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold,
               max_outputs: int, valid: torch.Tensor | None = None,
               score_threshold=_NEG / 2):
    """`nms_padded` returning the kept (boxes (..., M, 4), scores (..., M),
    valid (..., M)) instead of indices; empty slots are 0."""
    idx, keep = nms_padded(boxes, scores, iou_threshold, max_outputs, valid,
                           score_threshold)
    kept_boxes = take_along(boxes, idx) * keep[..., None].to(boxes.dtype)
    kept_scores = torch.where(keep, torch.gather(scores, -1, idx),
                              torch.zeros((), dtype=scores.dtype,
                                          device=scores.device))
    return kept_boxes, kept_scores, keep


def multiclass_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold,
                   max_per_class: int, score_threshold=0.0,
                   valid: torch.Tensor | None = None,
                   per_class_boxes: bool = False):
    """Per-class NMS for the eval path, batched over leading dims.

    Args:
      boxes: (..., K, 4) shared boxes, or (..., K, C, 4) per-class boxes if
        `per_class_boxes`.
      scores: (..., K, C) class scores (background already dropped).
      valid: optional (..., K) bool.

    Returns:
      det_boxes (..., C, M, 4), det_scores (..., C, M),
      det_valid (..., C, M) bool, det_idx (..., C, M) int64 into the K boxes.
    """
    scores_t = scores.transpose(-1, -2)                    # (..., C, K)
    if per_class_boxes:
        boxes_t = boxes.movedim(-2, -3)                    # (..., C, K, 4)
    else:
        boxes_t = boxes.unsqueeze(-3).expand(*scores_t.shape, 4)
    valid_t = None if valid is None else valid.unsqueeze(-2).expand_as(scores_t)
    idx, keep = nms_padded(boxes_t, scores_t, iou_threshold, max_per_class,
                           valid_t, score_threshold)
    kept_boxes = take_along(boxes_t, idx) * keep[..., None].to(boxes.dtype)
    kept_scores = torch.where(keep, torch.gather(scores_t, -1, idx),
                              torch.zeros((), dtype=scores.dtype,
                                          device=scores.device))
    return kept_boxes, kept_scores, keep, idx
