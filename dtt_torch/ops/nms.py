"""Static-shape greedy NMS on torch tensors (counterpart of
``dtt.ops.nms``), batched over any leading dims (frames, classes).

A box is suppressed iff its IoU with a kept, higher-ranked box is strictly
greater than the threshold; a selection is live iff its score is strictly
greater than `score_threshold`; ties go to the lower index, as ``argmax``
and ``lax.top_k`` take them; empty slots hold index 0 and are not valid.
Each form keeps its ``dtt`` form's order of the two zeros: ``argmax``
(``nms_padded``) ties +0.0 with -0.0, ``lax.top_k`` (``nms_padded_fast``)
orders floats totally and ranks +0.0 first.

* `nms_padded_plain` — ``dtt``'s ``nms_padded``: a fixed trip count of
  `max_outputs` steps, each selecting the current best score (``torch.max``
  returns the first maximal index) and masking every box it overlaps. No
  step reads a value back to the host.
* `nms_padded_fast_plain` — ``dtt``'s ``nms_padded_fast``: each step takes
  the top `select_block` live scores (a stable descending sort on the
  total order, `total_order_key`), resolves
  them among themselves greedily over their IoU panel, commits the
  survivors and masks what they overlap, until the budget is full or no
  live score is left. The same decisions in fewer steps; its loop test is
  a host read a step, which costs nothing on the CPU.
* `nms_cuda` — the hand-written kernel ``dtt_nms_select``
  (``csrc/nms.cu``): the multi-select loop of every problem of a batch in
  one launch, a thread block per problem, no host read. Each problem
  orders its live boxes once, then walks that order a step of candidates
  at a time; `nms_layout` says where the ordered boxes sit. It replaces
  the device loop ``dtt`` leaves to XLA (``nms_padded_fast``'s
  ``lax.while_loop``; there is no Pallas kernel).
* `nms_padded` / `nms_padded_fast` — the dispatchers: each runs its plain
  form on CPU tensors and launches the kernel on CUDA tensors, in its own
  order of the zeros (otherwise their decisions are the same), or
  raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from dtt_torch.core import boxes as box_ops
from dtt_torch.ops import _build

_NEG = -1e10
# the kernel's candidates a step at most: one warp resolves them
KERNEL_BLOCK = 32
# a block's shared memory on the card (227 KB), and what the kernel's
# static part may take of it (``kStaticSmem`` in ``csrc/nms.cu``)
SMEM_LIMIT = _build.SMEM_LIMIT
_STATIC_SMEM = 1_024


class NmsLayout(NamedTuple):
    body: str        # "shared" or "scratch": where the ordered boxes sit
    smem: int        # dynamic shared memory a block, bytes
    scratch: int     # scratch a problem, bytes (0 for "shared")


def nms_layout(k: int) -> NmsLayout:
    """Where ``dtt_nms_select`` keeps a problem of `k` boxes. It stages
    the boxes in score order with their areas and indices, 24 bytes a box
    (K rounded up to 32); three bit words a 32 boxes (alive positions, the
    -1e10 tier, the compaction's prefix) stay in shared memory. The staged
    boxes join them in shared memory while both fit a block's 227 KB
    beside the kernel's static 1 KB (K <= 9,472); past that they sit in a
    scratch buffer of the wrapper's, one slice a problem."""
    kp = 32 * -(-k // 32)
    staged, bits = 24 * kp, 12 * (kp // 32)
    if staged + bits + _STATIC_SMEM <= SMEM_LIMIT:
        return NmsLayout("shared", staged + bits, 0)
    return NmsLayout("scratch", bits, staged)


def take_along(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (*batch, K, *rest), idx (*batch, M) -> (*batch, M, *rest)."""
    nb = idx.dim() - 1
    rest = x.shape[nb + 1:]
    ix = idx.reshape(*idx.shape, *([1] * len(rest))).expand(*idx.shape, *rest)
    return torch.gather(x, nb, ix)


def total_order_key(scores: torch.Tensor) -> torch.Tensor:
    """float32 `scores` as int32 keys that increase with the value in the
    total order of ``lax.top_k``: -0.0 below +0.0, NaN above +inf."""
    bits = scores.view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def _masked_scores(scores: torch.Tensor, valid) -> torch.Tensor:
    s = scores.float()
    return s if valid is None else s.masked_fill(~valid, _NEG)


def nms_padded_plain(boxes: torch.Tensor, scores: torch.Tensor,
                     iou_threshold, max_outputs: int,
                     valid: torch.Tensor | None = None,
                     score_threshold=_NEG / 2):
    """Greedy NMS over K padded boxes per batch entry, one selection a
    step (the plain form of `nms_padded`)."""
    s = _masked_scores(scores, valid)
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


def nms_padded_fast_plain(boxes: torch.Tensor, scores: torch.Tensor,
                          iou_threshold, max_outputs: int,
                          valid: torch.Tensor | None = None,
                          score_threshold=_NEG / 2, select_block: int = 16):
    """Greedy NMS with multi-selection (the plain form of
    `nms_padded_fast`): ``dtt``'s block loop, batched, each batch entry
    stepping until its own budget is full or its scores are spent."""
    s = _masked_scores(scores, valid)
    batch, k = s.shape[:-1], s.shape[-1]
    s = s.reshape(-1, k)
    bx = boxes.reshape(-1, k, 4)
    p = s.shape[0]
    m = min(select_block, max_outputs, k)
    # one column past the budget takes the slots that do not fit
    idx = torch.zeros((p, max_outputs + 1), dtype=torch.int64,
                      device=s.device)
    val = torch.zeros((p, max_outputs + 1), dtype=torch.bool,
                      device=s.device)
    count = torch.zeros((p,), dtype=torch.int64, device=s.device)
    while True:
        live = (count < max_outputs) & (s.max(dim=-1).values > score_threshold)
        if not bool(live.any()):
            break
        top_i = torch.sort(total_order_key(s), dim=-1, descending=True,
                           stable=True).indices[:, :m]
        top_s = torch.gather(s, -1, top_i)
        kb = take_along(bx, top_i)                         # (P, m, 4)
        over = box_ops.pairwise_iou(kb, kb) > iou_threshold
        ok = (top_s > score_threshold) & live[:, None]
        keep = torch.zeros_like(ok)
        for j in range(m):
            sup = (keep[:, :j] & over[:, :j, j]).any(-1)
            keep[:, j] = ok[:, j] & ~sup
        # budget: only the first (max_outputs - count) survivors fit
        pos = count[:, None] + keep.cumsum(-1) - keep.long()
        keep &= pos < max_outputs
        slot = torch.where(keep, pos, max_outputs)
        idx.scatter_(-1, slot, top_i)
        val.scatter_(-1, slot, keep)
        # suppress everything the committed boxes overlap (themselves too)
        sup_all = (keep[:, :, None]
                   & (box_ops.pairwise_iou(kb, bx) > iou_threshold)).any(1)
        s = s.masked_fill(sup_all, _NEG)
        # retire committed boxes even at iou_threshold >= 1
        s = s.scatter(-1, top_i, torch.where(keep, _NEG,
                                             torch.gather(s, -1, top_i)))
        count += keep.sum(-1)
    return (idx[:, :max_outputs].reshape(*batch, max_outputs),
            val[:, :max_outputs].reshape(*batch, max_outputs))


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("nms")
    fn = lib.dtt_nms_select
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 2
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.dtt_nms_max_boxes.restype = ctypes.c_int
    return fn, lib.dtt_nms_max_boxes()


def nms_cuda(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             max_outputs: int, valid: torch.Tensor | None = None,
             score_threshold: float = _NEG / 2, select_block: int = 16,
             return_steps: bool = False, total_order: bool = True):
    """Greedy NMS by the CUDA kernel ``dtt_nms_select``, one launch for
    every problem of the batch.

    boxes (..., K, 4) float32, scores (..., K) (compared as float32), valid
    (..., K) bool or None, on one CUDA device; the thresholds are numbers
    (compared as float32). Returns keep_idx (..., max_outputs) int64 and
    keep_valid (..., max_outputs) bool, and with `return_steps` the
    dependent steps each problem ran, (...,) int32. Launches on the current
    stream and never reads back to the host; counts its launches in
    ``nms_cuda.launches``. Past K = 9,472 boxes (`nms_layout`) it allocates
    a scratch buffer of 24 bytes a box a problem. Below a score_threshold
    of -1e10, where masked boxes are selected again, a step's width
    changes the decisions, and the kernel decides as ``dtt`` at
    min(select_block, 32). With `total_order` +0.0 ranks above -0.0, as in
    ``dtt``'s ``nms_padded_fast``; without it they tie and go by index, as
    in its ``nms_padded``.
    """
    if not boxes.is_cuda or scores.device != boxes.device or (
            valid is not None and valid.device != boxes.device):
        raise ValueError("nms_cuda: boxes, scores and valid must be on one "
                         "CUDA device")
    if boxes.dtype != torch.float32 or boxes.dim() < 2 or boxes.shape[-1] != 4:
        raise TypeError("nms_cuda: boxes must be (..., K, 4) float32, got "
                        f"{tuple(boxes.shape)} {boxes.dtype}")
    if scores.shape != boxes.shape[:-1] or not scores.is_floating_point():
        raise ValueError(f"nms_cuda: scores must be floating (..., K) = "
                         f"{tuple(boxes.shape[:-1])}, got "
                         f"{tuple(scores.shape)} {scores.dtype}")
    if valid is not None and (valid.shape != scores.shape
                              or valid.dtype != torch.bool):
        raise ValueError("nms_cuda: valid must be bool of the scores' shape, "
                         f"got {tuple(valid.shape)} {valid.dtype}")
    if any(isinstance(t, torch.Tensor)
           for t in (iou_threshold, score_threshold)):
        raise TypeError("nms_cuda: the thresholds must be numbers (a tensor "
                        "would be read back to the host)")
    if max_outputs < 1 or select_block < 1:
        raise ValueError(f"nms_cuda: max_outputs {max_outputs} and "
                         f"select_block {select_block} must be >= 1")
    batch, k = scores.shape[:-1], scores.shape[-1]
    fn, max_k = _entry()
    if k > max_k:
        raise ValueError(f"nms_cuda: {k} boxes a problem; the kernel takes at "
                         f"most {max_k}")
    p = math.prod(batch)
    dev = boxes.device
    keep_idx = torch.empty((*batch, max_outputs), dtype=torch.int64,
                           device=dev)
    keep_valid = torch.empty((*batch, max_outputs), dtype=torch.bool,
                             device=dev)
    steps = torch.empty(batch, dtype=torch.int32, device=dev)
    if p == 0 or k == 0:
        keep_idx.zero_()
        keep_valid.zero_()
        steps.zero_()
        return (keep_idx, keep_valid, steps) if return_steps else (
            keep_idx, keep_valid)
    if p >= 2 ** 31:
        raise ValueError(f"nms_cuda: {p} problems exceed the grid")
    bx = boxes.reshape(p, k, 4).contiguous()
    sc = scores.reshape(p, k).float().contiguous()
    va = None if valid is None else valid.reshape(p, k).contiguous()
    layout = nms_layout(k)
    scratch = (torch.empty(p * layout.scratch, dtype=torch.uint8, device=dev)
               if layout.scratch else None)
    err = fn(bx.data_ptr(), sc.data_ptr(),
             None if va is None else va.data_ptr(), keep_idx.data_ptr(),
             keep_valid.data_ptr(), steps.data_ptr(), p, k, max_outputs,
             select_block, float(iou_threshold), float(score_threshold),
             int(bool(total_order)), layout.smem, layout.scratch,
             None if scratch is None else scratch.data_ptr(), dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"nms kernel launch failed: cudaError {err}")
    nms_cuda.launches += 1
    return (keep_idx, keep_valid, steps) if return_steps else (
        keep_idx, keep_valid)


nms_cuda.launches = 0


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

    The plain form on CPU tensors; otherwise the kernel, at its widest step
    (the decisions do not depend on the width), or one box a step below a
    score_threshold of -1e10, where they do; +0.0 ties -0.0, as in
    ``dtt``'s ``argmax``.
    """
    if boxes.device.type == "cpu":
        return nms_padded_plain(boxes, scores, iou_threshold, max_outputs,
                                valid, score_threshold)
    score_threshold = float(score_threshold)      # the kernel's float32
    width = (1 if np.float32(score_threshold) < np.float32(_NEG)
             else KERNEL_BLOCK)
    return nms_cuda(boxes, scores, iou_threshold, max_outputs, valid,
                    score_threshold, width, total_order=False)


def nms_padded_fast(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold,
                    max_outputs: int, valid: torch.Tensor | None = None,
                    score_threshold=_NEG / 2, select_block: int = 16):
    """`nms_padded`'s decisions taking `select_block` candidates a step
    (``dtt``'s ``nms_padded_fast``), but with +0.0 ranked above -0.0 as
    ``lax.top_k`` ranks them: the plain block loop on CPU tensors,
    otherwise the kernel."""
    if boxes.device.type == "cpu":
        return nms_padded_fast_plain(boxes, scores, iou_threshold,
                                     max_outputs, valid, score_threshold,
                                     select_block)
    return nms_cuda(boxes, scores, iou_threshold, max_outputs, valid,
                    score_threshold, select_block)


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
                   per_class_boxes: bool = False, select_block: int = 16):
    """Per-class NMS for the eval path, batched over leading dims, by
    `nms_padded_fast`.

    Args:
      boxes: (..., K, 4) shared boxes, or (..., K, C, 4) per-class boxes if
        `per_class_boxes`.
      scores: (..., K, C) class scores (background already dropped).
      valid: optional (..., K) bool.
      select_block: candidates a step of the multi-select loop.

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
    idx, keep = nms_padded_fast(boxes_t, scores_t, iou_threshold,
                                max_per_class, valid_t, score_threshold,
                                select_block)
    kept_boxes = take_along(boxes_t, idx) * keep[..., None].to(boxes.dtype)
    kept_scores = torch.where(keep, torch.gather(scores_t, -1, idx),
                              torch.zeros((), dtype=scores.dtype,
                                          device=scores.device))
    return kept_boxes, kept_scores, keep, idx
