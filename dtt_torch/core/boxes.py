"""Box geometry on torch tensors, the counterpart of ``dtt.core.boxes``.

Boxes are ``(x1, y1, x2, y2)`` with the Caffe/py-faster-rcnn ``+1`` width
convention. Every function works on any leading batch shape.
"""

from __future__ import annotations

import functools

import torch

# Caffe lineage: width = x2 - x1 + 1.
_ONE = 1.0
# log(1000/16): clamp on dw/dh before exp, as modern detectors do
_DWDH_MAX = 4.135166556742356


@functools.lru_cache(maxsize=None)
def _const(values: tuple, device: torch.device) -> torch.Tensor:
    """A float32 constant on `device`, made once: building it anew on each
    call would copy from the host and wait for the device every time."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def constant(values, like: torch.Tensor) -> torch.Tensor:
    """`values` as a 1-d tensor of `like`'s dtype on its device."""
    return _const(tuple(float(v) for v in values), like.device).to(like.dtype)


def box_wh_ctr(boxes: torch.Tensor):
    """(..., 4) -> widths, heights, ctr_x, ctr_y with the +1 convention."""
    w = boxes[..., 2] - boxes[..., 0] + _ONE
    h = boxes[..., 3] - boxes[..., 1] + _ONE
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    return w, h, cx, cy


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    w = (boxes[..., 2] - boxes[..., 0] + _ONE).clamp(min=0.0)
    h = (boxes[..., 3] - boxes[..., 1] + _ONE).clamp(min=0.0)
    return w * h


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix between (..., N, 4) and (..., M, 4) -> (..., N, M)."""
    return elementwise_iou(a[..., :, None, :], b[..., None, :, :])


def elementwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between broadcastable (..., 4) box tensors -> (...,)."""
    ix = (torch.minimum(a[..., 2], b[..., 2])
          - torch.maximum(a[..., 0], b[..., 0]) + _ONE)
    iy = (torch.minimum(a[..., 3], b[..., 3])
          - torch.maximum(a[..., 1], b[..., 1]) + _ONE)
    inter = ix.clamp(min=0.0) * iy.clamp(min=0.0)
    union = box_area(a) + box_area(b) - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def encode_boxes(ex_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                 means=None, stds=None) -> torch.Tensor:
    """Boxes -> regression deltas (ref bbox_transform), optionally
    normalized by (means, stds)."""
    ew, eh, ecx, ecy = box_wh_ctr(ex_boxes)
    gw, gh, gcx, gcy = box_wh_ctr(gt_boxes)
    ew = ew.clamp(min=1e-6)
    eh = eh.clamp(min=1e-6)
    deltas = torch.stack(
        [(gcx - ecx) / ew,
         (gcy - ecy) / eh,
         torch.log(gw.clamp(min=1e-6) / ew),
         torch.log(gh.clamp(min=1e-6) / eh)],
        dim=-1,
    )
    if means is not None:
        deltas = deltas - constant(means, deltas)
    if stds is not None:
        deltas = deltas / constant(stds, deltas)
    return deltas


def decode_boxes(boxes: torch.Tensor, deltas: torch.Tensor,
                 means=None, stds=None) -> torch.Tensor:
    """Regression deltas -> boxes (ref bbox_transform_inv).

    `deltas` may carry several 4-vectors per box in its last dim:
    (..., N, 4*K) against boxes (..., N, 4) -> (..., N, 4*K).
    """
    shape = deltas.shape
    d = deltas.reshape(*shape[:-1], -1, 4)
    if stds is not None:
        d = d * constant(stds, deltas)
    if means is not None:
        d = d + constant(means, deltas)
    w, h, cx, cy = box_wh_ctr(boxes)
    dw = d[..., 2].clamp(max=_DWDH_MAX)
    dh = d[..., 3].clamp(max=_DWDH_MAX)
    pcx = d[..., 0] * w[..., None] + cx[..., None]
    pcy = d[..., 1] * h[..., None] + cy[..., None]
    pw = torch.exp(dw) * w[..., None]
    ph = torch.exp(dh) * h[..., None]
    # "- 1" on x2/y2: decode is the exact inverse of encode under the +1
    # width convention, so zero deltas are the identity
    out = torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                       pcx + 0.5 * pw - _ONE, pcy + 0.5 * ph - _ONE], dim=-1)
    return out.reshape(shape)


def clip_boxes(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clip to the image extent [0, W-1] x [0, H-1] (ref clip_boxes).

    `height`/`width` are Python numbers or tensors on the boxes' device
    that broadcast against ``boxes.shape[:-1]`` (e.g. (B, 1) per-frame
    sizes for (B, N, 4) boxes). Supports (..., 4) and (..., 4*K) layouts.
    """
    shape = boxes.shape
    b = boxes.reshape(*shape[:-1], -1, 4)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    xmax = torch.as_tensor(width, dtype=boxes.dtype, device=boxes.device) - _ONE
    ymax = torch.as_tensor(height, dtype=boxes.dtype, device=boxes.device) - _ONE
    xmax, ymax = torch.broadcast_tensors(xmax, ymax)
    lim = torch.stack([xmax, ymax, xmax, ymax], dim=-1)[..., None, :]
    return torch.minimum(torch.maximum(b, zero), lim).reshape(shape)


def flip_boxes(boxes: torch.Tensor, width) -> torch.Tensor:
    """Horizontal flip in an image `width` pixels wide (the roidb
    'flipped' augmentation): x1' = W - 1 - x2, x2' = W - 1 - x1."""
    x1 = width - _ONE - boxes[..., 2]
    x2 = width - _ONE - boxes[..., 0]
    return torch.stack([x1, boxes[..., 1], x2, boxes[..., 3]], dim=-1)
