"""Box geometry and anchors of the plain reference.

Boxes are (x1, y1, x2, y2) with the Caffe "+1" width convention, as the
D&T paper's code (py-faster-rcnn lineage) has them. Written from that
convention alone; nothing here is imported from the program.
"""

from __future__ import annotations

import numpy as np
import torch

DWDH_MAX = float(np.log(1000.0 / 16.0))   # clamp on dw, dh before exp


def base_anchors(base_size: int, ratios, scales) -> np.ndarray:
    """(A, 4) anchors of one cell: py-faster-rcnn's generate_anchors
    (ratio-major, then scale), in float64 and rounded as it rounds."""
    def whctr(a):
        w, h = a[2] - a[0] + 1.0, a[3] - a[1] + 1.0
        return w, h, a[0] + 0.5 * (w - 1.0), a[1] + 0.5 * (h - 1.0)

    def mk(ws, hs, cx, cy):
        ws, hs = ws[:, None], hs[:, None]
        return np.hstack([cx - 0.5 * (ws - 1.0), cy - 0.5 * (hs - 1.0),
                          cx + 0.5 * (ws - 1.0), cy + 0.5 * (hs - 1.0)])

    base = np.array([0, 0, base_size - 1, base_size - 1], np.float64)
    w, h, cx, cy = whctr(base)
    ws = np.round(np.sqrt(w * h / np.asarray(ratios, np.float64)))
    hs = np.round(ws * np.asarray(ratios, np.float64))
    out = []
    for a in mk(ws, hs, cx, cy):
        w, h, cx, cy = whctr(a)
        s = np.asarray(scales, np.float64)
        out.append(mk(w * s, h * s, cx, cy))
    return np.vstack(out).astype(np.float32)


def grid_anchors(anchor_cfg: dict, height: int, width: int) -> np.ndarray:
    """All anchors of an H x W map, rows ordered (y, x, a)."""
    base = base_anchors(anchor_cfg["base_size"], anchor_cfg["ratios"],
                        anchor_cfg["scales"])
    stride = anchor_cfg["feat_stride"]
    sx, sy = np.meshgrid(np.arange(width, dtype=np.float32) * stride,
                         np.arange(height, dtype=np.float32) * stride)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    return np.ascontiguousarray((shifts + base[None]).reshape(-1, 4))


def decode(boxes: torch.Tensor, deltas: torch.Tensor, stds=None
           ) -> torch.Tensor:
    """Regression deltas (..., 4) -> boxes; x2, y2 carry the -1 so that
    zero deltas give the box back."""
    d = deltas
    if stds is not None:
        d = d * torch.tensor(stds, dtype=d.dtype, device=d.device)
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx, cy = boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h
    pcx, pcy = d[..., 0] * w + cx, d[..., 1] * h + cy
    pw = torch.exp(d[..., 2].clamp(max=DWDH_MAX)) * w
    ph = torch.exp(d[..., 3].clamp(max=DWDH_MAX)) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw - 1.0, pcy + 0.5 * ph - 1.0], dim=-1)


def clip(boxes: torch.Tensor, height: float, width: float) -> torch.Tensor:
    lim = torch.tensor([width - 1.0, height - 1.0, width - 1.0,
                        height - 1.0], dtype=boxes.dtype, device=boxes.device)
    return torch.minimum(boxes.clamp(min=0.0), lim)


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of broadcastable (..., 4) boxes."""
    ix = (torch.minimum(a[..., 2], b[..., 2])
          - torch.maximum(a[..., 0], b[..., 0]) + 1.0).clamp(min=0.0)
    iy = (torch.minimum(a[..., 3], b[..., 3])
          - torch.maximum(a[..., 1], b[..., 1]) + 1.0).clamp(min=0.0)
    area = lambda x: ((x[..., 2] - x[..., 0] + 1.0).clamp(min=0.0)
                      * (x[..., 3] - x[..., 1] + 1.0).clamp(min=0.0))
    inter = ix * iy
    union = area(a) + area(b) - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4), (..., M, 4) -> (..., N, M)."""
    return iou(a[..., :, None, :], b[..., None, :, :])


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, thresh: float,
               limit: int, floor: float) -> list:
    """Indices kept by greedy NMS, at most `limit`: boxes in order of
    descending score (ties: lower index first), a box kept unless a kept
    box overlaps it by IoU > `thresh`; scores <= `floor` never kept."""
    order = torch.sort(scores, descending=True, stable=True).indices
    order = order[scores[order] > floor]
    b = boxes[order]
    alive = torch.ones(len(order), dtype=torch.bool, device=boxes.device)
    keep = []
    i = 0
    n = len(order)
    alive_host = alive.cpu().numpy()
    while i < n and len(keep) < limit:
        if not alive_host[i]:
            i += 1
            continue
        keep.append(int(order[i]))
        over = (iou(b[i], b[i + 1:]) > thresh).cpu().numpy()
        alive_host[i + 1:] &= ~over
        i += 1
    return keep
