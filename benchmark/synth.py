"""Synthetic scenes drawn on the device: the benchmark's frozen copy of
the program's renderer.

``object_texture``, ``texture_table`` and ``draw_objects`` are copied from
``dtt_torch/data/synthetic.py`` and ``dtt_torch/data/device_synth.py`` at
commit 8f1f229, so that a later change to the program cannot move the
traffic. ``scene_frames`` is the benchmark's own: a scene of moving
class-textured boxes, drawn a block of frames at a time on the device.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_CLASSES = 256


def object_texture(cls: int, yy: np.ndarray, xx: np.ndarray) -> np.ndarray:
    """Class-coded texture (float, before clipping) at canvas coordinates:
    a level of 40 + 70 * digit per channel from cls's base-4 digits, and a
    diagonal stripe of period 4 + cls."""
    base = np.empty((*np.broadcast_shapes(yy.shape, xx.shape), 3), np.float32)
    base[..., 0] = 40.0 + 70.0 * (cls % 4)
    base[..., 1] = 40.0 + 70.0 * ((cls // 4) % 4)
    base[..., 2] = 40.0 + 70.0 * ((cls // 16) % 4)
    stripe = 20.0 * np.sin(2 * np.pi * (yy + xx) / max(4 + cls, 4))
    return base + stripe[..., None].astype(np.float32)


def texture_table(span: int, device) -> torch.Tensor:
    """(MAX_CLASSES, span, 3) uint8: class c's texture at y + x = s."""
    s = np.arange(span, dtype=np.float32)[None, :]
    zero = np.zeros((1, 1), np.float32)
    table = np.stack([np.clip(np.round(object_texture(c, zero, s)[0]), 0, 255)
                      for c in range(MAX_CLASSES)]).astype(np.uint8)
    return torch.from_numpy(table).to(device)


def draw_objects(boxes: torch.Tensor, labels: torch.Tensor,
                 valid: torch.Tensor, canvas: torch.Tensor,
                 table: torch.Tensor) -> torch.Tensor:
    """Objects drawn onto (N, H, W, 3) uint8 canvases: (N, G, 4) boxes,
    (N, G) class ids, (N, G) valid; a pixel takes the texture of the last
    valid slot whose rounded, clamped box covers it."""
    n, h, w = canvas.shape[:3]
    dev = canvas.device
    b = torch.round(boxes.float())
    x1, y1 = b[..., 0].clamp(min=0.0), b[..., 1].clamp(min=0.0)
    x2, y2 = b[..., 2].clamp(max=w - 1.0), b[..., 3].clamp(max=h - 1.0)
    drawn = valid.bool() & (x2 > x1) & (y2 > y1)
    ys = torch.arange(h, device=dev, dtype=torch.float32)
    xs = torch.arange(w, device=dev, dtype=torch.float32)
    rows = (ys >= y1[..., None]) & (ys <= y2[..., None]) & drawn[..., None]
    cols = (xs >= x1[..., None]) & (xs <= x2[..., None])
    winner = torch.full((n, h, w), -1, dtype=torch.int64, device=dev)
    for g in range(boxes.shape[1]):
        winner = torch.where(rows[:, g, :, None] & cols[:, g, None, :], g,
                             winner)
    cls = labels.long().gather(1, winner.clamp(min=0).view(n, -1)).view(n, h, w)
    diag = (torch.arange(h, device=dev)[:, None]
            + torch.arange(w, device=dev)[None, :])
    tex = table[cls, diag]
    return torch.where((winner >= 0)[..., None], tex, canvas)


def scene_frames(n: int, height: int, width: int, extent: tuple,
                 objects: int, size: tuple, speed: float, classes: int,
                 gen: torch.Generator, device, block: int = 32
                 ) -> np.ndarray:
    """(n, H, W, 3) uint8 frames of one scene on host memory: `objects`
    boxes of classes in [1, classes) and sides in `size` pixels, each
    moving at up to `speed` pixels a frame and bouncing off the true
    (h, w) `extent`, over a background of uniform integers in [23, 37];
    drawn `block` frames at a time on the device."""
    eh, ew = extent
    r = lambda *shape: torch.rand(*shape, generator=gen, device=device)
    side = size[0] + (size[1] - size[0]) * r(objects, 2)
    start = r(objects, 2) * (torch.tensor([ew, eh], device=device) - side)
    vel = (2 * r(objects, 2) - 1) * speed
    labels = 1 + (r(objects) * (classes - 1)).long().clamp(max=classes - 2)
    table = texture_table(height + width - 1, device)
    room = torch.tensor([ew, eh], device=device) - side
    out = np.empty((n, height, width, 3), np.uint8)
    for i in range(0, n, block):
        t = torch.arange(i, min(i + block, n), device=device,
                         dtype=torch.float32)
        # bounce: a triangle wave over [0, room]
        pos = start + vel * t[:, None, None]
        pos = room - (pos.remainder(2 * room) - room).abs()
        boxes = torch.cat([pos, pos + side - 1], dim=-1)
        m = len(t)
        bg = torch.randint(23, 38, (m, height, width, 3), generator=gen,
                           device=device, dtype=torch.uint8)
        frames = draw_objects(boxes, labels.expand(m, objects),
                              torch.ones(m, objects, dtype=torch.bool,
                                         device=device), bg, table)
        out[i:i + m] = frames.cpu().numpy()
    return out
