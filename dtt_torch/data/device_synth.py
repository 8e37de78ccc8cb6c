"""Synthetic canvases drawn on the card (counterpart of
``dtt.data.device_synth``).

A synthetic pair is described by a few KB of object parameters
(``dtt_torch.data.synthetic.sample_params_batch``), so the device-render
training path uploads those and draws the uint8 canvases where the step
runs: a background of uniform integers in [23, 37] from an explicit
``torch.Generator`` (the host generator's distribution), then each valid
object in slot order, its box rounded half to even and clamped to the
canvas, degenerate boxes skipped, textured by ``synthetic.object_texture``.

The texture of class c at pixel (y, x) depends on c and y + x only; it is
read from a table that the host computes once per canvas size with that
formula, clipped and rounded as the host renderer does, so a canvas drawn
here equals the host renderer's pixel for pixel on the same background.
Class ids must lie in [0, MAX_CLASSES). This is plain PyTorch: ``dtt``
draws with ``jnp`` and has no Pallas kernel here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dtt_torch.core.device import resolve_device
from dtt_torch.data.synthetic import object_texture

MAX_CLASSES = 256


@functools.lru_cache(maxsize=None)
def texture_table(span: int, device: torch.device) -> torch.Tensor:
    """(MAX_CLASSES, span, 3) uint8 on `device`: class c's texture at
    y + x = s, ``clip(round(object_texture(c, y, x)), 0, 255)``."""
    s = np.arange(span, dtype=np.float32)[None, :]
    zero = np.zeros((1, 1), np.float32)
    table = np.stack([np.clip(np.round(object_texture(c, zero, s)[0]), 0, 255)
                      for c in range(MAX_CLASSES)]).astype(np.uint8)
    return torch.from_numpy(table).to(device)


def _check_labels(labels: torch.Tensor) -> None:
    if labels.device.type == "cpu" and labels.numel() and (
            int(labels.min()) < 0 or int(labels.max()) >= MAX_CLASSES):
        raise ValueError(f"class ids must lie in [0, {MAX_CLASSES})")


def draw_objects(boxes: torch.Tensor, labels: torch.Tensor,
                 valid: torch.Tensor, canvas: torch.Tensor) -> torch.Tensor:
    """Objects drawn onto (N, H, W, 3) uint8 canvases, on their device:
    (N, G, 4) boxes, (N, G) class ids, (N, G) valid. Returns new canvases;
    a pixel takes the texture of the last valid slot whose box covers it
    (later slots overwrite earlier ones)."""
    _check_labels(labels)
    n, h, w = canvas.shape[:3]
    dev = canvas.device
    b = torch.round(boxes.float())                  # half to even
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
    tex = texture_table(h + w - 1, dev)[cls, diag]
    return torch.where((winner >= 0)[..., None], tex, canvas)


def render_frame(boxes: torch.Tensor, labels: torch.Tensor,
                 valid: torch.Tensor, background: torch.Tensor
                 ) -> torch.Tensor:
    """One uint8 canvas: (G, 4) boxes, (G,) class ids and (G,) valid drawn
    onto the (H, W, 3) uint8 `background`, on its device."""
    return draw_objects(boxes[None], labels[None], valid[None],
                        background[None])[0]


def pair_background(generator: torch.Generator, batch: int, height: int,
                    width: int, device) -> torch.Tensor:
    """(batch, 2, H, W, 3) uint8 backgrounds, uniform integers in [23, 37]
    drawn from `generator` (on `device`)."""
    return torch.randint(23, 38, (batch, 2, height, width, 3),
                         generator=generator, device=device,
                         dtype=torch.uint8)


def render_pairs(gt_boxes, gt_labels, gt_valid, generator: torch.Generator,
                 height: int, width: int, device=None) -> torch.Tensor:
    """uint8 canvases (B, 2, H, W, 3) of a batch of frame pairs on
    `device` (CUDA unless the caller passes "cpu"; raises without a GPU):
    gt_boxes (B, 2, G, 4), gt_labels (B, G) shared by the pair, gt_valid
    (B, 2, G), as arrays or tensors; the backgrounds from `generator`."""
    device = resolve_device(device)
    boxes, labels, valid = (torch.as_tensor(x).to(device)
                            for x in (gt_boxes, gt_labels, gt_valid))
    b, _, g = valid.shape
    background = pair_background(generator, b, height, width, device)
    labels2 = labels[:, None, :].expand(b, 2, g)
    return draw_objects(boxes.reshape(b * 2, g, 4), labels2.reshape(b * 2, g),
                        valid.reshape(b * 2, g),
                        background.view(b * 2, height, width, 3)
                        ).view(b, 2, height, width, 3)


def make_pair_render_fn(height: int, width: int, device=None):
    """``render(batch, generator) -> images`` for
    ``make_train_step(render_fn=...)``, drawing on `device` (CUDA unless
    the caller passes "cpu"; raises without a GPU)."""
    device = resolve_device(device)

    def render(batch: dict, generator: torch.Generator) -> torch.Tensor:
        return render_pairs(batch["gt_boxes"], batch["gt_labels"],
                            batch["gt_valid"], generator, height, width,
                            device)

    return render
