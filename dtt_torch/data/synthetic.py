"""Synthetic mini-VID (a copy of ``dtt.data.synthetic``'s samplers and
renderer, so the port loads without JAX).

Moving class-coded rectangles with track identities on uint8 canvases:
``sample_pair_params`` draws a pair's scene, ``render_frame`` draws it,
``synthetic_batch`` stacks pairs into the batch dict the train step
takes and ``sample_params_batch`` stacks scenes without pixels;
``sample_snippet_params`` and ``synthetic_snippet`` make the
constant-velocity snippets evaluation runs on. The same numpy seed gives
arrays equal to ``dtt``'s.
"""

from __future__ import annotations

import numpy as np


def _background(rng: np.random.RandomState, shape) -> np.ndarray:
    """uint8-native background, uniform integers in [23, 37] (~mean 30):
    no full-canvas float pass on the generator's critical path."""
    return _background_of(rng.randint(1 << 31), shape)


def _background_of(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(23, 38, shape, dtype=np.uint8)


def object_texture(cls: int, yy: np.ndarray, xx: np.ndarray) -> np.ndarray:
    """Class-coded texture patch (float, pre-clip) at absolute canvas coords.

    Each class id maps to base-4 digits (d0, d1, d2) = (cls%4, cls//4%4,
    cls//16%4) and each channel carries level 40+70*digit: any two classes
    differ by >=70 on some channel, > 2x the stripe amplitude (20) plus
    quantization — so downscaling can never collapse two classes onto the
    same appearance. (The round-2 code packed 30 classes into a lattice
    where pairs like 5<->20 and 17<->2 differed by only 30 on ONE channel;
    both scored a persistent AP 0.0 in the flagship run — appearance
    collision, i.e. label noise, not a property of the model graph.)
    A diagonal stripe of period 4+cls keeps per-class high-frequency
    texture. Shared formula with the device renderer
    (dtt/data/device_synth.py), parity-tested.
    """
    base = np.empty((*np.broadcast_shapes(yy.shape, xx.shape), 3), np.float32)
    base[..., 0] = 40.0 + 70.0 * (cls % 4)
    base[..., 1] = 40.0 + 70.0 * ((cls // 4) % 4)
    base[..., 2] = 40.0 + 70.0 * ((cls // 16) % 4)
    stripe = 20.0 * np.sin(2 * np.pi * (yy + xx) / max(4 + cls, 4))
    return base + stripe[..., None].astype(np.float32)


def _draw_object(img: np.ndarray, box, cls: int):
    """Draw one object onto a uint8 canvas (round->clamp box, clip texture)."""
    x1, y1, x2, y2 = [int(round(float(v))) for v in box]
    h, w = img.shape[:2]
    x1, y1 = max(x1, 0), max(y1, 0)
    x2, y2 = min(x2, w - 1), min(y2, h - 1)
    if x2 <= x1 or y2 <= y1:
        return
    yy = np.arange(y1, y2 + 1, dtype=np.float32)[:, None]
    xx = np.arange(x1, x2 + 1, dtype=np.float32)[None, :]
    patch = object_texture(cls, yy, xx)
    img[y1:y2 + 1, x1:x2 + 1] = np.clip(np.round(patch), 0, 255)


def render_frame(canvas: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                 valid: np.ndarray) -> np.ndarray:
    """Draw valid objects in slot order onto a uint8 canvas (in place)."""
    assert canvas.dtype == np.uint8
    for g in range(boxes.shape[0]):
        if valid[g]:
            _draw_object(canvas, boxes[g], int(labels[g]))
    return canvas


def _num_objects(rng, num_objects, cap: int) -> int:
    if num_objects is None:
        num_objects = (1, 3)
    if isinstance(num_objects, (tuple, list)):
        lo, hi = num_objects
        return min(rng.randint(lo, hi + 1), cap)
    return min(int(num_objects), cap)


def sample_pair_params(rng: np.random.RandomState, height: int, width: int,
                       num_classes: int, max_gt: int,
                       num_objects=None, max_shift: float = 12.0) -> dict:
    """Scene parameters for one frame pair (no pixels): gt_boxes (2, G, 4)
    track-aligned, gt_labels (G,), gt_valid (2, G), im_scale, im_size.
    `num_objects`: int, (lo, hi) range, or None for the (1, 3) default."""
    g = max_gt
    n = _num_objects(rng, num_objects, g)
    gt_boxes = np.zeros((2, g, 4), np.float32)
    gt_valid = np.zeros((2, g), bool)
    gt_labels = np.zeros((g,), np.int32)
    for i in range(n):
        bw = rng.uniform(width * 0.15, width * 0.45)
        bh = rng.uniform(height * 0.15, height * 0.45)
        x1 = rng.uniform(0, width - bw - max_shift - 1)
        y1 = rng.uniform(0, height - bh - max_shift - 1)
        cls = rng.randint(1, num_classes)
        dx = rng.uniform(-max_shift, max_shift)
        dy = rng.uniform(-max_shift, max_shift)
        box_t = np.array([x1, y1, x1 + bw, y1 + bh], np.float32)
        box_tau = np.clip(box_t + np.array([dx, dy, dx, dy], np.float32),
                          0, [width - 1, height - 1, width - 1, height - 1])
        gt_boxes[0, i] = box_t
        gt_boxes[1, i] = box_tau
        gt_labels[i] = cls
        gt_valid[:, i] = True
    return {
        "gt_boxes": gt_boxes,
        "gt_labels": gt_labels,
        "gt_valid": gt_valid,
        "im_scale": np.float32(1.0),
        "im_size": np.array([height, width], np.float32),
    }


def synthetic_pair(rng: np.random.RandomState, height: int, width: int,
                   num_classes: int, max_gt: int, num_objects=None,
                   max_shift: float = 12.0, uint8: bool = False):
    """One frame pair with translated objects.

    Returns dict:
      images: (2, H, W, 3) uint8 canvas if `uint8`, else its exact float32 cast
      gt_boxes: (2, G, 4) track-aligned
      gt_labels: (G,) class ids in [1, num_classes-1]
      gt_valid: (2, G) bool
      im_scale: () float32
    """
    params = sample_pair_params(rng, height, width, num_classes, max_gt,
                                num_objects, max_shift)
    return _render_pair(params, rng.randint(1 << 31), height, width, uint8)


def _render_pair(params: dict, seed: int, height: int, width: int,
                 uint8: bool) -> dict:
    """`synthetic_pair`'s pixels: the scene `params` drawn on the
    background of `seed`."""
    images = _background_of(seed, (2, height, width, 3))
    for f in range(2):
        render_frame(images[f], params["gt_boxes"][f], params["gt_labels"],
                     params["gt_valid"][f])
    if not uint8:
        images = images.astype(np.float32)
    return {"images": images, **params}


def synthetic_batch(rng: np.random.RandomState, batch: int, height: int,
                    width: int, num_classes: int, max_gt: int,
                    pixel_means=(102.98, 115.95, 122.77), uint8: bool = False,
                    num_objects=None, rows: slice | None = None):
    """Stacked batch dict for the train step.

    uint8=True ships the quantized un-normalized canvases natively — 4x
    fewer H2D bytes; the train step normalizes on device
    (normalize_device_images). Default emits host-mean-subtracted float32
    of the SAME canvases (the reference semantics).

    With `rows` (a data-parallel rank's share) every pair's scene is
    drawn, so `rng` moves as for the whole batch, but only those pairs
    are rendered and returned: the same rows of the whole batch.
    """
    scenes = [(sample_pair_params(rng, height, width, num_classes, max_gt,
                                  num_objects), rng.randint(1 << 31))
              for _ in range(batch)]
    samples = [_render_pair(params, seed, height, width, uint8)
               for params, seed in (scenes if rows is None else scenes[rows])]
    out = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    if not uint8:
        out["images"] = out["images"] - np.asarray(pixel_means, np.float32)
    return out


def sample_params_batch(rng: np.random.RandomState, batch: int, height: int,
                        width: int, num_classes: int, max_gt: int,
                        num_objects=None) -> dict:
    """Stacked scene parameters of `batch` pairs, without pixels (KB
    instead of MB): the device-render training path uploads these and
    draws the canvases on the card (``dtt_torch.data.device_synth``)."""
    samples = [sample_pair_params(rng, height, width, num_classes, max_gt,
                                  num_objects=num_objects)
               for _ in range(batch)]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def sample_snippet_params(rng: np.random.RandomState, num_frames: int,
                          height: int, width: int, num_classes: int,
                          max_gt: int, num_objects: int = 2,
                          max_step: float = 6.0):
    """Constant-velocity snippet scene: gt_boxes (T, G, 4), gt_labels (G,),
    gt_valid (T, G)."""
    g = max_gt
    n = min(num_objects, g)
    gt_boxes = np.zeros((num_frames, g, 4), np.float32)
    gt_valid = np.zeros((num_frames, g), bool)
    gt_labels = np.zeros((g,), np.int32)
    for i in range(n):
        bw = rng.uniform(width * 0.15, width * 0.35)
        bh = rng.uniform(height * 0.15, height * 0.35)
        x1 = rng.uniform(max_step * num_frames,
                         width - bw - max_step * num_frames - 1)
        y1 = rng.uniform(max_step * num_frames,
                         height - bh - max_step * num_frames - 1)
        vx = rng.uniform(-max_step, max_step)
        vy = rng.uniform(-max_step, max_step)
        cls = rng.randint(1, num_classes)
        gt_labels[i] = cls
        for t in range(num_frames):
            box = np.array([x1 + vx * t, y1 + vy * t,
                            x1 + bw + vx * t, y1 + bh + vy * t], np.float32)
            box = np.clip(box, 0, [width - 1, height - 1, width - 1, height - 1])
            gt_boxes[t, i] = box
            gt_valid[t, i] = True
    return gt_boxes, gt_labels, gt_valid


def synthetic_snippet(rng: np.random.RandomState, num_frames: int, height: int,
                      width: int, num_classes: int, max_gt: int,
                      num_objects: int = 2, max_step: float = 6.0,
                      uint8: bool = False):
    """A T-frame snippet with constant-velocity objects (for linking tests).

    Returns images (T, H, W, 3) — the uint8 canvases when `uint8`, else
    their exact float32 cast (same pixel distribution as training either
    way) — plus gt_boxes (T, G, 4), gt_labels (G,), gt_valid (T, G).
    """
    gt_boxes, gt_labels, gt_valid = sample_snippet_params(
        rng, num_frames, height, width, num_classes, max_gt, num_objects,
        max_step)
    images = _background(rng, (num_frames, height, width, 3))
    for t in range(num_frames):
        render_frame(images[t], gt_boxes[t], gt_labels, gt_valid[t])
    if not uint8:
        images = images.astype(np.float32)
    return images, gt_boxes, gt_labels, gt_valid
