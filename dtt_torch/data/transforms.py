"""Host-side image transforms (counterpart of ``dtt.data.transforms``).

The reference's blob pipeline (lib/roi_data_layer/minibatch.py +
lib/model/utils/blob.py): BGR pixel order, Caffe pixel-mean subtraction,
shorter side to 600 capped by the canvas, placed top-left on one fixed
canvas that is exactly 0 beyond the image (after the mean subtraction).

A frame decodes by one of two routes, chosen in the open by
``frame_route`` and announced once per route on stderr:

* ``native``: JPEG files, where the port's C++ pipeline builds
  (``dtt_torch.data.native``: DCT-scaled libjpeg decode and the resize,
  flip and mean in one pass; the same bits as ``dtt``'s);
* ``pil``: any file PIL reads, where PIL is importable; the decoded image
  goes through ``resize_to_canvas``, which resizes as
  ``cv2.resize(..., INTER_LINEAR)`` does on float32.

Neither available is an error naming the file and what is missing; a
route never falls back to the other.
"""

from __future__ import annotations

import functools
import os
import sys

import numpy as np
import torch

from dtt_torch.core.boxes import flip_boxes
from dtt_torch.core.config import InputConfig
from dtt_torch.data import native

_JPEG = (".jpeg", ".jpg")


def _pil():
    """PIL.Image, or None where PIL is not importable."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def frame_route(path: str) -> str:
    """How `path` decodes: "native" for a JPEG where the native library
    builds, else "pil" where PIL imports. Raises RuntimeError naming the
    file and what is missing when neither can."""
    is_jpeg = path.lower().endswith(_JPEG)
    if is_jpeg and native.available():
        return "native"
    if _pil() is not None:
        return "pil"
    missing = ("the native JPEG library did not build ("
               f"{native.unavailable_reason()}) and " if is_jpeg else "")
    raise RuntimeError(f"cannot decode {path}: {missing}PIL is not "
                       "importable")


@functools.lru_cache(maxsize=None)
def _announce(route: str, ext: str) -> None:
    why = ("" if route == "native" or ext not in _JPEG
           else f" (native: {native.unavailable_reason()})")
    print(f"dtt_torch.data: {ext} frames decode by {route}{why}",
          file=sys.stderr, flush=True)


def _read_bgr_u8(path: str) -> np.ndarray:
    """uint8 BGR HWC image read by PIL."""
    image = _pil()
    if image is None:
        raise RuntimeError(f"cannot decode {path}: PIL is not importable")
    with image.open(path) as im:
        return np.asarray(im.convert("RGB"))[:, :, ::-1]


def load_image_bgr(path: str) -> np.ndarray:
    """Read an image as float32 BGR HWC (by PIL)."""
    return _read_bgr_u8(path).astype(np.float32)


def canvas_scale(h: int, w: int, cfg: InputConfig) -> float:
    """Resize scale for an (h, w) image: shorter side to the target,
    capped so the image also fits the canvas (the reference's MAX_SIZE
    rule). A function of the dimensions only: streaming evaluation reads
    them from the annotation and decodes nothing."""
    scale = cfg.target_short_side / min(h, w)
    return min(scale, cfg.canvas_height / h, cfg.canvas_width / w)


def _linear_taps(src: int, dst: int):
    """cv2's INTER_LINEAR coordinate map for one axis: the half-pixel
    centre (i + 0.5) * src/dst - 0.5, split into a floor index and its
    fraction (rounded once to float32), clamped to the first and last
    source pixel with the fraction 0 there. Returns (lo, hi, fraction)."""
    step = 1.0 / (dst / src)               # cv2: scale = 1 / (dsize / ssize)
    f = (np.arange(dst) + 0.5) * step - 0.5
    lo = np.floor(f).astype(np.int64)
    frac = (f - lo).astype(np.float32)
    frac[(lo < 0) | (lo >= src - 1)] = 0.0
    lo = np.clip(lo, 0, src - 1)
    return lo, np.minimum(lo + 1, src - 1), frac


def _lerp(p: np.ndarray, q: np.ndarray, frac: np.ndarray) -> np.ndarray:
    """float32 p + (q - p) * frac with the difference rounded to float32
    and the multiply-add rounded once, as cv2's float INTER_LINEAR step
    (a fused multiply-add) computes it: here in float64, where the product
    of two float32 values is exact."""
    d = (q.astype(np.float32) - p).astype(np.float64)
    d *= frac
    d += p
    return d.astype(np.float32)


def _resize_bilinear(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """(h, w, 3) uint8 or float32 -> (nh, nw, 3) float32, bilinear as
    ``cv2.resize(img.astype(float32), (nw, nh), INTER_LINEAR)``: the
    horizontal taps first, then the vertical."""
    h, w = img.shape[:2]
    x0, x1, fx = _linear_taps(w, nw)
    y0, y1, fy = _linear_taps(h, nh)
    horiz = _lerp(np.take(img, x0, axis=1), np.take(img, x1, axis=1),
                  fx[None, :, None])
    return _lerp(horiz[y0], horiz[y1], fy[:, None, None])


def resize_to_canvas(img: np.ndarray, cfg: InputConfig, normalize: bool = True
                     ) -> tuple[np.ndarray, float]:
    """Shorter-side resize, mean subtraction, placed top-left on a zero
    canvas. Returns (float32 canvas (H, W, 3), scale).

    The padding stays exactly 0 after the mean subtraction, as the
    reference pads its blobs with zeros after normalizing."""
    h, w = img.shape[:2]
    scale = canvas_scale(h, w, cfg)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = _resize_bilinear(img, nh, nw)
    if normalize:
        resized -= np.asarray(cfg.pixel_means, np.float32)
    canvas = np.zeros((cfg.canvas_height, cfg.canvas_width, 3), np.float32)
    canvas[:nh, :nw] = resized
    return canvas, float(scale)


def normalize(img: np.ndarray, cfg: InputConfig) -> np.ndarray:
    return img - np.asarray(cfg.pixel_means, np.float32)


def flip_image_and_boxes(img: np.ndarray, boxes: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Horizontal flip of an image and its (N, 4) boxes (the roidb
    'flipped' augmentation)."""
    out = img[:, ::-1].copy()
    if boxes.size:
        boxes = flip_boxes(torch.from_numpy(np.ascontiguousarray(boxes)),
                           img.shape[1]).numpy()
    return out, boxes


def prepare_frame(path: str, cfg: InputConfig, flip: bool = False
                  ) -> tuple[np.ndarray, float]:
    """One frame -> (normalized float32 canvas, scale), by the route
    ``frame_route`` names, mirrored first when `flip`. A file the route
    cannot decode raises."""
    route = frame_route(path)
    _announce(route, os.path.splitext(path)[1].lower())
    if route == "native":
        with open(path, "rb") as f:
            data = f.read()
        try:
            return native.decode_resize_normalize(data, cfg, flip)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    img = _read_bgr_u8(path)
    if flip:
        img = img[:, ::-1]
    return resize_to_canvas(img, cfg)


def prepare_pair(entry: dict, cfg: InputConfig) -> dict:
    """roidb entry -> one train sample in the track-aligned layout.

    Returns images (2, H, W, 3) normalized float32; gt_boxes (2, G, 4),
    slot g the same trackid in both frames; gt_labels (G,); gt_valid
    (2, G); im_scale (); im_size (2,), the true (h, w) extent on the canvas
    (anchors beyond it are padding, not background)."""
    g_max = cfg.max_gt_boxes
    raw_annots = entry["annots"]
    flipped = bool(entry.get("flipped"))

    tids: list[int] = []                 # track-aligned slots by trackid
    for ann in raw_annots:
        for tid in ann["trackids"]:
            if int(tid) not in tids:
                tids.append(int(tid))
    slot_of = {tid: i for i, tid in enumerate(tids[:g_max])}

    gt_boxes = np.zeros((2, g_max, 4), np.float32)
    gt_labels = np.zeros((g_max,), np.int32)
    gt_valid = np.zeros((2, g_max), bool)
    images = []
    for f in range(2):
        ann = raw_annots[f]
        boxes = ann["boxes"].copy()
        if flipped and boxes.size:
            boxes = flip_boxes(torch.from_numpy(boxes), ann["width"]).numpy()
        canvas, scale = prepare_frame(entry["paths"][f], cfg, flip=flipped)
        images.append(canvas)
        if f == 0:
            im_size = np.array([round(ann["height"] * scale),
                                round(ann["width"] * scale)], np.float32)
        elif (ann["height"], ann["width"]) != (raw_annots[0]["height"],
                                               raw_annots[0]["width"]):
            # one im_size per pair would be wrong for one of the frames
            raise ValueError("frame pair with mismatched image extents: "
                             f"{entry['paths']}")
        for b, lab, tid in zip(boxes, ann["labels"], ann["trackids"]):
            slot = slot_of.get(int(tid))
            if slot is None:
                continue
            gt_boxes[f, slot] = b * scale
            gt_labels[slot] = lab
            gt_valid[f, slot] = True

    return {"images": np.stack(images), "gt_boxes": gt_boxes,
            "gt_labels": gt_labels, "gt_valid": gt_valid,
            "im_scale": np.float32(scale), "im_size": im_size}


def prepare_image(path: str, cfg: InputConfig) -> tuple[np.ndarray, float]:
    """One evaluation image -> (normalized canvas, scale)."""
    return prepare_frame(path, cfg)
