"""Write a small ImageNet VID/DET tree of synthetic scenes, in the
ILSVRC2015 layout ``dtt_torch.data.imagenet_vid`` reads, for the tests,
``chip_smoke.py`` and ``tools/bench_data_torch.py`` where the real corpus
is not on the machine. From the repository root (``tests`` on the path
as a directory: another installed ``tests`` package may shadow
``tests.vid_tree``)::

    PYTHONPATH=tests python -c "from vid_tree import write_vid_tree as w; w('/tmp/vid')"

Snippets hold class-textured rectangles (``synthetic.object_texture``)
moving at constant velocity on a smooth noisy background, with track ids;
in each snippet the last object leaves halfway through. DET images hold
still objects plus one of a class outside VID's 30, which the reader skips.
Frames are JPEG files written by PIL; annotations are VOC-style XML.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from dtt_torch.data.imagenet_vid import VID_CLASSES
from dtt_torch.data.synthetic import render_frame

NON_VID_WNID = "n99999999"


def write_annotation(path: str, width: int, height: int, objects) -> None:
    """VOC-style XML: the image size and one <object> per (wnid, trackid,
    (x1, y1, x2, y2))."""
    root = ET.Element("annotation")
    size = ET.SubElement(root, "size")
    ET.SubElement(size, "width").text = str(width)
    ET.SubElement(size, "height").text = str(height)
    for wnid, tid, box in objects:
        o = ET.SubElement(root, "object")
        ET.SubElement(o, "trackid").text = str(tid)
        ET.SubElement(o, "name").text = wnid
        bb = ET.SubElement(o, "bndbox")
        for k, v in zip(("xmin", "ymin", "xmax", "ymax"), box):
            ET.SubElement(bb, k).text = str(int(round(v)))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ET.ElementTree(root).write(path)


def _background(rng: np.random.RandomState, height: int, width: int
                ) -> np.ndarray:
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    base = (60 + 40 * np.sin(yy / 97.0)[..., None]
            + 30 * np.cos(xx[..., None] / 131.0 + np.arange(3)))
    noise = rng.randint(-8, 9, (height, width, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _write_jpeg(path: str, bgr: np.ndarray, quality: int) -> None:
    from PIL import Image
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(np.ascontiguousarray(bgr[:, :, ::-1])).save(
        path, format="JPEG", quality=quality)


def _draw(canvas: np.ndarray, objects) -> np.ndarray:
    for wnid, _, box in objects:
        label = 1 + [w for w, _ in VID_CLASSES].index(wnid) if (
            wnid != NON_VID_WNID) else 31
        render_frame(canvas, np.asarray([box], np.float32),
                     np.asarray([label]), np.asarray([True]))
    return canvas


def _snippet(root: str, split: str, name: str, n_frames: int, rng,
             height: int, width: int, num_objects: int, quality: int) -> None:
    objs = []
    for tid in range(num_objects):
        bw, bh = rng.uniform(0.15, 0.3) * width, rng.uniform(0.2, 0.35) * height
        x1, y1 = rng.uniform(0, width - bw), rng.uniform(0, height - bh)
        v = rng.uniform(-0.01, 0.01, 2) * (width, height)
        wnid = VID_CLASSES[rng.randint(len(VID_CLASSES))][0]
        objs.append((wnid, tid, np.array([x1, y1, x1 + bw, y1 + bh]), v))
    for t in range(n_frames):
        present = []
        for wnid, tid, box, v in objs:
            if tid == num_objects - 1 and num_objects > 1 and t >= n_frames // 2:
                continue                      # the last object has left
            b = box + np.tile(v, 2) * t
            b = np.clip(b, 0, [width - 1, height - 1] * 2)
            if b[2] - b[0] >= 8 and b[3] - b[1] >= 8:
                present.append((wnid, tid, b))
        stem = f"{t:06d}"
        _write_jpeg(os.path.join(root, "Data", "VID", split, name,
                                 stem + ".JPEG"),
                    _draw(_background(rng, height, width), present), quality)
        write_annotation(os.path.join(root, "Annotations", "VID", split, name,
                                      stem + ".xml"), width, height, present)


def write_vid_tree(root: str, seed: int = 0, height: int = 720,
                   width: int = 1280, train_frames=(10, 10),
                   val_frames=(17,), det_images: int = 4,
                   num_objects: int = 2, quality: int = 90) -> dict:
    """Write the tree under `root`: a train snippet of n frames for each n
    in `train_frames`, a val snippet for each in `val_frames`, and
    `det_images` DET train images, all height x width. Returns the counts
    of frames written per split."""
    rng = np.random.RandomState(seed)
    for i, n in enumerate(train_frames):
        _snippet(root, "train", f"snippet_{i:03d}", n, rng, height, width,
                 num_objects, quality)
    for i, n in enumerate(val_frames):
        _snippet(root, "val", f"snippet_{i:03d}", n, rng, height, width,
                 num_objects, quality)
    for i in range(det_images):
        objs = []
        for tid in range(num_objects):
            bw, bh = rng.uniform(0.2, 0.4) * width, rng.uniform(0.2, 0.4) * height
            x1, y1 = rng.uniform(0, width - bw), rng.uniform(0, height - bh)
            objs.append((VID_CLASSES[rng.randint(len(VID_CLASSES))][0], 0,
                         np.array([x1, y1, x1 + bw, y1 + bh])))
        if i % 2:                    # a class outside VID's, to be skipped
            objs.append((NON_VID_WNID, 0,
                         np.array([0, 0, width / 4, height / 4])))
        stem = f"det_{i:06d}"
        _write_jpeg(os.path.join(root, "Data", "DET", "train", "fold",
                                 stem + ".JPEG"),
                    _draw(_background(rng, height, width), objs), quality)
        write_annotation(os.path.join(root, "Annotations", "DET", "train",
                                      "fold", stem + ".xml"), width, height,
                         objs)
    return {"train": sum(train_frames), "val": sum(val_frames),
            "det": det_images}
