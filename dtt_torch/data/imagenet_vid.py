"""ImageNet VID / DET: annotation parsing, snippets and the frame-pair
roidb (counterpart of ``dtt.data.imagenet_vid``).

The reference's dataset classes (lib/datasets/imagenet*.py): VID snippets
with track ids, DET still images, the 30-class VID label space, and the
frame pairs D&T trains on, where a DET image pairs with itself as an
identity track.

Directory layout (standard ILSVRC2015):
  <root>/Data/VID/<split>/<snippet>/<frame>.JPEG
  <root>/Annotations/VID/<split>/<snippet>/<frame>.xml
  <root>/ImageSets/VID/<split>.txt
  <root>/Data/DET/<split>/... , Annotations/DET/...
"""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import List

import numpy as np

from dtt_torch.data.imdb import register_dataset

# The 30 ImageNet VID categories (wnid -> readable name), devkit order.
VID_CLASSES = [
    ("n02691156", "airplane"), ("n02419796", "antelope"),
    ("n02131653", "bear"), ("n02834778", "bicycle"),
    ("n01503061", "bird"), ("n02924116", "bus"),
    ("n02958343", "car"), ("n02402425", "cattle"),
    ("n02084071", "dog"), ("n02121808", "domestic_cat"),
    ("n02503517", "elephant"), ("n02118333", "fox"),
    ("n02510455", "giant_panda"), ("n02342885", "hamster"),
    ("n02374451", "horse"), ("n02129165", "lion"),
    ("n01674464", "lizard"), ("n02484322", "monkey"),
    ("n03790512", "motorcycle"), ("n02324045", "rabbit"),
    ("n02509815", "red_panda"), ("n02411705", "sheep"),
    ("n01726692", "snake"), ("n02355227", "squirrel"),
    ("n02129604", "tiger"), ("n04468005", "train"),
    ("n01662784", "turtle"), ("n04530566", "watercraft"),
    ("n02062744", "whale"), ("n02391049", "zebra"),
]
WNID_TO_LABEL = {w: i + 1 for i, (w, _) in enumerate(VID_CLASSES)}  # 0 = bg
CLASS_NAMES = ["__background__"] + [n for _, n in VID_CLASSES]


def parse_vid_xml(path: str) -> dict:
    """One annotation file -> {width, height, boxes, labels, trackids}."""
    root = ET.parse(path).getroot()
    size = root.find("size")
    width = int(size.find("width").text)
    height = int(size.find("height").text)
    boxes, labels, trackids = [], [], []
    for obj in root.findall("object"):
        wnid = obj.find("name").text.strip()
        if wnid not in WNID_TO_LABEL:
            continue  # DET images carry non-VID classes; skip them
        bb = obj.find("bndbox")
        x1 = float(bb.find("xmin").text)
        y1 = float(bb.find("ymin").text)
        x2 = float(bb.find("xmax").text)
        y2 = float(bb.find("ymax").text)
        tid_node = obj.find("trackid")
        tid = int(tid_node.text) if tid_node is not None else 0
        boxes.append([x1, y1, x2, y2])
        labels.append(WNID_TO_LABEL[wnid])
        trackids.append(tid)
    return {
        "width": width,
        "height": height,
        "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
        "labels": np.asarray(labels, np.int32),
        "trackids": np.asarray(trackids, np.int32),
    }


@dataclass
class Snippet:
    frames: List[str]          # image paths, temporal order
    annots: List[dict]         # parsed annotations per frame


@dataclass
class ImagenetVID:
    """VID video dataset -> frame-pair roidb entries."""

    root: str
    split: str = "train"
    tau: int = 1               # temporal offset of the pair
    use_flipped: bool = True
    cache_dir: str | None = None
    snippets: List[Snippet] = field(default_factory=list)

    def __post_init__(self):
        cache = None
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)
            cache = os.path.join(self.cache_dir,
                                 f"vid_{self.split}_tau{self.tau}.pkl")
            if os.path.exists(cache):
                with open(cache, "rb") as f:
                    self.snippets = pickle.load(f)
                return
        self.snippets = self._load_snippets()
        if cache:
            with open(cache, "wb") as f:
                pickle.dump(self.snippets, f)

    def _snippet_dirs(self) -> List[str]:
        listfile = os.path.join(self.root, "ImageSets", "VID",
                                f"{self.split}.txt")
        data_root = os.path.join(self.root, "Data", "VID", self.split)
        if os.path.exists(listfile):
            names = []
            with open(listfile) as f:
                for line in f:
                    name = line.strip().split()[0]
                    # val lists enumerate frames; train lists snippets
                    name = name.rsplit("/", 1)[0] if name.endswith(".JPEG") else name
                    if name not in names:
                        names.append(name)
            # train.txt entries may nest (subdir/snippet); resolve to dirs
            dirs = []
            for n in names:
                d = os.path.join(data_root, n)
                if os.path.isdir(d):
                    dirs.append(d)
            if dirs:
                return dirs
        # fall back to a filesystem walk
        dirs = []
        for dirpath, dirnames, filenames in os.walk(data_root):
            if any(f.endswith(".JPEG") for f in filenames):
                dirs.append(dirpath)
        return sorted(dirs)

    def _load_snippets(self) -> List[Snippet]:
        out = []
        data_root = os.path.join(self.root, "Data", "VID", self.split)
        ann_root = os.path.join(self.root, "Annotations", "VID", self.split)
        for d in self._snippet_dirs():
            rel = os.path.relpath(d, data_root)
            frames = sorted(f for f in os.listdir(d) if f.endswith(".JPEG"))
            paths, annots = [], []
            for fr in frames:
                xml = os.path.join(ann_root, rel, fr.replace(".JPEG", ".xml"))
                if not os.path.exists(xml):
                    continue
                paths.append(os.path.join(d, fr))
                annots.append(parse_vid_xml(xml))
            if len(paths) >= 1:
                out.append(Snippet(frames=paths, annots=annots))
        return out

    def roidb(self) -> List[dict]:
        """Frame-pair entries: {paths (2,), annots (2,), flipped}."""
        entries = []
        for sn in self.snippets:
            n = len(sn.frames)
            for t in range(n - self.tau):
                e = {
                    "paths": (sn.frames[t], sn.frames[t + self.tau]),
                    "annots": (sn.annots[t], sn.annots[t + self.tau]),
                    "flipped": False,
                }
                entries.append(e)
                if self.use_flipped:
                    entries.append({**e, "flipped": True})
        return entries


@dataclass
class ImagenetDET:
    """DET still images (VID-class subset) paired with themselves.

    D&T joint training treats a DET image as a 2-frame snippet with zero
    motion (identity track) — ref dataset classes + D&T paper §3.4.
    """

    root: str
    split: str = "train"
    use_flipped: bool = True
    max_images: int | None = None

    def _index(self) -> List[str]:
        data_root = os.path.join(self.root, "Data", "DET", self.split)
        items = []
        for dirpath, _, filenames in os.walk(data_root):
            for f in sorted(filenames):
                if f.endswith(".JPEG"):
                    items.append(os.path.join(dirpath, f))
        return sorted(items)

    def roidb(self) -> List[dict]:
        data_root = os.path.join(self.root, "Data", "DET", self.split)
        ann_root = os.path.join(self.root, "Annotations", "DET", self.split)
        entries = []
        for img in self._index():
            rel = os.path.relpath(img, data_root)
            xml = os.path.join(ann_root, rel.replace(".JPEG", ".xml"))
            if not os.path.exists(xml):
                continue
            ann = parse_vid_xml(xml)
            if ann["boxes"].shape[0] == 0:
                continue  # no VID-class objects in this DET image
            ann = {**ann,
                   "trackids": np.arange(ann["boxes"].shape[0], dtype=np.int32)}
            e = {"paths": (img, img), "annots": (ann, ann), "flipped": False}
            entries.append(e)
            if self.use_flipped:
                entries.append({**e, "flipped": True})
            if self.max_images and len(entries) >= self.max_images:
                break
        return entries


@register_dataset("imagenet_vid_train")
def _vid_train(root, **kw):
    return ImagenetVID(root=root, split="train", **kw)


@register_dataset("imagenet_vid_val")
def _vid_val(root, **kw):
    return ImagenetVID(root=root, split="val", use_flipped=False, **kw)


@register_dataset("imagenet_det_train")
def _det_train(root, **kw):
    return ImagenetDET(root=root, split="train", **kw)
