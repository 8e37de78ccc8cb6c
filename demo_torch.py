#!/usr/bin/env python
"""Demo with dtt_torch: run D&T over a frame directory or a video and draw
the detections, and with --link their tubes (the PyTorch counterpart of
``demo.py``).

Examples:
  python demo_torch.py --checkpoint runs/dtt_torch --frames /path/to/frames \\
      --out demo_out
  python demo_torch.py --checkpoint runs/tiny --synthetic --link --out demo_out

The checkpoint is a run dir or a step dir that either package wrote; the
config is its own, or --config, with --set applied after either. The
frames go through the tau=1 pair step in 4-pair batches, each paired with
the next; every frame is written to --out as ``frame_XXXX.jpg`` with its
boxes above --score-thresh, coloured by class (by tube with --link).
``cv2`` reads the frames and writes the images, imported only by the
functions that do so. Needs a CUDA card; ``main(argv, device="cpu")``
runs the plain PyTorch path instead.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Detect&Track demo (dtt_torch)")
    p.add_argument("--config", default=None)
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VAL")
    p.add_argument("--checkpoint", required=True,
                   help="run dir (uses LATEST) or a step dir with "
                        "state.msgpack, written by either package")
    p.add_argument("--frames", default=None,
                   help="directory of ordered frames (JPEG/PNG) or a video "
                        "file")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--out", default="demo_out")
    p.add_argument("--score-thresh", type=float, default=0.3)
    p.add_argument("--link", action="store_true")
    args = p.parse_args(argv)
    if not args.synthetic and not args.frames:
        p.error("--frames required without --synthetic")
    return args


def read_frames(path):
    """float32 BGR frames of a directory (sorted names) or a video file."""
    import cv2
    if os.path.isdir(path):
        names = sorted(f for f in os.listdir(path)
                       if f.lower().endswith((".jpeg", ".jpg", ".png")))
        return [cv2.imread(os.path.join(path, n)).astype(np.float32)
                for n in names]
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame.astype(np.float32))
    cap.release()
    return frames


_COLORS = [(60, 76, 231), (113, 204, 46), (219, 152, 52), (34, 126, 230),
           (156, 89, 182), (47, 156, 241), (133, 160, 22), (43, 57, 192)]


def draw(img, boxes, scores, classes, names, tube_ids=None):
    """`img` as uint8 with each box, its class name and score (and tube
    id) drawn, coloured by tube or class."""
    import cv2
    out = img.copy().astype(np.uint8)
    for i, (b, s, c) in enumerate(zip(boxes, scores, classes)):
        color = _COLORS[(tube_ids[i] if tube_ids is not None else c)
                        % len(_COLORS)]
        x1, y1, x2, y2 = [int(round(v)) for v in b]
        cv2.rectangle(out, (x1, y1), (x2, y2), color, 2)
        label = f"{names[c] if c < len(names) else c}:{s:.2f}"
        if tube_ids is not None:
            label += f" #{tube_ids[i]}"
        cv2.putText(out, label, (x1, max(y1 - 4, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1, cv2.LINE_AA)
    return out


def write_frame(path: str, img) -> None:
    import cv2
    if not cv2.imwrite(path, img):
        raise OSError(f"could not write {path}")


def tube_ids(tubes, shape) -> np.ndarray:
    """(C-1, T, M) id of the tube each detection belongs to, -1 for
    none; ids count the valid tubes class by class."""
    det_idx = np.asarray(tubes.det_idx)       # (C-1, max_tubes, T)
    tube_ok = np.asarray(tubes.tube_valid)
    in_tube = np.asarray(tubes.det_in_tube)
    out = np.full(shape, -1, np.int64)
    tid = 0
    for c in range(det_idx.shape[0]):
        for k in range(det_idx.shape[1]):
            if not tube_ok[c, k]:
                continue
            for t in range(det_idx.shape[2]):
                j = det_idx[c, k, t]
                if in_tube[c, t, j]:
                    out[c, t, j] = tid
            tid += 1
    return out


def main(argv=None, device=None):
    """Run the demo (on CUDA unless `device` is "cpu"); returns the number
    of frames written and of boxes drawn."""
    args = parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from eval_torch import load_model

    from dtt_torch.core.device import resolve_device
    from dtt_torch.data.imagenet_vid import CLASS_NAMES
    from dtt_torch.data.transforms import normalize, resize_to_canvas
    from dtt_torch.eval.inference import (evaluate_snippet, link_snippet,
                                          make_pair_step)

    device = resolve_device(device)
    cfg, model = load_model(args, device)
    names = (CLASS_NAMES if cfg.model.num_classes == 31
             else [f"c{i}" for i in range(cfg.model.num_classes)])
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    if args.synthetic:
        from dtt_torch.data.synthetic import synthetic_snippet
        raw, _, _, _ = synthetic_snippet(np.random.RandomState(7), 8, h, w,
                                         cfg.model.num_classes,
                                         cfg.input.max_gt_boxes)
        frames = list(raw)
        scale = 1.0
        canvases = [normalize(f, cfg.input) for f in frames]
        im_hw = (h, w)
    else:
        frames = read_frames(args.frames)
        if not frames:
            raise SystemExit(f"error: no frames found at {args.frames}")
        canvases = []
        for f in frames:
            c, scale = resize_to_canvas(f, cfg.input)   # normalizes too
            canvases.append(c)
        im_hw = (round(frames[0].shape[0] * scale),
                 round(frames[0].shape[1] * scale))

    pair_step = make_pair_step(cfg, model, 4, device)
    boxes, scores, valid, tracked = evaluate_snippet(
        cfg, pair_step, np.stack(canvases), im_hw=im_hw, scale=scale)
    tube_of = None
    if args.link:
        scores, tubes = link_snippet(cfg, boxes, scores, tracked, valid,
                                     device)
        tube_of = tube_ids(tubes, scores.shape)

    os.makedirs(args.out, exist_ok=True)
    n_drawn = 0
    for t, frame in enumerate(frames):
        ci, m = np.nonzero(valid[:, t] & (scores[:, t] >= args.score_thresh))
        tids = [int(tube_of[c, t, j]) for c, j in zip(ci, m)] \
            if tube_of is not None else None
        img = draw(frame, boxes[ci, t, m] / scale, scores[ci, t, m].tolist(),
                   (ci + 1).tolist(), names, tube_ids=tids)
        write_frame(os.path.join(args.out, f"frame_{t:04d}.jpg"), img)
        n_drawn += ci.size
    print(f"wrote {len(frames)} annotated frames ({n_drawn} boxes) to "
          f"{args.out}")
    return len(frames), n_drawn


if __name__ == "__main__":
    main()
