#!/usr/bin/env python
"""Diagnose tau=2 linked mAP against tau=1 on clean synthetic snippets,
for dtt_torch (the counterpart of ``tools/probe_tau2.py``).

Runs the strided path (pair step, tube linking, interpolation) on a few
snippets drawn as ``eval_torch.py --synthetic`` draws them and prints, per
frame, how many gt objects are covered (IoU >= 0.5) by (a) the raw
keyframe detections and (b) the tube-interpolated detections above 0.05,
then the tube bookkeeping of each class present: each valid tube's
keyframes in the tube and their rescored scores.

Usage (on a CUDA card): python tools/probe_tau2_torch.py --checkpoint RUN

``main(args, device)`` (args from ``parse_args``) prints the lines and
returns their numbers, on the card unless `device` is "cpu".
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def iou(a, b):
    ax1, ay1, ax2, ay2 = a
    bx1, by1, bx2, by2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    ix = np.maximum(0, np.minimum(ax2, bx2) - np.maximum(ax1, bx1) + 1)
    iy = np.maximum(0, np.minimum(ay2, by2) - np.maximum(ay1, by1) + 1)
    inter = ix * iy
    ua = ((ax2 - ax1 + 1) * (ay2 - ay1 + 1)
          + (bx2 - bx1 + 1) * (by2 - by1 + 1) - inter)
    return inter / np.maximum(ua, 1e-9)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", default="runs/mid_synth")
    p.add_argument("--snippets", type=int, default=3)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--tau", type=int, default=2)
    return p.parse_args(argv)


def main(args=None, device=None) -> list:
    """One dict a snippet: its keyframes, valid tubes a class, the
    per-frame coverage [(t, keyframe, raw covered, interpolated covered,
    objects)] and the tubes of the classes present [(class, tube, in tube
    a keyframe, rescored a keyframe)]."""
    from dtt_torch.core.config import load_config
    from dtt_torch.data.synthetic import synthetic_snippet
    from dtt_torch.eval.inference import (evaluate_snippet, interpolate_tubes,
                                          link_snippet, make_pair_step)
    from dtt_torch.train.checkpoint import (latest_checkpoint,
                                            restore_params_only)
    from dtt_torch.train.trainer import create_train_state

    args = args or parse_args()
    ck = latest_checkpoint(args.checkpoint)
    cfg = load_config(os.path.join(ck, "config.yml"))
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    model, _ = create_train_state(cfg, device)
    restore_params_only(ck, model)

    pair_step = make_pair_step(cfg, model, device=device)
    rng = np.random.RandomState(123)
    out = []
    for s in range(args.snippets):
        imgs, gt_boxes, gt_labels, gt_valid = synthetic_snippet(
            rng, args.frames, h, w, cfg.model.num_classes,
            cfg.input.max_gt_boxes, uint8=True)
        boxes, scores, valid, tracked, eval_ts = evaluate_snippet(
            cfg, pair_step, imgs, tau=args.tau)
        _, tubes = link_snippet(cfg, boxes, scores, tracked, valid, device)
        tv = np.asarray(tubes.tube_valid)
        onmat = np.asarray(tubes.det_in_tube)
        print(f"snippet {s}: eval_ts={eval_ts}  tubes/class="
              f"{tv.sum(axis=1).tolist()}", flush=True)
        rec = {"eval_ts": list(eval_ts), "tubes": tv.sum(axis=1).tolist(),
               "frames": [], "tube_rows": []}
        ts, cls0, sc, bx = interpolate_tubes(tubes, boxes, eval_ts,
                                             args.frames, tau=args.tau)
        n_obj = int(gt_valid[0].sum())
        for t in range(args.frames):
            cover_raw = cover_itp = 0
            for g in range(n_obj):
                gt = gt_boxes[t, g]
                c = int(gt_labels[g]) - 1
                if t in eval_ts:
                    ti = eval_ts.index(t)
                    v = np.asarray(valid[c][ti]).astype(bool)
                    if v.any() and iou(gt, np.asarray(boxes[c][ti])[v]).max() >= 0.5:
                        cover_raw += 1
                sel = (ts == t) & (cls0 == c) & (sc > 0.05)
                if sel.any() and iou(gt, bx[sel]).max() >= 0.5:
                    cover_itp += 1
            tag = "KEY" if t in eval_ts else "   "
            print(f"  t={t:2d} {tag} raw {cover_raw}/{n_obj}  "
                  f"interp {cover_itp}/{n_obj}", flush=True)
            rec["frames"].append((t, t in eval_ts, cover_raw, cover_itp,
                                  n_obj))
        # tube keyframe coverage for the classes present
        for g in range(n_obj):
            c = int(gt_labels[g]) - 1
            for k in np.nonzero(tv[c])[0]:
                j = np.asarray(tubes.det_idx)[c, k]
                on = onmat[c, np.arange(len(eval_ts)), j]
                rs = np.asarray(tubes.rescored)[c, np.arange(len(eval_ts)), j]
                print(f"  class {c} tube {k}: on={on.astype(int).tolist()} "
                      f"rescored={np.round(rs, 2).tolist()}", flush=True)
                rec["tube_rows"].append((c, int(k), on.astype(int).tolist(),
                                         rs.tolist()))
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
