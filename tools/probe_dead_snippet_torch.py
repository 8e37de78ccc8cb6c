#!/usr/bin/env python
"""Probe why specific flagship-eval synthetic snippets yield ZERO
detections, for dtt_torch (the counterpart of
``tools/probe_dead_snippet.py``). Recreates a snippet exactly as
``eval_torch.py --synthetic`` does (the same RandomState(123) chain), then
re-runs the video step on controlled variants to isolate the cause:
position shift, zero velocity, class swap, background reroll, boxes grown
10%. With ``PROBE_STAGE=2`` a second stage follows: for the snippet's
frame 0, the RPN proposals' coverage of each gt box (best IoU and its RPN
score) and the R-FCN class probabilities at the gt box itself, which
separates an RPN recall failure from an R-FCN classification failure.

Usage (on a CUDA card):
    python tools/probe_dead_snippet_torch.py --checkpoint RUN_DIR
    PROBE_STAGE=2 python tools/probe_dead_snippet_torch.py --checkpoint RUN_DIR

``main(args, device)`` and ``proposal_probe(args, device)`` (args from
``parse_args``) print the lines and return their numbers, on the card
unless `device` is "cpu".
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", default="/tmp/flagship_synth")
    p.add_argument("--snippet", type=int, default=7)
    p.add_argument("--frames", type=int, default=8)
    return p.parse_args(argv)


def load(args, device=None):
    """(cfg, model with the run dir's latest parameters, the checkpoint)."""
    from dtt_torch.core.config import load_config
    from dtt_torch.train.checkpoint import (latest_checkpoint,
                                            restore_params_only)
    from dtt_torch.train.trainer import create_train_state

    ck = latest_checkpoint(args.checkpoint)
    cfg = load_config(os.path.join(args.checkpoint, "config.yml"))
    model, _ = create_train_state(cfg, device)
    restore_params_only(ck, model)
    return cfg, model, ck


def snippet_scene(cfg, snippet: int, frames: int) -> tuple:
    """eval's RNG chain up to snippet `snippet`: its (gt_boxes, gt_labels,
    gt_valid) and its background."""
    from dtt_torch.data.synthetic import _background, sample_snippet_params

    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    rng = np.random.RandomState(123)
    for _ in range(snippet):
        sample_snippet_params(rng, frames, h, w, cfg.model.num_classes,
                              cfg.input.max_gt_boxes)
        _background(rng, (frames, h, w, 3))
    gt = sample_snippet_params(rng, frames, h, w, cfg.model.num_classes,
                               cfg.input.max_gt_boxes)
    return (*gt, _background(rng, (frames, h, w, 3)))


def main(args=None, device=None) -> list:
    """The video step on the snippet and its variants: one line each, and
    [(tag, detections above 0.3, [best score over IoU 0.5 at frame 0 of
    object 0, of object 1])]."""
    from dtt_torch.data.synthetic import _background, render_frame
    from dtt_torch.eval.inference import (evaluate_snippet_video,
                                          make_video_step)
    from dtt_torch.eval.vid_eval import _iou_matrix

    args = args or parse_args()
    cfg, model, ck = load(args, device)
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    print(f"loaded {ck}")
    video_step = make_video_step(cfg, model, min(33, args.frames + 1),
                                 device)
    gt_boxes, gt_labels, gt_valid, bg = snippet_scene(cfg, args.snippet,
                                                      args.frames)
    rows = []

    def run(tag, boxes, labels, background):
        imgs = background.copy()
        for t in range(args.frames):
            render_frame(imgs[t], boxes[t], labels, gt_valid[t])
        b, s, v, _ = evaluate_snippet_video(cfg, video_step, imgs,
                                            im_hw=(h, w), scale=1.0)
        live = v & (s > 0.3)
        n_each = []
        for g in range(2):
            # best det score overlapping object g's frame-0 box
            gb = boxes[0, g:g + 1]
            best = 0.0
            for c in range(s.shape[0]):
                m = v[c, 0]
                if not m.any():
                    continue
                ious = _iou_matrix(np.asarray(b[c, 0][m], float), gb)[:, 0]
                sc = np.asarray(s[c, 0][m])
                hit = ious > 0.5
                if hit.any():
                    best = max(best, float(sc[hit].max()))
            n_each.append(round(best, 3))
        print(f"{tag:40s} hi-dets {int(live.sum()):3d}   "
              f"best score obj0/obj1: {n_each}")
        rows.append((tag, int(live.sum()), n_each))

    run("original (dead?)", gt_boxes, gt_labels, bg)
    # shift both objects +40px x, +24px y
    sh = gt_boxes + np.asarray([40, 24, 40, 24], np.float32)
    sh = np.clip(sh, 0, [w - 1, h - 1, w - 1, h - 1])
    run("shifted +40,+24", sh, gt_labels, bg)
    # zero velocity (freeze at frame 0 geometry)
    frozen = np.repeat(gt_boxes[:1], args.frames, axis=0)
    run("zero velocity", frozen, gt_labels, bg)
    # swap classes to (cls % 29) + 1
    swapped = np.where(gt_labels > 0, (gt_labels % 29) + 1, 0).astype(np.int32)
    run(f"classes {gt_labels[gt_valid[0]]} -> {swapped[gt_valid[0]]}",
        gt_boxes, swapped, bg)
    # a new background roll
    bg2 = _background(np.random.RandomState(999), (args.frames, h, w, 3))
    run("rerolled background", gt_boxes, gt_labels, bg2)
    # object sizes +10%
    c = (gt_boxes[..., :2] + gt_boxes[..., 2:]) / 2
    half = (gt_boxes[..., 2:] - gt_boxes[..., :2]) / 2 * 1.1
    grown = np.concatenate([c - half, c + half], -1).astype(np.float32)
    grown = np.clip(grown, 0, [w - 1, h - 1, w - 1, h - 1])
    run("boxes grown 10%", grown, gt_labels, bg)
    return rows


def proposal_probe(args=None, device=None) -> dict:
    """Frame 0 of the snippet: the valid proposals and their top score,
    then per gt object its best proposal IoU (and that proposal's RPN
    score) and the R-FCN probabilities at its box. Returns those numbers
    (unrounded)."""
    import torch

    from dtt_torch.core import boxes as box_ops
    from dtt_torch.core.anchors import grid_anchors_for
    from dtt_torch.data.synthetic import render_frame
    from dtt_torch.models.dnt import normalize_device_images, rfcn_head
    from dtt_torch.models.rpn import proposal_layer, softmax

    a = args or parse_args()
    cfg, model, _ = load(a, device)
    dev = next(model.parameters()).device
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    gt_boxes, gt_labels, gt_valid, bg = snippet_scene(cfg, a.snippet,
                                                      a.frames)
    img = bg[0].copy()
    render_frame(img, gt_boxes[0], gt_labels, gt_valid[0])
    mcfg = cfg.model
    anchors = torch.from_numpy(
        grid_anchors_for(mcfg.anchors, h // 16, w // 16)).to(dev)
    with torch.inference_mode():
        x = normalize_device_images(
            torch.from_numpy(img[None]).to(dev),
            torch.tensor([h, w], dtype=torch.float32, device=dev),
            cfg.input.pixel_means)
        feats = model.frame_features(x)
        props = proposal_layer(feats.rpn_cls[:1], feats.rpn_bbox[:1],
                               anchors, h, w, 1.0, mcfg.rpn, False)
        # the R-FCN head at the gt boxes themselves
        gtb = torch.from_numpy(gt_boxes[0][gt_valid[0]]).to(dev)
        cls_gt, _ = rfcn_head(mcfg, feats.cls_maps[0], feats.bbox_maps[0],
                              gtb, 1.0 / mcfg.anchors.feat_stride)
        cls_at_gt = softmax(cls_gt).cpu().numpy()
    valid = props.valid[0].cpu().numpy()
    rois = props.rois[0].cpu().numpy()[valid]
    scores = props.scores[0].cpu().numpy()[valid]
    print(f"valid proposals: {len(rois)}, top score {scores.max():.3f}")
    out = {"valid": len(rois), "top_score": float(scores.max()),
           "objects": []}
    for g in range(int(gt_valid[0].sum())):
        gb = gt_boxes[0, g]
        iou = box_ops.pairwise_iou(torch.from_numpy(rois),
                                   torch.from_numpy(gb[None])).numpy()[:, 0]
        j = int(np.argmax(iou))
        probs = cls_at_gt[g]
        print(f"obj{g} cls={gt_labels[g]} box={gb.round(0)}: "
              f"best proposal IoU {iou[j]:.3f} (rpn score {scores[j]:.3f}); "
              f"RFCN@gt: argmax cls {int(probs.argmax())} "
              f"p={probs.max():.3f}, p[true]={probs[gt_labels[g]]:.3f}")
        out["objects"].append({
            "cls": int(gt_labels[g]), "best_iou": float(iou[j]),
            "rpn_score": float(scores[j]), "argmax_cls": int(probs.argmax()),
            "p_max": float(probs.max()),
            "p_true": float(probs[gt_labels[g]])})
    return out


if __name__ == "__main__":
    main()
    if os.environ.get("PROBE_STAGE") == "2":
        proposal_probe()
