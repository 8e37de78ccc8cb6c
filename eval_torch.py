#!/usr/bin/env python
"""Evaluate D&T with dtt_torch on CUDA cards: detections, tube linking
and VID mAP (the PyTorch counterpart of ``eval.py``).

Examples:
  python train_torch.py --synthetic --out runs/dtt_torch
  python eval_torch.py --synthetic --checkpoint runs/dtt_torch --link
  python eval_torch.py --synthetic --checkpoint runs/dtt_torch --tau 2 \\
      --set model.roi.eval_pool_impl=pallas_mm
  python eval_torch.py --dataset imagenet_vid_val --data-root \\
      /data/ILSVRC2015 --checkpoint runs/dtt_torch --link
  torchrun --nproc_per_node=8 eval_torch.py --synthetic --parallel \\
      --checkpoint runs/dtt_torch --link

The checkpoint is a run dir (its LATEST) or a step dir that either
package wrote (``state.msgpack``, ``config.yml``). The config is the one
saved in the checkpoint, or --config, with --set applied after either.
The snippets are the synthetic ones or those of
--dataset under --data-root, whose frames decode as inference reaches them
(``LazyFrames``), at the scale and extent their annotations state. tau=1
runs the video step over 97-frame chunks, or with --synthetic over
chunks of --synthetic-frames + 1 (at most 97), as eval.py does; tau>1
runs the pair step over 4-pair batches, links tubes and interpolates them
to every frame. Prints the wall time of each
phase (decoding, within detection, apart), then one JSON line: mAP,
protocol (and with linking mAP_nolink and link_uplift) and the per-class
APs. Needs a CUDA card; ``main(argv, device="cpu")`` runs the plain
PyTorch path instead. The video and pair steps are programs, as eval.py
jits them: each captured once as CUDA graphs (trunk and post-trunk under
``eval.split_video_step``) and replayed; --parallel's steps are one
program each, with their halo and gather captured under NCCL.

--parallel shards the work over the ranks of ``torchrun`` (one process a
card; without ``torchrun``, a group of one rank): tau=1 runs
``make_video_step_parallel`` over chunks of ranks x frames a rank (the
synthetic snippet's length + 1 over the ranks, else 96 over the ranks,
as eval.py sizes them), tau>1 ``make_pair_step_parallel`` over batches of
2 pairs a rank. Every rank runs the steps and sees every output; rank 0
alone links, interpolates, scores mAP, prints and writes --out.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

# the phases of the ``wall ms`` line and the recorder's spans that time
# them (``dtt_torch.utils.profiling``), in the line's order; the LazyFrames'
# decoding, inside detection, is the counter ``eval.decode_ms``
PHASES = {"detect": "eval.detect", "link": "link",
          "interpolate+nms": "eval.interpolate+nms",
          "decode_in_detect": None,
          "eval_detections": "eval.eval_detections"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate Detect&Track "
                                            "(dtt_torch)")
    p.add_argument("--config", default=None,
                   help="YAML config (default: the checkpoint's own)")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VAL",
                   help="dotted config overrides")
    p.add_argument("--checkpoint", required=True,
                   help="run dir (uses LATEST) or a step dir with "
                        "state.msgpack, written by either package")
    p.add_argument("--dataset", default="imagenet_vid_val")
    p.add_argument("--data-root", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="evaluate on generated snippets (no dataset "
                        "required)")
    p.add_argument("--synthetic-snippets", type=int, default=4)
    p.add_argument("--synthetic-frames", type=int, default=8,
                   help="frames per synthetic snippet (also sizes the video "
                        "chunk)")
    p.add_argument("--synthetic-hard", action="store_true",
                   help="hard synthetic snippets: occlusion windows, "
                        "flickering distractors, noise bursts, confusable "
                        "textures (the linking benchmark)")
    p.add_argument("--hard-visibility", type=float, nargs=2, default=None,
                   metavar=("LO", "HI"), help="occlusion-window alpha range")
    p.add_argument("--hard-distractors", type=int, default=None)
    p.add_argument("--hard-noise-sigma", type=float, default=None)
    p.add_argument("--hard-occlusion-prob", type=float, default=None)
    p.add_argument("--link", action="store_true",
                   help="tube linking + rescoring")
    p.add_argument("--tau", type=int, default=1,
                   help="temporal stride (D&T paper §4); tau>1 implies "
                        "--link + tube interpolation")
    p.add_argument("--out", default=None, help="detections pickle path")
    p.add_argument("--max-snippets", type=int, default=None,
                   help="evaluate at most this many snippets")
    p.add_argument("--eval-protocol", choices=("devkit", "flat"),
                   default="devkit",
                   help="devkit: size-adaptive IoU threshold (ImageNet "
                        "eval_vid rule); flat: fixed IoU 0.5")
    p.add_argument("--parallel", action="store_true",
                   help="shard the frames (tau=1) or the pairs (tau>1) "
                        "over the ranks of torchrun, one card each")
    args = p.parse_args(argv)
    if args.synthetic_hard:
        args.synthetic = True
    if not args.synthetic and not args.data_root:
        p.exit(1, "--data-root required without --synthetic\n")
    if args.tau < 1:
        p.error("--tau must be at least 1")
    return args


def load_model(args, device):
    """The config (--config, else the checkpoint's, then --set) and the
    model with the checkpoint's parameters on `device`."""
    from dtt_torch.core.config import (apply_overrides, config_from_dict,
                                       load_config)
    from dtt_torch.models.dnt import make_model
    from dtt_torch.train.checkpoint import (checkpoint_config,
                                            latest_checkpoint,
                                            restore_params_only)

    ck = args.checkpoint
    if os.path.exists(os.path.join(ck, "LATEST")):
        ck = latest_checkpoint(ck)
    # fail fast, before the model is built
    if ck is None or not os.path.exists(os.path.join(ck, "state.msgpack")):
        raise SystemExit(
            f"error: no checkpoint at {args.checkpoint!r} (expected a run dir "
            f"with LATEST or a step dir with state.msgpack)")
    if args.config:
        cfg = load_config(args.config, args.set)
    else:
        cfg = apply_overrides(config_from_dict(checkpoint_config(ck)),
                              args.set)
    model = make_model(cfg.model, device)
    step = restore_params_only(ck, model)
    print(f"loaded {ck} (step {step})")
    return cfg, model


def snippet_stream_synthetic(cfg, n_snippets, num_frames=8, hard=None):
    """Synthetic snippets as raw uint8 canvases (normalized on the
    device), from ``RandomState(123)`` as ``eval.py`` draws them. `hard`:
    a Hardness, for the hard generator."""
    from dtt_torch.data.synthetic import synthetic_snippet
    from dtt_torch.data.synthetic_hard import synthetic_hard_snippet

    rng = np.random.RandomState(123)
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    for i in range(n_snippets):
        if hard is not None:
            imgs, gt_boxes, gt_labels, gt_valid = synthetic_hard_snippet(
                rng, num_frames, h, w, cfg.model.num_classes,
                cfg.input.max_gt_boxes, hard=hard, uint8=True)
        else:
            imgs, gt_boxes, gt_labels, gt_valid = synthetic_snippet(
                rng, num_frames, h, w, cfg.model.num_classes,
                cfg.input.max_gt_boxes, uint8=True)
        yield (f"synthetic_{i}", imgs, (h, w), 1.0,
               (gt_boxes, gt_labels, gt_valid))


def snippet_gt_arrays(annots, scale: float):
    """Track-aligned gt arrays for one snippet's annotations (dicts of
    boxes, labels, trackids), sized to the true track count so crowded
    snippets are never truncated. Returns (gt_boxes (T, G, 4),
    gt_labels (G,), gt_valid (T, G))."""
    t_len = len(annots)
    tids = [np.asarray(ann["trackids"], np.int64).reshape(-1)
            for ann in annots]
    flat_tids = (np.concatenate(tids) if tids
                 else np.zeros(0, np.int64))
    uniq = np.unique(flat_tids)          # slot order is arbitrary
    g = max(uniq.size, 1)
    gt_boxes = np.zeros((t_len, g, 4), np.float32)
    gt_labels = np.zeros((g,), np.int32)
    gt_valid = np.zeros((t_len, g), bool)
    if flat_tids.size:
        t_idx = np.repeat(np.arange(t_len), [t.size for t in tids])
        slots = np.searchsorted(uniq, flat_tids)
        gt_boxes[t_idx, slots] = np.concatenate(
            [np.asarray(ann["boxes"], np.float32).reshape(-1, 4)
             for ann in annots]) * scale
        gt_labels[slots] = np.concatenate(
            [np.asarray(ann["labels"], np.int32).reshape(-1)
             for ann in annots])
        gt_valid[t_idx, slots] = True
    return gt_boxes, gt_labels, gt_valid


def snippet_stream_vid(cfg, snippets):
    """(name, frames, im_hw, scale, gt) per snippet of a dataset's
    ``Snippet`` list. `frames` is a LazyFrames, decoded as inference
    reaches it; the scale and the true extent come from the first
    annotation's header (a snippet's frames share their size), so nothing
    decodes before inference."""
    from dtt_torch.data.transforms import canvas_scale
    from dtt_torch.eval.inference import LazyFrames

    for sn in snippets:
        ann0 = sn.annots[0]
        scale = canvas_scale(ann0["height"], ann0["width"], cfg.input)
        im_hw = (round(ann0["height"] * scale), round(ann0["width"] * scale))
        yield (os.path.basename(os.path.dirname(sn.frames[0])),
               LazyFrames(sn.frames, cfg.input), im_hw, scale,
               snippet_gt_arrays(sn.annots, scale))


def cap_frame_dets(scores: np.ndarray, valid: np.ndarray, max_dets: int
                   ) -> np.ndarray:
    """Per-frame detection cap across classes (cfg.eval.max_dets_per_frame,
    the reference's max_per_image rule): keep each frame's top `max_dets`
    scores among valid detections, ties kept. Returns the tightened valid
    mask (C-1, T, M)."""
    c, t, m = scores.shape
    if max_dets <= 0 or c * m <= max_dets:
        return valid
    flat = np.where(valid, scores, -np.inf).transpose(1, 0, 2).reshape(t, -1)
    kth = -np.sort(-flat, axis=1)[:, max_dets - 1]          # (T,)
    keep = (flat >= kth[:, None]) & np.isfinite(flat)
    return valid & keep.reshape(t, c, m).transpose(1, 0, 2)


def wall_ms(record) -> dict:
    """The wall ms of each phase of PHASES that ran, from the recorder's
    `record` of the evaluation."""
    clock = {}
    for phase, name in PHASES.items():
        if name is None:
            if "eval.decode_ms" in record.counts:
                clock[phase] = float(record.counts["eval.decode_ms"])
        elif record.named(name):
            clock[phase] = record.ms(name)
    return clock


def process_strided_snippet(cfg, num_classes, frame_uid, t_len, eval_ts,
                            boxes, scores, valid, tracked, all_dets, raw_dets,
                            device):
    """tau-strided snippet post-processing: link tubes (on `device`),
    interpolate them to every frame, and fall back to the raw keyframe
    detections no tube claimed. The raw keyframe detections also feed
    `raw_dets` (mAP_nolink). Accumulates (fids, scores, boxes) triples per
    class; interpolation and per-frame NMS are the span
    ``eval.interpolate+nms``."""
    from dtt_torch.eval.inference import interpolate_tubes, link_snippet
    from dtt_torch.eval.vid_eval import nms_frame_dets
    from dtt_torch.utils.profiling import span
    valid = cap_frame_dets(scores, valid, cfg.eval.max_dets_per_frame)
    _, tubes = link_snippet(cfg, boxes, scores, tracked, valid, device)
    with span("eval.interpolate+nms"):
        tau = int(eval_ts[1] - eval_ts[0]) if len(eval_ts) > 1 else 1
        ts, cls0, sc, bx = interpolate_tubes(tubes, boxes, eval_ts, t_len,
                                             tau=tau)
        keep = sc > cfg.eval.score_thresh
        in_tube = tubes.det_in_tube                             # (C-1, T', N)
        mask = valid & (scores > cfg.eval.score_thresh)
        eval_ts = np.asarray(eval_ts)
        for c in range(1, num_classes):
            ti, m = np.nonzero(mask[c - 1])
            if raw_dets is not None and ti.size:
                raw_dets[c].append((frame_uid + eval_ts[ti],
                                    scores[c - 1][ti, m], boxes[c - 1][ti, m]))
            # union of the interpolated tube detections and the unclaimed
            # raw keyframe detections, then per-frame NMS: parallel tubes
            # on one object would otherwise emit duplicates at every frame
            sel = keep & (cls0 == c - 1)
            orphan = (~in_tube[c - 1][ti, m] if ti.size
                      else np.zeros(0, bool))
            t_u = np.concatenate([ts[sel], eval_ts[ti][orphan]])
            if t_u.size == 0:
                continue
            s_u = np.concatenate([sc[sel], scores[c - 1][ti, m][orphan]])
            b_u = np.concatenate([bx[sel], boxes[c - 1][ti, m][orphan]],
                                 axis=0)
            km = nms_frame_dets(t_u, s_u, b_u, cfg.eval.nms_thresh)
            all_dets[c].append((frame_uid + t_u[km], s_u[km], b_u[km]))


def join_group(device):
    """--parallel: join ``torchrun``'s group, or without ``WORLD_SIZE``
    make one of a single rank (an in-process store), unless the caller
    joined one. Returns the rank's device and whether this call made the
    group (and so leaves it)."""
    import torch.distributed as dist

    from dtt_torch.parallel import initialize_distributed, local_device
    if dist.is_initialized():
        return local_device(device), False
    if "WORLD_SIZE" in os.environ:
        initialize_distributed(device=device)
    else:
        initialize_distributed(store=dist.HashStore(), world_size=1, rank=0,
                               device=device)
    return local_device(device), True


def main(argv=None, device=None):
    """Run the evaluation (on CUDA unless `device` is "cpu"); prints and
    returns the result dict, and returns the wall ms per phase and the
    number of frame pairs the steps ran. With --parallel, ranks other
    than 0 return None for the result."""
    args = parse_args(argv)
    from dtt_torch.core.device import resolve_device
    from dtt_torch.data.imagenet_vid import CLASS_NAMES
    from dtt_torch.data.synthetic_hard import Hardness
    from dtt_torch.eval.inference import (LazyFrames, evaluate_snippet,
                                          evaluate_snippet_video,
                                          link_snippet, make_pair_step,
                                          make_pair_step_parallel,
                                          make_video_step,
                                          make_video_step_parallel)
    from dtt_torch.eval.vid_eval import eval_detections
    from dtt_torch.parallel import data_mesh
    from dtt_torch.utils.profiling import count, recording, span

    owns_group, lead = False, True
    if args.parallel:
        device, owns_group = join_group(device)
        mesh = data_mesh(device)
        lead = mesh.rank == 0
    else:
        device = resolve_device(device)
    cfg, model = load_model(args, device)
    if args.synthetic:
        hard = None
        if args.synthetic_hard:
            over = {}
            if args.hard_visibility is not None:
                over["visibility"] = tuple(args.hard_visibility)
            if args.hard_distractors is not None:
                over["distractors"] = args.hard_distractors
            if args.hard_noise_sigma is not None:
                over["noise_sigma"] = args.hard_noise_sigma
            if args.hard_occlusion_prob is not None:
                over["occlusion_prob"] = args.hard_occlusion_prob
            hard = Hardness(**over)
        n_snippets = args.synthetic_snippets
        if args.max_snippets is not None:
            n_snippets = min(n_snippets, args.max_snippets)
        stream = snippet_stream_synthetic(cfg, n_snippets,
                                          args.synthetic_frames, hard=hard)
    else:
        import dtt_torch.data.imagenet_vid  # noqa: F401  (registers datasets)
        from dtt_torch.data.imdb import get_dataset
        snippets = get_dataset(args.dataset, root=args.data_root).snippets
        if args.max_snippets:
            snippets = snippets[:args.max_snippets]
        stream = snippet_stream_vid(cfg, snippets)
    do_link = args.link or args.tau > 1   # tau>1 implies tube linking
    if args.tau > 1 and args.parallel:
        pair_step = make_pair_step_parallel(cfg, model, mesh)
        if lead:
            print(f"parallel strided eval: {mesh.size} rank(s) "
                  f"({mesh.backend}), {pair_step.batch}-pair batches")
    elif args.tau > 1:
        pair_step = make_pair_step(cfg, model, 4, device)
    elif args.parallel:
        # eval.py's parallel chunk: the synthetic snippet (+1) or 96
        # frames, over the ranks
        n = mesh.size
        fpd = (max(1, (args.synthetic_frames + n) // n) if args.synthetic
               else max(1, 96 // n))
        video_step = make_video_step_parallel(cfg, model, mesh, fpd)
        if lead:
            print(f"parallel eval: {n} rank(s) ({mesh.backend}), "
                  f"{video_step.frames_per_chunk}-frame chunks")
    else:
        # eval.py's chunk: synthetic snippets are short and of known length
        fpc = min(97, args.synthetic_frames + 1) if args.synthetic else 97
        video_step = make_video_step(cfg, model, fpc, device)
    num_classes = cfg.model.num_classes

    all_dets = {c: [] for c in range(1, num_classes)}
    # when linking, the pre-linking detections are collected too, so one
    # pass gives both mAPs; for tau>1 these are the keyframe detections
    raw_dets = {c: [] for c in range(1, num_classes)} if do_link else None
    all_gts = {c: {} for c in range(1, num_classes)}
    frame_uid, pairs = 0, 0
    with recording() as record:
        for name, frames, im_hw, scale, (gt_boxes, gt_labels,
                                         gt_valid) in stream:
            t_len = frames.shape[0]
            if args.tau > 1:
                with span("eval.detect", request=True):
                    boxes, scores, valid, tracked, eval_ts = \
                        evaluate_snippet(cfg, pair_step, frames,
                                         tau=args.tau, im_hw=im_hw,
                                         scale=scale)
                pairs += len(eval_ts)
                if not lead:
                    continue
                process_strided_snippet(cfg, num_classes, frame_uid, t_len,
                                        eval_ts, boxes, scores, valid,
                                        tracked, all_dets, raw_dets, device)
            else:
                with span("eval.detect", request=True):
                    boxes, scores, valid, tracked = evaluate_snippet_video(
                        cfg, video_step, frames, im_hw=im_hw, scale=scale)
                pairs += t_len
                if not lead:
                    continue
                valid = cap_frame_dets(scores, valid,
                                       cfg.eval.max_dets_per_frame)
                raw_scores = scores
                if args.link:
                    scores, _ = link_snippet(cfg, boxes, scores, tracked,
                                             valid, device)

                def collect(dest, sc):
                    mask = valid & (sc > cfg.eval.score_thresh)
                    for c in range(1, num_classes):
                        t_idx, m_idx = np.nonzero(mask[c - 1])
                        if t_idx.size:
                            dest[c].append((frame_uid + t_idx,
                                            sc[c - 1][t_idx, m_idx],
                                            boxes[c - 1][t_idx, m_idx]))

                collect(all_dets, scores)
                if raw_dets is not None:
                    collect(raw_dets, raw_scores)
            for c in np.unique(gt_labels):
                if not 1 <= c < num_classes:   # 0 = padding slots / bg
                    continue
                slot_mask = gt_labels == c              # (G,)
                present = gt_valid & slot_mask[None, :]  # (T, G)
                for t in np.nonzero(present.any(axis=1))[0]:
                    all_gts[int(c)][frame_uid + int(t)] = \
                        gt_boxes[t][present[t]]
            frame_uid += t_len
            decoded = ""
            if isinstance(frames, LazyFrames):
                count("eval.decode_ms", frames.decode_ms)
                decoded = f", {frames.decode_count} decoded"
            print(f"snippet {name}: {t_len} frames done "
                  f"(tau={args.tau}){decoded}")

        if owns_group:
            import torch.distributed as dist
            dist.destroy_process_group()
        if lead:
            if args.out:
                with open(args.out, "wb") as f:
                    pickle.dump({"dets": all_dets, "gts": all_gts}, f)
                print(f"wrote {args.out}")
            names = CLASS_NAMES if num_classes == 31 else None
            with span("eval.eval_detections"):
                result = eval_detections(all_dets, all_gts, num_classes,
                                         class_names=names,
                                         protocol=args.eval_protocol)
                raw = (eval_detections(raw_dets, all_gts, num_classes,
                                       class_names=names,
                                       protocol=args.eval_protocol)
                       if raw_dets is not None else None)
    clock = wall_ms(record)
    if not lead:
        return None, clock, pairs
    per_class = {f"class_{c}": (None if np.isnan(a) else round(a, 4))
                 for c, a in result["ap"].items()}
    out = {"mAP": round(result["map"], 4), "protocol": args.eval_protocol}
    if raw is not None:
        out["mAP_nolink"] = round(raw["map"], 4)
        out["link_uplift"] = round(result["map"] - raw["map"], 4)
    print("wall ms: " + ", ".join(f"{k} {v:.1f}" for k, v in clock.items())
          + f"; {pairs} pairs")
    out = {**out, **per_class}
    print(json.dumps(out))
    return out, clock, pairs


if __name__ == "__main__":
    main()
