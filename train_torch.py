#!/usr/bin/env python
"""Train the D&T model with dtt_torch on one CUDA card (the PyTorch
counterpart of ``train.py``).

Examples:
  # synthetic mini-VID, no dataset needed:
  python train_torch.py --synthetic --set train.total_steps=50 --out runs/dtt_torch
  # the same scenes drawn on the card from KB-scale parameters:
  python train_torch.py --synthetic --device-render --out runs/dtt_torch
  # ImageNet VID + DET, mixed 1:1 per batch slot:
  python train_torch.py --dataset imagenet_vid_train+imagenet_det_train \\
      --data-root /data/ILSVRC2015 --set input.det_fraction=0.5 \\
      --pretrained resnet101.pth --out runs/dnt

Like train.py, the flagship config assumes an ImageNet-pretrained backbone
(--pretrained, a torchvision-layout ResNet .pth); --calibrate-bn instead
estimates the frozen-BN affines from one batch (LSUV), for training from
scratch. Trains from flax-layout random weights drawn from ``train.seed``
(then --pretrained, then --calibrate-bn, then --resume, in train.py's
order) on one of three sources: the synthetic mini-VID (uint8 pairs,
normalized on the card), the same scenes drawn on the card
(``--device-render``), or the
'+'-joined datasets under --data-root read by ``PairLoader``
(``input.use_flipped``, ``input.det_fraction``; bf16 images for a bf16
model). Every batch reaches the card through ``device_prefetch``. Logs one
JSON line every ``train.log_every`` steps (and after the first) with
pairs/s and the losses, checkpoints every ``train.checkpoint_every`` steps
and at the end in dtt's run-dir format (``state.msgpack``), and resumes
from the latest checkpoint in --out with --resume, whichever package
wrote it. Needs a CUDA card; ``main(argv, device="cpu")`` runs the plain
PyTorch path on host batches instead.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train Detect&Track (dtt_torch)")
    p.add_argument("--config", default=None, help="YAML config")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VAL",
                   help="dotted config overrides")
    p.add_argument("--dataset", default="imagenet_vid_train",
                   help="'+'-joined registered dataset names")
    p.add_argument("--data-root", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated mini-VID (no dataset required)")
    p.add_argument("--device-render", action="store_true",
                   help="with --synthetic: upload only KB-scale scene "
                        "parameters and draw the canvases on the card "
                        "inside the train step (dtt_torch.data.device_synth)")
    p.add_argument("--out", default="runs/dtt_torch")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --out")
    p.add_argument("--pretrained", default=None, metavar="PTH",
                   help="torchvision/caffe-style ResNet .pth for the backbone")
    p.add_argument("--calibrate-bn", action="store_true",
                   help="estimate the frozen-BN affines from one data batch "
                        "(LSUV-style); substitute for pretrained running "
                        "stats when training from scratch")
    p.add_argument("--num-workers", type=int, default=8,
                   help="threads preparing the frame pairs of --dataset")
    args = p.parse_args(argv)
    if args.device_render and not args.synthetic:
        p.error("--device-render only applies to --synthetic training "
                "(real datasets upload decoded frames)")
    if not args.synthetic and not args.data_root:
        p.exit(1, "--data-root required without --synthetic\n")
    return args


def batch_stream(args, cfg, batch: int):
    """The host batches of the chosen source and the PairLoader (or
    None)."""
    import numpy as np

    from dtt_torch.data.synthetic import sample_params_batch, synthetic_batch

    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    if not args.synthetic:
        import dtt_torch.data.imagenet_vid  # noqa: F401  (registers datasets)
        from dtt_torch.data.imdb import combined_roidb
        from dtt_torch.data.loader import PairLoader
        roidb = combined_roidb(args.dataset, root=args.data_root,
                               use_flipped=cfg.input.use_flipped)
        print(f"roidb: {len(roidb)} frame-pair entries from {args.dataset}")
        loader = PairLoader(roidb, cfg.input, batch, seed=cfg.train.seed,
                            num_workers=args.num_workers,
                            det_fraction=cfg.input.det_fraction)
        return iter(loader), loader

    rng = np.random.RandomState(cfg.train.seed)
    shape = (cfg.model.num_classes, cfg.input.max_gt_boxes)
    n_obj = cfg.input.synthetic_objects

    def batches():
        while True:
            if args.device_render:   # scene parameters only (~KB)
                yield sample_params_batch(rng, batch, h, w, *shape,
                                          num_objects=n_obj)
            else:                    # uint8 canvases, normalized on the card
                yield synthetic_batch(rng, batch, h, w, *shape,
                                      cfg.input.pixel_means, uint8=True,
                                      num_objects=n_obj)

    return batches(), None


def calibration_images(args, cfg, stream, batch: int):
    """The mean-subtracted (B, 2, H, W, 3) float32 pairs --calibrate-bn
    measures: the stream's first batch, or with --device-render (whose
    batches hold no pixels) one batch drawn on the host from
    ``RandomState(seed + 7)``, as train.py does."""
    import numpy as np

    from dtt_torch.data.synthetic import synthetic_batch
    if args.device_render:
        calib = synthetic_batch(np.random.RandomState(cfg.train.seed + 7),
                                batch, cfg.input.canvas_height,
                                cfg.input.canvas_width,
                                cfg.model.num_classes, cfg.input.max_gt_boxes,
                                cfg.input.pixel_means, uint8=True,
                                num_objects=cfg.input.synthetic_objects)
    else:
        calib = next(stream)
    imgs = np.asarray(calib["images"])
    if imgs.dtype == np.uint8:
        imgs = imgs.astype(np.float32) - np.asarray(cfg.input.pixel_means,
                                                    np.float32)
    return imgs


def main(argv=None, device=None):
    """Train (on CUDA unless `device` is "cpu"); returns the final
    state."""
    args = parse_args(argv)
    import torch

    from dtt_torch.core.config import load_config, save_config
    from dtt_torch.core.device import resolve_device
    from dtt_torch.data.device_synth import make_pair_render_fn
    from dtt_torch.data.loader import device_prefetch
    from dtt_torch.models.targets import sample_draws
    from dtt_torch.train.checkpoint import (latest_checkpoint,
                                            restore_checkpoint,
                                            save_checkpoint)
    from dtt_torch.train.trainer import create_train_state, make_train_step
    from dtt_torch.utils.calibrate import calibrate_model_backbone
    from dtt_torch.utils.logging import MetricLogger
    from dtt_torch.utils.torch_import import import_pretrained_backbone

    device = resolve_device(device)
    cfg = load_config(args.config, args.set)
    os.makedirs(args.out, exist_ok=True)
    save_config(cfg, os.path.join(args.out, "config.yml"))

    batch = cfg.train.batch_size_per_chip
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device={name}, batch={batch} frame-pairs, canvas={h}x{w}")
    stream, loader = batch_stream(args, cfg, batch)
    render_fn = (make_pair_render_fn(h, w, device) if args.device_render
                 else None)
    generator = torch.Generator(device=device).manual_seed(cfg.train.seed + 1)

    model, state = create_train_state(cfg, device)
    if args.pretrained:
        import_pretrained_backbone(args.pretrained, model)
        print(f"loaded pretrained backbone from {args.pretrained}")
    if args.calibrate_bn:
        imgs = calibration_images(args, cfg, stream, batch)
        calibrate_model_backbone(cfg, model, imgs)
        print("calibrated frozen-BN affines from one batch "
              f"({imgs.shape[0] * 2} frames)")
    if args.resume:
        ck = latest_checkpoint(args.out)
        if ck:
            state = restore_checkpoint(ck, state)
            print(f"resumed from {ck} at step {state.step}")
    step_fn = make_train_step(cfg, model, (h // 16, w // 16), device,
                              render_fn=render_fn)
    if device.type == "cuda":
        # decoded frames go up as bf16 for a bf16 model: lossless (its
        # first op is the same cast) and half the bytes
        cast = ({"images": torch.bfloat16} if loader is not None
                and cfg.model.dtype == "bfloat16" else None)
        stream = device_prefetch(stream, device, size=2, cast=cast)

    logger = MetricLogger(args.out, run_name=cfg.exp_name)
    timer_step, t0 = None, time.perf_counter()
    try:
        while state.step < cfg.train.total_steps:
            state, metrics = step_fn(state, next(stream),
                                     sample_draws(cfg, batch, generator,
                                                  device), generator)
            step = state.step
            if timer_step is None:       # rates from after the first step
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                timer_step, t0 = step, time.perf_counter()
            if step % cfg.train.log_every == 0 or step == 1:
                m = {k: round(float(v), 4) for k, v in metrics.items()}
                pps = (step - timer_step) * batch / max(
                    time.perf_counter() - t0, 1e-9)
                print(json.dumps(logger.log(
                    step, {"pairs_per_sec": round(pps, 2), **m})))
            if step % cfg.train.checkpoint_every == 0:
                print(f"checkpoint: {save_checkpoint(args.out, state, cfg)}")
    finally:
        stream.close()
        if loader is not None:
            loader.stop()
    save_checkpoint(args.out, state, cfg)
    print(f"done at step {state.step}")
    return state


if __name__ == "__main__":
    main()
