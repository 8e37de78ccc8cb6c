#!/usr/bin/env python
"""Train the D&T model with dtt_torch on one CUDA card (the PyTorch
counterpart of ``train.py --synthetic``).

Example:
  python train_torch.py --synthetic --set train.total_steps=50 --out runs/dtt_torch

Trains on the synthetic mini-VID drawn from ``train.seed`` (uint8 pairs,
normalized on the card), from flax-layout random weights drawn from the
same seed. Logs one JSON line every ``train.log_every`` steps (and after
the first) with pairs/s and the losses, checkpoints every
``train.checkpoint_every`` steps and at the end, and resumes from the
latest checkpoint in --out with --resume. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

# options of train.py the port does not implement yet, and where ROADMAP.md
# queues them
_NOT_PORTED = {
    "device_render": "--device-render (device-side synthetic rendering; "
                     "ROADMAP.md Queue 1 item 10)",
    "pretrained": "--pretrained (reference .pth import; ROADMAP.md Queue 1 "
                  "item 13)",
    "calibrate_bn": "--calibrate-bn (LSUV BN calibration; ROADMAP.md Queue 1 "
                    "item 13)",
    "dataset": "--dataset (ImageNet VID loading; ROADMAP.md Queue 1 item 10)",
    "data_root": "--data-root (ImageNet VID loading; ROADMAP.md Queue 1 "
                 "item 10)",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train Detect&Track (dtt_torch)")
    p.add_argument("--config", default=None, help="YAML config")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VAL",
                   help="dotted config overrides")
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated mini-VID (the only data source "
                        "the port has)")
    p.add_argument("--out", default="runs/dtt_torch")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --out")
    p.add_argument("--device-render", action="store_true")
    p.add_argument("--pretrained", default=None, metavar="PTH")
    p.add_argument("--calibrate-bn", action="store_true")
    p.add_argument("--dataset", default=None)
    p.add_argument("--data-root", default=None)
    args = p.parse_args(argv)
    for name, what in _NOT_PORTED.items():
        if getattr(args, name):
            p.error(f"{what} is not ported to dtt_torch yet")
    if not args.synthetic:
        p.error("dtt_torch trains on --synthetic data only (ImageNet VID "
                "loading: ROADMAP.md Queue 1 item 10)")
    return args


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from dtt_torch.core.config import load_config
    from dtt_torch.core.device import resolve_device
    from dtt_torch.data.synthetic import synthetic_batch
    from dtt_torch.models.targets import sample_draws
    from dtt_torch.train.checkpoint import (latest_checkpoint,
                                            restore_checkpoint,
                                            save_checkpoint)
    from dtt_torch.train.trainer import create_train_state, make_train_step
    from dtt_torch.utils.logging import MetricLogger

    device = resolve_device()
    cfg = load_config(args.config, args.set)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)

    batch = cfg.train.batch_size_per_chip
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    print(f"device={torch.cuda.get_device_name(device)}, batch={batch} "
          f"frame-pairs, canvas={h}x{w}")
    rng = np.random.RandomState(cfg.train.seed)
    generator = torch.Generator(device=device).manual_seed(cfg.train.seed + 1)

    model, state = create_train_state(cfg, device)
    if args.resume:
        ck = latest_checkpoint(args.out)
        if ck:
            state = restore_checkpoint(ck, state)
            print(f"resumed from {ck} at step {state.step}")
    step_fn = make_train_step(cfg, model, (h // 16, w // 16), device)

    logger = MetricLogger(args.out, run_name=cfg.exp_name)
    timer_step, t0 = None, time.perf_counter()
    while state.step < cfg.train.total_steps:
        host = synthetic_batch(rng, batch, h, w, cfg.model.num_classes,
                               cfg.input.max_gt_boxes, cfg.input.pixel_means,
                               uint8=True,
                               num_objects=cfg.input.synthetic_objects)
        state, metrics = step_fn(state, host,
                                 sample_draws(cfg, batch, generator, device))
        step = state.step
        if timer_step is None:       # rates from after the first step
            torch.cuda.synchronize(device)
            timer_step, t0 = step, time.perf_counter()
        if step % cfg.train.log_every == 0 or step == 1:
            m = {k: round(float(v), 4) for k, v in metrics.items()}
            pps = (step - timer_step) * batch / max(time.perf_counter() - t0,
                                                    1e-9)
            print(json.dumps(logger.log(step, {"pairs_per_sec": round(pps, 2),
                                               **m})))
        if step % cfg.train.checkpoint_every == 0:
            print(f"checkpoint: {save_checkpoint(args.out, state, cfg)}")
    save_checkpoint(args.out, state, cfg)
    print(f"done at step {state.step}")


if __name__ == "__main__":
    main()
