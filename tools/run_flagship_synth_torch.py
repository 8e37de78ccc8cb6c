#!/usr/bin/env python
"""Flagship-config accuracy evidence for dtt_torch on one CUDA card (the
counterpart of ``tools/run_flagship_synth.py``).

Trains configs/flagship_synth.yml (ResNet-101 dilated backbone, 31-way
heads, 608x1088 canvas, frozen_stages=2, full anchor lattice, OHEM +
tracking losses) from scratch on synthetic VID with ``train_torch
--device-render`` (scene parameters go up as KB, the canvases are drawn on
the card), then evaluates detection mAP with and without tube linking
with ``eval_torch`` on host-rendered snippets, both in this process, with
the arguments run_flagship_synth.py passes to train.py and eval.py.

Usage (on a CUDA card):  python tools/run_flagship_synth_torch.py
                         [--out DIR] [--steps N] [--resume] [--skip-train]
Prints one JSON line: {"mAP_link": ..., "mAP_nolink": ..., "uplift": ...}
and exits nonzero if mAP_link < 0.7 or linking hurt. ``main(argv,
device="cpu")`` runs both on the CPU instead.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _d in (ROOT, HERE):
    if _d not in sys.path:
        sys.path.insert(0, _d)

import eval_torch  # noqa: E402
import train_torch  # noqa: E402
from run_mid_synth_torch import gate, verdict  # noqa: E402

CONFIG = os.path.join(ROOT, "configs", "flagship_synth.yml")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "flagship_synth"))
    p.add_argument("--steps", type=int, default=None,
                   help="override train.total_steps")
    # 32 snippets ~= 64 object tracks over 30 classes; 8 (~16 tracks) make
    # per-class AP a coin flip (one missed track = -7 points of mAP)
    p.add_argument("--snippets", type=int, default=32)
    p.add_argument("--resume", action="store_true",
                   help="continue training an existing --out checkpoint")
    p.add_argument("--skip-train", action="store_true",
                   help="evaluate an existing --out checkpoint only")
    return p.parse_args(argv)


def train_argv(args) -> list:
    argv = ["--synthetic", "--device-render", "--config", CONFIG, "--out",
            args.out]
    argv += ["--resume"] if args.resume else ["--calibrate-bn"]
    if args.steps:
        argv += ["--set", f"train.total_steps={args.steps}"]
    return argv


def eval_argv(args) -> list:
    return ["--synthetic", "--checkpoint", args.out, "--synthetic-snippets",
            str(args.snippets), "--link"]


def run(args, device=None) -> dict:
    """Train (unless --skip-train) and evaluate; returns the eval's result
    dict."""
    if not args.skip_train:
        train_torch.main(train_argv(args), device=device)
    return eval_torch.main(eval_argv(args), device=device)[0]


def main(argv=None, device=None):
    res = run(parse_args(argv), device)
    print(json.dumps(verdict(res)))
    fail = gate(res)
    if fail:
        sys.exit(fail)
    print("PASS: flagship mAP >= 0.7 and linking did not hurt")


if __name__ == "__main__":
    main()
