#!/usr/bin/env python
"""Synthetic accuracy evidence for dtt_torch: mid-size from-scratch
training on one CUDA card (the counterpart of ``tools/run_mid_synth.py``).

Trains configs/mid_synth.yml (ResNet-50, half-flagship canvas, frozen-BN
affines calibrated from data) on synthetic VID with ``train_torch``, then
evaluates detection mAP with and without tube linking with
``eval_torch``, both in this process, with the arguments run_mid_synth.py
passes to train.py and eval.py.

Usage (on a CUDA card):  python tools/run_mid_synth_torch.py [--out DIR]
                         [--steps N] [--skip-train]
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import eval_torch  # noqa: E402
import train_torch  # noqa: E402

CONFIG = os.path.join(ROOT, "configs", "mid_synth.yml")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "mid_synth"))
    p.add_argument("--steps", type=int, default=None,
                   help="override train.total_steps")
    p.add_argument("--snippets", type=int, default=8)
    p.add_argument("--skip-train", action="store_true",
                   help="evaluate an existing --out checkpoint only")
    return p.parse_args(argv)


def train_argv(args) -> list:
    argv = ["--synthetic", "--config", CONFIG, "--calibrate-bn", "--out",
            args.out]
    if args.steps:
        argv += ["--set", f"train.total_steps={args.steps}"]
    return argv


def eval_argv(args) -> list:
    return ["--synthetic", "--checkpoint", args.out, "--synthetic-snippets",
            str(args.snippets), "--link"]


def verdict(res: dict) -> dict:
    """The verdict line of one linked eval result (both mAPs, one pass)."""
    nolink, link = res["mAP_nolink"], res["mAP"]
    return {"mAP_link": round(link, 4), "mAP_nolink": round(nolink, 4),
            "uplift": round(link - nolink, 4)}


def gate(res: dict) -> str | None:
    """The failure message of the eval result `res`, or None if it
    passes: mAP with linking >= 0.7, and linking did not hurt."""
    nolink, link = res["mAP_nolink"], res["mAP"]
    if link < 0.7:
        return f"FAIL: mAP with linking {link:.4f} < 0.7"
    if link < nolink:
        return f"FAIL: linking hurt mAP ({link:.4f} < {nolink:.4f})"
    return None


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
    print("PASS: mAP >= 0.7 and linking did not hurt")


if __name__ == "__main__":
    main()
