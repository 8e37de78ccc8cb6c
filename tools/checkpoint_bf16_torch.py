#!/usr/bin/env python
"""Carry a trained checkpoint's parameters as bf16 and rebuild a run dir
from them.

A ResNet-50 run's ``state.msgpack`` (parameters and momentum in float32)
is ~250 MB; its parameters rounded to bf16 (round to nearest even, the
cast the port and dtt make at use when ``model.dtype`` is bfloat16) and
deflated are ~50 MB. ``--pack`` writes the latest checkpoint of a run dir
(or a step dir) as an ``.npz`` of those bf16 bit patterns with the step
and the saved config; ``--unpack`` writes a run dir from it: float32
parameters that hold the bf16 values exactly, zero momentum, the step and
the config, in dtt's run-dir format, which both ``eval_torch.py`` and
``eval.py`` read. For a bf16 model every parameter is cast to bf16 at
use, so the rebuilt run dir scores as the original does; evaluating both
shows it::

    python tools/checkpoint_bf16_torch.py --pack RUN_DIR params_bf16.npz
    python tools/checkpoint_bf16_torch.py --unpack params_bf16.npz RUN_DIR2
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> the uint16 bit patterns of its bf16 rounding (nearest
    even, as ``torch``'s cast)."""
    import torch
    t = torch.from_numpy(np.array(x, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def from_bf16_bits(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns -> float32 holding those values exactly."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def pack(ckpt: str, out: str) -> None:
    from dtt_torch.train.checkpoint import _read, latest_checkpoint
    if os.path.exists(os.path.join(ckpt, "LATEST")):
        ckpt = latest_checkpoint(ckpt)
    state = _read(ckpt)
    with open(os.path.join(ckpt, "config.yml")) as f:
        config = f.read()
    arrays = {k: to_bf16_bits(v) for k, v in _flatten(state["params"]).items()}
    np.savez_compressed(out, __step__=np.asarray(state["step"], np.int64),
                        __config__=np.asarray(config), **arrays)
    print(f"packed {ckpt} (step {int(state['step'])}, "
          f"{sum(a.size for a in arrays.values())} parameters) into {out}: "
          f"{os.path.getsize(out) / 2 ** 20:.1f} MiB")


def unpack(npz: str, out: str) -> str:
    from dtt_torch.core.config import load_config
    from dtt_torch.train.checkpoint import save_checkpoint
    from dtt_torch.train.trainer import create_train_state
    with np.load(npz) as z:
        step = int(z["__step__"])
        config = str(z["__config__"])
        tree = _nest({k: from_bf16_bits(z[k]) for k in z.files
                      if not k.startswith("__")})
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "config.yml")
        with open(path, "w") as f:
            f.write(config)
        cfg = load_config(path)
    _, state = create_train_state(cfg, "cpu", tree=tree)
    state = state._replace(step=step)
    os.makedirs(out, exist_ok=True)
    path = save_checkpoint(out, state, cfg)
    with open(os.path.join(out, "config.yml"), "w") as f:
        f.write(config)
    print(f"unpacked {npz} (step {step}) into {path}")
    return path


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--pack", nargs=2, metavar=("CKPT", "NPZ"))
    g.add_argument("--unpack", nargs=2, metavar=("NPZ", "RUN_DIR"))
    a = p.parse_args()
    if a.pack:
        pack(*a.pack)
    else:
        unpack(*a.unpack)
    return 0


if __name__ == "__main__":
    sys.exit(main())
