"""Time a full-width checkpoint's write and read on one card, stage by
stage: where an evaluation's start-up goes.

The ``Config()`` state (ResNet-101, 608x1088, f32 parameters and their
momentum, from numpy seed 0) is written as a run dir; then, each
``--repeats`` times (the median is printed), ``save_checkpoint``,
``restore_checkpoint`` into a fresh state, ``restore_params_only`` split
into the file's map and parse, the flax-to-torch layout (float32 copies
on the host) and ``load_state_dict`` onto the card, and
``eval_torch.load_model`` whole; beside them the same parameters through
``torch.save`` / ``torch.load(mmap=True)`` and ``load_state_dict``, the
state-dict file the port wrote before it took dtt's run-dir format::

    python tools/bench_checkpoint_torch.py [--repeats 5]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def timed(fn, repeats: int) -> tuple:
    """(median wall ms of `fn` ending in a synchronize, its last result)."""
    import torch
    times, out = [], None
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--repeats", type=int, default=5)
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bench_checkpoint_torch: no CUDA device", file=sys.stderr)
        return 1
    import eval_torch
    from dtt_torch.core.config import Config
    from dtt_torch.models.dnt import make_model
    from dtt_torch.train import checkpoint as ck
    from dtt_torch.train.trainer import create_train_state
    from dtt_torch.utils.params import torch_values

    card = subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cfg = Config()
    _, state = create_train_state(cfg, "cuda")
    for group in state.optimizer.param_groups:
        for p_ in group["params"]:
            state.optimizer.state[p_]["momentum_buffer"] = torch.zeros_like(
                p_)
    model = make_model(cfg.model, "cuda")
    ms = {}
    with tempfile.TemporaryDirectory() as d:
        ms["save_checkpoint"], path = timed(
            lambda: ck.save_checkpoint(d, state, cfg), args.repeats)
        _, fresh = create_train_state(cfg, "cuda")
        ms["restore_checkpoint"], _ = timed(
            lambda: ck.restore_checkpoint(path, fresh), args.repeats)
        ms["params: map + parse"], raw = timed(lambda: ck._read(path),
                                               args.repeats)
        ms["params: layout (host)"], values = timed(
            lambda: torch_values(model, raw["params"]["params"]),
            args.repeats)
        ms["params: load_state_dict"], _ = timed(
            lambda: model.load_state_dict(values), args.repeats)
        ms["restore_params_only"], _ = timed(
            lambda: ck.restore_params_only(path, model), args.repeats)
        ms["eval_torch.load_model"], _ = timed(
            lambda: eval_torch.load_model(eval_torch.parse_args(
                ["--synthetic", "--checkpoint", d]), "cuda"), args.repeats)
        pt = os.path.join(d, "state.pt")
        ms["state.pt: torch.save"], _ = timed(
            lambda: torch.save(model.state_dict(), pt), args.repeats)
        ms["state.pt: load(mmap) + load_state_dict"], _ = timed(
            lambda: model.load_state_dict(torch.load(
                pt, map_location="cpu", weights_only=True, mmap=True)),
            args.repeats)
        mib = os.path.getsize(os.path.join(path, "state.msgpack")) / 2**20
    print(json.dumps({"card": card, "state_msgpack_mib": round(mib, 1),
                      "median_ms": {k: round(v, 1) for k, v in ms.items()},
                      "repeats": args.repeats}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
