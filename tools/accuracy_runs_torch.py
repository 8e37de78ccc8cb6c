#!/usr/bin/env python
"""Measure one of the port's accuracy runs on one CUDA card: run
``tools/run_mid_synth_torch.py``, ``run_hard_bench_torch.py`` or
``run_flagship_synth_torch.py`` with the given arguments, in this process,
and report what the run cost beside its verdict.

The train step is timed from the end of the first step to the end of the
last, both after a ``torch.cuda.synchronize()`` (the rate ``train_torch``
logs, taken over the whole run); the peak is
``torch.cuda.max_memory_allocated()`` over the run. Prints the card's
``nvidia-smi`` name and power limit first, then the tool's own output,
then one JSON line (also written to --json): ms a step, pairs/s, peak
GiB, the train and eval wall seconds, the last step's losses, the
projected time of the config's full step count, and the tool's exit
status. Exits with the tool's status::

    python tools/accuracy_runs_torch.py --json out/mid200.json \\
        mid_synth --out out/mid_synth_torch --steps 200
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [d for d in (os.path.dirname(HERE), HERE) if d not in sys.path]

TOOLS = {"mid_synth": "run_mid_synth_torch",
         "hard_bench": "run_hard_bench_torch",
         "flagship_synth": "run_flagship_synth_torch"}


def card() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()


class StepClock:
    """Wraps ``make_train_step`` so that the run's steps are timed: the
    clock starts after the first step and stops after the step that
    reaches ``train.total_steps``, each behind a synchronize; `metrics`
    keeps that last step's metrics as floats."""

    def __init__(self, trainer):
        import torch
        self.torch, self.trainer = torch, trainer
        self.make = trainer.make_train_step
        self.first = self.last = None
        self.t0 = self.t1 = None
        self.batch = None
        self.metrics = None

    def __enter__(self):
        def make(cfg, *a, **k):
            step_fn = self.make(cfg, *a, **k)
            self.batch = cfg.train.batch_size_per_chip

            def timed(state, *sa, **sk):
                state, metrics = step_fn(state, *sa, **sk)
                if self.first is None or state.step >= cfg.train.total_steps:
                    self.torch.cuda.synchronize()
                    now = time.perf_counter()
                    if self.first is None:
                        self.first, self.t0 = state.step, now
                    else:
                        self.last, self.t1 = state.step, now
                        self.metrics = {k: float(v)
                                        for k, v in metrics.items()}
                return state, metrics
            return timed
        self.trainer.make_train_step = make
        return self

    def __exit__(self, *exc):
        self.trainer.make_train_step = self.make

    def ms_per_step(self):
        if self.last is None:
            return None
        return (self.t1 - self.t0) * 1e3 / (self.last - self.first)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--json", default=None, help="also write the summary here")
    p.add_argument("tool", choices=sorted(TOOLS))
    p.add_argument("args", nargs=argparse.REMAINDER)
    a = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("accuracy_runs_torch: no CUDA device is available",
              file=sys.stderr)
        return 1
    import importlib

    import eval_torch
    import train_torch
    from dtt_torch.train import trainer
    name = card()
    print(f"card: {name}", flush=True)
    tool = importlib.import_module(TOOLS[a.tool])
    args = tool.parse_args(a.args)

    walls = {"train_s": 0.0, "eval_s": 0.0}

    def clocked(fn, key):
        def call(*c, **k):
            t0 = time.perf_counter()
            try:
                return fn(*c, **k)
            finally:
                torch.cuda.synchronize()
                walls[key] += time.perf_counter() - t0
        return call

    train_torch.main = clocked(train_torch.main, "train_s")
    eval_torch.main = clocked(eval_torch.main, "eval_s")
    torch.cuda.reset_peak_memory_stats()
    status, t0 = 0, time.perf_counter()
    with StepClock(trainer) as clock:
        try:
            tool.main(a.args)
        except SystemExit as e:
            status = e.code
            if isinstance(status, str):
                print(status, file=sys.stderr, flush=True)
    wall = time.perf_counter() - t0
    ms = clock.ms_per_step()
    summary = {
        "tool": a.tool, "argv": a.args, "card": name,
        "kind": torch.cuda.get_device_name(0),
        "steps_timed": (None if ms is None else clock.last - clock.first),
        "ms_per_step": ms,
        "pairs_per_s": None if ms is None else clock.batch * 1e3 / ms,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "wall_s": wall, **walls,
        "last_step": clock.last, "last_step_metrics": clock.metrics,
        "status": status}
    if ms is not None and a.tool != "hard_bench":
        from dtt_torch.core.config import load_config
        total = load_config(tool.CONFIG).train.total_steps
        summary["config_total_steps"] = total
        summary["projected_full_run_min"] = ms * total / 6e4
    line = json.dumps(summary)
    print(line, flush=True)
    if a.json:
        os.makedirs(os.path.dirname(os.path.abspath(a.json)), exist_ok=True)
        with open(a.json, "w") as f:
            f.write(line + "\n")
    return 0 if status in (0, None) else (status if isinstance(status, int)
                                          else 1)


if __name__ == "__main__":
    sys.exit(main())
