"""Run train_torch.py and eval_torch.py at full width (``Config()``) as
one process and under torchrun, and compare their outputs.

    python3 tools/check_torchrun_torch.py [--nproc 1] [--steps 3]

1. ``train_torch.py --synthetic`` for --steps steps, once as one process
   and once under ``torchrun --standalone --nproc_per_node=N`` with
   ``train.batch_size_per_chip`` divided by N (the same global batch):
   each step's logged losses must agree to the log's 4 decimals, one unit
   of the last allowed for a value that rounds the other way (N = 1: the
   same arithmetic; N > 1 sums the batch in another order).
2. ``eval_torch.py --synthetic`` on the one-process run's checkpoint, at
   tau=1 with --link and at tau=2, once as one process and once with
   --parallel under torchrun: the printed mAP lines must agree to their 4
   decimals.

Prints each command's wall time and the comparison, then one JSON line.
Needs N CUDA cards (one H100 runs N = 1).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSSES = ("total", "rpn_cls", "rpn_box", "rfcn_cls", "rfcn_box", "track",
          "num_fg", "fg_ce")
TOL = 1.0001e-4      # one unit of the 4th decimal the outputs print


def run(cmd: list, torchrun: int = 0) -> str:
    if torchrun:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={torchrun}", *cmd]
    else:
        cmd = [sys.executable, *cmd]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=900)
    print(f"{' '.join(cmd[1:])}: rc {out.returncode} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if out.returncode:
        print(out.stdout[-4000:], out.stderr[-4000:], sep="\n")
        raise SystemExit(f"command failed: {cmd}")
    return out.stdout


def rows(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--nproc", type=int, default=1)
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args()
    n = args.nproc
    worst = {}
    with tempfile.TemporaryDirectory() as d:
        one, par = os.path.join(d, "one"), os.path.join(d, "par")
        base = ["train_torch.py", "--synthetic", "--set",
                f"train.total_steps={args.steps}", "train.log_every=1"]
        run(base + [f"train.batch_size_per_chip={n}", "--out", one])
        run(base + ["train.batch_size_per_chip=1", "--out", par], n)
        a, b = rows(os.path.join(one, "metrics.jsonl")), rows(
            os.path.join(par, "metrics.jsonl"))
        if [r["step"] for r in a] != [r["step"] for r in b]:
            raise SystemExit(f"logged steps differ: {a} vs {b}")
        worst["train"] = max(abs(x[k] - y[k]) for x, y in zip(a, b)
                             for k in LOSSES)
        print(f"train: {len(a)} logged steps, worst |d loss| "
              f"{worst['train']:.3g} (tol {TOL}); losses one process "
              f"{[r['total'] for r in a]}, torchrun {[r['total'] for r in b]}")
        for name, flags in (("eval_link", ["--link"]),
                            ("eval_tau2", ["--tau", "2"])):
            cmd = ["eval_torch.py", "--synthetic", "--checkpoint", one,
                   *flags]
            x = json.loads(run(cmd).strip().splitlines()[-1])
            y = json.loads(run(cmd + ["--parallel"], n).strip()
                           .splitlines()[-1])
            if set(x) != set(y):
                raise SystemExit(f"{name}: keys differ: {x} vs {y}")
            if any(x[k] != y[k] for k in x if not isinstance(x[k], float)):
                raise SystemExit(f"{name}: outputs differ: {x} vs {y}")
            worst[name] = max((abs(x[k] - y[k]) for k in x
                               if isinstance(x[k], float)), default=0.0)
            print(f"{name}: mAP {x['mAP']} one process, {y['mAP']} "
                  f"--parallel; worst |d| {worst[name]:.3g} (tol {TOL})")
    ok = all(v <= TOL for v in worst.values())
    print(json.dumps({"nproc": n, "worst": worst, "tol": TOL, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
