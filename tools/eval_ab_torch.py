"""Time the port's tau=1 ``--link`` evaluation (or, with ``--tau 2``, the
tau=2 pair-path evaluation), run for run, on one card.

Imports ``eval_torch`` and ``dtt_torch`` from the tree at ``--root``
(default: this checkout), so one script can time two trees in turns. The
full-width ``Config()`` weights from numpy seed 0 are written as a port
checkpoint; ``eval_torch.main`` then runs once on one snippet to warm up,
``--repeats`` times timed (1 snippet x 16 frames at tau=1 with tube
linking, or 2 snippets x 16 frames at tau=2 with the SAT pool, which link
their keyframes' tubes: ``chip_smoke.py``'s two eval runs), and once more
under ``torch.profiler``. Prints one JSON line per timed run (wall ms by phase)
and one for the profiled run (device kernels, device busy ms), and writes
the profiled run's kernel and operator counts by name to ``--out``::

    python tools/eval_ab_torch.py --label change --out counts.json
    python tools/eval_ab_torch.py --root _chip_tree/parent --label parent
    python tools/eval_ab_torch.py --tau 2 --label change
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

EVAL_FLAGS = {1: ["--synthetic", "--synthetic-snippets", "1",
                  "--synthetic-frames", "16", "--link"],
              2: ["--synthetic", "--synthetic-snippets", "2",
                  "--synthetic-frames", "16", "--tau", "2", "--set",
                  "model.roi.eval_pool_impl=pallas_mm"]}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--label", default="tree")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--tau", type=int, choices=sorted(EVAL_FLAGS), default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("eval_ab_torch: no CUDA device is available", file=sys.stderr)
        return 1
    import eval_torch
    from chip_smoke import busy_ms
    from torch.profiler import ProfilerActivity, profile

    from dtt_torch.core.config import Config
    from dtt_torch.train.checkpoint import save_checkpoint
    from dtt_torch.train.trainer import create_train_state
    from dtt_torch.utils.params import init_jax_params
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def run(argv):
        with contextlib.redirect_stdout(io.StringIO()):
            _, clock, pairs = eval_torch.main(argv)
        torch.cuda.synchronize()
        return clock, pairs

    cfg = Config()
    with tempfile.TemporaryDirectory() as d:
        _, state = create_train_state(
            cfg, "cuda", tree=init_jax_params(cfg.model, seed=0))
        save_checkpoint(d, state, cfg)
        del state
        argv = EVAL_FLAGS[args.tau] + ["--checkpoint", d]
        run(argv)
        for i in range(args.repeats):
            t0 = time.perf_counter()
            clock, pairs = run(argv)
            wall = (time.perf_counter() - t0) * 1e3
            print(json.dumps({"label": args.label, "tau": args.tau,
                              "repeat": i,
                              "wall_ms": round(wall, 2), "pairs": pairs,
                              **{k: round(v, 2) for k, v in clock.items()}}),
                  flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            clock, _ = run(argv)
            wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel: dict = {}
    for e in kernels:
        by_kernel[e.name] = by_kernel.get(e.name, 0) + 1
    ops = {e.key: e.count for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU}
    print(json.dumps({"label": args.label, "tau": args.tau,
                      "root": os.path.dirname(eval_torch.__file__),
                      "profiled_wall_ms": round(wall, 2),
                      "detect_ms": round(clock["detect"], 2),
                      "device_kernels": len(kernels),
                      "device_busy_ms": round(busy_ms(
                          (e.time_range.start, e.time_range.end)
                          for e in kernels), 3),
                      "cpu_ops": sum(ops.values())}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"kernels": by_kernel, "ops": ops}, f, indent=0,
                      sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
