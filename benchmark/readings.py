"""Readings behind a cell's limits: the judged numbers of the program
and of the control, seed by seed, in one process.

    python3 benchmark/readings.py --workload <cell> --seconds 4 \\
        --seeds 11 12 13 [--control] [--out readings.jsonl]

For each seed: the cell's set-up, a window of ``--seconds`` at the
cell's own load, and the check of what it produced (the program's
readings, which set each limit's lower end). With ``--control`` the
control is judged on the same sample: the plain reference in float8
(``reference.dnt.Precision("fp8")``) in the program's place, its own
trunk and its own proposals, and tube linking by the reference in float8
on the same detections (the upper ends). Not run by the benchmark's
runs; prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from benchmark import cells, run as brun
    from benchmark.trace import Spans
    from dtt_torch.core.config import config_from_dict
    brun.fixed_caches()
    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 2
    cell = cells.cell(ROOT, args.workload)
    cfg_dict = cell["config"]["config"]
    kind = cells.load_module("kinds", cell["traffic"]["kind"], ROOT)
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = SimpleNamespace(cfg=config_from_dict(cfg_dict),
                              cfg_dict=cfg_dict, traffic=cell["traffic"],
                              seed=seed, spans=Spans(),
                              workload=args.workload, device="cuda")
        run = kind.make(ctx)
        run.setup()
        res = run.window(args.seconds, False)
        line = {"seed": seed, "pairs": res["pairs"],
                "rate": res["end_to_end"], "program": run.check()}
        line["correct"] = brun.compare(line["program"], cell["limits"])[1]
        if args.control:
            line["control"] = run.control()
            line["control_correct"] = brun.compare(line["control"],
                                                   cell["limits"])[1]
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
