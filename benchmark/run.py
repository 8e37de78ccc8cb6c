"""One run of one cell of the benchmark of ``dtt_torch``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Sets up the cell (weights and traffic from the seed, the program built,
warmed up and captured), measures for ``--seconds``, checks what the
window produced against the plain reference, and prints one JSON line as
the last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; the numbers compared, each beside its limit, come last
there (``checks``) and as the last lines of standard error.

The cell's configuration, traffic, metric readers and limits are files
found by name (``benchmark/cells.py``). Exits non-zero without a result
where the card is missing, where JAX or the JAX package is loaded, or
where anything fails.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "dtt"}
CACHE = ROOT / ".bench_cache"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fixed_caches() -> None:
    """Every kernel cache inside the checkout, at fixed paths (the
    program's own kernels build into ``dtt_torch/_build/``)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def breakdown(trace) -> dict | None:
    """The device operations with the most time and the longest idle
    gaps of the traced stretch, each gap named by the benchmark's host
    span around it."""
    if trace is None or not trace.kernels:
        return None
    by_name: dict = {}
    for name, s, e, _ in trace.kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    for name, s, e in trace.copies:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    busy = sorted(trace.device_intervals())
    merged = []
    for s, e in busy:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = []
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = (e0 + s1) / 2
        inside = [(e - s, n) for n, s, e in trace.annotations if s <= mid <= e]
        label = min(inside)[1] if inside else "outside any span"
        gaps.append((s1 - e0, label))
    gaps = sorted(gaps, reverse=True)[:10]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, g / 1e6] for g, n in gaps]}


def main(argv=None) -> int:
    args = parse(argv)
    fixed_caches()
    sys.path.insert(0, str(ROOT))
    from benchmark import cells
    cell = cells.cell(ROOT, args.workload)
    import torch
    need = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {need} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    if line is None:
        return 3
    print(json.dumps(line), flush=True)
    return 0


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict | None:
    """Set-up, window, check and metrics of `cell` (as ``cells.cell``
    gives it): the result line, or None where a forbidden module is
    loaded once all of it has run. The numbers compared go to standard
    error last."""
    import torch
    from benchmark import cells
    from benchmark.trace import Spans
    from dtt_torch.core.config import config_from_dict
    cfg_dict = cell["config"]["config"]
    ctx = SimpleNamespace(cfg=config_from_dict(cfg_dict), cfg_dict=cfg_dict,
                          traffic=cell["traffic"], seed=seed, spans=Spans(),
                          workload=cell["workload"]["name"], device=device)
    root = cell.get("root", ROOT)
    limits = cell["limits"]
    kind = cells.load_module("kinds", cell["traffic"]["kind"], root)
    run = kind.make(ctx)
    print(f"set-up: imports {time.perf_counter() - T0:.2f} s", file=sys.stderr)
    run.setup()
    setup_s = time.perf_counter() - T0
    res = run.window(seconds, trace)
    count = cell["workload"]["chips"]
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                            else device),
                   "count": count, "memory_peak_bytes": int(run.peak_bytes)}
    checks, correct = compare(run.check(), limits)
    metrics = {}
    if trace:
        reading = SimpleNamespace(spans=ctx.spans, trace=run.device_trace,
                                  window=res, cfg=cfg_dict,
                                  traffic=cell["traffic"], run=run,
                                  root=root)
        for m in cell["per_layer"]:
            value = cells.load_module("metrics", m["name"], root).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tr = run.device_trace
        if tr is not None and tr.kernels:
            from benchmark.roofline import busy_ms
            device_info["busy_s"] = busy_ms(tr.device_intervals()) / 1e3
            device_info["window_s"] = tr.window_s
    else:
        values = dict(res["end_to_end"], setup_s=setup_s)
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics,
            "device": device_info}
    if trace:
        bd = breakdown(run.device_trace)
        if bd:
            line["breakdown"] = bd
    line["checks"] = checks
    # last, once everything this run loads (the kind, the check, the
    # metric readers) has been imported
    bad = loaded_forbidden()
    if bad:
        print(f"loaded in the run's process: {', '.join(bad)}",
              file=sys.stderr)
        return None
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return line


def compare(got: dict, limits: dict) -> tuple:
    """(checks, correct): each number of `got` that `limits` names,
    beside its limit, and whether none is over its limit."""
    checks = {name: {"value": got[name], "limit": limits[name]}
              for name in limits if not name.startswith("_")}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


if __name__ == "__main__":
    sys.exit(main())
