"""What ProcessGroupNCCL does inside a CUDA graph capture, at one rank on
one card: each case in a fresh process (its environment read when the
group is made), one NCCL rank on an in-process ``HashStore``.

    python3 tools/probe_nccl_capture_torch.py [--out DIR]

Cases: the collectives the parallel steps capture (an in-place SUM
all-reduce, ``all_gather`` into a list, both together), an AVG
all-reduce, an async work object waited on inside the capture, its
``is_completed()`` queried there, a capture whose group has made no
collective yet (no communicator), and the first case again under
``TORCH_NCCL_ASYNC_ERROR_HANDLING=0`` and under
``TORCH_NCCL_BLOCKING_WAIT=1`` (a send and receive of the rank to itself
inside a capture hung past 300 s on an H100 and is left out). Each prints
one JSON line: whether the capture succeeded (else its error; a case
that does not end in 90 s prints "hung"), the graph's nodes by type and its
kernels by name (``CUDAGraph.debug_dump``), the device events of three
profiled replays by name, whether the replays gave the right values,
whether eager collectives still work after the replays, and the NCCL
environment. With --out, each graph's DOT file is kept there.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import time

CASES = {"sum": {}, "gather": {}, "sum_gather": {}, "avg": {},
         "work_wait": {}, "work_query": {}, "no_warmup": {},
         "sum_async_error_0": {"TORCH_NCCL_ASYNC_ERROR_HANDLING": "0"},
         "sum_blocking_wait": {"TORCH_NCCL_BLOCKING_WAIT": "1"}}
ENV_KEYS = ("TORCH_NCCL_ASYNC_ERROR_HANDLING", "TORCH_NCCL_BLOCKING_WAIT",
            "TORCH_NCCL_AVOID_RECORD_STREAMS", "NCCL_GRAPH_MIXING_SUPPORT",
            "TORCH_NCCL_USE_COMM_NONBLOCKING")
N = 1 << 20


def dot_summary(path: str) -> dict:
    """Node types and kernel names of a graph's DOT dump."""
    text = open(path).read()
    kinds = collections.Counter(re.findall(r"\b(KERNEL|MEMCPY|MEMSET|"
                                           r"EVENT_RECORD|WAIT_EVENT|"
                                           r"MEM_ALLOC|MEM_FREE|HOST|EMPTY|"
                                           r"CONDITIONAL|GRAPH)\b", text))
    names = collections.Counter(
        n[:80] for n in re.findall(r"[A-Za-z_]\w{3,}", text)
        if "nccl" in n.lower() or "kernel" in n.lower())
    return {"node_kinds": dict(kinds), "names": dict(names.most_common(16)),
            "nccl_in_dot": text.lower().count("nccl")}


def run_case(name: str, out_dir: str | None) -> dict:
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.set_device(0)
    res = {"case": name, "env": {k: os.environ.get(k) for k in ENV_KEYS},
           "torch": torch.__version__, "nccl": ".".join(
               map(str, torch.cuda.nccl.version()))}
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1,
                            rank=0)
    x = torch.ones(N, device="cuda")
    part = torch.arange(N, dtype=torch.float32, device="cuda")
    gathered = [torch.empty_like(part)]
    if name != "no_warmup":
        dist.all_reduce(x)          # the communicator is made here
        torch.cuda.synchronize()
    seen = {}

    def body():
        if name.startswith("sum"):
            dist.all_reduce(x)
        if name in ("gather", "sum_gather"):
            dist.all_gather(gathered, part)
        if name == "avg":
            dist.all_reduce(x, op=dist.ReduceOp.AVG)
        if name.startswith("work"):
            work = dist.all_reduce(x, async_op=True)
            seen["work"] = type(work).__name__
            if name == "work_query":
                try:
                    seen["is_completed"] = work.is_completed()
                except Exception as e:      # noqa: BLE001 - recorded
                    seen["is_completed"] = repr(e)[:300]
            seen["wait"] = work.wait()
        if name == "no_warmup":
            dist.all_reduce(x)
        return x * 2

    side = torch.cuda.Stream()
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        graph = torch.cuda.CUDAGraph()
    graph.enable_debug_mode()
    t0 = time.perf_counter()
    try:
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            y = body()
        res["captured"] = True
    except Exception as e:      # noqa: BLE001 - the finding
        res["captured"] = False
        res["capture_error"] = repr(e)[:600]
    res["capture_ms"] = (time.perf_counter() - t0) * 1e3
    res.update(inside=seen)
    if res["captured"]:
        path = os.path.abspath(os.path.join(out_dir or ".", f"{name}.dot"))
        try:
            graph.debug_dump(path)
            res["graph"] = dot_summary(path)
            if out_dir is None:
                os.remove(path)
        except Exception as e:      # noqa: BLE001 - recorded
            res["graph"] = repr(e)[:300]
        if hasattr(graph, "instantiate"):
            graph.instantiate()
        ok = True
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(3):
                part.fill_(float(i + 1))
                graph.replay()
            torch.cuda.synchronize()
        if name in ("gather", "sum_gather"):
            ok &= bool((gathered[0] == 3.0).all())
        ok &= bool((y == 2 * x).all())
        res["replay_values_ok"] = ok
        dev = collections.Counter(
            e.name[:80] for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
        res["profiled_device_events"] = dict(dev)
        res["profiled_cpu_collectives"] = sorted({
            e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CPU
            and ("nccl" in e.name.lower() or "c10d" in e.name.lower())})
    try:
        dist.all_reduce(x)
        out = [torch.empty_like(part)]
        dist.all_gather(out, part)
        torch.cuda.synchronize()
        res["eager_after"] = "ok"
    except Exception as e:      # noqa: BLE001 - recorded
        res["eager_after"] = repr(e)[:300]
    time.sleep(2)               # the watchdog thread looks at the works
    dist.destroy_process_group()
    res["destroyed"] = True
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out")
    p.add_argument("--case", help="run one case in this process")
    args = p.parse_args(argv)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.case:
        print(json.dumps(run_case(args.case, args.out)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    for name, env in CASES.items():
        cmd = [sys.executable, os.path.abspath(__file__), "--case", name]
        if args.out:
            cmd += ["--out", args.out]
        try:
            proc = subprocess.run(cmd, env={**os.environ, **env},
                                  capture_output=True, text=True, timeout=90)
        except subprocess.TimeoutExpired:
            print(json.dumps({"case": name, "hung": True}), flush=True)
            continue
        lines = proc.stdout.strip().splitlines()
        if proc.returncode or not lines:
            print(json.dumps({"case": name, "rc": proc.returncode,
                              "stderr": proc.stderr[-1500:]}), flush=True)
        else:
            print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
