"""Time kernel 10 (the trunk's conv epilogue,
``dtt_torch/ops/csrc/epilogue.cu``) of one tree of the port on one CUDA
card, at the calls one ``Config()`` trunk call makes on each path's frames,
so that two trees can be timed in turns in one call.

    python3 tools/epilogue_device_torch.py [--root TREE] [--label L] \
        [--paths video pair flag_train flag_train_bwd] [--per-call]

Imports ``dtt_torch`` from the tree at ``--root`` (default: this
checkout) and calls its wrappers (``conv_epilogue_cuda``,
``conv_epilogue_bwd_cuda``), each first held bit for bit against the plain
version at each distinct (form, shape) of the path. Then, in bf16 as the
trunk runs: the CUDA-event ms of all the path's calls (the mean of 10
passes after 2; at one or two frames the host's launches) and the device
ms of one pass by ``torch.profiler``, beside the bound of the bytes they
move (3.35 TB/s); beside them the same of an eager ``torch.add`` of each
call's two inputs (``add``, forward only: the bytes of form B), the
card's rate for PyTorch's own fused elementwise pass. Paths (frames of
one trunk call): ``video`` 17, ``parallel_video`` 18, ``pair`` 8,
``flag_train`` 16, ``train`` 2, ``frame`` 1; ``_bwd`` times the backward
at the trained calls. One JSON line a (path, run) on stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import epilogue_host_torch as host  # noqa: E402

FRAMES = {"video": 17, "parallel_video": 18, "pair": 8, "flag_train": 16,
          "train": 2, "frame": 1}
HBM_BYTES_PER_S = 3.35e12


def bound_ms(calls: list, esize: int, backward: bool) -> tuple:
    """(the least ms the card could take for `calls`, their bytes): each
    tensor read or written once, the buffers once."""
    nbytes = 0
    for _, form, shape in calls:
        n, c = 1, shape[1]
        for d in shape:
            n *= d
        if backward:
            nbytes += n * esize * (3 if form == "A" else 4) + 4 * c * (
                2 if form == "C" else 1)
        else:
            nbytes += n * esize * (2 if form == "A" else 3) + 4 * c * (
                4 if form == "C" else 2)
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=HERE)
    p.add_argument("--label", default="change")
    p.add_argument("--paths", nargs="*",
                   default=["video", "pair", "flag_train", "flag_train_bwd"])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--per-call", action="store_true",
                   help="also print each run's device µs and GB/s by "
                        "(form, shape) (a line a run)")
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("epilogue_device_torch: no CUDA device is available",
              file=sys.stderr)
        return 1
    from dtt_torch.ops import _build
    from dtt_torch.ops import epilogue as epi
    _build.build(["epilogue"])
    card = host.card()
    dtype, cl = torch.bfloat16, torch.channels_last
    esize = 2

    for path in args.paths:
        backward = path.endswith("_bwd")
        frames = FRAMES[path.removesuffix("_bwd")]
        calls = [c for c in host.trunk_calls(frames) if not backward or c[0]]
        gen = torch.Generator(device="cuda").manual_seed(3)
        made = {}
        for _, form, shape in calls:
            if (form, shape) in made:
                continue

            def tensor():
                return (torch.randn(shape, device="cuda", generator=gen)
                        * 2).to(dtype).contiguous(memory_format=cl)

            c = shape[1]
            bufs = [1 + 0.5 * torch.randn(c, device="cuda", generator=gen),
                    torch.randn(c, device="cuda", generator=gen),
                    1 + 0.5 * torch.randn(c, device="cuda", generator=gen),
                    torch.randn(c, device="cuda", generator=gen)]
            x = tensor()
            z = None if form == "A" and not backward else tensor()
            k = {"x": x, "z": z, "s": bufs[0], "b": bufs[1],
                 "t": bufs[2] if form == "C" else None,
                 "c": bufs[3] if form == "C" else None, "form": form}
            if backward:
                # g = x, y = the forward's output of (z, s, b)
                k["y"] = epi.conv_epilogue_plain(z, bufs[0], bufs[1])
                k["want"] = epi.conv_epilogue_bwd_plain(x, k["y"], bufs[0],
                                                        form, k["t"])
            else:
                k["want"] = (epi.conv_epilogue_plain(
                    x, k["s"], k["b"], z, k["t"], k["c"]),)
            made[form, shape] = k
        lim, nbytes = bound_ms(calls, esize, backward)

        if backward:
            kernel = lambda k: epi.conv_epilogue_bwd_cuda(
                k["x"], k["y"], k["s"], k["form"], k["t"])
        else:
            kernel = lambda k: (epi.conv_epilogue_cuda(
                k["x"], k["s"], k["b"], k["z"], k["t"], k["c"]),)
        for (form, shape), k in made.items():
            got = kernel(k)
            torch.cuda.synchronize()
            for a, b in zip(got, k["want"]):
                ints = torch.int16
                if not (a is None and b is None) and not torch.equal(
                        a.view(ints), b.view(ints)):
                    raise AssertionError(f"{path}: form {form} {shape} "
                                         f"not bit-equal")
        runs = [("kernel", kernel, ("epilogue_fwd", "epilogue_bwd"), lim,
                 nbytes)]
        if not backward:
            # torch.add(x, x) reads x once
            add_bytes = sum((2 if f == "A" else 3) * esize * int(np.prod(sh))
                            for _, f, sh in calls)
            runs.append(("add", lambda k: torch.add(
                k["x"], k["x"] if k["z"] is None else k["z"]), ("",),
                add_bytes / HBM_BYTES_PER_S * 1e3, add_bytes))
        seq = [made[f, s] for _, f, s in calls]
        timed = []
        for name, run, words, lim_, nbytes_ in runs:
            def one_pass(run=run):
                for k in seq:
                    run(k)

            for _ in range(2):
                one_pass()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.iters):
                one_pass()
            end.record()
            end.synchronize()
            timed.append(start.elapsed_time(end) / args.iters)
        # the profiler last: a traced card costs every later launch more
        for (name, run, words, lim_, nbytes_), ms in zip(runs, timed):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for k in seq:
                    run(k)
                torch.cuda.synchronize()
            kern = [e for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and any(w in e.name for w in words)]
            dev_us = sum(e.time_range.elapsed_us() for e in kern)
            if args.per_call and len(kern) == len(calls):
                by = {}
                for (_, f, sh), e in zip(calls, kern):
                    us, n = by.get((f, sh), (0.0, 0))
                    by[f, sh] = (us + e.time_range.elapsed_us(), n + 1)
                rows = []
                for (f, sh), (us, n) in by.items():
                    b = bound_ms([(False, f, sh)], esize, backward)[1]
                    if name == "add":
                        b = (2 if f == "A" else 3) * esize * int(np.prod(sh))
                    rows.append([f, list(sh), n, round(us / n, 2),
                                 round(b / (us / n) / 1e3, 1)])
                print(json.dumps({"label": args.label, "path": path,
                                  "run": name, "per_call": rows}),
                      flush=True)
            print(json.dumps({
                "label": args.label, "path": path, "run": name,
                "calls": len(calls), "ms": ms,
                "device_ms": dev_us / 1e3, "bound_ms": lim_,
                "gb": nbytes_ / 1e9, "share": lim_ / ms,
                "device_share": lim_ * 1e3 / dev_us if dev_us else None,
                "card": card}), flush=True)
        del made
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
