"""Split the host's cost of one call of kernel 10 (the trunk's conv
epilogue, ``dtt_torch/ops/epilogue.py``) into its parts, on one CUDA card,
for one tree of the port, so that two trees can be split in turns in one
call.

    python3 tools/epilogue_host_torch.py [--root TREE] [--label L] \
        [--frames 1 2] [--rounds 20]

Imports ``dtt_torch`` from the tree at ``--root`` (default: this checkout).
For each frame count it records the epilogue calls of one ``Config()``
trunk call (ResNet-101 at 608x1088, bf16) on the meta device, makes their
inputs on the card, and times each part of a call call by call with the
host's ``perf_counter_ns``, cycling through the trunk's calls `--rounds`
times (100 calls a round), and prints one JSON line of medians in µs a
call: the parts of the wrapper (``parts``: the input checks, the buffer
checks, the output's allocation, the entry, device and stream, the ctypes
call that launches the kernel), the whole wrapper, the dispatcher
``conv_epilogue`` without a gradient, the backward wrapper, an eager
``torch.add`` of the same tensors (the yardstick of a PyTorch launch) and
an empty timed call (the timer); at a train step's trunk also the
dispatcher with a gradient (through ``_ConvEpilogue.apply``) and the
backward node alone (``_ConvEpilogue.backward``, the backward wrapper
included, without the autograd engine). The parts launch what the wrapper
launches; the card drains before each pass through the calls, so no
launch waits for room in the queue.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRUNK = (3, 4, 23, 3)                   # Config()'s ResNet-101
CANVAS = (608, 1088)


def card() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()


def trunk_calls(frames: int, layers=TRUNK, canvas=CANVAS,
                frozen_stages: int = 2) -> list:
    """(trained, form, shape) of each epilogue call of one trunk call on
    `frames` frames, recorded through the dispatcher on the meta device;
    trained: the call records a gradient (blocks past `frozen_stages`)."""
    import torch

    from dtt_torch.models.dnt import is_frozen
    from dtt_torch.models.resnet import ResNetBackbone
    from dtt_torch.ops import epilogue as epi
    with torch.device("meta"):
        bb = ResNetBackbone(layers, frozen_stages)
    for name, p in bb.named_parameters():
        p.requires_grad_(not is_frozen("backbone." + name, frozen_stages))
    seen = []

    def record(x, scale, bias, z=None, scale_z=None, bias_z=None):
        seen.append((x.requires_grad, epi.form_of(z, scale_z),
                     tuple(x.shape)))
        return epi.conv_epilogue_plain(x, scale, bias, z, scale_z, bias_z)

    with mock.patch.object(epi, "conv_epilogue", record):
        bb(torch.empty(frames, 3, *canvas, device="meta",
                       dtype=torch.bfloat16))
    return seen


def _median_us(fn, cases: list, rounds: int, sync) -> float:
    """The median of `fn(case)` over `rounds` passes through `cases`, µs a
    call by perf_counter_ns; the card drains before each pass, so a launch
    never waits for room in the queue."""
    ns = []
    clock = time.perf_counter_ns
    for _ in range(rounds):
        sync()
        for case in cases:
            t0 = clock()
            fn(case)
            ns.append(clock() - t0)
    sync()
    return statistics.median(ns) / 1e3


def parts(epi, torch) -> dict:
    """The wrapper's parts as this tree's ``epilogue`` module has them:
    name -> fn(case) for a case dict of x, s, b, z, t, c, form, c_."""
    cl = torch.channels_last
    name = "conv_epilogue_cuda"
    if hasattr(epi, "_check_params"):
        # a checkout before the launch path was cut: every call checks
        # its inputs and buffers, looks its entry up and sets the device
        def inputs(k):
            epi._check_input(name, k["x"])
            epi._check(name, k["x"])
            if k["z"] is not None:
                epi._check(name, k["z"], k["x"])

        def buffers(k):
            epi._check_params(name, k["c_"], k["x"].device, k["s"], k["b"],
                              *((k["t"], k["c"]) if k["form"] == "C"
                                else ()))

        def entry(k):
            epi._entry("dtt_conv_epilogue")
            torch._C._cuda_getCurrentRawStream(k["x"].get_device())

        def alloc(k):
            torch.empty_like(k["x"], memory_format=cl)

        fn = epi._entry("dtt_conv_epilogue")
        codes, forms = epi._DTYPE_CODES, epi.FORMS
        ptr = epi._ptr

        def call(k):
            x = k["x"]
            fn(x.data_ptr(), k["s"].data_ptr(), k["b"].data_ptr(),
               ptr(k["z"]), ptr(k["t"]), ptr(k["c"]), k["y"].data_ptr(),
               x.numel(), k["c_"], forms.index(k["form"]), codes[x.dtype],
               k["dev"], k["stream"])
    else:
        def inputs(k):
            epi._check_inputs(name, k["x"], k["z"])

        def buffers(k):
            epi._check_buffers(name, k["c_"], k["x"].device, k["s"], k["b"],
                               *(() if k["t"] is None else (k["t"], k["c"])))

        def entry(k):
            epi._device(name, k["x"])
            torch._C._cuda_getCurrentRawStream(k["dev"])

        def alloc(k):
            torch.empty_like(k["x"])

        fn = epi._entries()[0]
        codes = epi._CODES

        def call(k):
            x = k["x"]
            fn(x.data_ptr(), ptr(k["z"]), k["y"].data_ptr(),
               k["s"].data_ptr(), k["b"].data_ptr(), ptr(k["t"]),
               ptr(k["c"]), x.numel(), k["c_"], codes[k["form"], x.dtype],
               k["stream"])

        def ptr(t):
            return None if t is None else t.data_ptr()
    return {"inputs": inputs, "buffers": buffers, "alloc": alloc,
            "entry_stream": entry, "ctypes_call": call}


def host_split(epi, calls: list, rounds: int, dtype=None) -> dict:
    """Medians (µs a call) of the wrapper's parts and the yardsticks over
    `rounds` passes through `calls` ((trained, form, shape) a call), inputs
    made on the card; the gradient parts over the trained calls."""
    import torch
    dtype = dtype or torch.bfloat16
    cl = torch.channels_last
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    made, cases = {}, []
    for trained, form, shape in calls:
        key = (form, shape)
        if key not in made:
            def tensor():
                return torch.randn(shape, device="cuda", generator=gen).to(
                    dtype).contiguous(memory_format=cl)

            c_ = shape[1]
            buf = [torch.randn(c_, device="cuda", generator=gen)
                   for _ in range(4)]
            made[key] = {"x": tensor(), "s": buf[0], "b": buf[1],
                         "z": None if form == "A" else tensor(),
                         "t": buf[2] if form == "C" else None,
                         "c": buf[3] if form == "C" else None,
                         "form": form, "c_": c_, "dev": dev,
                         "stream": stream, "g": tensor()}
            made[key]["y"] = torch.empty_like(made[key]["x"])
        cases.append(dict(made[key], trained=trained))
    sync = torch.cuda.synchronize
    args = lambda k: (k["x"], k["s"], k["b"], k["z"], k["t"], k["c"])
    out = {}
    for part, fn in parts(epi, torch).items():
        out[part] = _median_us(fn, cases, rounds, sync)
    with torch.no_grad():
        out["wrapper"] = _median_us(
            lambda k: epi.conv_epilogue_cuda(*args(k)), cases, rounds, sync)
        out["dispatch_nograd"] = _median_us(
            lambda k: epi.conv_epilogue(*args(k)), cases, rounds, sync)
    out["bwd_wrapper"] = _median_us(
        lambda k: epi.conv_epilogue_bwd_cuda(k["g"], k["y"], k["s"],
                                             k["form"], k["t"]),
        cases, rounds, sync)
    out["torch_add"] = _median_us(
        lambda k: torch.add(k["x"], k["x"] if k["z"] is None else k["z"]),
        cases, rounds, sync)
    out["timer"] = _median_us(lambda k: None, cases, rounds, sync)
    leaves = {}
    for trained, form, shape in calls:
        if trained and (form, shape) not in leaves:
            leaves[form, shape] = made[form, shape]["x"].clone() \
                .requires_grad_()
    trained = [dict(made[f, s], x=leaves[f, s]) for t, f, s in calls if t]
    if trained:
        out["dispatch_grad"] = _median_us(
            lambda k: epi.conv_epilogue(*args(k)), trained, rounds, sync)
        # the backward node alone (``_ConvEpilogue.backward``), as the
        # autograd engine calls it, on an output made just before
        ns = []
        for _ in range(rounds):
            sync()
            for k in trained:
                y = epi.conv_epilogue(*args(k))
                t0 = time.perf_counter_ns()
                y.grad_fn.apply(k["g"])
                ns.append(time.perf_counter_ns() - t0)
                del y
        sync()
        out["node_bwd"] = statistics.median(ns) / 1e3
    out["calls"] = len(cases) * rounds
    out["trained_calls"] = len(trained) * rounds
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=HERE)
    p.add_argument("--label", default="change")
    p.add_argument("--frames", type=int, nargs="*", default=[1, 2])
    p.add_argument("--train-frames", type=int, nargs="*", default=[2],
                   help="frame counts split as a train step's trunk (its "
                        "trained calls also with a gradient)")
    p.add_argument("--rounds", type=int, default=20)
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("epilogue_host_torch: no CUDA device is available",
              file=sys.stderr)
        return 1
    from dtt_torch.ops import _build
    from dtt_torch.ops import epilogue as epi
    _build.build(["epilogue"])
    dev = card()
    for frames in args.frames:
        calls = [(trained and frames in args.train_frames, form, shape)
                 for trained, form, shape in trunk_calls(frames)]
        split = host_split(epi, calls, args.rounds)
        print(json.dumps({"label": args.label, "frames": frames,
                          "card": dev, "us": split}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
