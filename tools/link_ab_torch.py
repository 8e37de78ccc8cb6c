"""Time the tube-linking kernel ``dtt_link_tubes`` of one tree of the port
on one card, at the eval widths (30 classes, 20 slots, 20 tubes) and the
given snippet lengths, so that two trees can be timed in turns in one
call.

Imports ``dtt_torch`` from the tree at ``--root`` (default: this
checkout) and makes the detections with this checkout's
``tests/linking_cases.py``, so both trees link the same inputs. For each
length it holds the kernel against the plain form on the card (decisions
and tube scores bit for bit, rescored within 1e-6 (1 + |want|)) and
prints one JSON line: the CUDA-event ms of a ``link_cuda`` call (the
wrapper as a caller sees it, host work included), the kernel's device ms
by ``torch.profiler``, and ns a dependent step of the chain (K (T - 1)
frame steps and K T backtrack steps a class) by the device time.
``--exact`` builds a copy of the tree's kernel whose tame vote starts
from a test that is false at run time (T < 0), so every class takes the
exact NaN rule while both forms stay compiled as in the kernel (into
``_build/exact/`` of the tree), and times that; ``--direct`` plans every layout without the
links' ring, so that where the links sit in scratch the chain reads them
there::

    python tools/link_ab_torch.py --label change
    python tools/link_ab_torch.py --root _chip_tree/parent --label parent
    python tools/link_ab_torch.py --exact --label exact
    python tools/link_ab_torch.py --direct --label direct --frames 300 1400
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, N, K = 30, 20, 20
# the tame vote's start in linking.cu, and what --exact puts in its place:
# false at run time, but not a constant the compiler could fold (a
# constant false once built a kernel that stopped on an illegal
# instruction wherever an array sat in scratch)
TAME = ("  bool tame = T <= kTameFrames;", "  bool tame = T < 0;")


def exact_entry(root: str, linking, build):
    """``dtt_link_tubes`` of the tree at `root` with the tame vote forced
    off, built into ``<root>/dtt_torch/_build/exact/``."""
    with open(os.path.join(root, "dtt_torch", "ops", "csrc",
                           "linking.cu")) as f:
        text = f.read()
    if text.count(TAME[0]) != 1:
        raise RuntimeError("link_ab_torch: the tame vote is not in this "
                           "tree's linking.cu once")
    out = os.path.join(root, "dtt_torch", "_build", "exact")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "linking_exact.cu")
    with open(src, "w") as f:
        f.write(text.replace(*TAME))
    lib = os.path.join(out, "liblinking_exact.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src],
                   check=True)
    fn = ctypes.CDLL(lib).dtt_link_tubes
    fn.argtypes = linking._entry().argtypes
    fn.restype = ctypes.c_int
    return fn


def direct_layout(linking):
    """`linking.link_layout` planned without the links' ring."""
    def plan(t, n):
        sizes = linking._array_bytes(t, n, False)
        k, smem = linking._fit(sizes)
        return linking.LinkLayout("shared" if k == 0 else "scratch", smem,
                                  sum(sizes[:k]), len(sizes) - k,
                                  linking._ARRAYS[:k], False)
    return plan


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=HERE)
    p.add_argument("--label", default="tree")
    p.add_argument("--frames", type=int, nargs="*", default=[16, 8, 300])
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--exact", action="store_true",
                   help="time the kernel with the tame vote forced off")
    p.add_argument("--direct", action="store_true",
                   help="time the kernel with no ring for the links")
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("link_ab_torch: no CUDA device is available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from dtt_torch.eval import linking
    from dtt_torch.ops import _build
    if args.exact:
        exact = exact_entry(os.path.abspath(args.root), linking, _build)
        linking._entry = lambda: exact
    if args.direct:
        linking.link_layout = direct_layout(linking)
    spec = importlib.util.spec_from_file_location(
        "linking_cases", os.path.join(HERE, "tests", "linking_cases.py"))
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)

    def event_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.iters

    def device_ms(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                fn()
            torch.cuda.synchronize()
        return sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "link" in e.name) / 1e3 / args.iters

    failed = 0
    for t in args.frames:
        dets = cases.detections(seed=40 + t, c=C, t=t, n=N)
        a = tuple(torch.from_numpy(x).cuda() for x in dets)
        fn = lambda: linking.link_cuda(*a, max_tubes=K)  # noqa: E731
        got = fn()
        want = linking.link_all_classes_plain(*a, max_tubes=K)
        same = all(torch.equal(x.nan_to_num(0.0), y.nan_to_num(0.0))
                   for x, y in ((got.det_idx, want.det_idx),
                                (got.tube_valid, want.tube_valid),
                                (got.tube_score, want.tube_score),
                                (got.det_in_tube, want.det_in_tube)))
        d = (got.rescored - want.rescored).abs()
        same &= bool((d <= 1e-6 * (1 + want.rescored.abs())).all())
        failed += not same
        ms, dev = event_ms(fn), device_ms(fn)
        steps = K * (t - 1) + K * t
        layout = linking.link_layout(t, N)
        print(json.dumps({
            "label": args.label, "exact": args.exact,
            "direct": args.direct, "T": t, "C": C, "N": N, "K": K,
            "equal_to_plain": same, "event_ms": round(ms, 5),
            "device_ms": round(dev, 5), "chain_steps": steps,
            "ns_per_step": round(dev * 1e6 / steps, 2),
            "layout": layout.body,
            "in_scratch": list(getattr(layout, "in_scratch", ())),
            "ring": getattr(layout, "ring", None),
            "card": torch.cuda.get_device_name(0)}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
