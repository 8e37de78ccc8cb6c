"""Time the NMS kernel ``dtt_nms_select`` on one card, by CUDA events.

Imports ``dtt_torch`` from the tree at ``--root`` (default: this
checkout), so one call can time two trees in turns. The problems are
this checkout's ``tests/nms_cases.py``'s, made from seeds with numpy. Each case is first
held bit for bit against the plain block loop, then timed over
``--iters`` launches after two warm-up launches (``ms``: CUDA events
around the launches, the host's per-call cost included) and, after every
case is timed so, under ``torch.profiler`` (``device_ms``: the kernel's
own duration; the profiler slows later launches, so it comes last). Each
case prints one JSON line with its dependent steps (max over the
problems) and both times:

* ``path``: the calls of ``chip_smoke.py``'s paths at ``Config()``: a
  video chunk's proposals (16 x 6,000 -> 300) and per-class NMS (480 x 300
  -> 20), a frame's (1 x 6,000, 30 x 300), a train step's OHEM (2 x 330
  -> 128, unsorted losses);
* ``steps``: one frame's proposals (1 x 6,000, sorted) with 1, 32, 64,
  128 and 300 output slots: the fixed cost and the cost of a dependent
  step (the ``slope`` line: from 1 slot to 300, by both times);
* ``mask``: the same problem at IoU thresholds 2.0 (nothing suppressed:
  the walk ends at position 300), 0.1 (most suppressed: the walk goes
  through ~5,700 positions) and -1 (everything suppressed in the first
  step); and near-duplicate anchors at IoU 0.7 (``anchor_problem``:
  a hundred or so kept boxes suppress the rest, the walk goes through all
  6,000 positions), at 1 and 16 problems;
* ``order``: the same proposals in random order (the kernel sorts them),
  at 1 and 16 problems;
* ``model``: the NMS calls of one full-width video chunk (``Config()``,
  17 uint8 frames and weights from numpy seed 0, as ``chip_smoke.py``'s
  video path has them): each of its NMS calls (proposals, 6,000 -> 300
  a frame; per-class, 300 -> 20 a frame and class), captured from
  ``evaluate_snippet_video`` and replayed.

    python tools/bench_nms_torch.py --label change
    python tools/bench_nms_torch.py --root _chip_tree/parent --label parent
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys


def model_calls(ops) -> list:
    """The (args, kwargs) of each ``nms_cuda`` call of one full-width video
    chunk (``Config()``, 17 uint8 frames and weights from numpy seed 0), on
    the card; `ops` is the ``dtt_torch.ops.nms`` module to watch."""
    import numpy as np
    import torch
    from dtt_torch.core.config import Config
    from dtt_torch.eval.inference import evaluate_snippet_video, make_video_step
    from dtt_torch.utils.params import from_jax_params, init_jax_params
    cfg = Config()
    model = from_jax_params(init_jax_params(cfg.model, seed=0), cfg.model,
                            device="cuda")
    frames = np.random.RandomState(0).randint(
        0, 256, (17, cfg.input.canvas_height, cfg.input.canvas_width, 3)
    ).astype(np.uint8)
    im_hw = (cfg.input.canvas_height - 8, cfg.input.canvas_width - 48)
    step = make_video_step(cfg, model, 17)
    calls, real = [], ops.nms_cuda

    def spy(*a, **kw):
        calls.append((a, kw))
        return real(*a, **kw)
    spy.launches = 0                # nms_cuda counts by its module name
    ops.nms_cuda = spy
    try:   # uncaptured: a captured call's inputs hold no values
        evaluate_snippet_video(cfg, getattr(step, "eager", step), frames,
                               im_hw=im_hw)
        torch.cuda.synchronize()
    finally:
        ops.nms_cuda = real
    return calls


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--label", default="tree")
    p.add_argument("--iters", type=int, default=50)
    args = p.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("bench_nms_torch: no CUDA device is available", file=sys.stderr)
        return 1
    from dtt_torch.ops import nms as ops

    # the problems come from this checkout, so both trees get the same
    spec = importlib.util.spec_from_file_location(
        "nms_cases", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tests", "nms_cases.py"))
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()

    def on_card(c):
        return (torch.from_numpy(c["boxes"]).cuda(),
                torch.from_numpy(c["scores"]).cuda(), c["iou"], c["m"],
                torch.from_numpy(c["valid"]).cuda(), c["score"])

    def time_ms(fn):
        for _ in range(2):
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
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                fn()
            torch.cuda.synchronize()
        return sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "nms" in e.name) / 1e3 / args.iters

    mismatches = 0
    timed = []

    def run(group, name, c, block=32):
        nonlocal mismatches
        a = on_card(c)
        *got, steps = ops.nms_cuda(*a, select_block=block, return_steps=True)
        want = ops.nms_padded_fast_plain(*a, select_block=block)
        equal = all(torch.equal(x, y) for x, y in zip(got, want))
        mismatches += not equal
        fn = lambda: ops.nms_cuda(*a, select_block=block)  # noqa: E731
        layout = getattr(ops, "nms_layout", None)
        line = {"label": args.label, "group": group, "case": name,
                "P": a[1].shape[0], "K": a[1].shape[1], "M": a[3],
                "block": block, "steps": int(steps.max()), "ms": time_ms(fn),
                "bit_equal": equal, "card": card,
                "layout": layout(a[1].shape[1]).body if layout else None}
        timed.append((line, fn))
        return line

    frame = cases.path_problem("video_proposals", 1, 6000, 300, 0.7, -0.5,
                               seed=40)
    run("path", "video_proposals",
        cases.path_problem("video_proposals", 16, 6000, 300, 0.7, -0.5,
                           seed=41))
    run("path", "video_per_class",
        cases.path_problem("per_class", 480, 300, 20, 0.3, 1e-3, seed=42))
    run("path", "frame_proposals", frame)
    run("path", "frame_per_class",
        cases.path_problem("per_class", 30, 300, 20, 0.3, 1e-3, seed=43))
    run("path", "ohem", cases.path_problem("ohem", 2, 330, 128, 0.7, -0.5,
                                           seed=44))
    sweep = [run("steps", f"slots_{m}", dict(frame, m=m))
             for m in (1, 32, 64, 128, 300)]
    run("mask", "iou_2.0", dict(frame, iou=2.0))
    run("mask", "iou_0.1", dict(frame, iou=0.1))
    run("mask", "iou_-1", dict(frame, iou=-1.0))
    run("mask", "anchors_1", cases.anchor_problem(1, 6000, seed=47))
    run("mask", "anchors_16", cases.anchor_problem(16, 6000, seed=48))
    run("order", "unsorted_1", cases.permuted(frame, seed=45)[0])
    run("order", "unsorted_16", cases.permuted(cases.path_problem(
        "video_proposals", 16, 6000, 300, 0.7, -0.5, seed=41), seed=46)[0])
    for i, (a, _) in enumerate(model_calls(ops)):
        c = {"boxes": a[0].reshape(-1, *a[0].shape[-2:]).cpu().numpy(),
             "scores": a[1].float().reshape(-1, a[1].shape[-1]).cpu().numpy(),
             "iou": a[2], "m": a[3], "score": a[5]}
        c["valid"] = (np.ones(c["scores"].shape, bool) if a[4] is None else
                      a[4].reshape(c["scores"].shape).cpu().numpy())
        p, k = c["scores"].shape
        run("model", f"call_{i}_P{p}_K{k}", c, a[6])
    for line, fn in timed:
        line["device_ms"] = device_ms(fn)
        print(json.dumps(line), flush=True)
    first, last = sweep[0], sweep[-1]
    span = max(last["steps"] - first["steps"], 1)
    print(json.dumps({
        "label": args.label, "group": "steps", "case": "slope",
        "ms_fixed": first["ms"], "ms_per_step": (last["ms"] - first["ms"])
        / span, "device_ms_fixed": first["device_ms"],
        "device_ms_per_step": (last["device_ms"] - first["device_ms"]) / span,
        "card": card}), flush=True)
    return 1 if mismatches else 0


if __name__ == "__main__":
    sys.exit(main())
