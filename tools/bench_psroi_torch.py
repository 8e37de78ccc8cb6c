"""Time the port's direct PSRoI pool kernels on one card, by CUDA events and
by the device's own kernel times.

Imports ``dtt_torch`` and ``chip_smoke`` from the tree at ``--root``
(default: this checkout), so one call can time two trees in turns. At the
shapes ``chip_smoke.py`` holds them to (``Config()``: a video chunk's pool
call, 16 frames x 300 RoIs at D = 43; a train step's three, 2 x 330 x 31,
2 x 330 x 8 and 1 x 330 x 4; bf16 maps, chip_smoke's random RoIs), it
checks the forward ``psroi_sums_cuda`` and the backward ``psroi_bwd_cuda``
against their plain versions, then prints one JSON line per (kernel,
path): ``event_ms``, CUDA events around ``--iters`` groups of calls as
``chip_smoke.py`` times them (host launch gaps included), and
``device_ms``, the summed durations of the group's device kernels under
``torch.profiler`` (the kernels alone), with each call's share::

    python tools/bench_psroi_torch.py --label change
    python tools/bench_psroi_torch.py --root _chip_tree/parent --label parent
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--label", default="tree")
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("bench_psroi_torch: no CUDA device is available",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from dtt_torch.core.config import Config
    from dtt_torch.ops import psroi as ops

    cfg = Config()
    k = cfg.model.roi.ps_grid
    h, w = cfg.input.canvas_height // 16, cfg.input.canvas_width // 16
    bf16 = torch.bfloat16

    def device_ms(fn) -> tuple:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                fn()
            torch.cuda.synchronize()
        kernels = sorted((e.time_range.start, e.time_range.elapsed_us())
                         for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
        n = len(kernels) // args.iters
        per_call = [sum(us for _, us in kernels[j::n]) / 1e3 / args.iters
                    for j in range(n)]
        return sum(per_call), per_call

    def report(name, path, err, fn):
        ev = cs.time_ms(fn, iters=args.iters)
        dev, per_call = device_ms(fn)
        print(json.dumps({"label": args.label, "kernel": name, "path": path,
                          "max_abs_err": err, "event_ms": round(ev, 5),
                          "device_ms": round(dev, 5),
                          "device_ms_per_call": [round(t, 5)
                                                 for t in per_call]}),
              flush=True)

    for path, seed in (("video", 3), ("train", 4)):
        cases = cs.pool_cases(cfg, path)
        g = torch.Generator(device="cuda").manual_seed(seed)
        inputs = [(torch.randn(b, h, w, k * k * d, device="cuda",
                               generator=g).to(bf16), bd)
                  for (b, _, d), bd in zip(cases,
                                           cs.pool_bounds(cfg, cases, seed))]
        err = max((ops.psroi_sums_cuda(mp, *bd)
                   - ops.psroi_sums_plain(mp, *bd)).abs().max().item()
                  for mp, bd in inputs)
        if not err <= cs.PSROI_TOL:
            raise AssertionError(f"forward {path}: max abs err {err}")
        report("psroi_direct", path, err,
               lambda: [ops.psroi_sums_cuda(mp, *bd) for mp, bd in inputs])
        if path != "train":
            continue
        grads = []
        for (b, n, d), (_, bd) in zip(cases, inputs):
            area = ops.bin_areas(*bd)[..., None]
            go = torch.randn(b, n, k, k, d, device="cuda", generator=g)
            grads.append((torch.where(area > 0, go / area.clamp(min=1.0),
                                      0.0).contiguous(), bd))
        err = 0.0
        for gh, bd in grads:
            got = ops.psroi_bwd_cuda(gh, *bd, h, w, bf16).float()
            want = ops.psroi_bwd_plain(gh, *bd, h, w, bf16).float()
            e = (got - want).abs().max().item()
            if not e <= cs.BWD_REL_TOL * want.abs().max().item():
                raise AssertionError(f"backward: max abs err {e}")
            err = max(err, e)
        report("psroi_direct_bwd", path, err,
               lambda: [ops.psroi_bwd_cuda(gh, *bd, h, w, bf16)
                        for gh, bd in grads])
    return 0


if __name__ == "__main__":
    sys.exit(main())
