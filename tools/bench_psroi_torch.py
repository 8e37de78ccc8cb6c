"""Time the port's PSRoI pool and correlation forward kernels on one card,
by CUDA events and by the device's own kernel times.

Imports ``dtt_torch`` and ``chip_smoke`` from the tree at ``--root``
(default: this checkout), so one call can time two trees in turns. Each
kernel is first checked against its plain version, then timed at the
shapes ``chip_smoke.py`` holds it to (``Config()``, 38x68 maps, k = 7,
chip_smoke's random RoIs):

* ``direct``: the direct pool's forward ``psroi_sums_cuda`` (a video
  chunk's call, 16 frames x 300 RoIs at D = 43; a train step's three,
  2 x 330 x 31, 2 x 330 x 8 and 1 x 330 x 4; bf16 maps) and backward
  ``psroi_bwd_cuda`` (the train step's three);
* ``sat``: the SAT pools off float32 tables. Kernel 4, ``dtt_psroi_sat``
  on a pair batch (4 frames x 300 RoIs at D = 43): the bin sums and, where
  the tree has it, the mean mode; kernels 5 and 6 on one frame's cls, bbox
  and track tables (300 RoIs at D = 31, 8, 4): ``dtt_psroi_sat`` and
  ``dtt_psroi_sat_mean`` as three single launches and, where the tree has
  grouped launches, as one. Then the pair batch's pool stage split
  (bounds, SAT build, kernel, division, vote) as ``pool_vote_fused`` runs
  it with ``roi.eval_pool_impl=pallas_mm``;
* ``corr``: the correlation forwards, kernel 1 ``correlation_cuda`` and
  kernel 7 ``correlation_split_cuda``, at one pair's three scales (path
  ``frame``: 38x68, C = 512 / 1024 / 1024, bf16, d = 8, s = 2) and at 16
  pairs' (``chunk``), each held to one bf16 ulp of the plain version, then
  on the same maps in float32 (``frame_f32``, ``chunk_f32``: the CUDA-core
  bodies) at 1e-5, with the least time the card could take
  (``bound_ms``) and, where the tree has ``split_form``, kernel 7's
  clusters per scale.

Each timed case prints one JSON line: ``event_ms``, CUDA events around
``--iters`` repetitions as ``chip_smoke.py`` times them (host launch gaps
included); ``host_ms``, the host's time to issue one repetition (no
synchronize inside); and ``device_ms``, the summed durations of one
repetition's device kernels under ``torch.profiler`` (the kernels alone),
with each kernel's share in ``device_ms_per_call``::

    python tools/bench_psroi_torch.py --label change
    python tools/bench_psroi_torch.py --root _chip_tree/parent --label parent
    python tools/bench_psroi_torch.py --kernels corr
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--label", default="tree")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--kernels", default="direct,sat",
                   help="comma-separated: direct, sat, corr")
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("bench_psroi_torch: no CUDA device is available",
              file=sys.stderr)
        return 1
    import numpy as np
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from dtt_torch.core.config import Config
    from dtt_torch.ops import psroi as ops

    cfg = Config()
    k = cfg.model.roi.ps_grid
    hh, ww = cfg.input.canvas_height, cfg.input.canvas_width
    h, w = hh // 16, ww // 16
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

    def host_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt * 1e3 / args.iters

    def timed(fn) -> dict:
        ev = cs.time_ms(fn, iters=args.iters)
        dev, per_call = device_ms(fn)
        return {"event_ms": round(ev, 5), "host_ms": round(host_ms(fn), 5),
                "device_ms": round(dev, 5),
                "device_ms_per_call": [round(t, 5) for t in per_call]}

    def report(name, path, err, fn, **extra):
        print(json.dumps({"label": args.label, "kernel": name, "path": path,
                          "max_abs_err": err, **timed(fn), **extra}),
              flush=True)

    kinds = set(args.kernels.split(","))
    if "direct" in kinds:
        bench_direct(cfg, cs, ops, report, k, h, w, bf16)
    if "sat" in kinds:
        bench_sat(cfg, cs, ops, report, timed, args.label, np, k, hh, ww)
    if "corr" in kinds:
        bench_corr(cfg, cs, report)
    return 0


def bench_direct(cfg, cs, ops, report, k, h, w, bf16) -> None:
    import torch
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


def bench_sat(cfg, cs, ops, report, timed, label, np, k, hh, ww) -> None:
    """Kernels 4-6 at the pair batch's and one frame's shapes (chip_smoke's
    seeds 8 and 9), bit for bit against their plain versions, then the
    pair batch's pool stage split."""
    import torch
    m = cfg.model
    h, w = hh // 16, ww // 16
    scale = 1.0 / m.anchors.feat_stride
    n = m.rpn.post_nms_top_n_test
    dc = m.num_classes
    db = 8 if m.roi.class_agnostic else 4 * dc
    grouped = hasattr(ops, "psroi_sat_group_cuda")

    def exact(got, want, what):
        err = (got - want).abs().max().item()
        if err != 0.0:
            raise AssertionError(f"{what}: max abs err {err}, want 0")
        return err

    # kernel 4: a pair batch's fused maps, the sums and the mean mode
    b, d = cs.PAIR_BATCH, dc + db + 4
    g = torch.Generator(device="cuda").manual_seed(8)
    maps = torch.randn(b, h, w, k * k * d, device="cuda", generator=g)
    rois = cs.draw_rois(np.random.RandomState(8), b, n, hh, ww)
    table = ops.sat(maps).contiguous()
    bd = [x.contiguous() for x in ops.roi_bounds(rois, scale, k, h, w)]
    sums = ops.psroi_mm_sums_plain(table, *bd)
    report("psroi_mm", "pair", exact(ops.psroi_mm_sums_cuda(table, *bd), sums,
                                     "pair sums"),
           lambda: ops.psroi_mm_sums_cuda(table, *bd))
    means = ops.bin_means(sums, *bd)
    if grouped:
        report("psroi_mm_means", "pair",
               exact(ops.psroi_mm_means_cuda(table, *bd), means,
                     "pair means"),
               lambda: ops.psroi_mm_means_cuda(table, *bd))

    # the pool stage as pool_vote_fused runs it, stage by stage
    stages = {"bounds": lambda: [x.contiguous() for x in ops.roi_bounds(
                  rois, scale, k, h, w)],
              "sat_build": lambda: ops.sat(maps).contiguous()}
    if grouped:
        stages["kernel"] = lambda: ops.psroi_mm_means_cuda(table, *bd)
    else:
        stages["kernel"] = lambda: ops.psroi_mm_sums_cuda(table, *bd)
        stages["division"] = lambda: ops.bin_means(sums, *bd)
    stages["vote"] = lambda: means.mean(dim=(2, 3))
    whole = lambda: ops.psroi_pool_batched_pallas_mm(maps, rois, scale,
                                                     k).mean(dim=(2, 3))
    err = (whole() - means.mean(dim=(2, 3))).abs().max().item()
    if not err <= 8 * torch.finfo(torch.float32).eps * table.abs().max():
        raise AssertionError(f"pair pool vote: max abs err {err}")
    print(json.dumps({"label": label, "split": "pair_pool",
                      "stages": {s: timed(fn) for s, fn in stages.items()},
                      "whole": timed(whole)}), flush=True)

    # kernels 5 and 6: one frame's cls, bbox and track tables
    g = torch.Generator(device="cuda").manual_seed(9)
    fmaps = [torch.randn(1, h, w, k * k * d, device="cuda", generator=g)
             for d in (dc, db, 4)]
    rng = np.random.RandomState(9)
    members = [(ops.sat(x).contiguous(), [y.contiguous() for y in
                                          ops.roi_bounds(cs.draw_rois(
                                              rng, 1, n, hh, ww), scale, k,
                                              h, w)])
               for x in fmaps]
    report("sat_build", "frame", None,
           lambda: [ops.sat(x).contiguous() for x in fmaps])
    forms = [("psroi_mm", "mm_sums", ops.psroi_mm_sums_cuda,
              ops.psroi_mm_sums_plain),
             ("psroi_sat_mean", "sat_means", ops.psroi_sat_means_cuda,
              ops.psroi_sat_means_plain)]
    if grouped:
        forms.insert(1, ("psroi_mm_means", "mm_means", ops.psroi_mm_means_cuda,
                         ops.psroi_mm_means_plain))
    for name, form, single, plain in forms:
        wants = [plain(t, *bd_) for t, bd_ in members]
        err = max(exact(single(t, *bd_), want, f"frame {name}")
                  for (t, bd_), want in zip(members, wants))
        report(name, "frame", err,
               lambda: [single(t, *bd_) for t, bd_ in members],
               launches=len(members))
        if grouped:
            err = max(exact(got, want, f"frame {name} grouped")
                      for got, want in zip(
                          ops.psroi_sat_group_cuda(form, members), wants))
            report(name, "frame_grouped", err,
                   lambda: ops.psroi_sat_group_cuda(form, members),
                   launches=1)


def bench_corr(cfg, cs, report) -> None:
    """Kernels 1 and 7 at one pair's and 16 pairs' three scales
    (chip_smoke's seeds 10 and 1), in bf16 against the plain version at one
    bf16 ulp, then on the same maps in float32 (the CUDA-core bodies) at
    1e-5."""
    import torch
    from dtt_torch.ops import correlation as corr
    t = cfg.model.track
    d, s = t.max_displacement, t.stride
    new = hasattr(corr, "split_form")

    def f32_check(got, want, what):
        err = (got - want).abs().max().item()
        if not err <= 1e-5:
            raise AssertionError(f"{what}: max abs err {err}")
        return err

    for dtype in (torch.bfloat16, torch.float32):
        for path, pairs, seed in (("frame", 1, 10), ("chunk", 16, 1)):
            cases = [(a.to(dtype), c.to(dtype))
                     for a, c in cs.corr_inputs(cfg, pairs, seed)]
            if dtype == torch.float32:
                path += "_f32"
            check = cs.corr_check if dtype == torch.bfloat16 else f32_check
            wants = [corr.correlation_plain(a, c, d, s) for a, c in cases]
            bound_ms = cs.corr_bound(cases, d, s)[0]
            kernels = {"correlation": corr.correlation_cuda,
                       "correlation_split": corr.correlation_split_cuda}
            for name, kernel in kernels.items():
                err = max(check(kernel(a, c, d, s), want, f"{name} ({path})")
                          for (a, c), want in zip(cases, wants))
                extra = {"bound_ms": bound_ms}
                if new and kernel is corr.correlation_split_cuda:
                    extra["forms"] = [corr.split_form(tuple(a.shape), a.dtype,
                                                      d, s)
                                      for a, _ in cases]
                report(name, path, err,
                       lambda: [kernel(a, c, d, s) for a, c in cases],
                       **extra)


if __name__ == "__main__":
    sys.exit(main())
