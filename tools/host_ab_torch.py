"""A/B of the port's launch-bound paths for two trees on one CUDA card, in
one call: the ``Config()`` train step (1 pair), the single frame
(``make_single_frame_step``), one frame's trunk alone, the 17-frame video
chunk (``make_video_step``), the flagship train step
(``configs/flagship_synth.yml``: 8 pairs drawn on the card), the 4-pair
batch (``make_pair_step``, ``pallas_mm``) and the data-parallel train,
video and pair steps at one NCCL rank in the process (an in-process
``HashStore``; ``make_parallel_train_step``, ``make_video_step_parallel``
at 17 frames, ``make_pair_step_parallel`` at 4 pairs), each tree in a
fresh process a turn, the trees in alternating turns.

    python3 tools/host_ab_torch.py --parent _chip_tree/parent \
        [--pairs 10] [--steps 20] [--frames 30] [--out ab_out/host] \
        [--paths train frame video trunk flagship pair par_train ...]

`--parent` is an unpacked archive of the other tree; the change is this
checkout. The turns go parent, change, change, parent, ... (`--pairs` of
each tree, labelled E1, E2, ...); each builds its tree's kernels first
(kept in that tree between turns). A turn makes ``Config()``'s model
(ResNet-101, 608x1088, bf16; weights from numpy seed 0) and times the
`--paths` (default: all), each after two warm-up calls (a train program
captures its graph at the second): `--steps` train steps on synthetic
uint8 pairs as one block ended by a synchronize, then `--steps` more
synchronized one by one; the same for `--frames` single frames, `--steps`
17-frame uint8 chunks and 4-pair batches; 50 no-grad calls of the
backbone on one frame as one block; and `--steps` flagship steps as the
train steps. Where a tree's step has an uncaptured form (``step.eager``,
the program's eager twin) that form is timed too, under the path's name
+ ``_eager``; each form also reports its peak allocated GiB from before
its first call. The parallel paths run last, and after all timing each
of their forms makes 5 calls under ``torch.profiler``: the card's busy
share (``_busy``: the union of its kernel intervals over the wall time).
Prints one JSON line a turn (ms: the block's mean and the one-by-one
median; the card's name and power limit), writes them to
OUT/turns.jsonl, and last prints each tree's median, min and max of
every number over its turns.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES_PER_CHUNK = 17


def card() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()


PATHS = ("train", "frame", "video", "trunk", "flagship", "pair",
         "par_train", "par_video", "par_pair")
PAIR_BATCH = 4
PROFILE_CALLS = 5


def busy_share(one, n: int = PROFILE_CALLS) -> float:
    """The card's busy share over `n` calls of `one(i)` under
    ``torch.profiler``: the union of its kernel intervals over the wall
    time (None where the profiler saw no device event)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    one(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            one(1 + i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return busy / wall


def worker(root: str, steps: int, frames: int, paths: tuple) -> dict:
    """One turn in the tree at `root` (see the module docstring)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from dtt_torch.core.config import Config, load_config
    from dtt_torch.data.device_synth import make_pair_render_fn
    from dtt_torch.data.synthetic import sample_params_batch, synthetic_batch
    from dtt_torch.eval.inference import (make_pair_step,
                                          make_single_frame_step,
                                          make_video_step)
    from dtt_torch.models.targets import sample_draws
    from dtt_torch.ops import _build
    from dtt_torch.train.trainer import create_train_state, make_train_step
    from dtt_torch.utils.params import from_jax_params, init_jax_params

    _build.build()
    out = {"card": card()}
    profiled = {}

    def block(fn, n):
        """(mean ms of `n` calls as one block, median ms of `n` more
        synchronized one by one), after two warm-up calls."""
        fn(0)
        fn(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fn(2 + i)
        torch.cuda.synchronize()
        mean = (time.perf_counter() - t0) * 1e3 / n
        each = []
        for i in range(n):
            t0 = time.perf_counter()
            fn(2 + n + i)
            torch.cuda.synchronize()
            each.append((time.perf_counter() - t0) * 1e3)
        return mean, statistics.median(each)

    def forms(name, step, call, n):
        """Time `call(form, i)` for the step and its eager twin; keep the
        parallel paths' forms for the profile."""
        for suffix, form in (("", step), ("_eager", getattr(step, "eager",
                                                             None))):
            if form is None:
                continue
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mean, each = block(lambda i: call(form, i), n)
            out[f"{name}{suffix}_ms"], out[f"{name}{suffix}_ms_each"] = \
                mean, each
            out[f"{name}{suffix}_peak_gib"] = \
                torch.cuda.max_memory_allocated() / 2 ** 30
            if name.startswith("par_"):
                profiled[name + suffix] = lambda i, form=form: call(form, i)

    def train_path(name, cfg, tree, batches, render, make_step):
        h, w = cfg.input.canvas_height, cfg.input.canvas_width
        b = cfg.train.batch_size_per_chip
        model, state = create_train_state(cfg, "cuda", tree=tree)
        step = make_step(cfg, model, (h // 16, w // 16),
                         render_fn=make_pair_render_fn(h, w)
                         if render else None)
        gen = torch.Generator(device="cuda").manual_seed(cfg.train.seed + 1)
        rgen = (torch.Generator(device="cuda").manual_seed(cfg.train.seed
                                                           + 2)
                if render else None)
        box = {"state": state}

        def train(form, i):
            box["state"], _ = form(box["state"], batches[i % len(batches)],
                                   sample_draws(cfg, b, gen, "cuda"), rgen)

        forms(name, step, train, steps)

    cfg = Config()
    m, t = cfg.model, cfg.train
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    tree = init_jax_params(m, seed=0)
    rng = np.random.RandomState(t.seed)
    batches = [synthetic_batch(rng, t.batch_size_per_chip, h, w,
                               m.num_classes, cfg.input.max_gt_boxes,
                               cfg.input.pixel_means, uint8=True,
                               num_objects=cfg.input.synthetic_objects)
               for _ in range(2 * steps + 2)]
    if "train" in paths:
        train_path("train", cfg, tree, batches, False, make_train_step)
        torch.cuda.empty_cache()

    model = from_jax_params(tree, m, device="cuda")
    images = np.random.RandomState(11).randint(
        0, 256, (2 * frames + 2, h, w, 3)).astype(np.uint8)
    im_hw = (h - 8, w - 48)
    if "frame" in paths:
        fstep = make_single_frame_step(cfg, model)
        forms("frame", fstep, lambda form, i: form(
            torch.from_numpy(images[i:i + 1]), im_hw), frames)
        del fstep

    chunks = [torch.from_numpy(np.random.RandomState(12 + i).randint(
        0, 256, (FRAMES_PER_CHUNK, h, w, 3)).astype(np.uint8))
        for i in range(2)]
    pairs = [x[:2 * PAIR_BATCH].reshape(PAIR_BATCH, 2, h, w, 3)
             for x in chunks]
    pcfg = cfg.replace(model=m.replace(roi=m.roi.replace(
        eval_pool_impl="pallas_mm")))
    hw = torch.tensor(im_hw, dtype=torch.float32, device="cuda")
    if "video" in paths:
        vstep = make_video_step(cfg, model, FRAMES_PER_CHUNK)
        forms("video", vstep, lambda form, i: form(chunks[i % 2], hw, 1.0),
              steps)
        del vstep
    if "pair" in paths:
        pstep = make_pair_step(pcfg, model, PAIR_BATCH)
        forms("pair", pstep, lambda form, i: form(pairs[i % 2], hw, 1.0),
              steps)
        del pstep

    if "trunk" in paths:
        one = (torch.randn(1, 3, h, w, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(5)) * 60).to(
            getattr(torch, m.dtype)).contiguous(
            memory_format=torch.channels_last)
        with torch.inference_mode():
            out["trunk_ms"], _ = block(lambda i: model.backbone(one), 50)
        del one
    torch.cuda.empty_cache()

    if "flagship" in paths:
        fcfg = load_config(os.path.join(root, "configs",
                                        "flagship_synth.yml"))
        fh, fw = fcfg.input.canvas_height, fcfg.input.canvas_width
        frng = np.random.RandomState(fcfg.train.seed)
        train_path("flagship", fcfg, init_jax_params(fcfg.model, seed=0), [
            sample_params_batch(frng, fcfg.train.batch_size_per_chip, fh, fw,
                                fcfg.model.num_classes,
                                fcfg.input.max_gt_boxes,
                                num_objects=fcfg.input.synthetic_objects)
            for _ in range(4)], True, make_train_step)
        torch.cuda.empty_cache()

    if any(p.startswith("par_") for p in paths):
        import torch.distributed as dist

        from dtt_torch.eval.inference import (make_pair_step_parallel,
                                              make_video_step_parallel)
        from dtt_torch.parallel import data_mesh, initialize_distributed
        from dtt_torch.train.trainer import make_parallel_train_step
        initialize_distributed(store=dist.HashStore(), world_size=1, rank=0,
                               device="cuda:0")
        mesh = data_mesh("cuda:0")
        if "par_train" in paths:
            train_path("par_train", cfg, tree, batches, False,
                       lambda c, mod, f, render_fn: make_parallel_train_step(
                           c, mod, f, mesh, render_fn=render_fn))
        if "par_video" in paths:
            step = make_video_step_parallel(cfg, model, mesh,
                                            FRAMES_PER_CHUNK)
            forms("par_video", step, lambda form, i: form(chunks[i % 2], hw,
                                                          1.0), steps)
        if "par_pair" in paths:
            step = make_pair_step_parallel(pcfg, model, mesh, PAIR_BATCH)
            forms("par_pair", step, lambda form, i: form(pairs[i % 2], hw,
                                                         1.0), steps)
        for name, one in profiled.items():
            out[f"{name}_busy"] = busy_share(one)
        profiled.clear()
        dist.destroy_process_group()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent")
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--paths", nargs="+", choices=PATHS, default=PATHS)
    p.add_argument("--out", default=os.path.join(HERE, "ab_out", "host"))
    p.add_argument("--worker", metavar="ROOT",
                   help="run one turn in the tree at ROOT and print its "
                        "JSON line")
    args = p.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(os.path.abspath(args.worker), args.steps,
                                args.frames, tuple(args.paths))),
              flush=True)
        return 0
    if not args.parent:
        p.error("--parent is required")
    trees = {"parent": os.path.abspath(args.parent), "change": HERE}
    order = ["parent", "change", "change", "parent"] * (args.pairs // 2) + \
        ["parent", "change"] * (args.pairs % 2)
    os.makedirs(args.out, exist_ok=True)
    results = {name: [] for name in trees}
    failed = 0
    with open(os.path.join(args.out, "turns.jsonl"), "a") as log:
        for n, name in enumerate(order, 1):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 trees[name], "--steps", str(args.steps), "--frames",
                 str(args.frames), "--paths", *args.paths], cwd=trees[name],
                capture_output=True,
                text=True, timeout=900)
            lines = proc.stdout.strip().splitlines()
            if proc.returncode or not lines:
                failed += 1
                print(f"E{n}_{name}: rc {proc.returncode}\n"
                      f"{proc.stderr[-3000:]}", flush=True)
                continue
            row = dict(json.loads(lines[-1]), turn=f"E{n}_{name}",
                       seconds=time.perf_counter() - t0)
            results[name].append(row)
            log.write(json.dumps(row) + "\n")
            print(json.dumps(row), flush=True)
    def stats(values):
        return {"median": statistics.median(values), "min": min(values),
                "max": max(values)}

    summary = {name: {k: stats([r[k] for r in rows
                                if isinstance(r.get(k), float)])
                      for k in sorted({k for r in rows for k, v in r.items()
                                       if isinstance(v, float)})}
               for name, rows in results.items() if rows}
    print(json.dumps({"turns": {k: len(v) for k, v in results.items()},
                      "summary": summary}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
