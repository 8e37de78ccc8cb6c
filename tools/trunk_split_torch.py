"""Split the device time of the port's trunk between convolutions, the conv
epilogue (kernel 10, or the eager ``mul`` / ``add`` / ``relu`` passes it
replaced), casts, pooling and the rest, on one CUDA card, for one tree of the port,
so that two trees can be profiled in turns in one call.

Imports ``dtt_torch`` from the tree at ``--root`` (default: this
checkout). Two windows, each after two warm-up runs, under
``torch.profiler`` (run it after any timing: a traced card slows later
launches):

* ``chunk``: ``Config()``'s backbone (ResNet-101, 608x1088, bf16, weights
  from numpy seed 0) on one 17-frame chunk, no gradient;
* ``flagship``: one train step of ``configs/flagship_synth.yml`` (8 pairs
  at 608x1088, the same model) on host-rendered synthetic pairs; its
  whole step, trunk, heads and backward.

Each device kernel goes to the first class whose words its name holds
(``CLASSES``); prints one JSON line a window (the card, device ms and
kernel count by class, the window's wall ms) and writes the kernels with
the most device time beside it to ``OUT/<label>_<window>.txt``::

    python tools/trunk_split_torch.py --label change --out ab_out/split
    python tools/trunk_split_torch.py --root _chip_tree/parent --label parent
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (class, words): a kernel's class is the first whose word its name holds
# (cuDNN runs some 1x1 convs as cuBLAS products, the "nvjet" kernels; in
# the flagship step the heads' products are among them)
CLASSES = (("epilogue", ("epilogue_fwd", "epilogue_bwd")),
           ("cast", ("copy",)),
           ("mul", ("MulFunctor",)),
           ("add", ("Functor_add", "AddFunctor", "add_kernel")),
           ("relu", ("clamp_min", "clamp_scalar", "threshold")),
           ("pool", ("max_pool",)),
           ("conv", ("conv", "cudnn", "xmma", "gemm", "cutlass", "sm90_",
                     "nvjet", "nhwc", "nchw", "wgrad", "dgrad")))


def card() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()


def classify(name: str) -> str:
    for cls, words in CLASSES:
        if any(w in name for w in words):
            return cls
    return "other"


def profile(torch, fn, label: str, window: str, out: str) -> dict:
    """Device ms and kernels by class of one call of `fn` (after two
    warm-up calls)."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    by_class, by_name = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        cls = classify(e.name)
        ms, n = by_class.get(cls, (0.0, 0))
        by_class[cls] = (ms + us / 1e3, n + 1)
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + us / 1e3, n + 1)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{label}_{window}.txt"), "w") as f:
        for name, (ms, n) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][0])[:40]:
            f.write(f"{ms:10.4f} ms {n:5d}  {classify(name):8s} "
                    f"{name[:200]}\n")
    return {"label": label, "window": window, "wall_ms": wall,
            "device_ms": sum(ms for ms, _ in by_class.values()),
            "kernels": sum(n for _, n in by_class.values()),
            "by_class": {k: {"ms": ms, "kernels": n}
                         for k, (ms, n) in sorted(by_class.items())}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=HERE)
    p.add_argument("--label", default="change")
    p.add_argument("--out", default=os.path.join(HERE, "ab_out", "split"))
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from dtt_torch.core.config import Config, load_config
    from dtt_torch.data.synthetic import synthetic_batch
    from dtt_torch.models.dnt import normalize_device_images
    from dtt_torch.models.targets import sample_draws
    from dtt_torch.train.trainer import create_train_state, make_train_step
    from dtt_torch.utils.params import from_jax_params, init_jax_params
    if not torch.cuda.is_available():
        print("trunk_split_torch: no CUDA device is available",
              file=sys.stderr)
        return 1
    dev = card()
    print(f"card: {dev}; tree {root}", flush=True)
    cfg = Config()
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    tree = init_jax_params(cfg.model, seed=0)
    model = from_jax_params(tree, cfg.model, device="cuda")
    frames = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (17, h, w, 3)).astype(np.uint8)).cuda()
    im_hw = torch.tensor([h, w], dtype=torch.float32, device="cuda")
    images = normalize_device_images(frames, im_hw, cfg.input.pixel_means)
    x = images.permute(0, 3, 1, 2).to(model.dtype)

    def chunk():
        with torch.inference_mode():
            model.backbone(x)

    lines = [profile(torch, chunk, args.label, "chunk", args.out)]
    del model
    torch.cuda.empty_cache()

    fcfg = load_config(os.path.join(root, "configs", "flagship_synth.yml"))
    m, b = fcfg.model, fcfg.train.batch_size_per_chip
    fh, fw = fcfg.input.canvas_height, fcfg.input.canvas_width
    fmodel, state = create_train_state(fcfg, "cuda",
                                       tree=init_jax_params(m, seed=0))
    step = make_train_step(fcfg, fmodel, (fh // 16, fw // 16))
    rng = np.random.RandomState(1)
    batch = synthetic_batch(rng, b, fh, fw, m.num_classes,
                            fcfg.input.max_gt_boxes, fcfg.input.pixel_means,
                            uint8=True,
                            num_objects=fcfg.input.synthetic_objects)
    gen = torch.Generator(device="cuda").manual_seed(2)
    box = [state]

    def train_step():
        box[0], _ = step(box[0], batch, sample_draws(fcfg, b, gen, "cuda"))

    lines.append(profile(torch, train_step, args.label, "flagship", args.out))
    for line in lines:
        print(json.dumps(dict(line, card=dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
