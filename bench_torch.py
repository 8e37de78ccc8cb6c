"""Benchmark: D&T frame-pair inference throughput of dtt_torch on one CUDA
card (the port's counterpart of ``bench.py``).

Prints ONE JSON line on stdout: {"metric", "value", "unit", "vs_baseline"},
bench.py's keys under the metric ``dnt_torch_inference_frame_pairs_per_sec_per_gpu``.
The card's name and power limit (``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader``) and the runs' median, spread, min and max go to
stderr.

What is timed: the full video-mode pipeline of ``make_video_step`` (per-frame
ResNet-101 trunk shared across adjacent pairs, RPN + proposal NMS, the
R-FCN heads, 3-scale correlation, tracking, per-class decode + NMS, all
batched over the chunk) at ``Config()``'s 608x1088 canvas, on one chunk of
``--chunk`` float32 frames (``--chunk - 1`` pairs) drawn from a numpy seed
and placed on the card before the clock starts. Weights are random
flax-layout trees from a numpy seed (``init_jax_params``), carried over by
``from_jax_params``. After two untimed chunks, each of ``--runs`` chunks is timed on the host clock and ends in ``torch.cuda.synchronize()``;
the value is the median run's pairs per second. No profiler runs.

    python3 bench_torch.py [--chunk 97] [--runs 10] [--config YAML]
                           [--device cpu]

Baseline: the reference (Feynman27/pytorch-detect-to-track) publishes no
throughput; the paper reports ~7 fps on a Titan X. As ``bench.py`` does,
``vs_baseline`` is the measured value over an ASSUMED 15 frame pairs/s of
the reference on an A100-class card (7 fps scaled ~2x); it is no
measurement, and no TPU figure enters it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ASSUMED_A100_REFERENCE_PAIRS_PER_SEC = 15.0
METRIC = "dnt_torch_inference_frame_pairs_per_sec_per_gpu"
WARMUP = 2   # untimed chunks: kernel builds, cuDNN's algorithm search
SEED = 0     # of the weights and the frames


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--chunk", type=int, default=97,
                   help="frames a chunk (chunk - 1 pairs)")
    p.add_argument("--runs", type=int, default=10, help="timed chunks")
    p.add_argument("--config", default=None, help="YAML config (Config())")
    p.add_argument("--device", default=None,
                   help="'cpu' for the plain path on the CPU (default: the "
                        "card)")
    return p.parse_args(argv)


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; on the
    CPU, "cpu"."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else 0
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def time_chunks(cfg, chunk: int, runs: int, device: torch.device) -> list:
    """Seconds of each timed chunk of `make_video_step` on `device`."""
    from dtt_torch.eval.inference import make_video_step
    from dtt_torch.utils.params import from_jax_params, init_jax_params

    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    model = from_jax_params(init_jax_params(cfg.model, seed=SEED), cfg.model,
                            device=device)
    rng = np.random.RandomState(SEED)
    frames = torch.from_numpy(
        rng.randn(chunk, h, w, 3).astype(np.float32)).to(device)
    im_hw = torch.tensor([h, w], dtype=torch.float32, device=device)
    step = make_video_step(cfg, model, chunk, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(WARMUP):
        step(frames, im_hw, 1.0)
    sync()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        step(frames, im_hw, 1.0)
        sync()
        times.append(time.perf_counter() - t0)
    return times


def main(argv=None) -> dict:
    """Time the video step; prints the JSON line (stdout) and the runs'
    statistics (stderr), and returns the JSON line's dict."""
    from dtt_torch.core.config import load_config
    from dtt_torch.core.device import resolve_device

    args = parse_args(argv)
    if args.chunk < 2 or args.runs < 1:
        raise SystemExit("bench_torch: --chunk >= 2 and --runs >= 1")
    device = resolve_device(args.device)
    cfg = load_config(args.config)
    card = card_name(device)
    times = time_chunks(cfg, args.chunk, args.runs, device)
    pairs = args.chunk - 1
    med = statistics.median(times)
    value = pairs / med
    print(f"bench_torch: {card}; {cfg.model.backbone} "
          f"{cfg.input.canvas_height}x{cfg.input.canvas_width} "
          f"{cfg.model.dtype}, chunk {args.chunk} ({pairs} pairs), "
          f"{args.runs} runs after {WARMUP} warm-up: median "
          f"{med * 1e3:.2f} ms ({value:.3f} pairs/s), min "
          f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f} ms, spread "
          f"(max - min) / median {(max(times) - min(times)) / med:.1%}",
          file=sys.stderr, flush=True)
    where = "gpu" if device.type == "cuda" else "cpu"
    result = {
        "metric": METRIC if where == "gpu" else METRIC.replace("_gpu", "_cpu"),
        "value": round(value, 3),
        "unit": f"frame-pairs/sec/{where} (dtt_torch D&T video mode, "
                f"{cfg.model.backbone} {cfg.input.canvas_height}x"
                f"{cfg.input.canvas_width}, incl. NMS+decode)",
        "vs_baseline": round(value / ASSUMED_A100_REFERENCE_PAIRS_PER_SEC, 3),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
