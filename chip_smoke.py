"""Drive dtt_torch's video-mode inference, training, evaluation,
single-frame detection, data parallelism and data path on one CUDA card
and check them.

Run from the repository root, with one card visible:

    python3 chip_smoke.py

Phases, in order; any failure ends the script with a non-zero exit:

1. the card's name and power limit, as nvidia-smi reports them;
2. build every kernel from dtt_torch/ops/csrc (one nvcc per source, all
   started together);
3. per kernel and per path that runs it (correlation and PSRoI pool
   forward on the video and the train path, their backwards on the train
   path, correlation and the SAT pool on the tau-strided pair path, the
   SAT pools at one frame and both correlation forwards at one pair on the
   single-frame path), at the shapes that path gives it: every call of one
   video chunk, one train step, one pair batch or one frame against its
   plain PyTorch version (stated tolerance; the SAT pools bit for bit, in
   every mode, and at one frame as one grouped launch of the three tables
   and as three single launches), and CUDA-event times of those
   calls through the kernel, the plain version and, where one exists, one
   PyTorch call computing the same function, beside the least time the
   card could take; the channel-split correlation (its cluster form per
   scale and three runs bit for bit) at one pair and beside the unsplit
   one at a video chunk's 16 pairs; then correlation windows past the
   tensor-core band (d=16/s=4, d=10/s=2) in bf16 and f32 under every
   kernel form, forward and backward, against the plain versions; the NMS
   kernel at every NMS of a video chunk, a train step, a pair batch, a
   frame and the parallel chunk (proposals, per-class or OHEM) and on the
   crafted cases of tests/nms_cases.py (+0.0 against -0.0 and walks past
   1,024 positions among them) at select_block 1, 16, 32 and 48, bit for
   bit in each order of the zeros against the plain form of that order
   (``nms_padded_fast``'s total order, ``nms_padded``'s tie), and the two
   dispatchers on the signed-zero case against their plain forms,
   with its dependent steps, each call's layout and its ms a dependent
   step; below a score threshold of -1e10 against the block loop at the
   kernel's widths; unsorted proposals and the scratch layout (12,000 and
   49,152 boxes a problem); the tube-linking kernel at the eval paths'
   shapes (30 classes, 20 slots, 20 tubes; 16 frames at tau=1, 8
   keyframes at tau=2) and at a VID val snippet's 300 frames under every
   score boost, with its chain (dependent steps, ns a step), and on the
   problems of tests/linking_cases.py (tied scores, 45 and 33 slots, one
   frame, the link weights and then the scores in scratch), decisions and
   tube scores bit for bit against its plain form, rescored scores to
   1e-6; the trunk's conv epilogue (kernel 10, forward and backward) at
   every trunk call of a video chunk, a train step (the backward at its
   trained blocks), a pair batch and a frame, bit for bit, with the device
   design that ran and, per path, the host's cost of one wrapper call by
   part (tools/epilogue_host_torch.py: checks, allocation, launch; beside
   an eager torch.add);
4. small references: the tiny test config in float32 through the kernels
   on the card against the plain versions on the CPU, for the video path,
   for one train step (same weights, same injected draws; losses, every
   gradient leaf and the updated parameters), for the pair path at
   tau=2 with the SAT pool, tube linking included, and for the
   single-frame step, every per-frame pool form and the split
   correlation with their gradients; then kernel 10 bit for bit at every
   trunk shape of 608x1088 on 1 and 2 frames, each form in bf16 and f32
   with NaN, +-inf and +-0.0, forward and backward, and a calibrated
   ResNet-101 trunk's c3, c4 and c5 on one frame bit for bit against its
   eager form, with the trunk alone on 17 frames timed fused and eager;
5. the video path: ``Config()`` at full width (ResNet-101, 608x1088, bf16,
   31 classes), random flax-layout weights from a numpy seed carried over
   by ``from_jax_params``, and ``evaluate_snippet_video`` over a uint8
   snippet of several chunks, with its launch counts and the stage split
   of a video chunk (its pool stage split again into cast, bounds, kernel,
   division and mean) and of a pair batch (its SAT pool stage split into
   bounds, SAT build, kernel and mean);
6. the training path: ``Config()`` at full width, the same weights,
   ``create_train_state``/``make_train_step`` on synthetic uint8 pairs:
   two warm-up steps (the first eager, the second captures the step's
   program) and several timed ones, its launch counts (read from
   the timed run), checks of the losses, the frozen and trained leaves
   and a checkpoint round trip, a few steps under ``torch.profiler`` (the
   device's busy share, kernels per step) and one step split into stages;
7. the evaluation path: the same weights written as a port checkpoint and
   ``eval_torch.main`` run on it twice at full width, tau=2 on the pair
   path with the SAT pool (``roi.eval_pool_impl=pallas_mm``) and tau=1 on
   the video path with tube linking, each with its launch counts, its
   mAP line and its wall time split into detection, linking,
   interpolation + NMS and ``eval_detections``;
8. the single-frame path: ``make_single_frame_step`` at full width on the
   same weights, one warm-up and several timed uint8 frames with a stage
   split, then on the last frame ``rfcn_head`` under every ``impl`` (one
   SAT kernel launch a call for both maps under ``pallas_mm`` and
   ``pallas``) and ``correlation`` under both kernel forms at one pair's
   three scales, each checked, its launches counted and timed;
9. ``bench_torch.py``'s measurement at its defaults (its JSON line);
10. the data path: a VID/DET tree of 1280x720 JPEG frames written here
   (two train snippets of 10 frames, one val snippet of 17, four DET
   images), the decode route and its host ms per frame, ``PairLoader``'s
   rate alone, then at full width with the same weights 1 + 6 train steps
   from ``PairLoader`` (VID and DET mixed) through ``device_prefetch``
   (its first upload bit for bit against its host batch), 1 + 6 on
   host-rendered and 1 + 6 on device-rendered synthetic pairs (the
   card's canvases pixel for pixel against the host renderer's first),
   each with its launches, and ``eval_torch.main --dataset ... --link``
   on the val snippet, which must decode every frame once;
11. the step programs (CUDA graphs), at full width on the same weights:
   the 17-frame video chunk under both ``split_video_step`` forms, the
   4-pair batch and the single frame, each over 3 calls with changing
   frames, extents and scales, and the ``Config()`` train step and the
   flagship's (8 pairs drawn on the card) over 5 steps from one state,
   each bit for bit against its eager form (``step.eager``; the train
   steps with cuDNN's deterministic algorithms), with host ms a call of
   both forms (median, min and max of 20 calls after warm-up) and, last,
   each form's device busy share under ``torch.profiler``;
12. data parallelism, at full width on the same weights: (a) one NCCL
   rank in this process, the parallel steps as programs (CUDA graphs with
   NCCL's collectives inside): the train program for 1 + PAR_STEPS steps
   (the capture among them) against the serial program from the same
   state, batches and draws (losses, every parameter), with ms/step, the
   all-reduce's ms and bytes and peak memory, the video program on a
   17-frame chunk and the pair program on a pair batch against the
   serial programs, each with its launches (replays); each program bit
   for bit against its ``.eager`` (the train program over 5 steps under
   cuDNN's deterministic algorithms, the others over 3 calls with
   changing frames, extents and scales), host ms a call of both forms,
   no Python call of a collective while they replay, suspect S2 (2
   program steps then 2 eager ones on one state against 4 eager steps,
   for the serial and the parallel train step) and, last, each form's
   busy share and NCCL device events under ``torch.profiler``; (b)
   PAR_WORLD gloo ranks spawned on the one card (NCCL refuses two ranks
   on a device): each program refusing under gloo, then by ``.eager``
   one parallel video chunk and one parallel train step on a global
   batch against one process on it, the ranks' replicas equal;
13. weights and pooling modes, at full width: a torchvision-layout
   ResNet-101 .pth with BN running statistics made here from a numpy seed,
   ``train_torch.main --pretrained --calibrate-bn`` for 1 + 3 steps (every
   backbone conv the .pth's bit for bit, the last calibrated affines'
   outputs at per-channel mean 0 and std 1 within CALIB_TOL, the losses
   finite, the train path's kernels launched), the run's
   ``state.msgpack`` written again (the same bytes) and restored into a
   fresh state (parameters, momentum and step bit for bit, with the write
   and read ms and the file's size), ``eval_torch.main`` on that run dir
   at tau=1 with --link and at tau=2 with the SAT pool, then each of the
   pooling modes align, pool and crop: one 17-frame video chunk (pairs/s),
   for align 1 + 3 train steps (ms/step, peak memory), and the tiny f32
   config card against CPU for the video step and one train step, as in
   phase 4;
14. the mid_synth accuracy path (configs/mid_synth.yml: ResNet-50 at
   304x544, 19x34 maps, 10 classes, 12 anchors): the correlation and its
   backward, the direct pool and its backward and the NMS at one train
   step's shapes, and the correlation, the direct pool, the NMS and tube
   linking at its linked eval's 8-frame snippets, each against its plain
   version as in phase 3, and kernel 10 at both trunks' calls; then
   ``tools/run_mid_synth_torch.py``'s train (1 + MID_STEPS steps, from
   scratch with --calibrate-bn) and its eval of
   one snippet with --link, in this process at full width, each with its
   launches, the step's ms, pairs/s and peak memory, the losses of the
   last step, the mAPs and the verdict line (too few steps for the gate,
   whose message is logged, not applied);
15. the flagship accuracy path (configs/flagship_synth.yml: Config()'s
   model, ResNet-101 dilated at 608x1088, 31 classes, 8 pairs a step
   rendered on the card): the same kernels at its train step's and its
   linked eval's shapes against their plain versions, then
   ``tools/run_flagship_synth_torch.py``'s train (1 + FLAG_STEPS steps)
   and its eval of one snippet with --link, as in phase 14;
16. both correlation forwards' device time by ``torch.profiler`` at one
   pair and at 16 pairs, after the main paths, since a traced card slows
   the host's later launches.

It prints a JSON line of the kernels' numbers before the last line, one
entry per kernel and path, each with the launches of that path's run, and
ends with ``{"ok": true, "device": {...}}``. It needs no network and runs
without JAX. Without a CUDA card it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from dtt_torch.core.anchors import grid_anchors_for
from dtt_torch.core.config import Config
from dtt_torch.core.config import load_config
from dtt_torch.data.device_synth import make_pair_render_fn
from dtt_torch.data.synthetic import sample_params_batch, synthetic_batch
from dtt_torch.eval import linking as link_ops
from dtt_torch.eval.inference import (evaluate_snippet, evaluate_snippet_video,
                                      link_snippet, make_pair_step,
                                      make_single_frame_step, make_video_step)
from dtt_torch.models.dnt import (DnT, Detections, cosine_prep,
                                  decode_detections_batched,
                                  decode_frame_detections, is_frozen,
                                  normalize_device_images, pool_vote_fused,
                                  rfcn_head)
from dtt_torch.models.dnt import _BACKBONES, is_frozen
from dtt_torch.models.resnet import ResNetBackbone
from dtt_torch.models.rpn import Proposals, proposal_layer, softmax
from dtt_torch.models.targets import sample_draws
from dtt_torch.ops import _build
from dtt_torch.ops import correlation as corr_ops
from dtt_torch.ops import epilogue as epilogue_ops
from dtt_torch.ops import nms as nms_ops
from dtt_torch.ops import psroi as psroi_ops
from dtt_torch.train import losses as train_losses
from dtt_torch.train.checkpoint import (latest_checkpoint,
                                        restore_checkpoint, save_checkpoint)
from dtt_torch.train.trainer import (apply_gradients, batch_to_device,
                                     create_train_state, make_train_step,
                                     sgd_step_)
from dtt_torch.utils import calibrate
from dtt_torch.utils.params import from_jax_params, init_jax_params

import bench_torch
import eval_torch
import train_torch

# H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor FLOP/s and
# float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12

FRAMES_PER_CHUNK = 17        # 16 pairs per chunk
SNIPPET_FRAMES = 40          # 3 chunks: 16 + 16 + 8 pairs
# correlation (and its gradients) in bf16, element by element: |got - want|
# <= CORR_RTOL |want| + CORR_ATOL, one bf16 ulp of each output; outputs are
# ~1/sqrt(C), so a dropped 32-channel step or a wrong plane fails it
CORR_RTOL, CORR_ATOL = 2.0 ** -7, 1e-5
PSROI_TOL = 1e-3             # f32 sums of the same bf16 values, other order
PAIR_BATCH = 4               # pairs per batch of the tau-strided pair step
BWD_REL_TOL = 8e-3           # bf16 gradients: one bf16 ulp of the largest
TRAIN_STEPS = 6              # timed full-width train steps (after 2 warm-up)
TRAIN_REF_LOSS_TOL = 1e-4    # tiny f32 train step, card vs CPU, losses
# ... each gradient leaf: max |card - CPU| <= this share of the leaf's
# largest |CPU| element. On an H100 the worst leaf is off by ~1.7e-5;
# dropping the correlation's df2 moves the trunk's layer4 and the reduce
# conv by 2.5e-4 to 6e-4 in this config
TRAIN_REF_GRAD_REL = 1e-4
# ... and each updated parameter, element by element: |card - CPU| <=
# atol + rtol * |CPU|, two float32 ulps of the parameter plus 2e-8, under
# 1% of a typical lr * g update of ~1e-5
TRAIN_REF_PARAM_TOL = (2e-8, 2.5e-7)
PROFILE_STEPS = 3            # full-width train steps under torch.profiler
FRAME_STEPS = 8              # timed full-width single frames (after 1 warm-up)
DATA_STEPS = 6               # timed full-width steps per data source
DATA_WORKERS = 4             # PairLoader threads
DATA_DET_FRACTION = 0.5      # DET:VID mixture of the loader's batches
# correlation windows past the tensor-core band that dtt takes
WIDE_WINDOWS = ((16, 4), (10, 2))
MODE_STEPS = 3               # timed pretrained and align train steps
PAR_STEPS = 2                # parallel phase: timed steps after 1 warm-up
PAR_WORLD = 2                # gloo ranks sharing the one card
PAR_FPD = 8                  # frames a rank in the two-rank video chunk
PAR_S2_STEPS = (2, 2)        # S2: program steps, then eager steps, one state
# parallel phase (a), one NCCL rank against the one-process step from the
# same state, batches and draws: the same arithmetic, so the losses to
# float32 roundoff and each parameter within TRAIN_REF_PARAM_TOL (cuDNN's
# weight gradients need not be deterministic)
PAR_LOSS_RTOL = 1e-5
# ... the video and pair steps on the same chunk or batch against the
# serial steps: `valid` equal, scores and boxes (pixels) within these
PAR_EVAL_TOL = {"scores": 1e-3, "boxes": 0.5, "tracked": 0.5}
# (b), two gloo ranks against the same work emulated rank by rank in one
# process: the same shapes, so PAR_LOSS_RTOL, TRAIN_REF_PARAM_TOL and equal
# outputs; against one process on the whole batch (both pairs) or chunk:
# bf16 convolutions over another batch shape take other algorithms, and
# the proposals and the OHEM selection over random weights' near-tied
# scores follow them, so the losses within this share of their value,
# each leaf's update within this share of the leaf's largest update, and
# at most this share of the chunk's `valid` entries flipped (on an H100
# 80GB HBM3 at 700 W: 0.048, 0.049 and 3 of 9,000)
PAR2_LOSS_RTOL = 0.1
PAR2_UPDATE_REL = 0.1
PAR2_VALID_FLIPS = 1e-3
# calibrated affines' outputs over the calibration batch, per channel:
# |mean| and |std - 1|; the forward computes x * bf16(scale) + bf16(bias)
# in bf16, so a channel whose mean is m std off zero lands ~m 2^-8 away
CALIB_TOL = (0.1, 0.05)
KERNELS = {"correlation": corr_ops.correlation_cuda,
           "correlation_split": corr_ops.correlation_split_cuda,
           "correlation_bwd": corr_ops.correlation_bwd_cuda,
           "psroi_direct": psroi_ops.psroi_sums_cuda,
           "psroi_direct_bwd": psroi_ops.psroi_bwd_cuda,
           "psroi_mm": psroi_ops.psroi_mm_sums_cuda,
           "psroi_sat_mean": psroi_ops.psroi_sat_means_cuda,
           "nms": nms_ops.nms_cuda,
           "linking": link_ops.link_cuda,
           "epilogue": epilogue_ops.conv_epilogue_cuda,
           "epilogue_bwd": epilogue_ops.conv_epilogue_bwd_cuda}
# the kernels each driven path must launch (every path runs a proposal NMS;
# every run checked as "pair" or "eval_video" is an eval_torch run that
# links tubes)
PATH_KERNELS = {"video": ("correlation", "psroi_direct", "nms"),
                "train": ("correlation", "correlation_bwd", "psroi_direct",
                          "psroi_direct_bwd", "nms"),
                "pair": ("correlation", "psroi_mm", "nms", "linking"),
                "eval_video": ("correlation", "psroi_direct", "nms",
                               "linking"),
                "frame": ("correlation", "correlation_split", "psroi_mm",
                          "psroi_sat_mean", "nms"),
                "mode_video": ("correlation", "nms"),
                "mode_train": ("correlation", "correlation_bwd", "nms"),
                "parallel_train": ("correlation", "correlation_bwd",
                                   "psroi_direct", "psroi_direct_bwd", "nms"),
                "parallel_video": ("correlation", "psroi_direct", "nms"),
                "parallel_pair": ("correlation", "psroi_mm", "nms"),
                "mid_train": ("correlation", "correlation_bwd",
                              "psroi_direct", "psroi_direct_bwd", "nms"),
                "mid_eval": ("correlation", "psroi_direct", "nms",
                             "linking"),
                "flag_train": ("correlation", "correlation_bwd",
                               "psroi_direct", "psroi_direct_bwd", "nms"),
                "flag_eval": ("correlation", "psroi_direct", "nms",
                              "linking")}
# every path runs a trunk, so the conv epilogue; the training paths run
# its backward at every trained block
TRAIN_PATHS = ("train", "mid_train", "flag_train")
PATH_KERNELS = {path: (*names, "epilogue",
                       *(("epilogue_bwd",) if path in TRAIN_PATHS
                         or path in ("mode_train", "parallel_train")
                         else ()))
                for path, names in PATH_KERNELS.items()}
# select_block widths the NMS kernel is held at on the crafted cases (48:
# wider than one of its steps)
NMS_BLOCKS = (1, 16, 32, 48)
# tube linking, kernel against plain form: rescored scores element by
# element within LINK_TOL (1 + |want|), float32 roundoff of the boost's
# sum in another order; every other output bit for bit
LINK_TOL = 1e-6
LINK_BOOSTS = ("mean_top_half", "mean", "max")
# the eval paths' snippets: 16 frames at tau=1, their 8 keyframes at tau=2
LINK_FRAMES = {"eval_video": 16, "pair": 8}
# the mean length of an ImageNet VID val snippet (176,126 frames in 555
# snippets), linked whole at tau=1
LINK_VID_FRAMES = 300
# the mid_synth accuracy run (tools/run_mid_synth_torch.py): the train
# steps timed after 1 warm-up, and the frames of its eval's snippets
# (eval_torch's --synthetic-frames default: 8-frame snippets in 9-frame
# video chunks, so 8 frames pooled and linked)
MID_STEPS = 8
MID_EVAL_FRAMES = 8
LINK_FRAMES["mid_eval"] = MID_EVAL_FRAMES
# the flagship accuracy run (tools/run_flagship_synth_torch.py): the train
# steps timed after 1 warm-up; its eval's snippets are 8 frames, as mid's
FLAG_STEPS = 2
LINK_FRAMES["flag_eval"] = MID_EVAL_FRAMES
# the frames one call of a video-step path pools, and the paths that run
# the train step's shapes
VIDEO_FRAMES = {"video": FRAMES_PER_CHUNK - 1,
                # the parallel chunk's one rank also pools its wrapped pair
                "parallel_video": FRAMES_PER_CHUNK,
                "mid_eval": MID_EVAL_FRAMES,
                "flag_eval": MID_EVAL_FRAMES}
# kernel 10 at the shapes of each path's trunk calls: the frames one trunk
# call takes (a video chunk's 17, a parallel rank's chunk one more, an eval
# chunk's 17 or 9, a train step's two frames a pair, the pair batch's 8,
# one frame)
EPI_FRAMES = {"video": FRAMES_PER_CHUNK, "pair": 2 * PAIR_BATCH, "frame": 1,
              "parallel_video": FRAMES_PER_CHUNK + 1,
              "mid_eval": MID_EVAL_FRAMES + 1,
              "flag_eval": MID_EVAL_FRAMES + 1}
EPI_EXACT_FRAMES = (1, 2)    # bit for bit at every trunk shape of 608x1088
EPI_TRUNK_FRAMES = 17        # the trunk alone, fused against unfused


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of `fn` on the card, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float,
          ops_per_s: float = BF16_OPS_PER_S) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_card() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    log(f"card: {out}")
    return out


def phase_build() -> None:
    t0 = time.perf_counter()
    logs = _build.build(verbose=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"ptxas {name}: {line.strip()}")
    log(f"build: {sorted(_build.KERNELS)} in "
        f"{time.perf_counter() - t0:.1f} s")


def corr_inputs(cfg: Config, pairs: int, seed: int) -> list:
    """The 3-scale correlation inputs of `pairs` consecutive frame pairs:
    c3 pooled (512 ch), c4 (1024) and the reduced c5 (1024) at stride 16,
    cosine-prepared bf16, as (f1, f2) per scale."""
    h, w = cfg.input.canvas_height // 16, cfg.input.canvas_width // 16
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for c in (512, 1024, cfg.model.reduced_channels):
        x = cosine_prep(torch.randn(pairs + 1, h, w, c, device="cuda",
                                    generator=g).to(torch.bfloat16))
        out.append((x[:-1].contiguous(), x[1:].contiguous()))
    return out


def corr_check(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """max |got - want|; raises where an element is further off than
    CORR_RTOL |want| + CORR_ATOL."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    bad = diff > CORR_RTOL * w.abs() + CORR_ATOL
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} of {bad.numel()} "
                             f"outputs further than 2^-7 |want| + 1e-5 from "
                             f"the plain version (max abs err "
                             f"{diff.max().item():.3g})")
    return diff.max().item()


def corr_bound(cases: list, d: int, s: int) -> tuple:
    """(bound ms, what bounds it, bytes, operations) of the correlation
    forward of `cases`: both maps read and the output written once, a
    multiply-add per channel of each output."""
    nd2 = corr_ops.num_corr_channels(d, s)
    nbytes = sum(2 * f1.numel() * f1.element_size()
                 + f1[..., 0].numel() * nd2 * f1.element_size()
                 for f1, _ in cases)
    ops = sum(2 * f1.numel() * nd2 for f1, _ in cases)
    return (*bound(nbytes, ops), nbytes, ops)


def phase_correlation(cfg: Config, path: str, pairs: int, seed: int) -> dict:
    """The correlation forward of one call of `path` (a video chunk's 16
    pairs, a train step's pair or a pair batch's 4 pairs) at the 3
    scales."""
    t = cfg.model.track
    d, s = t.max_displacement, t.stride
    cases = corr_inputs(cfg, pairs, seed)
    err = 0.0
    for f1, f2 in cases:
        got = corr_ops.correlation_cuda(f1, f2, d, s)
        torch.cuda.synchronize()
        want = corr_ops.correlation_plain(f1, f2, d, s)
        err = max(err, corr_check(got, want, f"correlation kernel vs plain "
                                             f"({path}, C={f1.shape[-1]})"))
    ms = time_ms(lambda: [corr_ops.correlation_cuda(a, c, d, s)
                          for a, c in cases], iters=20)
    plain_ms = time_ms(lambda: [corr_ops.correlation_plain(a, c, d, s)
                                for a, c in cases], iters=3, warmup=1)
    bound_ms, bound_by, nbytes, ops = corr_bound(cases, d, s)
    log(f"correlation [{path}]: {pairs} pair(s) x 3 scales "
        f"{[tuple(c[0].shape) for c in cases]} bf16 d={d} s={s}: max_abs_err"
        f" {err:.3g} (tol 2^-7 |want| + 1e-5), kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library: none (no single PyTorch call computes "
        f"it), bound_us {bound_ms * 1e3:.1f} ({bound_by}, {nbytes / 1e6:.1f} "
        f"MB, {ops / 1e9:.2f} GFLOP), {bound_ms / ms:.1%} of the bound")
    return {"name": "correlation", "path": path, "route": "cuda",
            "source": "dtt_torch/ops/csrc/correlation.cu",
            "replaces": "dtt/ops/correlation.py:135",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_correlation_bwd(cfg: Config, pairs: int, seed: int,
                          path: str = "train") -> dict:
    """The correlation backward of one train step's pairs at the 3
    scales (`path` names the train path)."""
    t = cfg.model.track
    d, s = t.max_displacement, t.stride
    nd2 = corr_ops.num_corr_channels(d, s)
    g = torch.Generator(device="cuda").manual_seed(seed)
    cases = [(f1, f2, torch.randn(*f1.shape[:3], nd2, device="cuda",
                                  generator=g).to(torch.bfloat16))
             for f1, f2 in corr_inputs(cfg, pairs, seed)]
    err = 0.0
    for f1, f2, go in cases:
        got = corr_ops.correlation_bwd_cuda(f1, f2, go, d, s)
        torch.cuda.synchronize()
        want = corr_ops.correlation_bwd_plain(f1, f2, go, d, s)
        for name, x, y in zip(("df1", "df2"), got, want):
            err = max(err, corr_check(x, y, f"correlation backward kernel vs"
                                            f" plain ({name}, "
                                            f"C={f1.shape[-1]})"))
    ms = time_ms(lambda: [corr_ops.correlation_bwd_cuda(*c, d, s)
                          for c in cases], iters=20)
    plain_ms = time_ms(lambda: [corr_ops.correlation_bwd_plain(*c, d, s)
                                for c in cases], iters=3, warmup=1)
    nbytes = sum(4 * f1.numel() * 2 + go.numel() * 2 for f1, _, go in cases)
    ops = sum(2 * 2 * nd2 * f1.numel() for f1, _, _ in cases)
    bound_ms, bound_by = bound(nbytes, ops)
    log(f"correlation_bwd [{path}]: {pairs} pair(s) x 3 scales "
        f"{[tuple(c[0].shape) for c in cases]} bf16 d={d} s={s}: max_abs_err"
        f" {err:.3g} (tol 2^-7 |want| + 1e-5), kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library: none (no single PyTorch call computes "
        f"it), bound_us {bound_ms * 1e3:.1f} ({bound_by}, {nbytes / 1e6:.1f} "
        f"MB, {ops / 1e9:.2f} GFLOP), {bound_ms / ms:.1%} of the bound")
    return {"name": "correlation_bwd", "path": path, "route": "cuda",
            "source": "dtt_torch/ops/csrc/correlation.cu",
            "replaces": "dtt/ops/correlation.py:337 (XLA AD of correlation_mm;"
                        " no TPU kernel)",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def draw_rois(rng: np.random.RandomState, b: int, n: int, hh: int,
              ww: int) -> torch.Tensor:
    """(b, n, 4) boxes of 16-600 x 16-400 pixels on an hh x ww canvas, on
    the card."""
    x1 = rng.uniform(0, ww - 32, (b, n))
    y1 = rng.uniform(0, hh - 32, (b, n))
    rois = np.stack([x1, y1,
                     np.minimum(x1 + rng.uniform(16, 600, (b, n)), ww - 1),
                     np.minimum(y1 + rng.uniform(16, 400, (b, n)), hh - 1)],
                    axis=-1).astype(np.float32)
    return torch.from_numpy(rois).cuda()


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def check_launches(path: str, launches: dict) -> None:
    for name in PATH_KERNELS[path]:
        if launches[name] < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{path} path")


def pool_cases(cfg: Config, path: str) -> list:
    """(frames, RoIs, D) of each pool call of one video chunk (the fused
    cls|bbox|track maps of 16 frames at the test proposals) or of one train
    step (cls and bbox maps of both frames of each pair, track maps of
    frame t, at the labelled RoIs: 300 proposals + the gt slots)."""
    m = cfg.model
    dc = m.num_classes
    db = 8 if m.roi.class_agnostic else 4 * dc
    if path in VIDEO_FRAMES:
        return [(VIDEO_FRAMES[path], m.rpn.post_nms_top_n_test, dc + db + 4)]
    b = cfg.train.batch_size_per_chip
    n = (m.rpn.post_nms_top_n_train + cfg.input.max_gt_boxes
         if cfg.train.ohem else m.roi.batch_size)
    return [(2 * b, n, dc), (2 * b, n, db), (b, n, 4)]


def pool_bounds(cfg: Config, cases: list, seed: int) -> list:
    """Bin bounds of random RoIs for each (frames, RoIs, D) case."""
    m = cfg.model
    hh, ww = cfg.input.canvas_height, cfg.input.canvas_width
    rng = np.random.RandomState(seed)
    return [psroi_ops.roi_bounds(draw_rois(rng, b, n, hh, ww),
                                 1.0 / m.anchors.feat_stride, m.roi.ps_grid,
                                 hh // 16, ww // 16)
            for b, n, _ in cases]


def phase_psroi(cfg: Config, path: str, seed: int) -> dict:
    """The direct pool's calls of one video chunk or one train step, each
    against its plain version; times are for all of the calls."""
    k = cfg.model.roi.ps_grid
    h, w = cfg.input.canvas_height // 16, cfg.input.canvas_width // 16
    cases = pool_cases(cfg, path)
    g = torch.Generator(device="cuda").manual_seed(seed)
    inputs = [(torch.randn(b, h, w, k * k * d, device="cuda",
                           generator=g).to(torch.bfloat16), bd)
              for (b, _, d), bd in zip(cases, pool_bounds(cfg, cases, seed))]
    err = 0.0
    for maps, bd in inputs:
        got = psroi_ops.psroi_sums_cuda(maps, *bd)
        torch.cuda.synchronize()
        err = max(err, (got - psroi_ops.psroi_sums_plain(maps, *bd)).abs()
                  .max().item())
    if not err <= PSROI_TOL:
        raise AssertionError(f"psroi kernel vs plain ({path}): max abs err "
                             f"{err} > {PSROI_TOL}")
    ms = time_ms(lambda: [psroi_ops.psroi_sums_cuda(mp, *bd)
                          for mp, bd in inputs], iters=20)
    plain_ms = time_ms(lambda: [psroi_ops.psroi_sums_plain(mp, *bd)
                                for mp, bd in inputs], iters=3, warmup=1)
    lib_inputs = [(*(x.to(torch.bfloat16) for x in
                     psroi_ops.interval_indicators(*bd, h, w)),
                   mp.reshape(*mp.shape[:3], k, k, -1)) for mp, bd in inputs]
    library = lambda: [torch.einsum("bnpy,byxpqd,bnqx->bnpqd", r, m6, c)
                       for r, c, m6 in lib_inputs]
    lib_err = max((lib.float() - psroi_ops.psroi_sums_cuda(mp, *bd))
                  .abs().max().item()
                  for lib, (mp, bd) in zip(library(), inputs))
    library_ms = time_ms(library, iters=3, warmup=1)
    adds = sum(psroi_ops.bin_areas(*bd).sum().item() * d
               for (_, _, d), (_, bd) in zip(cases, inputs))
    # bytes this run's bins need: the 32-byte sectors of the maps that some
    # bin reads, each once, the bounds read and the sums written; beside it
    # the whole maps' bytes, the bound of a kernel that reads every pixel
    rest = sum(4 * bd[0].numel() * 4 + bd[0].numel() * k * d * 4
               for (_, _, d), (_, bd) in zip(cases, inputs))
    touched = sum(pool_sector_bytes(bd, mp.shape, k, mp.element_size())
                  for mp, bd in inputs)
    nbytes = touched + rest
    whole = sum(mp.numel() * mp.element_size() for mp, _ in inputs) + rest
    bound_ms, bound_by = bound(nbytes, adds)
    whole_ms, _ = bound(whole, adds)
    log(f"psroi_direct [{path}]: maps {[tuple(mp.shape) for mp, _ in inputs]}"
        f" bf16, (frames, RoIs, D) {cases}, k={k}: max_abs_err {err:.3g} "
        f"(tol {PSROI_TOL}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library einsum {library_ms:.4f} ms (bf16, max abs diff "
        f"{lib_err:.3g}), bound_us {bound_ms * 1e3:.1f} ({bound_by}, "
        f"{nbytes / 1e6:.1f} MB: {touched / 1e6:.1f} MB of 32-byte sectors "
        f"the bins read, {adds / 1e9:.3f} G adds), {bound_ms / ms:.1%} of "
        f"the bound; whole maps read once: bound_us {whole_ms * 1e3:.1f} "
        f"({whole / 1e6:.1f} MB)")
    return {"name": "psroi_direct", "path": path, "route": "cuda",
            "source": "dtt_torch/ops/csrc/psroi.cu",
            "replaces": "dtt/ops/psroi.py:382",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def pool_sector_bytes(bd: list, shape: tuple, k: int, esize: int) -> int:
    """Distinct bytes of the (B, H, W, k*k*D) maps that the bins of bounds
    `bd` read, in whole 32-byte sectors: for every (frame, pixel, bin) that
    some RoI's bin covers, the bin's run of D channels, rounded out to its
    sectors, each sector counted once."""
    b, h, w, c = shape
    d = c // (k * k)
    r, cind = psroi_ops.interval_indicators(*bd, h, w)
    cover = torch.einsum("bnpy,bnqx->byxpq", r, cind) > 0
    idx = cover.reshape(b, h, w, k * k).nonzero()
    pix = (idx[:, 0] * h + idx[:, 1]) * w + idx[:, 2]
    start = (pix * c + idx[:, 3] * d) * esize
    first, last = start // 32, (start + d * esize - 1) // 32
    hit = torch.zeros(-(-b * h * w * c * esize // 32), dtype=torch.bool,
                      device=start.device)
    for i in range(int((last - first).max().item()) + 1 if len(idx) else 0):
        hit[(first + i)[first + i <= last]] = True
    return int(hit.sum().item()) * 32


def phase_psroi_bwd(cfg: Config, seed: int, path: str = "train") -> dict:
    """The pool backward's calls of one train step (cls, bbox and track
    maps; `path` names the train path), each against its plain version;
    times are for all of the calls."""
    k = cfg.model.roi.ps_grid
    h, w = cfg.input.canvas_height // 16, cfg.input.canvas_width // 16
    bf16 = torch.bfloat16
    cases = pool_cases(cfg, path)
    g = torch.Generator(device="cuda").manual_seed(seed)
    inputs = []
    for (b, n, d), bd in zip(cases, pool_bounds(cfg, cases, seed)):
        area = psroi_ops.bin_areas(*bd)[..., None]
        go = torch.randn(b, n, k, k, d, device="cuda", generator=g)
        inputs.append((torch.where(area > 0, go / area.clamp(min=1.0), 0.0)
                       .contiguous(), bd))
    err = 0.0
    for ghat, bd in inputs:
        got = psroi_ops.psroi_bwd_cuda(ghat, *bd, h, w, bf16)
        torch.cuda.synchronize()
        want = psroi_ops.psroi_bwd_plain(ghat, *bd, h, w, bf16).float()
        e = (got.float() - want).abs().max().item()
        tol = BWD_REL_TOL * want.abs().max().item()
        if not e <= tol:
            raise AssertionError(f"psroi backward kernel vs plain, ghat "
                                 f"{tuple(ghat.shape)}: max abs err {e} > "
                                 f"{tol}")
        err = max(err, e)
    ms = time_ms(lambda: [psroi_ops.psroi_bwd_cuda(gh, *bd, h, w, bf16)
                          for gh, bd in inputs], iters=20)
    plain_ms = time_ms(lambda: [psroi_ops.psroi_bwd_plain(gh, *bd, h, w, bf16)
                                for gh, bd in inputs], iters=3, warmup=1)
    lib_inputs = [(*(x.to(bf16) for x in
                     psroi_ops.interval_indicators(*bd, h, w)), gh.to(bf16))
                  for gh, bd in inputs]
    library = lambda: [torch.einsum("bnpy,bnpqd,bnqx->byxpqd", r, gb, c)
                       for r, c, gb in lib_inputs]
    lib_err = max((lib.reshape(b, h, w, -1).float()
                   - psroi_ops.psroi_bwd_plain(gh, *bd, h, w, bf16).float())
                  .abs().max().item()
                  for lib, (b, _, _), (gh, bd) in zip(library(), cases,
                                                      inputs))
    library_ms = time_ms(library, iters=3, warmup=1)
    adds = sum(psroi_ops.bin_areas(*bd).sum().item() * d
               for (_, _, d), (_, bd) in zip(cases, inputs))
    nbytes = sum(b * h * w * k * k * d * 2 + gh.numel() * 4
                 + 4 * bd[0].numel() * 4
                 for (b, _, d), (gh, bd) in zip(cases, inputs))
    bound_ms, bound_by = bound(nbytes, adds)
    log(f"psroi_direct_bwd [{path}]: ghat {[tuple(gh.shape) for gh, _ in inputs]}"
        f" f32 -> bf16 maps, k={k}: max_abs_err {err:.3g} (tol {BWD_REL_TOL} "
        f"of the largest per call), kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, library einsum {library_ms:.4f} ms (bf16, max abs diff "
        f"{lib_err:.3g}), bound_us {bound_ms * 1e3:.1f} ({bound_by}, "
        f"{nbytes / 1e6:.1f} MB, {adds / 1e9:.3f} G adds), "
        f"{bound_ms / ms:.1%} of the bound")
    return {"name": "psroi_direct_bwd", "path": path, "route": "cuda",
            "source": "dtt_torch/ops/csrc/psroi.cu",
            "replaces": "dtt/ops/psroi.py:479",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def phase_psroi_mm(cfg: Config, seed: int) -> dict:
    """Kernel 4 (``dtt_psroi_sat``) at one pair batch's shapes (the fused
    maps of its PAIR_BATCH first frames at the test proposals, float32):
    the bin sums against the plain version and the mean mode that the pair
    path runs against ``bin_means`` of the plain sums, both bit for bit;
    times of both, of the sums and the division as two steps (the pool
    before the mean mode) and of the SAT build."""
    m = cfg.model
    k = m.roi.ps_grid
    hh, ww = cfg.input.canvas_height, cfg.input.canvas_width
    h, w = hh // 16, ww // 16
    dc = m.num_classes
    d = dc + (8 if m.roi.class_agnostic else 4 * dc) + 4
    b, n = PAIR_BATCH, m.rpn.post_nms_top_n_test
    g = torch.Generator(device="cuda").manual_seed(seed)
    maps = torch.randn(b, h, w, k * k * d, device="cuda", generator=g)
    table = psroi_ops.sat(maps).contiguous()
    bd = [x.contiguous() for x in psroi_ops.roi_bounds(
        draw_rois(np.random.RandomState(seed), b, n, hh, ww),
        1.0 / m.anchors.feat_stride, k, h, w)]
    sums = psroi_ops.psroi_mm_sums_cuda(table, *bd)
    means = psroi_ops.psroi_mm_means_cuda(table, *bd)
    torch.cuda.synchronize()
    want = psroi_ops.psroi_mm_sums_plain(table, *bd)
    err = max(exact_err(sums, want, "psroi_mm sums (pair)"),
              exact_err(means, psroi_ops.bin_means(want, *bd),
                        "psroi_mm mean mode (pair)"))
    sums_ms = time_ms(lambda: psroi_ops.psroi_mm_sums_cuda(table, *bd),
                      iters=20)
    ms = time_ms(lambda: psroi_ops.psroi_mm_means_cuda(table, *bd), iters=20)
    two_step_ms = time_ms(lambda: psroi_ops.bin_means(
        psroi_ops.psroi_mm_sums_cuda(table, *bd), *bd), iters=20)
    plain_ms = time_ms(lambda: psroi_ops.psroi_mm_means_plain(table, *bd),
                       iters=3, warmup=1)
    sat_ms = time_ms(lambda: psroi_ops.sat(maps), iters=20)
    r, c = psroi_ops.row_col_indicators(*bd, h, w)
    s6 = table.reshape(b, h + 1, w + 1, k, k, d)
    library = lambda: torch.einsum("bnpy,byxpqd,bnqx->bnpqd", r, s6, c)
    lib_err = (library() - sums).abs().max().item()
    library_ms = time_ms(library, iters=3, warmup=1)
    # bytes this run's bins need: each distinct SAT corner of a non-empty
    # bin read once (D channels), the means written once, the bounds read;
    # 3 subtractions and a division an output
    bound_ms, bound_by, nbytes, corners = sat_bound(bd, b, h, w, k, d,
                                                    means.numel(), 4)
    # the same in the whole 32-byte sectors the corner runs touch
    sectors = sat_sector_bytes(bd, b, h, w, k, d)
    sector_ms, _ = bound(nbytes - corners * d * 4 + sectors, 0)
    log(f"psroi_mm [pair]: SAT {tuple(table.shape)} f32, {n} RoIs, k={k}, "
        f"D={d}: max_abs_err {err:.3g} (bit for bit), mean mode {ms:.4f} "
        f"ms, bin sums {sums_ms:.4f} ms, bin sums + bin_means {two_step_ms:.4f}"
        f" ms, plain {plain_ms:.4f} ms, library einsum {library_ms:.4f} ms "
        f"(f32 bin sums, max abs diff {lib_err:.3g}), SAT build "
        f"{sat_ms:.4f} ms, bound_us {bound_ms * 1e3:.1f} ({bound_by}, "
        f"{nbytes / 1e6:.1f} MB: {corners} distinct corners of non-empty "
        f"bins x {d} channels), {bound_ms / ms:.1%} of the bound; in whole "
        f"32-byte sectors: bound_us {sector_ms * 1e3:.1f} ({sectors / 1e6:.1f}"
        f" MB of the table), {sector_ms / ms:.1%} of it")
    return {"name": "psroi_mm", "path": "pair", "route": "cuda",
            "source": "dtt_torch/ops/csrc/psroi.cu",
            "replaces": "dtt/ops/psroi.py:311",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def exact_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """max |got - want|; raises unless it is 0 (the SAT kernels repeat
    their plain versions' operations in the same order)."""
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if err != 0.0 or got.shape != want.shape:
        raise AssertionError(f"{what}: max abs err {err} against the plain "
                             f"version, want 0 ({tuple(got.shape)} vs "
                             f"{tuple(want.shape)})")
    return err


def sat_bound(bd: list, b: int, h: int, w: int, k: int, d: int,
              outputs: int, ops_per_output: int) -> tuple:
    """(bound ms, what bounds it, bytes, distinct corners) of a SAT pool
    call: each distinct table corner of a non-empty bin read once (D
    float32 channels), the f32 outputs written once, the bounds read."""
    hs, he, ws, we = (x.long() for x in bd)
    dev = hs.device
    slab = ((torch.arange(b, device=dev)[:, None, None, None] * k
             + torch.arange(k, device=dev)[:, None]) * k
            + torch.arange(k, device=dev)) * ((h + 1) * (w + 1))
    full = psroi_ops.bin_areas(*bd) > 0                     # (B, N, k, k)
    keys = torch.cat([(slab + y[..., :, None] * (w + 1) + x[..., None, :])[full]
                      for y in (hs, he) for x in (ws, we)])
    corners = torch.unique(keys).numel()
    nbytes = corners * d * 4 + outputs * 4 + 4 * bd[0].numel() * 4
    return (*bound(nbytes, ops_per_output * outputs, F32_OPS_PER_S), nbytes,
            corners)


def sat_sector_bytes(bd: list, b: int, h: int, w: int, k: int,
                     d: int) -> int:
    """Distinct bytes of the (B, H+1, W+1, k*k*D) float32 table that the
    corners of non-empty bins read, in whole 32-byte sectors: each
    corner's run of D channels rounded out to its sectors, each sector
    counted once."""
    hs, he, ws, we = (x.long() for x in bd)
    dev = hs.device
    c = k * k * d
    frame = torch.arange(b, device=dev)[:, None, None, None]
    bins = torch.arange(k * k, device=dev).reshape(k, k)
    full = psroi_ops.bin_areas(*bd) > 0                     # (B, N, k, k)
    start = 4 * torch.cat([
        (((frame * (h + 1) + y[..., :, None]) * (w + 1) + x[..., None, :]) * c
         + bins * d)[full] for y in (hs, he) for x in (ws, we)])
    first, last = start // 32, (start + 4 * d - 1) // 32
    hit = torch.zeros(-(-b * (h + 1) * (w + 1) * c * 4 // 32),
                      dtype=torch.bool, device=dev)
    for i in range(int((last - first).max().item()) + 1 if len(start) else 0):
        hit[(first + i)[first + i <= last]] = True
    return int(hit.sum().item()) * 32


def phase_frame_pools(cfg: Config, seed: int) -> list:
    """Kernels 5 and 6 at one frame's shapes: ``dtt_psroi_sat`` (the
    per-frame ``pallas_mm`` pool: its mean mode, and its bin sums) and
    ``dtt_psroi_sat_mean`` (the ``pallas`` pool) on one frame's float32
    cls, bbox and track tables at the test proposals, each form as one
    grouped launch of the three tables and as three single launches, every
    output bit for bit against its plain version. Times are for the three
    tables; the SAT build is timed on its own."""
    m = cfg.model
    k = m.roi.ps_grid
    hh, ww = cfg.input.canvas_height, cfg.input.canvas_width
    h, w = hh // 16, ww // 16
    dc = m.num_classes
    ds = (dc, 8 if m.roi.class_agnostic else 4 * dc, 4)
    n = m.rpn.post_nms_top_n_test
    g = torch.Generator(device="cuda").manual_seed(seed)
    maps = [torch.randn(1, h, w, k * k * d, device="cuda", generator=g)
            for d in ds]
    tables = [psroi_ops.sat(x).contiguous() for x in maps]
    rng = np.random.RandomState(seed)
    bds = [[x.contiguous() for x in psroi_ops.roi_bounds(
        draw_rois(rng, 1, n, hh, ww), 1.0 / m.anchors.feat_stride, k, h, w)]
        for _ in ds]
    calls = list(zip(tables, bds))
    sat_ms = time_ms(lambda: [psroi_ops.sat(x) for x in maps], iters=20)
    lib_inputs = [(*psroi_ops.row_col_indicators(*bd, h, w),
                   t.reshape(1, h + 1, w + 1, k, k, -1)) for t, bd in calls]
    library = lambda: [torch.einsum("bnpy,byxpqd,bnqx->bnpqd", r, s6, c)
                       for r, c, s6 in lib_inputs]
    library_ms = time_ms(library, iters=3, warmup=1)
    group = psroi_ops.psroi_sat_group_cuda
    run = {"grouped": lambda form: group(form, calls),
           "single": lambda form: [group(form, [call])[0] for call in calls]}
    forms = (("psroi_mm", ("mm_means", "mm_sums"), "dtt/ops/psroi.py:226"),
             ("psroi_sat_mean", ("sat_means",), "dtt/ops/psroi.py:586"))
    entries = []
    for name, modes, replaces in forms:
        err, times = 0.0, {}
        for form in modes:              # the first is what the path runs
            plain = psroi_ops.SAT_PLAIN[form]
            wants = [plain(t, *bd) for t, bd in calls]
            for how, fn in run.items():
                outs = fn(form)
                torch.cuda.synchronize()
                err = max([err] + [exact_err(o, wt, f"{name} {form} {how} "
                                                    f"(frame, D={d})")
                                   for o, wt, d in zip(outs, wants, ds)])
                times[form, how] = time_ms(lambda: fn(form), iters=20)
            if form == modes[0]:
                plain_ms = time_ms(lambda: [plain(t, *bd) for t, bd in calls],
                                   iters=3, warmup=1)
        ms = times[modes[0], "grouped"]
        bounds = [sat_bound(bd, 1, h, w, k, d, n * k * k * d, 4)
                  for (_, bd), d in zip(calls, ds)]
        nbytes = sum(x[2] for x in bounds)
        bound_ms, bound_by = bound(nbytes, sum(4 * n * k * k * d for d in ds),
                                   F32_OPS_PER_S)
        log(f"{name} [frame]: SAT {[tuple(t.shape) for t, _ in calls]} f32, "
            f"{n} RoIs, k={k}, D={ds}: max_abs_err {err:.3g} (bit for bit), "
            + ", ".join(f"{form} {how} {t:.4f} ms"
                        for (form, how), t in times.items())
            + f" (grouped: one launch for the three tables), plain "
            f"{plain_ms:.4f} ms, library einsum {library_ms:.4f} ms (f32 bin "
            f"sums), bound_us {bound_ms * 1e3:.2f} ({bound_by}, "
            f"{nbytes / 1e6:.2f} MB: {[x[3] for x in bounds]} distinct "
            f"corners of non-empty bins), {bound_ms / ms:.1%} of the bound")
        entries.append({"name": name, "path": "frame", "route": "cuda",
                        "source": "dtt_torch/ops/csrc/psroi.cu",
                        "replaces": replaces, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library_ms})
    log(f"SAT build [frame]: 3 tables {[tuple(t.shape) for t in tables]} "
        f"f32: {sat_ms:.4f} ms")
    return entries


def device_ms(fn, iters: int = 10):
    """Device time of one call of `fn` by ``torch.profiler``: its kernels'
    summed durations (no launch gaps), averaged over `iters` calls; None
    where the profiler recorded no device kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters if us else None


def phase_correlation_forms(cfg: Config, pairs: int, seed: int) -> list:
    """Both correlation forward kernels on one set of inputs, `pairs`
    pairs x 3 scales: the unsplit kernel 1 (``correlation_cuda``) and the
    channel-split kernel 7 (``correlation_split_cuda``), each against the
    plain version and timed in turns (split, unsplit, unsplit, split) by
    CUDA events (device time: ``phase_correlation_device``). Prints kernel 7's
    form per scale (``split_plan``'s ranks, the launch's clusters and
    cudaOccupancyMaxActiveClusters) and checks that three runs of it give
    the same bits. Returns their entries for the single-frame path."""
    t = cfg.model.track
    d, s = t.max_displacement, t.stride
    cases = corr_inputs(cfg, pairs, seed)
    for f1, _ in cases:
        form = corr_ops.split_form(tuple(f1.shape), f1.dtype, d, s)
        if not (1 <= form["ranks"] <= 8 and form["max_active_clusters"] >= 1):
            raise AssertionError(f"split form {form}")
        log(f"split form ({pairs} pair(s), C={f1.shape[-1]}): "
            f"{form['body']}, {form['ranks']} rank(s) of "
            f"{form['channels']} channels, {form['clusters']} clusters, "
            f"{form['max_active_clusters']} resident at once")
    kernels = {"correlation": corr_ops.correlation_cuda,
               "correlation_split": corr_ops.correlation_split_cuda}
    errs = dict.fromkeys(kernels, 0.0)
    for f1, f2 in cases:
        want = corr_ops.correlation_plain(f1, f2, d, s)
        for name, kernel in kernels.items():
            got = kernel(f1, f2, d, s)
            torch.cuda.synchronize()
            errs[name] = max(errs[name], corr_check(
                got, want, f"{name} kernel vs plain ({pairs} pairs, "
                           f"C={f1.shape[-1]})"))
    runs = [[corr_ops.correlation_split_cuda(a, c, d, s) for a, c in cases]
            for _ in range(3)]
    torch.cuda.synchronize()
    if not all(x.view(torch.int16).equal(y.view(torch.int16))
               for run in runs[1:] for x, y in zip(runs[0], run)):
        raise AssertionError(f"three runs of the split kernel ({pairs} "
                             f"pairs) differ")
    calls = {name: lambda kernel=kernel: [kernel(a, c, d, s)
                                          for a, c in cases]
             for name, kernel in kernels.items()}
    ms = dict.fromkeys(kernels, 0.0)
    for name in ("correlation_split", "correlation", "correlation",
                 "correlation_split"):
        ms[name] += time_ms(calls[name], iters=20) / 2
    plain_ms = time_ms(lambda: [corr_ops.correlation_plain(a, c, d, s)
                                for a, c in cases], iters=3, warmup=1)
    bound_ms, bound_by, nbytes, ops = corr_bound(cases, d, s)
    log(f"correlation forms: {pairs} pair(s) x 3 scales "
        f"{[tuple(c[0].shape) for c in cases]} bf16 d={d} s={s}: split "
        f"kernel {ms['correlation_split']:.4f} ms (max_abs_err "
        f"{errs['correlation_split']:.3g}, 3 runs bit-equal), unsplit kernel "
        f"{ms['correlation']:.4f} ms (max_abs_err {errs['correlation']:.3g}),"
        f" tol 2^-7 |want| + 1e-5; plain {plain_ms:.4f} ms, library: none, bound_us {bound_ms * 1e3:.1f} "
        f"({bound_by}, {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP); share "
        f"of the bound by events: split "
        f"{bound_ms / ms['correlation_split']:.1%}, unsplit "
        f"{bound_ms / ms['correlation']:.1%}")
    replaces = {"correlation": "dtt/ops/correlation.py:135",
                "correlation_split": "dtt/ops/correlation.py:275"}
    return [{"name": name, "path": "frame", "route": "cuda",
             "source": "dtt_torch/ops/csrc/correlation.cu",
             "replaces": replaces[name], "max_abs_err": errs[name],
             "ms": ms[name], "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None} for name in kernels]


def phase_correlation_device(cfg: Config) -> None:
    """The profiler's device time of both correlation forwards on
    ``phase_correlation_forms``' inputs (one pair, seed 10; 16 pairs, seed
    1), beside the bound. It runs after the main paths: once the profiler
    has traced the card, every later launch costs the host more, which
    slows the launch-bound paths (NMS loops) that follow."""
    t = cfg.model.track
    d, s = t.max_displacement, t.stride
    for pairs, seed in ((1, 10), (FRAMES_PER_CHUNK - 1, 1)):
        cases = corr_inputs(cfg, pairs, seed)
        bound_ms = corr_bound(cases, d, s)[0]
        shown = []
        for name, kernel in (("split", corr_ops.correlation_split_cuda),
                             ("unsplit", corr_ops.correlation_cuda)):
            v = device_ms(lambda: [kernel(a, c, d, s) for a, c in cases],
                          iters=20)
            shown.append(f"{name} not measured" if v is None else
                         f"{name} {v:.4f} ms, {bound_ms / v:.1%} of the "
                         f"bound")
        log(f"correlation forms, device (profiler): {pairs} pair(s) x 3 "
            f"scales: {'; '.join(shown)}")


def phase_wide_windows(seed: int) -> None:
    """Windows that dtt takes past the tensor-core band, d=16/s=4 and
    d=10/s=2, in bf16 and f32 on two pairs of 38x68 maps (256 channels):
    ``correlation(impl=auto|pallas_mm|pallas)`` forward and backward, each
    against the plain versions (bf16: 2^-7 |want| + 1e-5 element by
    element, f32: 1e-5), with the body that ran and the kernels launched."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    for dtype in (torch.bfloat16, torch.float32):
        f1, f2 = (torch.randn(2, 38, 68, 256, device="cuda", generator=g)
                  .to(dtype) for _ in range(2))
        for d, s in WIDE_WINDOWS:
            nd2 = corr_ops.num_corr_channels(d, s)
            go = torch.randn(2, 38, 68, nd2, device="cuda",
                             generator=g).to(dtype)
            want = (corr_ops.correlation_plain(f1, f2, d, s),
                    *corr_ops.correlation_bwd_plain(f1, f2, go, d, s))
            body = corr_ops.correlation_body(dtype, d, s)
            for impl in ("auto", "pallas_mm", "pallas"):
                a, b = (x.clone().requires_grad_() for x in (f1, f2))
                before = read_launches()
                out = corr_ops.correlation(a, b, d, s, impl)
                out.backward(go)
                torch.cuda.synchronize()
                launched = {n: c - before[n] for n, c in
                            read_launches().items() if c > before[n]}
                fwd = "correlation_split" if impl == "pallas" else "correlation"
                if launched != {fwd: 1, "correlation_bwd": 1}:
                    raise AssertionError(f"wide window d={d} s={s} {impl} "
                                         f"{dtype}: launched {launched}")
                errs = []
                for name, x, y in zip(("out", "df1", "df2"),
                                      (out, a.grad, b.grad), want):
                    what = (f"wide window d={d} s={s} {impl} {dtype} "
                            f"{name}")
                    if dtype == torch.bfloat16:
                        errs.append(corr_check(x, y, what))
                    else:
                        e = (x - y).abs().max().item()
                        if not e <= 1e-5:
                            raise AssertionError(f"{what}: max abs err {e}")
                        errs.append(e)
                log(f"wide window d={d} s={s} {str(dtype)[6:]} impl={impl}: "
                    f"body {body} forward and backward; launched "
                    f"{launched}; max abs err out/df1/df2 "
                    f"{[f'{e:.3g}' for e in errs]}")


def nms_calls(cfg: Config, path: str) -> list:
    """(name, P, K, M, IoU threshold, score threshold) of each NMS of one
    call of `path`: the proposal layer of a video chunk's 16 frames (17 on
    the parallel chunk's one rank), a train step's 2 frames a pair, a pair
    batch's 4 or one frame, then the per-class NMS of those frames (30
    classes at the test proposals), or OHEM's on the train step's frames
    (the train proposals and the gt slots)."""
    r, e, m = cfg.model.rpn, cfg.eval, cfg.model
    # the proposal layer keeps at most the map's anchors
    anchors = (m.anchors.num_anchors * (cfg.input.canvas_height // 16)
               * (cfg.input.canvas_width // 16))
    if path in TRAIN_PATHS:
        frames = 2 * cfg.train.batch_size_per_chip
        t = cfg.train
        return [("proposals", frames, min(r.pre_nms_top_n_train, anchors),
                 r.post_nms_top_n_train, r.nms_thresh, -0.5),
                ("ohem", frames, r.post_nms_top_n_train
                 + cfg.input.max_gt_boxes, t.ohem_top_k, t.ohem_nms_thresh,
                 -0.5)]
    frames = {**VIDEO_FRAMES, "pair": PAIR_BATCH, "frame": 1}[path]
    return [("proposals", frames, min(r.pre_nms_top_n_test, anchors),
             r.post_nms_top_n_test, r.nms_thresh, -0.5),
            ("per_class", frames * (m.num_classes - 1), r.post_nms_top_n_test,
             e.max_per_class, e.nms_thresh, e.score_thresh)]


def nms_inputs(problem: dict) -> tuple:
    return (torch.from_numpy(problem["boxes"]).cuda(),
            torch.from_numpy(problem["scores"]).cuda(), problem["iou"],
            problem["m"], torch.from_numpy(problem["valid"]).cuda(),
            problem["score"])


def nms_exact(args: tuple, block: int, what: str) -> torch.Tensor:
    """The kernel's (keep_idx, keep_valid) on `args` at width `block` in
    each order of the zeros against the plain form of that order, bit for
    bit: the total order against the block loop, the tied zeros against
    the one-at-a-time loop; returns its steps in the total order."""
    *fast, steps = nms_ops.nms_cuda(*args, select_block=block,
                                    return_steps=True)
    tied = nms_ops.nms_cuda(*args, select_block=block, total_order=False)
    torch.cuda.synchronize()
    for form, got, want in (
            ("nms_padded_fast", fast,
             nms_ops.nms_padded_fast_plain(*args, select_block=block)),
            ("nms_padded", tied, nms_ops.nms_padded_plain(*args))):
        for name, x, y in zip(("keep_idx", "keep_valid"), got, want):
            if not torch.equal(x, y):
                raise AssertionError(
                    f"nms kernel vs plain {form} ({what}, select_block "
                    f"{block}): {name} differs in {int((x != y).sum())} of "
                    f"{x.numel()} slots")
    return steps


def phase_nms(cfg: Config, path: str, seed: int) -> dict:
    """The NMS kernel's calls of one call of `path` (at the config's
    select_block), each bit for bit against both plain forms, with its
    dependent steps; times for all of the calls by CUDA events: the
    kernel, the plain one-at-a-time loop and the plain block loop."""
    cases = load_test_helper("nms_cases")
    calls = []
    for i, (name, p, k, m, iou, score) in enumerate(nms_calls(cfg, path)):
        block = (cfg.model.rpn.nms_select_block if name == "proposals"
                 else cfg.eval.nms_select_block if name == "per_class"
                 else nms_ops.KERNEL_BLOCK)         # OHEM: nms_padded
        args = nms_inputs(cases.path_problem(
            name, p, k, m, iou, score, seed + i,
            classes=cfg.model.num_classes - 1))
        steps = nms_exact(args, block, f"{path} {name} P={p} K={k} M={m}")
        calls.append((name, args, block, steps))
    ms = time_ms(lambda: [nms_ops.nms_cuda(*a, select_block=b)
                          for _, a, b, _ in calls], iters=20)
    # each call alone, and its ms a dependent step
    per_call = {}
    for n, a, b, s in calls:
        one = time_ms(lambda: nms_ops.nms_cuda(*a, select_block=b), iters=20)
        per_call[n] = {"ms": one, "steps": int(s.max()),
                       "ms_per_step": one / max(int(s.max()), 1)}
    plain_ms = time_ms(lambda: [nms_ops.nms_padded_plain(*a)
                                for _, a, _, _ in calls], iters=3, warmup=1)
    fast_ms = time_ms(lambda: [nms_ops.nms_padded_fast_plain(
        *a, select_block=b) for _, a, b, _ in calls], iters=3, warmup=1)
    # each box (16 B), score (4) and valid flag (1) read once; each slot
    # (8 + 1) and each problem's step count (4) written once
    nbytes = sum(a[1].numel() * 21 + a[1].shape[0] * (a[3] * 9 + 4)
                 for _, a, _, _ in calls)
    bound_ms, bound_by = bound(nbytes, 0)
    desc = "; ".join(
        f"{n} P={a[1].shape[0]} K={a[1].shape[1]} M={a[3]} block {b}: "
        f"dependent steps max {int(s.max())}, mean {s.float().mean():.1f}, "
        f"layout {nms_ops.nms_layout(a[1].shape[1])}, "
        f"{per_call[n]['ms']:.4f} ms alone, "
        f"{per_call[n]['ms_per_step'] * 1e3:.2f} us a dependent step"
        for n, a, b, s in calls)
    log(f"nms [{path}]: {desc}; bit-equal to both plain forms; kernel "
        f"{ms:.4f} ms, plain nms_padded {plain_ms:.4f} ms, plain "
        f"nms_padded_fast {fast_ms:.4f} ms, library: none (no PyTorch call "
        f"computes padded greedy NMS), bound_us {bound_ms * 1e3:.2f} "
        f"({bound_by}, {nbytes / 1e6:.2f} MB), {bound_ms / ms:.2%} of the "
        f"bound")
    return {"name": "nms", "path": path, "route": "cuda",
            "source": "dtt_torch/ops/csrc/nms.cu",
            "replaces": "dtt/ops/nms.py:75 (nms_padded_fast, XLA's "
                        "lax.while_loop; no TPU kernel)",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "plain_fast_ms": fast_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "steps": {n: int(s.max()) for n, _, _, s in calls},
            "calls": per_call}


def phase_nms_crafted() -> None:
    """The NMS kernel on the crafted cases (ties, IoU at the threshold,
    the budget filling inside a step, no valid box, thresholds >= 1, a NaN
    score, a masked box selected below -1e10), +0.0 tied with -0.0 and
    walks past 1,024 positions at every width of NMS_BLOCKS, bit for bit
    against both plain forms; below -1e10 against the block loop at the
    kernel's widths; unsorted proposals, 12,000 boxes and the most the
    kernel takes (the scratch layout), sorted and not."""
    helper = load_test_helper("nms_cases")
    cases = [*helper.crafted_cases(), helper.signed_zero_problem()]
    for c in cases:
        for block in NMS_BLOCKS:
            nms_exact(nms_inputs(c), block, c["name"])
    log(f"nms crafted cases: {len(cases)} cases x select_block "
        f"{list(NMS_BLOCKS)} bit-equal to both plain forms "
        f"({', '.join(c['name'] for c in cases)})")
    # +0.0 against -0.0: each dispatcher on the card as its plain form on
    # the CPU, and the two forms apart
    zero = helper.signed_zero_problem()
    cpu = tuple(x.cpu() if isinstance(x, torch.Tensor) else x
                for x in nms_inputs(zero))
    outs = {}
    for form, plain in ((nms_ops.nms_padded_fast,
                         nms_ops.nms_padded_fast_plain),
                        (nms_ops.nms_padded, nms_ops.nms_padded_plain)):
        got = [x.cpu() for x in form(*nms_inputs(zero))]
        if not all(torch.equal(x, y) for x, y in zip(got, plain(*cpu))):
            raise AssertionError(f"{form.__name__} on the card vs its plain "
                                 f"form on the CPU, signed zeros")
        outs[form.__name__] = got
    if torch.equal(outs["nms_padded_fast"][0], outs["nms_padded"][0]):
        raise AssertionError("nms: the signed-zero case does not tell the "
                             "two orders apart")
    log("nms signed zeros: nms_padded_fast (+0.0 first) and nms_padded "
        "(tied) on the card bit-equal to their plain forms on the CPU, and "
        "apart from each other")
    # walks past the first 1,024 positions (more than a block's threads)
    walks = []
    for c in helper.long_walk_problems():
        args = nms_inputs(c)
        steps = {b: int(nms_exact(args, b, c["name"]).max())
                 for b in NMS_BLOCKS}
        idx, val = nms_ops.nms_padded_plain(*args)
        end = min(helper.walk_end(c, idx.cpu().numpy(), val.cpu().numpy()))
        if end <= 1024:
            raise AssertionError(f"nms {c['name']}: the walk ends at "
                                 f"position {end}, not past 1,024")
        walks.append(f"{c['name']} (walk through >= {end} positions, steps "
                     f"max by select_block {steps})")
    log(f"nms long walks bit-equal to both plain forms at select_block "
        f"{list(NMS_BLOCKS)}: {'; '.join(walks)}")
    # below -1e10 the width decides: the block loop at the kernel's width,
    # and nms_padded on the card against the one-at-a-time loop
    args = nms_inputs(helper.below_masked_problem())
    for block in (1, 4, 16, 32):
        got = nms_ops.nms_cuda(*args, select_block=block)
        want = nms_ops.nms_padded_fast_plain(*args, select_block=block)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"nms kernel vs plain nms_padded_fast below "
                                 f"-1e10 at select_block {block}")
    if not all(torch.equal(x, y) for x, y in zip(
            nms_ops.nms_padded(*args), nms_ops.nms_padded_plain(*args))):
        raise AssertionError("nms_padded on the card vs plain below -1e10")
    # unsorted proposals and the scratch layout, sorted and not
    big = []
    for name, p, k, seed in (("video_proposals", 16, 6000, 30),
                             ("train_proposals", 2, 12000, 31),
                             ("train_proposals", 1, nms_ops._entry()[1], 32)):
        c = helper.path_problem(name, p, k, 300, 0.7, -0.5, seed=seed)
        for form, prob in (("sorted", c),
                           ("unsorted", helper.permuted(c, seed)[0])):
            if form == "sorted" and k == 6000:
                continue                            # phase_nms's shape
            what = f"{form} P={p} K={k}"
            steps = nms_exact(nms_inputs(prob), 32, what)
            big.append(f"{what} ({nms_ops.nms_layout(k).body}, steps max "
                       f"{int(steps.max())})")
    log(f"nms below -1e10 bit-equal to the block loop at widths 1/4/16/32 "
        f"and nms_padded to the one-at-a-time loop; bit-equal to both "
        f"plain forms at select_block 32: {'; '.join(big)}")


def link_inputs(kw: dict) -> tuple:
    helper = load_test_helper("linking_cases")
    return tuple(torch.from_numpy(x).cuda() for x in helper.detections(**kw))


def link_exact(args: tuple, k: int, boost: str, weight: float,
               what: str) -> float:
    """The linking kernel against its plain form on the card: paths, tube
    validity, tube scores and claimed detections bit for bit, rescored
    scores within LINK_TOL; returns max |d rescored|."""
    got = link_ops.link_cuda(*args, max_tubes=k, link_iou_weight=weight,
                             score_boost=boost)
    torch.cuda.synchronize()
    want = link_ops.link_all_classes_plain(*args, max_tubes=k,
                                           link_iou_weight=weight,
                                           score_boost=boost)
    for name in ("det_idx", "tube_valid", "tube_score", "det_in_tube"):
        x, y = getattr(got, name), getattr(want, name)
        same = (x == y) | (x.isnan() & y.isnan()) if x.is_floating_point() \
            else x == y
        if not bool(same.all()):
            raise AssertionError(
                f"linking kernel vs plain ({what}, {boost}): {name} differs "
                f"in {int((~same).sum())} of {x.numel()}")
    x, y = got.rescored, want.rescored
    same = (x == y) | (x.isnan() & y.isnan())     # NaN and inf where equal
    err = torch.where(same, torch.zeros_like(x), (x - y).abs())
    if not bool((same | (err <= LINK_TOL * (1 + y.abs()))).all()):
        raise AssertionError(f"linking kernel vs plain ({what}, {boost}): "
                             f"rescored off by {err.max().item():.3g}")
    return err.max().item()


def link_timing(cfg: Config, t: int, seed: int, what: str) -> dict:
    """The linking kernel at the eval widths (the 30 classes,
    eval.max_per_class slots, eval.max_tubes_per_class tubes) and `t`
    frames on detections made as tests/linking_cases.py makes them, under
    every score boost against the plain form; CUDA-event times of the
    kernel and of the plain form on the card at the config's boost, the
    roofline bound and the chain the kernel cannot avoid, logged."""
    e = cfg.eval
    c = cfg.model.num_classes - 1
    n, k, w = e.max_per_class, e.max_tubes_per_class, e.link_iou_weight
    args = link_inputs(dict(seed=seed, c=c, t=t, n=n))
    err = max(link_exact(args, k, b, w, f"{what} C={c} T={t} N={n} K={k}")
              for b in LINK_BOOSTS)
    kw = dict(max_tubes=k, link_iou_weight=w, score_boost=e.tube_score_boost)
    ms = time_ms(lambda: link_ops.link_cuda(*args, **kw), iters=20)
    dev_ms = device_ms(lambda: link_ops.link_cuda(*args, **kw), iters=20)
    plain_ms = time_ms(lambda: link_ops.link_all_classes_plain(*args, **kw),
                       iters=3, warmup=1)
    # each box and tracked box (16 + 16 B), score (4) and valid flag (1)
    # read once, each rescored score (4) and claim flag (1) written once,
    # and a tube's path (8 T), validity (1) and score (4). Float32
    # operations the function needs: a box's area (2 subtractions, 2
    # additions, 2 clamps, a product) once a box of frames 0..T-2's tracked
    # boxes and frames 1..T-1's boxes; the IoU and its weight once a pair
    # (i, j) of consecutive frames a class, since no tube changes them (a
    # min and a max, a subtraction and an addition an axis: 8; 2 clamps and
    # a product; the union's addition and subtraction; its test and the
    # division; the weight's product: 16); then a tube's link and
    # candidate a pair (p_t + p_t+1, + w IoU, + v, the max: 4).
    pairs = c * (t - 1) * n * n
    ops = c * (t - 1) * 2 * n * 7 + pairs * 16 + k * pairs * 4
    nbytes = c * t * n * 42 + c * k * (8 * t + 5)
    bound_ms, bound_by = bound(nbytes, ops, F32_OPS_PER_S)
    # the chain: tubes claim in turn and a tube's frames are a max-plus
    # recurrence, so a class is K (T - 1) dependent frame steps and K T
    # dependent backtrack steps; the classes run side by side
    steps = k * (t - 1) + k * t
    lay = link_ops.link_layout(t, n)
    log(f"linking [{what}]: C={c} T={t} N={n} K={k} ({lay.body} layout, "
        f"{lay.smem} B shared, in scratch {list(lay.in_scratch)}): "
        f"decisions and tube scores bit-equal to the plain form under "
        f"{list(LINK_BOOSTS)}, rescored max_abs_err {err:.3g} (tol "
        f"{LINK_TOL} (1 + |want|)); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms ({e.tube_score_boost}), kernel device ms "
        f"{dev_ms} (torch.profiler), library: none (no "
        f"PyTorch call links tubes), bound_us {bound_ms * 1e3:.3f} "
        f"({bound_by}, {nbytes / 1e3:.1f} KB, {ops / 1e6:.1f} M float32 "
        f"ops), {bound_ms / ms:.3%} of the bound; chain {steps} dependent "
        f"steps a class ({k} x {t - 1} frame steps + {k} x {t} backtrack), "
        f"{ms * 1e6 / steps:.1f} ns a step by the events"
        + ("" if dev_ms is None else
           f", {dev_ms * 1e6 / steps:.1f} by the device time"))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_linking(cfg: Config, path: str, seed: int) -> dict:
    """The linking kernel at the shapes of the eval path `path`
    (LINK_FRAMES[path] frames), as `link_timing` gives it, as an entry of
    the kernels line."""
    timing = link_timing(cfg, LINK_FRAMES[path], seed, path)
    return {"name": "linking", "path": path, "route": "cuda",
            "source": "dtt_torch/ops/csrc/linking.cu",
            "replaces": "dtt/eval/linking.py:80 (link_tubes, XLA's lax.scan "
                        "program vmapped over the classes; no TPU kernel)",
            **timing, "library_ms": None}


def phase_linking_cases() -> None:
    """The linking kernel on every problem of tests/linking_cases.py
    (the eval widths with and without tied scores, 45 slots, one frame,
    the scratch layout) under every score boost, against its plain form."""
    helper = load_test_helper("linking_cases")
    done = []
    for name, kw, k in helper.kernel_cases():
        args = link_inputs(kw)
        err = max(link_exact(args, k, b, 1.0, name) for b in LINK_BOOSTS)
        lay = link_ops.link_layout(kw["t"], kw["n"])
        done.append(f"{name} C={kw['c']} T={kw['t']} N={kw['n']} K={k} "
                    f"({lay.body}, {lay.smem} B shared, {lay.scratch} B "
                    f"scratch a class: {list(lay.in_scratch)}; max |d "
                    f"rescored| {err:.3g})")
    log(f"linking cases under {list(LINK_BOOSTS)}: decisions and tube "
        f"scores bit-equal to the plain form: {'; '.join(done)}")


def epilogue_args(form: str, shape: tuple, dtype: torch.dtype, gen,
                  special: float = 0.0) -> tuple:
    """Kernel 10's arguments (x, scale, bias, z, scale_z, bias_z) for one
    call: channels-last tensors ~N(0, 2) with a share `special` of NaN,
    +-inf and +-0.0, buffers ~N(1, 0.5) and ~N(0, 1), -0.0 among them."""
    def tensor():
        x = torch.randn(shape, device="cuda", generator=gen) * 2
        if special:
            table = torch.tensor([float("nan"), float("inf"), float("-inf"),
                                  0.0, -0.0], device="cuda")
            pick = torch.rand(shape, device="cuda", generator=gen)
            x = torch.where(pick < special,
                            table[(pick * 1e6).long() % len(table)], x)
        return x.to(dtype).contiguous(memory_format=torch.channels_last)

    def buffers():
        c = shape[1]
        s = 1 + 0.5 * torch.randn(c, device="cuda", generator=gen)
        b = torch.randn(c, device="cuda", generator=gen)
        return s, torch.where(b.abs() < 0.1, torch.full_like(b, -0.0), b)

    x, (s, b) = tensor(), buffers()
    z = None if form == "A" else tensor()
    t, c = buffers() if form == "C" else (None, None)
    return x, s, b, z, t, c


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    ints = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.shape == b.shape and torch.equal(a.view(ints), b.view(ints))


def phase_epilogue_exact(cfg: Config) -> None:
    """Kernel 10 (``dtt_conv_epilogue`` and its backward) bit for bit
    against its plain version at each distinct (form, shape) of a
    ``Config()`` trunk call at its canvas, on EPI_EXACT_FRAMES frames,
    every form in bf16 and f32, with NaN, +-inf and +-0.0 among the
    inputs; the backward with and without the shortcut's gradient."""
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    n = 0
    for frames in EPI_EXACT_FRAMES:
        shapes = sorted({(f, s) for _, f, s in
                         trunk_epilogue_calls(cfg, frames)})
        for dtype in (torch.bfloat16, torch.float32):
            for i, (form, shape) in enumerate(shapes):
                gen = torch.Generator(device="cuda").manual_seed(60 + i)
                args = epilogue_args(form, shape, dtype, gen, special=0.05)
                y = epilogue_ops.conv_epilogue_cuda(*args)
                torch.cuda.synchronize()
                want = epilogue_ops.conv_epilogue_plain(*args)
                if not same_bits(y, want):
                    raise AssertionError(f"epilogue kernel vs plain: form "
                                         f"{form} {shape} {dtype} not "
                                         f"bit-equal")
                g = epilogue_args("A", shape, dtype, gen, special=0.05)[0]
                s, t = args[1], args[4]
                want_g = epilogue_ops.conv_epilogue_bwd_plain(g, want, s,
                                                              form, t)
                for want_gz in (True, False):
                    got_g = epilogue_ops.conv_epilogue_bwd_cuda(
                        g, y, s, form, t, want_gz)
                    torch.cuda.synchronize()
                    ok = same_bits(got_g[0], want_g[0]) and (
                        (got_g[1] is None) == (form == "A" or not want_gz))
                    if got_g[1] is not None:
                        ok = ok and same_bits(got_g[1], want_g[1])
                    if not ok:
                        raise AssertionError(f"epilogue backward kernel vs "
                                             f"plain: form {form} {shape} "
                                             f"{dtype} not bit-equal")
                n += 1
    log(f"epilogue exact: {n} (form, shape, dtype) calls of a "
        f"{cfg.model.backbone} trunk at {h}x{w} on {EPI_EXACT_FRAMES} "
        f"frame(s), with NaN, +-inf and +-0.0: forward and backward bit for "
        f"bit against the plain version")


def phase_epilogue_trunk(cfg: Config) -> None:
    """The whole trunk through kernel 10 against its eager form: a
    ``Config()`` backbone (PyTorch's initialisation from a seed, then BN
    calibration, through the kernel) on one frame, c3, c4 and c5 bit for
    bit against the same backbone with the dispatcher patched to the plain
    version (one launch a recorded call, the calls a meta-device trunk
    records); then the trunk alone on EPI_TRUNK_FRAMES frames, fused
    against unfused, by CUDA events."""
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    layers = _BACKBONES[cfg.model.backbone]
    dtype = getattr(torch, cfg.model.dtype)
    torch.manual_seed(70)
    bb = ResNetBackbone(layers, cfg.model.frozen_stages, device="cuda").to(
        memory_format=torch.channels_last)
    gen = torch.Generator(device="cuda").manual_seed(71)
    frames = (torch.randn(EPI_TRUNK_FRAMES, 3, h, w, device="cuda",
                          generator=gen) * 60).to(dtype).contiguous(
        memory_format=torch.channels_last)
    t0 = time.perf_counter()
    calibrate.calibrate_backbone(bb, frames[:2])
    calib_s = time.perf_counter() - t0
    seen = []

    def plain(x, scale, bias, z=None, scale_z=None, bias_z=None):
        seen.append((epilogue_ops.form_of(z, scale_z), tuple(x.shape)))
        return epilogue_ops.conv_epilogue_plain(x, scale, bias, z, scale_z,
                                                bias_z)

    one = frames[:1]
    with torch.no_grad():
        before = epilogue_ops.conv_epilogue_cuda.launches
        fused = bb(one)
        launched = epilogue_ops.conv_epilogue_cuda.launches - before
        with mock.patch.object(epilogue_ops, "conv_epilogue", plain):
            eager = bb(one)
        torch.cuda.synchronize()
        want_calls = [c[1:] for c in trunk_epilogue_calls(cfg, 1)]
        if seen != want_calls or launched != len(want_calls) or \
                launched != 1 + 3 * sum(layers):
            raise AssertionError(f"trunk epilogue calls: {len(seen)} "
                                 f"recorded, {launched} launched, "
                                 f"{len(want_calls)} expected")
        for name, a, b in zip(("c3", "c4", "c5"), fused, eager):
            if not same_bits(a, b):
                raise AssertionError(f"trunk {name} through kernel 10 is not "
                                     "bit-equal to the eager form")
            if not torch.isfinite(a.float()).all():
                raise AssertionError(f"trunk {name} has non-finite values")
        ms = time_ms(lambda: bb(frames), iters=5)
        with mock.patch.object(epilogue_ops, "conv_epilogue",
                               epilogue_ops.conv_epilogue_plain):
            eager_ms = time_ms(lambda: bb(frames), iters=5)
        ms2 = time_ms(lambda: bb(frames), iters=5)
    log(f"epilogue trunk: {cfg.model.backbone} at {h}x{w} {dtype}, "
        f"calibrated in {calib_s:.1f} s; one frame's c3, c4, c5 through "
        f"kernel 10 bit-equal to the eager form, "
        f"{launched} launches; the trunk alone on {EPI_TRUNK_FRAMES} frames: "
        f"fused {ms:.3f} / {ms2:.3f} ms, eager {eager_ms:.3f} ms (CUDA "
        f"events, fused, eager, fused)")
    del bb, frames, fused, eager
    torch.cuda.empty_cache()


def trunk_epilogue_calls(cfg: Config, frames: int) -> list:
    """(trained, form, shape) of each kernel 10 call of one call of
    ``cfg``'s trunk on `frames` frames at its canvas, in order, recorded
    through the dispatcher on a meta-device trunk whose parameters are
    frozen as ``DnT`` freezes them; trained: the call records a gradient,
    so a train step runs its backward."""
    with torch.device("meta"):
        bb = ResNetBackbone(_BACKBONES[cfg.model.backbone],
                            cfg.model.frozen_stages)
    for name, p in bb.named_parameters():
        p.requires_grad_(not is_frozen("backbone." + name,
                                       cfg.model.frozen_stages))
    seen = []

    def record(x, scale, bias, z=None, scale_z=None, bias_z=None):
        seen.append((x.requires_grad, epilogue_ops.form_of(z, scale_z),
                     tuple(x.shape)))
        return epilogue_ops.conv_epilogue_plain(x, scale, bias, z, scale_z,
                                                bias_z)

    with mock.patch.object(epilogue_ops, "conv_epilogue", record):
        bb(torch.empty(frames, 3, cfg.input.canvas_height,
                       cfg.input.canvas_width, device="meta",
                       dtype=getattr(torch, cfg.model.dtype)))
    return seen


def epilogue_calls(cfg: Config, path: str) -> list:
    """``trunk_epilogue_calls`` of one trunk call of `path` (a train
    path's trunk takes its batch's two frames a pair)."""
    return trunk_epilogue_calls(cfg, EPI_FRAMES[path] if path in EPI_FRAMES
                                else 2 * cfg.train.batch_size_per_chip)


def phase_epilogue(cfg: Config, path: str, seed: int,
                   backward: bool = False) -> dict:
    """Kernel 10 at one trunk call of `path` (its forward, or with
    `backward` its backward at every trained block, the shortcut's
    gradient wanted as the train step wants it), in the model's dtype:
    each distinct call bit for bit against the plain version, then CUDA
    event times of all the calls through the kernel and the plain
    version, beside the bound of the bytes they move."""
    dtype = getattr(torch, cfg.model.dtype)
    calls = [c for c in epilogue_calls(cfg, path) if not backward or c[0]]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    inputs = {}
    for _, form, shape in calls:
        if (form, shape) not in inputs:
            args = epilogue_args(form, shape, dtype, gen)
            g = epilogue_args("A", shape, dtype, gen)[0]
            y = epilogue_ops.conv_epilogue_plain(*args)
            inputs[form, shape] = (args, g, y)
    if backward:
        kernel = lambda a, g, y, f: epilogue_ops.conv_epilogue_bwd_cuda(
            g, y, a[1], f, a[4])
        plain = lambda a, g, y, f: epilogue_ops.conv_epilogue_bwd_plain(
            g, y, a[1], f, a[4])
    else:
        kernel = lambda a, g, y, f: (epilogue_ops.conv_epilogue_cuda(*a),)
        plain = lambda a, g, y, f: (epilogue_ops.conv_epilogue_plain(*a),)
    for (form, shape), (a, g, y) in inputs.items():
        got, want = kernel(a, g, y, form), plain(a, g, y, form)
        torch.cuda.synchronize()
        if not all(x is None and v is None or same_bits(x, v)
                   for x, v in zip(got, want)):
            raise AssertionError(f"epilogue{'_bwd' if backward else ''} "
                                 f"kernel vs plain ({path}): form {form} "
                                 f"{shape} not bit-equal")
    run = lambda fn: [fn(*inputs[f, s], f) for _, f, s in calls]
    ms = time_ms(lambda: run(kernel), iters=10)
    plain_ms = time_ms(lambda: run(plain), iters=3, warmup=1)
    esize = torch.finfo(dtype).bits // 8
    nbytes = ops = 0
    for _, form, shape in calls:
        n, c = int(np.prod(shape)), shape[1]
        if backward:
            nbytes += n * esize * (3 if form == "A" else 4) + 4 * c * (
                2 if form == "C" else 1)
            ops += n * (3 if form == "C" else 2)
        else:
            nbytes += n * esize * (2 if form == "A" else 3) + 4 * c * (
                4 if form == "C" else 2)
            ops += n * {"A": 3, "B": 4, "C": 7}[form]
    bound_ms, bound_by = bound(nbytes, ops, F32_OPS_PER_S)
    frames = calls[0][2][0]
    name = "epilogue_bwd" if backward else "epilogue"
    log(f"{name} [{path}]: {len(calls)} calls of a "
        f"{cfg.model.backbone} trunk on {frames} frame(s) at "
        f"{cfg.input.canvas_height}x{cfg.input.canvas_width} {dtype} "
        f"({len(inputs)} distinct, each bit-equal to the plain version; "
        f"{epilogue_design()}): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e9:.3f} GB), "
        f"{bound_ms / ms:.1%} of the bound")
    del inputs
    torch.cuda.empty_cache()
    if not backward:
        phase_epilogue_host(cfg, path)
    return {"name": name, "path": path, "route": "cuda",
            "source": "dtt_torch/ops/csrc/epilogue.cu",
            "replaces": "dtt/models/resnet.py:101",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def epilogue_design() -> str:
    """The device design of kernel 10, with its sizes as its source sets
    them."""
    with open(os.path.join(os.path.dirname(epilogue_ops.__file__), "csrc",
                           "epilogue.cu")) as f:
        text = f.read()
    size = {k: re.search(rf"constexpr int {k} = (\d+);", text).group(1)
            for k in ("kUnroll", "kMinBlocks")}
    return (f"design control: {size['kUnroll']} 16-byte loads a thread in "
            f"flight, {size['kMinBlocks']} blocks an SM")


def phase_epilogue_host(cfg: Config, path: str) -> None:
    """The host's cost of one call of kernel 10's wrappers by part
    (``tools/epilogue_host_torch.py``) at `path`'s trunk calls, the
    gradient's parts at a train path's trained calls: medians of at least
    1,000 calls, µs a call, beside an eager ``torch.add`` of the same
    tensors."""
    calls = epilogue_calls(cfg, path)
    if path not in TRAIN_PATHS:
        calls = [(False, f, s) for _, f, s in calls]
    tool = load_tool("epilogue_host_torch")
    split = tool.host_split(epilogue_ops, calls,
                            rounds=-(-1000 // len(calls)),
                            dtype=getattr(torch, cfg.model.dtype))
    torch.cuda.empty_cache()
    log(f"epilogue host [{path}]: µs a call (median of {split['calls']}): "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items()
                    if isinstance(v, float)))


def phase_bench(card: str) -> None:
    """``bench_torch.py``'s measurement at its defaults (its JSON line and
    its statistics)."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = bench_torch.main([])
    log(f"bench_torch (defaults): {json.dumps(out)} on {card}, "
        f"{time.perf_counter() - t0:.1f} s with set-up")


def with_mode(cfg: Config, mode: str) -> Config:
    return cfg.replace(model=cfg.model.replace(
        roi=cfg.model.roi.replace(pooling_mode=mode)))


def tiny_config(mode: str = "psroi") -> Config:
    cfg = Config()
    m = cfg.model
    return with_mode(cfg.replace(
        model=m.replace(backbone="tiny", dtype="float32", frozen_stages=0,
                        reduced_channels=64, num_classes=4,
                        rpn=m.rpn.replace(channels=32, pre_nms_top_n_test=64,
                                          post_nms_top_n_test=16),
                        roi=m.roi.replace(ps_grid=3),
                        track=m.track.replace(max_displacement=2, stride=1)),
        input=cfg.input.replace(canvas_height=64, canvas_width=96)), mode)


def phase_reference(mode: str = "psroi") -> None:
    """Tiny config, float32: kernels on the card vs plain versions on the
    CPU, end to end, under pooling mode `mode`. `valid` equal; values to
    float32 roundoff."""
    cfg = tiny_config(mode)
    tree = init_jax_params(cfg.model, seed=3)
    frames = np.random.RandomState(5).randint(0, 256, (7, 64, 96, 3)).astype(
        np.uint8)
    outs = []
    for dev in ("cpu", "cuda"):
        model = from_jax_params(tree, cfg.model, device=dev)
        step = make_video_step(cfg, model, 4, device=dev)
        outs.append(evaluate_snippet_video(cfg, step, frames, im_hw=(56, 80)))
    (cb, cs, cv, ct), (gb, gs, gv, gt) = outs
    np.testing.assert_array_equal(gv, cv)
    np.testing.assert_allclose(gs, cs, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gb, cb, rtol=0, atol=1e-2)
    np.testing.assert_allclose(gt, ct, rtol=0, atol=1e-2)
    log(f"reference [{mode}]: tiny config f32, card vs CPU: "
        f"{int(gv.sum())} valid detections equal; max |d score| "
        f"{np.abs(gs - cs).max():.3g}, "
        f"max |d box| {np.abs(gb - cb).max():.3g}")


def phase_pair_reference() -> None:
    """Tiny config, float32, SAT pool: the tau=2 pair step and tube
    linking through the kernels on the card against the plain versions on
    the CPU. `valid`, tube validity and claimed detections equal; scores
    and rescored scores to 1e-4, boxes to 1e-2 (float32 roundoff of a
    whole network, as the video reference)."""
    cfg = tiny_config()
    cfg = cfg.replace(model=cfg.model.replace(
        roi=cfg.model.roi.replace(eval_pool_impl="pallas_mm")))
    tree = init_jax_params(cfg.model, seed=3)
    frames = np.random.RandomState(5).randint(0, 256, (7, 64, 96, 3)).astype(
        np.uint8)
    outs = {}
    before = psroi_ops.psroi_mm_sums_cuda.launches
    for dev in ("cpu", "cuda"):
        model = from_jax_params(tree, cfg.model, device=dev)
        step = make_pair_step(cfg, model, 3, device=dev)
        boxes, scores, valid, tracked, ts = evaluate_snippet(
            cfg, step, frames, tau=2, im_hw=(56, 80))
        _, tubes = link_snippet(cfg, boxes, scores, tracked, valid, dev)
        outs[dev] = (boxes, scores, valid, tracked, tubes)
    if psroi_ops.psroi_mm_sums_cuda.launches == before:
        raise AssertionError("the pair reference did not launch the SAT "
                             "kernel")
    (cb, cs, cv, ct, ctub), (gb, gs, gv, gt, gtub) = outs["cpu"], outs["cuda"]
    np.testing.assert_array_equal(gv, cv)
    np.testing.assert_array_equal(gtub.tube_valid, ctub.tube_valid)
    np.testing.assert_array_equal(gtub.det_in_tube, ctub.det_in_tube)
    np.testing.assert_allclose(gs, cs, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gtub.rescored, ctub.rescored, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(gb, cb, rtol=0, atol=1e-2)
    np.testing.assert_allclose(gt, ct, rtol=0, atol=1e-2)
    log(f"pair reference: tiny config f32, pallas_mm, tau=2 keyframes {ts}, "
        f"card vs CPU: {int(gv.sum())} valid detections equal, "
        f"{int(gtub.tube_valid.sum())} tubes and {int(gtub.det_in_tube.sum())}"
        f" claimed detections equal; max |d score| {np.abs(gs - cs).max():.3g}"
        f", max |d rescored| {np.abs(gtub.rescored - ctub.rescored).max():.3g}"
        f", max |d box| {np.abs(gb - cb).max():.3g}")


def phase_frame_reference() -> None:
    """Tiny config, float32: the single-frame step, every per-frame pool
    form and the split correlation, each with its gradients, through the
    kernels on the card against the plain versions on the CPU. The step:
    `valid` equal, scores to 1e-4, boxes to 1e-2 (as the video reference).
    Pools: rtol 1e-5 with an atol of 8 float32 ulps of the SAT's largest
    entry (the table is a cumsum in another order on each device), map
    gradients to 1e-5 of the largest. Correlation: 1e-5, gradients 1e-5."""
    cfg = tiny_config()
    tree = init_jax_params(cfg.model, seed=3)
    image = np.random.RandomState(6).randint(0, 256, (1, 64, 96, 3)).astype(
        np.uint8)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = from_jax_params(tree, cfg.model, device=dev)
        step = make_single_frame_step(cfg, model, device=dev)
        outs[dev] = [x.cpu().numpy() for x in step(torch.from_numpy(image),
                                                   (56, 80))]
    (cb, cs, cv), (gb, gs, gv) = outs["cpu"], outs["cuda"]
    np.testing.assert_array_equal(gv, cv)
    np.testing.assert_allclose(gs, cs, rtol=0, atol=1e-4)
    np.testing.assert_allclose(gb, cb, rtol=0, atol=1e-2)
    rng = np.random.RandomState(7)
    h, w, k, d = 10, 14, 7, 9
    maps = torch.from_numpy(rng.randn(h, w, k * k * d).astype(np.float32))
    xy = rng.uniform(-40, w * 16, (40, 2))
    rois = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(0, 200, (40, 2))], axis=-1).astype(np.float32))
    go = torch.from_numpy(rng.randn(40, k, k, d).astype(np.float32))
    atol = 8 * np.finfo(np.float32).eps * psroi_ops.sat(maps[None]).abs().max()
    before = read_launches()
    worst = {}
    for impl in ("xla", "mm", "pallas_mm", "pallas"):
        res = []
        for dev in ("cpu", "cuda"):
            m = maps.to(dev).detach().clone().requires_grad_()
            out = psroi_ops.psroi_pool(m, rois.to(dev), 1 / 16, k, impl)
            out.backward(go.to(dev))
            res.append((out.detach().cpu(), m.grad.cpu()))
        (co, cg), (go_, gg) = res
        torch.testing.assert_close(go_, co, rtol=1e-5, atol=atol.item())
        torch.testing.assert_close(gg, cg, rtol=0,
                                   atol=1e-5 * cg.abs().max().item())
        worst[impl] = (go_ - co).abs().max().item()
    f1, f2 = (torch.from_numpy(rng.randn(2, 7, 11, 160).astype(np.float32))
              for _ in range(2))
    gc = torch.from_numpy(rng.randn(2, 7, 11, 81).astype(np.float32))
    res = []
    for dev in ("cpu", "cuda"):
        a, b = (x.to(dev).detach().clone().requires_grad_()
                for x in (f1, f2))
        out = corr_ops.correlation(a, b, 8, 2, "pallas")
        out.backward(gc.to(dev))
        res.append([x.detach().cpu() for x in (out, a.grad, b.grad)])
    for x, y in zip(res[1], res[0]):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-5)
    launched = {n: c - before[n] for n, c in read_launches().items()
                if c > before[n]}
    for name in ("psroi_mm", "psroi_sat_mean", "correlation_split",
                 "correlation_bwd"):
        if name not in launched:
            raise AssertionError(f"the frame reference did not launch {name}")
    log(f"frame reference: tiny config f32, card vs CPU: single-frame step "
        f"{int(gv.sum())} valid detections equal, max |d score| "
        f"{np.abs(gs - cs).max():.3g}, max |d box| {np.abs(gb - cb).max():.3g};"
        f" psroi_pool max |d| by impl {worst} (atol {atol.item():.3g}); "
        f"correlation pallas max |d| {(res[1][0] - res[0][0]).abs().max():.3g}"
        f", gradients equal to 1e-5; launches {launched}")


def stage_timer():
    """(stage, times): ``stage(name, fn)`` runs fn after a synchronize and
    synchronizes after it, recording host wall ms (launches included) and
    device ms between CUDA events into ``times[name]``."""
    times: dict = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        out = fn()
        ev[1].record()
        torch.cuda.synchronize()
        times[name] = ((time.perf_counter() - t0) * 1e3,
                       ev[0].elapsed_time(ev[1]))
        return out

    return stage, times


def log_stages(what: str, times: dict) -> None:
    parts = ", ".join(f"{n} {wall:.2f} ms wall / {dev:.2f} ms device"
                      for n, (wall, dev) in times.items())
    total = sum(wall for wall, _ in times.values())
    log(f"stages ({what}, synchronized): {parts}; sum {total:.2f} ms wall")


def phase_stages(cfg: Config, model, frames: np.ndarray, path: str) -> None:
    """One video chunk's or one pair batch's time by stage, the step's
    stages run one by one with a synchronize after each. The video chunk
    pairs adjacent frames and pools directly; the pair batch pairs frames
    0::2 with 1::2 and pools off the SAT (``pallas_mm``)."""
    mcfg, ecfg = cfg.model, cfg.eval
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    anchors = torch.from_numpy(grid_anchors_for(mcfg.anchors, h // 16,
                                                w // 16)).cuda()
    im_hw = torch.tensor([h, w], dtype=torch.float32, device="cuda")
    if path == "video":
        n, halves = FRAMES_PER_CHUNK, (slice(None, -1), slice(1, None))
        what = f"one {n}-frame chunk"
    else:
        n, halves = 2 * PAIR_BATCH, (slice(0, None, 2), slice(1, None, 2))
        mcfg = mcfg.replace(roi=mcfg.roi.replace(eval_pool_impl="pallas_mm"))
        what = f"one {PAIR_BATCH}-pair batch, SAT pool"
    chunk = torch.from_numpy(frames[:n]).cuda()
    dc = mcfg.num_classes
    db = 8 if mcfg.roi.class_agnostic else 4 * dc
    stage, times = stage_timer()

    with torch.inference_mode():
        for _ in range(2):                  # report the second pass
            images = stage("normalize", lambda: normalize_device_images(
                chunk, im_hw, cfg.input.pixel_means))
            feats = stage("trunk", lambda: model.frame_trunk(images))
            f_t, f_tau = (feats.slice(x) for x in halves)
            fused = stage("corr+fused_psmaps",
                          lambda: model.fused_psmaps(f_t, f_tau))
            props = stage("proposals", lambda: proposal_layer(
                f_t.rpn_cls, f_t.rpn_bbox, anchors, im_hw[0], im_hw[1], 1.0,
                mcfg.rpn))
            pooled = stage("pool", lambda: pool_vote_fused(mcfg, fused,
                                                           props.rois))
            det = Detections(props.rois, props.valid,
                             softmax(pooled[..., :dc]), pooled[..., dc:dc + db])
            stage("decode+nms", lambda: decode_detections_batched(
                mcfg, det, im_hw[0], im_hw[1], ecfg.score_thresh,
                ecfg.nms_thresh, ecfg.max_per_class,
                track_deltas=pooled[..., dc + db:],
                select_block=ecfg.nms_select_block))
    log_stages(what, times)
    if path == "video":
        phase_pool_split(mcfg, fused, props.rois, pooled)
    else:
        phase_pair_pool_split(mcfg, fused, props.rois, pooled)


def phase_pool_split(mcfg, fused: torch.Tensor, rois: torch.Tensor,
                     pooled: torch.Tensor) -> None:
    """The video "pool" stage split into its steps as ``pool_vote_fused``
    runs them for the direct pool: the cast of the fused maps to the
    compute dtype, ``roi_bounds`` with the bin areas, the bin-sum kernel,
    the division by the area (and cast), and the mean over the bins; the
    result must equal the stage's."""
    k, dtype = mcfg.roi.ps_grid, getattr(torch, mcfg.dtype)
    _, h, w, _ = fused.shape
    scale = 1.0 / mcfg.anchors.feat_stride
    stage, times = stage_timer()

    def bounds():
        bd = [t.contiguous() for t in psroi_ops.roi_bounds(rois, scale, k, h,
                                                            w)]
        return bd, psroi_ops.bin_areas(*bd)[..., None]

    with torch.inference_mode():
        for _ in range(2):                  # report the second pass
            maps = stage("cast", lambda: fused.to(dtype).contiguous())
            bd, area = stage("roi_bounds+areas", bounds)
            sums = stage("kernel", lambda: psroi_ops.psroi_sums(maps, *bd))
            means = stage("division", lambda: torch.where(
                area > 0, sums / area.clamp(min=1.0),
                torch.zeros((), device=sums.device)).to(dtype))
            votes = stage("mean", lambda: means.float().mean(dim=(2, 3)))
    if not torch.equal(votes, pooled):
        raise AssertionError("the split pool stage differs from the stage")
    log_stages("the video pool stage, split", times)


def phase_pair_pool_split(mcfg, fused: torch.Tensor, rois: torch.Tensor,
                          pooled: torch.Tensor) -> None:
    """The pair batch's "pool" stage split into its steps as
    ``pool_vote_fused`` runs them for the SAT pool (``pallas_mm``):
    ``roi_bounds``, the SAT build, the kernel (bin sums over the areas in
    one launch) and the mean over the bins; the result must equal the
    stage's."""
    k = mcfg.roi.ps_grid
    _, h, w, _ = fused.shape
    scale = 1.0 / mcfg.anchors.feat_stride
    stage, times = stage_timer()
    with torch.inference_mode():
        for _ in range(2):                  # report the second pass
            bd = stage("roi_bounds", lambda: [t.contiguous() for t in
                                              psroi_ops.roi_bounds(
                                                  rois, scale, k, h, w)])
            table = stage("sat_build",
                          lambda: psroi_ops.sat(fused).contiguous())
            means = stage("kernel", lambda: psroi_ops.psroi_mm_means(
                table, *bd).to(fused.dtype))
            votes = stage("mean", lambda: means.mean(dim=(2, 3)))
    if not torch.equal(votes, pooled):
        raise AssertionError("the split pair pool stage differs from the "
                             "stage")
    log_stages("the pair-batch pool stage, split", times)


def phase_main_path(cfg: Config, card: str, tree: dict) -> dict:
    """The video path at full width, with the forward kernels' launches
    counted over one snippet (returned)."""
    m = cfg.model
    model = from_jax_params(tree, m, device="cuda")
    log(f"video path: {m.backbone} {cfg.input.canvas_height}x"
        f"{cfg.input.canvas_width} {m.dtype} compute, float32 parameters, "
        f"{m.num_classes} classes, k={m.roi.ps_grid}, "
        f"{m.rpn.post_nms_top_n_test} proposals")
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, (SNIPPET_FRAMES, cfg.input.canvas_height,
                                  cfg.input.canvas_width, 3)).astype(np.uint8)
    im_hw = (cfg.input.canvas_height - 8, cfg.input.canvas_width - 48)
    step = make_video_step(cfg, model, FRAMES_PER_CHUNK)
    # the peak from before the capture: replays allocate nothing
    torch.cuda.reset_peak_memory_stats()
    evaluate_snippet_video(cfg, step, frames[:FRAMES_PER_CHUNK], im_hw=im_hw)
    torch.cuda.synchronize()                        # warm-up: 2 chunks

    reset_launches()
    t0 = time.perf_counter()
    boxes, scores, valid, tracked = evaluate_snippet_video(
        cfg, step, frames, im_hw=im_hw)
    dt = time.perf_counter() - t0
    launches = read_launches()
    log(f"video path launches: {launches}")
    check_launches("video", launches)

    c, t, mm = m.num_classes - 1, SNIPPET_FRAMES, cfg.eval.max_per_class
    shapes = {"boxes": (boxes.shape, (c, t, mm, 4)),
              "scores": (scores.shape, (c, t, mm)),
              "valid": (valid.shape, (c, t, mm)),
              "tracked": (tracked.shape, (c, t, mm, 4))}
    for name, (got, want) in shapes.items():
        if got != want:
            raise AssertionError(f"{name} has shape {got}, want {want}")
    for name, x in (("boxes", boxes), ("scores", scores),
                    ("tracked", tracked)):
        if not np.isfinite(x).all():
            raise AssertionError(f"{name} has non-finite values")
    if valid.dtype != np.bool_ or not valid.any():
        raise AssertionError("no valid detection in the snippet")
    if not ((scores >= 0) & (scores <= 1)).all():
        raise AssertionError("scores outside [0, 1]")
    for x in (boxes, tracked):
        if x[..., 2].max() > im_hw[1] - 1 or x[..., 3].max() > im_hw[0] - 1:
            raise AssertionError("boxes reach past the true image extent")
    log(f"video path: {t} frames in chunks of {FRAMES_PER_CHUNK}: "
        f"{dt * 1e3:.1f} ms, {t / dt:.2f} pairs/s on {card}; "
        f"{int(valid.sum())} valid detections; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    phase_stages(cfg, model, frames, "video")
    phase_stages(cfg, model, frames, "pair")
    return launches


def train_tiny_config(mode: str = "psroi") -> Config:
    """The tiny training config of the CPU tests (tests/test_train.py)
    under pooling mode `mode`."""
    cfg = Config()
    m = cfg.model
    return with_mode(cfg.replace(
        model=m.replace(backbone="tiny", dtype="float32", frozen_stages=0,
                        reduced_channels=64, num_classes=4,
                        anchors=m.anchors.replace(scales=(1.0, 2.0, 4.0)),
                        rpn=m.rpn.replace(channels=32, pre_nms_top_n_train=128,
                                          post_nms_top_n_train=32),
                        roi=m.roi.replace(ps_grid=3, batch_size=16),
                        track=m.track.replace(max_displacement=2, stride=1)),
        train=cfg.train.replace(learning_rate=1e-3, ohem_top_k=16,
                                lr_decay_steps=(10**6,)),
        input=cfg.input.replace(canvas_height=64, canvas_width=96,
                                max_gt_boxes=4)), mode)


def worst_leaf(ratios: dict) -> tuple:
    """The largest of `ratios` (a value per leaf) and its leaf."""
    name = max(ratios, key=ratios.get)
    return ratios[name], name


def phase_train_reference(mode: str = "psroi") -> None:
    """Tiny config, float32, pooling mode `mode`: one train step through
    the kernels on the card against one through the plain versions on the
    CPU, from the same weights, batch and draws. Losses within
    TRAIN_REF_LOSS_TOL, every leaf's clipped gradient within
    TRAIN_REF_GRAD_REL of the leaf's largest element, the updated
    parameters element by element within TRAIN_REF_PARAM_TOL (atol,
    rtol)."""
    cfg = train_tiny_config(mode)
    tree = init_jax_params(cfg.model, seed=3)
    batch = synthetic_batch(np.random.RandomState(4), 2, 64, 96, 4, 4,
                            cfg.input.pixel_means, uint8=True)
    batch["im_size"][1] = (56, 80)
    draws = sample_draws(cfg, 2, torch.Generator().manual_seed(5))
    out = {}
    for dev in ("cpu", "cuda"):
        model, state = create_train_state(cfg, dev, tree=tree)
        step = make_train_step(cfg, model, (4, 6), dev)
        state, metrics = step(state, batch,
                              type(draws)(*(x.to(dev) for x in draws)))
        # the step leaves each trainable leaf's clipped gradient in .grad
        out[dev] = ({k: v.item() for k, v in metrics.items()},
                    {k: p.grad.cpu() for k, p in model.named_parameters()
                     if p.requires_grad},
                    {k: v.cpu() for k, v in model.state_dict().items()})
    (cpu_loss, cpu_grads, cpu_params) = out["cpu"]
    (gpu_loss, gpu_grads, gpu_params) = out["cuda"]
    loss_err = max(abs(gpu_loss[k] - cpu_loss[k]) for k in cpu_loss)
    grad_r, grad_leaf = worst_leaf({
        k: (gpu_grads[k] - v).abs().max().item()
        / max(v.abs().max().item(), 1e-30) for k, v in cpu_grads.items()})
    atol, rtol = TRAIN_REF_PARAM_TOL
    param_r, param_leaf = worst_leaf({
        k: ((gpu_params[k].double() - v.double()).abs()
            / (atol + rtol * v.double().abs())).max().item()
        for k, v in cpu_params.items()})
    if not (loss_err <= TRAIN_REF_LOSS_TOL and grad_r <= TRAIN_REF_GRAD_REL
            and param_r <= 1):
        raise AssertionError(
            f"train reference, card vs CPU: losses {gpu_loss} vs {cpu_loss};"
            f" worst gradient leaf {grad_leaf} off by {grad_r:.3g} of its "
            f"largest element (tol {TRAIN_REF_GRAD_REL}), worst parameter "
            f"{param_r:.3g} of its tolerance ({param_leaf})")
    log(f"train reference [{mode}]: tiny config f32, one step, card vs "
        f"CPU: max |d loss| {loss_err:.3g} (tol {TRAIN_REF_LOSS_TOL}); "
        f"{len(cpu_grads)} "
        f"gradient leaves, worst off by {grad_r:.3g} of the leaf's largest "
        f"(tol {TRAIN_REF_GRAD_REL}, {grad_leaf}); updated parameters worst at "
        f"{param_r:.3g} of {TRAIN_REF_PARAM_TOL} ({param_leaf}); max |grad| "
        f"{max(v.abs().max().item() for v in cpu_grads.values()):.3g}; total "
        f"{gpu_loss['total']:.6f}")


def phase_train(cfg: Config, tree: dict, card: str) -> dict:
    """The training path at full width: two warm-up steps (the second
    captures the program), then TRAIN_STEPS timed steps whose kernel
    launches are counted (returned);
    checks, a checkpoint round trip, PROFILE_STEPS steps under the
    profiler and one step split into stages."""
    m, t = cfg.model, cfg.train
    b = t.batch_size_per_chip
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    model, state = create_train_state(cfg, "cuda", tree=tree)
    step = make_train_step(cfg, model, (h // 16, w // 16))
    rng = np.random.RandomState(t.seed)
    gen = torch.Generator(device="cuda").manual_seed(t.seed + 1)
    batches = [synthetic_batch(rng, b, h, w, m.num_classes,
                               cfg.input.max_gt_boxes, cfg.input.pixel_means,
                               uint8=True,
                               num_objects=cfg.input.synthetic_objects)
               for _ in range(TRAIN_STEPS + PROFILE_STEPS + 3)]
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    log(f"train path: {m.backbone} {h}x{w} {m.dtype} compute, float32 "
        f"parameters, {m.num_classes} classes, k={m.roi.ps_grid}, "
        f"{m.rpn.pre_nms_top_n_train}/{m.rpn.post_nms_top_n_train} train "
        f"proposals, OHEM {t.ohem} top-{t.ohem_top_k} NMS "
        f"{t.ohem_nms_thresh}, batch {b} pair(s), frozen_stages "
        f"{m.frozen_stages}")
    torch.cuda.reset_peak_memory_stats()
    for i in range(2):       # eager, then captured as the step's program
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i],
                              sample_draws(cfg, b, gen, "cuda"))
        torch.cuda.synchronize()
        log(f"train warm-up step {i + 1}: "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    reset_launches()
    history = []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        state, metrics = step(state, batches[2 + i],
                              sample_draws(cfg, b, gen, "cuda"))
        history.append(metrics)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    log(f"train path launches ({TRAIN_STEPS} steps): {launches}")
    check_launches("train", launches)
    for metrics in history:
        values = {k: v.item() for k, v in metrics.items()}
        if not all(np.isfinite(v) for v in values.values()):
            raise AssertionError(f"non-finite loss: {values}")
        if not (values["rpn_cls"] > 0 and values["rfcn_cls"] > 0):
            raise AssertionError(f"zero classification loss: {values}")
    after = model.state_dict()
    moved = [k for k in initial if not torch.equal(initial[k], after[k])]
    frozen_moved = [k for k in moved if is_frozen(k, m.frozen_stages)]
    if frozen_moved:
        raise AssertionError(f"frozen leaves changed: {frozen_moved[:5]}")
    for prefix in ("backbone.layer2.", "backbone.layer3.", "backbone.layer4.",
                   "rpn.", "reduce.", "cls_maps.", "bbox_maps.",
                   "track_maps."):
        if not any(k.startswith(prefix) for k in moved):
            raise AssertionError(f"no leaf of {prefix} changed")
    ms = dt * 1e3 / TRAIN_STEPS
    log(f"train path: {TRAIN_STEPS} steps in {dt * 1e3:.1f} ms: {ms:.1f} "
        f"ms/step, {TRAIN_STEPS * b / dt:.3f} pairs/s on {card}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{len(moved)} of {len(initial)} leaves moved, none frozen; last "
        f"losses {json.dumps({k: round(v, 4) for k, v in values.items()})}")
    del initial, after

    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(d, state, cfg)
        _, fresh = create_train_state(cfg, "cuda", tree=tree)
        fresh = restore_checkpoint(path, fresh)
    same = fresh.step == state.step and all(
        torch.equal(v, state.model.state_dict()[k])
        for k, v in fresh.model.state_dict().items())
    bufs = [s_["momentum_buffer"] for s_ in state.optimizer.state.values()]
    fresh_bufs = [s_["momentum_buffer"]
                  for s_ in fresh.optimizer.state.values()]
    same = same and len(bufs) == len(fresh_bufs) > 0 and all(
        torch.equal(x, y) for x, y in zip(bufs, fresh_bufs))
    if not same:
        raise AssertionError("checkpoint did not restore bitwise")
    log(f"train checkpoint: step {fresh.step}, {len(bufs)} momentum buffers "
        "and every parameter restored bitwise")
    del fresh
    state = phase_train_profile(cfg, state, step, batches[-1 - PROFILE_STEPS:-1],
                                gen)
    phase_train_stages(cfg, state, batches[-1], gen)
    return launches


def busy_ms(intervals) -> float:
    """Total length of the union of (start, end) intervals in us, as ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def phase_train_profile(cfg: Config, state, step, batches: list, gen):
    """Full-width train steps under ``torch.profiler``: wall ms per step,
    the device's busy share (union of kernel intervals over the traced
    wall time), device kernels per step and the kernels with the most
    device time. Returns the state after the steps."""
    from torch.profiler import ProfilerActivity, profile
    b = cfg.train.batch_size_per_chip
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            state, _ = step(state, batch, sample_draws(cfg, b, gen, "cuda"))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    n = len(batches)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"train profile: {wall / n:.1f} ms/step wall; the profiler "
            "recorded no device events: busy share not measured")
        return state
    busy = busy_ms((e.time_range.start, e.time_range.end) for e in kernels)
    by_name: dict = {}
    for e in kernels:
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), count + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    log(f"train profile ({n} steps traced): {wall / n:.1f} ms/step wall; "
        f"device busy {busy / n:.1f} ms/step ({100 * busy / wall:.1f}% of "
        f"wall); {len(kernels) / n:.0f} device kernels/step")
    for name, (us, count) in top:
        log(f"  top kernel: {us / n / 1e3:.3f} ms/step, {count / n:.0f} "
            f"launches/step: {name[:90]}")
    return state


def phase_train_stages(cfg: Config, state, batch: dict, gen) -> None:
    """One train step's time by stage, run one by one with a synchronize
    after each (the second of two passes is reported)."""
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    anchors = torch.from_numpy(grid_anchors_for(cfg.model.anchors, h // 16,
                                                w // 16)).cuda()
    batch = batch_to_device(batch, torch.device("cuda"))
    draws = sample_draws(cfg, cfg.train.batch_size_per_chip, gen, "cuda")
    stage, times = stage_timer()
    for _ in range(2):
        state.optimizer.zero_grad(set_to_none=True)
        feats, track = stage("forward trunk+heads+corr", lambda:
                             train_losses.forward_heads(cfg, state.model,
                                                        batch))
        asg = stage("targets+proposals", lambda: train_losses.assign_targets(
            cfg, feats, anchors, batch, draws))
        lb = stage("pools+losses", lambda: train_losses.head_losses(
            cfg, feats, track, asg))
        stage("backward", lambda: lb.total.backward())
        state = stage("optimizer", lambda: apply_gradients(cfg, state))
    log_stages("one train step", times)


def run_eval(argv: list) -> tuple:
    """``eval_torch.main(argv)`` in this process, its printed lines logged
    with a prefix; returns its result, wall ms by phase and pairs."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = eval_torch.main(argv)
    for line in buf.getvalue().splitlines():
        log(f"  eval_torch: {line}")
    return out


def phase_eval(cfg: Config, tree: dict, card: str) -> dict:
    """The evaluation path at full width: the weights written as a port
    checkpoint, then ``eval_torch.main`` on the pair path (tau=2, SAT
    pool) and on the video path with linking, each once to warm up on one
    snippet and once with its kernel launches counted (returned per
    path)."""
    runs = {"pair": ["--synthetic-snippets", "2", "--synthetic-frames", "16",
                     "--tau", "2", "--set", "model.roi.eval_pool_impl=pallas_mm"],
            "eval_video": ["--synthetic-snippets", "1", "--synthetic-frames",
                           "16", "--link"]}
    launches = {}
    with tempfile.TemporaryDirectory() as d:
        _, state = create_train_state(cfg, "cuda", tree=tree)
        save_checkpoint(d, state, cfg)
        del state
        for path, flags in runs.items():
            argv = ["--synthetic", "--checkpoint", d, *flags]
            run_eval(argv + ["--max-snippets", "1"])
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            out, clock, pairs = run_eval(argv)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            launches[path] = read_launches()
            log(f"eval {path} launches: {launches[path]}")
            check_launches(path, launches[path])
            for key in ("mAP", "mAP_nolink", "link_uplift"):
                if not (key in out and np.isfinite(out[key])
                        and -1 <= out[key] <= 1):
                    raise AssertionError(f"eval {path}: {key} is "
                                         f"{out.get(key)!r}")
            split = ", ".join(f"{k} {v:.1f} ms" for k, v in clock.items())
            log(f"eval {path} ({' '.join(flags)}): {pairs} pairs in "
                f"{wall:.1f} ms wall ({split}); {pairs * 1e3 / clock['detect']:.2f}"
                f" pairs/s in detection, {pairs * 1e3 / wall:.2f} end to end on "
                f"{card}; mAP {out['mAP']}, mAP_nolink {out['mAP_nolink']}, "
                f"link_uplift {out['link_uplift']} (random weights)")
    return launches


def frame_detections(m, feats, props: Proposals) -> Detections:
    """``detect_frame``'s heads on one frame's features and proposals."""
    cls_score, bbox_pred = rfcn_head(m, feats.cls_maps[0], feats.bbox_maps[0],
                                     props.rois, 1.0 / m.anchors.feat_stride)
    return Detections(props.rois, props.valid, softmax(cls_score), bbox_pred)


def phase_frame_path(cfg: Config, tree: dict, card: str) -> dict:
    """The single-frame path at full width: ``make_single_frame_step`` on
    one warm-up and FRAME_STEPS timed uint8 frames; then, on the last
    frame's features and proposals, ``rfcn_head`` under every ``impl``
    (each against ``xla``: ``pallas`` to the bit, the SAT forms to the
    SAT's f32 error) and ``correlation`` under both kernel forms at one
    pair's three scales. The kernel launches of that run are returned;
    the per-impl timings after it are not counted."""
    m, ecfg = cfg.model, cfg.eval
    hh, ww = cfg.input.canvas_height, cfg.input.canvas_width
    model = from_jax_params(tree, m, device="cuda")
    step = make_single_frame_step(cfg, model)
    frames = np.random.RandomState(11).randint(
        0, 256, (FRAME_STEPS + 1, hh, ww, 3)).astype(np.uint8)
    im_hw = (hh - 8, ww - 48)
    log(f"frame path: {m.backbone} {hh}x{ww} {m.dtype} compute, float32 "
        f"parameters, {m.num_classes} classes, k={m.roi.ps_grid}, "
        f"{m.rpn.post_nms_top_n_test} proposals, single-frame R-FCN step")
    reset_launches()
    t0 = time.perf_counter()
    step(torch.from_numpy(frames[:1]), im_hw)
    torch.cuda.synchronize()
    log(f"frame warm-up: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    t0 = time.perf_counter()
    outs = [step(torch.from_numpy(frames[i:i + 1]), im_hw)
            for i in range(1, FRAME_STEPS + 1)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c, mm = m.num_classes - 1, ecfg.max_per_class
    for boxes, scores, valid in ([x.cpu().numpy() for x in o] for o in outs):
        if boxes.shape != (c, mm, 4) or scores.shape != (c, mm) or \
                valid.shape != (c, mm):
            raise AssertionError(f"frame outputs {boxes.shape} "
                                 f"{scores.shape} {valid.shape}")
        if not (np.isfinite(boxes).all() and np.isfinite(scores).all()):
            raise AssertionError("frame outputs have non-finite values")
        if not ((scores >= 0) & (scores <= 1)).all():
            raise AssertionError("frame scores outside [0, 1]")
        if boxes[..., 2].max() > im_hw[1] - 1 or \
                boxes[..., 3].max() > im_hw[0] - 1:
            raise AssertionError("frame boxes reach past the true extent")
    n_valid = sum(int(o[2].sum()) for o in outs)
    if not n_valid:
        raise AssertionError("no valid detection in the timed frames")
    log(f"frame path: {FRAME_STEPS} frames in {dt * 1e3:.1f} ms: "
        f"{dt * 1e3 / FRAME_STEPS:.2f} ms/frame, {FRAME_STEPS / dt:.2f} "
        f"frames/s on {card}; {n_valid} valid detections")

    anchors = torch.from_numpy(grid_anchors_for(m.anchors, hh // 16,
                                                ww // 16)).cuda()
    hw = torch.tensor(im_hw, dtype=torch.float32, device="cuda")
    image = torch.from_numpy(frames[-1:]).cuda()
    scale = 1.0 / m.anchors.feat_stride
    stage, times = stage_timer()
    with torch.inference_mode():
        for _ in range(2):                  # report the second pass
            feats = stage("trunk", lambda: model.frame_features(
                normalize_device_images(image, hw, cfg.input.pixel_means)))
            props = stage("proposals", lambda: Proposals(*(x[0] for x in (
                proposal_layer(feats.rpn_cls, feats.rpn_bbox, anchors, hw[0],
                               hw[1], 1.0, m.rpn)))))
            det = stage("heads", lambda: frame_detections(m, feats, props))
            stage("decode", lambda: decode_frame_detections(
                m, det, hw[0], hw[1], ecfg.score_thresh, ecfg.nms_thresh,
                ecfg.max_per_class))
        log_stages("one full-width frame", times)

        maps = (feats.cls_maps[0], feats.bbox_maps[0])
        heads = {impl: lambda impl=impl: rfcn_head(m, *maps, props.rois,
                                                   scale, impl)
                 for impl in ("xla", "mm", "pallas_mm", "pallas")}
        want = heads["xla"]()
        sat_atol = [8 * np.finfo(np.float32).eps
                    * psroi_ops.sat(x[None]).abs().max().item() for x in maps]
        # SAT kernel launches (dtt_psroi_sat, dtt_psroi_sat_mean) that one
        # rfcn_head call makes: one for both maps under the kernel forms
        sat_launches = lambda: (psroi_ops.psroi_mm_sums_cuda.launches,
                                psroi_ops.psroi_sat_means_cuda.launches)
        one_call = {"xla": (0, 0), "mm": (0, 0), "pallas_mm": (1, 0),
                    "pallas": (0, 1)}
        errs = {}
        for impl, fn in heads.items():
            before = sat_launches()
            got = fn()
            torch.cuda.synchronize()
            made = tuple(a - b for a, b in zip(sat_launches(), before))
            if made != one_call[impl]:
                raise AssertionError(f"rfcn_head({impl}) made SAT launches "
                                     f"(dtt_psroi_sat, dtt_psroi_sat_mean) "
                                     f"{made}, want {one_call[impl]}")
            errs[impl] = [(g - w_).abs().max().item()
                          for g, w_ in zip(got, want)]
            tol = [0.0] * 2 if impl in ("xla", "pallas") else [
                a + 1e-5 * w_.abs().max().item()
                for a, w_ in zip(sat_atol, want)]
            if not all(e <= t for e, t in zip(errs[impl], tol)):
                raise AssertionError(f"rfcn_head({impl}) vs xla: max abs err "
                                     f"{errs[impl]} > {tol}")
        pair = model.frame_trunk(normalize_device_images(
            torch.from_numpy(frames[-2:]).cuda(), hw, cfg.input.pixel_means))
        t = m.track
        corr_cases = [(cosine_prep(pair.corr_feats[sc][:1]).contiguous(),
                       cosine_prep(pair.corr_feats[sc][1:]).contiguous())
                      for sc in t.scales]
        corrs = {impl: lambda impl=impl: [
            corr_ops.correlation(a, b, t.max_displacement, t.stride, impl)
            for a, b in corr_cases] for impl in ("pallas_mm", "pallas")}
        corr_err = 0.0
        results = {impl: fn() for impl, fn in corrs.items()}
        for i, (a, b) in enumerate(corr_cases):
            plain = corr_ops.correlation_plain(a, b, t.max_displacement,
                                               t.stride)
            for impl in corrs:
                corr_err = max(corr_err, corr_check(
                    results[impl][i], plain, f"frame correlation ({impl}, "
                                             f"C={a.shape[-1]}) vs plain"))
        torch.cuda.synchronize()
        launches = read_launches()
        log(f"frame path launches: {launches}")
        check_launches("frame", launches)
        head_ms = {impl: time_ms(fn, iters=10) for impl, fn in heads.items()}
        corr_ms = {impl: time_ms(fn, iters=10) for impl, fn in corrs.items()}
    errs = {k: [f"{e:.3g}" for e in v] for k, v in errs.items()}
    log(f"frame heads (cls D={maps[0].shape[-1] // m.roi.ps_grid ** 2}, bbox "
        f"D={maps[1].shape[-1] // m.roi.ps_grid ** 2}, "
        f"{props.rois.shape[0]} RoIs) by impl: ms "
        f"{ {k: round(v, 4) for k, v in head_ms.items()} }, max abs err vs "
        f"xla (cls, bbox) {errs}; SAT kernel launches a call {one_call}")
    log(f"frame correlation at one pair x 3 scales "
        f"{[tuple(a.shape) for a, _ in corr_cases]} by impl: ms "
        f"{ {k: round(v, 4) for k, v in corr_ms.items()} }, max abs err vs "
        f"plain {corr_err:.3g} (tol 2^-7 |want| + 1e-5)")
    return launches


def timed_train(cfg: Config, state, step, stream, gen, label: str,
                card: str):
    """Two warm-up steps (the program captures at the second) and
    DATA_STEPS timed steps of `step` on batches pulled from `stream`:
    checks the losses and the train path's kernels, logs ms/step, pairs/s,
    the wait for batches, peak memory and launches a step. Returns the
    state and the timed ms/step."""
    b = cfg.train.batch_size_per_chip
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        state, _ = step(state, next(stream),
                        sample_draws(cfg, b, gen, "cuda"), gen)
    torch.cuda.synchronize()
    reset_launches()
    history, wait = [], 0.0
    t0 = time.perf_counter()
    for _ in range(DATA_STEPS):
        tw = time.perf_counter()
        batch = next(stream)
        wait += time.perf_counter() - tw
        state, metrics = step(state, batch, sample_draws(cfg, b, gen, "cuda"),
                              gen)
        history.append(metrics)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    check_launches("train", launches)
    for metrics in history:
        values = {k: v.item() for k, v in metrics.items()}
        if not all(np.isfinite(v) for v in values.values()):
            raise AssertionError(f"{label}: non-finite loss: {values}")
    ms = dt * 1e3 / DATA_STEPS
    per_step = {k: v / DATA_STEPS for k, v in launches.items() if v}
    log(f"data train ({label}): {DATA_STEPS} steps {ms:.1f} ms/step, "
        f"{DATA_STEPS * b / dt:.3f} pairs/s on {card}; waited "
        f"{wait * 1e3 / DATA_STEPS:.2f} ms/step for batches; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel "
        f"launches/step {per_step}; last losses "
        f"{json.dumps({k: round(v, 4) for k, v in values.items()})}")
    return state, ms


def load_test_helper(name: str):
    """This checkout's ``tests/<name>.py``, loaded by its path: the card's
    machine has another ``tests`` package on its path, which ``import
    tests.<name>`` would find first."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def vid_tree_writer():
    """``write_vid_tree`` of this checkout's ``tests/vid_tree.py``."""
    return load_test_helper("vid_tree").write_vid_tree


def phase_data(cfg: Config, tree: dict, card: str) -> None:
    """The data path at full width on a VID/DET tree written here (1280 x
    720 JPEG frames, 600/720 onto the canvas): the decode route and its
    host ms per frame; PairLoader's rate alone; training from PairLoader
    (VID and DET mixed by det_fraction) through device_prefetch, whose
    first upload must equal its host batch bit for bit; the device
    renderer pixel for pixel against the host renderer, then training on
    it beside host-rendered synthetic batches; and ``eval_torch.main
    --dataset ... --link``, which must decode every frame once."""
    import dtt_torch.data.imagenet_vid  # noqa: F401  (registers datasets)
    from dtt_torch.data import device_synth, native, transforms
    from dtt_torch.data.imdb import combined_roidb
    from dtt_torch.data.loader import PairLoader, device_prefetch
    from dtt_torch.data.synthetic import render_frame, sample_params_batch

    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    b, seed = cfg.train.batch_size_per_chip, cfg.train.seed
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        counts = vid_tree_writer()(root, seed=0)
        log(f"data tree: {counts} frames of 1280x720 JPEG (PIL, quality "
            f"90) in {time.perf_counter() - t0:.1f} s")
        val = os.path.join(root, "Data", "VID", "val", "snippet_000")
        paths = sorted(os.path.join(val, f) for f in os.listdir(val))
        route = transforms.frame_route(paths[0])
        transforms.prepare_frame(paths[0], cfg.input)
        t0 = time.perf_counter()
        for p in paths:
            canvas, scale = transforms.prepare_frame(p, cfg.input)
        decode_ms = (time.perf_counter() - t0) * 1e3 / len(paths)
        log(f"data decode: route {route} (native: "
            f"{native.unavailable_reason() or 'built'}); prepare_frame "
            f"{decode_ms:.2f} ms/frame on one host thread over "
            f"{len(paths)} frames, scale {scale:.4f} onto {h}x{w}")

        roidb = combined_roidb("imagenet_vid_train+imagenet_det_train",
                               root=root, use_flipped=cfg.input.use_flipped)
        loader = PairLoader(roidb, cfg.input, b, seed=seed,
                            num_workers=DATA_WORKERS,
                            det_fraction=DATA_DET_FRACTION)
        it = iter(loader)
        next(it)
        t0 = time.perf_counter()
        for _ in range(DATA_STEPS):
            next(it)
        dt = time.perf_counter() - t0
        loader.stop()
        log(f"data loader alone: {len(roidb)} roidb entries, "
            f"{DATA_WORKERS} workers: {DATA_STEPS * b / dt:.2f} pairs/s")

        model, state = create_train_state(cfg, "cuda", tree=tree)
        feat_hw = (h // 16, w // 16)
        step = make_train_step(cfg, model, feat_hw)
        gen = torch.Generator(device="cuda").manual_seed(seed + 1)
        loader = PairLoader(roidb, cfg.input, b, seed=seed,
                            num_workers=DATA_WORKERS,
                            det_fraction=DATA_DET_FRACTION)
        host: list = []

        def tap(batches):
            for batch in batches:
                host.append(batch)
                yield batch

        cast = {"images": torch.bfloat16}
        prefetched = device_prefetch(tap(iter(loader)), "cuda", size=2,
                                     cast=cast)
        first = next(prefetched)
        for k, v in host[0].items():
            want = torch.from_numpy(v)
            want = want.to(cast[k]) if k in cast else want
            if not torch.equal(first[k].cpu(), want):
                raise AssertionError(f"prefetched {k} differs from its host "
                                     "batch")
        log(f"data prefetch: first batch on the card equals its host batch "
            f"bit for bit ({', '.join(f'{k} {tuple(v.shape)} {v.dtype}' for k, v in first.items())})")
        try:
            state, data_ms = timed_train(
                cfg, state, step, itertools.chain([first], prefetched), gen,
                "PairLoader + device_prefetch", card)
        finally:
            prefetched.close()
            loader.stop()
        det = [bool(np.array_equal(x["images"][0, 0], x["images"][0, 1]))
               for x in host[:DATA_STEPS + 1]]
        if all(det) or not any(det):
            raise AssertionError(f"one group only in the batches: DET {det}")
        log(f"data mixture: DET (identity) pairs {sum(det)} of {len(det)} "
            f"at det_fraction {DATA_DET_FRACTION}")

        rng = np.random.RandomState(seed)
        shape = (cfg.model.num_classes, cfg.input.max_gt_boxes)
        n_obj = cfg.input.synthetic_objects
        stream = device_prefetch(
            (synthetic_batch(rng, b, h, w, *shape, cfg.input.pixel_means,
                             uint8=True, num_objects=n_obj)
             for _ in itertools.count()), "cuda")
        try:
            state, synth_ms = timed_train(cfg, state, step, stream, gen,
                                          "host-rendered synthetic", card)
        finally:
            stream.close()

        p = sample_params_batch(np.random.RandomState(1), 2, h, w, *shape,
                                num_objects=(5, 30))
        got = device_synth.render_pairs(
            p["gt_boxes"], p["gt_labels"], p["gt_valid"],
            torch.Generator(device="cuda").manual_seed(2), h, w)
        bg = device_synth.pair_background(
            torch.Generator(device="cuda").manual_seed(2), 2, h, w,
            "cuda").cpu().numpy()
        got = got.cpu().numpy()
        t0 = time.perf_counter()
        for i in range(2):
            for f in range(2):
                want = render_frame(bg[i, f].copy(), p["gt_boxes"][i, f],
                                    p["gt_labels"][i], p["gt_valid"][i, f])
                if not np.array_equal(got[i, f], want):
                    raise AssertionError("device render differs from the "
                                         f"host renderer at pair {i} frame "
                                         f"{f}")
        host_ms = (time.perf_counter() - t0) * 1e3 / 2
        dev_ms = time_ms(lambda: device_synth.render_pairs(
            p["gt_boxes"], p["gt_labels"], p["gt_valid"], gen, h, w), 10)
        log(f"data render: the card's canvases equal the host renderer's "
            f"pixel for pixel (2 pairs, {int(p['gt_valid'].sum())} objects); "
            f"render_pairs {dev_ms / 2:.3f} ms/pair on the card (events), "
            f"host objects {host_ms:.1f} ms/pair")
        render_step = make_train_step(
            cfg, model, feat_hw,
            render_fn=device_synth.make_pair_render_fn(h, w))
        stream = device_prefetch(
            (sample_params_batch(rng, b, h, w, *shape, num_objects=n_obj)
             for _ in itertools.count()), "cuda")
        try:
            state, render_ms = timed_train(cfg, state, render_step, stream,
                                           gen, "device-rendered synthetic",
                                           card)
        finally:
            stream.close()
        log(f"data train ms/step: PairLoader {data_ms:.1f}, host-rendered "
            f"{synth_ms:.1f}, device-rendered {render_ms:.1f} on {card}")
        del model, state, step, render_step

        with tempfile.TemporaryDirectory() as ck:
            _, fresh = create_train_state(cfg, "cuda", tree=tree)
            save_checkpoint(ck, fresh, cfg)
            del fresh
            seen = []
            stream_vid = eval_torch.snippet_stream_vid

            def spy(cfg_, snippets):
                for item in stream_vid(cfg_, snippets):
                    seen.append(item[1])
                    yield item

            eval_torch.snippet_stream_vid = spy
            try:
                reset_launches()
                t0 = time.perf_counter()
                out, clock, pairs = run_eval(
                    ["--dataset", "imagenet_vid_val", "--data-root", root,
                     "--checkpoint", ck, "--link"])
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            finally:
                eval_torch.snippet_stream_vid = stream_vid
        launches = read_launches()
        check_launches("eval_video", launches)
        for key in ("mAP", "mAP_nolink", "link_uplift"):
            if not (key in out and np.isfinite(out[key])):
                raise AssertionError(f"data eval: {key} is {out.get(key)!r}")
        decoded = sum(f.decode_count for f in seen)
        if decoded != counts["val"] or sum(len(f) for f in seen) != decoded:
            raise AssertionError(f"data eval decoded {decoded} frames of "
                                 f"{counts['val']}")
        split = ", ".join(f"{k} {v:.1f} ms" for k, v in clock.items())
        log(f"data eval (--dataset imagenet_vid_val --link): {pairs} pairs, "
            f"{decoded} frames decoded once each, in {wall:.1f} ms wall "
            f"({split}) on {card}; launches {launches}; mAP {out['mAP']}, "
            f"mAP_nolink {out['mAP_nolink']} (random weights)")


def pth_name(key: str) -> str:
    """The torchvision module name of the port's backbone module `key`
    (``backbone.layer1.block0.downsample_conv`` -> ``layer1.0.downsample.0``)."""
    parts = key.removeprefix("backbone.").split(".")
    name = ".".join(p.removeprefix("block") if p.startswith("block") else p
                    for p in parts)
    return (name.replace("downsample_conv", "downsample.0")
            .replace("downsample_bn", "downsample.1"))


def resnet_pth_state(cfg: Config, seed: int) -> dict:
    """A torchvision-layout state dict of `cfg`'s backbone from a numpy
    seed: He-normal convs and BatchNorms with running statistics."""
    rng = np.random.default_rng(seed)
    t = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    sd = {}
    for key, ref in DnT(cfg.model, device="meta").state_dict().items():
        if not key.startswith("backbone."):
            continue
        name, leaf = key.rsplit(".", 1)
        name, shape = pth_name(name), tuple(ref.shape)
        if leaf == "weight":
            std = np.sqrt(2.0 / np.prod(shape[1:]))
            sd[f"{name}.weight"] = t(rng.standard_normal(shape) * std)
        elif leaf == "scale":
            sd[f"{name}.weight"] = t(rng.uniform(0.5, 1.5, shape))
            sd[f"{name}.bias"] = t(rng.normal(0.0, 0.1, shape))
            sd[f"{name}.running_mean"] = t(rng.normal(0.0, 0.1, shape))
            sd[f"{name}.running_var"] = t(rng.uniform(0.5, 1.5, shape))
            sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
    return sd


def momentum_buffers(state) -> list:
    return [state.optimizer.state[p].get("momentum_buffer")
            for g in state.optimizer.param_groups for p in g["params"]]


def phase_weights_train(cfg: Config, d: str, card: str):
    """``train_torch.main --pretrained --calibrate-bn`` at full width for
    1 + MODE_STEPS steps into run dir `d`/run, with its checks; returns
    the final state and the train path's launches."""
    sd = resnet_pth_state(cfg, seed=21)
    pth = os.path.join(d, "resnet101.pth")
    torch.save(sd, pth)
    seen = {}
    real = calibrate.calibrate_model_backbone

    def checked_calibration(cfg_, model, imgs):
        # called after the import, before any step: the .pth's convs
        convs = [(k, v) for k, v in model.state_dict().items()
                 if k.startswith("backbone.") and k.endswith(".weight")]
        bad = [k for k, v in convs
               if not torch.equal(v.cpu(), sd[pth_name(k[:-7]) + ".weight"])]
        if bad or len(convs) != 1 + 3 * 33 + 4:
            raise AssertionError(f"imported convs differ from the .pth: "
                                 f"{bad[:4]} of {len(convs)}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(cfg_, model, imgs)
        torch.cuda.synchronize()
        seen["calib_s"] = time.perf_counter() - t0
        groups = calibrate.affine_groups(model.backbone)
        stats = calibrate.affine_stats(
            model.backbone, calibrate.backbone_input(model, imgs), groups[-1])
        seen["mean"] = max(m.abs().max().item() for m, _ in stats.values())
        seen["std"] = max((v.sqrt() - 1).abs().max().item()
                          for _, v in stats.values())
        seen["groups"], seen["convs"] = len(groups), len(convs)
        return model

    out = os.path.join(d, "run")
    argv = ["--synthetic", "--pretrained", pth, "--calibrate-bn", "--out",
            out, "--set", f"train.total_steps={1 + MODE_STEPS}",
            "train.log_every=1"]
    buf = io.StringIO()
    calibrate.calibrate_model_backbone = checked_calibration
    try:
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            state = train_torch.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    finally:
        calibrate.calibrate_model_backbone = real
    rows = [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]
    log(f"weights train launches (1 + {MODE_STEPS} steps): {launches}")
    check_launches("train", launches)
    if [r["step"] for r in rows] != list(range(1, 2 + MODE_STEPS)):
        raise AssertionError(f"train_torch logged steps "
                             f"{[r['step'] for r in rows]}")
    losses = [{k: v for k, v in r.items() if k not in ("step", "exp")}
              for r in rows]
    if not all(np.isfinite(v) for r in losses for v in r.values()):
        raise AssertionError(f"non-finite loss: {losses}")
    mean_tol, std_tol = CALIB_TOL
    if not (seen.get("mean", np.inf) <= mean_tol
            and seen.get("std", np.inf) <= std_tol):
        raise AssertionError(f"calibrated affines off: max |mean| "
                             f"{seen.get('mean')}, max |std - 1| "
                             f"{seen.get('std')} (tol {CALIB_TOL})")
    log(f"weights train: --pretrained (a torchvision-layout ResNet-101 .pth, "
        f"{os.path.getsize(pth) / 2**20:.1f} MiB, made from a numpy seed: "
        f"{seen['convs']} backbone convs equal to it bit for bit) "
        f"--calibrate-bn ({seen['groups']} affine groups in "
        f"{seen['calib_s']:.2f} s; the last group's outputs over the "
        f"batch: max |mean| {seen['mean']:.3g}, max |std - 1| "
        f"{seen['std']:.3g}, tol {CALIB_TOL}); {len(rows)} steps in "
        f"{wall:.1f} s of train_torch.main; {rows[-1]['pairs_per_sec']} "
        f"pairs/s, {1e3 / rows[-1]['pairs_per_sec']:.1f} ms/step after the "
        f"first on {card}; last losses {json.dumps(losses[-1])}")
    return state, launches, out


def phase_weights(card: str) -> dict:
    """Weights in and out and the other pooling modes at full width (see
    the module docstring, phase 10); returns the launches of each path
    driven."""
    cfg = Config()
    launches = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        state, launches["weights_train"], out = phase_weights_train(cfg, d,
                                                                   card)
        ck = latest_checkpoint(out)
        raw = os.path.join(ck, "state.msgpack")
        cfg = load_config(os.path.join(ck, "config.yml"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = save_checkpoint(os.path.join(d, "again"), state, cfg)
        write_ms = (time.perf_counter() - t0) * 1e3
        with open(raw, "rb") as f, \
                open(os.path.join(again, "state.msgpack"), "rb") as g:
            if f.read() != g.read():
                raise AssertionError("a second save of the state wrote "
                                     "other bytes")
        _, fresh = create_train_state(cfg, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh = restore_checkpoint(ck, fresh)
        torch.cuda.synchronize()
        read_ms = (time.perf_counter() - t0) * 1e3
        bufs, fresh_bufs = momentum_buffers(state), momentum_buffers(fresh)
        same = (fresh.step == state.step == 1 + MODE_STEPS
                and all(torch.equal(v, state.model.state_dict()[k])
                        for k, v in fresh.model.state_dict().items())
                and len(bufs) == len(fresh_bufs) > 0
                and all(a is not None and torch.equal(a, b)
                        for a, b in zip(bufs, fresh_bufs)))
        if not same:
            raise AssertionError("the run's state.msgpack did not restore "
                                 "bit for bit")
        n_params = sum(v.numel() for v in state.model.state_dict().values())
        mib = os.path.getsize(raw) / 2**20
        log(f"weights checkpoint: state.msgpack of {mib:.1f} MiB "
            f"({n_params / 1e6:.1f} M values and their momentum), "
            f"written in {write_ms:.1f} ms (the same bytes again), restored "
            f"in {read_ms:.1f} ms into a fresh state: step {fresh.step}, "
            f"{len(bufs)} momentum buffers and every parameter bit for bit "
            f"on {card}")
        del state, fresh, bufs, fresh_bufs
        for path, flags in (("eval_video", ["--link"]),
                            ("pair", ["--tau", "2", "--set",
                                      "model.roi.eval_pool_impl=pallas_mm"])):
            reset_launches()
            t0 = time.perf_counter()
            res, _, pairs = run_eval(["--synthetic", "--checkpoint", out,
                                      "--synthetic-snippets", "1",
                                      "--synthetic-frames", "16", *flags])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[f"weights_{path}"] = read_launches()
            check_launches(path, launches[f"weights_{path}"])
            if not all(np.isfinite(res[k]) for k in ("mAP", "mAP_nolink")):
                raise AssertionError(f"eval of the read-back run: {res}")
            log(f"weights eval ({' '.join(flags)}) of the read-back run: "
                f"{pairs} pairs in {wall * 1e3:.1f} ms wall on {card}; "
                f"launches {launches[f'weights_{path}']}; mAP {res['mAP']}")
    for mode in ("align", "pool", "crop"):
        launches.update(phase_mode(with_mode(Config(), mode), card))
        phase_reference(mode)
        phase_train_reference(mode)
    log(f"weights and pooling modes: {time.perf_counter() - t_phase:.1f} s "
        f"on {card}")
    return launches


def phase_mode(cfg: Config, card: str) -> dict:
    """One 17-frame video chunk at full width under cfg's pooling mode
    (pairs/s), and for align 1 + MODE_STEPS train steps (ms/step, peak
    memory); returns their launches."""
    mode = cfg.model.roi.pooling_mode
    tree = init_jax_params(cfg.model, seed=0)
    model = from_jax_params(tree, cfg.model, device="cuda")
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    frames = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (FRAMES_PER_CHUNK, h, w, 3)).astype(np.uint8))
    im_hw = torch.tensor([h - 8, w - 48], dtype=torch.float32, device="cuda")
    step = make_video_step(cfg, model, FRAMES_PER_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    step(frames, im_hw)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = [x.cpu().numpy() for x in step(frames, im_hw)]
    dt = time.perf_counter() - t0
    launches = {f"{mode}_video": read_launches()}
    check_launches("mode_video", launches[f"{mode}_video"])
    if not all(np.isfinite(x).all() for x in outs) or not outs[2].any():
        raise AssertionError(f"{mode} video chunk: non-finite or no valid "
                             "detection")
    log(f"{mode} video chunk: {FRAMES_PER_CHUNK - 1} pairs in "
        f"{dt * 1e3:.1f} ms, {(FRAMES_PER_CHUNK - 1) / dt:.2f} pairs/s on "
        f"{card}; {int(outs[2].sum())} valid detections; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches[f'{mode}_video']}")
    del model, step
    if mode != "align":
        return launches
    b = cfg.train.batch_size_per_chip
    model, state = create_train_state(cfg, "cuda", tree=tree)
    step = make_train_step(cfg, model, (h // 16, w // 16))
    rng = np.random.RandomState(2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    batches = [synthetic_batch(rng, b, h, w, cfg.model.num_classes,
                               cfg.input.max_gt_boxes, cfg.input.pixel_means,
                               uint8=True) for _ in range(2 + MODE_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    for batch in batches[:2]:   # eager, then captured as the program
        state, _ = step(state, batch, sample_draws(cfg, b, gen, "cuda"))
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    history = []
    for batch in batches[2:]:
        state, metrics = step(state, batch, sample_draws(cfg, b, gen, "cuda"))
        history.append(metrics)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches["align_train"] = read_launches()
    check_launches("mode_train", launches["align_train"])
    values = [{k: v.item() for k, v in m_.items()} for m_ in history]
    if not all(np.isfinite(v) for row in values for v in row.values()):
        raise AssertionError(f"align train: non-finite loss: {values}")
    log(f"align train: {MODE_STEPS} steps {dt * 1e3 / MODE_STEPS:.1f} "
        f"ms/step on {card}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{launches['align_train']}; last losses "
        f"{json.dumps({k: round(v, 4) for k, v in values[-1].items()})}")
    return launches


def eval_errors(got, want, n: int) -> dict:
    """Per PairOutputs field of the first `n` pairs: max |got - want|, and
    for `valid` the count of entries that differ."""
    out = {}
    for name, g, w in zip(("boxes", "scores", "valid", "tracked"), got,
                          want):
        g, w = g[:n].cpu(), w[:n].cpu()
        out[name] = (int((g != w).sum()) if name == "valid"
                     else (g.float() - w.float()).abs().max().item())
    return out


def check_eval_errors(errs: dict, what: str) -> None:
    bad = [k for k, v in errs.items()
           if (v != 0 if k == "valid" else v > PAR_EVAL_TOL[k])]
    if bad:
        raise AssertionError(f"{what}: {bad} past the tolerance: {errs} "
                             f"(tol {PAR_EVAL_TOL}, valid equal)")


def par_train_run(cfg: Config, tree: dict, make_step, batches: list,
                  draws: list) -> tuple:
    """1 warm-up + PAR_STEPS timed steps of `make_step(model)` from the
    tree, alone on the card: losses per step, ms/step, the state after
    (on the host), the launches and peak memory of the timed steps and
    the bytes a parallel step all-reduces (None for a serial step)."""
    model, state = create_train_state(cfg, "cuda", tree=tree)
    step = make_step(model)
    losses = []
    state, m = step(state, batches[0], draws[0])
    losses.append({k: v.item() for k, v in m.items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    history = []
    for batch, d in zip(batches[1:], draws[1:]):
        state, m = step(state, batch, d)
        history.append(m)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / PAR_STEPS
    launches = read_launches()
    losses += [{k: v.item() for k, v in m.items()} for m in history]
    peak = torch.cuda.max_memory_allocated() / 2**30
    after = {k: v.cpu() for k, v in model.state_dict().items()}
    nbytes = (step.allreduce_bytes(state) if hasattr(step, "allreduce_bytes")
              else None)
    del model, state, step, history, m
    torch.cuda.empty_cache()
    return losses, ms, after, launches, peak, nbytes


@contextlib.contextmanager
def collective_calls():
    """Count the calls of torch.distributed's collectives that the
    parallel steps make (``dtt_torch.parallel.mesh`` calls them through
    the module), by name, while the block runs."""
    import torch.distributed as dist
    names = ("all_reduce", "all_gather", "broadcast", "batch_isend_irecv")
    counts = dict.fromkeys(names, 0)
    saved = {n: getattr(dist, n) for n in names}

    def counting(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return saved[name](*args, **kwargs)
        return call

    for n in names:
        setattr(dist, n, counting(n))
    try:
        yield counts
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def s2_check(cfg: Config, tree: dict, name: str, make_step, batches: list,
             draws: list) -> None:
    """Suspect S2: PAR_S2_STEPS[0] program steps, then PAR_S2_STEPS[1]
    ``step.eager`` steps on the same state, against as many eager steps
    from the same state, batches and draws, with cuDNN's deterministic
    algorithms: every loss, parameter, buffer and momentum buffer bit for
    bit. Counts the warnings that autograd's gradient accumulators were
    made on another stream."""
    import warnings
    n, m = PAR_S2_STEPS
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    runs, warned = {}, 0
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for label, forms in (("mixed", ["program"] * n + ["eager"] * m),
                             ("eager", ["eager"] * (n + m))):
            model, state = create_train_state(cfg, "cuda", tree=tree)
            step = make_step(cfg, model, (h // 16, w // 16))
            metrics = []
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for i, form in enumerate(forms):
                    fn = step if form == "program" else step.eager
                    state, mt = fn(state, batches[i], draws[i])
                    metrics.append(mt)
                torch.cuda.synchronize()
            warned += sum("AccumulateGrad" in str(c.message) for c in caught)
            runs[label] = (metrics, state, step)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (mm, sm, step), (me, se, _) = runs["mixed"], runs["eager"]
    bad = [(i, k) for i, (a, e) in enumerate(zip(mm, me)) for k in a
           if not exact(a[k], e[k])]
    pe = se.model.state_dict()
    bad += [k for k, v in sm.model.state_dict().items() if not exact(v, pe[k])]
    bufs = lambda st: [x["momentum_buffer"] for x in st.optimizer.state.values()]
    bad += [f"momentum {i}" for i, (x, y) in enumerate(zip(bufs(sm), bufs(se)))
            if not exact(x, y)]
    if bad or step.programs[0].captures != 1:
        raise AssertionError(f"S2 {name}: {n} program steps then {m} eager "
                             f"ones differ from {n + m} eager steps: "
                             f"{bad[:6]} ({len(bad)})")
    log(f"S2 {name}: {n} program steps (1 eager, then captured, "
        f"{step.programs[0].replays} replay(s)) then {m} step.eager steps on "
        f"one state bit-equal to {n + m} eager steps from the same state "
        f"(cuDNN deterministic): every loss, {len(pe)} parameters and "
        f"buffers, {len(bufs(sm))} momentum buffers; {warned} "
        f"AccumulateGrad stream warning(s)")


def phase_parallel_nccl(cfg: Config, tree: dict, card: str) -> tuple:
    """(a) One NCCL rank in this process at full width: the parallel
    train, video and pair programs against the serial programs from the
    same state and inputs (PAR_LOSS_RTOL, TRAIN_REF_PARAM_TOL,
    PAR_EVAL_TOL), each against its own ``.eager`` bit for bit (the train
    program over PROGRAM_STEPS steps under cuDNN's deterministic
    algorithms), host ms a call of both forms, and no Python call of a
    collective while a program replays; S2 for the serial and the
    parallel train step. Returns the launches per path and the closures
    to profile (the caller profiles them and leaves the group)."""
    import torch.distributed as dist

    from dtt_torch.eval.inference import (make_pair_step_parallel,
                                          make_video_step_parallel)
    from dtt_torch.parallel import (all_reduce_mean_, data_mesh,
                                    initialize_distributed)
    from dtt_torch.train.trainer import make_parallel_train_step

    initialize_distributed(store=dist.HashStore(), world_size=1, rank=0,
                           device="cuda:0")
    mesh = data_mesh("cuda:0")
    log(f"parallel (a): {mesh.size} rank, backend {mesh.backend}, NCCL "
        f"{torch.cuda.nccl.version()}, environment "
        f"{ {k: v for k, v in os.environ.items() if 'NCCL' in k} }")
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    b = cfg.train.batch_size_per_chip
    rng = np.random.RandomState(31)
    batches = [synthetic_batch(rng, b, h, w, cfg.model.num_classes,
                               cfg.input.max_gt_boxes, cfg.input.pixel_means,
                               uint8=True) for _ in range(PROGRAM_STEPS)]
    gen = torch.Generator(device="cuda").manual_seed(32)
    draws = [sample_draws(cfg, b, gen, "cuda") for _ in range(PROGRAM_STEPS)]
    fhw = (h // 16, w // 16)
    parallel = lambda c, m, f, render_fn=None: make_parallel_train_step(
        c, m, f, mesh, render_fn=render_fn)
    # the serial program from the same state; each run's timed steps hold
    # the capture (the second call) and one replay
    s_loss, s_ms, s_after, _, s_peak, _ = par_train_run(
        cfg, tree, lambda m: make_train_step(cfg, m, fhw),
        batches[:1 + PAR_STEPS], draws[:1 + PAR_STEPS])
    p_loss, p_ms, p_after, t_launches, p_peak, nbytes = par_train_run(
        cfg, tree, lambda m: parallel(cfg, m, fhw), batches[:1 + PAR_STEPS],
        draws[:1 + PAR_STEPS])
    check_launches("parallel_train", t_launches)
    loss_err = max(abs(p[k] - q[k]) / max(abs(q[k]), 1e-12)
                   for p, q in zip(p_loss, s_loss) for k in q)
    atol, rtol = TRAIN_REF_PARAM_TOL
    param_r, param_leaf = worst_leaf({
        k: ((p_after[k].double() - v.double()).abs()
            / (atol + rtol * v.double().abs())).max().item()
        for k, v in s_after.items()})
    if not (loss_err <= PAR_LOSS_RTOL and param_r <= 1):
        raise AssertionError(
            f"parallel train program (1 NCCL rank) vs the serial program: "
            f"losses off by {loss_err:.3g} of their value (tol "
            f"{PAR_LOSS_RTOL}), worst parameter at {param_r:.3g} of "
            f"{TRAIN_REF_PARAM_TOL} ({param_leaf})")
    buf = torch.zeros(nbytes // 4, dtype=torch.float32, device="cuda")
    ar_ms = time_ms(lambda: all_reduce_mean_(buf, mesh), iters=10)
    log(f"parallel train program (1 NCCL rank): {1 + PAR_STEPS} steps "
        f"against make_train_step's program from the same state, batches "
        f"and draws: losses off by {loss_err:.3g} of their value (tol "
        f"{PAR_LOSS_RTOL}), parameters worst at {param_r:.3g} of "
        f"{TRAIN_REF_PARAM_TOL} ({param_leaf}); {p_ms:.1f} ms/step "
        f"parallel, {s_ms:.1f} ms/step serial over steps 2-{1 + PAR_STEPS} "
        f"(the capture and {PAR_STEPS - 1} replay(s)); eager all-reduce "
        f"of {nbytes} bytes ({nbytes / 4:.0f} trainable float32) "
        f"{ar_ms:.3f} ms; peak device memory {p_peak:.2f} GiB parallel, "
        f"{s_peak:.2f} GiB serial; launches {t_launches} on {card}")
    del s_after, p_after, buf
    profiled = {}
    train_one = train_programs(cfg, tree, "parallel train step (1 NCCL "
                               "rank)", batches, False, card,
                               make_step=parallel)
    with collective_calls() as calls:
        for i in range(3):
            train_one("graphed", i)
        torch.cuda.synchronize()
    if any(calls.values()):
        raise AssertionError(f"parallel train program: a replay called "
                             f"collectives from Python: {calls}")
    with collective_calls() as eager_calls:
        train_one("eager", 0)
    log(f"parallel train program: Python collective calls over 3 replays "
        f"{calls}; over one eager step {eager_calls}")
    profiled["parallel train step (1 NCCL rank)"] = train_one
    s2_check(cfg, tree, "serial train step (Config())",
             lambda c, m, f: make_train_step(c, m, f), batches, draws)
    s2_check(cfg, tree, "parallel train step (Config(), 1 NCCL rank)",
             lambda c, m, f: parallel(c, m, f), batches, draws)

    model = from_jax_params(tree, cfg.model, device="cuda")
    crng = np.random.RandomState(33)
    chunks = [torch.from_numpy(crng.randint(
        0, 256, (FRAMES_PER_CHUNK, h, w, 3)).astype(np.uint8))
        for _ in range(PROGRAM_CHECKS)]
    extents = [(h - 8 * (i + 1), w - 48 * (i + 1))
               for i in range(PROGRAM_CHECKS)]
    hws = [torch.tensor(e, dtype=torch.float32, device="cuda")
           for e in extents]
    scales = [1.0, 0.8, 1.25][:PROGRAM_CHECKS]
    im_hw = hws[0]
    frames = chunks[0]
    vpar = make_video_step_parallel(cfg, model, mesh, FRAMES_PER_CHUNK)
    vser = make_video_step(cfg, model, FRAMES_PER_CHUNK)
    vpar(frames, im_hw), vser(frames, im_hw)
    torch.cuda.synchronize()
    reset_launches()
    got = vpar(frames, im_hw)
    torch.cuda.synchronize()
    v_launches = read_launches()
    check_launches("parallel_video", v_launches)
    want = vser(frames, im_hw)
    if got[0].shape[0] != FRAMES_PER_CHUNK:
        raise AssertionError(f"parallel video chunk gave {got[0].shape[0]} "
                             f"pairs, want {FRAMES_PER_CHUNK}")
    v_err = eval_errors(got, want, FRAMES_PER_CHUNK - 1)
    check_eval_errors(v_err, "parallel video program (1 NCCL rank)")
    log(f"parallel video program (1 NCCL rank, frames_per_device "
        f"{FRAMES_PER_CHUNK}): {FRAMES_PER_CHUNK - 1} pairs against "
        f"make_video_step's program: {v_err} (tol {PAR_EVAL_TOL}, valid "
        f"equal); launches {v_launches} (one replay)")
    name = "parallel video chunk (1 NCCL rank)"
    check_program(name, vpar, [(chunks[i], hws[i], scales[i])
                               for i in range(PROGRAM_CHECKS)])
    vforms = {"graphed": vpar, "eager": vpar.eager}
    with collective_calls() as calls:
        graphed = host_ms(lambda i: vpar(chunks[i % PROGRAM_CHECKS], im_hw,
                                         1.0))
    log_forms(name, {"graphed": graphed, "eager": host_ms(
        lambda i: vpar.eager(chunks[i % PROGRAM_CHECKS], im_hw, 1.0))}, card)
    if any(calls.values()):
        raise AssertionError(f"{name}: a replay called collectives from "
                             f"Python: {calls}")
    profiled[name] = lambda form, i: vforms[form](
        chunks[i % PROGRAM_CHECKS], im_hw, 1.0)

    pcfg = cfg.replace(model=cfg.model.replace(roi=cfg.model.roi.replace(
        eval_pool_impl="pallas_mm")))
    prng = np.random.RandomState(34)
    pairs = [torch.from_numpy(prng.randint(
        0, 256, (PAIR_BATCH, 2, h, w, 3)).astype(np.uint8))
        for _ in range(PROGRAM_CHECKS)]
    ppar = make_pair_step_parallel(pcfg, model, mesh, PAIR_BATCH)
    pser = make_pair_step(pcfg, model, PAIR_BATCH)
    ppar(pairs[0], im_hw), pser(pairs[0], im_hw)
    torch.cuda.synchronize()
    reset_launches()
    got = ppar(pairs[0], im_hw)
    torch.cuda.synchronize()
    p_launches = read_launches()
    check_launches("parallel_pair", p_launches)
    p_err = eval_errors(got, pser(pairs[0], im_hw), PAIR_BATCH)
    check_eval_errors(p_err, "parallel pair program (1 NCCL rank)")
    log(f"parallel pair program (1 NCCL rank, {PAIR_BATCH} pairs, "
        f"pallas_mm): against make_pair_step's program: {p_err} (tol "
        f"{PAR_EVAL_TOL}, valid equal); launches {p_launches}")
    name = "parallel pair batch (1 NCCL rank)"
    check_program(name, ppar, [(pairs[i], hws[i], scales[i])
                               for i in range(PROGRAM_CHECKS)])
    pforms = {"graphed": ppar, "eager": ppar.eager}
    with collective_calls() as calls:
        graphed = host_ms(lambda i: ppar(pairs[i % PROGRAM_CHECKS], im_hw,
                                         1.0))
    log_forms(name, {"graphed": graphed, "eager": host_ms(
        lambda i: ppar.eager(pairs[i % PROGRAM_CHECKS], im_hw, 1.0))}, card)
    if any(calls.values()):
        raise AssertionError(f"{name}: a replay called collectives from "
                             f"Python: {calls}")
    profiled[name] = lambda form, i: pforms[form](
        pairs[i % PROGRAM_CHECKS], im_hw, 1.0)
    return ({"parallel_train": t_launches, "parallel_video": v_launches,
             "parallel_pair": p_launches}, profiled)


def parallel_rank(rank: int, world: int, store: str, out: str) -> None:
    """(b) One gloo rank on the card: one parallel video chunk of world x
    PAR_FPD frames, then one parallel train step on its rows of a global
    batch of world x batch_size_per_chip pairs, both by ``step.eager``
    (gloo's collectives cannot be captured, so the programs refuse to
    run; their errors are saved); rank 0 saves what the parent
    compares."""
    from dtt_torch.eval.inference import (make_pair_step_parallel,
                                          make_video_step_parallel)
    from dtt_torch.parallel import (data_mesh, exchange_halo,
                                    initialize_distributed)
    from dtt_torch.train.trainer import (make_parallel_train_step,
                                         replicate_tree, shard_batch,
                                         shard_draws)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist
    initialize_distributed(init_method=f"file://{store}", world_size=world,
                           rank=rank, device="cuda:0", backend="gloo")
    mesh = data_mesh("cuda:0")
    cfg = Config()
    tree = init_jax_params(cfg.model, seed=0)
    batch, draws = par2_inputs(cfg, world)
    model, state = create_train_state(cfg, mesh.device, tree=tree)
    state = replicate_tree(state, mesh)
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    frames, im_hw = par2_frames(cfg, world)
    vstep = make_video_step_parallel(cfg, model, mesh, PAR_FPD)
    reset_launches()
    t0 = time.perf_counter()
    vout = [x.cpu() for x in vstep.eager(frames, im_hw.cuda())]
    video_ms = (time.perf_counter() - t0) * 1e3
    v_launches = read_launches()
    # the halo alone: this rank's first-frame features out, the next
    # rank's in, for the parent to hold against each other
    with torch.inference_mode():
        feats = par2_trunk(cfg, model, frames[mesh.rows(len(frames))],
                           im_hw)
        sent = [x[:1] for x in feats]
        got = exchange_halo(sent, mesh)
    step = make_parallel_train_step(cfg, model, (h // 16, w // 16), mesh)
    pstep = make_pair_step_parallel(cfg, model, mesh, 1)
    refused = {}
    for name, call in (
            ("train", lambda: step(state, shard_batch(batch, mesh),
                                   shard_draws(draws, mesh))),
            ("video", lambda: vstep(frames, im_hw.cuda())),
            ("pair", lambda: pstep(frames[:2 * world].reshape(
                world, 2, h, w, 3), im_hw.cuda()))):
        try:
            call()
            refused[name] = None
        except RuntimeError as e:
            refused[name] = str(e)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    state, metrics = step.eager(state, shard_batch(batch, mesh),
                                shard_draws(draws, mesh))
    torch.cuda.synchronize()
    train_ms = (time.perf_counter() - t0) * 1e3
    t_launches = read_launches()
    res = {"metrics": {k: v.item() for k, v in metrics.items()},
           "launches": {"train": t_launches, "video": v_launches},
           "ms": {"train": train_ms, "video": video_ms},
           "checksum": sum(p.double().sum().item()
                           for p in model.state_dict().values()),
           "halo": {"sent": [x.cpu() for x in sent],
                    "got": [x.cpu() for x in got]},
           "backend": mesh.backend, "refused": refused}
    if rank == 0:
        res["state"] = {k: v.cpu() for k, v in model.state_dict().items()}
        res["video"] = vout
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def par2_inputs(cfg: Config, world: int) -> tuple:
    """The global batch and draws of phase (b), alike in every process."""
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    b = world * cfg.train.batch_size_per_chip
    batch = synthetic_batch(np.random.RandomState(41), b, h, w,
                            cfg.model.num_classes, cfg.input.max_gt_boxes,
                            cfg.input.pixel_means, uint8=True)
    gen = torch.Generator(device="cuda").manual_seed(42)
    return batch, sample_draws(cfg, b, gen, "cuda")


def par2_frames(cfg: Config, world: int) -> tuple:
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    frames = torch.from_numpy(np.random.RandomState(43).randint(
        0, 256, (world * PAR_FPD, h, w, 3)).astype(np.uint8))
    return frames, torch.tensor([h - 8, w - 48], dtype=torch.float32)


def par2_trunk(cfg: Config, model, frames: torch.Tensor, im_hw) -> list:
    """The features of `frames` that the video step's halo carries: the
    reduced c5 and each correlation input, in that order. Under inference
    mode: an autograd graph kept alive holds its parameters' gradient
    accumulators, and a train step on another stream then warns that
    their stream differs (ROADMAP Queue 3, S2)."""
    from dtt_torch.eval.inference import _trunk_and_post
    trunk, _ = _trunk_and_post(cfg, model)
    with torch.inference_mode():
        feats = trunk(normalize_device_images(frames.cuda(), im_hw.cuda(),
                                              cfg.input.pixel_means))
    return [feats.reduced] + [feats.corr_feats[k]
                              for k in sorted(feats.corr_feats)]


def par2_emulate_video(cfg: Config, model, frames, im_hw, world: int):
    """The parallel video chunk's ranks one after another in this process
    (the same shapes a rank computes on): each rank's trunk, its frame
    t+1 side extended by the next rank's first frame, its heads; the
    outputs in rank order."""
    from dtt_torch.eval.inference import _trunk_and_post
    from dtt_torch.models.dnt import FrameFeats
    trunk, post = _trunk_and_post(cfg, model)
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    anchors = torch.from_numpy(grid_anchors_for(
        cfg.model.anchors, h // 16, w // 16)).cuda()
    hw = im_hw.cuda()
    with torch.inference_mode():
        feats = [trunk(normalize_device_images(
            frames[r * PAR_FPD:(r + 1) * PAR_FPD].cuda(), hw,
            cfg.input.pixel_means)) for r in range(world)]
        outs = []
        for r, f in enumerate(feats):
            nxt = feats[(r + 1) % world]
            ext = lambda a, b: torch.cat([a[1:], b[:1]])
            f_tau = FrameFeats(None, None, ext(f.reduced, nxt.reduced),
                               {k: ext(v, nxt.corr_feats[k])
                                for k, v in f.corr_feats.items()})
            outs.append(post(cfg, model, anchors, f, f_tau, hw, 1.0))
        return [torch.cat([o[i] for o in outs]) for i in range(4)]


def par2_emulate_train(cfg: Config, tree: dict, batch: dict, draws,
                       world: int) -> tuple:
    """The parallel train step's ranks one after another in this process:
    each rank's loss and gradients from its rows, summed and halved as the
    all-reduce does, then the update. Returns the averaged losses and the
    state after (on the host)."""
    from dtt_torch.parallel import DataMesh
    from dtt_torch.train.trainer import shard_batch, shard_draws
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    anchors = torch.from_numpy(grid_anchors_for(
        cfg.model.anchors, h // 16, w // 16)).cuda()
    model, state = create_train_state(cfg, "cuda", tree=tree)
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    grads, losses = None, None
    for r in range(world):
        mesh = DataMesh(r, world, torch.device("cuda", 0))
        state.optimizer.zero_grad(set_to_none=True)
        _, lb = train_losses.batch_loss(
            cfg, model, anchors,
            batch_to_device(shard_batch(batch, mesh), torch.device("cuda")),
            shard_draws(draws, mesh))
        lb.total.backward()
        g = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in params]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        m = torch.stack(lb).detach()
        losses = m if losses is None else losses + m
    for p, g in zip(params, grads):
        p.grad = g.div_(world)
    apply_gradients(cfg, state)
    out = (dict(zip(train_losses.LossBreakdown._fields,
                    losses.div_(world).tolist())),
           {k: v.cpu() for k, v in model.state_dict().items()})
    del model, state, params, grads
    torch.cuda.empty_cache()
    return out


def phase_parallel_gloo(cfg: Config, tree: dict, card: str) -> None:
    """(b) PAR_WORLD gloo ranks on the one card (NCCL refuses two ranks on
    one device), spawned: one full-width parallel video chunk and one
    parallel train step on a global batch. Each is held against the ranks'
    work emulated one after another in this process (the same shapes, so
    the same arithmetic: the collectives, the halo and the gather exactly)
    and against one process on the whole chunk or batch (other shapes in
    bf16, at PAR2's tolerances). A check of the collectives and the halo
    on CUDA tensors, not a scaling figure."""
    import torch.multiprocessing as mp

    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    f = PAR_WORLD * PAR_FPD
    batch, draws = par2_inputs(cfg, PAR_WORLD)
    frames, im_hw = par2_frames(cfg, PAR_WORLD)
    model, state = create_train_state(cfg, "cuda", tree=tree)
    serial_video = [x.cpu() for x in make_video_step(cfg, model, f)(
        frames, im_hw.cuda())]
    emul_video = [x.cpu() for x in par2_emulate_video(cfg, model, frames,
                                                      im_hw, PAR_WORLD)]
    halo_want = par2_trunk(cfg, model, frames[:PAR_FPD], im_hw)
    before = {k: v.cpu() for k, v in model.state_dict().items()}
    step = make_train_step(cfg, model, (h // 16, w // 16))
    state, metrics = step(state, batch, draws)
    one_loss = {k: v.item() for k, v in metrics.items()}
    one_state = {k: v.cpu() for k, v in model.state_dict().items()}
    del model, state, step, metrics
    torch.cuda.empty_cache()
    emul_loss, emul_state = par2_emulate_train(cfg, tree, batch, draws,
                                               PAR_WORLD)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(parallel_rank, args=(PAR_WORLD, os.path.join(
            d, "store"), d), nprocs=PAR_WORLD, start_method="spawn")
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt"),
                            weights_only=False) for r in range(PAR_WORLD)]
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    if len({r["checksum"] for r in ranks}) != 1:
        raise AssertionError(f"the ranks' replicas differ after the step: "
                             f"{[r['checksum'] for r in ranks]}")
    for r in ranks:
        for path, names in (("train", PATH_KERNELS["train"]),
                            ("video", PATH_KERNELS["video"])):
            if any(r["launches"][path][n] < 1 for n in names):
                raise AssertionError(f"a gloo rank launched no {names} on "
                                     f"its {path} path: {r['launches']}")
    # the halo: rank r got rank r+1's first frame, bit for bit, and rank
    # 0's first frame is the one computed here
    halo_ok = all(
        torch.equal(a, b) for i, r in enumerate(ranks)
        for a, b in zip(r["halo"]["got"],
                        ranks[(i + 1) % PAR_WORLD]["halo"]["sent"])) and \
        all(torch.equal(a, b.cpu()[:1]) for a, b in
            zip(r0["halo"]["sent"], halo_want))
    v_exact = eval_errors(r0["video"], emul_video, f)
    v_serial = eval_errors(r0["video"], serial_video, f - 1)
    flips = v_serial["valid"] / serial_video[2][:f - 1].numel()
    atol, rtol = TRAIN_REF_PARAM_TOL
    exact_loss = max(abs(r0["metrics"][k] - v) / max(abs(v), 1e-12)
                     for k, v in emul_loss.items())
    exact_r, exact_leaf = worst_leaf({
        k: ((r0["state"][k].double() - v.double()).abs()
            / (atol + rtol * v.double().abs())).max().item()
        for k, v in emul_state.items()})
    one_loss_err = max(abs(r0["metrics"][k] - v) / max(abs(v), 1e-12)
                       for k, v in one_loss.items())
    upd_r, upd_leaf = worst_leaf({
        k: ((r0["state"][k] - one_state[k]).abs().max()
            / (one_state[k] - v).abs().max().clamp(min=1e-30)).item()
        for k, v in before.items() if not torch.equal(one_state[k], v)})
    refusals = [m for r in ranks for m in r["refused"].values()]
    if not all(m and "gloo" in m for m in refusals):
        raise AssertionError(f"parallel (b): a program under gloo on the "
                             f"card did not refuse, naming the backend: "
                             f"{[r['refused'] for r in ranks]}")
    log(f"parallel (b): each program refused under gloo on the card "
        f"({len(refusals)} calls): {refusals[0]!r}; the ranks call "
        f"step.eager")
    log(f"parallel (b): {PAR_WORLD} gloo ranks on one card, "
        f"{r0['backend']} (the halo through the host), {wall:.1f} s "
        f"with start-up; halo bit for bit: {halo_ok}; video chunk of {f} "
        f"frames ({PAR_FPD} a rank) against the ranks emulated here: "
        f"{v_exact} (equal), against the serial chunk: {v_serial}, "
        f"{flips:.2e} of `valid` flipped (tol {PAR2_VALID_FLIPS}); train "
        f"step on {PAR_WORLD} x {cfg.train.batch_size_per_chip} pair(s) "
        f"against the ranks emulated here: losses off by {exact_loss:.3g} "
        f"(tol {PAR_LOSS_RTOL}), worst parameter at {exact_r:.3g} of "
        f"{TRAIN_REF_PARAM_TOL} ({exact_leaf}); against one process on the "
        f"global batch: losses off by {one_loss_err:.3g} of their value "
        f"(tol {PAR2_LOSS_RTOL}), worst leaf update off by {upd_r:.3g} of "
        f"its largest (tol {PAR2_UPDATE_REL}, {upd_leaf}); ranks' replicas "
        f"equal; rank ms {[r['ms'] for r in ranks]} (gloo, not a scaling "
        f"figure); launches "
        f"{[r['launches'] for r in ranks]}")
    if not halo_ok or any(v_exact.values()):
        raise AssertionError("parallel (b): the video chunk is off the "
                             "ranks emulated in one process")
    if not (exact_loss <= PAR_LOSS_RTOL and exact_r <= 1):
        raise AssertionError("parallel (b): the train step is off the ranks "
                             "emulated in one process")
    if not (one_loss_err <= PAR2_LOSS_RTOL and upd_r <= PAR2_UPDATE_REL
            and flips <= PAR2_VALID_FLIPS):
        raise AssertionError("parallel (b): the two ranks are off one "
                             "process on the whole batch or chunk")


def phase_parallel(cfg: Config, tree: dict, card: str) -> dict:
    """The data-parallel paths: (a) one NCCL rank, its programs profiled
    last, (b) two gloo ranks on the card; returns (a)'s launches per
    path."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    launches, profiled = phase_parallel_nccl(cfg, tree, card)
    phase_programs_profile(profiled, nccl=True)
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    phase_parallel_gloo(cfg, tree, card)
    log(f"parallel phase: {time.perf_counter() - t0:.1f} s on {card}")
    return launches


def load_tool(name: str):
    """This checkout's ``tools/<name>.py`` (the tools import each other by
    name, from their directory)."""
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    return importlib.import_module(name)


def phase_accuracy(card: str, tool_name: str, prefix: str, steps: int,
                   seed: int) -> tuple:
    """An accuracy tool's path (``tools/<tool_name>.py``): the train
    step's and the linked eval's kernels at its config's shapes against
    their plain versions (paths `prefix`_train and `prefix`_eval), then
    the tool's train (1 + `steps` steps, from scratch with --calibrate-bn)
    and its eval of one snippet with --link at full width, each with its
    launches counted (reset just before, read just after), the step's ms
    and peak memory, and the verdict line. Too few steps for the gate: its
    message is logged, not applied. Returns the kernels' entries and the
    launches per path."""
    tool = load_tool(tool_name)
    cfg = load_config(tool.CONFIG)
    b = cfg.train.batch_size_per_chip
    train, ev = f"{prefix}_train", f"{prefix}_eval"
    kernels = [phase_correlation(cfg, train, b, seed=seed),
               phase_correlation_bwd(cfg, b, seed=seed + 1, path=train),
               phase_psroi(cfg, train, seed=seed + 2),
               phase_psroi_bwd(cfg, seed=seed + 3, path=train),
               phase_nms(cfg, train, seed=seed + 4),
               phase_correlation(cfg, ev, LINK_FRAMES[ev], seed=seed + 5),
               phase_psroi(cfg, ev, seed=seed + 6),
               phase_nms(cfg, ev, seed=seed + 7),
               phase_linking(cfg, ev, seed=seed + 8),
               phase_epilogue(cfg, train, seed=seed + 9),
               phase_epilogue(cfg, train, seed=seed + 10, backward=True),
               phase_epilogue(cfg, ev, seed=seed + 11)]
    clock = load_tool("accuracy_runs_torch").StepClock(
        importlib.import_module("dtt_torch.train.trainer"))
    launches = {}

    def counted(fn, path):
        def call(*a, **k):
            torch.cuda.synchronize()
            reset_launches()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            launches[path] = read_launches()
            return out
        return call

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        args = tool.parse_args(["--out", d, "--steps", str(1 + steps),
                                "--snippets", "1"])
        torch.cuda.reset_peak_memory_stats()
        with mock.patch.object(train_torch, "main",
                               counted(train_torch.main, train)), \
                mock.patch.object(eval_torch, "main",
                                  counted(eval_torch.main, ev)), \
                clock:
            res = tool.run(args, device="cuda")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = clock.metrics
    wall = time.perf_counter() - t0
    for path in (train, ev):
        log(f"{path} launches: {launches[path]}")
        check_launches(path, launches[path])
    if not all(np.isfinite(v) for v in losses.values()):
        raise AssertionError(f"{prefix} train: losses not finite: {losses}")
    for key in ("mAP", "mAP_nolink", "link_uplift"):
        if not (key in res and np.isfinite(res[key]) and -1 <= res[key] <= 1):
            raise AssertionError(f"{prefix} eval: {key} is {res.get(key)!r}")
    ms = clock.ms_per_step()
    log(f"{tool_name.removeprefix('run_').removesuffix('_torch')}: "
        f"{clock.last - clock.first} timed steps of {b} pairs at "
        f"{cfg.input.canvas_height}x{cfg.input.canvas_width} "
        f"({cfg.model.backbone}): {ms:.2f} ms/step, {b * 1e3 / ms:.2f} "
        f"pairs/s, peak {peak:.2f} GiB, losses at step {clock.last}: "
        f"{ {k: round(v, 4) for k, v in losses.items()} }; eval of 1 "
        f"snippet with --link: mAP {res['mAP']}, mAP_nolink "
        f"{res['mAP_nolink']}; verdict {json.dumps(tool.verdict(res))}; "
        f"gate not applied at {1 + steps} steps (it would say: "
        f"{tool.gate(res) or 'PASS'}); {wall:.1f} s on {card}")
    return kernels, launches


def phase_mid_synth(card: str) -> tuple:
    """The mid_synth accuracy path (configs/mid_synth.yml: ResNet-50 at
    304x544, 19x34 maps, 10 classes, 12 anchors), paths mid_train and
    mid_eval, as `phase_accuracy` drives it."""
    return phase_accuracy(card, "run_mid_synth_torch", "mid", MID_STEPS,
                          seed=40)


def phase_flagship(card: str) -> tuple:
    """The flagship accuracy path (configs/flagship_synth.yml: Config()'s
    model, ResNet-101 dilated at 608x1088, 38x68 maps, 31 classes, 12
    anchors, 8 pairs a step rendered on the card, OHEM and tracking),
    paths flag_train and flag_eval, as `phase_accuracy` drives it."""
    return phase_accuracy(card, "run_flagship_synth_torch", "flag",
                          FLAG_STEPS, seed=50)


# the step programs (CUDA graphs): inference calls held bit for bit against
# the eager form on changing inputs, train steps from one state, calls of
# each form timed after warm-up, calls of each form under the profiler
PROGRAM_CHECKS = 3
PROGRAM_STEPS = 5
PROGRAM_CALLS = 20
PROGRAM_PROFILE_CALLS = 5


def exact(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit: floats by their bits (NaN payloads and signed zeros
    included), other dtypes by value."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        return torch.equal(a.view(ints), b.view(ints))
    return torch.equal(a, b)


def output_tensors(out) -> list:
    """The tensors of a step's outputs, in order."""
    if isinstance(out, dict):
        return list(out.values())
    return list(out)


def check_program(name: str, step, calls: list) -> None:
    """`step` (its programs) against ``step.eager`` on the same arguments
    call by call, bit for bit; the outputs of consecutive calls share no
    storage; each program captured once and replayed."""
    before = [p.replays for p in step.programs]
    prev = set()
    for i, args in enumerate(calls):
        got = output_tensors(step(*args))
        want = output_tensors(step.eager(*args))
        bad = [j for j, (g, w) in enumerate(zip(got, want))
               if not exact(g, w)]
        if bad or len(got) != len(want):
            raise AssertionError(f"programs {name}: call {i} outputs {bad} "
                                 f"differ from the eager form")
        ptrs = {t.untyped_storage().data_ptr() for t in got}
        if ptrs & prev:
            raise AssertionError(f"programs {name}: call {i} returned "
                                 "storage of the call before")
        prev = ptrs
    captures = [p.captures for p in step.programs]
    replays = [p.replays - b for p, b in zip(step.programs, before)]
    if captures != [1] * len(step.programs) or min(replays) < len(calls):
        raise AssertionError(f"programs {name}: captures {captures}, "
                             f"replays {replays} over {len(calls)} calls")
    log(f"programs {name}: {len(calls)} calls bit-equal to the eager form "
        f"(changing inputs), no storage shared between calls; "
        f"{len(step.programs)} program(s), captured once, replays "
        f"{replays}")


def program_memory(name: str, step, args: tuple) -> None:
    """Device memory of a fresh step's first call, eager form first
    (MiB above what was allocated before it): the call's peak and what
    stays allocated after it (a program's buffers, graph outputs and
    copies)."""
    parts = []
    for form, fn in (("eager", step.eager), ("graphed", step)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        kept = torch.cuda.memory_allocated() - base
        del out
        parts.append(f"{form} peak +{peak / 2**20:.1f} MiB, kept "
                     f"+{kept / 2**20:.1f} MiB")
    log(f"programs {name} memory of the first call: " + "; ".join(parts))


def host_ms(fn, n: int = PROGRAM_CALLS) -> dict:
    """Host ms of `n` calls of `fn(i)`, each ended by a synchronize, after
    two warm-up calls: median, min and max."""
    for i in range(2):
        fn(i)
    torch.cuda.synchronize()
    ms = []
    for i in range(n):
        t0 = time.perf_counter()
        fn(2 + i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"median": float(np.median(ms)), "min": min(ms), "max": max(ms)}


def log_forms(name: str, times: dict, card: str) -> None:
    log(f"programs {name} host ms a call ({PROGRAM_CALLS} calls after 2 "
        f"warm-up, synchronized): " + "; ".join(
            f"{form} median {t['median']:.3f} [{t['min']:.3f}-"
            f"{t['max']:.3f}]" for form, t in times.items())
        + f"; graphed/eager median "
        f"{times['graphed']['median'] / times['eager']['median']:.3f} on "
        f"{card}")


def train_programs(cfg: Config, tree: dict, name: str, batches: list,
                   render: bool, card: str, make_step=make_train_step):
    """PROGRAM_STEPS train steps of the program and of ``step.eager`` from
    one state, on the same batches and draws (and render generators
    seeded alike): losses, parameters, momentum buffers and the render
    generator's state bit for bit, with cuDNN's deterministic algorithms
    (its weight gradients need not be otherwise). Then host ms a step of
    both forms. `make_step(cfg, model, feat_hw, render_fn=)` makes the
    step (``make_train_step``, or a parallel one). Returns a closure
    (form, i) -> one step, for the profile."""
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    b = cfg.train.batch_size_per_chip
    render_fn = make_pair_render_fn(h, w) if render else None
    dgen = torch.Generator(device="cuda").manual_seed(61)
    draws = [sample_draws(cfg, b, dgen, "cuda") for _ in batches]
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for form in ("graphed", "eager"):
            model, state = create_train_state(cfg, "cuda", tree=tree)
            step = make_step(cfg, model, (h // 16, w // 16),
                             render_fn=render_fn)
            fn = step if form == "graphed" else step.eager
            gen = (torch.Generator(device="cuda").manual_seed(62) if render
                   else None)
            metrics = []
            for i in range(PROGRAM_STEPS):
                state, m = fn(state, batches[i], draws[i], gen)
                metrics.append(m)
            torch.cuda.synchronize()
            runs[form] = (metrics, state, gen, step)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (mg, sg, gg, step), (me, se, ge, _) = runs["graphed"], runs["eager"]
    bad = [(i, k) for i, (a, e) in enumerate(zip(mg, me)) for k in a
           if not exact(a[k], e[k])]
    pe = se.model.state_dict()
    bad += [k for k, v in sg.model.state_dict().items() if not exact(v, pe[k])]
    bufs = lambda st: [x["momentum_buffer"] for x in st.optimizer.state.values()]
    bad += [f"momentum {i}" for i, (x, y) in enumerate(zip(bufs(sg), bufs(se)))
            if not exact(x, y)]
    if render and not torch.equal(gg.get_state(), ge.get_state()):
        bad.append("render generator state")
    if bad or step.programs[0].captures != 1:
        raise AssertionError(f"programs {name}: the graphed steps differ "
                             f"from the eager ones: {bad[:6]} ({len(bad)})")
    log(f"programs {name}: {PROGRAM_STEPS} train steps (1 eager, then "
        f"captured, {step.programs[0].replays} replays) bit-equal to "
        f"{PROGRAM_STEPS} eager ones from the same state: every loss, "
        f"{len(pe)} parameters and buffers, {len(bufs(sg))} momentum "
        f"buffers" + (", the render generator's state" if render else ""))
    del runs, se, me, ge
    box = {"state": sg}
    gen = gg

    def one(form, i):
        fn = step if form == "graphed" else step.eager
        box["state"], _ = fn(box["state"], batches[i % len(batches)],
                             draws[i % len(draws)], gen)

    log_forms(name, {f: host_ms(lambda i, f=f: one(f, i))
                     for f in ("graphed", "eager")}, card)
    return one


def sgd_bits(cfg: Config) -> None:
    """The port's update (``sgd_step_``: a device rate, the product
    rounded before the add) against ``torch.optim.SGD.step`` at the same
    float rate, over 3 steps (the first makes the momentum buffers) on
    random float32 parameters and gradients: how many elements of the
    parameters differ and by how many float32 ulps at most."""
    gen = torch.Generator(device="cuda").manual_seed(70)
    shapes = [(1024, 1024), (512, 256, 3, 3), (2048,), (4096, 1024)]
    base = [torch.randn(s, device="cuda", generator=gen) for s in shapes]
    grads = [[torch.randn(s, device="cuda", generator=gen) * 1e-2
              for s in shapes] for _ in range(3)]
    t = cfg.train
    runs = []
    for form in ("sgd_step_", "SGD.step"):
        params = [torch.nn.Parameter(b.clone()) for b in base]
        opt = torch.optim.SGD([{"params": params, "lr_mult": 1.0,
                                "weight_decay": t.weight_decay}],
                              lr=t.learning_rate, momentum=t.momentum)
        for g in grads:
            for p, x in zip(params, g):
                p.grad = x.clone()
            if form == "SGD.step":
                opt.step()
            else:
                with torch.no_grad():
                    sgd_step_(opt, torch.full((), t.learning_rate,
                                              device="cuda"))
        runs.append([p.detach() for p in params])
    n = sum(b.numel() for b in base)
    differ = sum(int((a != b).sum()) for a, b in zip(*runs))
    ulps = max(int((a.view(torch.int32) - b.view(torch.int32)).abs().max())
               for a, b in zip(*runs))
    log(f"programs update bits: sgd_step_ against torch.optim.SGD.step at "
        f"lr {t.learning_rate}, 3 steps: {differ} of {n} parameter "
        f"elements differ, by at most {ulps} float32 ulp(s)")


def phase_programs(cfg: Config, tree: dict, card: str) -> None:
    """The serial steps as programs (CUDA graphs) at ``Config()``'s full
    width: the 17-frame video chunk under both ``split_video_step`` forms,
    the 4-pair batch, the single frame, the ``Config()`` train step and
    the flagship's (8 pairs rendered on the card), each held bit for bit
    against its eager form (``step.eager``) over PROGRAM_CHECKS calls with
    changing frames, extents and scales (train: PROGRAM_STEPS steps from
    one state), then host ms a call of both forms and, last, the card's
    busy share of each under the profiler."""
    sgd_bits(cfg)
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    m = cfg.model
    model = from_jax_params(tree, m, device="cuda")
    rng = np.random.RandomState(60)
    extents = [(h - 8 * i, w - 48 * i) for i in range(PROGRAM_CHECKS)]
    scales = [1.0, 0.8, 1.25][:PROGRAM_CHECKS]
    hw = [torch.tensor(e, dtype=torch.float32, device="cuda")
          for e in extents]
    profiled = {}

    def frames(n):
        return [torch.from_numpy(rng.randint(0, 256, (n, h, w, 3)).astype(
            np.uint8)) for _ in range(PROGRAM_CHECKS)]

    chunks = frames(FRAMES_PER_CHUNK)
    for split in (True, False):
        c = cfg.replace(eval=cfg.eval.replace(split_video_step=split))
        step = make_video_step(c, model, FRAMES_PER_CHUNK)
        name = f"video chunk (split_video_step={split})"
        program_memory(name, step, (chunks[0], hw[0], scales[0]))
        check_program(name, step, [(chunks[i], hw[i], scales[i])
                                   for i in range(PROGRAM_CHECKS)])
        forms = {"graphed": step, "eager": step.eager}
        log_forms(name, {f: host_ms(lambda i, fn=fn: fn(
            chunks[i % PROGRAM_CHECKS], hw[0], 1.0)) for f, fn in
            forms.items()}, card)
        profiled[name] = lambda form, i, forms=forms: forms[form](
            chunks[i % PROGRAM_CHECKS], hw[0], 1.0)
    pairs = [x.reshape(PAIR_BATCH, 2, h, w, 3)
             for x in frames(2 * PAIR_BATCH)]
    step = make_pair_step(cfg, model, PAIR_BATCH)
    program_memory("pair batch", step, (pairs[0], hw[0], scales[0]))
    check_program("pair batch", step, [(pairs[i], hw[i], scales[i])
                                       for i in range(PROGRAM_CHECKS)])
    pforms = {"graphed": step, "eager": step.eager}
    log_forms("pair batch", {f: host_ms(lambda i, fn=fn: fn(
        pairs[i % PROGRAM_CHECKS], hw[0], 1.0)) for f, fn in
        pforms.items()}, card)
    profiled["pair batch"] = lambda form, i: pforms[form](
        pairs[i % PROGRAM_CHECKS], hw[0], 1.0)
    images = frames(1)
    step = make_single_frame_step(cfg, model)
    program_memory("single frame", step, (images[0], extents[0], scales[0]))
    check_program("single frame", step, [(images[i], extents[i], scales[i])
                                         for i in range(PROGRAM_CHECKS)])
    fforms = {"graphed": step, "eager": step.eager}
    log_forms("single frame", {f: host_ms(lambda i, fn=fn: fn(
        images[i % PROGRAM_CHECKS], extents[0])) for f, fn in
        fforms.items()}, card)
    profiled["single frame"] = lambda form, i: fforms[form](
        images[i % PROGRAM_CHECKS], extents[0])

    t = cfg.train
    b = t.batch_size_per_chip
    brng = np.random.RandomState(t.seed)
    batches = [synthetic_batch(brng, b, h, w, m.num_classes,
                               cfg.input.max_gt_boxes, cfg.input.pixel_means,
                               uint8=True, num_objects=cfg.input.synthetic_objects)
               for _ in range(PROGRAM_STEPS)]
    profiled["Config() train step"] = train_programs(
        cfg, tree, "Config() train step", batches, False, card)
    fcfg = load_config(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "configs", "flagship_synth.yml"))
    fh, fw = fcfg.input.canvas_height, fcfg.input.canvas_width
    frng = np.random.RandomState(fcfg.train.seed)
    fbatches = [sample_params_batch(
        frng, fcfg.train.batch_size_per_chip, fh, fw,
        fcfg.model.num_classes, fcfg.input.max_gt_boxes,
        num_objects=fcfg.input.synthetic_objects)
        for _ in range(PROGRAM_STEPS)]
    profiled["flagship train step"] = train_programs(
        fcfg, init_jax_params(fcfg.model, seed=0), "flagship train step",
        fbatches, True, card)
    phase_programs_profile(profiled)


def phase_programs_profile(profiled: dict, nccl: bool = False) -> None:
    """PROGRAM_PROFILE_CALLS calls of each form of each program under
    ``torch.profiler``: the card's busy share (the union of its kernel
    intervals over the traced wall time) and device kernels a call; with
    `nccl`, also the device events a call whose name names NCCL, and the
    device copies a call."""
    from torch.profiler import ProfilerActivity, profile
    for name, one in profiled.items():
        parts = []
        for form in ("graphed", "eager"):
            one(form, 0)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for i in range(PROGRAM_PROFILE_CALLS):
                    one(form, 1 + i)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            kernels = [e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            n = PROGRAM_PROFILE_CALLS
            if not kernels:
                parts.append(f"{form} {wall / n:.2f} ms wall, busy share "
                             "not measured (no device events)")
                continue
            busy = busy_ms((e.time_range.start, e.time_range.end)
                           for e in kernels)
            parts.append(f"{form} {wall / n:.2f} ms wall, device busy "
                         f"{busy / n:.2f} ms ({100 * busy / wall:.1f}%), "
                         f"{len(kernels) / n:.0f} device events a call")
            if nccl:
                names = sorted({e.name[:60] for e in kernels
                                if "nccl" in e.name.lower()})
                copies = sum("memcpy" in e.name.lower() for e in kernels)
                parts[-1] += (f", {sum('nccl' in e.name.lower() for e in kernels) / n:.1f}"
                              f" NCCL device events a call {names}, "
                              f"{copies / n:.1f} device copies a call")
        log(f"programs {name} profile ({PROGRAM_PROFILE_CALLS} calls a "
            f"form): " + "; ".join(parts))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_card()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    phase_build()
    cfg = Config()
    pairs = cfg.train.batch_size_per_chip
    kernels = [phase_correlation(cfg, "video", FRAMES_PER_CHUNK - 1, seed=1),
               phase_psroi(cfg, "video", seed=2),
               phase_correlation(cfg, "train", pairs, seed=5),
               phase_correlation_bwd(cfg, pairs, seed=4),
               phase_psroi(cfg, "train", seed=6),
               phase_psroi_bwd(cfg, seed=3),
               phase_correlation(cfg, "pair", PAIR_BATCH, seed=7),
               phase_psroi_mm(cfg, seed=8),
               *phase_frame_pools(cfg, seed=9),
               *phase_correlation_forms(cfg, 1, seed=10),
               phase_correlation(cfg, "parallel_video", FRAMES_PER_CHUNK,
                                 seed=13),
               phase_psroi(cfg, "parallel_video", seed=14),
               *(phase_nms(cfg, path, seed=20 + 2 * i) for i, path in
                 enumerate(("video", "train", "pair", "frame",
                            "parallel_video"))),
               phase_linking(cfg, "pair", seed=30),
               phase_linking(cfg, "eval_video", seed=31),
               *(phase_epilogue(cfg, path, seed=80 + i) for i, path in
                 enumerate(("video", "train", "pair", "frame",
                            "parallel_video"))),
               phase_epilogue(cfg, "train", seed=86, backward=True)]
    link_timing(cfg, LINK_VID_FRAMES, seed=32, what="vid_len")
    # the eval video chunk gives the trunk the video chunk's shapes
    kernels += [dict(k, path="eval_video", measured_as="video")
                for k in kernels
                if k["name"] == "epilogue" and k["path"] == "video"]
    # the parallel train and pair paths give each kernel the shapes of the
    # serial ones (one rank: the same batch), so their entries are the
    # serial ones' times, marked with the path they were measured at (the
    # parallel pair step links no tubes)
    kernels += [dict(k, path="parallel_" + k["path"], measured_as=k["path"])
                for k in kernels
                if k["path"] in ("train", "pair") and k["name"] != "linking"]
    phase_nms_crafted()
    phase_linking_cases()
    phase_correlation_forms(cfg, FRAMES_PER_CHUNK - 1, seed=1)
    phase_wide_windows(seed=12)
    phase_reference()
    phase_train_reference()
    phase_pair_reference()
    phase_frame_reference()
    phase_epilogue_exact(cfg)
    phase_epilogue_trunk(cfg)
    t0 = time.perf_counter()
    tree = init_jax_params(cfg.model, seed=0)
    log(f"full-width weights from a numpy seed in "
        f"{time.perf_counter() - t0:.1f} s")
    launches = {"video": phase_main_path(cfg, card, tree),
                "train": phase_train(cfg, tree, card),
                **phase_eval(cfg, tree, card),
                "frame": phase_frame_path(cfg, tree, card)}
    phase_bench(card)
    phase_data(cfg, tree, card)
    phase_programs(cfg, tree, card)
    # after the serial programs' profile: the parallel programs are
    # profiled too, and a traced card slows later launches
    launches.update(phase_parallel(cfg, tree, card))
    del tree
    phase_weights(card)
    for phase in (phase_mid_synth, phase_flagship):
        acc_kernels, acc_launches = phase(card)
        kernels += acc_kernels
        launches.update(acc_launches)
    for k in kernels:
        k["launches"] = launches[k["path"]][k["name"]]
    phase_correlation_device(cfg)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
