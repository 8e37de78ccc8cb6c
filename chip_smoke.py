"""Drive dtt_torch's video-mode inference, training, evaluation and
single-frame detection on one CUDA card and check them.

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
   plain PyTorch version (stated tolerance), and CUDA-event times of those
   calls through the kernel, the plain version and, where one exists, one
   PyTorch call computing the same function, beside the least time the
   card could take; the channel-split correlation also beside the unsplit
   one at a video chunk's 16 pairs; then correlation windows past the
   tensor-core band (d=16/s=4, d=10/s=2) in bf16 and f32 under every
   kernel form, forward and backward, against the plain versions;
4. small references: the tiny test config in float32 through the kernels
   on the card against the plain versions on the CPU, for the video path,
   for one train step (same weights, same injected draws; losses, every
   gradient leaf and the updated parameters), for the pair path at
   tau=2 with the SAT pool, tube linking included, and for the
   single-frame step, every per-frame pool form and the split
   correlation with their gradients;
5. the video path: ``Config()`` at full width (ResNet-101, 608x1088, bf16,
   31 classes), random flax-layout weights from a numpy seed carried over
   by ``from_jax_params``, and ``evaluate_snippet_video`` over a uint8
   snippet of several chunks, with its launch counts and the stage split
   of a video chunk (its pool stage split again into cast, bounds, kernel,
   division and mean) and of a pair batch;
6. the training path: ``Config()`` at full width, the same weights,
   ``create_train_state``/``make_train_step`` on synthetic uint8 pairs:
   one warm-up step and several timed ones, its launch counts (read from
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
   split, then on the last frame ``rfcn_head`` under every ``impl`` and
   ``correlation`` under both kernel forms at one pair's three scales,
   each checked, its launches counted and timed.

It prints a JSON line of the kernels' numbers before the last line, one
entry per kernel and path, each with the launches of that path's run, and
ends with ``{"ok": true, "device": {...}}``. It needs no network and runs
without JAX. Without a CUDA card it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dtt_torch.core.anchors import grid_anchors_for
from dtt_torch.core.config import Config
from dtt_torch.data.synthetic import synthetic_batch
from dtt_torch.eval.inference import (evaluate_snippet, evaluate_snippet_video,
                                      link_snippet, make_pair_step,
                                      make_single_frame_step, make_video_step)
from dtt_torch.models.dnt import (Detections, cosine_prep,
                                  decode_detections_batched,
                                  decode_frame_detections, is_frozen,
                                  normalize_device_images, pool_vote_fused,
                                  rfcn_head)
from dtt_torch.models.rpn import Proposals, proposal_layer, softmax
from dtt_torch.models.targets import sample_draws
from dtt_torch.ops import _build
from dtt_torch.ops import correlation as corr_ops
from dtt_torch.ops import psroi as psroi_ops
from dtt_torch.train import losses as train_losses
from dtt_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from dtt_torch.train.trainer import (apply_gradients, batch_to_device,
                                     create_train_state, make_train_step)
from dtt_torch.utils.params import from_jax_params, init_jax_params

import eval_torch

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
# SAT bin sums, kernel vs plain on one table: the same two f32 differences
# in the same order, so 0 is expected; 1e-6 of the largest |sum| would
# still flag a wrong corner or a reordered difference, which move a sum
# by the SAT's own magnitude
PSROI_MM_REL_TOL = 1e-6
BWD_REL_TOL = 8e-3           # bf16 gradients: one bf16 ulp of the largest
TRAIN_STEPS = 6              # timed full-width train steps (after 1 warm-up)
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
# SAT bin means, kernel vs plain on one table: the same corner order and
# division, so 0 is expected; 1e-6 of the largest |mean| guards the same
# faults as PSROI_MM_REL_TOL
PSROI_MEAN_REL_TOL = 1e-6
# correlation windows past the tensor-core band that dtt takes
WIDE_WINDOWS = ((16, 4), (10, 2))
KERNELS = {"correlation": corr_ops.correlation_cuda,
           "correlation_split": corr_ops.correlation_split_cuda,
           "correlation_bwd": corr_ops.correlation_bwd_cuda,
           "psroi_direct": psroi_ops.psroi_sums_cuda,
           "psroi_direct_bwd": psroi_ops.psroi_bwd_cuda,
           "psroi_mm": psroi_ops.psroi_mm_sums_cuda,
           "psroi_sat_mean": psroi_ops.psroi_sat_means_cuda}
# the kernels each driven path must launch
PATH_KERNELS = {"video": ("correlation", "psroi_direct"),
                "train": ("correlation", "correlation_bwd", "psroi_direct",
                          "psroi_direct_bwd"),
                "pair": ("correlation", "psroi_mm"),
                "eval_video": ("correlation", "psroi_direct"),
                "frame": ("correlation", "correlation_split", "psroi_mm",
                          "psroi_sat_mean")}


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


def phase_correlation_bwd(cfg: Config, pairs: int, seed: int) -> dict:
    """The correlation backward of one train step's pairs at the 3
    scales."""
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
    log(f"correlation_bwd [train]: {pairs} pair(s) x 3 scales "
        f"{[tuple(c[0].shape) for c in cases]} bf16 d={d} s={s}: max_abs_err"
        f" {err:.3g} (tol 2^-7 |want| + 1e-5), kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library: none (no single PyTorch call computes "
        f"it), bound_us {bound_ms * 1e3:.1f} ({bound_by}, {nbytes / 1e6:.1f} "
        f"MB, {ops / 1e9:.2f} GFLOP), {bound_ms / ms:.1%} of the bound")
    return {"name": "correlation_bwd", "path": "train", "route": "cuda",
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
    if path == "video":
        return [(FRAMES_PER_CHUNK - 1, m.rpn.post_nms_top_n_test,
                 dc + db + 4)]
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


def phase_psroi_bwd(cfg: Config, seed: int) -> dict:
    """The pool backward's calls of one train step (cls, bbox and track
    maps), each against its plain version; times are for all of the
    calls."""
    k = cfg.model.roi.ps_grid
    h, w = cfg.input.canvas_height // 16, cfg.input.canvas_width // 16
    bf16 = torch.bfloat16
    cases = pool_cases(cfg, "train")
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
    log(f"psroi_direct_bwd [train]: ghat {[tuple(gh.shape) for gh, _ in inputs]}"
        f" f32 -> bf16 maps, k={k}: max_abs_err {err:.3g} (tol {BWD_REL_TOL} "
        f"of the largest per call), kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, library einsum {library_ms:.4f} ms (bf16, max abs diff "
        f"{lib_err:.3g}), bound_us {bound_ms * 1e3:.1f} ({bound_by}, "
        f"{nbytes / 1e6:.1f} MB, {adds / 1e9:.3f} G adds), "
        f"{bound_ms / ms:.1%} of the bound")
    return {"name": "psroi_direct_bwd", "path": "train", "route": "cuda",
            "source": "dtt_torch/ops/csrc/psroi.cu",
            "replaces": "dtt/ops/psroi.py:479",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def phase_psroi_mm(cfg: Config, seed: int) -> dict:
    """The SAT pool's bin sums of one pair batch (the fused maps of its
    PAIR_BATCH first frames at the test proposals, float32) against the
    plain version; the SAT build is timed on its own."""
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
    got = psroi_ops.psroi_mm_sums_cuda(table, *bd)
    torch.cuda.synchronize()
    want = psroi_ops.psroi_mm_sums_plain(table, *bd)
    err = (got - want).abs().max().item()
    tol = PSROI_MM_REL_TOL * want.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"psroi SAT kernel vs plain (pair): max abs err "
                             f"{err} > {tol}")
    ms = time_ms(lambda: psroi_ops.psroi_mm_sums_cuda(table, *bd), iters=20)
    plain_ms = time_ms(lambda: psroi_ops.psroi_mm_sums_plain(table, *bd),
                       iters=3, warmup=1)
    sat_ms = time_ms(lambda: psroi_ops.sat(maps), iters=20)
    r, c = psroi_ops.row_col_indicators(*bd, h, w)
    s6 = table.reshape(b, h + 1, w + 1, k, k, d)
    library = lambda: torch.einsum("bnpy,byxpqd,bnqx->bnpqd", r, s6, c)
    lib_err = (library() - got).abs().max().item()
    library_ms = time_ms(library, iters=3, warmup=1)
    # bytes this run's bins need: each distinct SAT corner of a non-empty
    # bin read once (D channels), the sums written once, the bounds read
    bound_ms, bound_by, nbytes, corners = sat_bound(bd, b, h, w, k, d,
                                                    got.numel(), 3)
    log(f"psroi_mm [pair]: SAT {tuple(table.shape)} f32, {n} RoIs, k={k}, "
        f"D={d}: max_abs_err {err:.3g} (tol {tol:.3g}), kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, library einsum {library_ms:.4f} ms (f32, "
        f"max abs diff {lib_err:.3g}), SAT build {sat_ms:.4f} ms, bound_us "
        f"{bound_ms * 1e3:.1f} ({bound_by}, {nbytes / 1e6:.1f} MB: "
        f"{corners} distinct corners of non-empty bins x {d} channels)")
    return {"name": "psroi_mm", "path": "pair", "route": "cuda",
            "source": "dtt_torch/ops/csrc/psroi.cu",
            "replaces": "dtt/ops/psroi.py:311",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


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


def phase_frame_pools(cfg: Config, seed: int) -> list:
    """Kernels 5 and 6 at one frame's shapes: the SAT bin sums
    (``psroi_mm_sums_cuda`` at B=1, the per-frame ``pallas_mm`` pool) and
    the SAT bin means (``psroi_sat_means_cuda``, the ``pallas`` pool) of
    one frame's float32 cls, bbox and track maps at the test proposals,
    each call against its plain version; times are for the three calls.
    The SAT build is timed on its own."""
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
    forms = (("psroi_mm", psroi_ops.psroi_mm_sums_cuda,
              psroi_ops.psroi_mm_sums_plain, PSROI_MM_REL_TOL, 3,
              "dtt/ops/psroi.py:226"),
             ("psroi_sat_mean", psroi_ops.psroi_sat_means_cuda,
              psroi_ops.psroi_sat_means_plain, PSROI_MEAN_REL_TOL, 4,
              "dtt/ops/psroi.py:586"))
    entries = []
    for name, kernel, plain, rel_tol, ops, replaces in forms:
        err = 0.0
        for t, bd in calls:
            got = kernel(t, *bd)
            torch.cuda.synchronize()
            want = plain(t, *bd)
            e = (got - want).abs().max().item()
            tol = rel_tol * want.abs().max().item()
            if not e <= tol:
                raise AssertionError(f"{name} kernel vs plain (frame, "
                                     f"{tuple(t.shape)}): max abs err {e} > "
                                     f"{tol}")
            err = max(err, e)
        ms = time_ms(lambda: [kernel(t, *bd) for t, bd in calls], iters=20)
        plain_ms = time_ms(lambda: [plain(t, *bd) for t, bd in calls],
                           iters=3, warmup=1)
        bounds = [sat_bound(bd, 1, h, w, k, d, n * k * k * d, ops)
                  for (_, bd), d in zip(calls, ds)]
        nbytes = sum(x[2] for x in bounds)
        bound_ms, bound_by = bound(nbytes, sum(ops * n * k * k * d
                                               for d in ds), F32_OPS_PER_S)
        log(f"{name} [frame]: SAT {[tuple(t.shape) for t, _ in calls]} f32, "
            f"{n} RoIs, k={k}, D={ds}: max_abs_err {err:.3g} (tol {rel_tol} "
            f"of the largest), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library einsum {library_ms:.4f} ms (f32 bin sums), bound_us "
            f"{bound_ms * 1e3:.2f} ({bound_by}, {nbytes / 1e6:.2f} MB: "
            f"{[x[3] for x in bounds]} distinct corners of non-empty bins)")
        entries.append({"name": name, "path": "frame", "route": "cuda",
                        "source": "dtt_torch/ops/csrc/psroi.cu",
                        "replaces": replaces, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": library_ms})
    log(f"SAT build [frame]: 3 tables {[tuple(t.shape) for t in tables]} "
        f"f32: {sat_ms:.4f} ms")
    return entries


def phase_correlation_forms(cfg: Config, pairs: int, seed: int) -> list:
    """Both correlation forward kernels on one set of inputs, `pairs`
    pairs x 3 scales: the unsplit kernel 1 (``correlation_cuda``) and the
    channel-split kernel 7 (``correlation_split_cuda``), each against the
    plain version and timed in turns (split, unsplit, unsplit, split).
    Returns their entries for the single-frame path."""
    t = cfg.model.track
    d, s = t.max_displacement, t.stride
    cases = corr_inputs(cfg, pairs, seed)
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
    run = lambda kernel: time_ms(lambda: [kernel(a, c, d, s)
                                          for a, c in cases], iters=20)
    ms = dict.fromkeys(kernels, 0.0)
    for name in ("correlation_split", "correlation", "correlation",
                 "correlation_split"):
        ms[name] += run(kernels[name]) / 2
    plain_ms = time_ms(lambda: [corr_ops.correlation_plain(a, c, d, s)
                                for a, c in cases], iters=3, warmup=1)
    bound_ms, bound_by, nbytes, ops = corr_bound(cases, d, s)
    log(f"correlation forms: {pairs} pair(s) x 3 scales "
        f"{[tuple(c[0].shape) for c in cases]} bf16 d={d} s={s}: split "
        f"kernel {ms['correlation_split']:.4f} ms (max_abs_err "
        f"{errs['correlation_split']:.3g}), unsplit kernel "
        f"{ms['correlation']:.4f} ms (max_abs_err {errs['correlation']:.3g}),"
        f" tol 2^-7 |want| + 1e-5; plain {plain_ms:.4f} ms, library: none, "
        f"bound_us {bound_ms * 1e3:.1f} ({bound_by}, {nbytes / 1e6:.1f} MB, "
        f"{ops / 1e9:.2f} GFLOP); share of the bound: split "
        f"{bound_ms / ms['correlation_split']:.1%}, unsplit "
        f"{bound_ms / ms['correlation']:.1%}")
    replaces = {"correlation": "dtt/ops/correlation.py:135",
                "correlation_split": "dtt/ops/correlation.py:275"}
    return [{"name": name, "path": "frame", "route": "cuda",
             "source": "dtt_torch/ops/csrc/correlation.cu",
             "replaces": replaces[name], "max_abs_err": errs[name],
             "ms": ms[name], "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": None} for name in kernels]


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
                    f"body {body if impl != 'pallas' else 'cuda_cores'} "
                    f"forward, {body} backward; launched {launched}; max abs"
                    f" err out/df1/df2 {[f'{e:.3g}' for e in errs]}")


def tiny_config() -> Config:
    cfg = Config()
    m = cfg.model
    return cfg.replace(
        model=m.replace(backbone="tiny", dtype="float32", frozen_stages=0,
                        reduced_channels=64, num_classes=4,
                        rpn=m.rpn.replace(channels=32, pre_nms_top_n_test=64,
                                          post_nms_top_n_test=16),
                        roi=m.roi.replace(ps_grid=3),
                        track=m.track.replace(max_displacement=2, stride=1)),
        input=cfg.input.replace(canvas_height=64, canvas_width=96))


def phase_reference() -> None:
    """Tiny config, float32: kernels on the card vs plain versions on the
    CPU, end to end. `valid` equal; values to float32 roundoff."""
    cfg = tiny_config()
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
    log(f"reference: tiny config f32, card vs CPU: {int(gv.sum())} valid "
        f"detections equal; max |d score| {np.abs(gs - cs).max():.3g}, "
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
                track_deltas=pooled[..., dc + db:]))
    log_stages(what, times)
    if path == "video":
        phase_pool_split(mcfg, fused, props.rois, pooled)


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
    evaluate_snippet_video(cfg, step, frames[:FRAMES_PER_CHUNK], im_hw=im_hw)
    torch.cuda.synchronize()                        # warm-up: 2 chunks

    torch.cuda.reset_peak_memory_stats()
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


def train_tiny_config() -> Config:
    """The tiny training config of the CPU tests (tests/test_train.py)."""
    cfg = Config()
    m = cfg.model
    return cfg.replace(
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
                                max_gt_boxes=4))


def worst_leaf(ratios: dict) -> tuple:
    """The largest of `ratios` (a value per leaf) and its leaf."""
    name = max(ratios, key=ratios.get)
    return ratios[name], name


def phase_train_reference() -> None:
    """Tiny config, float32: one train step through the kernels on the
    card against one through the plain versions on the CPU, from the same
    weights, batch and draws. Losses within TRAIN_REF_LOSS_TOL, every
    leaf's clipped gradient within TRAIN_REF_GRAD_REL of the leaf's
    largest element, the updated parameters element by element within
    TRAIN_REF_PARAM_TOL (atol, rtol)."""
    cfg = train_tiny_config()
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
    log(f"train reference: tiny config f32, one step, card vs CPU: max |d "
        f"loss| {loss_err:.3g} (tol {TRAIN_REF_LOSS_TOL}); {len(cpu_grads)} "
        f"gradient leaves, worst off by {grad_r:.3g} of the leaf's largest "
        f"(tol {TRAIN_REF_GRAD_REL}, {grad_leaf}); updated parameters worst at "
        f"{param_r:.3g} of {TRAIN_REF_PARAM_TOL} ({param_leaf}); max |grad| "
        f"{max(v.abs().max().item() for v in cpu_grads.values()):.3g}; total "
        f"{gpu_loss['total']:.6f}")


def phase_train(cfg: Config, tree: dict, card: str) -> dict:
    """The training path at full width: one warm-up step, then
    TRAIN_STEPS timed steps whose kernel launches are counted (returned);
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
               for _ in range(TRAIN_STEPS + PROFILE_STEPS + 2)]
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    log(f"train path: {m.backbone} {h}x{w} {m.dtype} compute, float32 "
        f"parameters, {m.num_classes} classes, k={m.roi.ps_grid}, "
        f"{m.rpn.pre_nms_top_n_train}/{m.rpn.post_nms_top_n_train} train "
        f"proposals, OHEM {t.ohem} top-{t.ohem_top_k} NMS "
        f"{t.ohem_nms_thresh}, batch {b} pair(s), frozen_stages "
        f"{m.frozen_stages}")
    t0 = time.perf_counter()
    state, metrics = step(state, batches[0], sample_draws(cfg, b, gen, "cuda"))
    torch.cuda.synchronize()
    log(f"train warm-up step: {(time.perf_counter() - t0) * 1e3:.1f} ms")

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    history = []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        state, metrics = step(state, batches[1 + i],
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
        errs = {}
        for impl, fn in heads.items():
            got = fn()
            torch.cuda.synchronize()
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
        f"xla (cls, bbox) {errs}")
    log(f"frame correlation at one pair x 3 scales "
        f"{[tuple(a.shape) for a, _ in corr_cases]} by impl: ms "
        f"{ {k: round(v, 4) for k, v in corr_ms.items()} }, max abs err vs "
        f"plain {corr_err:.3g} (tol 2^-7 |want| + 1e-5)")
    return launches


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
               *phase_correlation_forms(cfg, 1, seed=10)]
    phase_correlation_forms(cfg, FRAMES_PER_CHUNK - 1, seed=1)
    phase_wide_windows(seed=12)
    phase_reference()
    phase_train_reference()
    phase_pair_reference()
    phase_frame_reference()
    t0 = time.perf_counter()
    tree = init_jax_params(cfg.model, seed=0)
    log(f"full-width weights from a numpy seed in "
        f"{time.perf_counter() - t0:.1f} s")
    launches = {"video": phase_main_path(cfg, card, tree),
                "train": phase_train(cfg, tree, card),
                **phase_eval(cfg, tree, card),
                "frame": phase_frame_path(cfg, tree, card)}
    for k in kernels:
        k["launches"] = launches[k["path"]][k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
