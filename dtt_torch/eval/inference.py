"""Snippet inference, tube linking and strided-tube interpolation
(counterpart of ``dtt.eval.inference``).

* Video mode (``make_video_step``, ``evaluate_snippet_video``, tau=1):
  backbone features are computed once per frame and the F-1 adjacent pairs
  of a chunk are formed by shifting. The snippet driver extends the
  snippet by its last frame (the identity pair for frame T-1) and walks it
  in chunks that overlap by one frame.
* tau-strided testing (``make_pair_step``, ``evaluate_snippet``; D&T paper
  §4): only frames 0, tau, 2tau, ... are detected, each paired with frame
  min(t+tau, T-1), in batches of pairs; ``interpolate_tubes`` fills the
  skipped frames along the linked tubes.
* ``link_snippet``: tube linking + rescoring on the device.
* Single-frame R-FCN detection (``make_single_frame_step``): no tracking
  head, one frame per call.

The video and pair steps take the fused path under the psroi pooling mode
(one pool of the fused ps-maps) and the unfused one under the others
(``frame_features``, ``track_psmaps``, the batched detection and track
pools), as ``dtt`` chooses by ``roi.pooling_mode``.

Both drivers keep two batches in flight: CUDA work is queued
asynchronously and only the ``.cpu()`` of a finished batch waits. Their
frames are an array or a ``LazyFrames``, which decodes each frame of a
snippet on first touch and keeps a bounded cache.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from dtt_torch.core.anchors import grid_anchors_for
from dtt_torch.core.config import Config
from dtt_torch.core.device import resolve_device
from dtt_torch.eval.linking import Tubes, link_all_classes
from dtt_torch.models.dnt import (DnT, decode_detections_batched,
                                  decode_frame_detections, detect_frame,
                                  detect_frames_batched, detect_track_fused,
                                  normalize_device_images, track_rois_batched)


class PairOutputs(NamedTuple):
    """Per-class padded detections for frame t of each pair (batched)."""

    boxes: torch.Tensor    # (B, C-1, M, 4)
    scores: torch.Tensor   # (B, C-1, M)
    valid: torch.Tensor    # (B, C-1, M)
    tracked: torch.Tensor  # (B, C-1, M, 4) predicted boxes in frame t+tau


class LazyFrames:
    """A snippet's frames, indexable like the (T, H, W, 3) array of
    normalized canvases it stands for, decoded on first touch with only a
    small LRU cache resident.

    Real VID snippets run to thousands of frames at 7.9 MB a canvas (608 x
    1088 x 3 float32), so stacking a snippet before inference can take tens
    of GB. The snippet drivers touch frames in order with one frame of
    overlap between chunks (the strided driver, a batch of pairs at a
    time) and size the cache to that working set with ``ensure_cache``, so
    every frame decodes once. ``decode_count``, ``decode_ms`` and
    ``peak_cached`` count the decodes, their wall time and the most frames
    held at once.
    """

    def __init__(self, paths, input_cfg, cache_frames: int = 8,
                 prepare=None):
        from dtt_torch.data.transforms import prepare_image
        self.paths = list(paths)
        self.input_cfg = input_cfg
        self._prepare = prepare or prepare_image
        self._cap = max(int(cache_frames), 1)
        self._cache: OrderedDict = OrderedDict()
        self.decode_count = 0
        self.decode_ms = 0.0
        self.peak_cached = 0

    def ensure_cache(self, n: int) -> None:
        """Grow the cache to hold `n` frames, the consumer's working set
        (a chunk and its overlap, or a batch of pairs); never shrinks."""
        self._cap = max(self._cap, int(n))

    @property
    def shape(self):
        return (len(self.paths), self.input_cfg.canvas_height,
                self.input_cfg.canvas_width, 3)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i) -> np.ndarray:
        i = int(i)
        if i < 0:
            i += len(self.paths)
        if not 0 <= i < len(self.paths):
            raise IndexError(i)
        if i in self._cache:
            self._cache.move_to_end(i)
            return self._cache[i]
        t0 = time.perf_counter()
        img, _ = self._prepare(self.paths[i], self.input_cfg)
        self.decode_ms += (time.perf_counter() - t0) * 1e3
        self.decode_count += 1
        self._cache[i] = img
        if len(self._cache) > self._cap:
            self._cache.popitem(last=False)
        self.peak_cached = max(self.peak_cached, len(self._cache))
        return img


def _transfer_dtype(cfg: Config, frames: np.ndarray) -> torch.Tensor:
    """Host frames as the tensor to upload: uint8 canvases as they are
    (normalized on the device), float frames in the model's compute dtype
    (the backbone's first op is the same cast)."""
    t = torch.from_numpy(np.ascontiguousarray(frames))
    if t.dtype == torch.uint8:
        return t
    return t.to(getattr(torch, cfg.model.dtype))


def _gather_chunk(cfg: Config, frames, idxs) -> torch.Tensor:
    """Stack the requested frame indices into one transfer-ready chunk."""
    return _transfer_dtype(cfg, np.stack([np.asarray(frames[i])
                                          for i in idxs]))


def _step_setup(cfg: Config, model: DnT, device) -> tuple:
    """The step's device (CUDA unless the caller passes "cpu"), checked
    against the model's, and the canvas's anchors on it."""
    device = resolve_device(device)
    model_device = next(model.parameters()).device
    if model_device.type != device.type:
        raise ValueError(f"model is on {model_device}, step asked for {device}")
    h, w = cfg.input.canvas_height, cfg.input.canvas_width
    anchors = torch.from_numpy(
        grid_anchors_for(cfg.model.anchors, h // 16, w // 16)).to(device)
    return device, anchors


def _upload(frames: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cuda" and frames.device.type == "cpu":
        frames = frames.pin_memory()
    return frames.to(device, non_blocking=True)


def _detect_and_track_fused(cfg: Config, model: DnT, anchors, f_t, f_tau,
                            im_hw, scale) -> PairOutputs:
    """Everything after the trunk: 3-scale correlation + fused ps-maps,
    proposals, the fused pool and per-class decode, clipped to the true
    image extent `im_hw` with the RPN min-size filter at `scale`."""
    mcfg, ecfg = cfg.model, cfg.eval
    fused_maps = model.fused_psmaps(f_t, f_tau)
    _, det, deltas = detect_track_fused(mcfg, f_t, fused_maps, anchors,
                                        im_hw[0], im_hw[1], scale)
    return PairOutputs(*decode_detections_batched(
        mcfg, det, im_hw[0], im_hw[1], ecfg.score_thresh, ecfg.nms_thresh,
        ecfg.max_per_class, track_deltas=deltas))


def _detect_and_track(cfg: Config, model: DnT, anchors, f_t, f_tau, im_hw,
                      scale) -> PairOutputs:
    """The unfused counterpart of `_detect_and_track_fused`: the track maps
    of (f_t, f_tau), batched proposals, the cls/bbox pools of `f_t`
    (``frame_features``), the track pool at its RoIs and per-class decode.
    Any pooling mode."""
    mcfg, ecfg = cfg.model, cfg.eval
    track_maps = model.track_psmaps(f_t, f_tau)
    _, det = detect_frames_batched(mcfg, f_t, anchors, im_hw[0], im_hw[1],
                                   scale)
    deltas = track_rois_batched(mcfg, track_maps, det.rois)
    return PairOutputs(*decode_detections_batched(
        mcfg, det, im_hw[0], im_hw[1], ecfg.score_thresh, ecfg.nms_thresh,
        ecfg.max_per_class, track_deltas=deltas))


def _trunk_and_post(cfg: Config, model: DnT):
    """The trunk and the post-trunk stage of the video and pair steps for
    the pooling mode: fused under psroi, else unfused."""
    if cfg.model.roi.pooling_mode == "psroi":
        return model.frame_trunk, _detect_and_track_fused
    return model.frame_features, _detect_and_track


def make_video_step(cfg: Config, model: DnT, frames_per_chunk: int = 33,
                    device=None):
    """(frames (F, H, W, 3), im_hw (2,) float32 tensor on the device, scale)
    -> PairOutputs of F-1 pairs, as device tensors.

    Runs on `device` (CUDA unless the caller passes "cpu"), which must hold
    `model`. ``EvalConfig.split_video_step`` is ignored: eager PyTorch has
    no single program to split.
    """
    if frames_per_chunk < 2:
        raise ValueError("a chunk needs at least one frame pair")
    device, anchors = _step_setup(cfg, model, device)
    trunk, post = _trunk_and_post(cfg, model)

    @torch.inference_mode()
    def step(frames: torch.Tensor, im_hw: torch.Tensor, scale: float = 1.0
             ) -> PairOutputs:
        if frames.shape[0] != frames_per_chunk:
            raise ValueError(f"expected chunks of {frames_per_chunk} frames, "
                             f"got {tuple(frames.shape)}")
        images = normalize_device_images(_upload(frames, device), im_hw,
                                         cfg.input.pixel_means)
        feats = trunk(images)
        return post(cfg, model, anchors, feats.slice(slice(None, -1)),
                    feats.slice(slice(1, None)), im_hw, scale)

    step.frames_per_chunk = frames_per_chunk
    step.device = device
    return step


def make_pair_step(cfg: Config, model: DnT, batch: int = 4, device=None):
    """(pairs (B, 2, H, W, 3), im_hw (2,) float32 tensor on the device,
    scale) -> PairOutputs of the B pairs (detections of each pair's first
    frame, tracked into its second), as device tensors.

    One trunk pass over the 2B frames, then frames 0::2 and 1::2 as the
    pair halves (``dtt``'s ``_pair_forward``). Runs on `device` (CUDA
    unless the caller passes "cpu"), which must hold `model`.
    ``EvalConfig.split_video_step`` is ignored, as in `make_video_step`.
    """
    if batch < 1:
        raise ValueError("a pair batch needs at least one pair")
    device, anchors = _step_setup(cfg, model, device)
    trunk, post = _trunk_and_post(cfg, model)

    @torch.inference_mode()
    def step(pairs: torch.Tensor, im_hw: torch.Tensor, scale: float = 1.0
             ) -> PairOutputs:
        if pairs.shape[:2] != (batch, 2):
            raise ValueError(f"expected batches of {batch} pairs "
                             f"(B, 2, H, W, 3), got {tuple(pairs.shape)}")
        pairs = normalize_device_images(_upload(pairs, device), im_hw,
                                        cfg.input.pixel_means)
        feats = trunk(pairs.reshape(-1, *pairs.shape[2:]))
        return post(cfg, model, anchors, feats.slice(slice(0, None, 2)),
                    feats.slice(slice(1, None, 2)), im_hw, scale)

    step.batch = batch
    step.device = device
    return step


def make_single_frame_step(cfg: Config, model: DnT, device=None):
    """(image (1, H, W, 3), im_hw=None, scale) -> per-class detections
    (boxes (C-1, M, 4), scores (C-1, M), valid (C-1, M)) as device tensors:
    ``frame_features`` -> ``detect_frame`` -> ``decode_frame_detections``
    with the eval thresholds (single-frame R-FCN detection, no tracking).

    A uint8 image is normalized on the device; `im_hw` is its true (h, w)
    extent (default: the canvas). Runs on `device` (CUDA unless the caller
    passes "cpu"), which must hold `model`.
    """
    device, anchors = _step_setup(cfg, model, device)
    mcfg, ecfg = cfg.model, cfg.eval
    canvas = (cfg.input.canvas_height, cfg.input.canvas_width)

    @torch.inference_mode()
    def step(image: torch.Tensor, im_hw=None, scale: float = 1.0):
        if image.dim() != 4 or image.shape[0] != 1:
            raise ValueError(f"expected one image (1, H, W, 3), got "
                             f"{tuple(image.shape)}")
        hw = torch.as_tensor(canvas if im_hw is None else im_hw,
                             dtype=torch.float32, device=device)
        image = normalize_device_images(_upload(image, device), hw,
                                        cfg.input.pixel_means)
        feats = model.frame_features(image)
        _, det = detect_frame(mcfg, feats, anchors, hw[0], hw[1], scale)
        return decode_frame_detections(mcfg, det, hw[0], hw[1],
                                       ecfg.score_thresh, ecfg.nms_thresh,
                                       ecfg.max_per_class)

    step.device = device
    return step


def evaluate_snippet_video(cfg: Config, video_step, frames,
                           frames_per_chunk: int | None = None,
                           im_hw=None, scale: float = 1.0):
    """Snippet eval with per-frame feature sharing (τ=1).

    `frames` is a (T, H, W, 3) array (uint8 canvases or normalized floats)
    or a LazyFrames, whose cache is sized to a chunk and its overlap;
    `im_hw` the true (h, w) extent on the canvas (default: the canvas).
    Returns numpy (C-1, T, M, 4) boxes, (C-1, T, M) scores, (C-1, T, M)
    valid and (C-1, T, M, 4) tracked boxes.
    """
    f = frames_per_chunk or video_step.frames_per_chunk
    if f < 2:
        raise ValueError("a chunk needs at least one frame pair")
    t_len = frames.shape[0]
    if im_hw is None:
        im_hw = (frames.shape[1], frames.shape[2])
    im_hw = torch.tensor(im_hw, dtype=torch.float32, device=video_step.device)
    if isinstance(frames, LazyFrames):   # each frame decodes once
        frames.ensure_cache(f + 1)

    outs = []
    pending: list = []  # dispatch-ahead queue: host work overlaps the device

    def fetch(entry):
        out, real = entry
        return [x[:real].cpu().numpy() for x in out]

    start = 0
    while start < t_len:
        # index min(i, T-1): duplicates the last frame both for the final
        # identity pair and as tail padding (trimmed via `real`)
        idxs = [min(i, t_len - 1) for i in range(start, start + f)]
        chunk = _gather_chunk(cfg, frames, idxs)
        real = min(f - 1, t_len - start)  # pairs produced by this chunk
        pending.append((video_step(chunk, im_hw, scale), real))
        if len(pending) > 2:      # keep 2 chunks in flight
            outs.append(fetch(pending.pop(0)))
        start += f - 1            # overlap: last frame re-used as next f_t
    outs.extend(fetch(e) for e in pending)
    return tuple(np.concatenate([o[i] for o in outs], axis=0)[:t_len]
                 .swapaxes(0, 1) for i in range(4))


def evaluate_snippet(cfg: Config, pair_step, frames, tau: int = 1,
                     im_hw=None, scale: float = 1.0):
    """Stride-tau pairs over a snippet, batched; stacked per-frame dets.

    `frames` is a (T, H, W, 3) array (uint8 canvases or normalized
    floats) or a LazyFrames, whose cache is sized to a batch of pairs.
    With tau=1 every frame is evaluated (the last pairs with
    itself, as the reference does). With tau>1 (temporally strided
    testing, D&T paper §4) only frames 0, tau, 2tau, ... are, each paired
    with frame min(t+tau, T-1); ``interpolate_tubes`` fills the skipped
    frames from tubes. Pairs run in batches of the step's size; the tail
    batch is padded by repeating its last pair and trimmed. Returns numpy
    (C-1, T', M, 4) boxes, (C-1, T', M) scores, (C-1, T', M) valid and
    (C-1, T', M, 4) tracked boxes [+ the evaluated frame indices when
    tau > 1].
    """
    batch = pair_step.batch
    t_len = frames.shape[0]
    eval_ts = list(range(0, t_len, tau))
    if im_hw is None:
        im_hw = (frames.shape[1], frames.shape[2])
    im_hw = torch.tensor(im_hw, dtype=torch.float32, device=pair_step.device)
    pair_idx = [(t, min(t + tau, t_len - 1)) for t in eval_ts]
    if isinstance(frames, LazyFrames):   # each frame decodes once
        frames.ensure_cache(2 * batch)

    outs = []
    pending: list = []  # dispatch-ahead queue (see evaluate_snippet_video)

    def fetch(entry):
        out, real = entry
        return [x[:real].cpu().numpy() for x in out]

    for i in range(0, len(pair_idx), batch):
        chunk = pair_idx[i:i + batch]
        real = len(chunk)
        chunk += [chunk[-1]] * (batch - real)   # tail padding, trimmed
        g = _gather_chunk(cfg, frames, [t for ab in chunk for t in ab])
        pending.append((pair_step(g.reshape(batch, 2, *g.shape[1:]), im_hw,
                                  scale), real))
        if len(pending) > 2:      # keep 2 batches in flight
            outs.append(fetch(pending.pop(0)))
    outs.extend(fetch(e) for e in pending)
    out = tuple(np.concatenate([o[i] for o in outs], axis=0).swapaxes(0, 1)
                for i in range(4))
    return out if tau == 1 else (*out, eval_ts)


def interpolate_tubes(tubes: Tubes, boxes: np.ndarray, eval_ts: list[int],
                      t_total: int, tau: int | None = None):
    """Fill skipped frames of a tau-strided evaluation by linear
    interpolation along each tube (D&T paper §4). `tubes` holds numpy
    arrays (as ``link_snippet`` returns them). Returns flat detection
    arrays over ALL t_total frames: (ts (N,), cls (N,) 0-based,
    scores (N,), boxes (N, 4)).

    With `tau` given, a tube's last keyframe extends through at most
    tau-1 trailing frames, exactly the gap the stride skipped, so a
    short-lived false positive is not extended to the end of the snippet.
    """
    det_idx = np.asarray(tubes.det_idx)      # (C, K, T')
    tube_ok = np.asarray(tubes.tube_valid)   # (C, K)
    in_tube = np.asarray(tubes.det_in_tube)  # (C, T', N)
    rescored = np.asarray(tubes.rescored)    # (C, T', N)
    ts_out, cls_out, sc_out, bx_out = [], [], [], []
    n_t = det_idx.shape[2]
    eval_ts = np.asarray(eval_ts)
    for c, k in zip(*np.nonzero(tube_ok)):
        # the tube's valid keyframes (frame index, box, rescored score)
        j = det_idx[c, k]                                   # (T',)
        on = in_tube[c, np.arange(n_t), j]                  # (T',)
        kt = eval_ts[on]
        if kt.size == 0:
            continue
        kb = boxes[c, on, j[on]]                            # (Tk, 4)
        ks = rescored[c, on, j[on]].astype(np.float64)      # (Tk,)
        # piecewise-linear between consecutive keyframes, then the last
        # keyframe extends through the <= tau-1 frames the stride skipped
        t_end = t_total if tau is None else min(kt[-1] + tau, t_total)
        t = np.arange(kt[0], t_end)
        sc = np.interp(t, kt, ks)
        bx = np.stack([np.interp(t, kt, kb[:, d]) for d in range(4)], axis=1)
        ts_out.append(t)
        cls_out.append(np.full(t.size, c, np.int64))
        sc_out.append(sc)
        bx_out.append(bx)
    if not ts_out:
        z = np.zeros(0)
        return z.astype(np.int64), z.astype(np.int64), z, np.zeros((0, 4))
    return (np.concatenate(ts_out), np.concatenate(cls_out),
            np.concatenate(sc_out), np.concatenate(bx_out))


def link_snippet(cfg: Config, boxes, scores, tracked, valid, device=None):
    """Tube linking + rescoring for one snippet's stacked (C-1, T, M, ...)
    numpy detections on `device` (CUDA unless the caller passes "cpu").
    Returns the rescored scores and the Tubes, as numpy arrays."""
    device = resolve_device(device)
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    tubes = link_all_classes(
        put(boxes), put(scores), put(tracked), put(valid),
        max_tubes=cfg.eval.max_tubes_per_class,
        link_iou_weight=cfg.eval.link_iou_weight,
        score_boost=cfg.eval.tube_score_boost)
    tubes = Tubes(*(x.cpu().numpy() for x in tubes))
    return tubes.rescored, tubes
