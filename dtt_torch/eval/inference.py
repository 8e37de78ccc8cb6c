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
* Data parallel (``make_video_step_parallel``, ``make_pair_step_parallel``;
  one process per device, ``dtt_torch.parallel``): a rank runs its rows of
  the chunk or the pair batch and the ranks' padded outputs are gathered
  in rank order, so the drivers see the serial step's arrays. The video
  step's ranks pass their first frame's features to the rank before them,
  the halo of the frame pair across a shard boundary. Each is one program
  with its halo and gather inside (``split_video_step`` does not apply,
  as ``dtt``'s parallel steps ignore it).

The video and pair steps take the fused path under the psroi pooling mode
(one pool of the fused ps-maps) and the unfused one under the others
(``frame_features``, ``track_psmaps``, the batched detection and track
pools), as ``dtt`` chooses by ``roi.pooling_mode``.

The serial steps are programs (``dtt_torch.utils.programs``), as ``dtt``
jits them: on CUDA each is captured once as a CUDA graph and replayed, the
video and pair steps as two programs (trunk, then the post-trunk stage on
the trunk's feature buffers) under ``EvalConfig.split_video_step`` and as
one without it; each data-parallel step as one program, under NCCL with
its collectives captured in the graph. A step's outputs are
copies that its next call leaves alone, so both drivers keep two batches
in flight: CUDA work is queued asynchronously. On CUDA a batch travels
through a ring of three pinned staging slots (``_Staging``): it is
gathered straight into a slot, and its outputs come back into the slot
behind the step on the stream, so reading a finished batch waits on that
batch's event alone and never drains the stream. Their frames are an
array or a ``LazyFrames``, which decodes each frame of a snippet on first
touch and keeps a bounded cache.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from dtt_torch.core.anchors import grid_anchors_for
from dtt_torch.core.config import Config
from dtt_torch.core.device import resolve_device
from dtt_torch.eval.linking import (Tubes, link_all_classes, to_device,
                                    tubes_numpy)
from dtt_torch.models.dnt import (DnT, FrameFeats,
                                  decode_detections_batched,
                                  decode_frame_detections, detect_frame,
                                  detect_frames_batched, detect_track_fused,
                                  normalize_device_images, track_rois_batched)
from dtt_torch.parallel.mesh import (DataMesh, all_gather_cat, exchange_halo,
                                     mesh_program)
from dtt_torch.utils.profiling import count, span
from dtt_torch.utils.programs import StepProgram


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


def _transfer_dtype(cfg: Config, dtype) -> torch.dtype:
    """The dtype host frames of numpy `dtype` are uploaded in: uint8
    canvases as they are (normalized on the device), float frames in the
    model's compute dtype (the backbone's first op is the same cast)."""
    return torch.uint8 if dtype == np.uint8 else getattr(torch,
                                                          cfg.model.dtype)


def _gather_chunk(cfg: Config, frames, idxs) -> torch.Tensor:
    """Stack the requested frame indices into one fresh transfer-ready
    chunk."""
    x = np.stack([np.asarray(frames[i]) for i in idxs])
    return torch.from_numpy(x).to(_transfer_dtype(cfg, x.dtype))


# Chunks a snippet driver keeps queued on the device while it gathers the
# next one; a ring of staging slots holds one more.
_IN_FLIGHT = 2
_RINGS = threading.local()


class _Slot:
    """One chunk's staging between host and card: a pinned host block of
    the chunk's transfer shape and dtype, pinned host tensors for the
    step's outputs (shaped like them at the slot's first chunk) and the
    event recorded on the stream after the outputs' copies into them."""

    def __init__(self, shape: tuple, dtype: torch.dtype):
        self.host = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.outs: list = []
        self.event = torch.cuda.Event()


def _ring(device: torch.device, shape: tuple, dtype: torch.dtype) -> list:
    """This thread's slots for chunks of `shape` and `dtype` on `device`,
    pinned at their first use and kept: pinning them anew for each
    snippet would cost more than staging saves."""
    rings = _RINGS.__dict__.setdefault("rings", {})
    key = (device, shape, dtype)
    if key not in rings:
        rings[key] = [_Slot(shape, dtype) for _ in range(_IN_FLIGHT + 1)]
    return rings[key]


class _Staging:
    """The snippet drivers' trip of a chunk between host and device.

    On CUDA the k-th chunk of a snippet goes through slot k mod 3 of the
    ring for its transfer shape and dtype: its frames are copied straight
    into the slot's pinned block (float frames cast on the way), the step
    uploads from there, the rows the chunk produced are copied into the
    slot's pinned outputs behind the step on the stream, and the slot's
    event is recorded after them. Fetching a chunk waits on that event
    alone, so the chunks queued after it keep the card busy, and copies
    the rows out, which frees the slot. On the CPU a chunk is a fresh
    array and its outputs are read as they are.
    """

    def __init__(self, cfg: Config, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.pinned = self.device.type == "cuda"
        self.pending: list = []      # (outputs, real rows, event or None)
        self._chunks = 0
        self._slot = None

    @property
    def full(self) -> bool:
        """More chunks queued than the drivers keep in flight."""
        return len(self.pending) > _IN_FLIGHT

    def gather(self, frames, idxs) -> torch.Tensor:
        """Frames `idxs` of `frames` as the chunk to hand to the step."""
        if not self.pinned:
            return _gather_chunk(self.cfg, frames, idxs)
        first = np.asarray(frames[idxs[0]])
        ring = _ring(self.device, (len(idxs), *first.shape),
                     _transfer_dtype(self.cfg, first.dtype))
        slot = self._slot = ring[self._chunks % len(ring)]
        self._chunks += 1
        slot.event.synchronize()   # its last chunk's copies are done
        for j, i in enumerate(idxs):
            x = first if j == 0 else np.asarray(frames[i])
            slot.host[j].copy_(torch.from_numpy(x))
        return slot.host

    def put(self, out, real: int) -> None:
        """Queue the step's outputs `out` for the last gathered chunk, of
        which the first `real` rows are kept."""
        if not self.pinned:
            self.pending.append((out, real, None))
            return
        slot = self._slot
        if [(o.shape, o.dtype) for o in slot.outs] != [
                (x.shape, x.dtype) for x in out]:
            slot.outs = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                         for x in out]
        for o, x in zip(slot.outs, out):
            o[:real].copy_(x[:real], non_blocking=True)
        slot.event.record(torch.cuda.current_stream(self.device))
        self.pending.append((slot.outs, real, slot.event))

    def fetch(self) -> list:
        """The oldest queued chunk's kept rows, as numpy arrays of their
        own."""
        out, real, event = self.pending.pop(0)
        if event is None:
            return [x[:real].cpu().numpy() for x in out]
        event.synchronize()
        return [x[:real].numpy().copy() for x in out]


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
        ecfg.max_per_class, track_deltas=deltas,
        select_block=ecfg.nms_select_block))


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
        ecfg.max_per_class, track_deltas=deltas,
        select_block=ecfg.nms_select_block))


def _trunk_and_post(cfg: Config, model: DnT):
    """The trunk and the post-trunk stage of the video and pair steps for
    the pooling mode: fused under psroi, else unfused."""
    if cfg.model.roi.pooling_mode == "psroi":
        return model.frame_trunk, _detect_and_track_fused
    return model.frame_features, _detect_and_track


def _paired_step(cfg: Config, name: str, trunk_body, post_body, device,
                 check, **attrs):
    """A video or pair step ``(x, im_hw, scale=1.0) -> PairOutputs`` as
    programs (``dtt_torch.utils.programs``): with
    ``EvalConfig.split_video_step`` (the default) two, the trunk and the
    post-trunk stage, which reads the trunk's feature buffers in place
    (``dtt``'s two jitted programs); otherwise one. `check(x)` validates
    the input; `attrs` (and ``device``) are set on the step and on
    ``step.eager``, the same step uncaptured; ``step.programs`` holds the
    programs."""
    if cfg.eval.split_video_step:
        trunk = StepProgram(trunk_body, f"{name} trunk", device,
                            copy_out=False)
        post = StepProgram(post_body, f"{name} post-trunk", device,
                           borrow=(0,))
        programs = (trunk, post)
        run = lambda x, im_hw, scale: post(trunk(x, im_hw), im_hw, scale)
        eager = lambda x, im_hw, scale: post.eager(trunk.eager(x, im_hw),
                                                   im_hw, scale)
    else:
        run = StepProgram(lambda x, im_hw, scale: post_body(
            trunk_body(x, im_hw), im_hw, scale), name, device)
        programs, eager = (run,), run.eager

    def wrap(form):
        def step(x: torch.Tensor, im_hw: torch.Tensor,
                 scale: float = 1.0) -> PairOutputs:
            check(x)
            return form(x, im_hw, scale)
        step.__dict__.update(attrs, device=device)
        return step

    step = wrap(run)
    step.eager, step.programs = wrap(eager), programs
    return step


def make_video_step(cfg: Config, model: DnT, frames_per_chunk: int = 33,
                    device=None):
    """(frames (F, H, W, 3), im_hw (2,) float32 tensor, scale) ->
    PairOutputs of F-1 pairs, as device tensors.

    Runs on `device` (CUDA unless the caller passes "cpu"), which must hold
    `model`, as programs (``dtt_torch.utils.programs``): on CUDA captured
    once as CUDA graphs and replayed, two (the trunk, then the post-trunk
    stage on its features) under ``EvalConfig.split_video_step``, one
    without it, as ``dtt`` jits its step; `frames`, `im_hw` and `scale`
    are inputs of the program, not constants. ``step.eager`` is the same
    step uncaptured; ``step.programs`` holds the programs.
    """
    if frames_per_chunk < 2:
        raise ValueError("a chunk needs at least one frame pair")
    device, anchors = _step_setup(cfg, model, device)
    trunk, post = _trunk_and_post(cfg, model)

    @torch.inference_mode()
    def trunk_body(frames, im_hw):
        return trunk(normalize_device_images(frames, im_hw,
                                             cfg.input.pixel_means))

    @torch.inference_mode()
    def post_body(feats, im_hw, scale):
        return post(cfg, model, anchors, feats.slice(slice(None, -1)),
                    feats.slice(slice(1, None)), im_hw, scale)

    def check(frames):
        if frames.shape[0] != frames_per_chunk:
            raise ValueError(f"expected chunks of {frames_per_chunk} "
                             f"frames, got {tuple(frames.shape)}")

    return _paired_step(cfg, "video step", trunk_body, post_body, device,
                        check, frames_per_chunk=frames_per_chunk)


def make_pair_step(cfg: Config, model: DnT, batch: int = 4, device=None):
    """(pairs (B, 2, H, W, 3), im_hw (2,) float32 tensor, scale) ->
    PairOutputs of the B pairs (detections of each pair's first frame,
    tracked into its second), as device tensors.

    One trunk pass over the 2B frames, then frames 0::2 and 1::2 as the
    pair halves (``dtt``'s ``_pair_forward``). Runs on `device` (CUDA
    unless the caller passes "cpu"), which must hold `model`, as programs
    split by ``EvalConfig.split_video_step`` as in `make_video_step`
    (``step.eager``, ``step.programs``).
    """
    if batch < 1:
        raise ValueError("a pair batch needs at least one pair")
    device, anchors = _step_setup(cfg, model, device)
    trunk, post = _pair_forward(cfg, model, anchors)

    def check(pairs):
        if pairs.shape[:2] != (batch, 2):
            raise ValueError(f"expected batches of {batch} pairs "
                             f"(B, 2, H, W, 3), got {tuple(pairs.shape)}")

    return _paired_step(cfg, "pair step", trunk, post, device, check,
                        batch=batch)


def _pair_forward(cfg: Config, model: DnT, anchors):
    """The pair step's body as its trunk stage (one pass over the 2B
    frames of the uploaded pairs) and its post-trunk stage (frames 0::2
    and 1::2 as the pair halves, ``dtt``'s ``_pair_forward``)."""
    trunk, post = _trunk_and_post(cfg, model)

    @torch.inference_mode()
    def trunk_body(pairs, im_hw):
        pairs = normalize_device_images(pairs, im_hw, cfg.input.pixel_means)
        return trunk(pairs.reshape(-1, *pairs.shape[2:]))

    @torch.inference_mode()
    def post_body(feats, im_hw, scale):
        return post(cfg, model, anchors, feats.slice(slice(0, None, 2)),
                    feats.slice(slice(1, None, 2)), im_hw, scale)

    return trunk_body, post_body


def _mesh_setup(cfg: Config, model: DnT, mesh: DataMesh) -> tuple:
    """`_step_setup` on the rank's device, which must hold `model`."""
    device, anchors = _step_setup(cfg, model, mesh.device)
    model_device = next(model.parameters()).device
    if model_device != mesh.device:
        raise ValueError(f"model is on {model_device}, mesh holds "
                         f"{mesh.device}")
    return device, anchors


def _local_rows(x: torch.Tensor, mesh: DataMesh, local: int, what: str
                ) -> torch.Tensor:
    """This rank's rows of the global `x` (world * local rows), or `x`
    itself when it holds just the rank's `local` rows."""
    n = mesh.size * local
    if x.shape[0] == n:
        return x[mesh.rows(n)]
    if x.shape[0] == local:
        return x
    raise ValueError(f"expected {n} {what} (or this rank's {local}), got "
                     f"{tuple(x.shape)}")


def _gather_outputs(out: PairOutputs, mesh: DataMesh) -> PairOutputs:
    """Every rank's padded outputs in rank order, on every rank (`valid`
    travels as uint8: not every backend carries bool)."""
    if not mesh.distributed:
        return out
    boxes, scores, valid, tracked = (all_gather_cat(x, mesh) for x in (
        out.boxes, out.scores, out.valid.to(torch.uint8), out.tracked))
    return PairOutputs(boxes, scores, valid.bool(), tracked)


def _parallel_step(name: str, body, mesh: DataMesh, local, **attrs):
    """A parallel video or pair step ``(x, im_hw, scale=1.0) ->
    PairOutputs`` as one program over `mesh` (``dtt``'s one jitted
    ``shard_map``; its collectives inside): ``local(x)`` takes the rank's
    rows of `x` before the program, whose buffers take them. The form is
    the backend's (``mesh_program``); ``step.eager`` is the step
    uncaptured, ``step.programs`` holds the program, and `attrs` (and
    ``device``) are set on both."""
    program = StepProgram(body, name, mesh.device)

    def wrap(form):
        def step(x: torch.Tensor, im_hw: torch.Tensor,
                 scale: float = 1.0) -> PairOutputs:
            return form(local(x), im_hw, scale)
        step.__dict__.update(attrs, device=mesh.device)
        return step

    step = wrap(mesh_program(program, mesh))
    step.eager, step.programs = wrap(program.eager), (program,)
    return step


def make_pair_step_parallel(cfg: Config, model: DnT, mesh: DataMesh,
                            pairs_per_device: int = 2):
    """Data-parallel tau-strided pair step over the ranks of `mesh`: pairs
    are independent, so the batch shards with no halo. The same call and
    outputs as `make_pair_step` with ``batch = mesh.size *
    pairs_per_device`` (``step.batch``, which ``evaluate_snippet`` reads):
    each rank runs its `pairs_per_device` rows (``step.rows``; a rank may
    be given only those) on ``mesh.device`` and every rank returns the
    whole batch's outputs, gathered in rank order. One program
    (``_parallel_step``; ``step.eager``, ``step.programs``), the gather
    inside it."""
    if pairs_per_device < 1:
        raise ValueError("a pair batch needs at least one pair a rank")
    _, anchors = _mesh_setup(cfg, model, mesh)
    trunk, post = _pair_forward(cfg, model, anchors)
    batch = mesh.size * pairs_per_device

    @torch.inference_mode()
    def body(pairs, im_hw, scale):
        return _gather_outputs(post(trunk(pairs, im_hw), im_hw, scale), mesh)

    def local(pairs):
        if pairs.shape[1] != 2:
            raise ValueError(f"expected pairs (B, 2, H, W, 3), got "
                             f"{tuple(pairs.shape)}")
        return _local_rows(pairs, mesh, pairs_per_device, "pairs")

    return _parallel_step("parallel pair step", body, mesh, local,
                          batch=batch, rows=mesh.rows(batch))


def make_video_step_parallel(cfg: Config, model: DnT, mesh: DataMesh,
                             frames_per_device: int = 4):
    """Data-parallel video step over the ranks of `mesh`: a chunk of
    ``mesh.size * frames_per_device`` frames (``step.frames_per_chunk``)
    shards by rank (``step.rows``; a rank may be given only its frames).
    Each rank runs the trunk on its frames and sends the features of its
    first frame that frame t+1's side of the heads reads (the reduced c5
    and the correlation inputs) to the rank before it, so its last frame
    pairs with the next rank's first.

    Returns that many pairs, gathered in rank order on every rank. The
    last pair wraps around (rank n-1's last frame with rank 0's first) and
    ``evaluate_snippet_video``'s `real` accounting always trims it, so
    callers see the serial step's contract (F-1 usable pairs, chunks that
    overlap by one frame). One program (``_parallel_step``;
    ``step.eager``, ``step.programs``), the halo and the gather inside
    it."""
    if frames_per_device < 1:
        raise ValueError("a rank needs at least one frame")
    _, anchors = _mesh_setup(cfg, model, mesh)
    trunk, post = _trunk_and_post(cfg, model)
    frames_per_chunk = mesh.size * frames_per_device

    @torch.inference_mode()
    def body(frames, im_hw, scale):
        images = normalize_device_images(frames, im_hw, cfg.input.pixel_means)
        feats = trunk(images)
        keys = sorted(feats.corr_feats)
        halo = exchange_halo([feats.reduced[:1]]
                             + [feats.corr_feats[k][:1] for k in keys], mesh)
        ext = lambda x, h: torch.cat([x[1:], h])
        # frame t+1's side of the heads reads only these fields
        f_tau = FrameFeats(
            rpn_cls=None, rpn_bbox=None,
            reduced=ext(feats.reduced, halo[0]),
            corr_feats={k: ext(feats.corr_feats[k], h)
                        for k, h in zip(keys, halo[1:])})
        out = post(cfg, model, anchors, feats, f_tau, im_hw, scale)
        return _gather_outputs(out, mesh)

    return _parallel_step(
        "parallel video step", body, mesh,
        lambda x: _local_rows(x, mesh, frames_per_device, "frames"),
        frames_per_chunk=frames_per_chunk, rows=mesh.rows(frames_per_chunk))


def make_single_frame_step(cfg: Config, model: DnT, device=None):
    """(image (1, H, W, 3), im_hw=None, scale) -> per-class detections
    (boxes (C-1, M, 4), scores (C-1, M), valid (C-1, M)) as device tensors:
    ``frame_features`` -> ``detect_frame`` -> ``decode_frame_detections``
    with the eval thresholds (single-frame R-FCN detection, no tracking).

    A uint8 image is normalized on the device; `im_hw` is its true (h, w)
    extent (default: the canvas). Runs on `device` (CUDA unless the caller
    passes "cpu"), which must hold `model`, as one program
    (``dtt_torch.utils.programs``; ``dtt`` jits the step): on CUDA captured
    once as a CUDA graph and replayed, with the image, `im_hw` and `scale`
    its inputs. ``step.eager`` is the same step uncaptured;
    ``step.programs`` holds the program.
    """
    device, anchors = _step_setup(cfg, model, device)
    mcfg, ecfg = cfg.model, cfg.eval
    canvas = (cfg.input.canvas_height, cfg.input.canvas_width)

    @torch.inference_mode()
    def body(image, hw, scale):
        image = normalize_device_images(image, hw, cfg.input.pixel_means)
        feats = model.frame_features(image)
        _, det = detect_frame(mcfg, feats, anchors, hw[0], hw[1], scale)
        return decode_frame_detections(mcfg, det, hw[0], hw[1],
                                       ecfg.score_thresh, ecfg.nms_thresh,
                                       ecfg.max_per_class)

    program = StepProgram(body, "single-frame step", device)

    def checked(form):
        def step(image: torch.Tensor, im_hw=None, scale: float = 1.0):
            if image.dim() != 4 or image.shape[0] != 1:
                raise ValueError(f"expected one image (1, H, W, 3), got "
                                 f"{tuple(image.shape)}")
            hw = canvas if im_hw is None else im_hw
            if not isinstance(hw, torch.Tensor):
                hw = torch.tensor(hw, dtype=torch.float32)
            return form(image, hw, scale)
        return step

    step, step_eager = checked(program), checked(program.eager)
    step_eager.device = step.device = device
    step.eager, step.programs = step_eager, (program,)
    return step


def evaluate_snippet_video(cfg: Config, video_step, frames,
                           frames_per_chunk: int | None = None,
                           im_hw=None, scale: float = 1.0):
    """Snippet eval with per-frame feature sharing (τ=1).

    `frames` is a (T, H, W, 3) array (uint8 canvases or normalized floats)
    or a LazyFrames, whose cache is sized to a chunk and its overlap;
    `im_hw` the true (h, w) extent on the canvas (default: the canvas).
    Returns numpy (C-1, T, M, 4) boxes, (C-1, T, M) scores, (C-1, T, M)
    valid and (C-1, T, M, 4) tracked boxes. Recorded
    (``dtt_torch.utils.profiling``) as the span ``video.snippet``, a
    request, with a span ``video.gather`` around each chunk's gather on the
    host, a span ``video.fetch`` around each read of a chunk's outputs (on
    CUDA the wait on its slot's event and the copy out), the counter
    ``video.chunks`` and, on CUDA, ``video.staged``: the chunks that went
    through a staging slot.
    """
    f = frames_per_chunk or video_step.frames_per_chunk
    if f < 2:
        raise ValueError("a chunk needs at least one frame pair")
    with span("video.snippet", request=True):
        t_len = frames.shape[0]
        if im_hw is None:
            im_hw = (frames.shape[1], frames.shape[2])
        im_hw = torch.tensor(im_hw, dtype=torch.float32,
                             device=video_step.device)
        if isinstance(frames, LazyFrames):   # each frame decodes once
            frames.ensure_cache(f + 1)
        # a parallel step's rank reads (and decodes) only its own frames
        rows = getattr(video_step, "rows", slice(None))

        # dispatch-ahead queue: host work overlaps the device
        stage = _Staging(cfg, video_step.device)
        outs = []
        start = 0
        while start < t_len:
            count("video.chunks")
            # index min(i, T-1): duplicates the last frame both for the
            # final identity pair and as tail padding (trimmed via `real`)
            idxs = [min(i, t_len - 1) for i in range(start, start + f)]
            with span("video.gather"):
                chunk = stage.gather(frames, idxs[rows])
            if stage.pinned:
                count("video.staged")
            real = min(f - 1, t_len - start)  # pairs produced by this chunk
            stage.put(video_step(chunk, im_hw, scale), real)
            if stage.full:
                with span("video.fetch"):
                    outs.append(stage.fetch())
            start += f - 1        # overlap: last frame re-used as next f_t
        while stage.pending:
            with span("video.fetch"):
                outs.append(stage.fetch())
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
    rows = getattr(pair_step, "rows", slice(None))   # see the video driver

    stage = _Staging(cfg, pair_step.device)   # see evaluate_snippet_video
    outs = []
    for i in range(0, len(pair_idx), batch):
        chunk = pair_idx[i:i + batch]
        real = len(chunk)
        chunk += [chunk[-1]] * (batch - real)   # tail padding, trimmed
        mine = chunk[rows]
        g = stage.gather(frames, [t for ab in mine for t in ab])
        stage.put(pair_step(g.reshape(len(mine), 2, *g.shape[1:]), im_hw,
                            scale), real)
        if stage.full:
            outs.append(stage.fetch())
    while stage.pending:
        outs.append(stage.fetch())
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
    numpy detections on `device` (CUDA unless the caller passes "cpu"), by
    one copy of the four inputs to the device and one copy of the five
    outputs back. Returns the rescored scores and the Tubes, as numpy
    arrays. Recorded as the span ``link`` (the request last started on
    the thread: the snippet's detection) with ``link.upload``,
    ``link.kernel`` and ``link.readback``."""
    device = resolve_device(device)
    with span("link"):
        with span("link.upload"):
            inputs = to_device((boxes, scores, tracked, valid), device)
        with span("link.kernel"):
            tubes = link_all_classes(
                *inputs, max_tubes=cfg.eval.max_tubes_per_class,
                link_iou_weight=cfg.eval.link_iou_weight,
                score_boost=cfg.eval.tube_score_boost)
        with span("link.readback"):
            tubes = tubes_numpy(tubes)
    return tubes.rescored, tubes
