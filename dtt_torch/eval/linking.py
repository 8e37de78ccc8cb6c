"""Viterbi tube linking + rescoring over padded per-frame detections
(counterpart of ``dtt.eval.linking``).

Per class, the detections of a snippet are linked across time by a dynamic
program over the link score

  s(d_t, d_{t+1}) = p(d_t) + p(d_{t+1}) + w * IoU(track(d_t), d_{t+1})

where track(d_t) is d_t's box displaced by the tracking regression. The
best path becomes a tube; its detections are rescored (boosted to a tube
statistic, by default the mean of the top half of its scores, D&T paper
§3.4), removed, and the search repeats up to `max_tubes` times. Frames
with no detection left expose slot 0 as a virtual skip (score 0), so a
tube can bridge them; virtual slots are never claimed.

``dtt`` vmaps one class's program over the classes and scans over tubes,
frames and the backtrack, one compiled device program. Here:

* `link_all_classes_plain` — the plain form: the class axis is a batch
  dimension and the scans are loops of small tensor ops on the device the
  inputs lie on, with no transfer to the host; the link scores' IoU term
  does not depend on which detections are left, so it is computed once for
  all frames and tubes.
* `link_cuda` — the hand-written kernel ``dtt_link_tubes``
  (``dtt_torch/ops/csrc/linking.cu``): every class of a snippet in one
  launch, a thread block a class; `link_layout` says where its working
  arrays sit. Decisions and tube scores equal the plain form's bit for
  bit; the rescored scores to float32 roundoff (the boost's sum is taken
  in another order).
* `link_all_classes` — the dispatcher: the plain form on CPU tensors, the
  kernel on CUDA tensors, or it raises; `link_tubes` is its one-class
  case.

Everything is float32 (``_NEG`` terms swamp small ones there, as in
``dtt``) and every argmax takes the first maximum, as ``jnp.argmax``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from dtt_torch.core import boxes as box_ops
from dtt_torch.ops import _build

_NEG = -1e9
_BOOSTS = ("mean_top_half", "mean", "max")
# what the kernel's static part takes of a block's shared memory
# (``kStaticSmem`` in ``csrc/linking.cu``)
_STATIC_SMEM = 1_024


class Tubes(NamedTuple):
    det_idx: torch.Tensor      # (C, max_tubes, T) detection index per frame
    tube_valid: torch.Tensor   # (C, max_tubes) tube is real
    tube_score: torch.Tensor   # (C, max_tubes) mean link-path score
    rescored: torch.Tensor     # (C, T, N) rescored detection scores
    det_in_tube: torch.Tensor  # (C, T, N) bool: detection was claimed


def _first_argmax(x: torch.Tensor, values: torch.Tensor, dim: int
                  ) -> torch.Tensor:
    """Index of the first element of `x` equal to its maximum `values`
    along `dim` (``values`` keeps `dim` as size 1), as ``jnp.argmax``: a
    NaN ranks above every number (``amax`` gives NaN where `x` has one)."""
    idx = torch.arange(x.shape[dim], device=x.device).reshape(
        [-1 if i == dim % x.dim() else 1 for i in range(x.dim())])
    hit = (x == values) | x.isnan()
    return torch.where(hit, idx, x.shape[dim]).amin(dim=dim)


def _viterbi_once(scores, iou_w, valid, virtual):
    """Best single tube per class: path (C, T) and mean link score (C,).

    `iou_w` is ``w * IoU(tracked[t], boxes[t+1])``, (C, T-1, N, N)."""
    c, t, n = scores.shape
    neg = torch.tensor(_NEG, dtype=scores.dtype, device=scores.device)
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    p = torch.where(valid, scores, torch.where(virtual, zero, neg))
    eff_valid = valid | virtual
    link = torch.where(eff_valid[:, 1:, None, :],
                       (p[:, :-1, :, None] + p[:, 1:, None, :]) + iou_w, neg)
    v = torch.where(eff_valid[:, 0], zero, neg)               # (C, N)
    backs = []
    for i in range(t - 1):
        cand = v[:, :, None] + link[:, i]                     # (C, N, N)
        v = cand.amax(dim=1)
        backs.append(_first_argmax(cand, v[:, None, :], 1))
    end = _first_argmax(v, v.amax(dim=1, keepdim=True), 1)    # (C,)
    path_score = v.gather(1, end[:, None])[:, 0]
    path = [end]
    for back in reversed(backs):
        path.append(back.gather(1, path[-1][:, None])[:, 0])
    path = torch.stack(path[::-1], dim=1)                      # (C, T)
    # divide by a tensor on the device: CUDA divides by a Python number as
    # a multiply by its reciprocal, an ulp off dtt's and the kernel's
    steps = torch.full((), float(max(t - 1, 1)), dtype=scores.dtype,
                       device=scores.device)
    return path, path_score / steps


def link_all_classes_plain(boxes: torch.Tensor,    # (C, T, N, 4)
                           scores: torch.Tensor,   # (C, T, N)
                           tracked: torch.Tensor,  # (C, T, N, 4) t -> t+1
                           valid: torch.Tensor,    # (C, T, N)
                           max_tubes: int = 20, link_iou_weight: float = 1.0,
                           score_boost: str = "mean_top_half") -> Tubes:
    """Greedy repeated-Viterbi tube extraction for every class at once, on
    the inputs' device, by loops of tensor ops (the plain form of
    `link_all_classes`).

    `score_boost` selects the tube statistic detections are boosted to
    (``cfg.eval.tube_score_boost``): "mean_top_half" (D&T paper §3.4),
    "mean", or "max" over the tube's claimed detection scores.
    """
    if score_boost not in _BOOSTS:
        raise ValueError(f"unknown tube_score_boost {score_boost!r}")
    c, t, n = scores.shape
    dev = scores.device
    valid = valid.bool()
    iou_w = link_iou_weight * box_ops.pairwise_iou(tracked[:, :-1],
                                                   boxes[:, 1:])
    first_slot = torch.arange(n, device=dev) == 0
    frames = torch.arange(t, device=dev)
    ninf = torch.tensor(float("-inf"), dtype=scores.dtype, device=dev)
    zero = torch.zeros((), dtype=scores.dtype, device=dev)
    cur_valid, rescored = valid, scores
    in_tube = torch.zeros_like(valid)
    paths, oks, mscores = [], [], []
    for _ in range(max_tubes):
        any_left = cur_valid.flatten(1).any(dim=1)                   # (C,)
        frame_empty = ~cur_valid.any(dim=2)                          # (C, T)
        virtual = frame_empty[:, :, None] & first_slot
        path, mean_score = _viterbi_once(scores, iou_w, cur_valid, virtual)
        tube_ok = any_left & (mean_score > _NEG / 2)
        onehot = (path[:, :, None] == torch.arange(n, device=dev)) & cur_valid
        flat = torch.where(onehot, scores, ninf).amax(dim=2).sort(
            dim=1, descending=True).values                           # (C, T)
        count = onehot.any(dim=2).sum(dim=1)
        finite = torch.where(torch.isfinite(flat), flat, zero)
        if score_boost == "mean_top_half":
            k_stat = ((count + 1) // 2).clamp(min=1)
        elif score_boost == "mean":
            k_stat = count.clamp(min=1)
        else:
            k_stat = torch.ones_like(count)
        top = frames < k_stat[:, None]
        boost = torch.where(top, finite, zero).sum(dim=1) / k_stat
        claim = onehot & tube_ok[:, None, None]
        rescored = torch.where(claim, torch.maximum(rescored,
                                                    boost[:, None, None]),
                               rescored)
        cur_valid = cur_valid & ~claim
        in_tube = in_tube | claim
        paths.append(path)
        oks.append(tube_ok)
        mscores.append(mean_score)
    return Tubes(det_idx=torch.stack(paths, dim=1),
                 tube_valid=torch.stack(oks, dim=1),
                 tube_score=torch.stack(mscores, dim=1),
                 rescored=rescored, det_in_tube=in_tube)


class LinkLayout(NamedTuple):
    body: str        # "shared" or "scratch": where the backpointers sit
    smem: int        # dynamic shared memory a block, bytes
    scratch: int     # scratch a class, bytes (0 for "shared")
    n_shared: int    # how many of v, the claimed scores and the
                     # backpointers sit in shared memory, in that order


def link_layout(t: int, n: int) -> LinkLayout:
    """Where ``dtt_link_tubes`` keeps the working arrays of a class of `t`
    frames and `n` slots: v (two buffers, 8 bytes a slot), the claimed
    scores (4 bytes a frame) and the backpointers (4 bytes a slot of each
    frame but the last), each padded to 16 bytes. They take shared memory
    in that order while they fit a block's 227 KB beside the kernel's
    static 1 KB (the backpointers at n = 20 up to t = 2,754); the rest sits
    in a scratch buffer of the wrapper's, one slice a class."""
    pad = lambda b: -(-b // 16) * 16            # noqa: E731
    sizes = (pad(8 * n), pad(4 * t), pad(4 * (t - 1) * n))
    smem, k = 0, 0
    while k < 3 and smem + sizes[k] + _STATIC_SMEM <= _build.SMEM_LIMIT:
        smem += sizes[k]
        k += 1
    return LinkLayout("shared" if k == 3 else "scratch", smem,
                      sum(sizes[k:]), k)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("linking").dtt_link_tubes
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def link_cuda(boxes: torch.Tensor, scores: torch.Tensor,
              tracked: torch.Tensor, valid: torch.Tensor,
              max_tubes: int = 20, link_iou_weight: float = 1.0,
              score_boost: str = "mean_top_half") -> Tubes:
    """`link_all_classes` by the CUDA kernel ``dtt_link_tubes``, one launch
    for every class.

    boxes and tracked (C, T, N, 4) float32, scores (C, T, N) float32, valid
    (C, T, N) bool, on one CUDA device, T and N >= 1; max_tubes >= 1 and
    link_iou_weight a number (taken as float32). Launches on the current
    stream and never reads back to the host; counts its launches in
    ``link_cuda.launches``. Where `link_layout` puts an array in scratch it
    allocates the scratch buffer.
    """
    if score_boost not in _BOOSTS:
        raise ValueError(f"unknown tube_score_boost {score_boost!r}")
    if (boxes.dim() != 4 or boxes.shape[-1] != 4
            or tracked.shape != boxes.shape):
        raise ValueError("link_cuda: boxes and tracked must both be (C, T, "
                         f"N, 4), got {tuple(boxes.shape)} and "
                         f"{tuple(tracked.shape)}")
    if scores.shape != boxes.shape[:-1] or valid.shape != scores.shape:
        raise ValueError(f"link_cuda: scores and valid must be (C, T, N) = "
                         f"{tuple(boxes.shape[:-1])}, got "
                         f"{tuple(scores.shape)} and {tuple(valid.shape)}")
    if any(x.dtype != torch.float32 for x in (boxes, scores, tracked)) or \
            valid.dtype != torch.bool:
        raise TypeError("link_cuda: boxes, scores and tracked must be "
                        "float32 and valid bool, got "
                        f"{boxes.dtype}, {scores.dtype}, {tracked.dtype}, "
                        f"{valid.dtype}")
    if isinstance(link_iou_weight, torch.Tensor):
        raise TypeError("link_cuda: link_iou_weight must be a number (a "
                        "tensor would be read back to the host)")
    c, t, n = scores.shape
    if t < 1 or n < 1 or max_tubes < 1:
        raise ValueError(f"link_cuda: T {t}, N {n} and max_tubes "
                         f"{max_tubes} must be >= 1")
    if c >= 2 ** 31:
        raise ValueError(f"link_cuda: {c} classes exceed the grid")
    dev = boxes.device
    if not boxes.is_cuda or any(x.device != dev
                                for x in (scores, tracked, valid)):
        raise ValueError("link_cuda: boxes, scores, tracked and valid must "
                         "be on one CUDA device")
    det_idx = torch.empty((c, max_tubes, t), dtype=torch.int64, device=dev)
    tube_valid = torch.empty((c, max_tubes), dtype=torch.bool, device=dev)
    tube_score = torch.empty((c, max_tubes), dtype=torch.float32, device=dev)
    rescored = torch.empty((c, t, n), dtype=torch.float32, device=dev)
    in_tube = torch.empty((c, t, n), dtype=torch.bool, device=dev)
    tubes = Tubes(det_idx, tube_valid, tube_score, rescored, in_tube)
    if c == 0:
        return tubes
    fn = _entry()
    layout = link_layout(t, n)
    scratch = (torch.empty(c * layout.scratch, dtype=torch.uint8, device=dev)
               if layout.scratch else None)
    bx, sc, tr, va = (x.contiguous() for x in (boxes, scores, tracked, valid))
    err = fn(bx.data_ptr(), tr.data_ptr(), sc.data_ptr(), va.data_ptr(),
             det_idx.data_ptr(), tube_valid.data_ptr(), tube_score.data_ptr(),
             rescored.data_ptr(), in_tube.data_ptr(), c, t, n, max_tubes,
             float(link_iou_weight), _BOOSTS.index(score_boost), layout.smem,
             layout.n_shared, layout.scratch,
             None if scratch is None else scratch.data_ptr(), dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"linking kernel launch failed: cudaError {err}")
    link_cuda.launches += 1
    return tubes


link_cuda.launches = 0


def link_all_classes(boxes: torch.Tensor,    # (C, T, N, 4)
                     scores: torch.Tensor,   # (C, T, N)
                     tracked: torch.Tensor,  # (C, T, N, 4) box t -> t+1
                     valid: torch.Tensor,    # (C, T, N)
                     max_tubes: int = 20, link_iou_weight: float = 1.0,
                     score_boost: str = "mean_top_half") -> Tubes:
    """Greedy repeated-Viterbi tube extraction for every class at once, on
    the inputs' device: the plain form on CPU tensors, otherwise one launch
    of the kernel (float32 boxes and scores, bool valid).

    `score_boost` selects the tube statistic detections are boosted to
    (``cfg.eval.tube_score_boost``): "mean_top_half" (D&T paper §3.4),
    "mean", or "max" over the tube's claimed detection scores.
    """
    if boxes.device.type == "cpu":
        return link_all_classes_plain(boxes, scores, tracked, valid,
                                      max_tubes, link_iou_weight, score_boost)
    return link_cuda(boxes, scores, tracked, valid, max_tubes,
                     link_iou_weight, score_boost)


def link_tubes(boxes: torch.Tensor,    # (T, N, 4)
               scores: torch.Tensor,   # (T, N)
               tracked: torch.Tensor,  # (T, N, 4) box propagated t -> t+1
               valid: torch.Tensor,    # (T, N)
               max_tubes: int = 20, link_iou_weight: float = 1.0,
               score_boost: str = "mean_top_half") -> Tubes:
    """Greedy repeated-Viterbi tube extraction for one class: the
    one-class case of `link_all_classes`, with its fields' class axis
    dropped ((max_tubes, T) paths, (T, N) scores)."""
    tubes = link_all_classes(boxes[None], scores[None], tracked[None],
                             valid[None], max_tubes, link_iou_weight,
                             score_boost)
    return Tubes(*(x[0] for x in tubes))
