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
  launch, a thread block a class, each tube's chain on one warp over the
  plain form's link scores, kept in shared memory and updated where a tube
  claims; `link_layout` says where its working arrays sit. Decisions and
  tube scores equal the plain form's bit for bit; the rescored scores to
  float32 roundoff (the boost's sum is taken in another order).
* `to_device` and `tubes_numpy` — `link_snippet`'s one copy of its inputs
  to the card and one of `link_cuda`'s outputs back.
* `link_all_classes` — the dispatcher: the plain form on CPU tensors, the
  kernel on CUDA tensors, or it raises; `link_tubes` is its one-class
  case.

Everything is float32 (``_NEG`` terms swamp small ones there, as in
``dtt``) and every argmax takes the first maximum, as ``jnp.argmax``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from dtt_torch.core import boxes as box_ops
from dtt_torch.ops import _build

_NEG = -1e9
_BOOSTS = ("mean_top_half", "mean", "max")
# the kernel's constants (``csrc/linking.cu``): what its static part takes
# of a block's shared memory (kStaticSmem), its threads a block (kThreads),
# the slots up to which a backpointer is a byte (kNarrowBack), v's bytes a
# slot (kSlotBytes), its working arrays in the order they leave shared
# memory (kArrays of them) and the link frames a ring holds (kRing)
_STATIC_SMEM = 0
_THREADS = 512
_NARROW_BACK = 255
_SLOT_BYTES = 8
_ARRAYS = ("link weights", "links", "claimed scores", "p", "backpointers",
           "live words", "path", "v", "link ring")
_RING = 4


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
    body: str        # "shared": every array in shared memory; "scratch"
    smem: int        # dynamic shared memory a block, bytes
    scratch: int     # scratch a class, bytes (0 for "shared")
    n_shared: int    # how many of `_ARRAYS`, from the last, sit in shared
                     # memory
    in_scratch: tuple  # the names of those in scratch, in order
    ring: bool       # links in scratch reach the chain through a ring of
                     # `_RING` frames in shared memory


def _array_bytes(t: int, n: int, ring: bool) -> tuple:
    """The bytes of each of ``dtt_link_tubes``'s working arrays (in
    `_ARRAYS`'s order) for `t` frames of `n` slots, each padded to 16: a
    frame of link weights or links n rows of a stride of at least n floats
    that is 4 (mod 8), p and v `n` rounded up to 4 slots, the ring (its
    frames and an mbarrier a frame) only with `ring`. The kernel's
    ``dtt_link_array_bytes`` gives the same (a GPU test holds them)."""
    back = 1 if n <= _NARROW_BACK else 4
    n4 = -(-n // 4) * 4
    frame = 4 * n * (n4 | 4)
    pad = lambda b: -(-b // 16) * 16            # noqa: E731
    return ((t - 1) * frame,                    # link weights
            (t - 1) * frame,                    # links
            pad(8 * (_THREADS // 32) * t),      # claimed scores, a warp
            4 * t * n4,                         # p
            pad(back * (t - 1) * n),            # backpointers
            pad(4 * t * -(-n // 32)),           # live words
            pad(back * t),                      # path
            _SLOT_BYTES * n4,                   # v
            _RING * frame + pad(8 * _RING) if ring else 0)   # link ring


def _fit(sizes: tuple) -> tuple:
    """(k, bytes): the arrays from the k-th on fit in shared memory."""
    k, smem = len(sizes), 0
    while k and smem + sizes[k - 1] + _STATIC_SMEM <= _build.SMEM_LIMIT:
        k -= 1
        smem += sizes[k]
    return k, smem


def link_layout(t: int, n: int) -> LinkLayout:
    """Where ``dtt_link_tubes`` keeps the working arrays of a class of `t`
    frames and `n` slots: `_ARRAYS` leave shared memory in that order, the
    link weights first, until the rest fits a block's 227 KB beside the
    kernel's static bytes (at n = 20 the link weights leave from t = 69 on,
    the links from t = 128); those that leave sit in a scratch buffer of
    the wrapper's, one slice a class. Where the links leave, a ring of
    their frames joins the shared arrays if it fits there."""
    sizes = _array_bytes(t, n, False)
    k, smem = _fit(sizes)
    ring = False
    if k > 1:
        with_ring = _array_bytes(t, n, True)
        rk, rsmem = _fit(with_ring)
        if rk < len(with_ring):
            sizes, k, smem, ring = with_ring, rk, rsmem, True
    return LinkLayout("shared" if k == 0 else "scratch", smem,
                      sum(sizes[:k]), len(sizes) - k,
                      tuple(a for a, b in zip(_ARRAYS, sizes[:k]) if b),
                      ring)


def _packed_bytes(fields) -> int:
    """The bytes of arrays of `fields` ((shape, dtype) each) packed at
    16-byte aligned offsets."""
    return sum(-(-math.prod(s) * d.itemsize // 16) * 16 for s, d in fields)


def _packed(buf: torch.Tensor, fields) -> list:
    """The arrays of `fields` ((shape, dtype) each) packed in the uint8
    `buf` at 16-byte aligned offsets, as views."""
    out, at = [], 0
    for shape, dtype in fields:
        nbytes = math.prod(shape) * dtype.itemsize
        out.append(buf[at:at + nbytes].view(dtype).view(shape))
        at += -(-nbytes // 16) * 16
    return out


def to_device(arrays, device) -> list:
    """numpy arrays as tensors on `device` by one host-to-device copy: packed
    into one host buffer (pinned where `device` is a card, from PyTorch's
    caching host allocator, which keeps a block until its copies are done),
    copied once, and viewed there."""
    src = [np.ascontiguousarray(a) for a in arrays]
    fields = [(a.shape, torch.from_numpy(a).dtype) for a in src]
    device = torch.device(device)
    host = torch.empty(_packed_bytes(fields), dtype=torch.uint8,
                       pin_memory=device.type != "cpu")
    for view, a in zip(_packed(host, fields), src):
        view.numpy()[...] = a
    return _packed(host.to(device, non_blocking=True), fields)


def tubes_numpy(tubes: Tubes) -> Tubes:
    """`tubes` as numpy arrays; `link_cuda`'s, whose fields are views of one
    device buffer, by one device-to-host copy (into a pinned buffer, then
    out to arrays of their own)."""
    store = tubes[0].untyped_storage()
    if tubes[0].device.type == "cpu" or any(
            x.untyped_storage().data_ptr() != store.data_ptr() for x in tubes):
        return Tubes(*(x.cpu().numpy() for x in tubes))
    dev = tubes[0].device
    host = torch.empty(store.nbytes(), dtype=torch.uint8, pin_memory=True)
    host.copy_(torch.empty(0, dtype=torch.uint8, device=dev).set_(store))
    return Tubes(*(host[x.storage_offset() * x.element_size():][:x.nbytes]
                   .view(x.dtype).view(x.shape).numpy().copy()
                   for x in tubes))


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("linking").dtt_link_tubes
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p])
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
    ``link_cuda.launches``. The five fields of the result are views of one
    device buffer (`tubes_numpy` reads them back by one copy). Where
    `link_layout` puts an array in scratch it allocates the scratch buffer.
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
    fields = [((c, max_tubes, t), torch.int64), ((c, max_tubes), torch.bool),
              ((c, max_tubes), torch.float32), ((c, t, n), torch.float32),
              ((c, t, n), torch.bool)]
    tubes = Tubes(*_packed(torch.empty(_packed_bytes(fields),
                                       dtype=torch.uint8, device=dev), fields))
    if c == 0:
        return tubes
    fn = _entry()
    layout = link_layout(t, n)
    scratch = (torch.empty(c * layout.scratch, dtype=torch.uint8, device=dev)
               if layout.scratch else None)
    bx, sc, tr, va = (x.contiguous() for x in (boxes, scores, tracked, valid))
    err = fn(bx.data_ptr(), tr.data_ptr(), sc.data_ptr(), va.data_ptr(),
             *(x.data_ptr() for x in tubes), c, t, n, max_tubes,
             float(link_iou_weight), _BOOSTS.index(score_boost), layout.smem,
             layout.n_shared, layout.ring, layout.scratch,
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
