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
frames and the backtrack. Here the class axis is a batch dimension and the
scans are loops of small tensor ops on the device the inputs lie on, with
no transfer to the host: the link scores' IoU term does not depend on which
detections are left, so it is computed once for all frames and tubes.
Everything is float32 (``_NEG`` terms swamp small ones there, as in
``dtt``) and every argmax takes the first maximum, as ``jnp.argmax``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dtt_torch.core import boxes as box_ops

_NEG = -1e9
_BOOSTS = ("mean_top_half", "mean", "max")


class Tubes(NamedTuple):
    det_idx: torch.Tensor      # (C, max_tubes, T) detection index per frame
    tube_valid: torch.Tensor   # (C, max_tubes) tube is real
    tube_score: torch.Tensor   # (C, max_tubes) mean link-path score
    rescored: torch.Tensor     # (C, T, N) rescored detection scores
    det_in_tube: torch.Tensor  # (C, T, N) bool: detection was claimed


def _first_argmax(x: torch.Tensor, values: torch.Tensor, dim: int
                  ) -> torch.Tensor:
    """Index of the first element of `x` equal to its maximum `values`
    along `dim` (``values`` keeps `dim` as size 1)."""
    idx = torch.arange(x.shape[dim], device=x.device).reshape(
        [-1 if i == dim % x.dim() else 1 for i in range(x.dim())])
    return torch.where(x == values, idx, x.shape[dim]).amin(dim=dim)


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
    return path, path_score / max(t - 1, 1)


def link_all_classes(boxes: torch.Tensor,    # (C, T, N, 4)
                     scores: torch.Tensor,   # (C, T, N)
                     tracked: torch.Tensor,  # (C, T, N, 4) box t -> t+1
                     valid: torch.Tensor,    # (C, T, N)
                     max_tubes: int = 20, link_iou_weight: float = 1.0,
                     score_boost: str = "mean_top_half") -> Tubes:
    """Greedy repeated-Viterbi tube extraction for every class at once, on
    the inputs' device.

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
