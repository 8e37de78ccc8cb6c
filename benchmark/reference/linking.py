"""The plain reference of D&T's tube linking and rescoring (paper §3.4).

Per class, detections are linked over time by the best path under the
link score p(d_t) + p(d_t+1) + w IoU(tracked(d_t), d_t+1), found by a
Viterbi pass (the first maximum wins a tie); the path is a tube, its
detections are rescored to the mean of the top half of its scores (or
the statistic the configuration names), taken out, and the search repeats
up to the configuration's number of tubes. A frame with no detection left
exposes slot 0 as a skip of score 0, never claimed. Float32, the classes
as a batch dimension; `q` rounds the scores and the link terms (the
control's lower precision).
"""

from __future__ import annotations

import torch

from benchmark.reference.boxes import pairwise_iou

NEG = -1e9


def _first_argmax(x: torch.Tensor, dim: int) -> tuple:
    values = x.amax(dim=dim, keepdim=True)
    idx = torch.arange(x.shape[dim], device=x.device).reshape(
        [-1 if i == dim % x.dim() else 1 for i in range(x.dim())])
    hit = (x == values) | x.isnan()
    return values.squeeze(dim), torch.where(hit, idx, x.shape[dim]).amin(dim)


def _best_path(scores, iou_w, valid, virtual, q):
    c, t, n = scores.shape
    neg = torch.tensor(NEG, device=scores.device)
    p = torch.where(valid, scores, torch.where(virtual, 0.0, neg))
    live = valid | virtual
    link = torch.where(live[:, 1:, None, :],
                       q((p[:, :-1, :, None] + p[:, 1:, None, :]) + iou_w),
                       neg)
    v = torch.where(live[:, 0], 0.0, neg)
    backs = []
    for i in range(t - 1):
        v, back = _first_argmax(v[:, :, None] + link[:, i], 1)
        backs.append(back)
    score, end = _first_argmax(v, 1)
    path = [end]
    for back in reversed(backs):
        path.append(back.gather(1, path[-1][:, None])[:, 0])
    return torch.stack(path[::-1], dim=1), score / max(t - 1, 1)


def link(boxes, scores, tracked, valid, max_tubes: int, iou_weight: float,
         boost: str, q=lambda x: x) -> dict:
    """(C, T, N, 4) boxes, (C, T, N) scores, (C, T, N, 4) tracked boxes,
    (C, T, N) valid -> rescored (C, T, N), det_in_tube (C, T, N),
    tube_valid (C, K), tube_score (C, K), det_idx (C, K, T)."""
    c, t, n = scores.shape
    dev = scores.device
    scores = q(scores.float())
    valid = valid.bool()
    iou_w = q(iou_weight * pairwise_iou(tracked[:, :-1].float(),
                                        boxes[:, 1:].float()))
    first = torch.arange(n, device=dev) == 0
    cur, rescored = valid, scores
    in_tube = torch.zeros_like(valid)
    paths, oks, means = [], [], []
    for _ in range(max_tubes):
        any_left = cur.flatten(1).any(1)
        virtual = (~cur.any(2))[:, :, None] & first
        path, mean = _best_path(scores, iou_w, cur, virtual, q)
        ok = any_left & (mean > NEG / 2)
        onehot = (path[:, :, None] == torch.arange(n, device=dev)) & cur
        picked = torch.where(onehot, scores, float("-inf")).amax(2)
        picked = picked.sort(dim=1, descending=True).values
        count = onehot.any(2).sum(1)
        finite = torch.where(torch.isfinite(picked), picked, 0.0)
        if boost == "mean_top_half":
            kk = ((count + 1) // 2).clamp(min=1)
        elif boost == "mean":
            kk = count.clamp(min=1)
        elif boost == "max":
            kk = torch.ones_like(count)
        else:
            raise ValueError(f"unknown tube_score_boost {boost!r}")
        top = torch.arange(t, device=dev) < kk[:, None]
        value = torch.where(top, finite, 0.0).sum(1) / kk
        claim = onehot & ok[:, None, None]
        rescored = torch.where(claim, torch.maximum(rescored,
                                                    value[:, None, None]),
                               rescored)
        cur = cur & ~claim
        in_tube = in_tube | claim
        paths.append(path)
        oks.append(ok)
        means.append(mean)
    return {"rescored": rescored, "det_in_tube": in_tube,
            "tube_valid": torch.stack(oks, 1), "tube_score": torch.stack(means, 1),
            "det_idx": torch.stack(paths, 1)}
