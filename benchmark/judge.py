"""The numbers that decide whether the video step's outputs are correct.

A frame pair's outputs (per class: kept boxes, scores, validity and
tracked boxes) are judged in two stages against the plain reference's
float32 forward of the same two frames on the same weights. The trunk's
state (the maps the heads read, of both frames, read from the trunk
program's buffers) is held against the reference's trunk
(``trunk_err``). Everything after it, proposals, heads and per-class
NMS, the reference computes from the judged side's own trunk state, and
the detections are held against those. Two reasons: which ~300 of the
38,760 anchors survive the RPN's NMS turns on near-ties that any change
of rounding flips (float32 against float8 keeps 2-4% of them alike), and
with the initialisers' weights the class logits run to the hundreds, so
the trunk's rounding reaches the scores with a gain that changes from
seed to seed by more than the factor between the program and a float8
control.

* ``trunk_err``: the largest, over the trunk's outputs that the heads
  read and the pair's two frames, of max |judged - reference| /
  max |reference|.
* ``box_err``: each kept detection is matched to the proposal whose
  reference box and tracked box lie nearest; the mean distance of its
  box or tracked box from the reference's, over the reference box's
  longer side. A mean, not the largest: the largest swings with the
  smallest boxes (a sixth of a pixel on a 14-pixel box).
* ``score_err``: for each kept detection, |log score - the reference's
  log-probability of its class at the matched proposal| over the span of
  the reference's class logits there; the 90th percentile. Over the
  span, because the logits' scale changes from seed to seed and the
  score's gap with it; the largest swings with a few near-ties.
* ``missed_share``: the share of the reference's detections scoring
  ``CONFIDENT`` or more that the judged side leaves out: none of its
  detections of the class at that proposal or over it (IoU above the
  NMS threshold), nor its lowest where its list of the class is full,
  scores half as much. A sound side leaves none out: the limit is 0.
* ``link_gap``: the reference's tube linking of the program's own
  detections of a snippet; the largest |rescored - reference| and 1 for
  any detection claimed by a tube on one side and not the other.
"""

from __future__ import annotations

import numpy as np


def np_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4), (M, 4) -> (N, M) IoU, +1 widths, float64."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    ix = np.clip(np.minimum(a[:, None, 2], b[None, :, 2])
                 - np.maximum(a[:, None, 0], b[None, :, 0]) + 1, 0, None)
    iy = np.clip(np.minimum(a[:, None, 3], b[None, :, 3])
                 - np.maximum(a[:, None, 1], b[None, :, 1]) + 1, 0, None)
    area = lambda x: (np.clip(x[:, 2] - x[:, 0] + 1, 0, None)
                      * np.clip(x[:, 3] - x[:, 1] + 1, 0, None))
    inter = ix * iy
    union = area(a)[:, None] + area(b)[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def trunk_err(got: dict, want: dict) -> float:
    """max over the maps of max |got - want| / max |want|."""
    worst = 0.0
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got[k], np.float64)
        worst = max(worst, float(np.abs(g - w).max()
                                 / max(np.abs(w).max(), 1e-30)))
    return worst


CONFIDENT = 0.3   # a reference detection's score from which leaving it out counts


def pair_gaps(out: dict, ref: dict, nms_thresh: float) -> dict:
    """The per-detection gaps of one pair's outputs `out` (numpy boxes
    (C-1, M, 4), scores, valid, tracked) against the reference's `ref`
    (its kept detections and, before NMS, its proposals ``roi_valid``,
    ``cls_logits``, ``roi_boxes``, ``roi_tracked``): ``box`` and
    ``score`` of each kept detection and ``missed`` (1 or 0) of each
    reference detection scoring ``CONFIDENT`` or more (see the module's
    notes)."""
    cand_ok = ref["roi_valid"]
    rbox, rtrk = ref["roi_boxes"], ref["roi_tracked"]
    z = ref["cls_logits"].astype(np.float64)
    zmax = z.max(1, keepdims=True)
    log_prob = z - zmax - np.log(np.exp(z - zmax).sum(1, keepdims=True))
    z_span = np.maximum(z.max(1) - z.min(1), 1e-6)
    m_cap = out["scores"].shape[1]
    side = lambda b: np.maximum(b[:, 2] - b[:, 0] + 1, b[:, 3] - b[:, 1] + 1)
    score, box, missed = [], [], []
    for c in range(out["scores"].shape[0]):
        v = out["valid"][c]
        pb, pt, ps = out["boxes"][c][v], out["tracked"][c][v], out["scores"][c][v]
        match = np.zeros(0, int)
        if len(pb):
            db = np.abs(pb[:, None] - rbox[None]).max(-1)
            dt = np.abs(pt[:, None] - rtrk[None]).max(-1)
            d = np.where(cand_ok[None], np.maximum(db, dt), np.inf)
            match = d.argmin(1)
            k = np.arange(len(pb))
            box.append(np.maximum(db[k, match] / side(rbox[match]),
                                  dt[k, match] / side(rtrk[match])))
            score.append(np.abs(np.log(np.maximum(ps.astype(np.float64),
                                                  1e-300))
                                - log_prob[match, c + 1]) / z_span[match])
        rv = ref["valid"][c] & (ref["scores"][c] >= CONFIDENT)
        rb, rs = ref["boxes"][c][rv], ref["scores"][c][rv]
        if not len(rb):
            continue
        # the reference's kept detection: its proposal, by the same match
        ri = np.abs(rb[:, None] - rbox[None]).max(-1)
        ri = np.where(cand_ok[None], ri, np.inf).argmin(1)
        best = np.zeros(len(rb))
        if len(pb):
            cover = (ri[:, None] == match[None]) | (np_iou(rb, pb) > nms_thresh)
            best = np.where(cover, ps[None], 0.0).max(1)
            if len(pb) == m_cap:     # a full list leaves out what scores lower
                best = np.maximum(best, ps.min())
        missed.append((best < 0.5 * rs).astype(np.float64))
    cat = lambda xs: np.concatenate(xs) if xs else np.zeros(0)
    return {"score": cat(score), "box": cat(box), "missed": cat(missed)}


def link_gap(got: dict, want: dict) -> float:
    """The largest |rescored - reference| over detections, 1 where a
    detection is in a tube on one side only."""
    if (np.asarray(got["det_in_tube"]) != np.asarray(want["det_in_tube"])
            ).any():
        return 1.0
    return float(np.abs(np.asarray(got["rescored"], np.float64)
                        - np.asarray(want["rescored"], np.float64)).max())
