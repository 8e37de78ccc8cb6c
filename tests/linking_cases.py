"""Detections for the tube-linking tests, made with numpy from a seed (no
JAX, so ``chip_smoke.py`` and the GPU tests load this file too).

`detections` draws padded per-frame detections: objects drifting across
frames with the tracked box near the next frame's box, some slots
invalid, one class with no valid detection and one with frames left
empty, and on request non-finite scores and boxes. `kernel_cases` names
the problems the linking kernel is held at against its plain form: the
eval path's widths (the 30 VID classes, N = ``eval.max_per_class`` = 20,
K = ``eval.max_tubes_per_class`` = 20) at T = 16 (tau=1) and T = 8 (tau=2
keyframes), with and without tied scores, and at T = 16 with non-finite
inputs; the eval widths at T = 300, the mean length of an ImageNet VID
val snippet (from W_SCRATCH_T on the links sit in scratch); N = 45 (not
a multiple of a warp) and N = 33 (two live words a frame); N = 300 (int32
backpointers, and a link frame of 360 KB, so the links sit in scratch at
T = 4); T = 1; T = W_SCRATCH_T, the first length at which the kernel's
links (the link weights with the scores folded in) leave shared memory at
N = 20, with and without non-finite inputs; and a T long enough that the
scores leave it too.
"""

import numpy as np

EVAL_C, EVAL_N, EVAL_K = 30, 20, 20
# the first T at which dtt_link_tubes's links leave shared memory at N =
# EVAL_N (link_layout; a CPU test holds it)
W_SCRATCH_T = 128


def detections(seed, c=4, t=7, n=5, tied=False, nonfinite=False):
    """(boxes, scores, tracked, valid) of `c` classes, `t` frames and `n`
    slots: float32 (c, t, n, 4), (c, t, n), (c, t, n, 4) and bool
    (c, t, n). Class 1 has no valid detection, class 2 every other frame
    from frame 2 empty, class 3 none at frame 0 (c >= 4). `tied`: few
    distinct scores and repeated boxes, so argmax ties. `nonfinite` (c >=
    8): at slot 0 of the middle frame, valid, class 4 has a NaN score
    (every path's score is NaN, as in dtt), class 5 a NaN box and tracked
    box (IoU 0), class 6 a score of +inf and class 7 one of -inf; class
    0's invalid slots hold NaN scores, which linking never reads."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 200, (c, 1, n, 2)) + np.arange(t)[None, :, None,
                                                          None] * 3.0
    wh = rng.uniform(10, 60, (c, 1, n, 2)).repeat(t, axis=1)
    boxes = np.concatenate([xy, xy + wh], axis=-1)
    boxes += rng.uniform(-4, 4, boxes.shape)
    tracked = np.roll(boxes, -1, axis=1) + rng.uniform(-3, 3, boxes.shape)
    if tied:   # few distinct scores and repeated boxes: argmax ties
        scores = rng.choice(np.float32([0.9, 0.5, 0.5, 0.2]), (c, t, n))
        boxes[:, :, 1] = boxes[:, :, 0]
        tracked[:, :, 1] = tracked[:, :, 0]
    else:
        scores = rng.uniform(0.01, 1.0, (c, t, n))
    valid = rng.rand(c, t, n) > 0.3
    valid[1] = False                     # a class with no detection
    valid[2, 2:t:2] = False              # empty frames: virtual skip slots
    if t > 1:
        valid[3, 0] = False              # no detection at frame 0
    if nonfinite:
        mid = t // 2
        valid[4:8, mid, 0] = True
        scores[4, mid, 0] = np.nan
        boxes[5, mid, 0] = np.nan
        tracked[5, mid, 0] = np.nan
        scores[6, mid, 0] = np.inf
        scores[7, mid, 0] = -np.inf
        scores[0][~valid[0]] = np.nan
    return (boxes.astype(np.float32), scores.astype(np.float32),
            tracked.astype(np.float32), valid)


def kernel_cases():
    """(name, `detections` keywords, max_tubes) of each problem the kernel
    is held at."""
    ev = dict(c=EVAL_C, n=EVAL_N)
    return [("eval_tau1", dict(seed=0, t=16, **ev), EVAL_K),
            ("eval_tau1_tied", dict(seed=1, t=16, tied=True, **ev), EVAL_K),
            ("eval_tau2", dict(seed=2, t=8, **ev), EVAL_K),
            ("eval_tau2_tied", dict(seed=3, t=8, tied=True, **ev), EVAL_K),
            ("eval_tau1_nonfinite", dict(seed=8, t=16, nonfinite=True, **ev),
             EVAL_K),
            ("vid_len", dict(seed=10, t=300, **ev), EVAL_K),
            ("n45", dict(seed=4, c=6, t=16, n=45), EVAL_K),
            ("n33", dict(seed=11, c=6, t=16, n=33), EVAL_K),
            ("n300", dict(seed=13, c=4, t=4, n=300), 3),
            ("t1", dict(seed=5, t=1, **ev), EVAL_K),
            ("w_scratch", dict(seed=12, c=8, t=W_SCRATCH_T, n=EVAL_N),
             EVAL_K),
            ("w_scratch_nonfinite", dict(seed=14, c=8, t=W_SCRATCH_T,
                                         n=EVAL_N, nonfinite=True), EVAL_K),
            ("scratch", dict(seed=6, c=4, t=1400, n=45), 3)]
