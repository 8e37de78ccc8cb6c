"""NMS problems made with numpy from a seed, shared by the NMS tests on the
CPU and on the card and by ``chip_smoke.py`` (which loads this file by its
path): the crafted edge cases and problems at the shapes of the port's
paths. No JAX and no torch here.

A problem is a dict of ``boxes`` (P, K, 4) float32, ``scores`` (P, K)
float32, ``valid`` (P, K) bool, ``iou`` and ``score`` (the thresholds) and
``m`` (the output slots).
"""

import numpy as np

_NEG = -1e10
# (name, P, K, M, IoU threshold, score threshold) of each NMS the port's
# paths run at Config(): the proposals of a video chunk (frame t of its 16
# pairs) and of a train step (both frames of its pair), a chunk's per-class
# NMS (16 frames x 30 classes at 300 proposals) and OHEM's (both frames,
# 300 proposals + 30 gt slots, 128 kept)
PATH_SHAPES = (("video_proposals", 16, 6000, 300, 0.7, -0.5),
               ("train_proposals", 2, 6000, 300, 0.7, -0.5),
               ("per_class", 480, 300, 20, 0.3, 1e-3),
               ("ohem", 2, 330, 128, 0.7, -0.5))
CRAFTED_K = 64


def _boxes(rng, shape, extent=(608.0, 1088.0), size=(16.0, 400.0),
           centers=None):
    """Boxes around `centers` (n, 2) cluster centres (or uniform), of
    `size` sides, clipped to the extent: heavy overlap, as proposals have."""
    h, w = extent
    if centers is None:
        cx = rng.uniform(0, w, shape)
        cy = rng.uniform(0, h, shape)
    else:
        pick = rng.randint(0, len(centers), shape)
        cx = centers[pick, 0] + rng.normal(0, 12, shape)
        cy = centers[pick, 1] + rng.normal(0, 12, shape)
    bw = rng.uniform(*size, shape)
    bh = rng.uniform(*size, shape)
    x1 = np.clip(cx - bw / 2, 0, w - 1)
    y1 = np.clip(cy - bh / 2, 0, h - 1)
    x2 = np.clip(cx + bw / 2, x1, w - 1)
    y2 = np.clip(cy + bh / 2, y1, h - 1)
    return np.stack([x1, y1, x2, y2], -1).astype(np.float32)


def path_problem(name, p, k, m, iou, score, seed, classes=30):
    """A problem at one of PATH_SHAPES: proposals sorted by score (as the
    proposal layer hands them over) with ~5% filtered to -1; per-class
    scores as softmax columns of `classes` foreground classes (p a multiple
    of them), most under the threshold; OHEM losses."""
    rng = np.random.RandomState(seed)
    centers = np.stack([rng.uniform(0, 1088, 200), rng.uniform(0, 608, 200)],
                       -1)
    boxes = _boxes(rng, (p, k), centers=centers)
    if name.endswith("proposals"):
        scores = -np.sort(-rng.uniform(0, 1, (p, k)), axis=-1)
        scores[rng.rand(p, k) < 0.05] = -1.0
        valid = scores >= 0
    elif name == "per_class":
        scores = rng.dirichlet(np.full(classes + 1, 0.05),
                               (p // classes, k))[..., 1:]
        scores = scores.transpose(0, 2, 1).reshape(p, k)
        valid = np.repeat(rng.rand(p // classes, k) > 0.02, classes, axis=0)
    else:
        scores = rng.exponential(1.0, (p, k))
        valid = rng.rand(p, k) > 0.05
    return dict(name=name, boxes=boxes, scores=scores.astype(np.float32),
                valid=valid, iou=iou, score=score, m=m)


def permuted(problem, seed):
    """`problem` with each row's boxes in another order (scores and
    validity travel with their boxes), and the permutations (P, K): row
    position i holds the original box perm[i]."""
    rng = np.random.RandomState(seed)
    p, k = problem["scores"].shape
    perm = np.stack([rng.permutation(k) for _ in range(p)])
    moved = {key: np.take_along_axis(
        problem[key], perm.reshape(perm.shape + (1,) * (problem[key].ndim - 2)),
        1) for key in ("boxes", "scores", "valid")}
    return dict(problem, **moved), perm


def anchor_problem(p, k, seed):
    """Proposals as a proposal layer at random weights hands them over:
    Config()'s anchor lattice over a 608 x 1088 canvas (16-pixel stride,
    12 anchors a cell: base 16, scales 4/8/16/32, ratios 1/2, 1, 2), each
    box ~e^2.25 times its anchor's sides and clipped, so most are
    near-duplicates of the canvas; nearly equal scores, the top `k` sorted.
    At IoU 0.7 a hundred or so kept boxes suppress every other one, and
    the walk goes through every position with slots to spare."""
    rng = np.random.RandomState(seed)
    h, w, stride = 608.0, 1088.0, 16
    sides = []
    for r in (0.5, 1.0, 2.0):
        bw = np.round(np.sqrt(256.0 / r))
        sides += [(bw * s, np.round(bw * r) * s) for s in (4, 8, 16, 32)]
    sides = np.float64(sides)
    gy, gx = np.mgrid[0:int(h) // stride, 0:int(w) // stride]
    cx = np.repeat(gx.reshape(-1) * stride + 7.5, len(sides))
    cy = np.repeat(gy.reshape(-1) * stride + 7.5, len(sides))
    aw, ah = (np.tile(sides[:, i], gx.size) for i in (0, 1))
    boxes, scores = [], []
    for _ in range(p):
        d = rng.normal(0, 0.1, (cx.size, 4))
        x, y = cx + d[:, 0] * aw, cy + d[:, 1] * ah
        bw, bh = aw * np.exp(d[:, 2] + 2.25), ah * np.exp(d[:, 3] + 2.25)
        b = np.stack([np.clip(x - 0.5 * (bw - 1), 0, w - 1),
                      np.clip(y - 0.5 * (bh - 1), 0, h - 1),
                      np.clip(x + 0.5 * (bw - 1), 0, w - 1),
                      np.clip(y + 0.5 * (bh - 1), 0, h - 1)], -1)
        s = 0.5 + 0.01 * rng.randn(cx.size)
        top = np.argsort(-s, kind="stable")[:k]
        boxes.append(b[top])
        scores.append(s[top])
    return dict(name=f"anchors_{p}x{k}", boxes=np.float32(boxes),
                scores=np.float32(scores), valid=np.ones((p, k), bool),
                iou=0.7, score=-0.5, m=300)


def long_walk_problems(seed: int = 0):
    """Problems whose walk goes past the first 1,024 positions, more
    than a block of the kernel has threads: proposals at IoU 0.1 (most
    suppressed; a frame's and a video chunk's), and the anchor problem at
    a video chunk's 16."""
    out = []
    for i, p in enumerate((1, 16)):
        c = path_problem("video_proposals", p, 6000, 300, 0.1, -0.5,
                         seed=seed + 50 + i)
        out.append(dict(c, name=f"proposals_iou_0.1_{p}x6000"))
    out.append(anchor_problem(16, 6000, seed + 52))
    return out


def walk_end(problem, keep_idx, keep_valid):
    """How far the greedy walk went in each problem, in positions of the
    (score desc, index asc) order of its live boxes: past the last kept
    box where every slot is filled, else through every live box. Takes
    numpy outputs of either plain form."""
    ends = []
    for i in range(problem["scores"].shape[0]):
        s = np.where(problem["valid"][i], problem["scores"][i],
                     np.float32(_NEG))
        live = np.nonzero(s > problem["score"])[0]
        order = live[np.lexsort((live, -s[live]))]
        pos = np.empty(len(s), int)
        pos[order] = np.arange(len(order))
        kept = keep_idx[i][keep_valid[i]]
        ends.append(int(pos[kept[-1]]) + 1 if len(kept) == problem["m"]
                    else len(order))
    return ends


def path_problems(seed: int = 0):
    return [path_problem(*shape, seed=seed + i)
            for i, shape in enumerate(PATH_SHAPES)]


def _at_threshold_boxes(rng, k):
    """Boxes whose IoUs sit exactly at 0.5 and 0.25 (exact in float32): a
    10x10 box beside its 10x5 and 10x6 halves and its 5x5 corner, copies
    of that family 100 pixels apart."""
    family = np.float32([[0, 0, 9, 9], [0, 0, 9, 4], [0, 0, 9, 5],
                         [0, 5, 9, 9], [0, 0, 4, 4], [5, 5, 9, 9],
                         [0, 0, 9, 9], [1, 0, 9, 9]])
    reps = -(-k // len(family))
    offs = np.float32([[100 * (i % 8), 100 * (i // 8)] * 2
                       for i in range(reps)])
    return (family[None] + offs[:, None]).reshape(-1, 4)[:k]


def crafted_cases(seed: int = 0):
    """The edge cases, each one problem of CRAFTED_K boxes: ties, IoU
    exactly at the threshold, the budget filling inside a step, no valid
    box, thresholds >= 1 (duplicate boxes kept), scores at the score
    threshold, a NaN score, the proposal layer's -1 filter, and a score
    threshold below -1e10 (a masked box selected)."""
    rng = np.random.RandomState(seed)
    k = CRAFTED_K
    ties = np.float32([0.9, 0.7, 0.5, 0.5, 0.3, 1e-4])
    spread = _boxes(rng, (k,), extent=(200.0, 200.0), size=(10.0, 70.0))
    disjoint = np.float32([[20 * i, 0, 20 * i + 9, 9] for i in range(k)])
    at = _at_threshold_boxes(rng, k)
    dup = np.repeat(spread[: k // 2], 2, axis=0)
    cases = []

    def add(name, boxes, scores, valid=None, iou=0.5, score=_NEG / 2, m=k):
        valid = np.ones(k, bool) if valid is None else valid
        cases.append(dict(name=name, boxes=boxes[None].astype(np.float32),
                          scores=np.asarray(scores, np.float32)[None],
                          valid=valid[None], iou=iou, score=score, m=m))

    add("ties", spread, rng.choice(ties, k), rng.rand(k) > 0.1)
    add("ties_dense", spread, np.full(k, 0.5), iou=0.3)
    add("at_threshold_0.5", at, rng.choice(ties, k), iou=0.5)
    add("at_threshold_0.25", at, rng.choice(ties, k), iou=0.25)
    add("budget_in_first_step", disjoint, rng.uniform(0, 1, k), m=5)
    add("budget_in_a_later_step", spread, rng.choice(ties, k), m=37,
        iou=0.7)
    add("no_valid", spread, rng.uniform(0, 1, k), np.zeros(k, bool))
    add("threshold_1", dup, rng.choice(ties, k), iou=1.0)
    add("threshold_1.5", dup, rng.uniform(0, 1, k), iou=1.5)
    add("score_threshold", spread, rng.choice(ties, k), score=0.5)
    nan = rng.uniform(0, 1, k)
    nan[7] = np.nan
    add("nan_score", spread, nan)
    filt = rng.uniform(0, 1, k)
    filt[rng.rand(k) < 0.3] = -1.0
    add("proposal_filter", spread, filt, filt >= 0, iou=0.7, score=-0.5)
    # below -1e10 a masked box is live again: pairs of equal boxes, the
    # first box masked; one slot more than the valid pairs' survivors takes
    # the lowest masked index, 0, in the one-at-a-time and every block form
    pairs = np.repeat(disjoint[: k // 2], 2, axis=0)
    masked = rng.rand(k) > 0.85
    masked[0] = True
    survivors = int((~masked).reshape(-1, 2).any(1).sum())
    add("below_masked_score", pairs, rng.uniform(0, 1, k), ~masked,
        score=2 * _NEG, m=survivors + 1)
    return cases


def signed_zero_problem(seed: int = 0):
    """One problem of CRAFTED_K overlapping boxes whose scores tie at +0.0
    and -0.0 (live at a score threshold of -0.5). dtt's argmax
    (``nms_padded``) ties them and goes by index; its ``lax.top_k``
    (``nms_padded_fast``) ranks +0.0 first. Each of the port's forms
    follows its own dtt form, so the two forms decide differently here."""
    rng = np.random.RandomState(seed)
    k = CRAFTED_K
    boxes = _boxes(rng, (k,), extent=(200.0, 200.0), size=(10.0, 70.0))
    scores = rng.choice(np.float32([0.5, 0.0, -0.0, 0.0, -0.0, 0.2]), k)
    return dict(name="signed_zero_ties", boxes=boxes[None],
                scores=scores[None], valid=np.ones((1, k), bool), iou=0.3,
                score=-0.5, m=k)


def below_masked_problem(seed: int = 0):
    """One problem of CRAFTED_K overlapping boxes at a score threshold of
    -2e10, where every box at -1e10 (masked, retired or suppressed) is live
    again, ranked by index, above scores between -2e10 and -1e10 and with
    scores under -2e10 and -inf brought back once suppressed; M = K slots,
    so the -1e10 boxes come round again. Its decisions depend on the step
    width (dtt's ``nms_padded_fast`` at that width)."""
    rng = np.random.RandomState(seed)
    k = CRAFTED_K
    scores = rng.uniform(0, 1, k)
    scores[rng.rand(k) < 0.2] = 1.5 * _NEG
    scores[rng.rand(k) < 0.1] = 3 * _NEG
    scores[rng.rand(k) < 0.05] = -np.inf
    boxes = _boxes(rng, (k,), extent=(200.0, 200.0), size=(10.0, 70.0))
    return dict(name="below_masked_rich", boxes=boxes[None],
                scores=scores.astype(np.float32)[None],
                valid=(rng.rand(k) > 0.2)[None], iou=0.5, score=2 * _NEG,
                m=k)
