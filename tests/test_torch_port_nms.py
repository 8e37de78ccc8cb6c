"""The port's multi-select NMS held against dtt's on the CPU: the plain
``nms_padded_fast`` (and the one-at-a-time ``nms_padded``) against
``dtt.ops.nms.nms_padded_fast`` at select_block 1, 16 and 32 on the
crafted cases of ``tests/nms_cases.py`` (ties, IoU exactly at the
threshold, the budget filling inside a step, no valid box, thresholds >= 1,
a NaN score) and a batch whose problems stop at different steps; walks
past 1,024 positions (6,000 boxes) against dtt's one-at-a-time loop; then
``multiclass_nms(select_block=...)``, ``proposal_layer`` at
``nms_select_block`` 1 and 32 and ``decode_detections_batched`` against
dtt's.

Decisions (indices, validity) are equal exactly; scores within 1e-6 and
box coordinates within 1e-6 relative + 1e-4 pixels (decoded boxes may
differ by an ulp of the decode's exp). Problems of dtt's block form keep
K <= 512: dtt unrolls each block step, one compile per (K, max_outputs,
block).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dtt.core.config as jcfg
from dtt.models import dnt as jdnt
from dtt.models.rpn import proposal_layer as j_proposal_layer
from dtt.ops import nms as jnms
from tests.nms_cases import (below_masked_problem, crafted_cases,
                              long_walk_problems, path_problem,
                              signed_zero_problem, walk_end)

import dtt_torch.core.config as tcfg
from dtt_torch.models import dnt as tdnt
from dtt_torch.models.rpn import proposal_layer as t_proposal_layer
from dtt_torch.ops import nms as tnms

BLOCKS = (1, 16, 32)
CASES = {c["name"]: c for c in crafted_cases()}
LONG = {c["name"]: c for c in long_walk_problems()}
TOL = dict(rtol=1e-6, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _dtt_fast(c, block, i=0):
    return jnms.nms_padded_fast(
        jnp.asarray(c["boxes"][i]), jnp.asarray(c["scores"][i]), c["iou"],
        c["m"], valid=jnp.asarray(c["valid"][i]),
        score_threshold=c["score"], select_block=block)


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_nms_padded_fast_matches_dtt(name, block):
    """The plain block loop gives dtt's indices and validity exactly, and
    so does the one-at-a-time loop (the kernel serves both)."""
    c = CASES[name]
    ji, jv = _dtt_fast(c, block)
    args = (_t(c["boxes"]), _t(c["scores"]), c["iou"], c["m"],
            _t(c["valid"]), c["score"])
    ti, tv = tnms.nms_padded_fast(*args, select_block=block)
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))
    si, sv = tnms.nms_padded(*args)
    np.testing.assert_array_equal(sv.numpy(), tv.numpy())
    np.testing.assert_array_equal(si.numpy(), ti.numpy())


def test_crafted_cases_reach_their_edges():
    """The cases do what their names say, so the parity above covers it:
    a kept pair at IoU exactly 0.5 / 0.25, duplicates kept at threshold
    >= 1, the budget full, nothing kept without a valid box or with a NaN
    score."""
    def kept(name):
        c = CASES[name]
        i, v = tnms.nms_padded_fast(_t(c["boxes"]), _t(c["scores"]), c["iou"],
                                    c["m"], _t(c["valid"]), c["score"])
        return c, i[0][v[0]].numpy()

    for name, t in (("at_threshold_0.5", 0.5), ("at_threshold_0.25", 0.25)):
        c, idx = kept(name)
        b = c["boxes"][0][idx]
        area = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
        ix = np.minimum(b[:, None, 2], b[None, :, 2]) - np.maximum(
            b[:, None, 0], b[None, :, 0]) + 1
        iy = np.minimum(b[:, None, 3], b[None, :, 3]) - np.maximum(
            b[:, None, 1], b[None, :, 1]) + 1
        inter = np.clip(ix, 0, None) * np.clip(iy, 0, None)
        iou = inter / (area[:, None] + area[None, :] - inter)
        np.fill_diagonal(iou, 0)
        assert (iou == t).any() and (iou <= t).all(), name
    for name in ("threshold_1", "threshold_1.5"):
        c, idx = kept(name)
        assert len(idx) == c["m"] == len(set(idx.tolist())), name
    for name in ("budget_in_first_step", "budget_in_a_later_step"):
        c, idx = kept(name)
        assert len(idx) == c["m"], name
    for name in ("no_valid", "nan_score"):
        assert len(kept(name)[1]) == 0, name


def test_below_masked_score_case_reaches_its_edge():
    """Below a score threshold of -1e10 the last slot takes masked box 0,
    after every valid pair's survivor."""
    c = CASES["below_masked_score"]
    i, v = tnms.nms_padded_fast(_t(c["boxes"]), _t(c["scores"]), c["iou"],
                                c["m"], _t(c["valid"]), c["score"])
    idx = i[0][v[0]].numpy()
    assert len(idx) == c["m"] and idx[-1] == 0 and not c["valid"][0][0]
    assert c["valid"][0][idx[:-1]].all()


@pytest.mark.parametrize("block", BLOCKS)
def test_signed_zero_ties_match_each_dtt_form(block):
    """Each of the port's forms orders the two zeros as its dtt form does:
    the block loop ranks +0.0 above -0.0 at each width, as dtt's
    ``nms_padded_fast`` (``lax.top_k`` orders floats totally); the
    one-at-a-time loop ties them and goes by index, as dtt's
    ``nms_padded`` (``argmax``). dtt's two forms differ on the case, so it
    tells the orders apart."""
    c = signed_zero_problem()
    args = (_t(c["boxes"]), _t(c["scores"]), c["iou"], c["m"],
            _t(c["valid"]), c["score"])
    ji, jv = jnms.nms_padded(jnp.asarray(c["boxes"][0]),
                             jnp.asarray(c["scores"][0]), c["iou"], c["m"],
                             valid=jnp.asarray(c["valid"][0]),
                             score_threshold=c["score"])
    fi, fv = _dtt_fast(c, block)
    for (ti, tv), (wi, wv) in ((tnms.nms_padded_fast(*args,
                                                     select_block=block),
                                (fi, fv)),
                               (tnms.nms_padded(*args), (ji, jv))):
        np.testing.assert_array_equal(tv[0].numpy(), np.asarray(wv))
        np.testing.assert_array_equal(ti[0].numpy(), np.asarray(wi))
    idx = np.asarray(ji)[np.asarray(jv)]
    zero = idx[c["scores"][0][idx] == 0]
    signs = np.signbit(c["scores"][0][zero])
    assert signs.any() and not signs.all() and (np.diff(zero) > 0).all()
    assert not np.array_equal(np.asarray(fi), np.asarray(ji))


@pytest.mark.parametrize("block", BLOCKS)
def test_nms_below_masked_score_matches_dtt(block):
    """Below a score threshold of -1e10 (masked, retired and suppressed
    boxes live again, scores under -1e10 and -inf among them, every slot
    filled) the plain block loop gives dtt's decisions at each width, and
    at width 1 so does the one-at-a-time loop: the GPU tests hold the
    kernel against them there."""
    c = below_masked_problem()
    ji, jv = _dtt_fast(c, block)
    args = (_t(c["boxes"]), _t(c["scores"]), c["iou"], c["m"],
            _t(c["valid"]), c["score"])
    ti, tv = tnms.nms_padded_fast(*args, select_block=block)
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))
    if block == 1:
        si, sv = tnms.nms_padded(*args)
        np.testing.assert_array_equal(sv.numpy(), tv.numpy())
        np.testing.assert_array_equal(si.numpy(), ti.numpy())


@pytest.mark.parametrize("name", sorted(LONG))
def test_long_walk_problems_walk_past_a_block(name):
    """Each problem's walk goes past the first 1,024 positions of its
    order (the GPU tests hold the kernel on them there), and both plain
    forms agree on it at every width."""
    c = LONG[name]
    args = (_t(c["boxes"]), _t(c["scores"]), c["iou"], c["m"],
            _t(c["valid"]), c["score"])
    si, sv = tnms.nms_padded(*args)
    assert min(walk_end(c, si.numpy(), sv.numpy())) > 1024
    for block in BLOCKS:
        ti, tv = tnms.nms_padded_fast(*args, select_block=block)
        np.testing.assert_array_equal(tv.numpy(), sv.numpy())
        np.testing.assert_array_equal(ti.numpy(), si.numpy())


@pytest.mark.parametrize("name", sorted(LONG))
def test_long_walk_problems_match_dtt(name):
    """The first problem of each against dtt's one-at-a-time loop (6,000
    boxes: too many for dtt's unrolled block form here)."""
    c = LONG[name]
    ji, jv = jnms.nms_padded(jnp.asarray(c["boxes"][0]),
                             jnp.asarray(c["scores"][0]), c["iou"], c["m"],
                             valid=jnp.asarray(c["valid"][0]),
                             score_threshold=c["score"])
    ti, tv = tnms.nms_padded(_t(c["boxes"][:1]), _t(c["scores"][:1]),
                             c["iou"], c["m"], _t(c["valid"][:1]), c["score"])
    np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti[0].numpy(), np.asarray(ji))


@pytest.mark.parametrize("block", [1, 32])
def test_nms_padded_fast_batched_matches_dtt(block):
    """A batch of 6 OHEM-like problems (K = 330, 128 slots), whose loops
    end at different steps, against dtt's vmapped form."""
    c = path_problem("ohem", 6, 330, 128, 0.7, -0.5, seed=3)
    c["valid"][2] = False                          # one ends before a step
    c["m"] = 40
    want = jax.vmap(lambda b, s, v: jnms.nms_padded_fast(
        b, s, c["iou"], c["m"], valid=v, score_threshold=c["score"],
        select_block=block))(jnp.asarray(c["boxes"]),
                             jnp.asarray(c["scores"]),
                             jnp.asarray(c["valid"]))
    got = tnms.nms_padded_fast(_t(c["boxes"]).reshape(2, 3, 330, 4),
                               _t(c["scores"]).reshape(2, 3, 330), c["iou"],
                               c["m"], _t(c["valid"]).reshape(2, 3, 330),
                               c["score"], select_block=block)
    np.testing.assert_array_equal(got[1].reshape(6, -1).numpy(),
                                  np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].reshape(6, -1).numpy(),
                                  np.asarray(want[0]))


@pytest.mark.parametrize("per_class_boxes", [False, True])
@pytest.mark.parametrize("block", [1, 32])
def test_multiclass_nms_select_block_matches_dtt(per_class_boxes, block):
    """Per-class NMS over shared or per-class boxes with tied scores, at
    the given width, against dtt's (per frame)."""
    rng = np.random.RandomState(block)
    nb, k, c = 2, 48, 4
    base = CASES["ties"]["boxes"][0][:k]
    boxes = np.stack([base + np.float32(7 * i) for i in range(nb)])
    if per_class_boxes:
        boxes = np.stack([boxes + np.float32(3 * j) for j in range(c)], 2)
    scores = rng.choice(np.float32([0.9, 0.5, 0.5, 0.2, 1e-4]), (nb, k, c))
    valid = rng.rand(nb, k) > 0.1
    want = [jnms.multiclass_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                0.3, 6, score_threshold=1e-3,
                                valid=jnp.asarray(valid[i]),
                                per_class_boxes=per_class_boxes,
                                select_block=block)
            for i in range(nb)]
    got = tnms.multiclass_nms(_t(boxes), _t(scores), 0.3, 6,
                              score_threshold=1e-3, valid=_t(valid),
                              per_class_boxes=per_class_boxes,
                              select_block=block)
    for j, name in enumerate(("boxes", "scores", "valid", "idx")):
        w = np.stack([np.asarray(x[j]) for x in want])
        if name in ("valid", "idx"):
            np.testing.assert_array_equal(got[j].numpy(), w, err_msg=name)
        else:
            np.testing.assert_allclose(got[j].numpy(), w, **TOL,
                                       err_msg=name)


def _model_configs():
    """Config() at a 64x96 canvas and 5 classes, in both packages."""
    jc = jcfg.Config()
    jc = jc.replace(input=jc.input.replace(canvas_height=64, canvas_width=96),
                    model=jc.model.replace(num_classes=5))
    return jc, tcfg._merge_into(tcfg.Config(), dataclasses.asdict(jc))


@pytest.mark.parametrize("block", [1, 32])
def test_proposal_layer_select_block_matches_dtt(block):
    """Random RPN outputs on a 4x6 map (288 anchors, 200 kept before NMS,
    60 after) through both proposal layers at nms_select_block `block`:
    equal validity, scores within 1e-6 and boxes within 1e-6 relative +
    1e-4 pixels (the decode's exp may differ by an ulp, as in
    test_proposal_layer_matches)."""
    jc, tc = _model_configs()
    rpn = dict(pre_nms_top_n_test=200, post_nms_top_n_test=60,
               nms_select_block=block, min_size=2.0)
    jrpn, trpn = jc.model.rpn.replace(**rpn), tc.model.rpn.replace(**rpn)
    from dtt.core.anchors import grid_anchors_for
    anchors = np.asarray(grid_anchors_for(jc.model.anchors, 4, 6))
    rng = np.random.RandomState(block)
    a = jc.model.anchors.num_anchors
    cls = rng.randn(2, 4, 6, 2 * a).astype(np.float32)
    # two anchors' scores tied everywhere: the ties reach the NMS
    cls[..., 2 * 3:2 * 3 + 2] = cls[..., 0:2]
    bbox = (rng.randn(2, 4, 6, 4 * a) * 0.3).astype(np.float32)
    want = jax.vmap(lambda c, b: j_proposal_layer(
        c, b, jnp.asarray(anchors), 60.0, 90.0, 1.0, jrpn, False))(
        jnp.asarray(cls), jnp.asarray(bbox))
    got = t_proposal_layer(_t(cls), _t(bbox), _t(anchors), 60.0, 90.0, 1.0,
                           trpn)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert 0 < int(got.valid.sum()) < got.valid.numel()
    np.testing.assert_allclose(got.rois.numpy(), np.asarray(want.rois),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               **TOL)


@pytest.mark.parametrize("agnostic", [False, True])
def test_decode_detections_batched_matches_dtt(agnostic):
    """Random detections of 2 frames (96 RoIs, 5 classes) through both
    per-class decodes at select_block 32, with tracking: equal validity,
    boxes, scores and tracked boxes within 1e-6 (1e-4 for pixel
    coordinates)."""
    jc, tc = _model_configs()
    roi = dict(class_agnostic=agnostic)
    jm = jc.model.replace(roi=jc.model.roi.replace(**roi))
    tm = tc.model.replace(roi=tc.model.roi.replace(**roi))
    rng = np.random.RandomState(int(agnostic))
    b, n, nc = 2, 96, 5
    rois = np.stack([CASES["ties"]["boxes"][0][(np.arange(n) + 5 * i) % 64]
                     for i in range(b)])
    logits = rng.randn(b, n, nc).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    db = 8 if agnostic else 4 * nc
    det = dict(rois=rois, roi_valid=rng.rand(b, n) > 0.1,
               cls_prob=prob.astype(np.float32),
               bbox_pred=(rng.randn(b, n, db) * 0.2).astype(np.float32))
    deltas = (rng.randn(b, n, 4) * 0.2).astype(np.float32)
    want = jdnt.decode_detections_batched(
        jm, jdnt.Detections(**{k: jnp.asarray(v) for k, v in det.items()}),
        60.0, 90.0, 1e-3, 0.3, 10, track_deltas=jnp.asarray(deltas),
        select_block=32)
    got = tdnt.decode_detections_batched(
        tm, tdnt.Detections(**{k: _t(v) for k, v in det.items()}),
        60.0, 90.0, 1e-3, 0.3, 10, track_deltas=_t(deltas), select_block=32)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].any()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    for j in (0, 3):
        np.testing.assert_allclose(got[j].numpy(), np.asarray(want[j]),
                                   rtol=1e-6, atol=1e-4)


def test_nms_cuda_refuses_cpu_tensors():
    """The kernel wrapper takes only CUDA tensors; the dispatchers run the
    plain forms on CPU tensors and launch nothing."""
    c = CASES["ties"]
    args = (_t(c["boxes"]), _t(c["scores"]), c["iou"], c["m"], _t(c["valid"]))
    with pytest.raises(ValueError, match="CUDA"):
        tnms.nms_cuda(*args)
    before = tnms.nms_cuda.launches
    tnms.nms_padded(*args)
    tnms.nms_padded_fast(*args, select_block=32)
    tnms.nms_gather(*args)
    assert tnms.nms_cuda.launches == before
