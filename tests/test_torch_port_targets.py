"""dtt_torch's target assignment held against dtt's on the CPU:
``anchor_target``, ``proposal_target`` and ``label_all_rois`` on the same
boxes, with the uniforms JAX draws from dtt's keys handed to the port
(``Draws``), so both packages sample the same anchors and RoIs.

Labels, validity and selected boxes must be equal; regression targets and
weights are float32 arithmetic in the same order (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtt.core.anchors import grid_anchors_for
from dtt.core.config import Config as JConfig
from dtt.data.synthetic import sample_pair_params
from dtt.models import targets as jt

from dtt_torch.core.config import Config as TConfig
from dtt_torch.models import targets as tt

TOL = dict(rtol=1e-5, atol=1e-5)
B, G = 3, 6
FEAT_HW = (8, 12)            # a 128x192 canvas at stride 16
SCALES = (1.0, 2.0, 4.0)     # anchors that fit the small canvas


def _t(x):
    return torch.from_numpy(np.array(x))


def _frames(rng):
    """B frames of track-aligned gt (frame t and the other frame), two of
    them on a canvas only partly filled by the image."""
    h, w = FEAT_HW[0] * 16, FEAT_HW[1] * 16
    ps = [sample_pair_params(rng, h, w, 8, G, num_objects=(1, G))
          for _ in range(B)]
    gt_boxes = np.stack([p["gt_boxes"] for p in ps])     # (B, 2, G, 4)
    gt_valid = np.stack([p["gt_valid"] for p in ps])
    gt_valid[0, 1, 0] = False                            # a track that leaves
    gt_labels = np.stack([p["gt_labels"] for p in ps]).astype(np.int64)
    sizes = np.array([[h, w], [h - 20, w - 36], [h - 8, w]], np.float32)
    return gt_boxes, gt_valid, gt_labels, sizes


def _uniforms(key, n):
    """Per frame, the two uniforms dtt's target functions draw from the
    frame's key: split(key) -> uniform(k0, (n,)), uniform(k1, (n,))."""
    keys = jax.vmap(jax.random.split)(key)               # (B, 2, 2)
    draw = jax.vmap(lambda k: jax.random.uniform(k, (n,)))
    return keys, np.asarray(draw(keys[:, 0])), np.asarray(draw(keys[:, 1]))


@pytest.mark.parametrize("seed", [0, 1])
def test_anchor_target_matches(seed):
    cfg = JConfig().model.rpn
    anchors = grid_anchors_for(JConfig().model.anchors.replace(scales=SCALES),
                               *FEAT_HW)
    gt_boxes, gt_valid, _, sizes = _frames(np.random.RandomState(seed))
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    _, u_pos, u_neg = _uniforms(keys, anchors.shape[0])
    want = jax.vmap(lambda gb, gv, hh, ww, k: jt.anchor_target(
        jnp.asarray(anchors), gb, gv, hh, ww, k, cfg))(
        jnp.asarray(gt_boxes[:, 0]), jnp.asarray(gt_valid[:, 0]),
        jnp.asarray(sizes[:, 0]), jnp.asarray(sizes[:, 1]), keys)
    got = tt.anchor_target(_t(anchors), _t(gt_boxes[:, 0]),
                           _t(gt_valid[:, 0]), _t(sizes[:, 0]),
                           _t(sizes[:, 1]), _t(u_pos), _t(u_neg),
                           TConfig().model.rpn)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert (got.labels == 1).any() and (got.labels == 0).any()
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(want.bbox_targets), **TOL)
    np.testing.assert_allclose(got.bbox_weights.numpy(),
                               np.asarray(want.bbox_weights), **TOL)


def _proposals(rng, gt_boxes, r=40):
    """RoIs around the gt boxes (jittered copies, so IoUs span the fg and
    bg bands) plus random boxes, some slots invalid."""
    rois = []
    for f in range(B):
        g = gt_boxes[f][rng.randint(0, G, r)]
        jitter = rng.uniform(-30, 30, (r, 4)).astype(np.float32)
        near = g + jitter * rng.uniform(0, 1, (r, 1)).astype(np.float32)
        x1 = rng.uniform(0, 150, r)
        y1 = rng.uniform(0, 100, r)
        far = np.stack([x1, y1, x1 + rng.uniform(4, 60, r),
                        y1 + rng.uniform(4, 40, r)], 1)
        pick = rng.rand(r)[:, None] < 0.7
        box = np.where(pick, near, far)
        rois.append(np.concatenate([np.minimum(box[:, :2], box[:, 2:]),
                                    np.maximum(box[:, :2], box[:, 2:])], 1))
    valid = rng.rand(B, r) > 0.15
    return np.stack(rois).astype(np.float32), valid


@pytest.mark.parametrize("track", [True, False])
def test_proposal_target_matches(track):
    rng = np.random.RandomState(3)
    gt_boxes, gt_valid, gt_labels, _ = _frames(rng)
    rois, valid = _proposals(rng, gt_boxes[:, 0])
    jcfg, tcfg = JConfig().model, TConfig().model
    jcfg = jcfg.replace(roi=jcfg.roi.replace(batch_size=44))
    tcfg = tcfg.replace(roi=tcfg.roi.replace(batch_size=44))
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    _, u_fg, u_slot = _uniforms(keys, rois.shape[1] + G)
    args = (rois, valid, gt_boxes[:, 0], gt_labels, gt_valid[:, 0],
            gt_boxes[:, 1], gt_valid[:, 1])
    want = jax.vmap(lambda *a: jt.proposal_target(
        *a, jcfg.roi, jcfg.track if track else None))(
        *[jnp.asarray(a) for a in args], keys)
    got = tt.proposal_target(*[_t(a) for a in args], _t(u_fg), _t(u_slot),
                             tcfg.roi, tcfg.track if track else None)
    _assert_roi_targets(got, want)
    assert (got.labels > 0).any() and (got.valid & (got.labels == 0)).any()
    assert not got.valid.all()          # a short bg supply leaves slots


def test_label_all_rois_matches():
    rng = np.random.RandomState(4)
    gt_boxes, gt_valid, gt_labels, _ = _frames(rng)
    rois, valid = _proposals(rng, gt_boxes[:, 0])
    jcfg, tcfg = JConfig().model, TConfig().model
    args = (rois, valid, gt_boxes[:, 0], gt_labels, gt_valid[:, 0],
            gt_boxes[:, 1], gt_valid[:, 1])
    want = jax.vmap(lambda *a: jt.label_all_rois(*a, jcfg.roi, jcfg.track))(
        *[jnp.asarray(a) for a in args])
    got = tt.label_all_rois(*[_t(a) for a in args], tcfg.roi, tcfg.track)
    _assert_roi_targets(got, want)
    assert (got.track_weights > 0).any()


def _assert_roi_targets(got, want):
    for name in ("labels", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got.rois.numpy(), np.asarray(want.rois))
    for name in ("bbox_targets", "bbox_weights", "track_targets",
                 "track_weights"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), **TOL,
                                   err_msg=name)


def test_sample_draws_shapes():
    """One uniform per anchor and per candidate RoI of each frame."""
    cfg = TConfig()
    d = tt.sample_draws(cfg, 2, torch.Generator().manual_seed(0))
    a = 38 * 68 * cfg.model.anchors.num_anchors
    r = cfg.model.rpn.post_nms_top_n_train + cfg.input.max_gt_boxes
    assert d.anchor_pos.shape == d.anchor_neg.shape == (2, 2, a)
    assert d.roi_fg.shape == d.roi_slot.shape == (2, 2, r)
    assert 0 <= float(d.anchor_pos.min()) and float(d.roi_slot.max()) < 1
