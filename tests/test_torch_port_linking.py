"""dtt_torch's tube linking held against dtt's on the CPU:
``link_all_classes`` (repeated Viterbi over padded per-frame detections,
virtual skip slots on empty frames, tube rescoring) on random detections
made with numpy from a seed and given to both packages.

The discrete results (paths, tube validity, claimed detections) must be
equal. Both sides add the same float32 terms in the same order, so the
rescored scores and tube scores agree to float32 roundoff (1e-6; they
are sums of a few scores below 1, or multiples of -1e9 divided by T-1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtt.eval.linking import link_all_classes as j_link_all_classes

from dtt_torch.eval.linking import link_all_classes
from tests.linking_cases import detections as _detections


@pytest.mark.parametrize("score_boost", ["mean_top_half", "mean", "max"])
@pytest.mark.parametrize("seed,t,tied", [(0, 7, False), (1, 7, True),
                                         (2, 1, False)])
def test_link_all_classes_matches_dtt(score_boost, seed, t, tied):
    boxes, scores, tracked, valid = _detections(seed, t=t, tied=tied)
    kw = dict(max_tubes=6, link_iou_weight=1.5, score_boost=score_boost)
    want = j_link_all_classes(*(jnp.asarray(x) for x in
                                (boxes, scores, tracked, valid)), **kw)
    got = link_all_classes(*(torch.from_numpy(x) for x in
                             (boxes, scores, tracked, valid)), **kw)
    for name in ("det_idx", "tube_valid", "det_in_tube"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for name in ("rescored", "tube_score"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    ok = got.tube_valid.numpy()
    assert not ok[1].any()               # nothing to link in class 1
    assert ok.any()
    # claimed detections were valid, and only they were rescored
    in_tube = got.det_in_tube.numpy()
    assert not (in_tube & ~valid).any()
    np.testing.assert_array_equal(got.rescored.numpy()[~in_tube],
                                  scores[~in_tube])


def test_link_all_classes_refuses_unknown_boost():
    boxes, scores, tracked, valid = (torch.from_numpy(x) for x in
                                     _detections(0, t=3))
    with pytest.raises(ValueError, match="tube_score_boost"):
        link_all_classes(boxes, scores, tracked, valid, score_boost="median")
