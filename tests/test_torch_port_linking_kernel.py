"""The linking kernel's surroundings on the CPU: the plain form
``link_all_classes_plain`` (what ``dtt_link_tubes`` is held against on the
card) against dtt's ``link_all_classes`` at the eval path's widths (the 30
VID classes, ``max_per_class`` = 20 slots, ``max_tubes_per_class`` = 20
tubes) at T = 16 (tau=1) and T = 8 (tau=2 keyframes); `link_layout` around
its shared-memory limit; the dispatcher taking the plain form for CPU
tensors; and `link_cuda` refusing CPU tensors and bad arguments before it
builds or launches anything.

Decisions (paths, tube validity, claimed detections) are equal exactly;
rescored and tube scores to 1e-6, as in ``test_torch_port_linking.py``
(NaN where dtt has NaN).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dtt.eval.linking import link_all_classes as j_link_all_classes

from dtt_torch.eval import linking as tlink
from dtt_torch.ops import _build
from tests.linking_cases import EVAL_C, EVAL_K, EVAL_N, detections

BOOSTS = ("mean_top_half", "mean", "max")


def _tensors(seed, t, tied=False, c=EVAL_C, n=EVAL_N, nonfinite=False):
    return tuple(torch.from_numpy(x)
                 for x in detections(seed, c=c, t=t, n=n, tied=tied,
                                     nonfinite=nonfinite))


def _against_dtt(args, score_boost):
    kw = dict(max_tubes=EVAL_K, link_iou_weight=1.0, score_boost=score_boost)
    want = j_link_all_classes(*(jnp.asarray(x.numpy()) for x in args), **kw)
    got = tlink.link_all_classes_plain(*args, **kw)
    for name in ("det_idx", "tube_valid", "det_in_tube"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for name in ("rescored", "tube_score"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    return got


@pytest.mark.parametrize("score_boost", BOOSTS)
@pytest.mark.parametrize("t,tied", [(16, False), (8, True)],
                         ids=["tau1_T16", "tau2_T8_tied"])
def test_plain_form_matches_dtt_at_eval_widths(t, tied, score_boost):
    got = _against_dtt(_tensors(7 + t, t, tied), score_boost)
    ok = got.tube_valid.numpy()
    assert ok.any() and not ok[1].any()
    # every tube runs, as in dtt: a class runs out of detections and its
    # later tubes are not ok
    assert not ok[:, -1].all()


@pytest.mark.parametrize("score_boost", BOOSTS)
@pytest.mark.parametrize("t", [16, 2])
def test_plain_form_matches_dtt_on_nonfinite_inputs(t, score_boost):
    """NaN and infinite scores and NaN boxes (`detections(nonfinite=True)`):
    every argmax takes the first NaN, as jnp.argmax, so every path slot
    lies in [0, N); a live NaN score leaves no tube of its class ok; a NaN
    box links with IoU 0."""
    got = _against_dtt(_tensors(8, t, nonfinite=True), score_boost)
    idx = got.det_idx.numpy()
    assert idx.min() >= 0 and idx.max() < EVAL_N
    assert np.isnan(got.tube_score[4].numpy()).all()
    assert not got.tube_valid[4].any()
    assert got.tube_valid[5:8].any(dim=1).all()
    assert np.isnan(got.rescored[0].numpy()).any()


def _fits(t, n):
    sizes = [-(-b // 16) * 16 for b in (8 * n, 4 * t, 4 * (t - 1) * n)]
    return sum(sizes) + tlink._STATIC_SMEM <= _build.SMEM_LIMIT


@pytest.mark.parametrize("n", [1, 20, 45, 300])
def test_link_layout_switches_at_the_shared_limit(n):
    """The backpointers stay in shared memory up to the last T at which
    v, the claimed scores and they fit beside the static 1 KB, and go to
    scratch one frame later; the shared bytes never pass the limit."""
    last = max(t for t in range(1, 60_000 // n + 2) if _fits(t, n))
    shared, past = tlink.link_layout(last, n), tlink.link_layout(last + 1, n)
    assert shared.body == "shared" and shared.n_shared == 3
    assert shared.scratch == 0
    assert past.body == "scratch" and past.n_shared == 2
    assert past.scratch == -(-4 * last * n // 16) * 16
    for lay in (shared, past):
        assert lay.smem % 16 == 0
        assert lay.smem + tlink._STATIC_SMEM <= _build.SMEM_LIMIT


def test_link_layout_at_the_eval_widths_and_past_every_limit():
    """The eval path's snippets sit wholly in shared memory; at N = 20
    the backpointers move to scratch from T = 2,755; a T too long for the
    claimed scores and an N too wide for v move those too, in order."""
    assert tlink.link_layout(16, 20) == tlink.LinkLayout(
        "shared", 160 + 64 + 1200, 0, 3)
    assert tlink.link_layout(1, 20) == tlink.LinkLayout("shared", 176, 0, 3)
    assert tlink.link_layout(2754, 20).body == "shared"
    assert tlink.link_layout(2755, 20).body == "scratch"
    long = tlink.link_layout(60_000, 1)
    assert long.n_shared == 1 and long.smem == 16
    assert long.scratch == 240_000 + 240_000     # 4 * 59,999 padded
    wide = tlink.link_layout(2, 30_000)
    assert wide.n_shared == 0 and wide.smem == 0
    assert wide.scratch == 240_000 + 16 + 120_000


def test_link_layout_agrees_with_the_kernel_source():
    """The limit and the static bytes `link_layout` plans with are the
    kernel's, and so is every kernel source's own shared-memory limit."""
    def constant(name, source):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);",
                             (_build.CSRC / source).read_text()).group(1))
    assert constant("kSmemLimit", "linking.cu") == _build.SMEM_LIMIT
    assert constant("kStaticSmem", "linking.cu") == tlink._STATIC_SMEM
    for source in ("correlation.cu", "psroi.cu"):
        assert constant("kMaxSmem", source) == _build.SMEM_LIMIT, source


def test_dispatcher_takes_the_plain_form_for_cpu_tensors(monkeypatch):
    """CPU tensors go to the plain form and never to the kernel's
    wrapper; the one-class `link_tubes` goes the same way."""
    def no_kernel(*a, **k):
        raise AssertionError("link_cuda was called for CPU tensors")
    monkeypatch.setattr(tlink, "link_cuda", no_kernel)
    args = _tensors(3, 8)
    got = tlink.link_all_classes(*args, max_tubes=4, score_boost="mean")
    want = tlink.link_all_classes_plain(*args, max_tubes=4,
                                        score_boost="mean")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    one = tlink.link_tubes(*(x[0] for x in args), max_tubes=4,
                           score_boost="mean")
    for g, w in zip(one, want):
        assert torch.equal(g, w[0])


def test_link_cuda_refuses_cpu_tensors_and_bad_arguments(monkeypatch):
    """Each refusal names what is wrong and comes before any build or
    launch (this host has no nvcc: a build would raise otherwise)."""
    def no_build():
        raise AssertionError("link_cuda reached the build")
    monkeypatch.setattr(tlink, "_entry", no_build)
    boxes, scores, tracked, valid = _tensors(4, 3, c=4, n=5)
    before = tlink.link_cuda.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        tlink.link_cuda(boxes, scores, tracked, valid)
    with pytest.raises(ValueError, match="tube_score_boost"):
        tlink.link_cuda(boxes, scores, tracked, valid, score_boost="median")
    with pytest.raises(ValueError, match=r"\(C, T, N, 4\)"):
        tlink.link_cuda(boxes[..., :3], scores, tracked, valid)
    with pytest.raises(ValueError, match=r"\(C, T, N, 4\)"):
        tlink.link_cuda(boxes, scores, tracked[:, :2], valid)
    with pytest.raises(ValueError, match=r"\(C, T, N\)"):
        tlink.link_cuda(boxes, scores[:, :, :4], tracked, valid)
    with pytest.raises(ValueError, match=r"\(C, T, N\)"):
        tlink.link_cuda(boxes, scores, tracked, valid[0])
    with pytest.raises(TypeError, match="float32"):
        tlink.link_cuda(boxes.double(), scores, tracked, valid)
    with pytest.raises(TypeError, match="valid bool"):
        tlink.link_cuda(boxes, scores, tracked, valid.float())
    with pytest.raises(TypeError, match="a number"):
        tlink.link_cuda(boxes, scores, tracked, valid,
                        link_iou_weight=torch.tensor(1.0))
    with pytest.raises(ValueError, match="max_tubes 0"):
        tlink.link_cuda(boxes, scores, tracked, valid, max_tubes=0)
    with pytest.raises(ValueError, match="T 0"):
        tlink.link_cuda(boxes[:, :0], scores[:, :0], tracked[:, :0],
                        valid[:, :0])
    assert tlink.link_cuda.launches == before
