"""The tube-linking kernel ``dtt_link_tubes`` held against the plain form
``link_all_classes_plain`` on a CUDA card: paths, tube validity, tube
scores and claimed detections bit for bit, rescored scores to 1e-6 (the
boost's sum is taken in another order), under every ``score_boost``, on
the problems of ``tests/linking_cases.py``: the eval path's widths (30
classes, 20 slots, 20 tubes) at T = 16 and T = 8 with and without tied
scores and at T = 16 with NaN and infinite inputs (NaN where the plain
form has NaN), N = 45, T = 1, and a T long enough that the backpointers
take the scratch layout; then a T so long that the claimed scores take it too, one
launch a call, the same bits every run, and a call that cannot launch
raises. Marked ``gpu``: they skip without a card. This file imports no
JAX:

    python -m pytest --noconftest -q tests/test_torch_port_linking_gpu.py
"""

import os
import sys

import pytest
import torch

from dtt_torch.eval import linking as tlink

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from linking_cases import detections, kernel_cases  # noqa: E402

pytestmark = pytest.mark.gpu

BOOSTS = ("mean_top_half", "mean", "max")
CASES = {name: (kw, k) for name, kw, k in kernel_cases()}
EXACT = ("det_idx", "tube_valid", "tube_score", "det_in_tube")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(kw, device):
    return tuple(torch.from_numpy(x).to(device) for x in detections(**kw))


def _check(args, k, boost, weight=1.0):
    before = tlink.link_cuda.launches
    got = tlink.link_all_classes(*args, max_tubes=k, link_iou_weight=weight,
                                 score_boost=boost)
    torch.cuda.synchronize()
    assert tlink.link_cuda.launches == before + 1
    want = tlink.link_all_classes_plain(*args, max_tubes=k,
                                        link_iou_weight=weight,
                                        score_boost=boost)
    for name in EXACT:
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if g.is_floating_point():
            assert torch.equal(g.isnan(), w.isnan()), name
            g, w = g.nan_to_num(0.0), w.nan_to_num(0.0)
        assert torch.equal(g, w), name
    torch.testing.assert_close(got.rescored, want.rescored, rtol=1e-6,
                               atol=1e-6, equal_nan=True)
    return got


@pytest.mark.parametrize("boost", BOOSTS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_link_kernel_matches_plain(cuda, name, boost):
    kw, k = CASES[name]
    got = _check(_on(kw, cuda), k, boost)
    assert got.tube_valid.any() and not got.tube_valid[1].any()
    assert got.det_idx.min() >= 0 and got.det_idx.max() < kw["n"]
    if kw.get("nonfinite"):
        assert not got.tube_valid[4].any() and got.tube_score[4].isnan().all()
    if name == "scratch":
        assert tlink.link_layout(kw["t"], kw["n"]).body == "scratch"


def test_link_kernel_takes_another_iou_weight(cuda):
    kw, k = CASES["eval_tau1"]
    _check(_on(kw, cuda), k, "mean_top_half", weight=1.5)


def test_link_kernel_keeps_the_claimed_scores_in_scratch(cuda):
    """58,000 frames of 2 slots: the claimed scores pass a block's shared
    memory and join the backpointers in scratch (only v stays)."""
    kw = dict(seed=9, c=4, t=58_000, n=2)
    assert tlink.link_layout(kw["t"], kw["n"]).n_shared == 1
    _check(_on(kw, cuda), 2, "mean_top_half")


def test_link_kernel_is_deterministic(cuda):
    kw, k = CASES["eval_tau1_tied"]
    args = _on(kw, cuda)
    first = tlink.link_cuda(*args, max_tubes=k)
    for _ in range(3):
        again = tlink.link_cuda(*args, max_tubes=k)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_link_call_that_cannot_launch_raises(cuda, monkeypatch):
    """A launch error raises and never returns the plain result; so does
    a build failure; float64 scores are refused."""
    kw, k = CASES["eval_tau2"]
    args = _on(kw, cuda)
    monkeypatch.setattr(tlink, "_entry", lambda: (lambda *a: 98))
    before = tlink.link_cuda.launches
    with pytest.raises(RuntimeError, match="cudaError 98"):
        tlink.link_all_classes(*args, max_tubes=k)

    def no_build():
        raise RuntimeError("nvcc failed for linking")
    monkeypatch.setattr(tlink, "_entry", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tlink.link_tubes(*(x[0] for x in args), max_tubes=k)
    assert tlink.link_cuda.launches == before
    monkeypatch.undo()
    with pytest.raises(TypeError, match="float32"):
        tlink.link_all_classes(args[0], args[1].double(), *args[2:])
