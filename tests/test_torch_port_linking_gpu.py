"""The tube-linking kernel ``dtt_link_tubes`` held against the plain form
``link_all_classes_plain`` on a CUDA card: paths, tube validity, tube
scores and claimed detections bit for bit, rescored scores to 1e-6 (the
boost's sum is taken in another order), under every ``score_boost``, on
the problems of ``tests/linking_cases.py``: the eval path's widths (30
classes, 20 slots, 20 tubes) at T = 16 and T = 8 with and without tied
scores, at T = 16 with NaN and infinite inputs (NaN where the plain form
has NaN) and at T = 300 (a VID val snippet's length: the links in
scratch), N = 45 and N = 33, N = 300 (int32 backpointers, the links in
scratch), T = 1, T just past where the links leave shared memory (also
with NaN and infinite inputs), and a T long enough that the scores leave it too; then a T so long that the live
words leave it as well, `link_layout`'s sizes against the kernel's own,
one launch a call, one read-back of the five outputs, the same bits every
run, a call that cannot launch raises, and each instance's SASS holds the
tame vote's block reduction once. Marked ``gpu``: they skip
without a card. This file imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_port_linking_gpu.py
"""

import ctypes
import os
import re
import subprocess
import sys

import pytest
import torch

from dtt_torch.eval import linking as tlink
from dtt_torch.ops import _build

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
    lay = tlink.link_layout(kw["t"], kw["n"])
    if name in ("vid_len", "w_scratch", "w_scratch_nonfinite", "n300"):
        assert lay.in_scratch == ("link weights", "links")
        # n300: int32 backpointers, and the links read from scratch with
        # no ring (one frame of them is 360 KB)
        assert lay.ring is (name != "n300")
    if name == "n300":
        assert kw["n"] > tlink._NARROW_BACK
    if name == "scratch":
        assert lay.in_scratch == ("link weights", "links", "claimed scores",
                                  "p")


def test_link_kernel_takes_another_iou_weight(cuda):
    kw, k = CASES["eval_tau1"]
    _check(_on(kw, cuda), k, "mean_top_half", weight=1.5)


def test_link_kernel_keeps_the_claimed_scores_in_scratch(cuda):
    """58,000 frames of 2 slots: the claimed scores, p, the backpointers
    and the live words pass a block's shared memory and join the link
    weights and the links in scratch (only the path, v and the links' ring
    stay)."""
    kw = dict(seed=9, c=4, t=58_000, n=2)
    lay = tlink.link_layout(kw["t"], kw["n"])
    assert lay.in_scratch == tlink._ARRAYS[:6] and lay.ring
    _check(_on(kw, cuda), 2, "mean_top_half")


def test_link_layout_sizes_are_the_kernels(cuda):
    """`link_layout` plans with the kernel's own array sizes
    (``dtt_link_array_bytes``), with the ring and without, across the
    narrow and int32 backpointers, one and two live words and odd
    strides."""
    fn = _build.load("linking").dtt_link_array_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int64)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int64 * len(tlink._ARRAYS))()
    for t in (1, 2, 7, 16, 69, 128, 300, 1400, 58_000):
        for n in (1, 2, 3, 20, 31, 32, 33, 45, 255, 256, 300, 30_000):
            for ring in (False, True):
                assert fn(t, n, ring, out) == len(tlink._ARRAYS)
                assert tuple(out) == tlink._array_bytes(t, n, ring), (
                    t, n, ring)
    assert fn(0, 20, 0, out) == -1 and fn(16, 0, 0, out) == -1


def test_link_snippet_copies_once_each_way(cuda, monkeypatch):
    """`to_device` copies the four inputs up as one buffer and `link_cuda`'s
    five outputs, views of one device buffer, come back by one copy in
    `tubes_numpy`, twice in a row (pinned buffers the caching host
    allocator hands out again); through them the kernel's result equals
    the plain form's on the card."""
    kw, k = CASES["eval_tau1"]
    arrays = detections(**kw)
    want = tlink.link_all_classes_plain(*_on(kw, cuda), max_tubes=k)
    ups, downs = [], []
    to, copy = torch.Tensor.to, torch.Tensor.copy_

    def counted_to(x, *a, **kw):
        out = to(x, *a, **kw)
        if out.is_cuda and not x.is_cuda:
            ups.append(x.numel())
        return out

    def counted_copy(x, src, *a, **kw):
        if src.is_cuda and not x.is_cuda:
            downs.append(src.numel())
        return copy(x, src, *a, **kw)
    for _ in range(2):
        monkeypatch.setattr(torch.Tensor, "to", counted_to)
        args = tlink.to_device(arrays, cuda)
        monkeypatch.undo()
        assert len(ups) == 1 and len({x.untyped_storage().data_ptr()
                                      for x in args}) == 1
        got = tlink.link_cuda(*args, max_tubes=k)
        assert len({x.untyped_storage().data_ptr() for x in got}) == 1
        monkeypatch.setattr(torch.Tensor, "copy_", counted_copy)
        host = tlink.tubes_numpy(got)
        monkeypatch.undo()
        assert len(downs) == 1
        ups.clear()
        downs.clear()
        for name in EXACT:
            torch.testing.assert_close(torch.from_numpy(getattr(host, name)),
                                       getattr(want, name).cpu(), rtol=0,
                                       atol=0, equal_nan=True)
        torch.testing.assert_close(torch.from_numpy(host.rescored),
                                   want.rescored.cpu(), rtol=1e-6, atol=1e-6,
                                   equal_nan=True)


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


def test_link_kernel_reduces_the_vote_once(cuda):
    """Each instance of ``link_kernel`` in the built library runs one block
    reduction (``BAR.RED``, the tame vote's ``__syncthreads_and``). Where
    the vote reduces a constant, ptxas (CUDA 12.9, -O1 to -O3) gave the
    scratch instances a second copy on warp 0's path at the head of the
    tubes' loop, which meets the other warps' ``__syncthreads`` and stops
    the kernel on an illegal instruction (S1;
    ``tools/sanitize_linking_torch.py --routes``)."""
    _build.load("linking")
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(_build.library_path("linking"))],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
        elif name and "link_kernel" in name and "BAR.RED" in line:
            counts[name] = counts.get(name, 0) + 1
    assert len(counts) == 4, counts        # uint8 / int32 x shared / scratch
    assert set(counts.values()) == {1}, counts
