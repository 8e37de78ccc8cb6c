"""The linking kernel's surroundings on the CPU: the plain form
``link_all_classes_plain`` (what ``dtt_link_tubes`` is held against on the
card) against dtt's ``link_all_classes`` at the eval path's widths (the 30
VID classes, ``max_per_class`` = 20 slots, ``max_tubes_per_class`` = 20
tubes) at T = 16 (tau=1) and T = 8 (tau=2 keyframes); `link_layout` around
its shared-memory limit and against the kernel source's constants; the
one-buffer upload and read-back of `link_snippet`; the dispatcher taking
the plain form for CPU tensors; and `link_cuda` refusing CPU tensors and
bad arguments before it builds or launches anything.

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
from tests.linking_cases import (EVAL_C, EVAL_K, EVAL_N, W_SCRATCH_T,
                                 detections, kernel_cases)

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


def _fits(t, n, ring=False, leave=0):
    return (sum(tlink._array_bytes(t, n, ring)[leave:]) + tlink._STATIC_SMEM
            <= _build.SMEM_LIMIT)


@pytest.mark.parametrize("n", [1, 20, 45, 300])
def test_link_layout_switches_at_the_shared_limit(n):
    """Every array stays in shared memory up to the last T at which they all
    fit beside the static bytes; one frame later the link weights go to
    scratch (and the links with them at n = 300); once the links must go
    too, a ring of four of their frames takes shared memory where it fits
    (not at n = 300); the shared bytes never pass the limit."""
    sizes = tlink._array_bytes
    last = max(t for t in range(1, 60_000 // n + 2) if _fits(t, n))
    links = min(t for t in range(last + 1, 60_000 // n + 3)
                if not _fits(t, n, leave=1))
    shared, past = tlink.link_layout(last, n), tlink.link_layout(last + 1, n)
    assert shared.body == "shared" and shared.n_shared == 9
    assert shared.scratch == 0 and shared.in_scratch == ()
    assert not shared.ring and shared.smem == sum(sizes(last, n, False))
    assert past.body == "scratch"
    assert past.in_scratch[0] == "link weights"
    assert len(past.in_scratch) == (1 if links > last + 1 else 2)
    assert past.scratch >= sizes(last + 1, n, False)[0]
    assert sizes(last + 1, n, False)[0] == last * 4 * n * (-(-n // 4) * 4 | 4)
    both = tlink.link_layout(links, n)
    assert both.in_scratch == ("link weights", "links")
    assert both.ring == (n < 300) and both.n_shared == 7
    assert both.smem == sum(sizes(links, n, both.ring)[2:])
    for lay in (shared, past, both):
        assert lay.smem % 16 == 0 and lay.scratch % 16 == 0
        assert lay.smem + tlink._STATIC_SMEM <= _build.SMEM_LIMIT


def test_link_layout_at_the_eval_widths_and_past_every_limit():
    """The eval path's snippets sit wholly in shared memory; at N = 20 the
    links leave it from T = W_SCRATCH_T (the `w_scratch` case) and a
    VID-length snippet keeps everything else there beside their ring;
    longer T and wider N move the claimed scores, p, the backpointers, the
    live words, the path and v after the links, in that order, and a wide
    N takes int32 backpointers and no ring. The sizes are written out here
    (W, the links, the claimed scores, p, the backpointers, the live
    words, the path, v, the ring's four frames and mbarriers)."""
    assert tlink.link_layout(16, 20) == tlink.LinkLayout(
        "shared", 2 * 24000 + 2048 + 1280 + 304 + 64 + 16 + 160, 0, 9, (),
        False)
    assert tlink.link_layout(1, 20) == tlink.LinkLayout(
        "shared", 128 + 80 + 16 + 16 + 160, 0, 9, (), False)
    assert len(tlink.link_layout(W_SCRATCH_T - 1, 20).in_scratch) == 1
    assert tlink.link_layout(W_SCRATCH_T, 20).in_scratch == (
        "link weights", "links")
    assert tlink.link_layout(300, 20) == tlink.LinkLayout(
        "scratch", 38400 + 24000 + 5984 + 1200 + 304 + 160 + 4 * 1600 + 32,
        2 * 299 * 1600, 7, ("link weights", "links"), True)
    assert tlink.link_layout(1400, 45).in_scratch == (
        "link weights", "links", "claimed scores", "p")
    long = tlink.link_layout(60_000, 1)
    assert long.n_shared == 3 and long.smem == 60_000 + 32 + 4 * 16 + 32
    assert long.in_scratch == tlink._ARRAYS[:6]
    wide = tlink.link_layout(2, 30_000)
    assert wide.n_shared == 1 and wide.smem == 0 and not wide.ring
    assert wide.in_scratch == tlink._ARRAYS[:-1]
    frame = 30_000 * 30_004 * 4
    assert wide.scratch == (2 * frame + 256 + 240_000 + 4 * 30_000
                            + 7504 + 16 + 240_000)  # int32 backpointers
    n300 = tlink.link_layout(4, 300)                # the `n300` case
    assert n300.in_scratch == ("link weights", "links") and not n300.ring


def test_link_layout_agrees_with_the_kernel_source():
    """The limit, the static bytes, the block's threads, the narrow
    backpointers' reach, v's bytes a slot, the ring's frames and the
    arrays' order that `link_layout` plans with are the kernel's, and so is
    every kernel source's own shared-memory limit."""
    source = (_build.CSRC / "linking.cu").read_text()

    def constant(name, text=source):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);",
                             text).group(1))
    assert constant("kSmemLimit") == _build.SMEM_LIMIT
    assert constant("kStaticSmem") == tlink._STATIC_SMEM
    assert constant("kThreads") == tlink._THREADS
    assert constant("kNarrowBack") == tlink._NARROW_BACK
    assert constant("kSlotBytes") == tlink._SLOT_BYTES
    assert constant("kRing") == tlink._RING
    assert constant("kArrays") == len(tlink._ARRAYS)
    order = re.findall(r"b\[(\d)\] = .*;\s*// (.+)", source)
    assert [int(i) for i, _ in order] == list(range(len(tlink._ARRAYS)))
    assert tuple(name.strip() for _, name in order) == tlink._ARRAYS
    for other in ("correlation.cu", "psroi.cu"):
        text = (_build.CSRC / other).read_text()
        assert constant("kMaxSmem", text) == _build.SMEM_LIMIT, other


def test_w_scratch_case_is_the_first_length_past_shared_memory():
    """`linking_cases.W_SCRATCH_T` is where the links leave shared memory
    at the eval path's N, so the `w_scratch` kernel case sits just past
    it."""
    assert not _fits(W_SCRATCH_T, EVAL_N, leave=1)
    assert _fits(W_SCRATCH_T - 1, EVAL_N, leave=1)
    cases = {name: kw for name, kw, _ in kernel_cases()}
    assert cases["w_scratch"]["t"] == W_SCRATCH_T
    assert cases["w_scratch"]["n"] == EVAL_N
    assert tlink.link_layout(cases["vid_len"]["t"], EVAL_N).body == "scratch"
    assert tlink.link_layout(16, cases["n33"]["n"]).body == "shared"


@pytest.mark.parametrize("shape", [(4, 7, 5), (30, 16, 20), (1, 1, 1)])
def test_to_device_packs_one_buffer(shape):
    """`link_snippet`'s upload: the four arrays, equal to what was given, as
    views of one buffer at 16-byte aligned offsets (one copy to a card);
    linking them gives the unpacked arrays' result."""
    c, t, n = shape
    arrays = detections(5, c=max(c, 4), t=t, n=n)
    arrays = tuple(a[:c] for a in arrays)
    got = tlink.to_device(arrays, "cpu")
    store = got[0].untyped_storage().data_ptr()
    for g, a in zip(got, arrays):
        np.testing.assert_array_equal(g.numpy(), a)
        assert g.untyped_storage().data_ptr() == store
        assert g.storage_offset() * g.element_size() % 16 == 0
    want = tlink.link_all_classes_plain(*(torch.from_numpy(a)
                                          for a in arrays), max_tubes=3)
    for g, w in zip(tlink.link_all_classes(*got, max_tubes=3), want):
        assert torch.equal(g, w)
    host = tlink.tubes_numpy(want)
    for h, w in zip(host, want):
        assert isinstance(h, np.ndarray)
        np.testing.assert_array_equal(h, w.numpy())


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
