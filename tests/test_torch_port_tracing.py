"""The port's span-and-counter recorder (``dtt_torch.utils.profiling``) on
a tiny CPU video step: nothing recorded while off, the snippet loop's,
the programs' and linking's spans and counters with their parents and
request ids, self times, the spans a recording keeps at its edges, the
threads' own stacks, and the recorder's clock against the profiler's.
Imports no JAX."""

import math
import sys
import threading

import numpy as np
import pytest
import torch

from dtt_torch.eval.inference import (evaluate_snippet_video, link_snippet,
                                      make_video_step)
from dtt_torch.utils import profiling
from dtt_torch.utils.params import from_jax_params, init_jax_params
from dtt_torch.utils.profiling import (count, recording, span,
                                       start_recording, stop_recording)
from tests.test_torch_port_programs_gpu import H, W, _tiny

CHUNK = 4
PROGRAMS = ("video step trunk", "video step post-trunk")


@pytest.fixture(scope="module")
def video():
    cfg = _tiny()
    model = from_jax_params(init_jax_params(cfg.model, seed=1), cfg.model,
                            "cpu")
    return cfg, make_video_step(cfg, model, CHUNK, device="cpu")


def _frames(n: int) -> np.ndarray:
    return np.random.RandomState(n).randint(0, 256, (n, H, W, 3)).astype(
        np.uint8)


def _snippet(cfg, step, frames):
    boxes, scores, valid, tracked = evaluate_snippet_video(
        cfg, step, frames, im_hw=(56, 80))
    link_snippet(cfg, boxes, scores, tracked, valid, device="cpu")


def test_nothing_is_recorded_while_off(video):
    """Off, every span is the one shared no-op and a snippet leaves
    nothing behind for a recording that starts after it."""
    cfg, step = video
    profiling.profiled()     # ends a recording that followed a profiler
    assert profiling._recorder is None
    assert span("video.gather") is span("link", "label")
    _snippet(cfg, step, _frames(5))
    count("video.chunks", 3)
    record = start_recording()
    assert stop_recording() is record
    assert record.spans == [] and record.counts == {}
    assert profiling._recorder is None


@pytest.mark.parametrize("t_len", [3, 6, 7])
def test_snippet_spans_counters_parents_and_requests(video, t_len):
    """A snippet of T frames in chunks of f: ``video.chunks`` is
    ceil(T / (f - 1)) (f - 1 pairs a chunk, T pairs with the last frame's
    identity pair); one gather, one fetch and one call of each program a
    chunk, each under the snippet; each program call's copy-in, run and (where it
    copies) copy-out under it; linking's three spans under ``link``,
    which shares the snippet's request; self times non-negative, adding
    up to each root's duration."""
    cfg, step = video
    with recording() as rec:
        _snippet(cfg, step, _frames(t_len))
    chunks = math.ceil(t_len / (CHUNK - 1))
    assert rec.counts == {"video.chunks": chunks}
    names = [s.name for s in rec.spans]
    (root,) = [i for i, n in enumerate(names) if n == "video.snippet"]
    (link,) = [i for i, n in enumerate(names) if n == "link"]
    assert rec.spans[root].parent is None and rec.spans[link].parent is None
    assert names.count("video.gather") == chunks
    assert names.count("video.fetch") == chunks
    assert sorted(s.label for s in rec.named("program.call")) == sorted(
        PROGRAMS * chunks)
    for i, s in enumerate(rec.spans):
        parent = None if s.parent is None else rec.spans[s.parent].name
        want = {"video.gather": "video.snippet",
                "video.fetch": "video.snippet",
                "program.call": "video.snippet",
                "program.copy_in": "program.call",
                "program.run": "program.call",
                "program.copy_out": "program.call",
                "link.upload": "link", "link.kernel": "link",
                "link.readback": "link"}.get(s.name)
        assert parent == want, (s.name, parent)
        assert s.request == rec.spans[root].request is not None
    # the program each copy-in, run and copy-out belongs to
    children = {n: [rec.spans[s.parent].label for s in rec.spans
                    if s.name == n]
                for n in ("program.copy_in", "program.run",
                          "program.copy_out")}
    assert sorted(children["program.copy_in"]) == sorted(PROGRAMS * chunks)
    assert sorted(children["program.run"]) == sorted(PROGRAMS * chunks)
    # the trunk hands its buffers on uncopied
    assert children["program.copy_out"] == [PROGRAMS[1]] * chunks
    own = rec.self_ns()
    assert min(own) >= 0

    def tree(i):
        return [i] + [j for j, s in enumerate(rec.spans) if s.parent == i
                      for j in tree(j)]

    for r in (root, link):
        s = rec.spans[r]
        assert sum(own[j] for j in tree(r)) == s.end - s.start
    assert rec.start <= rec.spans[0].start and rec.spans[-1].end <= rec.end


def test_recording_edges_and_nesting():
    """A span begun before its recording started is not kept (its child
    becomes a root); one still open at the stop is dropped; an outer
    recording keeps everything, an inner one its own part; the counts are
    the ones added while each ran."""
    outer = start_recording()
    count("c", 2)
    with span("a", request=True):
        inner = start_recording()
        count("c")
        with span("b"):
            pass
        with span("open"):
            assert stop_recording() is inner
    assert stop_recording() is outer
    assert [(s.name, s.parent) for s in inner.spans] == [("b", None)]
    assert inner.counts == {"c": 1}
    assert [(s.name, s.parent) for s in outer.spans] == [
        ("a", None), ("b", 0), ("open", 0)]
    assert outer.counts == {"c": 3}
    assert len({s.request for s in outer.spans}) == 1
    with pytest.raises(RuntimeError):
        stop_recording()


def test_threads_keep_their_own_stacks():
    """Spans on several threads at once (more threads than cores, a short
    switch interval): each span's parent is on its own thread, and none
    is lost."""
    threads, per = 8, 200
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording() as rec:
            def work():
                for _ in range(per):
                    with span("outer", request=True):
                        with span("inner"):
                            count("n")
            ts = [threading.Thread(target=work) for _ in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(before)
    assert rec.counts == {"n": threads * per}
    inner = [s for s in rec.spans if s.name == "inner"]
    assert len(inner) == threads * per
    for s in inner:
        p = rec.spans[s.parent]
        assert p.name == "outer" and p.thread == s.thread
        assert p.request == s.request
    assert len({s.request for s in rec.spans}) == threads * per


def test_spans_on_the_profilers_clock():
    """Under a CPU ``torch.profiler`` each span is also the event
    ``dtt.<name>``, and the Record puts its start within 1 ms of that
    event's on the profiler's clock (after a first span: the process's
    first ``record_function`` sets itself up inside the span)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recording() as rec:
            with span("first"):
                pass
            for i in range(5):
                with span("probe"):
                    torch.ones(64).sum()
    events = sorted(e.start_ns()
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "dtt.probe")
    spans = rec.named("probe")
    assert len(events) == len(spans) == 5
    for e, s in zip(events, spans):
        assert 0 <= e - rec.profiler_us(s.start) * 1e3 < 1e6


def test_a_profiler_with_no_recording_on_is_followed(video):
    """A ``torch.profiler`` that records while no recording is on: the
    snippet's spans and counts go to ``profiled()``'s Record once the
    profiler stops, none of them into the profiler's timeline; a span
    after the stop is not recorded; ``stop_recording`` has nothing of its
    own to stop meanwhile; a recording started inside the profiled
    stretch gets its own part and marks it in the timeline."""
    from torch.profiler import ProfilerActivity, profile
    cfg, step = video
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _snippet(cfg, step, _frames(6))
        with pytest.raises(RuntimeError):
            stop_recording()
        with recording() as inner:
            with span("inside"):
                pass
    with span("after"):
        pass
    assert profiling._recorder is None
    rec = profiling.profiled()
    assert rec.counts == {"video.chunks": math.ceil(6 / (CHUNK - 1))}
    names = [s.name for s in rec.spans]
    assert names[0] == "video.snippet" and names[-1] == "inside"
    assert "link" in names and "after" not in names
    assert [s.name for s in inner.spans] == ["inside"]
    events = {e.name() for e in prof.profiler.kineto_results.events()
              if e.name().startswith("dtt.")}
    assert events == {"dtt.inside"}
    assert profiling.profiled() is rec
