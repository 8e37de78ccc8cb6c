"""The readers of the program's own spans and counters (the six host
metrics of the video cell) on hand-made Records and device intervals, and
the program's Record of a stretch that the benchmark's device trace
profiled: its spans on the trace's clock, the trace itself unchanged by
them, and nothing from a program that does not follow the profiler."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from conftest import ROOT

from dtt_torch.utils.profiling import Record, Span

MS = 1_000_000       # ns
READERS = ("gather_ms.video", "step_host_ms.video", "copy_in_ms.video",
           "pinned_mib.video", "link_host_ms.video", "gather_idle_pct.video")


def _read(name: str, reading):
    from benchmark import cells
    return cells.load_module("metrics", name, ROOT).read(reading)


def _trace(monkeypatch, kernels_ms, window_s, program):
    """A device trace with kernels at (start, end) ms over the stretch
    [0, `window_s`] s, and `program` as the program's Record of it, on
    the clock on which its spans stand at their ns / 1e3."""
    from benchmark.trace import DeviceTrace
    from dtt_torch.utils import profiling
    tr = DeviceTrace()
    tr.kernels = [("k", s * 1e3, e * 1e3, i)
                  for i, (s, e) in enumerate(kernels_ms)]
    tr.t0, tr.t1 = 0.0, window_s
    monkeypatch.setattr(profiling, "profiled", lambda: program)
    return tr


def _record(spans, counts, start_ms=0) -> Record:
    """A Record begun at `start_ms` of `spans` [(name, label, start ms,
    end ms, parent)] whose profiler clock is its ns / 1e3."""
    rec = Record()
    rec.start, rec.offset = int(start_ms * MS), 0
    rec.spans = [Span(n, lab, int(s * MS), int(e * MS), p, 1, 0)
                 for n, lab, s, e, p in spans]
    rec.counts = dict(counts)
    return rec


def _chunks_record() -> Record:
    """Two chunks of a snippet and its linking: gathers of 30 and 50 ms,
    each chunk's two program calls with their copy-ins, 64 MiB pinned
    each, and a 12 ms link."""
    trunk, post = "video step trunk", "video step post-trunk"
    return _record([
        ("video.snippet", None, 0, 200, None),           # 0
        ("video.gather", None, 0, 30, 0),                # 1
        ("program.call", trunk, 30, 36, 0),              # 2
        ("program.copy_in", None, 30, 34, 2),            # 3
        ("program.replay", None, 34, 36, 2),             # 4
        ("program.call", post, 36, 38, 0),               # 5
        ("program.copy_in", None, 36, 37, 5),            # 6
        ("video.gather", None, 40, 90, 0),               # 7
        ("program.call", trunk, 90, 100, 0),             # 8
        ("program.copy_in", None, 90, 96, 8),            # 9
        ("program.call", post, 100, 102, 0),             # 10
        ("program.copy_in", None, 100, 101, 10),         # 11
        ("program.call", "pair step trunk", 102, 190, 0),  # 12: not video
        ("program.copy_in", None, 102, 180, 12),         # 13: not video
        ("link", None, 200, 212, None),                  # 14
        ("link.kernel", None, 201, 211, 14),             # 15
    ], {"video.chunks": 2, "program.pinned_bytes": 128 * 2**20})


def test_host_readers_on_a_hand_made_record(monkeypatch):
    r = SimpleNamespace(trace=_trace(monkeypatch, [(0, 10)], 0.3,
                                     _chunks_record()),
                        root=ROOT)
    assert _read("gather_ms.video", r) == pytest.approx(40.0)
    assert _read("step_host_ms.video", r) == pytest.approx(10.0)
    assert _read("copy_in_ms.video", r) == pytest.approx(6.0)
    assert _read("pinned_mib.video", r) == pytest.approx(64.0)
    assert _read("link_host_ms.video", r) == pytest.approx(12.0)


def test_pinned_mib_reads_zero_where_nothing_was_pinned(monkeypatch):
    rec = _chunks_record()
    del rec.counts["program.pinned_bytes"]
    r = SimpleNamespace(trace=_trace(monkeypatch, [(0, 10)], 0.3, rec),
                        root=ROOT)
    assert _read("pinned_mib.video", r) == 0.0


@pytest.mark.parametrize("busy, gathers, window_s, want", [
    # busy 0-10 and 30-40 ms, a gather 5-35 ms: 20 of 40 ms idle in it
    ([(0, 10), (30, 40)], [(5, 35)], 0.04, 50.0),
    # overlapping kernels count once; two gathers, one idle throughout
    ([(0, 20), (5, 15), (60, 80)], [(10, 30), (40, 50)], 0.1, 20.0),
    # the device busy all through the gather
    ([(0, 100)], [(10, 90)], 0.1, 0.0),
])
def test_gather_idle_pct(monkeypatch, busy, gathers, window_s, want):
    rec = _record([("video.gather", None, s, e, None) for s, e in gathers],
                  {"video.chunks": len(gathers)})
    r = SimpleNamespace(trace=_trace(monkeypatch, busy, window_s, rec),
                        root=ROOT)
    assert _read("gather_idle_pct.video", r) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_a_record(monkeypatch, name):
    """No trace, no Record, an empty one, or one begun outside the
    traced stretch (a profiler's of another stretch): None."""
    assert _read(name, SimpleNamespace(trace=None, root=ROOT)) is None
    for rec in (None, _record([], {}),
                _record([("video.gather", None, 400, 430, None)],
                        {"video.chunks": 1}, start_ms=400)):
        tr = _trace(monkeypatch, [(0, 10)], 0.1, rec)
        assert _read(name, SimpleNamespace(trace=tr, root=ROOT)) is None


def _cpu_trace(monkeypatch):
    """A DeviceTrace that runs on the CPU (no synchronize)."""
    import torch
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    from benchmark.trace import DeviceTrace
    return DeviceTrace()


def _profiled_snippet():
    """The spans of a snippet's gather, a program call and a link, with
    the benchmark's own annotation around the snippet."""
    import time

    from torch.profiler import record_function

    from dtt_torch.utils.profiling import count, span
    with record_function("bench.snippet"):
        with span("video.snippet", request=True):
            with span("video.gather"):
                time.sleep(0.02)
            count("video.chunks")
            with span("program.call", "video step trunk"):
                time.sleep(0.01)
    with span("link"):
        pass


def test_the_program_records_the_stretch_the_trace_profiles(monkeypatch):
    """Under the benchmark's device trace the program follows the
    profiler: its Record of the stretch holds the spans and counts, on
    the trace's clock (its snippet within 1 ms of the benchmark's
    annotation around it), the trace itself holds no ``dtt.`` event, and
    the readers read the Record."""
    from torch.profiler import record_function

    from dtt_torch.utils import profiling
    with record_function("warm"):    # the process's first sets itself up
        pass
    tr = _cpu_trace(monkeypatch)
    tr.start()
    _profiled_snippet()
    tr.stop()
    with profiling.span("after"):    # the profiler stopped: not recorded
        pass
    rec = profiling.profiled()
    assert [s.name for s in rec.spans] == [
        "video.snippet", "video.gather", "program.call", "link"]
    assert rec.counts == {"video.chunks": 1}
    assert tr.t0 * 1e9 <= rec.start and rec.end <= tr.t1 * 1e9 + 1e9
    (bench,) = [(s, e) for n, s, e in tr.annotations if n == "bench.snippet"]
    (mine,) = rec.named("video.snippet")
    start, end = rec.profiler_us(mine.start), rec.profiler_us(mine.end)
    assert 0 <= start - bench[0] < 1e3 and 0 <= bench[1] - end < 1e3
    assert [n for n, *_ in tr.annotations] == ["bench.snippet"]
    tr.kernels = [("k", start - 50, start - 10, 1)]
    r = SimpleNamespace(trace=tr, root=ROOT)
    assert _read("gather_ms.video", r) == pytest.approx(20.0, abs=5.0)
    assert _read("step_host_ms.video", r) == pytest.approx(10.0, abs=5.0)
    assert _read("link_host_ms.video", r) >= 0


def test_a_program_without_the_recorder_leaves_the_readers_empty(
        monkeypatch):
    """Where the program has no recorder that follows the profiler (the
    program before it had one), the readers give None and the trace is
    as it always was."""
    from dtt_torch.utils import profiling
    monkeypatch.delattr(profiling, "profiled")
    tr = _cpu_trace(monkeypatch)
    tr.start()
    tr.stop()
    assert tr.annotations == []
    tr.kernels = [("k", 0.0, 10.0, 1)]
    for name in READERS:
        assert _read(name, SimpleNamespace(trace=tr, root=ROOT)) is None


@pytest.mark.gpu
def test_the_programs_spans_are_no_device_work(cuda):
    """On the card the program's spans under the benchmark's trace add
    no event to it (no ``dtt.`` range on the device's timeline, where the
    trace would take it for a kernel), and the Record holds them."""
    import torch

    from benchmark.trace import DeviceTrace
    from dtt_torch.utils import profiling
    from dtt_torch.utils.profiling import span
    x = torch.ones(4096, 4096, device=cuda)
    tr = DeviceTrace()
    tr.start()
    with span("video.snippet", request=True):
        with span("program.replay"):
            for _ in range(4):
                x = x @ x / 4096
    tr.stop()
    assert not [k for k in tr.kernels + tr.copies if k[0].startswith("dtt.")]
    assert tr.kernels and tr.annotations == []
    rec = profiling.profiled()
    assert [s.name for s in rec.spans] == ["video.snippet", "program.replay"]
    assert tr.t0 * 1e9 <= rec.start <= tr.t1 * 1e9
