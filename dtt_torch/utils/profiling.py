"""Profiling helpers (counterpart of ``dtt.utils.profiling``): a device
trace by ``torch.profiler``, the port's span-and-counter recorder and a step
timer that waits for the device before it reads the clock.

The recorder
------------
``span(name)`` times a block and ``count(name, n)`` adds to a counter. Both
do nothing while no recording is on and no ``torch.profiler`` records: off,
a span is a module-level check and a read of the profiler's flag that
return a shared no-op context, and a count is the same two checks; neither
allocates. ``start_recording()`` switches recording on and returns the
``Record`` that ``stop_recording()`` fills and returns (``recording()`` is
the two as a context). Recordings nest: an inner one gets the spans begun
and the counts added while it ran, and recording stays on until the
outermost stops. There is no environment variable and no config key.

A ``torch.profiler`` that records while no recording is on is followed:
the first span or count it sees starts a recording, and the first one
after the profiler stopped (or ``profiled()``) stops it; ``profiled()``
returns that Record, the program's spans and counts over the profiled
stretch. So a tool that traces the device gets the program's spans without
switching anything in the program. Such a recording does not put its spans
into the profiler's own timeline (below), so the profiler's device events
stay the device's work alone.

A recorded span keeps its name, an optional label (a program's name), its
start and end (``time.perf_counter_ns``), the index of its parent (the span
open around it on the same thread: each thread keeps its own stack, since
loader threads run beside the main one), its thread and a request id. A span
opened with ``request=True`` starts a new request unless one around it on
its thread already did; every other span takes the request of the span
around it, and a span with none around it the request last started on its
thread. So the detection of a snippet (``video.snippet``) and its linking
(``link``, called after it on the same thread) share an id. A span begun
before its recording started is not kept, and one still open when its
recording stops is dropped (a child it had becomes a root).
``Record.self_ns`` gives each span's duration less its children's.

While a ``torch.profiler`` records and a recording that ``start_recording``
started is on, each span also enters ``record_function("dtt.<name>")``, so
the profiler's timeline shows the program's spans (``device_trace``
records for its block); on a card the profiler also draws each such range
on the device's timeline, around the kernels it launched. One clock: a
``Record`` reads ``time.time_ns()`` beside ``perf_counter_ns()`` once, when
it starts, and ``Record.profiler_us`` puts a span on the profiler's clock
(microseconds of ``time.time_ns()``), the clock on which the profiler
places kernels and copies.

Spans and counters of the port, and who reads them:

* ``video.snippet`` (request), its children ``video.gather`` (a chunk's
  frames stacked on the host: on CUDA into a pinned staging slot),
  ``video.fetch`` (a chunk's outputs read back: on CUDA the wait on its
  slot's event and the copy out) and the video step's programs' spans;
  ``video.chunks`` counts the chunks and ``video.staged`` those that went
  through a staging slot (``dtt_torch.eval.inference``);
* ``program.call`` (labelled with the program's name) with its children
  ``program.copy_in``, ``program.replay`` (on the CPU ``program.run``, the
  direct call of the step) and ``program.copy_out``;
  ``program.pinned_bytes`` counts the host bytes pinned afresh to upload
  them (``dtt_torch.utils.programs``);
* ``link`` with ``link.upload``, ``link.kernel`` and ``link.readback``
  (``link_snippet``);
* ``eval.detect`` (request), ``eval.interpolate+nms``,
  ``eval.eval_detections`` and the counter ``eval.decode_ms``, the phases
  of ``eval_torch.py``'s ``wall ms`` line.

The benchmark's per-layer metrics of the video cell read the video, program
and link spans and counters of its traced stretch (``profiled()``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

import torch

_now = time.perf_counter_ns


def _synchronize(result) -> None:
    """Wait for the device work behind `result` (a tensor or a nest of
    them): every CUDA device a tensor of it lies on."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(result)
    for d in devices:
        torch.cuda.synchronize(d)


# ---------------------------------------------------------------- recorder

class Span(NamedTuple):
    """One recorded span: times in ``perf_counter_ns``; `parent` indexes
    the Record's spans (None for a root)."""
    name: str
    label: str | None
    start: int
    end: int
    parent: int | None
    request: int | None
    thread: int


class Record:
    """What one recording kept: ``spans`` in the order they began, the
    ``counts`` added while it ran, and its ``start`` and ``end``
    (``perf_counter_ns``). Filled when the recording stops."""

    def __init__(self):
        self.start = _now()
        self.offset = time.time_ns() - self.start
        self.end = None
        self.spans: list[Span] = []
        self.counts: dict = {}

    def profiler_us(self, t_ns: int) -> float:
        """A ``perf_counter_ns`` time on the profiler's clock, in us."""
        return (t_ns + self.offset) / 1e3

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def ms(self, name: str) -> float:
        """Total ms of the spans called `name`."""
        return sum(s.end - s.start for s in self.named(name)) / 1e6

    def self_ns(self) -> list:
        """Each span's duration less the part its children cover (a
        thread's spans nest, so its children's durations)."""
        out = [s.end - s.start for s in self.spans]
        for s in self.spans:
            if s.parent is not None:
                out[s.parent] -= s.end - s.start
        return out


class _Recorder:
    """The spans and counts of the recordings that are on. A span is a
    list [name, label, start, end, parent, request, thread] until it
    closes (end None while open). `follower` is the recording that
    follows a profiler, always the outermost."""

    def __init__(self):
        self.spans: list = []
        self.counts: dict = {}
        self.lock = threading.Lock()
        self.local = threading.local()
        self.requests = 0
        self.open: list = []   # (Record, first span index, counts then)
        self.follower: Record | None = None

    def thread(self):
        """This thread's stack of open spans [(index, request, in a
        request)] and its last request."""
        t = self.local
        if not hasattr(t, "stack"):
            t.stack, t.last = [], None
        return t

    def marks(self) -> bool:
        """Whether a recording that ``start_recording`` started is on."""
        return len(self.open) > (self.follower is not None)


class _Off:
    """The shared context of a span while no recording is on."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_recorder: _Recorder | None = None
_profiled: Record | None = None    # the last followed profiler's stretch
_follow_lock = threading.Lock()
_OFF = _Off()
_profiling = torch._C._autograd._profiler_enabled


def _active() -> _Recorder | None:
    """The recorder a span or a count goes to now: None while off; a
    profiler that records with nothing on is followed from here on, and
    one that stopped is no longer."""
    rec = _recorder
    if rec is None:
        return _follow() if _profiling() else None
    if rec.follower is not None and not rec.marks() and not _profiling():
        _unfollow()
        return _recorder
    return rec


def _follow() -> _Recorder | None:
    """Start the recording that follows the profiler."""
    with _follow_lock:
        if _recorder is None:
            record = start_recording()
            _recorder.follower = record
        return _recorder


def _unfollow() -> None:
    """Stop the recording that followed a profiler, once it is the only
    one on; keep its Record for ``profiled()``."""
    global _profiled
    with _follow_lock:
        rec = _recorder
        if rec is not None and rec.follower is not None and not rec.marks():
            _profiled = _stop(rec)


class _Span:
    __slots__ = ("rec", "name", "label", "request", "index", "rf")

    def __init__(self, rec, name, label, request):
        self.rec, self.name, self.label = rec, name, label
        self.request = request

    def __enter__(self):
        rec = self.rec
        t = rec.thread()
        if t.stack:
            parent, request, inside = t.stack[-1]
        else:
            parent, request, inside = None, t.last, False
        with rec.lock:
            if self.request and not inside:
                rec.requests += 1
                request = t.last = rec.requests
            self.index = len(rec.spans)
            rec.spans.append([self.name, self.label, 0, None, parent,
                              request, threading.get_ident()])
        t.stack.append((self.index, request, inside or self.request))
        rec.spans[self.index][2] = _now()
        self.rf = None
        if rec.marks() and _profiling():
            self.rf = torch.profiler.record_function("dtt." + self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        self.rec.spans[self.index][3] = _now()
        self.rec.thread().stack.pop()
        return False


def span(name: str, label: str | None = None, request: bool = False):
    """A context that records the block as the span `name` while a
    recording is on or a profiler records (see the module docstring); a
    shared no-op otherwise. `label` rides on the span; ``request=True``
    marks the root of a request."""
    if _recorder is None and not _profiling():
        return _OFF
    rec = _active()
    if rec is None:
        return _OFF
    return _Span(rec, name, label, request)


annotate = span  # with annotate("step"): ...


def count(name: str, n=1) -> None:
    """Add `n` to the counter `name` while a recording is on or a
    profiler records."""
    if _recorder is None and not _profiling():
        return
    rec = _active()
    if rec is None:
        return
    with rec.lock:
        rec.counts[name] = rec.counts.get(name, 0) + n


def start_recording() -> Record:
    """Switch recording on (or open a recording inside one that is on);
    returns the Record that ``stop_recording`` fills."""
    global _recorder
    if _recorder is None:
        _recorder = _Recorder()
    rec = _recorder
    record = Record()
    with rec.lock:
        rec.open.append((record, len(rec.spans), dict(rec.counts)))
    return record


def stop_recording() -> Record:
    """Stop the innermost recording that ``start_recording`` started and
    return its Record: the spans that began and closed while it ran
    (their parents re-indexed; a parent outside it makes a root) and the
    counts added meanwhile. Recording goes off with the outermost."""
    rec = _recorder
    if rec is None or not rec.marks():
        raise RuntimeError("stop_recording: no recording is on")
    return _stop(rec)


def _stop(rec: _Recorder) -> Record:
    global _recorder
    end = _now()
    with rec.lock:
        record, first, counts = rec.open.pop()
        raw = [list(s) for s in rec.spans[first:]]
        now = dict(rec.counts)
        if not rec.open:
            _recorder = None
    kept = {}
    for i, (name, label, start, stop, parent, request, thread) in \
            enumerate(raw, first):
        if stop is None or start < record.start:
            continue
        kept[i] = len(record.spans)
        record.spans.append(Span(name, label, start, stop, kept.get(parent),
                                 request, thread))
    record.counts = {k: v - counts.get(k, 0) for k, v in now.items()
                     if k not in counts or v != counts[k]}
    record.end = end
    return record


@contextlib.contextmanager
def recording():
    """``with recording() as record:`` records the block; `record` is
    filled when the block ends."""
    record = start_recording()
    try:
        yield record
    finally:
        stop_recording()


def profiled() -> Record | None:
    """The Record of the last stretch a ``torch.profiler`` recorded with
    no recording on (the module docstring), once the profiler has
    stopped; None before any."""
    rec = _recorder
    if rec is not None and rec.follower is not None and not _profiling():
        _unfollow()
    return _profiled


# ---------------------------------------------------------------- traces

@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record everything inside the block with ``torch.profiler`` (the
    CUDA activity too where a card is present), the program's spans among
    it, and write a trace that TensorBoard's profile plugin reads under
    `log_dir`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    with prof, recording():
        yield prof


class StepTimer:
    """Wall-clock timer that waits for the device's results (honest step
    times); the first `warmup` steps are not kept."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._times: list[float] = []
        self._seen = 0

    @contextlib.contextmanager
    def step(self, result_to_block=None):
        t0 = time.perf_counter()
        yield
        if result_to_block is not None:
            _synchronize(result_to_block)
        self._seen += 1
        if self._seen > self.warmup:
            self._times.append(time.perf_counter() - t0)

    def time_fn(self, fn, *args, iters: int = 10):
        """Mean seconds of `fn(*args)` over `iters` calls after one."""
        _synchronize(fn(*args))
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        _synchronize(out)
        return (time.perf_counter() - t0) / iters

    @property
    def mean(self) -> float:
        return sum(self._times) / max(len(self._times), 1)

    def summary(self) -> dict:
        if not self._times:
            return {"steps": 0}
        ts = sorted(self._times)
        return {
            "steps": len(ts),
            "mean_s": self.mean,
            "p50_s": ts[len(ts) // 2],
            "p95_s": ts[int(len(ts) * 0.95)],
        }
