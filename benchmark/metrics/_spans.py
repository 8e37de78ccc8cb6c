"""The program's own spans and counters over the traced stretch: the
``Record`` that ``dtt_torch.utils.profiling`` keeps of the stretch a
``torch.profiler`` recorded (``profiled()``: the program follows the
device trace's profiler by itself), or None where the program has no
such recorder. The video step's programs are named ``video step trunk``
and ``video step post-trunk`` (``video step`` as one program)."""


def record(r):
    """The traced stretch's Record: None without a trace, without a
    recorder that follows the profiler, or where the Record it gives did
    not start inside the stretch (``perf_counter`` on both)."""
    tr = r.trace
    if tr is None or tr.t0 is None or tr.t1 is None:
        return None
    from dtt_torch.utils import profiling
    profiled = getattr(profiling, "profiled", None)
    rec = None if profiled is None else profiled()
    if rec is None or not tr.t0 * 1e9 <= rec.start <= tr.t1 * 1e9:
        return None
    return rec


def video_step(rec, span) -> bool:
    """Whether `span` is a call of the video step's programs."""
    return span.name == "program.call" and (span.label or "").startswith(
        "video step")


def chunks(rec) -> int:
    return rec.counts.get("video.chunks", 0)


def ms_per_chunk(r, keep):
    """Host ms a chunk of the stretch's spans that `keep(rec, span)`
    takes; None without a Record or a chunk."""
    rec = record(r)
    if rec is None or not chunks(rec):
        return None
    return sum(s.end - s.start for s in rec.spans
               if keep(rec, s)) / 1e6 / chunks(rec)


def overlap_us(intervals, a: float, b: float) -> float:
    """The length of [a, b] that the union of (start, end) `intervals`
    covers, in their unit."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        s, e = max(s, a, end), min(e, b)
        if e > s:
            total += e - s
        end = max(end, e)
    return total
