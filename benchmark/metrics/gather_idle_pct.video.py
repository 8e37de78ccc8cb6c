"""The share of the traced stretch in which the device runs nothing (no
kernel, copy or set: the union ``device_idle_pct.video`` takes) while the
host is inside a ``video.gather`` span of the program: the card waiting
on the snippet loop's stacking of a chunk's frames. The spans are put
on the trace's clock by the program's Record."""

from benchmark.cells import load_module


def read(r):
    s = load_module("metrics", "_spans", r.root)
    rec = s.record(r)
    tr = r.trace
    if rec is None or not s.chunks(rec) or not tr.kernels:
        return None
    busy = tr.device_intervals()
    idle_us = 0.0
    for g in rec.named("video.gather"):
        a, b = rec.profiler_us(g.start), rec.profiler_us(g.end)
        idle_us += (b - a) - s.overlap_us(busy, a, b)
    return 100 * idle_us / 1e6 / tr.window_s
