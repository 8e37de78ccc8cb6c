"""MiB of host memory pinned afresh a chunk to upload it: the program's
``program.pinned_bytes`` counter over ``video.chunks`` over 2**20, in the
traced stretch (0 where nothing had to be pinned)."""

from benchmark.cells import load_module


def read(r):
    s = load_module("metrics", "_spans", r.root)
    rec = s.record(r)
    if rec is None or not s.chunks(rec):
        return None
    return rec.counts.get("program.pinned_bytes", 0) / s.chunks(rec) / 2**20
