"""Host ms a chunk that the snippet loop spends stacking the chunk's
frames into one array before the step's call: the program's
``video.gather`` spans over its ``video.chunks`` counter, in the traced
stretch."""

from benchmark.cells import load_module


def read(r):
    return load_module("metrics", "_spans", r.root).ms_per_chunk(
        r, lambda rec, s: s.name == "video.gather")
