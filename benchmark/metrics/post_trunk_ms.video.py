"""Device ms a chunk of the kernels that the post-trunk program's
replays run (correlation, head maps, proposals and NMS, PSRoI pools,
per-class decode and NMS)."""

from benchmark.cells import load_module


def read(r):
    return load_module("metrics", "_programs", r.root).per_chunk(r, 1)
