"""Device ms a chunk of the kernels that the trunk program's replays
run (ResNet trunk, its conv epilogues, the RPN and reduce convs)."""

from benchmark.cells import load_module


def read(r):
    return load_module("metrics", "_programs", r.root).per_chunk(r, 0)
