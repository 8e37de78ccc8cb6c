"""Host ms a chunk that the video step's programs spend copying their
arguments into their buffers (pinning the chunk's host frames and
enqueueing the uploads): the ``program.copy_in`` spans under the video
step's calls over ``video.chunks``, in the traced stretch."""

from benchmark.cells import load_module


def read(r):
    s = load_module("metrics", "_spans", r.root)
    return s.ms_per_chunk(
        r, lambda rec, x: x.name == "program.copy_in"
        and x.parent is not None and s.video_step(rec, rec.spans[x.parent]))
