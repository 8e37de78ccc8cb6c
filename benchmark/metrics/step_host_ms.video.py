"""Host ms a chunk inside the video step's programs (both calls, the
trunk's and the post-trunk stage's: copy-in, replay, copy-out): the
program's ``program.call`` spans of the video step over ``video.chunks``,
in the traced stretch. The program's own counterpart of
``dispatch_ms.video``, which the benchmark times around the step."""

from benchmark.cells import load_module


def read(r):
    s = load_module("metrics", "_spans", r.root)
    return s.ms_per_chunk(r, s.video_step)
