"""Host ms a chunk from the video step's call to its return: the chunk's
copy-in and the programs' launch (the benchmark's span around the step
it hands to ``evaluate_snippet_video``), the mean over the window."""


def read(r):
    ms = r.spans.ms("dispatch")
    return sum(ms) / len(ms) if ms else None
