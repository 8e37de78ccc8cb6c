"""Host ms a snippet of ``link_snippet`` (its upload, the linking kernel
and the read-back to numpy), the mean over the window."""


def read(r):
    ms = r.spans.ms("link")
    return sum(ms) / len(ms) if ms else None
