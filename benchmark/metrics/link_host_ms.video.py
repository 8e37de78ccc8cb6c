"""Host ms a snippet inside ``link_snippet`` (its upload, the linking
kernel and the read-back to numpy): the program's ``link`` spans, their
mean over the traced stretch. The program's own counterpart of
``link_ms.video``, which the benchmark times around the call."""

from benchmark.cells import load_module


def read(r):
    rec = load_module("metrics", "_spans", r.root).record(r)
    spans = [] if rec is None else rec.named("link")
    if not spans:
        return None
    return sum(s.end - s.start for s in spans) / 1e6 / len(spans)
