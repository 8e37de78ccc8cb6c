"""Kernel 1's (``dtt_correlation``, with its channel-split form: the
device kernels named ``correlation...`` but the backward's) share of its
roofline in the video chunks: the frozen bound of a chunk's
correlation forward (chunk - 1 pairs at three scales,
``benchmark/roofline.py``), over those kernels' device ms a chunk."""

from benchmark import roofline
from benchmark.reference.dnt import corr_channels


def read(r):
    tr = r.trace
    if tr is None:
        return None
    us = sum(e - s for n, s, e, _ in tr.kernels
             if "correlation" in n and "bwd" not in n)
    chunks = len([1 for n, _, _, _ in tr.runtime
                  if n.startswith("cudaGraphLaunch")]) // 2
    if not us or not chunks:
        return None
    inp, m = r.cfg["input"], r.cfg["model"]
    s = m["anchors"]["feat_stride"]
    chans = {"c3": 512, "c4": 1024, "c5": m["reduced_channels"]}
    bound = roofline.corr_bound_ms(
        r.traffic["chunk"] - 1, inp["canvas_height"] // s,
        inp["canvas_width"] // s, [chans[k] for k in m["track"]["scales"]],
        corr_channels(m))
    return 100 * bound / (us / 1e3 / chunks)
