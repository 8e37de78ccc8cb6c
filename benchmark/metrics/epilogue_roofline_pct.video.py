"""Kernel 10's (``dtt_conv_epilogue``: its device kernels
``epilogue_fwd_vec`` and ``epilogue_fwd_scalar``) share of its roofline
in the video chunks: the frozen bound of one trunk call's epilogues at the
chunk's frames (``benchmark/roofline.py``), over the kernel's device ms a
chunk in the traced stretch."""

from benchmark import roofline


def read(r):
    tr = r.trace
    if tr is None:
        return None
    us = sum(e - s for n, s, e, _ in tr.kernels
             if "epilogue_fwd" in n)
    chunks = len([1 for n, _, _, _ in tr.runtime
                  if n.startswith("cudaGraphLaunch")]) // 2
    if not us or not chunks:
        return None
    inp, m = r.cfg["input"], r.cfg["model"]
    calls = roofline.epilogue_calls(m["backbone"], r.traffic["chunk"],
                                    inp["canvas_height"], inp["canvas_width"])
    return 100 * roofline.epilogue_bound_ms(calls) / (us / 1e3 / chunks)
