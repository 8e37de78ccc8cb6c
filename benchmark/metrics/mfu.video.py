"""The whole video step's share of the card's bf16 peak: the model FLOP
of the pairs the window completed (``benchmark/flops.py``) over the
window's seconds times 989 TFLOP/s."""

from benchmark import flops, roofline


def read(r):
    w = r.window
    if not w["pairs"]:
        return None
    return (100 * w["pairs"] * flops.video_pair_flop(r.cfg)
            / (w["window_s"] * roofline.BF16_OPS_PER_S))
