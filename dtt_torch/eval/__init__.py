"""Snippet inference (video and tau-strided pair steps), single-frame
detection, tube linking and VID mAP."""

from dtt_torch.eval.inference import make_single_frame_step

__all__ = ["make_single_frame_step"]
