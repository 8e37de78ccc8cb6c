"""Snippet inference (video and tau-strided pair steps, serial and
data-parallel), single-frame detection, tube linking and VID mAP."""

from dtt_torch.eval.linking import Tubes, link_all_classes, link_tubes
from dtt_torch.eval.vid_eval import (average_precision, det_arrays,
                                     det_tuples, eval_class, eval_detections)
from dtt_torch.eval.inference import (evaluate_snippet, interpolate_tubes,
                                      link_snippet, make_pair_step,
                                      make_pair_step_parallel,
                                      make_single_frame_step,
                                      make_video_step,
                                      make_video_step_parallel)

__all__ = ["Tubes", "link_all_classes", "link_tubes", "average_precision",
           "det_arrays", "det_tuples",
           "eval_class", "eval_detections", "evaluate_snippet",
           "interpolate_tubes", "link_snippet", "make_pair_step",
           "make_single_frame_step", "make_pair_step_parallel",
           "make_video_step", "make_video_step_parallel"]
