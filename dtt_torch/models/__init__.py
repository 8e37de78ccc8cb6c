"""ResNet trunk, RPN, targets and the D&T model: video-mode inference,
training and single-frame detection."""

from dtt_torch.models.dnt import (Detections, DnT, FrameFeats,
                                  decode_frame_detections, detect_frame,
                                  make_model, rfcn_head, track_rois)

__all__ = [
    "Detections", "DnT", "FrameFeats", "decode_frame_detections",
    "detect_frame", "make_model", "rfcn_head", "track_rois",
]
