"""ResNet trunk, RPN, targets and the D&T model: video-mode inference,
training and single-frame detection."""

from dtt_torch.models.resnet import (ResNetBackbone, resnet101, resnet50,
                                     tiny_resnet)
from dtt_torch.models.rpn import (Proposals, RPNHead, proposal_layer,
                                  rpn_loss, smooth_l1)
from dtt_torch.models.targets import (AnchorTargets, RoITargets,
                                      anchor_target, label_all_rois,
                                      proposal_target)
from dtt_torch.models.dnt import (Detections, DnT, FrameFeats,
                                  decode_frame_detections, detect_frame,
                                  make_model, rfcn_head, track_rois)

__all__ = [
    "ResNetBackbone", "resnet101", "resnet50", "tiny_resnet",
    "RPNHead", "Proposals", "proposal_layer", "rpn_loss", "smooth_l1",
    "AnchorTargets", "RoITargets", "anchor_target", "label_all_rois",
    "proposal_target",
    "Detections", "DnT", "FrameFeats", "decode_frame_detections",
    "detect_frame", "make_model", "rfcn_head", "track_rois",
]
