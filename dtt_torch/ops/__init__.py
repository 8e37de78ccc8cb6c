"""Correlation, PSRoI pooling, the RoI ops, NMS and the trunk's conv
epilogue: plain PyTorch versions and CUDA kernel wrappers. Importing
builds nothing: each kernel is built at its first launch.

The names of ``dtt.ops``, except the dispatcher ``correlation``: it stays
in its module ``dtt_torch.ops.correlation``, whose name it would shadow
here.
"""

from dtt_torch.ops.nms import (multiclass_nms, nms_gather, nms_padded,
                               nms_padded_fast)
from dtt_torch.ops.psroi import psroi_pool, psroi_pool_pallas, psroi_pool_xla
from dtt_torch.ops.correlation import (correlation_pallas, correlation_xla,
                                       num_corr_channels)
from dtt_torch.ops.epilogue import conv_epilogue, conv_epilogue_plain
from dtt_torch.ops.roi_ops import (bilinear_sample, roi_align, roi_crop,
                                   roi_pool)

__all__ = [
    "multiclass_nms", "nms_gather", "nms_padded", "nms_padded_fast",
    "psroi_pool", "psroi_pool_pallas", "psroi_pool_xla",
    "correlation_pallas", "correlation_xla", "num_corr_channels",
    "conv_epilogue", "conv_epilogue_plain",
    "bilinear_sample", "roi_align", "roi_crop", "roi_pool",
]
