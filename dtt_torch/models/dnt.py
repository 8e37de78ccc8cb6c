"""The Detect & Track network (counterpart of ``dtt.models.dnt``).

  ResNet (dilated conv5) -> c3 (s8), c4 (s16), c5 (s16)
  RPN on c4; 1x1 "reduce" conv c5 -> reduced                    [per frame]
  cosine correlation of (t, t+1) at c3 (pooled to s16), c4, reduced

Video-mode inference (``frame_trunk``, ``fused_psmaps``,
``detect_track_fused``): fused cls|bbox|track ps-maps as three partial 1x1
products in f32, proposals + ONE PSRoI pool of the fused maps (direct, SAT
kernel or gather, by ``roi.eval_pool_impl``), and per-class decode + NMS
with each kept box's tracked box in frame t+tau.

Training (``frame_features``, ``track_psmaps``, ``pool_vote_batched``):
the unfused cls/bbox maps per frame, the track maps from the concatenated
[reduced_t | reduced_tau | corr x3] input, and differentiable pools.

Single-frame R-FCN detection (``detect_frame``, ``rfcn_head``,
``pool_vote``, ``decode_frame_detections``; ``track_rois``): one frame's
proposals and per-frame ``psroi_pool`` votes by ``impl``; the batched
forms ``detect_frames_batched`` and ``track_rois_batched`` pool with the
gather form.

``roi.pooling_mode`` (the reference's ``cfg.POOLING_MODE``): ``"psroi"``
heads emit k^2 position-sensitive channel groups; ``"align"``, ``"pool"``
and ``"crop"`` heads emit one group, pooled by ``roi_align``,
``roi_pool`` or ``roi_crop`` and voted by the bin mean. The fused
video-mode path is psroi only; the other modes take the unfused one.

Parameters are float32 and cast to ``cfg.dtype`` at use, as the reference
casts its float32 params. Public functions take and return NHWC tensors
(JAX's layouts); convs run on channels-last NCHW views of the same memory.
Every ps-map channel is bin-major ``c = (ph*k + pw)*D + d``.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dtt_torch.core import boxes as box_ops
from dtt_torch.core.config import ModelConfig
from dtt_torch.core.device import resolve_device
from dtt_torch.models.resnet import Conv2d, ResNetBackbone
from dtt_torch.models.rpn import Proposals, RPNHead, proposal_layer, softmax
from dtt_torch.models.targets import roi_norm_params
from dtt_torch.ops.correlation import correlation
from dtt_torch.ops.nms import multiclass_nms
from dtt_torch.ops.psroi import (psroi_pool, psroi_pool_batched,
                                 psroi_pool_batched_direct,
                                 psroi_pool_batched_pallas_mm,
                                 psroi_pool_maps)
from dtt_torch.ops.roi_ops import roi_align, roi_crop, roi_pool

_BACKBONES = {
    "resnet101": (3, 4, 23, 3),
    "resnet50": (3, 4, 6, 3),
    "tiny": (1, 1, 1, 1),
}


class FrameFeats(NamedTuple):
    """The per-frame trunk outputs (batched over frames), NHWC."""

    rpn_cls: torch.Tensor    # (B, H, W, 2A) float32
    rpn_bbox: torch.Tensor   # (B, H, W, 4A) float32
    reduced: torch.Tensor    # (B, H, W, reduced_channels)
    corr_feats: Dict[str, torch.Tensor]  # stride-16 maps for correlation
    cls_maps: Optional[torch.Tensor] = None   # (B, H, W, k^2*C) float32
    bbox_maps: Optional[torch.Tensor] = None  # (B, H, W, k^2*4*nb) float32

    def slice(self, sl: slice) -> "FrameFeats":
        """The same features for frames `sl`."""
        pick = lambda t: None if t is None else t[sl]
        return FrameFeats(self.rpn_cls[sl], self.rpn_bbox[sl],
                          self.reduced[sl],
                          {k: v[sl] for k, v in self.corr_feats.items()},
                          pick(self.cls_maps), pick(self.bbox_maps))


class Detections(NamedTuple):
    rois: torch.Tensor       # (B, N, 4) proposal boxes
    roi_valid: torch.Tensor  # (B, N)
    cls_prob: torch.Tensor   # (B, N, C) softmax class probabilities
    bbox_pred: torch.Tensor  # (B, N, 4*nb) normalized regression output


class PsConv(nn.Module):
    """A 1x1 ps-map conv kept as an (in, out) float32 matrix and bias, the
    form ``fused_psmaps`` slices; cast to the compute dtype at use, as the
    reference casts its float32 params."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cin, cout, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def _matmul_f32(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """1x1 conv of NHWC `x` as a float32 matmul over its channels."""
    return (x.float().reshape(-1, x.shape[-1]) @ kernel).reshape(
        *x.shape[:-1], kernel.shape[-1])


def _conv1x1(x: torch.Tensor, conv: PsConv) -> torch.Tensor:
    """1x1 conv of NHWC `x` in its dtype (kernel and bias cast to it, the
    bias added after the product as flax's ``nn.Conv`` does), as float32."""
    y = x.reshape(-1, x.shape[-1]) @ conv.kernel.to(x.dtype)
    y = y + conv.bias.to(x.dtype)
    return y.reshape(*x.shape[:-1], -1).float()


_FROZEN_AFFINE_PARENTS = ("bn1", "bn2", "bn3", "downsample_bn")


def is_frozen(name: str, frozen_stages: int) -> bool:
    """Whether the parameter or buffer `name` (``a.b.c.weight``) is frozen:
    every frozen-BN affine, the stem for ``frozen_stages >= 1`` and
    ``layer{s}`` for ``frozen_stages >= s + 1`` (dtt's ``_is_frozen``)."""
    keys = name.split(".")
    if len(keys) >= 2 and keys[-2] in _FROZEN_AFFINE_PARENTS:
        return True
    if keys[0] != "backbone":
        return False
    stage = keys[1]
    if frozen_stages >= 1 and stage in ("conv1", "bn1"):
        return True
    return any(frozen_stages >= s + 1 and stage == f"layer{s}"
               for s in range(1, 4))


def cosine_prep(x: torch.Tensor) -> torch.Tensor:
    """Unit-normalize channels and rescale by sqrt(C), so correlation's 1/C
    mean lies in [-1, 1]; the norm and the rescale in the input dtype."""
    n = torch.sqrt(x.float().square().sum(dim=-1, keepdim=True) + 1e-6)
    # sqrt(C) rounded to the input dtype on the host, as a Python scalar
    root_c = torch.tensor(math.sqrt(x.shape[-1]), dtype=torch.float32)
    return (x / n.to(x.dtype)) * root_c.to(x.dtype).item()


_ROI_POOLS = {"align": roi_align, "pool": roi_pool, "crop": roi_crop}


def ps_groups(cfg: ModelConfig) -> int:
    """Channel groups of a head map: k^2 under psroi, else one."""
    return cfg.roi.ps_grid ** 2 if cfg.roi.pooling_mode == "psroi" else 1


class DnT(nn.Module):
    """All parameterized layers of the D&T model."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.roi.pooling_mode not in ("psroi", *_ROI_POOLS):
            raise ValueError(
                f"unknown pooling_mode {cfg.roi.pooling_mode!r}")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)     # compute dtype
        k2 = ps_groups(cfg)
        nb = 2 if cfg.roi.class_agnostic else cfg.num_classes
        cr = cfg.reduced_channels
        corr_ch = len(cfg.track.scales) * cfg.track.num_corr_channels
        self.backbone = ResNetBackbone(_BACKBONES[cfg.backbone],
                                       cfg.frozen_stages, cfg.remat,
                                       device=device)
        self.rpn = RPNHead(1024, cfg.anchors.num_anchors, cfg.rpn.channels,
                           device=device)
        self.reduce = Conv2d(2048, cr, 1, device=device)
        self.cls_maps = PsConv(cr, k2 * cfg.num_classes, device)
        self.bbox_maps = PsConv(cr, k2 * 4 * nb, device)
        self.track_maps = PsConv(2 * cr + corr_ch, k2 * 4, device)
        self.to(memory_format=torch.channels_last)
        for name, p in self.named_parameters():
            p.requires_grad_(not is_frozen(name, cfg.frozen_stages))

    def frame_trunk(self, images: torch.Tensor) -> FrameFeats:
        """(B, H, W, 3) mean-subtracted images -> trunk outputs, without the
        cls/bbox maps (``fused_psmaps`` computes them on the eval path)."""
        x = images.permute(0, 3, 1, 2).to(self.dtype)
        c3, c4, c5 = self.backbone(x)
        rpn_cls, rpn_bbox = self.rpn(c4)
        reduced = F.relu(self.reduce(c5))
        c3p = F.max_pool2d(c3, 2, stride=2)
        return FrameFeats(rpn_cls=rpn_cls, rpn_bbox=rpn_bbox,
                          reduced=_nhwc(reduced),
                          corr_feats={"c3": _nhwc(c3p), "c4": _nhwc(c4),
                                      "c5": _nhwc(reduced)})

    def frame_features(self, images: torch.Tensor) -> FrameFeats:
        """``frame_trunk`` plus the unfused cls/bbox ps-maps, each a 1x1
        conv in the compute dtype cast to float32 (the training path)."""
        feats = self.frame_trunk(images)
        return feats._replace(cls_maps=_conv1x1(feats.reduced, self.cls_maps),
                              bbox_maps=_conv1x1(feats.reduced,
                                                 self.bbox_maps))

    def corr_volumes(self, feats_t: FrameFeats, feats_tau: FrameFeats
                     ) -> list:
        """Per-scale cosine-correlation volumes (B, H, W, nd^2)."""
        c = self.cfg.track
        prep = cosine_prep if c.normalize else (lambda x: x)
        return [correlation(prep(feats_t.corr_feats[s]).contiguous(),
                            prep(feats_tau.corr_feats[s]).contiguous(),
                            c.max_displacement, c.stride)
                for s in c.scales]

    def track_psmaps(self, feats_t: FrameFeats, feats_tau: FrameFeats
                     ) -> torch.Tensor:
        """Tracking-head maps (B, H, W, k^2*4) float32: one 1x1 conv of the
        concatenation [reduced_t | reduced_tau | corr@scales] (D&T eq. 7),
        in the compute dtype."""
        dtype = feats_t.reduced.dtype
        x = torch.cat([feats_t.reduced, feats_tau.reduced]
                      + [v.to(dtype) for v in
                         self.corr_volumes(feats_t, feats_tau)], dim=-1)
        return _conv1x1(x, self.track_maps)

    def fused_psmaps(self, feats_t: FrameFeats, feats_tau: FrameFeats
                     ) -> torch.Tensor:
        """All head ps-maps: (B, H, W, k^2*(Dc+Db+Dt)) float32, per-bin
        layout [cls | bbox | track].

        Three partial 1x1 products summed in f32, as the reference does:
        reduced_t feeds all three outputs; reduced_tau and the correlation
        volumes feed the track slots only. Each product runs as a float32
        matmul of compute-dtype values (bf16-rounded kernels), so it keeps
        the reference's f32 accumulation; this relies on PyTorch's default
        of TF32 off for float32 matmuls.
        """
        cr = feats_t.reduced.shape[-1]
        k2 = ps_groups(self.cfg)
        ck, bk, tk = (m.kernel for m in
                      (self.cls_maps, self.bbox_maps, self.track_maps))
        dc, db, dt = (x.shape[-1] // k2 for x in (ck, bk, tk))
        dtype = feats_t.reduced.dtype
        rounded = lambda w: w.to(dtype).float()

        k1 = torch.cat([ck.reshape(cr, k2, dc), bk.reshape(cr, k2, db),
                        tk[:cr].reshape(cr, k2, dt)], dim=-1)
        out = _matmul_f32(feats_t.reduced, rounded(k1.reshape(cr, -1)))
        track = _matmul_f32(feats_tau.reduced, rounded(tk[cr:2 * cr]))
        corr = torch.cat([x.to(dtype) for x in
                          self.corr_volumes(feats_t, feats_tau)], dim=-1)
        track = track + _matmul_f32(corr, rounded(tk[2 * cr:]))
        b, hh, ww = out.shape[:3]
        out = out.reshape(b, hh, ww, k2, dc + db + dt)
        out[..., dc + db:] += track.reshape(b, hh, ww, k2, dt)
        bias = torch.cat([self.cls_maps.bias.reshape(k2, dc),
                          self.bbox_maps.bias.reshape(k2, db),
                          self.track_maps.bias.reshape(k2, dt)], dim=-1)
        return out.reshape(b, hh, ww, -1) + bias.reshape(-1)


def normalize_device_images(images: torch.Tensor, im_size: torch.Tensor,
                            pixel_means) -> torch.Tensor:
    """uint8 canvas -> mean-subtracted float32, exactly 0 beyond the true
    `im_size` (h, w) extent: one (2,) size for all frames, or (..., 2)
    sizes for images (..., H, W, 3). Float inputs pass through unchanged."""
    if images.dtype != torch.uint8:
        return images
    h, w = images.shape[-3], images.shape[-2]
    x = images.float()
    x = x - box_ops.constant(pixel_means, x)
    hh = im_size[..., 0, None, None, None]
    ww = im_size[..., 1, None, None, None]
    rows = torch.arange(h, device=images.device)[:, None, None] < hh
    cols = torch.arange(w, device=images.device)[None, :, None] < ww
    return torch.where(rows & cols, x, torch.zeros((), device=images.device))


def pool_vote_batched(cfg: ModelConfig, maps: torch.Tensor,
                      rois: torch.Tensor, spatial_scale: float,
                      impl: str = "direct") -> torch.Tensor:
    """(B, H, W, k*k*D) maps, (B, N, 4) RoIs -> (B, N, D) votes, the mean
    over the k*k bins of a differentiable PSRoI pool (the RoIs take no
    gradient), as ``dtt``'s ``pool_vote_batched``:

    * ``"direct"`` pools the maps cast to the compute dtype (its backward
      is the pool-backward kernel), then averages in float32;
    * ``"gather"`` pools the maps as they are (float32 on the train path)
      from their SAT, with autograd's scatter-add backward.

    Under the other pooling modes, (B, H, W, D) maps are pooled as they
    are by the mode's op over the whole batch, whatever `impl`.
    """
    k = cfg.roi.ps_grid
    if cfg.roi.pooling_mode != "psroi":
        return _ROI_POOLS[cfg.roi.pooling_mode](
            maps, rois, spatial_scale, k).mean(dim=(2, 3))
    if impl == "direct":
        pooled = psroi_pool_batched_direct(
            maps.to(getattr(torch, cfg.dtype)).contiguous(), rois,
            spatial_scale, k)
        return pooled.float().mean(dim=(2, 3))
    if impl == "gather":
        return psroi_pool_batched(maps, rois, spatial_scale, k).mean(
            dim=(2, 3))
    raise ValueError(f"unknown batched psroi impl {impl!r}")


def pool_vote_fused(cfg: ModelConfig, fused_maps: torch.Tensor,
                    rois: torch.Tensor) -> torch.Tensor:
    """(B, H, W, k*k*D) float32 fused maps, (B, N, 4) RoIs -> (B, N, D)
    float32 votes by ``cfg.roi.eval_pool_impl``, with ``dtt``'s dtype per
    form: ``"direct"`` pools the maps cast to the compute dtype,
    ``"pallas_mm"`` (the SAT kernel, inference only) and ``"gather"`` pool
    them in float32."""
    impl = cfg.roi.eval_pool_impl
    scale = 1.0 / cfg.anchors.feat_stride
    if impl == "pallas_mm":
        return psroi_pool_batched_pallas_mm(fused_maps, rois, scale,
                                            cfg.roi.ps_grid).mean(dim=(2, 3))
    if impl not in ("direct", "gather"):
        raise ValueError(f"unknown roi.eval_pool_impl {impl!r}")
    return pool_vote_batched(cfg, fused_maps, rois, scale, impl)


def detect_track_fused(cfg: ModelConfig, feats: FrameFeats,
                       fused_maps: torch.Tensor, anchors: torch.Tensor,
                       im_height, im_width, im_scale: float
                       ) -> tuple[Proposals, Detections, torch.Tensor]:
    """Batched proposals + ONE PSRoI pool of the fused maps
    (`pool_vote_fused`) -> detections + track deltas. Pooling is linear per
    channel, so splitting the pooled vote equals three separate pools.
    psroi pooling mode only."""
    if cfg.roi.pooling_mode != "psroi":
        raise ValueError("detect_track_fused pools psroi maps; pooling_mode "
                         f"{cfg.roi.pooling_mode!r} takes the unfused path")
    props = proposal_layer(feats.rpn_cls, feats.rpn_bbox, anchors,
                           im_height, im_width, im_scale, cfg.rpn)
    pooled = pool_vote_fused(cfg, fused_maps, props.rois)
    dc = cfg.num_classes
    db = 8 if cfg.roi.class_agnostic else 4 * cfg.num_classes
    det = Detections(rois=props.rois, roi_valid=props.valid,
                     cls_prob=softmax(pooled[..., :dc]),
                     bbox_pred=pooled[..., dc:dc + db])
    return props, det, pooled[..., dc + db:]


def decode_detections_batched(cfg: ModelConfig, det: Detections,
                              im_height, im_width, score_thresh, nms_thresh,
                              max_per_class: int,
                              track_deltas: Optional[torch.Tensor] = None):
    """Per-class box decode + NMS over the frame batch.

    Returns boxes (B, C-1, M, 4), scores (B, C-1, M), valid (B, C-1, M)
    [and, with `track_deltas`, each kept detection's tracked box in frame
    t+1, (B, C-1, M, 4)]. The background class is dropped.
    """
    means, stds = roi_norm_params(cfg.roi)
    agnostic = cfg.roi.class_agnostic
    # class-agnostic: the fg half of the (bg, fg) pair
    deltas = det.bbox_pred[..., 4:8] if agnostic else det.bbox_pred
    boxes = box_ops.clip_boxes(
        box_ops.decode_boxes(det.rois, deltas, means, stds),
        im_height, im_width)
    if not agnostic:                                      # drop background
        boxes = boxes.reshape(*boxes.shape[:-1], -1, 4)[..., 1:, :]
    det_boxes, det_scores, det_valid, det_idx = multiclass_nms(
        boxes, det.cls_prob[..., 1:], nms_thresh, max_per_class,
        score_threshold=score_thresh, valid=det.roi_valid,
        per_class_boxes=not agnostic)
    if track_deltas is None:
        return det_boxes, det_scores, det_valid
    tracked = box_ops.decode_boxes(det.rois, track_deltas,
                                   cfg.track.bbox_normalize_means,
                                   cfg.track.bbox_normalize_stds)
    tracked = box_ops.clip_boxes(tracked, im_height, im_width)
    frames = torch.arange(tracked.shape[0], device=tracked.device)
    det_tracked = tracked[frames[:, None, None], det_idx] * det_valid[..., None]
    return det_boxes, det_scores, det_valid, det_tracked


def pool_vote(cfg: ModelConfig, maps: torch.Tensor, rois: torch.Tensor,
              spatial_scale: float, impl: str = "auto") -> torch.Tensor:
    """(H, W, k*k*D) maps, (N, 4) RoIs -> (N, D) votes: the mean over the
    k*k bins of ``psroi_pool(impl)``, in the maps' dtype. Under the other
    pooling modes, (H, W, D) maps are pooled by the mode's op, whatever
    `impl`."""
    k = cfg.roi.ps_grid
    mode = cfg.roi.pooling_mode
    if mode != "psroi":
        return _ROI_POOLS[mode](maps, rois, spatial_scale, k).mean(dim=(1, 2))
    return psroi_pool(maps, rois, spatial_scale, k, impl).mean(dim=(1, 2))


def rfcn_head(cfg: ModelConfig, cls_maps: torch.Tensor,
              bbox_maps: torch.Tensor, rois: torch.Tensor,
              spatial_scale: float, impl: str = "auto"):
    """One frame's per-RoI class scores (N, C) and box deltas (N, 4*nb):
    ``pool_vote`` of each map, the two pools in one kernel launch under
    ``"pallas_mm"`` and ``"pallas"`` (``psroi_pool_maps``)."""
    if cfg.roi.pooling_mode != "psroi":
        return tuple(pool_vote(cfg, m, rois, spatial_scale)
                     for m in (cls_maps, bbox_maps))
    return tuple(p.mean(dim=(1, 2)) for p in psroi_pool_maps(
        (cls_maps, bbox_maps), rois, spatial_scale, cfg.roi.ps_grid, impl))


def detect_frame(cfg: ModelConfig, feats: FrameFeats, anchors: torch.Tensor,
                 im_height, im_width, im_scale, frame_idx: int = 0,
                 train: bool = False) -> tuple[Proposals, Detections]:
    """Single-frame R-FCN detection on frame `frame_idx` of a batched
    ``frame_features`` output: its proposals (the batched proposal layer at
    B=1) and ``rfcn_head``'s votes, unbatched: rois (N, 4), valid (N,),
    cls_prob (N, C), bbox_pred (N, 4*nb)."""
    i = frame_idx
    props = proposal_layer(feats.rpn_cls[i:i + 1], feats.rpn_bbox[i:i + 1],
                           anchors, im_height, im_width, im_scale, cfg.rpn,
                           train)
    props = Proposals(*(x[0] for x in props))
    cls_score, bbox_pred = rfcn_head(cfg, feats.cls_maps[i],
                                     feats.bbox_maps[i], props.rois,
                                     1.0 / cfg.anchors.feat_stride)
    return props, Detections(rois=props.rois, roi_valid=props.valid,
                             cls_prob=softmax(cls_score), bbox_pred=bbox_pred)


def detect_frames_batched(cfg: ModelConfig, feats: FrameFeats,
                          anchors: torch.Tensor, im_height, im_width,
                          im_scale, train: bool = False
                          ) -> tuple[Proposals, Detections]:
    """Detection over the whole frame batch: one proposal call, and the
    cls/bbox maps pooled by the gather form (``pool_vote_batched``)."""
    props = proposal_layer(feats.rpn_cls, feats.rpn_bbox, anchors, im_height,
                           im_width, im_scale, cfg.rpn, train)
    scale = 1.0 / cfg.anchors.feat_stride
    cls_score = pool_vote_batched(cfg, feats.cls_maps, props.rois, scale,
                                  "gather")
    bbox_pred = pool_vote_batched(cfg, feats.bbox_maps, props.rois, scale,
                                  "gather")
    return props, Detections(rois=props.rois, roi_valid=props.valid,
                             cls_prob=softmax(cls_score), bbox_pred=bbox_pred)


def track_rois_batched(cfg: ModelConfig, track_maps: torch.Tensor,
                       rois: torch.Tensor) -> torch.Tensor:
    """(B, H, W, k^2*4), (B, N, 4) -> (B, N, 4) tracking deltas (gather
    pool)."""
    return pool_vote_batched(cfg, track_maps, rois,
                             1.0 / cfg.anchors.feat_stride, "gather")


def track_rois(cfg: ModelConfig, track_maps: torch.Tensor, rois: torch.Tensor,
               frame_idx: int = 0) -> torch.Tensor:
    """RoI-pooled tracking deltas (N, 4) for frame `frame_idx`'s RoIs."""
    return pool_vote(cfg, track_maps[frame_idx], rois,
                     1.0 / cfg.anchors.feat_stride)


def decode_frame_detections(cfg: ModelConfig, det: Detections, im_height,
                            im_width, score_thresh=None, nms_thresh=None,
                            max_per_class: int = 20,
                            track_deltas: Optional[torch.Tensor] = None):
    """One frame's per-class decode + NMS: `decode_detections_batched` at
    B=1. Returns boxes (C-1, M, 4), scores (C-1, M), valid (C-1, M) [and,
    with `track_deltas` (N, 4), each kept detection's tracked box]."""
    out = decode_detections_batched(
        cfg, Detections(*(x[None] for x in det)), im_height, im_width,
        score_thresh, nms_thresh, max_per_class,
        None if track_deltas is None else track_deltas[None])
    return tuple(x[0] for x in out)


def make_model(cfg: ModelConfig, device=None) -> DnT:
    """The model on `device` (CUDA unless the caller passes "cpu"), with
    float32 parameters (frozen ones without gradients). Its weights are
    PyTorch's initial values; load real ones with
    ``dtt_torch.utils.params.from_jax_params``."""
    return DnT(cfg, resolve_device(device)).eval()
