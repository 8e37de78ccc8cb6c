"""Reference PyTorch checkpoints into the port's model (counterpart of
``dtt.utils.torch_import``).

Maps torchvision-layout ResNet weights, and full reference D&T checkpoints
(jwyang-lineage module names), onto a ``DnT`` in place, for pretrained
initialization. The port's tensors are already in torch layout, so conv
kernels are copied as they are; what remains of ``dtt``'s conversions:

* BatchNorm (gamma, beta, running_mean, running_var) folds into the
  FrozenAffine (scale, bias): scale = gamma / sqrt(var + eps),
  bias = beta - mean * scale, in float32 numpy as ``dtt`` folds them;
* position-sensitive 1x1 conv outputs: the Caffe/reference channel layout
  c = (d*k + ph)*k + pw is permuted to the port's bin-major
  c = (ph*k + pw)*D + d (psroi pooling mode only);
* RPN cls channels: the reference's class-major (bg anchors..., fg
  anchors...) to the port's anchor-major (A, 2).

The values equal, bit for bit, those of ``dtt``'s importer read through
``from_jax_params``, in either stage layout of ``dtt``'s tree.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dtt_torch.models.dnt import DnT

_BN_EPS = 1e-5


def fold_bn(gamma, beta, mean, var, eps: float = _BN_EPS):
    scale = gamma / np.sqrt(var + eps)
    bias = beta - mean * scale
    return scale.astype(np.float32), bias.astype(np.float32)


def ps_channel_perm(k: int, d: int) -> np.ndarray:
    """Index permutation Caffe ps layout -> bin-major layout:
    perm[dst] = src with src = (dd*k + ph)*k + pw, dst = (ph*k + pw)*d + dd;
    apply as x[..., perm]."""
    perm = np.empty(k * k * d, np.int64)
    for dd in range(d):
        for ph in range(k):
            for pw in range(k):
                perm[(ph * k + pw) * d + dd] = (dd * k + ph) * k + pw
    return perm


def permute_ps_channels(w: np.ndarray, k: int, d: int) -> np.ndarray:
    """Permute the output channels (last axis) of a ps-conv kernel from the
    Caffe layout to the bin-major one."""
    return w[..., ps_channel_perm(k, d)]


def _to_np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                      else t, np.float32)


def _fill(model: DnT, values: Dict[str, np.ndarray]) -> None:
    """Copy `values` (torch layout, by state-dict key) into `model`."""
    state = model.state_dict()
    for key, v in values.items():
        if tuple(v.shape) != tuple(state[key].shape):
            raise ValueError(f"{key}: imported shape {tuple(v.shape)} != "
                             f"model {tuple(state[key].shape)}")
    with torch.no_grad():
        for key, v in values.items():
            state[key].copy_(torch.from_numpy(np.ascontiguousarray(v)))


def _backbone_values(sd: Dict[str, np.ndarray], model: DnT, used: set
                     ) -> Dict[str, np.ndarray]:
    """The backbone's values from torchvision names: conv1, bn1,
    layerK.I.{convJ, bnJ, downsample.0, downsample.1}."""
    def take(name):
        used.add(name)
        if name not in sd:
            raise KeyError(f"missing torch key {name!r}")
        return sd[name]

    def source(parts):
        """torchvision module name of a port module path."""
        if len(parts) == 1:                       # conv1, bn1
            return parts[0]
        layer, block, mod = parts
        mod = {"downsample_conv": "downsample.0",
               "downsample_bn": "downsample.1"}.get(mod, mod)
        return f"{layer}.{int(block.removeprefix('block'))}.{mod}"

    out = {}
    for key in model.state_dict():
        parts = key.split(".")
        if parts[0] != "backbone":
            continue
        *path, leaf = parts[1:]
        name = source(path)
        if leaf == "weight":
            out[key] = take(f"{name}.weight")
        elif leaf == "scale":
            scale, bias = fold_bn(take(f"{name}.weight"), take(f"{name}.bias"),
                                  take(f"{name}.running_mean"),
                                  take(f"{name}.running_var"))
            out[key], out[key[:-len("scale")] + "bias"] = scale, bias
    return out


def import_resnet_backbone(state_dict: Dict, model: DnT,
                           strict: bool = True) -> DnT:
    """Pour a torchvision(-style) ResNet state dict into `model`'s backbone,
    in place; with `strict`, a key other than ``fc.*`` left unused
    raises."""
    sd = {k: _to_np(v) for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}
    used: set = set()
    _fill(model, _backbone_values(sd, model, used))
    if strict:
        unused = {k for k in sd if not k.startswith("fc.")} - used
        if unused:
            raise KeyError(f"unconsumed torch keys: {sorted(unused)[:8]}...")
    return model


# reference module names per port module (first present wins); see
# dtt.utils.torch_import.NAME_CANDIDATES
NAME_CANDIDATES = {
    "rpn.conv": ("RCNN_rpn.RPN_Conv", "rpn.RPN_Conv", "RPN_Conv"),
    "rpn.cls_score": ("RCNN_rpn.RPN_cls_score", "rpn.RPN_cls_score",
                      "RPN_cls_score"),
    "rpn.bbox_pred": ("RCNN_rpn.RPN_bbox_pred", "rpn.RPN_bbox_pred",
                      "RPN_bbox_pred"),
    "reduce": ("RCNN_conv_new", "conv_new_1", "RCNN_conv_1x1", "conv_new"),
    "cls_maps": ("RCNN_cls_base", "rfcn_cls", "RCNN_cls_score_net",
                 "cls_score_net"),
    "bbox_maps": ("RCNN_bbox_base", "rfcn_bbox", "RCNN_bbox_pred_net",
                  "bbox_pred_net"),
    "track_maps": ("RCNN_tracking", "rfcn_tracking", "tracking_pred",
                   "RCNN_tracking_base"),
}

# the jwyang lineage's Sequential backbone: RCNN_base = (conv1, bn1, relu,
# maxpool, layer1, layer2, layer3), RCNN_top = (layer4)
_RCNN_BASE_MAP = {"RCNN_base.0": "conv1", "RCNN_base.1": "bn1",
                  "RCNN_base.4": "layer1", "RCNN_base.5": "layer2",
                  "RCNN_base.6": "layer3", "RCNN_top.0": "layer4"}


def normalize_backbone_keys(sd: Dict) -> Dict:
    """Rewrite RCNN_base.N / RCNN_top.N sequential names to torchvision's."""
    out = {}
    for k, v in sd.items():
        for pre, sub in _RCNN_BASE_MAP.items():
            if k.startswith(pre + "."):
                k = sub + k[len(pre):]
                break
        out[k] = v
    return out


def _rpn_cls_perm(num_anchors: int) -> np.ndarray:
    """Reference RPN cls channels are class-major (bg anchors..., fg
    anchors...); the port's are anchor-major. dst a*2+s <- src s*A+a."""
    a = num_anchors
    perm = np.empty(2 * a, np.int64)
    for s in range(2):
        for i in range(a):
            perm[i * 2 + s] = s * a + i
    return perm


def import_full_checkpoint(state_dict: Dict, model: DnT,
                           strict: bool = True) -> DnT:
    """Pour a complete reference D&T state dict into `model`, in place:
    backbone, RPN, reduce ("conv new"), the cls/bbox ps convs and the
    tracking conv, with BN folding, the ps-channel permutation (psroi
    mode) and the RPN-cls one. With `strict`, a missing head or a key
    other than ``fc.*`` left unused raises."""
    cfg = model.cfg
    sd = normalize_backbone_keys(
        {k: _to_np(v) for k, v in state_dict.items()
         if not k.endswith("num_batches_tracked")})
    backbone_sd = {k: v for k, v in sd.items()
                   if k.split(".")[0] in
                   ("conv1", "bn1", "layer1", "layer2", "layer3", "layer4")}
    import_resnet_backbone(backbone_sd, model, strict=strict)
    used = set(backbone_sd)
    state = model.state_dict()

    def find(slot):
        for cand in NAME_CANDIDATES[slot]:
            if cand + ".weight" in sd:
                return cand
        if strict:
            raise KeyError(f"no reference weights found for {slot!r} "
                           f"(tried {NAME_CANDIDATES[slot]})")
        return None

    k = cfg.roi.ps_grid
    nb = 2 if cfg.roi.class_agnostic else cfg.num_classes
    ps = cfg.roi.pooling_mode == "psroi"
    perms = {"rpn.cls_score": _rpn_cls_perm(cfg.anchors.num_anchors),
             "cls_maps": ps_channel_perm(k, cfg.num_classes) if ps else None,
             "bbox_maps": ps_channel_perm(k, 4 * nb) if ps else None,
             "track_maps": ps_channel_perm(k, 4) if ps else None}
    values = {}
    for slot in NAME_CANDIDATES:
        name = find(slot)
        if name is None:
            continue
        w, b = sd[name + ".weight"], sd[name + ".bias"]
        used.update({name + ".weight", name + ".bias"})
        matrix = slot in ("cls_maps", "bbox_maps", "track_maps")
        if matrix:                                # (O, I, 1, 1) -> (I, O)
            w = w.reshape(w.shape[0], -1).T
        wkey = slot + (".kernel" if matrix else ".weight")
        # shapes are checked before any permutation: a short permutation
        # would silently drop channels of a mismatched head
        if w.shape != tuple(state[wkey].shape):
            raise ValueError(f"{name}: kernel shape {w.shape} != the "
                             f"model's {tuple(state[wkey].shape)}")
        perm = perms.get(slot)
        if perm is not None:
            w = w[:, perm] if matrix else w[perm]
            b = b[perm]
        values[wkey], values[slot + ".bias"] = w, b
    _fill(model, values)
    if strict:
        unused = {key for key in sd if not key.startswith("fc.")} - used
        if unused:
            raise KeyError(f"unconsumed reference keys: {sorted(unused)[:8]}...")
    return model


def load_pth(path: str) -> Dict:
    """``torch.load`` a .pth (weights only) and return its flat state dict:
    the ``state_dict`` or ``model`` entry when there is one, ``module.``
    prefixes dropped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"],
                                                               dict):
        obj = obj["model"]
    return {k.replace("module.", ""): v for k, v in obj.items()}


def import_pretrained_backbone(pth_path: str, model: DnT) -> DnT:
    """A .pth file's ResNet weights into `model`'s backbone, in place."""
    return import_resnet_backbone(load_pth(pth_path), model)
