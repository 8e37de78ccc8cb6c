"""The plain reference of D&T's video step: the forward pass of a frame
pair and its per-class detections, in float32 with TF32 off.

Written from the paper's description (Feichtenhofer et al., ICCV 2017,
§3-4, with R-FCN's heads, Dai et al. 2016) and the configuration file's
values: a dilated ResNet with frozen BatchNorm affines, an RPN on c4, a
1x1 "reduce" conv on c5, cosine correlation of the two frames at c3
(pooled to stride 16), c4 and the reduced c5, position-sensitive class,
box and track maps, proposals by NMS, PSRoI pooling by integer bins,
per-class NMS and each kept box's tracked box in the next frame. It
imports nothing of the program; it takes the weights that the benchmark
made (``benchmark.weights``) and the uint8 frames.

`Precision` is where the arithmetic is rounded: float32 is the reference;
"fp8" rounds every conv's and product's inputs and weights to float8
e4m3 (a scale per tensor), the control that ``benchmark/judge.py`` judges.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import boxes as bx

BACKBONES = {"resnet101": (3, 4, 23, 3), "resnet50": (3, 4, 6, 3),
             "tiny": (1, 1, 1, 1)}
FP8_MAX = 448.0


class Precision:
    """Rounding of a conv's or a product's operands: none (float32) or
    float8 e4m3 with one scale per tensor."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x
        scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale


@contextmanager
def no_tf32():
    """float32 products and convs in float32, not TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ---------------------------------------------------------------- weights

def param_spec(model: dict) -> list:
    """(name, shape, init) of every weight: init is ("lecun", fan_in),
    ("normal", std), ("ones",) or ("zeros",). Names and layouts are the
    ones the program's module tree uses (conv weights OIHW, the ps-map
    kernels (in, out) matrices)."""
    spec = []

    def conv(name, cout, cin, k, bias=False, std=None):
        init = ("normal", std) if std else ("lecun", cin * k * k)
        spec.append((f"{name}.weight", (cout, cin, k, k), init))
        if bias:
            spec.append((f"{name}.bias", (cout,), ("zeros",)))

    def affine(name, c):
        spec.append((f"{name}.scale", (c,), ("ones",)))
        spec.append((f"{name}.bias", (c,), ("zeros",)))

    conv("backbone.conv1", 64, 3, 7)
    affine("backbone.bn1", 64)
    inplanes = 64
    for s, (blocks, planes) in enumerate(zip(BACKBONES[model["backbone"]],
                                             (64, 128, 256, 512)), start=1):
        for i in range(blocks):
            p = f"backbone.layer{s}.block{i}"
            cin = inplanes if i == 0 else planes * 4
            conv(f"{p}.conv1", planes, cin, 1)
            affine(f"{p}.bn1", planes)
            conv(f"{p}.conv2", planes, planes, 3)
            affine(f"{p}.bn2", planes)
            conv(f"{p}.conv3", planes * 4, planes, 1)
            affine(f"{p}.bn3", planes * 4)
            if i == 0:
                conv(f"{p}.downsample_conv", planes * 4, cin, 1)
                affine(f"{p}.downsample_bn", planes * 4)
        inplanes = planes * 4
    a = len(model["anchors"]["scales"]) * len(model["anchors"]["ratios"])
    rc = model["rpn"]["channels"]
    conv("rpn.conv", rc, 1024, 3, bias=True, std=0.01)
    conv("rpn.cls_score", 2 * a, rc, 1, bias=True, std=0.01)
    conv("rpn.bbox_pred", 4 * a, rc, 1, bias=True, std=0.01)
    cr = model["reduced_channels"]
    conv("reduce", cr, 2048, 1, bias=True, std=0.01)
    k2, nc, nb = groups(model)
    for name, cin, cout, std in (
            ("cls_maps", cr, k2 * nc, 0.01),
            ("bbox_maps", cr, k2 * 4 * nb, 0.001),
            ("track_maps", 2 * cr + len(model["track"]["scales"])
             * corr_channels(model), k2 * 4, 0.001)):
        spec.append((f"{name}.kernel", (cin, cout), ("normal", std)))
        spec.append((f"{name}.bias", (cout,), ("zeros",)))
    return spec


def groups(model: dict) -> tuple:
    """(k^2 bins, classes, box sets: 2 class-agnostic or one a class)."""
    k = model["roi"]["ps_grid"]
    nb = 2 if model["roi"]["class_agnostic"] else model["num_classes"]
    return k * k, model["num_classes"], nb


def offsets(track: dict) -> list:
    d, s = track["max_displacement"], track["stride"]
    return list(range(-d, d + 1, s))


def corr_channels(model: dict) -> int:
    return len(offsets(model["track"])) ** 2


# ---------------------------------------------------------------- trunk

def normalize(frames: torch.Tensor, im_hw, means) -> torch.Tensor:
    """uint8 (B, H, W, 3) canvases -> float32 NCHW, the BGR means taken
    off, zero outside the true (h, w) extent."""
    x = frames.float() - torch.tensor(means, device=frames.device)
    h, w = int(im_hw[0]), int(im_hw[1])
    x[:, h:] = 0.0
    x[:, :, w:] = 0.0
    return x.permute(0, 3, 1, 2)


class Trunk:
    """The per-frame part of the network on weights `w` (a dict)."""

    def __init__(self, w: dict, model: dict, prec: Precision):
        self.w, self.m, self.q = w, model, prec

    def conv(self, x, name, stride=1, pad=0, dilation=1):
        b = self.w.get(f"{name}.bias")
        return F.conv2d(self.q(x), self.q(self.w[f"{name}.weight"]), b,
                        stride, pad, dilation)

    def affine(self, x, name):
        return (x * self.w[f"{name}.scale"][:, None, None]
                + self.w[f"{name}.bias"][:, None, None])

    def block(self, x, p, stride, dilation, down):
        out = F.relu(self.affine(self.conv(x, f"{p}.conv1"), f"{p}.bn1"))
        out = F.relu(self.affine(self.conv(out, f"{p}.conv2", stride,
                                           dilation, dilation), f"{p}.bn2"))
        out = self.affine(self.conv(out, f"{p}.conv3"), f"{p}.bn3")
        sc = (self.affine(self.conv(x, f"{p}.downsample_conv", stride),
                          f"{p}.downsample_bn") if down else x)
        return F.relu(out + sc)

    def __call__(self, images: torch.Tensor) -> dict:
        """NCHW float32 -> the features the heads read, NHWC."""
        x = F.relu(self.affine(self.conv(images, "backbone.conv1", 2, 3),
                               "backbone.bn1"))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for s, blocks in enumerate(BACKBONES[self.m["backbone"]], start=1):
            stride = 2 if s in (2, 3) else 1
            dil = 2 if s == 4 else 1
            for i in range(blocks):
                x = self.block(x, f"backbone.layer{s}.block{i}",
                               stride if i == 0 else 1, dil, i == 0)
            outs.append(x)
        c3, c4, c5 = outs[1:]
        r = F.relu(self.conv(c4, "rpn.conv", pad=1))
        nhwc = lambda t: t.permute(0, 2, 3, 1)
        reduced = nhwc(F.relu(self.conv(c5, "reduce")))
        return {"rpn_cls": nhwc(self.conv(r, "rpn.cls_score")),
                "rpn_bbox": nhwc(self.conv(r, "rpn.bbox_pred")),
                "reduced": reduced,
                "c3": nhwc(F.max_pool2d(c3, 2, stride=2)), "c4": nhwc(c4),
                "c5": reduced}


# ---------------------------------------------------------------- heads

def cosine(x: torch.Tensor) -> torch.Tensor:
    """Channels to unit norm, times sqrt(C)."""
    n = torch.sqrt(x.square().sum(-1, keepdim=True) + 1e-6)
    return x / n * math.sqrt(x.shape[-1])


def correlation(f1, f2, track: dict, q: Precision) -> torch.Tensor:
    """(B, H, W, C) x2 -> (B, H, W, nd^2): the channel mean of f1 times f2
    displaced by (dy, dx), dy-major."""
    _, h, w, c = f1.shape
    d = track["max_displacement"]
    a, f2p = q(f1), F.pad(q(f2), (0, 0, d, d, d, d))
    return torch.stack([(a * f2p[:, d + dy:d + dy + h, d + dx:d + dx + w]
                         ).sum(-1) / c
                        for dy in offsets(track) for dx in offsets(track)],
                       dim=-1)


def head_maps(w: dict, model: dict, ft: dict, ftau: dict, q: Precision):
    """The class, box and track ps-maps of frame pairs (t, t+1), NHWC;
    the track maps read [reduced_t | reduced_t+1 | correlations]."""
    prod = lambda x, name: (q(x) @ q(w[f"{name}.kernel"])
                            + w[f"{name}.bias"])
    track = model["track"]
    prep = cosine if track["normalize"] else (lambda x: x)
    corr = [correlation(prep(ft[s]), prep(ftau[s]), track, q)
            for s in track["scales"]]
    x = torch.cat([ft["reduced"], ftau["reduced"], *corr], dim=-1)
    return (prod(ft["reduced"], "cls_maps"), prod(ft["reduced"], "bbox_maps"),
            prod(x, "track_maps"))


def proposals(model: dict, feats: dict, anchors: torch.Tensor, im_hw,
              scale: float) -> tuple:
    """One frame's RPN proposals (test budgets): foreground softmax,
    decode, clip, the min-size filter, the top pre-NMS boxes, NMS and the
    first post-NMS ones. Returns rois (N, 4) and valid (N,), padded."""
    rpn = model["rpn"]
    logits = feats["rpn_cls"].reshape(-1, 2)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    fg = (e / e.sum(dim=-1, keepdim=True))[:, 1]
    boxes = bx.clip(bx.decode(anchors, feats["rpn_bbox"].reshape(-1, 4)),
                    *im_hw)
    min_size = rpn["min_size"] * scale
    ws = boxes[:, 2] - boxes[:, 0] + 1.0
    hs = boxes[:, 3] - boxes[:, 1] + 1.0
    fg = torch.where((ws >= min_size) & (hs >= min_size), fg,
                     torch.full_like(fg, -1.0))
    top = torch.sort(fg, descending=True, stable=True).indices[
        :rpn["pre_nms_top_n_test"]]
    keep = bx.greedy_nms(boxes[top].cpu(), fg[top].cpu(), rpn["nms_thresh"],
                         rpn["post_nms_top_n_test"], -0.5)
    n = rpn["post_nms_top_n_test"]
    rois = torch.zeros(n, 4, device=boxes.device)
    valid = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    rois[:len(keep)] = boxes[top[keep]]
    valid[:len(keep)] = True
    return rois, valid


def psroi_votes(maps: torch.Tensor, rois: torch.Tensor, k: int,
                spatial_scale: float) -> torch.Tensor:
    """Position-sensitive RoI pooling: (H, W, k*k*D) maps, (N, 4) RoIs ->
    (N, D), the mean over the k x k bins of each bin's own channel group
    averaged over the bin's integer cells (an empty bin gives 0). Bin
    bounds as R-FCN's: the RoI rounded, scaled, split in k, floor and
    ceil, clipped to the map. Sums from a float64 summed-area table."""
    h, w, c = maps.shape
    d = c // (k * k)
    x1 = torch.round(rois[:, 0]) * spatial_scale
    y1 = torch.round(rois[:, 1]) * spatial_scale
    x2 = torch.round(rois[:, 2] + 1.0) * spatial_scale
    y2 = torch.round(rois[:, 3] + 1.0) * spatial_scale
    bw = (x2 - x1).clamp(min=0.1) / k
    bh = (y2 - y1).clamp(min=0.1) / k
    g = torch.arange(k, dtype=torch.float32, device=maps.device)
    hs = torch.floor(g * bh[:, None] + y1[:, None]).clamp(0, h).long()
    he = torch.ceil((g + 1) * bh[:, None] + y1[:, None]).clamp(0, h).long()
    ws = torch.floor(g * bw[:, None] + x1[:, None]).clamp(0, w).long()
    we = torch.ceil((g + 1) * bw[:, None] + x1[:, None]).clamp(0, w).long()
    table = F.pad(maps.double().cumsum(0).cumsum(1), (0, 0, 1, 0, 1, 0))
    table = table.reshape(h + 1, w + 1, k * k, d)
    binid = torch.arange(k * k, device=maps.device).reshape(k, k)
    corner = lambda y, x: table[y[:, :, None], x[:, None, :], binid]
    a, b = hs, he
    c0, c1 = ws, we
    sums = (corner(b, c1) - corner(a, c1) - corner(b, c0) + corner(a, c0))
    area = ((he - hs).clamp(min=0)[:, :, None]
            * (we - ws).clamp(min=0)[:, None, :]).double()[..., None]
    means = torch.where(area > 0, sums / area.clamp(min=1.0),
                        torch.zeros((), dtype=torch.float64,
                                    device=maps.device))
    return means.mean(dim=(1, 2)).float()


def pair_detections(cfg: dict, w: dict, ft: dict, ftau: dict,
                    anchors: torch.Tensor, im_hw, scale: float,
                    q: Precision) -> dict:
    """One frame pair's per-class detections from its two frames'
    features (batch of one): boxes (C-1, M, 4), scores (C-1, M), valid
    (C-1, M), tracked (C-1, M, 4), and the RoIs with their class
    probabilities, boxes and tracked boxes before NMS."""
    model, ev = cfg["model"], cfg["eval"]
    k = model["roi"]["ps_grid"]
    cls_m, box_m, trk_m = head_maps(w, model, ft, ftau, q)
    rois, roi_valid = proposals(model, {n: ft[n][0] for n in
                                        ("rpn_cls", "rpn_bbox")},
                                anchors, im_hw, scale)
    s = 1.0 / model["anchors"]["feat_stride"]
    cls_logits = psroi_votes(cls_m[0], rois, k, s)
    cls_prob = torch.softmax(cls_logits, dim=-1)
    deltas = psroi_votes(box_m[0], rois, k, s)
    if not model["roi"]["class_agnostic"]:
        raise ValueError("the reference decodes class-agnostic boxes only")
    boxes = bx.clip(bx.decode(rois, deltas[:, 4:8],
                              model["roi"]["bbox_normalize_stds"]), *im_hw)
    tracked = bx.clip(bx.decode(rois, psroi_votes(trk_m[0], rois, k, s),
                                model["track"]["bbox_normalize_stds"]),
                      *im_hw)
    nc, m = model["num_classes"] - 1, ev["max_per_class"]
    out_b = torch.zeros(nc, m, 4)
    out_s = torch.zeros(nc, m)
    out_v = torch.zeros(nc, m, dtype=torch.bool)
    out_t = torch.zeros(nc, m, 4)
    scores = torch.where(roi_valid[:, None], cls_prob[:, 1:],
                         torch.full_like(cls_prob[:, 1:], -1.0)).cpu()
    b_cpu, t_cpu = boxes.cpu(), tracked.cpu()
    for c in range(nc):
        keep = bx.greedy_nms(b_cpu, scores[:, c], ev["nms_thresh"], m,
                             ev["score_thresh"])
        n = len(keep)
        out_b[c, :n], out_s[c, :n] = b_cpu[keep], scores[keep, c]
        out_v[c, :n], out_t[c, :n] = True, t_cpu[keep]
    return {"boxes": out_b, "scores": out_s, "valid": out_v,
            "tracked": out_t, "rois": rois.cpu(), "roi_valid": roi_valid.cpu(),
            "cls_prob": cls_prob.cpu(), "cls_logits": cls_logits.cpu(),
            "roi_boxes": b_cpu,
            "roi_tracked": t_cpu}


def frame_anchors(cfg: dict, device) -> torch.Tensor:
    """The canvas's anchors, rows ordered (y, x, a)."""
    inp, a = cfg["input"], cfg["model"]["anchors"]
    s = a["feat_stride"]
    return torch.from_numpy(bx.grid_anchors(
        a, inp["canvas_height"] // s, inp["canvas_width"] // s)).to(device)


TRUNK_MAPS = ("rpn_cls", "rpn_bbox", "reduced", "c3", "c4")


def pair(cfg: dict, w: dict, frames, t: int, im_hw, prec: Precision,
         anchors: torch.Tensor, given: list | None = None,
         scale: float = 1.0) -> tuple:
    """Frame pair (t, t+1) of `frames` (uint8 (T, H, W, 3), host; the last
    frame pairs with itself, as the video step's identity pair): the two
    frames' trunk features (``TRUNK_MAPS``, host numpy, one dict a frame)
    and the pair's detections (``pair_detections``), from the reference's
    own trunk features or, where `given`, from those (two dicts of
    ``TRUNK_MAPS``, as this returns them)."""
    model, inp = cfg["model"], cfg["input"]
    t2 = min(t + 1, len(frames) - 1)
    dev = anchors.device
    x = torch.from_numpy(np.stack([frames[t], frames[t2]])).to(dev)
    with torch.no_grad(), no_tf32():
        f = Trunk(w, model, prec)(normalize(x, im_hw, inp["pixel_means"]))
        src = f if given is None else {
            k: torch.from_numpy(np.stack([g[k] for g in given])).to(dev)
            for k in TRUNK_MAPS}
        if given is not None:
            src["c5"] = src["reduced"]
        det = pair_detections(cfg, w, {k: v[:1] for k, v in src.items()},
                              {k: v[1:] for k, v in src.items()}, anchors,
                              im_hw, scale, prec)
    feats = [{k: f[k][i].cpu().numpy() for k in TRUNK_MAPS} for i in (0, 1)]
    return feats, det


def snippet_detections(cfg: dict, w: dict, frames: np.ndarray, pairs: list,
                       im_hw, device, prec: Precision, scale: float = 1.0
                       ) -> list:
    """The reference's detections of frame pairs (t, t+1) of `frames`,
    one pair at a time."""
    anchors = frame_anchors(cfg, device)
    return [pair(cfg, w, frames, t, im_hw, prec, anchors, scale=scale)[1]
            for t in pairs]
