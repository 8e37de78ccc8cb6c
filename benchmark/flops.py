"""Model FLOP of the D&T network from the configuration's shapes.

A multiply-add counts 2. Counted: every conv of the trunk, the RPN and
the reduce conv, the 1x1 products of the class, box and track maps and
the correlation's multiply-adds. Not counted (each well under 1% of a
frame's): the affines, ReLUs and residual adds, pooling, softmax, box
decoding, NMS and linking. Whatever implements the work, the count is
the same: it is the model's, not a kernel's.
"""

from __future__ import annotations

from benchmark.reference.dnt import BACKBONES, corr_channels, groups
from benchmark.roofline import conv_out


def _conv(cin, cout, k, h, w) -> int:
    return 2 * cin * cout * k * k * h * w


def trunk_stages(model: dict, height: int, width: int) -> list:
    """FLOP of one frame's trunk by stage: stem, layer1..4, then the RPN
    and reduce convs on c4 / c5, as (name, FLOP)."""
    h, w = conv_out(height, 7, 2, 3), conv_out(width, 7, 2, 3)
    out = [("stem", _conv(3, 64, 7, h, w))]
    h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)
    cin = 64
    for s, (blocks, planes) in enumerate(zip(BACKBONES[model["backbone"]],
                                             (64, 128, 256, 512)), start=1):
        stride = 2 if s in (2, 3) else 1
        total = 0
        for i in range(blocks):
            st = stride if i == 0 else 1
            c = cin if i == 0 else planes * 4
            h2, w2 = conv_out(h, 3, st, 1), conv_out(w, 3, st, 1)
            total += (_conv(c, planes, 1, h, w)
                      + _conv(planes, planes, 3, h2, w2)
                      + _conv(planes, planes * 4, 1, h2, w2))
            if i == 0:
                total += _conv(c, planes * 4, 1, h2, w2)
            h, w = h2, w2
        out.append((f"layer{s}", total))
        cin = planes * 4
    a = len(model["anchors"]["scales"]) * len(model["anchors"]["ratios"])
    rc = model["rpn"]["channels"]
    out.append(("rpn", _conv(1024, rc, 3, h, w) + _conv(rc, 6 * a, 1, h, w)))
    out.append(("reduce", _conv(2048, model["reduced_channels"], 1, h, w)))
    return out


def trunk_flop(model: dict, height: int, width: int) -> int:
    """One frame's trunk, RPN and reduce conv."""
    return sum(f for _, f in trunk_stages(model, height, width))


def map_flop(model: dict, h16: int, w16: int) -> int:
    """One frame pair's class, box and track maps (1x1 products)."""
    k2, nc, nb = groups(model)
    cr = model["reduced_channels"]
    corr = len(model["track"]["scales"]) * corr_channels(model)
    return (_conv(cr, k2 * nc, 1, h16, w16) + _conv(cr, k2 * 4 * nb, 1, h16, w16)
            + _conv(2 * cr + corr, k2 * 4, 1, h16, w16))


def corr_flop(model: dict, h16: int, w16: int) -> int:
    """One frame pair's correlation at every scale."""
    chans = {"c3": 512, "c4": 1024, "c5": model["reduced_channels"]}
    return sum(2 * chans[s] * corr_channels(model) * h16 * w16
               for s in model["track"]["scales"])


def video_pair_flop(cfg: dict) -> int:
    """A video pair's model FLOP: its frame's trunk once (the video step
    shares a frame's features between its two pairs) and the pair's
    heads and correlation."""
    model, inp = cfg["model"], cfg["input"]
    h, w = inp["canvas_height"], inp["canvas_width"]
    s = model["anchors"]["feat_stride"]
    return (trunk_flop(model, h, w) + map_flop(model, h // s, w // s)
            + corr_flop(model, h // s, w // s))
