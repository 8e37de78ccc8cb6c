"""The yardstick's peaks and the least time a kernel's work could take.

Frozen copies from ``chip_smoke.py`` at commit 8f1f229: the peaks and
``bound`` (``chip_smoke.py:227``, ``:393``), ``busy_ms`` (``:2197``), the
correlation forward's bytes and operations (``corr_bound``, ``:450``) and
the conv epilogue's (``phase_epilogue``, ``:1571``). The epilogue's calls
are worked out here from the ResNet's shapes, where ``chip_smoke.py``
recorded them from the program's trunk.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12    # one H100 SXM, NVIDIA's data sheet
BF16_OPS_PER_S = 989e12      # dense bf16 tensor-core rate
F32_OPS_PER_S = 67e12        # float32 outside the tensor cores
STAGES = {"resnet101": (3, 4, 23, 3), "resnet50": (3, 4, 6, 3),
          "tiny": (1, 1, 1, 1)}


def bound(bytes_moved: float, ops: float,
          ops_per_s: float = BF16_OPS_PER_S) -> tuple:
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the operations over `ops_per_s`."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def busy_ms(intervals) -> float:
    """Total length of the union of (start, end) intervals in us, as ms."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def conv_out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def epilogue_calls(backbone: str, frames: int, height: int, width: int,
                   frozen_stages: int = 0) -> list:
    """(trained, form, (N, C, H, W)) of each conv epilogue of one trunk
    call on `frames` canvases: form A after a conv (affine, ReLU), B a
    block's last conv with its input added, C a first block's last conv
    with the downsample conv's affine output added. `trained`: the stage
    takes a gradient (stages above ``frozen_stages``; 1 is the stem)."""
    h, w = conv_out(height, 7, 2, 3), conv_out(width, 7, 2, 3)
    calls = [(frozen_stages < 1, "A", (frames, 64, h, w))]
    h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)
    for s, (blocks, planes) in enumerate(zip(STAGES[backbone],
                                             (64, 128, 256, 512)), start=1):
        trained = frozen_stages < s + 1
        stride = 2 if s in (2, 3) else 1
        for i in range(blocks):
            st = stride if i == 0 else 1
            calls.append((trained, "A", (frames, planes, h, w)))
            h2, w2 = conv_out(h, 3, st, 1), conv_out(w, 3, st, 1)
            calls.append((trained, "A", (frames, planes, h2, w2)))
            calls.append((trained, "C" if i == 0 else "B",
                          (frames, planes * 4, h2, w2)))
            h, w = h2, w2
    return calls


def epilogue_work(calls: list, esize: int = 2, backward: bool = False
                  ) -> tuple:
    """(bytes, operations) of the epilogue `calls` (forward, or backward
    at the trained ones), each tensor read or written once."""
    nbytes = ops = 0
    for trained, form, shape in calls:
        if backward and not trained:
            continue
        n, c = shape[0] * shape[1] * shape[2] * shape[3], shape[1]
        if backward:
            nbytes += n * esize * (3 if form == "A" else 4) + 4 * c * (
                2 if form == "C" else 1)
            ops += n * (3 if form == "C" else 2)
        else:
            nbytes += n * esize * (2 if form == "A" else 3) + 4 * c * (
                4 if form == "C" else 2)
            ops += n * {"A": 3, "B": 4, "C": 7}[form]
    return nbytes, ops


def epilogue_bound_ms(calls: list, esize: int = 2,
                      backward: bool = False) -> float:
    return bound(*epilogue_work(calls, esize, backward), F32_OPS_PER_S)[0]


def corr_work(pairs: int, height: int, width: int, channels: list,
              displacements: int, esize: int = 2) -> tuple:
    """(bytes, operations) of the correlation forward of `pairs` pairs of
    (H, W, C) maps, one per entry of `channels`: both maps read and the
    output written once, a multiply-add per channel of each output."""
    nbytes = ops = 0
    for c in channels:
        n = pairs * height * width * c
        nbytes += 2 * n * esize + pairs * height * width * displacements * esize
        ops += 2 * n * displacements
    return nbytes, ops


def corr_bound_ms(*args, **kw) -> float:
    return bound(*corr_work(*args, **kw))[0]
