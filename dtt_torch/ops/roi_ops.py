"""RoI align / pool / crop, the pooling modes other than PSRoI
(counterpart of ``dtt.ops.roi_ops``).

Plain PyTorch: ``dtt`` has no Pallas kernel for them (gather forms in
XLA), so neither does the port. Each op takes one frame, (H, W, C) maps
and (N, 4) RoIs, or a batch of frames, (B, H, W, C) and (B, N, 4), and
returns (N, k, k, C) or (B, N, k, k, C) in the maps' dtype:

* ``roi_align``: torchvision semantics (continuous coordinates, a fixed
  ``sampling_ratio`` grid a bin, ``aligned`` for the half-pixel shift),
  the mean of bilinear samples;
* ``roi_pool``: Caffe/torchvision integer-bin max pooling, 0 for an empty
  bin; computed in float32 as a row max then a column max over chunks of
  RoIs, so memory stays bounded (``dtt`` broadcasts (N, k, H, W, C) at
  once) and ties share the gradient evenly, as ``jnp.max`` does;
* ``roi_crop``: the spatial-transformer bilinear crop (a uniform grid
  across the RoI, align-corners), optionally reduced 2x2 by max.

Where a quotient feeds ``floor``/``ceil`` it divides by a tensor: on CUDA,
``tensor / python_number`` is a multiply by the reciprocal, which can put
a bin edge on the other side of an integer.
"""

from __future__ import annotations

import torch

# elements of the (RoIs, k, H, W, C) row stage of `roi_pool` held at once
_POOL_CHUNK = 1 << 26


def _batched(fn):
    """Run the batched op `fn` on one frame when given (H, W, C) maps."""
    def wrapper(features, rois, *args, **kw):
        if features.dim() == 3:
            return fn(features[None], rois[None], *args, **kw)[0]
        return fn(features, rois, *args, **kw)
    wrapper.__name__, wrapper.__doc__ = fn.__name__, fn.__doc__
    return wrapper


def _div(x: torch.Tensor, d) -> torch.Tensor:
    """`x` / `d` as a true division on every device."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _bilinear(features: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor
              ) -> torch.Tensor:
    """(B, H, W, C) maps at points (B, ...) -> (B, ..., C)."""
    b, h, w, c = features.shape
    outside = (ys < -1.0) | (ys > h) | (xs < -1.0) | (xs > w)
    y = ys.clamp(0.0, h - 1.0)
    x = xs.clamp(0.0, w - 1.0)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    ly = (y - y0.to(y.dtype))[..., None]
    lx = (x - x0.to(x.dtype))[..., None]
    flat = features.reshape(b * h * w, c)
    base = (torch.arange(b, device=features.device) * (h * w)).reshape(
        (b,) + (1,) * (ys.dim() - 1))
    v00 = flat[base + y0 * w + x0]
    v01 = flat[base + y0 * w + x1]
    v10 = flat[base + y1 * w + x0]
    v11 = flat[base + y1 * w + x1]
    val = ((1 - ly) * (1 - lx) * v00 + (1 - ly) * lx * v01
           + ly * (1 - lx) * v10 + ly * lx * v11)
    return torch.where(outside[..., None], torch.zeros((), dtype=val.dtype,
                                                       device=val.device),
                       val)


def bilinear_sample(features: torch.Tensor, ys: torch.Tensor,
                    xs: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of (H, W, C) maps at continuous points `ys`,
    `xs` (any one shape) -> (..., C); or of (B, H, W, C) maps at points
    with a leading B. Points outside [-1, H] x [-1, W] give zero
    (torchvision's rule); points inside are clamped to the pixel grid."""
    if features.dim() == 3:
        return _bilinear(features[None], ys[None], xs[None])[0]
    return _bilinear(features, ys, xs)


def _grid_samples(features, x1, y1, bin_w, bin_h, n_pts: int, pos):
    """Bilinear samples at x1 + pos * bin_w (columns) and y1 + pos * bin_h
    (rows) for each RoI: (B, N, n_pts, n_pts, C)."""
    ys = y1[..., None] + pos * bin_h[..., None]               # (B, N, P)
    xs = x1[..., None] + pos * bin_w[..., None]
    b, n = ys.shape[:2]
    yy = ys[..., :, None].expand(b, n, n_pts, n_pts)
    xx = xs[..., None, :].expand(b, n, n_pts, n_pts)
    return _bilinear(features, yy, xx)


@_batched
def roi_align(features: torch.Tensor, rois: torch.Tensor,
              spatial_scale: float, output_size: int,
              sampling_ratio: int = 2, aligned: bool = False
              ) -> torch.Tensor:
    """(H, W, C), (N, 4) -> (N, k, k, C): the mean of a sampling_ratio^2
    grid of bilinear samples a bin (or batched, with a leading B).
    `sampling_ratio` must be positive: torchvision's adaptive
    ``ceil(roi / bin)`` grid has a data-dependent shape."""
    if sampling_ratio <= 0:
        raise ValueError("roi_align needs a fixed sampling_ratio > 0")
    k, sr = output_size, sampling_ratio
    offset = 0.5 if aligned else 0.0
    x1, y1, x2, y2 = (rois[..., i] * spatial_scale - offset for i in range(4))
    roi_w = x2 - x1
    roi_h = y2 - y1
    if not aligned:
        roi_w = roi_w.clamp(min=1.0)
        roi_h = roi_h.clamp(min=1.0)
    bin_w = _div(roi_w, k)
    bin_h = _div(roi_h, k)
    lattice = torch.arange(k * sr, dtype=features.dtype,
                           device=features.device)
    idx = torch.floor(_div(lattice, sr))
    sub = _div(torch.remainder(lattice, sr) + 0.5, sr)
    samples = _grid_samples(features, x1, y1, bin_w, bin_h, k * sr,
                            idx + sub)
    b, n, _, _, c = samples.shape
    return samples.reshape(b, n, k, sr, k, sr, c).mean(dim=(3, 5))


def _bin_edges(lo: torch.Tensor, size: torch.Tensor, k: int, limit: int):
    """Integer bin starts and ends (B, N, k) of k bins of `size` from `lo`,
    clipped to [0, limit]."""
    grid = torch.arange(k, dtype=torch.float32, device=lo.device)
    bin_size = _div(size, k)[..., None]
    start = torch.floor(grid * bin_size).long() + lo[..., None]
    end = torch.ceil((grid + 1) * bin_size).long() + lo[..., None]
    return start.clamp(0, limit), end.clamp(0, limit)


@_batched
def roi_pool(features: torch.Tensor, rois: torch.Tensor,
             spatial_scale: float, output_size: int) -> torch.Tensor:
    """(H, W, C), (N, 4) -> (N, k, k, C): the max over each integer bin,
    0 where a bin is empty (or batched, with a leading B)."""
    b, h, w, c = features.shape
    k = output_size
    n = rois.shape[1]
    # corners rounded half to even, as jnp.round
    x1, y1, x2, y2 = (torch.round(rois[..., i] * spatial_scale).long()
                      for i in range(4))
    roi_w = (x2 - x1 + 1).clamp(min=1).float()
    roi_h = (y2 - y1 + 1).clamp(min=1).float()
    hs, he = _bin_edges(y1, roi_h, k, h)
    ws, we = _bin_edges(x1, roi_w, k, w)
    ys = torch.arange(h, device=features.device)
    xs = torch.arange(w, device=features.device)
    row_in = (ys >= hs[..., None]) & (ys < he[..., None])       # (B, N, k, H)
    col_in = (xs >= ws[..., None]) & (xs < we[..., None])       # (B, N, k, W)
    neg = torch.tensor(torch.finfo(torch.float32).min, device=features.device)
    f = features.float()
    rows = max(1, _POOL_CHUNK // max(1, k * h * w * c))
    out = []
    for i in range(b):
        for j in range(0, n, rows):
            sl = slice(j, j + rows)
            rowmax = torch.where(row_in[i, sl, :, :, None, None],
                                 f[i, None, None], neg).amax(dim=2)
            out.append(torch.where(col_in[i, sl, None, :, :, None],
                                   rowmax[:, :, None], neg).amax(dim=3))
    pooled = torch.cat(out).reshape(b, n, k, k, c)
    empty = ((he <= hs)[..., :, None] | (we <= ws)[..., None, :])[..., None]
    return torch.where(empty, torch.zeros((), device=features.device),
                       pooled).to(features.dtype)


@_batched
def roi_crop(features: torch.Tensor, rois: torch.Tensor,
             spatial_scale: float, output_size: int,
             max_pool: bool = True) -> torch.Tensor:
    """(H, W, C), (N, 4) -> (N, k, k, C): bilinear samples on a uniform
    grid spanning each RoI corner to corner, 2k x 2k reduced 2x2 by max
    with `max_pool` (the reference's crop-resize-with-max-pool), else
    k x k (or batched, with a leading B)."""
    g = output_size * 2 if max_pool else output_size
    x1, y1, x2, y2 = (rois[..., i] * spatial_scale for i in range(4))
    t = _div(torch.arange(g, dtype=features.dtype, device=features.device),
             max(g - 1.0, 1.0))
    ys = y1[..., None] + t * (y2 - y1)[..., None]
    xs = x1[..., None] + t * (x2 - x1)[..., None]
    b, n = ys.shape[:2]
    samples = _bilinear(features, ys[..., :, None].expand(b, n, g, g),
                        xs[..., None, :].expand(b, n, g, g))
    if max_pool:
        k = output_size
        samples = samples.reshape(b, n, k, 2, k, 2, -1).amax(dim=(3, 5))
    return samples
