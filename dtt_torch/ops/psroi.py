"""Position-sensitive RoI pooling (counterpart of ``dtt.ops.psroi``): the
frame-batched pools (``psroi_pool_batched_direct`` with ``_direct_ad``,
``psroi_pool_batched``, ``psroi_pool_batched_pallas_mm``) and the per-frame
``psroi_pool`` with its four ``impl`` forms.

Caffe/R-FCN bin bounds (``roi_bounds``), then per (frame, RoI, bin,
channel) the sum of the map over the bin, divided by the bin's area, with
empty bins 0. Channels are dtt's bin-major ``c = (ph*k + pw)*D + d``.

* `psroi_sums_plain` / `psroi_sums_cuda` / `psroi_sums` — the bin sums:
  interval-indicator contractions in f32 (the reference the kernel is held
  against; the CPU path), the hand-written kernel ``csrc/psroi.cu``
  (replaces the TPU kernel ``_psroi_direct_kernel``), and the dispatcher
  that takes the plain version for CPU tensors and the kernel otherwise.
* `psroi_bwd_plain` / `psroi_bwd_cuda` / `psroi_bwd` — the same three for
  the map gradient from ghat = g/area (the kernel replaces
  ``_psroi_direct_bwd_kernel``).
* `psroi_pool_batched_direct` — the pool as an autograd function: the bin
  means in the maps' dtype, the gradient in the maps' dtype, none for the
  RoIs (the bin bounds are piecewise constant in them).

Summed-area-table (SAT) forms, the other two ``roi.eval_pool_impl``s:

* `sat` — the zero-padded float32 2-D cumsum, (B, H+1, W+1, C); every bin
  sum is then a difference of 4 corners.
* `psroi_pool_batched` — the ``"gather"`` form (``dtt``'s
  ``psroi_pool_batched``, XLA there): the corners gathered from the SAT in
  plain PyTorch, differentiable through autograd (scatter-add backward).
* `psroi_mm_sums_plain` / `psroi_mm_sums_cuda` / `psroi_mm_sums` — the
  ``"pallas_mm"`` bin sums off the SAT: one-hot +-1 row and column
  indicator contractions, rows first (the reference the kernel is held
  against; the CPU path), the kernel ``dtt_psroi_sat`` in
  ``csrc/psroi.cu`` (replaces the TPU kernel ``_psroi_mm_kernel_b``), and
  the dispatcher.
* `psroi_pool_batched_pallas_mm` — area and division around those sums,
  inference only, as ``dtt``'s function of the same name.
* `psroi_sat_means_plain` / `psroi_sat_means_cuda` / `psroi_sat_means` —
  the gather form's bin means off the SAT: the corners combined as
  ((S11 - S01) - S10) + S00 and divided by the area (the reference the
  kernel is held against; the CPU path), the kernel ``dtt_psroi_sat_mean``
  in ``csrc/psroi.cu`` (replaces the TPU kernel ``_psroi_kernel``), and the
  dispatcher.

Per frame, ``psroi_pool(impl=...)`` with dtt's names: ``"xla"`` (the
gather form at B=1, the default), ``"mm"`` (the bilinear form as einsums),
``"pallas_mm"`` (``psroi_mm_sums`` at B=1: the TPU kernel
``_psroi_mm_kernel`` has ``_psroi_mm_kernel_b``'s body without the frame
axis, so the port launches the one kernel for both) and ``"pallas"``
(``psroi_sat_means``). The two kernel forms are autograd functions whose
backward is the ``"xla"`` form's scatter-add, as dtt pins both.

Numerics: the sums stay f32 throughout. The TPU kernels round their bf16
row partial sums (forward) and ghat expansions (backward) to bf16 inside
their matmuls, so bf16 results differ from them by that rounding. SAT
entries grow to H*W times the map's values, so a SAT pool's bin mean is a
difference of large f32 numbers; its error is a few ulps of the SAT.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from dtt_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def roi_bounds(rois: torch.Tensor, spatial_scale: float, group_size: int,
               height: int, width: int):
    """Integer bin bounds per RoI: (..., N, 4) -> hs, he, ws, we, each
    (..., N, k) int32. ``torch.round`` rounds half to even, like the
    reference's ``jnp.round``; every operation rounds as the reference's
    does, on the CPU and on CUDA alike."""
    k = group_size
    start_w = torch.round(rois[..., 0]) * spatial_scale
    start_h = torch.round(rois[..., 1]) * spatial_scale
    end_w = torch.round(rois[..., 2] + 1.0) * spatial_scale
    end_h = torch.round(rois[..., 3] + 1.0) * spatial_scale
    # divide by k as a tensor filled on the device (no blocking copy): CUDA
    # divides by a Python number as a multiply by its reciprocal, an ulp off
    # the reference's division, which can move a bin bound across an integer
    kk = torch.full((), float(k), device=rois.device)
    bin_w = (end_w - start_w).clamp(min=0.1) / kk
    bin_h = (end_h - start_h).clamp(min=0.1) / kk
    grid = torch.arange(k, dtype=torch.float32, device=rois.device)
    hs = torch.floor(grid * bin_h[..., None] + start_h[..., None])
    he = torch.ceil((grid + 1.0) * bin_h[..., None] + start_h[..., None])
    ws = torch.floor(grid * bin_w[..., None] + start_w[..., None])
    we = torch.ceil((grid + 1.0) * bin_w[..., None] + start_w[..., None])
    clip = lambda v, hi: v.clamp(0, hi).to(torch.int32)
    return clip(hs, height), clip(he, height), clip(ws, width), clip(we, width)


def bin_areas(hs, he, ws, we) -> torch.Tensor:
    """(..., N, k, k) bin pixel counts as float32 (0 for empty bins)."""
    dh = (he - hs).float().clamp(min=0.0)
    dw = (we - ws).float().clamp(min=0.0)
    return dh[..., :, None] * dw[..., None, :]


def interval_indicators(hs, he, ws, we, height: int, width: int):
    """0/1 interval indicators: R (..., N, k, H), C (..., N, k, W) float32."""
    yy = torch.arange(height, device=hs.device)
    xx = torch.arange(width, device=ws.device)
    r = (yy >= hs[..., None]) & (yy < he[..., None])
    c = (xx >= ws[..., None]) & (xx < we[..., None])
    return r.float(), c.float()


def psroi_sums_plain(maps: torch.Tensor, hs, he, ws, we) -> torch.Tensor:
    """(B, H, W, k*k*D) maps, (B, N, k) bounds -> (B, N, k, k, D) f32 bin
    sums, plain PyTorch."""
    b, h, w, c = maps.shape
    k = hs.shape[-1]
    d = c // (k * k)
    r, cind = interval_indicators(hs, he, ws, we, h, w)
    m = maps.float().reshape(b, h, w, k, k, d)
    rows = [torch.einsum("bnqx,bnxqd->bnqd", cind,
                         torch.einsum("bny,byxqd->bnxqd", r[:, :, ph],
                                      m[:, :, :, ph]))
            for ph in range(k)]
    return torch.stack(rows, dim=2)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("psroi").dtt_psroi_direct
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def psroi_sums_cuda(maps: torch.Tensor, hs, he, ws, we) -> torch.Tensor:
    """(B, H, W, k*k*D) maps, (B, N, k) int32 bounds -> (B, N, k, k, D) f32
    bin sums by the CUDA kernel.

    Launches on the current stream; counts its launches in
    ``psroi_sums_cuda.launches``.
    """
    bounds = (hs, he, ws, we)
    if not maps.is_cuda or any(t.device != maps.device for t in bounds):
        raise ValueError("psroi_sums_cuda: maps and bounds must be on one "
                         "CUDA device")
    if maps.dim() != 4 or maps.dtype not in _DTYPE_CODES:
        raise TypeError("psroi_sums_cuda: maps must be (B, H, W, k*k*D) "
                        f"float32 or bfloat16, got {tuple(maps.shape)} "
                        f"{maps.dtype}")
    b, h, w, c = maps.shape
    if hs.dim() != 3 or hs.shape[0] != b:
        raise ValueError(f"psroi_sums_cuda: bounds must be (B={b}, N, k), "
                         f"got {tuple(hs.shape)}")
    n, k = hs.shape[1], hs.shape[2]
    if any(t.shape != hs.shape or t.dtype != torch.int32 for t in bounds):
        raise TypeError("psroi_sums_cuda: bounds must be four int32 tensors "
                        "of one shape")
    if c % (k * k):
        raise ValueError(f"psroi_sums_cuda: {c} channels not divisible by "
                         f"k^2={k * k}")
    if not (maps.is_contiguous() and all(t.is_contiguous() for t in bounds)):
        raise ValueError("psroi_sums_cuda: inputs must be contiguous")
    if h * w * c >= 2 ** 31 or b * n * c >= 2 ** 62:
        raise ValueError("psroi_sums_cuda: maps too large for int32 sizes")
    d = c // (k * k)
    sums = torch.empty((b, n, k, k, d), dtype=torch.float32,
                       device=maps.device)
    if sums.numel() == 0:
        return sums
    err = _entry()(maps.data_ptr(), hs.data_ptr(), he.data_ptr(),
                   ws.data_ptr(), we.data_ptr(), sums.data_ptr(),
                   b, n, h, w, k, d, _DTYPE_CODES[maps.dtype],
                   maps.device.index,
                   torch.cuda.current_stream(maps.device).cuda_stream)
    if err:
        raise RuntimeError(f"psroi kernel launch failed: cudaError {err}")
    psroi_sums_cuda.launches += 1
    return sums


psroi_sums_cuda.launches = 0


def psroi_sums(maps: torch.Tensor, hs, he, ws, we) -> torch.Tensor:
    """Bin sums: the plain version on CPU tensors, the CUDA kernel
    otherwise (which raises off CUDA)."""
    if maps.device.type == "cpu":
        return psroi_sums_plain(maps, hs, he, ws, we)
    return psroi_sums_cuda(maps, hs, he, ws, we)


def psroi_bwd_plain(ghat: torch.Tensor, hs, he, ws, we, height: int,
                    width: int, dtype: torch.dtype) -> torch.Tensor:
    """(B, N, k, k, D) f32 ghat, (B, N, k) bounds -> (B, H, W, k*k*D) map
    gradient in `dtype`: dF[b,y,x,p,q,d] = sum_n R[b,n,p,y] ghat[b,n,p,q,d]
    C[b,n,q,x] in f32, the transpose of `psroi_sums_plain`."""
    b, _, k, _, d = ghat.shape
    r, cind = interval_indicators(hs, he, ws, we, height, width)
    rows = [torch.einsum("bny,bnxqd->byxqd", r[:, :, ph],
                         torch.einsum("bnqx,bnqd->bnxqd", cind,
                                      ghat[:, :, ph].float()))
            for ph in range(k)]
    return torch.stack(rows, dim=3).reshape(b, height, width,
                                            k * k * d).to(dtype)


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = _build.load("psroi").dtt_psroi_direct_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_MAX_BWD_ROIS = 4000  # kMaxBwdRois in csrc/psroi.cu


def psroi_bwd_cuda(ghat: torch.Tensor, hs, he, ws, we, height: int,
                   width: int, dtype: torch.dtype) -> torch.Tensor:
    """(B, N, k, k, D) f32 ghat, (B, N, k) int32 bounds -> (B, H, W, k*k*D)
    map gradient in `dtype` by the CUDA kernel.

    Launches on the current stream; counts its launches in
    ``psroi_bwd_cuda.launches``.
    """
    bounds = (hs, he, ws, we)
    if not ghat.is_cuda or any(t.device != ghat.device for t in bounds):
        raise ValueError("psroi_bwd_cuda: ghat and bounds must be on one "
                         "CUDA device")
    if ghat.dim() != 5 or ghat.dtype != torch.float32 or dtype not in \
            _DTYPE_CODES:
        raise TypeError("psroi_bwd_cuda: ghat must be (B, N, k, k, D) "
                        f"float32 and the output float32 or bfloat16, got "
                        f"{tuple(ghat.shape)} {ghat.dtype} -> {dtype}")
    b, n, k, k2, d = ghat.shape
    if k2 != k or hs.shape != (b, n, k):
        raise ValueError(f"psroi_bwd_cuda: bounds must be (B={b}, N={n}, "
                         f"k={k}) for ghat {tuple(ghat.shape)}, got "
                         f"{tuple(hs.shape)}")
    if any(t.shape != hs.shape or t.dtype != torch.int32 for t in bounds):
        raise TypeError("psroi_bwd_cuda: bounds must be four int32 tensors "
                        "of one shape")
    if not (ghat.is_contiguous() and all(t.is_contiguous() for t in bounds)):
        raise ValueError("psroi_bwd_cuda: inputs must be contiguous")
    if n > _MAX_BWD_ROIS:
        raise ValueError(f"psroi_bwd_cuda: at most {_MAX_BWD_ROIS} RoIs per "
                         f"frame, got {n}")
    if height * width * k * k * d >= 2 ** 31:
        raise ValueError("psroi_bwd_cuda: maps too large for int32 sizes")
    out = torch.empty((b, height, width, k * k * d), dtype=dtype,
                      device=ghat.device)
    if out.numel() == 0:
        return out
    err = _bwd_entry()(ghat.data_ptr(), hs.data_ptr(), he.data_ptr(),
                       ws.data_ptr(), we.data_ptr(), out.data_ptr(),
                       b, n, height, width, k, d, _DTYPE_CODES[dtype],
                       ghat.device.index,
                       torch.cuda.current_stream(ghat.device).cuda_stream)
    if err:
        raise RuntimeError(f"psroi backward kernel launch failed: cudaError "
                           f"{err}")
    psroi_bwd_cuda.launches += 1
    return out


psroi_bwd_cuda.launches = 0


def psroi_bwd(ghat: torch.Tensor, hs, he, ws, we, height: int, width: int,
              dtype: torch.dtype) -> torch.Tensor:
    """Map gradient: the plain version on CPU tensors, the CUDA kernel
    otherwise (which raises off CUDA)."""
    if ghat.device.type == "cpu":
        return psroi_bwd_plain(ghat, hs, he, ws, we, height, width, dtype)
    return psroi_bwd_cuda(ghat, hs, he, ws, we, height, width, dtype)


class _DirectPool(torch.autograd.Function):
    """Bin means of `maps` over integer bounds; the backward is the pool
    backward of ghat = g/area (0 for empty bins), as dtt's ``_direct_ad``."""

    @staticmethod
    def forward(ctx, maps, hs, he, ws, we, area):
        ctx.save_for_backward(hs, he, ws, we, area)
        ctx.maps_shape = maps.shape
        ctx.maps_dtype = maps.dtype
        sums = psroi_sums(maps, hs, he, ws, we)
        out = torch.where(area > 0, sums / area.clamp(min=1.0),
                          torch.zeros((), device=sums.device))
        return out.to(maps.dtype)

    @staticmethod
    def backward(ctx, g):
        hs, he, ws, we, area = ctx.saved_tensors
        ghat = torch.where(area > 0, g.float() / area.clamp(min=1.0),
                           torch.zeros((), device=g.device)).contiguous()
        _, h, w, _ = ctx.maps_shape
        dmaps = psroi_bwd(ghat, hs, he, ws, we, h, w, ctx.maps_dtype)
        return dmaps, None, None, None, None, None


def psroi_pool_batched_direct(features: torch.Tensor, rois: torch.Tensor,
                              spatial_scale: float, group_size: int
                              ) -> torch.Tensor:
    """(B, H, W, k*k*D) maps, (B, N, 4) RoIs -> (B, N, k, k, D) bin means
    in the maps' dtype; differentiable in the maps."""
    b, h, w, c = features.shape
    k = group_size
    if c % (k * k):
        raise ValueError(f"channels {c} not divisible by k^2={k * k}")
    hs, he, ws, we = (t.contiguous() for t in
                      roi_bounds(rois.detach(), spatial_scale, k, h, w))
    area = bin_areas(hs, he, ws, we)[..., None]
    return _DirectPool.apply(features, hs, he, ws, we, area)


def sat(features: torch.Tensor) -> torch.Tensor:
    """Zero-padded summed-area table: (B, H, W, C) -> (B, H+1, W+1, C)
    float32, the cumsum over H first, then W (``dtt``'s ``_sat``)."""
    s = features.float().cumsum(dim=1).cumsum(dim=2)
    return F.pad(s, (0, 0, 1, 0, 1, 0))


def bin_means(sums: torch.Tensor, hs, he, ws, we) -> torch.Tensor:
    """(..., N, k, k, D) f32 bin sums over their bins' areas, 0 for empty
    bins (the division every form does outside its sums)."""
    area = bin_areas(hs, he, ws, we)[..., None]
    return torch.where(area > 0, sums / area.clamp(min=1.0),
                       torch.zeros((), device=sums.device))


def psroi_sat_means_plain(table: torch.Tensor, hs, he, ws, we) -> torch.Tensor:
    """(B, H+1, W+1, k*k*D) f32 SAT, (B, N, k) bounds -> (B, N, k, k, D) f32
    bin means, plain PyTorch: the 4 corners of each bin gathered from the
    table and combined as ((S11 - S01) - S10) + S00, then divided by the
    area (``dtt``'s ``psroi_pool_xla`` and ``psroi_pool_batched`` order).
    Differentiable in the table (scatter-add backward)."""
    b, h1, w1, c = table.shape
    k = hs.shape[-1]
    flat = table.reshape(b * h1 * w1, k * k, c // (k * k))
    base = (torch.arange(b, device=hs.device) * (h1 * w1))[
        :, None, None, None]
    bins = torch.arange(k * k, device=hs.device).reshape(k, k)
    a, bb = hs[..., :, None].long(), he[..., :, None].long()   # (B, N, k, 1)
    c0, c1 = ws[..., None, :].long(), we[..., None, :].long()  # (B, N, 1, k)
    corner = lambda y, x: flat[base + y * w1 + x, bins]        # (B, N, k, k, D)
    total = corner(bb, c1) - corner(a, c1) - corner(bb, c0) + corner(a, c0)
    return bin_means(total, hs, he, ws, we)


def psroi_pool_batched(features: torch.Tensor, rois: torch.Tensor,
                       spatial_scale: float, group_size: int) -> torch.Tensor:
    """(B, H, W, k*k*D) maps, (B, N, 4) RoIs -> (B, N, k, k, D) bin means
    in the maps' dtype: the 4 SAT corners of each bin gathered in plain
    PyTorch (the ``"gather"`` pool). Differentiable in the maps through
    autograd; the RoIs take no gradient."""
    _, h, w, c = features.shape
    k = group_size
    if c % (k * k):
        raise ValueError(f"channels {c} not divisible by k^2={k * k}")
    bounds = roi_bounds(rois.detach(), spatial_scale, k, h, w)
    return psroi_sat_means_plain(sat(features), *bounds).to(features.dtype)


def row_col_indicators(hs, he, ws, we, height: int, width: int):
    """One-hot difference indicators over the SAT's rows and columns:
    R (..., N, k, H+1) = e_he - e_hs, C (..., N, k, W+1) = e_we - e_ws,
    float32."""
    yy = torch.arange(height + 1, device=hs.device)
    xx = torch.arange(width + 1, device=ws.device)
    r = (he[..., None] == yy).float() - (hs[..., None] == yy).float()
    c = (we[..., None] == xx).float() - (ws[..., None] == xx).float()
    return r, c


def psroi_mm_sums_plain(table: torch.Tensor, hs, he, ws, we) -> torch.Tensor:
    """(B, H+1, W+1, k*k*D) f32 SAT, (B, N, k) bounds -> (B, N, k, k, D)
    f32 bin sums, plain PyTorch: the bilinear form R^T SAT C per bin, the
    rows contracted first (``dtt``'s ``psroi_pool_mm`` order), one bin row
    at a time to bound the row product's memory."""
    b, h1, w1, c = table.shape
    k = hs.shape[-1]
    d = c // (k * k)
    r, cind = row_col_indicators(hs, he, ws, we, h1 - 1, w1 - 1)
    s6 = table.reshape(b, h1, w1, k, k, d)
    rows = [torch.einsum("bnqx,bnxqd->bnqd", cind,
                         torch.einsum("bny,byxqd->bnxqd", r[:, :, ph],
                                      s6[:, :, :, ph]))
            for ph in range(k)]
    return torch.stack(rows, dim=2)


@functools.lru_cache(maxsize=None)
def _sat_entry(name: str):
    fn = getattr(_build.load("psroi"), name)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_sat(wrapper, entry: str, table: torch.Tensor, bounds
                ) -> torch.Tensor:
    """Check the SAT kernels' arguments, launch `entry` on the current
    stream, count the launch on `wrapper` and return its (B, N, k, k, D)
    f32 output."""
    name = wrapper.__name__
    hs = bounds[0]
    if not table.is_cuda or any(t.device != table.device for t in bounds):
        raise ValueError(f"{name}: table and bounds must be on one CUDA "
                         "device")
    if table.dim() != 4 or table.dtype != torch.float32:
        raise TypeError(f"{name}: the SAT must be (B, H+1, W+1, k*k*D) "
                        f"float32, got {tuple(table.shape)} {table.dtype}")
    b, h1, w1, c = table.shape
    if hs.dim() != 3 or hs.shape[0] != b:
        raise ValueError(f"{name}: bounds must be (B={b}, N, k), got "
                         f"{tuple(hs.shape)}")
    n, k = hs.shape[1], hs.shape[2]
    if any(t.shape != hs.shape or t.dtype != torch.int32 for t in bounds):
        raise TypeError(f"{name}: bounds must be four int32 tensors of one "
                        "shape")
    if c % (k * k) or min(h1, w1) < 1:
        raise ValueError(f"{name}: {c} channels not divisible by k^2={k * k},"
                         " or an empty table")
    if not (table.is_contiguous() and all(t.is_contiguous() for t in bounds)):
        raise ValueError(f"{name}: inputs must be contiguous")
    if h1 * w1 * c >= 2 ** 31 or b * n * c >= 2 ** 62:
        raise ValueError(f"{name}: table too large for int32 sizes")
    d = c // (k * k)
    out = torch.empty((b, n, k, k, d), dtype=torch.float32,
                      device=table.device)
    if out.numel() == 0:
        return out
    err = _sat_entry(entry)(table.data_ptr(), *(t.data_ptr() for t in bounds),
                            out.data_ptr(), b, n, h1 - 1, w1 - 1, k, d,
                            table.device.index,
                            torch.cuda.current_stream(table.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed: cudaError {err}")
    wrapper.launches += 1
    return out


def psroi_mm_sums_cuda(table: torch.Tensor, hs, he, ws, we) -> torch.Tensor:
    """(B, H+1, W+1, k*k*D) float32 SAT, (B, N, k) int32 bounds ->
    (B, N, k, k, D) f32 bin sums by the CUDA kernel ``dtt_psroi_sat`` (4
    corner reads per output). Bounds outside [0, H] x [0, W] are clamped to
    the table.

    Launches on the current stream; counts its launches in
    ``psroi_mm_sums_cuda.launches``.
    """
    return _launch_sat(psroi_mm_sums_cuda, "dtt_psroi_sat", table,
                       (hs, he, ws, we))


psroi_mm_sums_cuda.launches = 0


def psroi_mm_sums(table: torch.Tensor, hs, he, ws, we) -> torch.Tensor:
    """SAT bin sums: the plain version on CPU tensors, the CUDA kernel
    otherwise (which raises off CUDA)."""
    if table.device.type == "cpu":
        return psroi_mm_sums_plain(table, hs, he, ws, we)
    return psroi_mm_sums_cuda(table, hs, he, ws, we)


def psroi_sat_means_cuda(table: torch.Tensor, hs, he, ws, we) -> torch.Tensor:
    """(B, H+1, W+1, k*k*D) float32 SAT, (B, N, k) int32 bounds ->
    (B, N, k, k, D) f32 bin means by the CUDA kernel ``dtt_psroi_sat_mean``:
    the plain version's corner order and division, so the same bits.

    Launches on the current stream; counts its launches in
    ``psroi_sat_means_cuda.launches``.
    """
    return _launch_sat(psroi_sat_means_cuda, "dtt_psroi_sat_mean", table,
                       (hs, he, ws, we))


psroi_sat_means_cuda.launches = 0


def psroi_sat_means(table: torch.Tensor, hs, he, ws, we) -> torch.Tensor:
    """SAT bin means: the plain version on CPU tensors, the CUDA kernel
    otherwise (which raises off CUDA)."""
    if table.device.type == "cpu":
        return psroi_sat_means_plain(table, hs, he, ws, we)
    return psroi_sat_means_cuda(table, hs, he, ws, we)


def psroi_pool_batched_pallas_mm(features: torch.Tensor, rois: torch.Tensor,
                                 spatial_scale: float, group_size: int
                                 ) -> torch.Tensor:
    """(B, H, W, k*k*D) maps, (B, N, 4) RoIs -> (B, N, k, k, D) bin means
    in the maps' dtype, off the f32 SAT (the ``"pallas_mm"`` pool, named
    after ``dtt``'s function and setting). Area and division outside the
    sums, empty bins 0. Inference only: the CUDA path has no gradient."""
    b, h, w, c = features.shape
    k = group_size
    if c % (k * k):
        raise ValueError(f"channels {c} not divisible by k^2={k * k}")
    bounds = [t.contiguous() for t in
              roi_bounds(rois.detach(), spatial_scale, k, h, w)]
    sums = psroi_mm_sums(sat(features).contiguous(), *bounds)
    return bin_means(sums, *bounds).to(features.dtype)


# ---------------------------------------------------------------- per frame
# dtt's per-frame pools: (H, W, k*k*D) maps and (N, 4) RoIs -> (N, k, k, D)
# in the maps' dtype, differentiable in the maps; the RoIs take no gradient.

def _frame_bounds(features: torch.Tensor, rois: torch.Tensor,
                  spatial_scale: float, k: int) -> list:
    """One frame's bin bounds as (1, N, k) int32 tensors."""
    h, w, c = features.shape
    if c % (k * k):
        raise ValueError(f"channels {c} not divisible by k^2={k * k}")
    return [t[None].contiguous() for t in
            roi_bounds(rois.detach(), spatial_scale, k, h, w)]


def psroi_pool_xla(features: torch.Tensor, rois: torch.Tensor,
                   spatial_scale: float, group_size: int) -> torch.Tensor:
    """The ``"xla"`` pool: the 4 SAT corners gathered in plain PyTorch (the
    gather pool at B=1), with autograd's scatter-add backward."""
    return psroi_pool_batched(features[None], rois[None], spatial_scale,
                              group_size)[0]


def psroi_pool_mm(features: torch.Tensor, rois: torch.Tensor,
                  spatial_scale: float, group_size: int) -> torch.Tensor:
    """The ``"mm"`` pool: the SAT bilinear form as plain einsums, rows
    first, area and division outside, differentiable through autograd."""
    bounds = _frame_bounds(features, rois, spatial_scale, group_size)
    sums = psroi_mm_sums_plain(sat(features[None]), *bounds)
    return bin_means(sums, *bounds)[0].to(features.dtype)


def _pallas_mm_forward(features, rois, spatial_scale, group_size):
    return psroi_pool_batched_pallas_mm(features[None], rois[None],
                                        spatial_scale, group_size)[0]


def _pallas_forward(features, rois, spatial_scale, group_size):
    bounds = _frame_bounds(features, rois, spatial_scale, group_size)
    means = psroi_sat_means(sat(features[None]).contiguous(), *bounds)
    return means[0].to(features.dtype)


class _FramePool(torch.autograd.Function):
    """A per-frame kernel pool whose backward is the scatter-add of the
    ``"xla"`` gather form, as dtt pins both Pallas pools' ``custom_vjp`` to
    AD of ``psroi_pool_xla``."""

    @staticmethod
    def forward(ctx, features, rois, spatial_scale, group_size, form):
        ctx.save_for_backward(features, rois)
        ctx.args = (spatial_scale, group_size)
        return form(features, rois, spatial_scale, group_size)

    @staticmethod
    def backward(ctx, g):
        features, rois = ctx.saved_tensors
        with torch.enable_grad():
            f = features.detach().requires_grad_()
            (df,) = torch.autograd.grad(psroi_pool_xla(f, rois, *ctx.args), f,
                                        g.to(features.dtype))
        return df, None, None, None, None


def psroi_pool_pallas_mm(features: torch.Tensor, rois: torch.Tensor,
                         spatial_scale: float, group_size: int
                         ) -> torch.Tensor:
    """The ``"pallas_mm"`` pool: SAT bin sums by ``psroi_mm_sums`` at B=1
    (the kernel ``dtt_psroi_sat`` on CUDA, which replaces the TPU kernel
    ``_psroi_mm_kernel``), area and division outside."""
    return _FramePool.apply(features, rois, spatial_scale, group_size,
                            _pallas_mm_forward)


def psroi_pool_pallas(features: torch.Tensor, rois: torch.Tensor,
                      spatial_scale: float, group_size: int) -> torch.Tensor:
    """The ``"pallas"`` pool: SAT bin means by ``psroi_sat_means`` (the
    kernel ``dtt_psroi_sat_mean`` on CUDA, which replaces the TPU kernel
    ``_psroi_kernel``), cast to the maps' dtype outside."""
    return _FramePool.apply(features, rois, spatial_scale, group_size,
                            _pallas_forward)


_FRAME_POOLS = {"xla": psroi_pool_xla, "mm": psroi_pool_mm,
                "pallas_mm": psroi_pool_pallas_mm, "pallas": psroi_pool_pallas}


def psroi_pool(features: torch.Tensor, rois: torch.Tensor,
               spatial_scale: float, group_size: int,
               impl: str = "auto") -> torch.Tensor:
    """(H, W, k*k*D) maps, (N, 4) RoIs -> (N, k, k, D) bin means by `impl`,
    dtt's names: ``"xla"`` (``"auto"``), ``"mm"``, ``"pallas_mm"`` or
    ``"pallas"``."""
    if impl == "auto":
        impl = "xla"
    if impl not in _FRAME_POOLS:
        raise ValueError(f"unknown psroi impl {impl!r}")
    return _FRAME_POOLS[impl](features, rois, spatial_scale, group_size)
