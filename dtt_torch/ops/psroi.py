"""Position-sensitive RoI pooling (counterpart of ``dtt.ops.psroi``): the
frame-batched pools (``psroi_pool_batched_direct`` with ``_direct_ad``,
``psroi_pool_batched``, ``psroi_pool_batched_pallas_mm``) and the per-frame
``psroi_pool`` with its four ``impl`` forms.

Caffe/R-FCN bin bounds (``roi_bounds``), then per (frame, RoI, bin,
channel) the sum of the map over the bin, divided by the bin's area, with
empty bins 0. Channels are dtt's bin-major ``c = (ph*k + pw)*D + d``.

* `psroi_sums_plain` / `psroi_sums_cuda` / `psroi_sums` — the bin sums:
  interval-indicator contractions in f32 (the reference the kernel is held
  against; the CPU path), the hand-written kernel ``dtt_psroi_direct`` in
  ``csrc/psroi.cu`` (replaces the TPU kernel ``_psroi_direct_kernel``: one
  thread per channel vector of a bin, loads as wide as D allows, 8 pixels
  in flight), and
  the dispatcher that takes the plain version for CPU tensors and the
  kernel otherwise.
* `psroi_bwd_plain` / `psroi_bwd_cuda` / `psroi_bwd` — the same three for
  the map gradient from ghat = g/area (the kernel ``dtt_psroi_direct_bwd``
  replaces ``_psroi_direct_bwd_kernel``: a block per (frame, output row,
  column tile, bin row) lists the RoIs whose bin row holds the output row,
  adds each one's ghat over only the columns its bins cover and writes the
  row with 16-byte stores; deterministic).
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
  the dispatcher; `psroi_mm_means_plain` / `psroi_mm_means_cuda` /
  `psroi_mm_means` the same sums over the bins' areas (``bin_means``), in
  the kernel's mean mode on CUDA.
* `psroi_pool_batched_pallas_mm` — those bin means, inference only, as
  ``dtt``'s function of the same name (which divides outside its kernel).
* `psroi_sat_means_plain` / `psroi_sat_means_cuda` / `psroi_sat_means` —
  the gather form's bin means off the SAT: the corners combined as
  ((S11 - S01) - S10) + S00 and divided by the area (the reference the
  kernel is held against; the CPU path), the kernel ``dtt_psroi_sat_mean``
  in ``csrc/psroi.cu`` (replaces the TPU kernel ``_psroi_kernel``), and the
  dispatcher.
* `psroi_sat_group_cuda` / `psroi_sat_group` — one launch of either SAT
  kernel (``SAT_FORMS``) for 1 to 4 (table, bounds) members, and the
  dispatcher (the plain version per member on the CPU); every single
  wrapper above is a group of one.

Per frame, ``psroi_pool(impl=...)`` with dtt's names: ``"xla"`` (the
gather form at B=1, the default), ``"mm"`` (the bilinear form as einsums),
``"pallas_mm"`` (``psroi_mm_means`` at B=1: the TPU kernel
``_psroi_mm_kernel`` has ``_psroi_mm_kernel_b``'s body without the frame
axis, so the port launches the one kernel for both) and ``"pallas"``
(``psroi_sat_means``); `psroi_pool_maps` pools several maps at the same
RoIs, in one launch under the two kernel forms. The kernel forms are
autograd functions whose backward is the ``"xla"`` form's scatter-add per
map, as dtt pins both.

Numerics: the sums stay f32 throughout. The TPU kernels round their bf16
row partial sums (forward) and ghat expansions (backward) to bf16 inside
their matmuls, so bf16 results differ from them by that rounding. SAT
entries grow to H*W times the map's values, so a SAT pool's bin mean is a
difference of large f32 numbers; its error is a few ulps of the SAT.
"""

from __future__ import annotations

import array
import ctypes
import functools

import torch
import torch.nn.functional as F

from dtt_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = _build.SMEM_LIMIT  # kMaxSmem


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
    if h * w * c >= 2 ** 31 or b * n * c >= 2 ** 31:
        raise ValueError("psroi_sums_cuda: maps or sums too large for int32 "
                         "sizes")
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


def _bwd_smem_bytes(k: int, d: int) -> int:
    """Shared memory of one ``dtt_psroi_direct_bwd`` block at its widest
    tile (csrc/psroi.cu ``bwd_smem``): a tile of max(1, 8192 // (k*D))
    pixels x the k*D channels of one bin row in f32, the warps' counts and
    a 256-RoI list (index and k bin columns)."""
    kd = k * d
    tile = max(1, 8192 // kd) * kd * 4
    return (tile + 15) // 16 * 16 + 4 * (8 + 256 * (1 + k))


def psroi_bwd_cuda(ghat: torch.Tensor, hs, he, ws, we, height: int,
                   width: int, dtype: torch.dtype) -> torch.Tensor:
    """(B, N, k, k, D) f32 ghat, (B, N, k) int32 bounds -> (B, H, W, k*k*D)
    map gradient in `dtype` by the CUDA kernel: each element summed by one
    thread in RoI order (no atomics), so the result is the same bits from
    run to run. Any number of RoIs; one pixel's k*D channels of a bin row
    in f32 must fit a block's shared memory beside the RoI list
    (``_bwd_smem_bytes``).

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
    smem = _bwd_smem_bytes(k, d)
    if smem > _MAX_SMEM:
        raise ValueError(f"psroi_bwd_cuda: one pixel's k*D = {k * d} channels"
                         f" of a bin row in float32 beside a 256-RoI list of "
                         f"{k} bin columns need {smem:,} bytes of shared "
                         f"memory, more than a block's {_MAX_SMEM:,}")
    if height * width * k * k * d >= 2 ** 31 or max(b * k, height) >= 2 ** 16:
        raise ValueError("psroi_bwd_cuda: maps too large for int32 sizes or "
                         "the grid (frames x k and rows < 65536)")
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


def psroi_mm_means_plain(table: torch.Tensor, hs, he, ws, we) -> torch.Tensor:
    """``psroi_mm_sums_plain`` divided by the bins' areas, empty bins 0
    (``bin_means``): the ``"pallas_mm"`` pool's bin means."""
    return bin_means(psroi_mm_sums_plain(table, hs, he, ws, we),
                     hs, he, ws, we)


# The SAT pool forms: each C entry and its mode argument. Kernels 4 and 5
# (bin sums, and the sums divided by the area in the kernel) are
# ``dtt_psroi_sat``; kernel 6 (the gather form's bin means) is
# ``dtt_psroi_sat_mean``. One launch pools 1 to 4 (table, bounds) members.
SAT_FORMS = {"mm_sums": ("dtt_psroi_sat", 0),
             "mm_means": ("dtt_psroi_sat", 1),
             "sat_means": ("dtt_psroi_sat_mean", None)}
_SAT_MAX_MEMBERS = 4
_SAT_MAX_K = 32          # a block stages one RoI's k*k bins: kSatMaxBins


@functools.lru_cache(maxsize=None)
def _sat_entry(name: str):
    fn = getattr(_build.load("psroi"), name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int,
                   *([ctypes.c_int] if name == "dtt_psroi_sat" else []),
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _sat_args(name: str, members) -> list:
    """Check a SAT pool group's members, (table, (hs, he, ws, we)) each,
    and return each member's output shape (B, N, k, k, D). Every member is
    checked (the launch's host time is most of a frame's pool time, so
    each check is one cheap test); all lie on the CUDA device of the
    first table."""
    if not 1 <= len(members) <= _SAT_MAX_MEMBERS:
        raise ValueError(f"{name}: 1 to {_SAT_MAX_MEMBERS} (table, bounds) "
                         f"members a launch, got {len(members)}")
    f32, i32 = torch.float32, torch.int32
    device = members[0][0].get_device()
    shapes, pairs = [], 0
    for table, bounds in members:
        if table.dtype is not f32 or table.dim() != 4:
            raise TypeError(f"{name}: the SAT must be (B, H+1, W+1, k*k*D) "
                            f"float32, got {tuple(table.shape)} "
                            f"{table.dtype}")
        b, h1, w1, c = table.shape
        if len(bounds) != 4:
            raise ValueError(f"{name}: bounds are (hs, he, ws, we), got "
                             f"{len(bounds)} tensors")
        hs, he, ws, we = bounds
        s = hs.shape
        if len(s) != 3 or s[0] != b:
            raise ValueError(f"{name}: bounds must be (B={b}, N, k), got "
                             f"{tuple(s)}")
        if he.shape != s or ws.shape != s or we.shape != s or not (
                hs.dtype is i32 and he.dtype is i32 and ws.dtype is i32
                and we.dtype is i32):
            raise TypeError(f"{name}: bounds must be four int32 tensors of "
                            "one shape")
        _, n, k = s
        if c % (k * k) or h1 < 1 or w1 < 1:
            raise ValueError(f"{name}: {c} channels not divisible by "
                             f"k^2={k * k}, or an empty table")
        if k > _SAT_MAX_K:
            raise ValueError(f"{name}: k={k} > {_SAT_MAX_K}: a block stages "
                             "one RoI's k*k bins")
        if not (table.is_contiguous() and hs.is_contiguous()
                and he.is_contiguous() and ws.is_contiguous()
                and we.is_contiguous()):
            raise ValueError(f"{name}: inputs must be contiguous")
        if h1 * w1 * c >= 2 ** 31:
            raise ValueError(f"{name}: a frame's table must have < 2^31 "
                             f"elements (32-bit offsets), got {h1 * w1 * c}")
        pairs += b * n
        if pairs >= 2 ** 31:
            raise ValueError(f"{name}: {pairs} (frame, RoI) pairs in one "
                             "launch: the grid holds < 2^31")
        if device < 0 or table.get_device() != device or \
                hs.get_device() != device or he.get_device() != device or \
                ws.get_device() != device or we.get_device() != device:
            raise ValueError(f"{name}: tables and bounds must be on one CUDA "
                             "device")
        shapes.append((b, n, k, k, c // (k * k)))
    return shapes


def psroi_sat_group_cuda(form: str, members) -> list:
    """One CUDA launch of SAT pool `form` (``SAT_FORMS``) for 1 to 4
    members, each a (B, H+1, W+1, k*k*D) float32 SAT and its (B, N, k)
    int32 bounds (hs, he, ws, we); members may differ in every size.
    Returns each member's (B, N, k, k, D) f32 output: ``"mm_sums"`` the bin
    sums, ``"mm_means"`` those over the areas, ``"sat_means"`` the gather
    form's bin means (empty bins 0), the plain versions' bits. Bounds
    outside [0, H] x [0, W] are clamped to the table.

    Launches on the current stream. ``dtt_psroi_sat``'s launches count in
    ``psroi_mm_sums_cuda.launches``, ``dtt_psroi_sat_mean``'s in
    ``psroi_sat_means_cuda.launches``.
    """
    entry, mode = SAT_FORMS[form]
    shapes = _sat_args(entry, members)
    outs, args = [], []
    for (table, (hs, he, ws, we)), shape in zip(members, shapes):
        out = table.new_empty(shape)
        outs.append(out)
        args += (table.data_ptr(), hs.data_ptr(), he.data_ptr(),
                 ws.data_ptr(), we.data_ptr(), out.data_ptr(), shape[0],
                 shape[1], table.shape[1] - 1, table.shape[2] - 1, shape[2],
                 shape[4])
    if not any(b * n for b, n, *_ in shapes):
        return outs
    argv = array.array("q", args)
    device = members[0][0].get_device()
    # the raw current stream (torch.cuda.current_stream builds a Stream
    # object, several microseconds of the launch's host time)
    stream = torch._C._cuda_getCurrentRawStream(device)
    fn = _sat_entry(entry)
    err = (fn(argv.buffer_info()[0], len(members), device, stream)
           if mode is None else
           fn(argv.buffer_info()[0], len(members), mode, device, stream))
    if err:
        raise RuntimeError(f"{entry}: kernel launch failed: cudaError {err}")
    counter = psroi_mm_sums_cuda if mode is not None else psroi_sat_means_cuda
    counter.launches += 1
    return outs


SAT_PLAIN = {"mm_sums": psroi_mm_sums_plain, "mm_means": psroi_mm_means_plain,
              "sat_means": psroi_sat_means_plain}


def psroi_sat_group(form: str, members) -> list:
    """SAT pool `form` of each (table, bounds) member: the plain version per
    member on CPU tensors, one CUDA launch otherwise (which raises off
    CUDA)."""
    if members[0][0].device.type == "cpu":
        return [SAT_PLAIN[form](table, *bounds) for table, bounds in members]
    return psroi_sat_group_cuda(form, members)


def psroi_mm_sums_cuda(table: torch.Tensor, hs, he, ws, we) -> torch.Tensor:
    """(B, H+1, W+1, k*k*D) float32 SAT, (B, N, k) int32 bounds ->
    (B, N, k, k, D) f32 bin sums by the CUDA kernel ``dtt_psroi_sat`` (4
    corner reads per output), ``psroi_mm_sums_plain``'s bits.

    Launches on the current stream; ``psroi_mm_sums_cuda.launches`` counts
    every launch of ``dtt_psroi_sat`` (``psroi_sat_group_cuda``).
    """
    return psroi_sat_group_cuda("mm_sums", [(table, (hs, he, ws, we))])[0]


psroi_mm_sums_cuda.launches = 0


def psroi_mm_sums(table: torch.Tensor, hs, he, ws, we) -> torch.Tensor:
    """SAT bin sums: the plain version on CPU tensors, the CUDA kernel
    otherwise (which raises off CUDA)."""
    return psroi_sat_group("mm_sums", [(table, (hs, he, ws, we))])[0]


def psroi_mm_means_cuda(table: torch.Tensor, hs, he, ws, we) -> torch.Tensor:
    """The bin sums of ``psroi_mm_sums_cuda`` divided by the bins' areas in
    the same launch (``dtt_psroi_sat``'s mean mode), empty bins 0:
    ``psroi_mm_means_plain``'s bits. Counted in
    ``psroi_mm_sums_cuda.launches``."""
    return psroi_sat_group_cuda("mm_means", [(table, (hs, he, ws, we))])[0]


def psroi_mm_means(table: torch.Tensor, hs, he, ws, we) -> torch.Tensor:
    """SAT bin sums over the areas: the plain version on CPU tensors, the
    CUDA kernel otherwise (which raises off CUDA)."""
    return psroi_sat_group("mm_means", [(table, (hs, he, ws, we))])[0]


def psroi_sat_means_cuda(table: torch.Tensor, hs, he, ws, we) -> torch.Tensor:
    """(B, H+1, W+1, k*k*D) float32 SAT, (B, N, k) int32 bounds ->
    (B, N, k, k, D) f32 bin means by the CUDA kernel ``dtt_psroi_sat_mean``:
    the plain version's corner order and division, so the same bits.

    Launches on the current stream; ``psroi_sat_means_cuda.launches``
    counts every launch of ``dtt_psroi_sat_mean``.
    """
    return psroi_sat_group_cuda("sat_means", [(table, (hs, he, ws, we))])[0]


psroi_sat_means_cuda.launches = 0


def psroi_sat_means(table: torch.Tensor, hs, he, ws, we) -> torch.Tensor:
    """SAT bin means: the plain version on CPU tensors, the CUDA kernel
    otherwise (which raises off CUDA)."""
    return psroi_sat_group("sat_means", [(table, (hs, he, ws, we))])[0]


def psroi_pool_batched_pallas_mm(features: torch.Tensor, rois: torch.Tensor,
                                 spatial_scale: float, group_size: int
                                 ) -> torch.Tensor:
    """(B, H, W, k*k*D) maps, (B, N, 4) RoIs -> (B, N, k, k, D) bin means
    in the maps' dtype, off the f32 SAT (the ``"pallas_mm"`` pool, named
    after ``dtt``'s function and setting): the bin sums over the areas,
    empty bins 0, in one kernel launch on CUDA (``dtt`` divides outside its
    kernel; the bits are the same). Inference only: the CUDA path has no
    gradient."""
    b, h, w, c = features.shape
    k = group_size
    if c % (k * k):
        raise ValueError(f"channels {c} not divisible by k^2={k * k}")
    bounds = [t.contiguous() for t in
              roi_bounds(rois.detach(), spatial_scale, k, h, w)]
    return psroi_mm_means(sat(features).contiguous(),
                          *bounds).to(features.dtype)


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


# the per-frame kernel pools: ``"pallas_mm"`` (kernel 5, whose TPU kernel
# ``_psroi_mm_kernel`` is ``_psroi_mm_kernel_b`` without the frame axis, so
# the port launches the one kernel at B=1; dtt divides outside its kernel,
# the port in it, with the same bits) and ``"pallas"`` (kernel 6)
_FRAME_KERNEL_FORMS = {"pallas_mm": "mm_means", "pallas": "sat_means"}


def _kernel_pools(maps, rois, spatial_scale, group_size, form) -> tuple:
    """Each map's bin means by SAT pool `form`, one launch for all maps on
    CUDA; maps of one size share their bounds."""
    k = group_size
    members, bounds = [], {}
    for m in maps:
        h, w, c = m.shape
        if c % (k * k):
            raise ValueError(f"channels {c} not divisible by k^2={k * k}")
        if (h, w) not in bounds:
            bounds[h, w] = [t[None].contiguous() for t in
                            roi_bounds(rois.detach(), spatial_scale, k, h, w)]
        members.append((sat(m[None]).contiguous(), bounds[h, w]))
    return tuple(out[0].to(m.dtype) for out, m in
                 zip(psroi_sat_group(form, members), maps))


class _FramePools(torch.autograd.Function):
    """A per-frame kernel pool of one or more maps at the same RoIs, one
    launch for all of them; each map's backward is the scatter-add of the
    ``"xla"`` gather form, as dtt pins both Pallas pools' ``custom_vjp`` to
    AD of ``psroi_pool_xla``."""

    @staticmethod
    def forward(ctx, rois, spatial_scale, group_size, form, *maps):
        ctx.save_for_backward(rois, *maps)
        ctx.args = (spatial_scale, group_size)
        ctx.set_materialize_grads(False)
        return _kernel_pools(maps, rois, spatial_scale, group_size, form)

    @staticmethod
    def backward(ctx, *grads):
        rois, *maps = ctx.saved_tensors
        dmaps = []
        for m, g, need in zip(maps, grads, ctx.needs_input_grad[4:]):
            if g is None or not need:
                dmaps.append(None)
                continue
            with torch.enable_grad():
                f = m.detach().requires_grad_()
                (df,) = torch.autograd.grad(psroi_pool_xla(f, rois, *ctx.args),
                                            f, g.to(m.dtype))
            dmaps.append(df)
        return (None, None, None, None, *dmaps)


def psroi_pool_pallas_mm(features: torch.Tensor, rois: torch.Tensor,
                         spatial_scale: float, group_size: int
                         ) -> torch.Tensor:
    """The ``"pallas_mm"`` pool: the SAT bin sums over the areas by
    ``psroi_mm_means`` at B=1 (the kernel ``dtt_psroi_sat`` on CUDA, which
    replaces the TPU kernel ``_psroi_mm_kernel``)."""
    return _FramePools.apply(rois, spatial_scale, group_size, "mm_means",
                             features)[0]


def psroi_pool_pallas(features: torch.Tensor, rois: torch.Tensor,
                      spatial_scale: float, group_size: int) -> torch.Tensor:
    """The ``"pallas"`` pool: SAT bin means by ``psroi_sat_means`` (the
    kernel ``dtt_psroi_sat_mean`` on CUDA, which replaces the TPU kernel
    ``_psroi_kernel``), cast to the maps' dtype outside."""
    return _FramePools.apply(rois, spatial_scale, group_size, "sat_means",
                             features)[0]


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


def psroi_pool_maps(maps, rois: torch.Tensor, spatial_scale: float,
                    group_size: int, impl: str = "auto") -> tuple:
    """``psroi_pool`` of each of several (H, W, k*k*D_i) maps at the same
    (N, 4) RoIs -> a tuple of (N, k, k, D_i), each the bits of its own
    ``psroi_pool`` call. Under ``"pallas_mm"`` and ``"pallas"`` one kernel
    launch pools up to 4 maps."""
    if impl == "auto":
        impl = "xla"
    if impl not in _FRAME_POOLS:
        raise ValueError(f"unknown psroi impl {impl!r}")
    if impl in _FRAME_KERNEL_FORMS:
        return _FramePools.apply(rois, spatial_scale, group_size,
                                 _FRAME_KERNEL_FORMS[impl], *maps)
    return tuple(_FRAME_POOLS[impl](m, rois, spatial_scale, group_size)
                 for m in maps)
