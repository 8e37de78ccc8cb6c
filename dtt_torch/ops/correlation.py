"""FlowNet-style cross-frame correlation (counterpart of ``dtt.ops.correlation``).

    corr[b, y, x, j(dy, dx)] = (1/C) * sum_c f1[b, y, x, c] * f2[b, y+dy, x+dx, c]

with dy, dx in {-d, -d+s, ..., d}, dy-major channel order, zero padding
outside f2, f32 accumulation and the result in the input dtype. Maps are
NHWC, batched over frame pairs.

* `correlation_plain` (also `correlation_xla`) — shifted multiply-reduce
  in PyTorch (the reference the kernels are held against; the CPU path).
  dtt's banded-matmul forms ``mm`` and ``mm_diag`` exist to choose between
  the TPU's matrix and vector units; they compute the same function, so
  here both names select this form.
* `correlation_cuda` — the hand-written kernel ``dtt_correlation`` in
  ``csrc/correlation.cu``, which replaces the TPU kernel
  ``_corr_mm_kernel`` (dtt/ops/correlation.py): bfloat16 maps on the
  tensor cores (``max_displacement`` <= 8), float32 maps on the CUDA cores.
  See the source for its design.
* `correlation_split_cuda` — the kernel ``dtt_correlation_split`` in the
  same source, channel blocks summed by concurrent blocks; replaces the TPU
  kernel ``_corr_kernel``.
* `correlation_bwd_plain` / `correlation_bwd_cuda` — the gradients of both
  inputs: the shifted multiply form, and a kernel in the same source (dtt
  differentiates its forward with XLA's AD instead).
* `correlation_pallas_mm` / `correlation_pallas` — differentiable forms over
  the two forward kernels sharing that backward (the plain versions for
  CPU tensors).
* `correlation(impl=...)` — dtt's names: ``"auto"`` (= ``"pallas_mm"``),
  ``"xla"``, ``"mm"``, ``"mm_diag"``, ``"pallas_mm"``, ``"pallas"``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from dtt_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ND = 9  # kMaxNd in csrc/correlation.cu
_TC_MAX_D = 8  # kMaxD: the bf16 tensor-core bodies' band of 16 + 2d <= 32


def offsets(max_displacement: int, stride: int) -> list:
    return list(range(-max_displacement, max_displacement + 1, stride))


def num_corr_channels(max_displacement: int, stride: int) -> int:
    return len(offsets(max_displacement, stride)) ** 2


def correlation_plain(f1: torch.Tensor, f2: torch.Tensor,
                      max_displacement: int = 8, stride: int = 2
                      ) -> torch.Tensor:
    """(B, H, W, C) x2 -> (B, H, W, nd^2), plain PyTorch."""
    _, h, w, c = f1.shape
    d = max_displacement
    a = f1.float()
    f2p = F.pad(f2.float(), (0, 0, d, d, d, d))
    outs = []
    for dy in offsets(d, stride):
        for dx in offsets(d, stride):
            sl = f2p[:, d + dy:d + dy + h, d + dx:d + dx + w, :]
            outs.append((a * sl).sum(dim=-1) / c)
    return torch.stack(outs, dim=-1).to(f1.dtype)


correlation_xla = correlation_plain


def correlation_bwd_plain(f1: torch.Tensor, f2: torch.Tensor,
                          g: torch.Tensor, max_displacement: int = 8,
                          stride: int = 2):
    """Gradients of `correlation_plain` for the output gradient g
    (B, H, W, nd^2): (df1, df2) in the inputs' dtype, summed in f32."""
    _, h, w, c = f1.shape
    d = max_displacement
    pad = (0, 0, d, d, d, d)
    a = f1.float()
    f2p = F.pad(f2.float(), pad)
    gg = g.float()
    df1 = torch.zeros_like(a)
    df2p = torch.zeros_like(f2p)
    j = 0
    for dy in offsets(d, stride):
        for dx in offsets(d, stride):
            gj = gg[..., j:j + 1]
            df1 += gj * f2p[:, d + dy:d + dy + h, d + dx:d + dx + w, :]
            df2p[:, d + dy:d + dy + h, d + dx:d + dx + w, :] += gj * a
            j += 1
    df2 = df2p[:, d:d + h, d:d + w, :]
    return (df1 / c).to(f1.dtype), (df2 / c).to(f2.dtype)


def _check_maps(name: str, f1: torch.Tensor, f2: torch.Tensor,
                max_displacement: int, stride: int) -> None:
    if not (f1.is_cuda and f2.device == f1.device):
        raise ValueError(f"{name}: f1 and f2 must be on one CUDA device, got "
                         f"{f1.device} and {f2.device}")
    if f1.dim() != 4 or f1.shape != f2.shape:
        raise ValueError(f"{name}: expected two (B, H, W, C) maps of one "
                         f"shape, got {tuple(f1.shape)} and "
                         f"{tuple(f2.shape)}")
    if f1.dtype not in _DTYPE_CODES or f2.dtype != f1.dtype:
        raise TypeError(f"{name}: float32 or bfloat16 maps of one dtype, got "
                        f"{f1.dtype} and {f2.dtype}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError(f"{name}: maps must be contiguous NHWC")
    if stride < 1 or max_displacement < 0 or (
            len(offsets(max_displacement, stride)) > _MAX_ND):
        raise ValueError(f"{name}: needs stride >= 1 and at most {_MAX_ND} "
                         f"displacements per axis, got d={max_displacement},"
                         f" s={stride}")
    if f1.numel() >= 2 ** 31:
        raise ValueError(f"{name}: maps too large for int32 sizes")


def _check_band(name: str, f1: torch.Tensor, max_displacement: int) -> None:
    """The bf16 tensor-core bodies take max_displacement <= 8."""
    if f1.dtype == torch.bfloat16 and max_displacement > _TC_MAX_D:
        raise ValueError(f"{name}: the bfloat16 tensor-core kernel takes "
                         f"max_displacement <= {_TC_MAX_D}, got "
                         f"{max_displacement}")


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("correlation").dtt_correlation
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def correlation_cuda(f1: torch.Tensor, f2: torch.Tensor,
                     max_displacement: int = 8, stride: int = 2
                     ) -> torch.Tensor:
    """(B, H, W, C) x2 -> (B, H, W, nd^2) by the CUDA kernel.

    Launches on the current stream; counts its launches in
    ``correlation_cuda.launches``.
    """
    _check_maps("correlation_cuda", f1, f2, max_displacement, stride)
    _check_band("correlation_cuda", f1, max_displacement)
    b, h, w, c = f1.shape
    out = torch.empty((b, h, w, num_corr_channels(max_displacement, stride)),
                      dtype=f1.dtype, device=f1.device)
    if out.numel() == 0:
        return out
    err = _entry()(f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, h, w, c,
                   max_displacement, stride, _DTYPE_CODES[f1.dtype],
                   f1.device.index,
                   torch.cuda.current_stream(f1.device).cuda_stream)
    if err:
        raise RuntimeError(f"correlation kernel launch failed: cudaError {err}")
    correlation_cuda.launches += 1
    return out


correlation_cuda.launches = 0

# channels per block of dtt_correlation_split (dtt's channel_block)
_SPLIT_C = 128


@functools.lru_cache(maxsize=None)
def _split_entry():
    fn = _build.load("correlation").dtt_correlation_split
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def correlation_split_cuda(f1: torch.Tensor, f2: torch.Tensor,
                           max_displacement: int = 8, stride: int = 2
                           ) -> torch.Tensor:
    """(B, H, W, C) x2 -> (B, H, W, nd^2) by the channel-split CUDA kernel:
    one block per 128-channel block writes its f32 partial planes to a
    workspace, a second kernel sums them in block order.

    Launches on the current stream; counts its launches in
    ``correlation_split_cuda.launches``.
    """
    _check_maps("correlation_split_cuda", f1, f2, max_displacement, stride)
    b, h, w, c = f1.shape
    nblk = -(-c // _SPLIT_C)
    if c < 1 or b * nblk >= 2 ** 16:
        raise ValueError(f"correlation_split_cuda: needs 1 <= C and B * "
                         f"ceil(C / {_SPLIT_C}) < 65536, got B={b}, C={c}")
    nd2 = num_corr_channels(max_displacement, stride)
    out = torch.empty((b, h, w, nd2), dtype=f1.dtype, device=f1.device)
    if out.numel() == 0:
        return out
    part = torch.empty((nblk, b, h, w, nd2), dtype=torch.float32,
                       device=f1.device)
    err = _split_entry()(f1.data_ptr(), f2.data_ptr(), part.data_ptr(),
                         out.data_ptr(), b, h, w, c, max_displacement, stride,
                         _SPLIT_C, _DTYPE_CODES[f1.dtype], f1.device.index,
                         torch.cuda.current_stream(f1.device).cuda_stream)
    if err:
        raise RuntimeError(f"correlation split kernel launch failed: "
                           f"cudaError {err}")
    correlation_split_cuda.launches += 1
    return out


correlation_split_cuda.launches = 0


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = _build.load("correlation").dtt_correlation_bwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def correlation_bwd_cuda(f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor,
                         max_displacement: int = 8, stride: int = 2):
    """Gradients (df1, df2) of the correlation for the output gradient g
    (B, H, W, nd^2) of the maps' dtype, by the CUDA kernel.

    Launches on the current stream; counts its launches in
    ``correlation_bwd_cuda.launches``.
    """
    _check_maps("correlation_bwd_cuda", f1, f2, max_displacement, stride)
    _check_band("correlation_bwd_cuda", f1, max_displacement)
    b, h, w, c = f1.shape
    nd2 = num_corr_channels(max_displacement, stride)
    if g.shape != (b, h, w, nd2) or g.dtype != f1.dtype or \
            g.device != f1.device or not g.is_contiguous():
        raise ValueError(f"correlation_bwd_cuda: g must be a contiguous "
                         f"({b}, {h}, {w}, {nd2}) {f1.dtype} tensor on "
                         f"{f1.device}, got {tuple(g.shape)} {g.dtype}")
    df1 = torch.empty_like(f1)
    df2 = torch.empty_like(f2)
    if df1.numel() == 0:
        return df1, df2
    err = _bwd_entry()(f1.data_ptr(), f2.data_ptr(), g.data_ptr(),
                       df1.data_ptr(), df2.data_ptr(), b, h, w, c,
                       max_displacement, stride, _DTYPE_CODES[f1.dtype],
                       f1.device.index,
                       torch.cuda.current_stream(f1.device).cuda_stream)
    if err:
        raise RuntimeError(f"correlation backward kernel launch failed: "
                           f"cudaError {err}")
    correlation_bwd_cuda.launches += 1
    return df1, df2


correlation_bwd_cuda.launches = 0


class _Correlation(torch.autograd.Function):
    """The plain versions on CPU tensors; on CUDA tensors the forward
    kernel `kernel` and the backward kernel. The output gradient is taken
    in the maps' dtype, as dtt casts it."""

    @staticmethod
    def forward(ctx, f1, f2, max_displacement, stride, kernel):
        ctx.save_for_backward(f1, f2)
        ctx.window = (max_displacement, stride)
        if f1.device.type == "cpu":
            return correlation_plain(f1, f2, max_displacement, stride)
        return kernel(f1, f2, max_displacement, stride)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        g = g.to(f1.dtype).contiguous()
        bwd = (correlation_bwd_plain if f1.device.type == "cpu"
               else correlation_bwd_cuda)
        df1, df2 = bwd(f1, f2, g, *ctx.window)
        return df1, df2, None, None, None


def correlation_pallas_mm(f1: torch.Tensor, f2: torch.Tensor,
                          max_displacement: int = 8, stride: int = 2
                          ) -> torch.Tensor:
    """Differentiable correlation by ``correlation_cuda`` on CUDA tensors,
    the plain version on CPU tensors."""
    return _Correlation.apply(f1, f2, max_displacement, stride,
                              correlation_cuda)


def correlation_pallas(f1: torch.Tensor, f2: torch.Tensor,
                       max_displacement: int = 8, stride: int = 2
                       ) -> torch.Tensor:
    """Differentiable correlation by ``correlation_split_cuda`` on CUDA
    tensors, the plain version on CPU tensors; the backward is
    ``correlation_pallas_mm``'s, as dtt pins both to one backward."""
    return _Correlation.apply(f1, f2, max_displacement, stride,
                              correlation_split_cuda)


_FORMS = {"xla": correlation_xla, "mm": correlation_plain,
          "mm_diag": correlation_plain, "pallas_mm": correlation_pallas_mm,
          "pallas": correlation_pallas}


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                max_displacement: int = 8, stride: int = 2,
                impl: str = "auto") -> torch.Tensor:
    """(B, H, W, C) x2 -> (B, H, W, nd^2), differentiable in both maps, by
    `impl` (dtt's names; ``"auto"`` is ``"pallas_mm"``: the CUDA kernels on
    CUDA tensors, which raise off CUDA, the plain versions on the CPU)."""
    if f1.shape != f2.shape:
        raise ValueError(f"correlation: maps of one shape, got "
                         f"{tuple(f1.shape)} and {tuple(f2.shape)}")
    if impl == "auto":
        impl = "pallas_mm"
    if impl not in _FORMS:
        raise ValueError(f"unknown correlation impl {impl!r}")
    return _FORMS[impl](f1, f2, max_displacement, stride)
