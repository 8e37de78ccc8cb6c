"""The trunk's conv epilogue (kernel 10): the frozen-BN affine, the ReLU and
the residual add after a conv, in one pass forward and one backward.

``dtt`` traces its trunk into one jitted program, where XLA may fuse each
conv's affine, ReLU and residual add; the port's eager trunk ran each of
them as its own pass over the activations. With x the conv's output, z the
block's shortcut and the ``FrozenAffine`` float32 buffers (scale, bias) and
(scale_z, bias_z) cast to x's dtype first, as ``.to(x.dtype)`` does:

* form A, ``z`` None: ``relu(x * scale + bias)`` (the stem's ``bn1``, each
  block's ``bn1`` and ``bn2``);
* form B, ``z`` given: ``relu(x * scale + bias + z)`` (``bn3`` with an
  identity shortcut);
* form C, ``z``, ``scale_z`` and ``bias_z`` given: ``relu(x * scale + bias
  + (z * scale_z + bias_z))`` (``bn3`` with ``downsample_bn`` on z),

each product and sum rounded to the dtype as the eager ops round it.
``conv_epilogue_plain`` is those eager ops; ``conv_epilogue_cuda`` and
``conv_epilogue_bwd_cuda`` launch ``dtt_conv_epilogue`` and
``dtt_conv_epilogue_bwd`` (``csrc/epilogue.cu``), which give their bits.
``conv_epilogue`` dispatches: the plain version for CPU tensors (autograd
differentiates its ops), the kernels for CUDA tensors (or an error),
through ``_ConvEpilogue`` when a gradient is recorded.
``conv_epilogue_bwd_plain`` is the backward kernel's reference. The
buffers take no gradient. The wrappers launch on the current device's
current stream: tensors on another device raise.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dtt_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
FORMS = ("A", "B", "C")
# the C entries' `code`: the form in bits 0-1, bfloat16 in bit 2
_CODES = {(f, d): FORMS.index(f) | c << 2
          for f in FORMS for d, c in _DTYPE_CODES.items()}
_CL = torch.channels_last


def form_of(z, scale_z) -> str:
    """The epilogue form of a call: A without a shortcut, B with an
    identity one, C with an affine on it."""
    return "A" if z is None else "B" if scale_z is None else "C"


def _cast(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A (C,) buffer in `dtype`, broadcast over (H, W); no gradient."""
    return p.detach().to(dtype)[:, None, None]


def conv_epilogue_plain(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, z: torch.Tensor | None = None,
                        scale_z: torch.Tensor | None = None,
                        bias_z: torch.Tensor | None = None) -> torch.Tensor:
    """The epilogue as the eager ops of ``FrozenAffine`` and ``F.relu``:
    (N, C, H, W) x (and z), (C,) buffers."""
    y = x * _cast(scale, x.dtype) + _cast(bias, x.dtype)
    if scale_z is not None:
        z = z * _cast(scale_z, z.dtype) + _cast(bias_z, z.dtype)
    if z is not None:
        y = y + z
    return F.relu(y)


def conv_epilogue_bwd_plain(g: torch.Tensor, y: torch.Tensor,
                            scale: torch.Tensor, form: str,
                            scale_z: torch.Tensor | None = None) -> tuple:
    """(gx, gz) of an epilogue of form `form` from its output `y` and the
    output's gradient `g`, as autograd takes them through the eager ops:
    m = threshold_backward(g, y, 0), gx = m * scale, gz = m (B) or m *
    scale_z (C), None for A."""
    m = torch.ops.aten.threshold_backward(g, y, 0)
    gx = m * _cast(scale, g.dtype)
    if form == "A":
        return gx, None
    return gx, m if form == "B" else m * _cast(scale_z, g.dtype)


def _check_inputs(name: str, x: torch.Tensor,
                  z: torch.Tensor | None = None) -> int:
    """Raise unless x is (N, C, H, W) float32 or bfloat16, channels-last
    and 16-byte aligned, and z (where given) the same but for its data;
    returns x's data pointer."""
    if x.dim() != 4 or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: tensors must be (N, C, H, W) float32 or "
                        f"bfloat16, got {tuple(x.shape)} {x.dtype}")
    _check_layout(name, x)
    if z is not None:
        if z.shape != x.shape or z.dtype != x.dtype or z.device != x.device:
            raise ValueError(f"{name}: every tensor must be "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}, "
                             f"got {tuple(z.shape)} {z.dtype} on {z.device}")
        _check_layout(name, z)
    return x.data_ptr()


def _check_layout(name: str, t: torch.Tensor) -> None:
    if not t.is_contiguous(memory_format=_CL):
        raise ValueError(f"{name}: tensors must be channels-last "
                         f"contiguous, got strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: tensors must be 16-byte aligned")


def _check_buffers(name: str, c: int, device, *params) -> None:
    """Raise unless `params` are (c,) float32 contiguous tensors on
    `device`."""
    for p in params:
        if p.dtype != torch.float32 or p.shape != (c,) or \
                p.device != device or not p.is_contiguous():
            raise ValueError(f"{name}: the buffers must be ({c},) float32 "
                             f"contiguous on {device}, got "
                             f"{tuple(p.shape)} {p.dtype} on {p.device}")


def _device(name: str, x: torch.Tensor) -> int:
    """x's CUDA device, which must be the current one: the kernels launch
    on the current device's current stream."""
    if not x.is_cuda:
        raise ValueError(f"{name}: the tensors must be on a CUDA device, "
                         f"got {x.device}")
    dev, cur = x.get_device(), torch._C._cuda_getDevice()
    if dev != cur:
        raise ValueError(f"{name}: the tensors are on cuda:{dev} but the "
                         f"current device is cuda:{cur}; call under "
                         f"torch.cuda.device({dev})")
    return dev


_ENTRIES = None


def _entries() -> tuple:
    """(``dtt_conv_epilogue``, ``dtt_conv_epilogue_bwd``), built, loaded
    and bound once."""
    global _ENTRIES
    if _ENTRIES is None:
        lib = _build.load("epilogue")
        fwd, bwd = lib.dtt_conv_epilogue, lib.dtt_conv_epilogue_bwd
        fwd.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        bwd.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fwd.restype = bwd.restype = ctypes.c_int
        _ENTRIES = (fwd, bwd)
    return _ENTRIES


def conv_epilogue_cuda(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, z: torch.Tensor | None = None,
                       scale_z: torch.Tensor | None = None,
                       bias_z: torch.Tensor | None = None) -> torch.Tensor:
    """The epilogue by ``dtt_conv_epilogue``: (N, C, H, W) channels-last,
    16-byte aligned x (and z) in float32 or bfloat16 on the current CUDA
    device, (C,) float32 buffers; the output is a new channels-last
    tensor like x.

    Launches on the current stream; counts its launches in
    ``conv_epilogue_cuda.launches``."""
    name = "conv_epilogue_cuda"
    xp = _check_inputs(name, x, z)
    c = x.shape[1]
    _check_buffers(name, c, x.device, scale, bias,
                   *(() if scale_z is None else (scale_z, bias_z)))
    dev = _device(name, x)
    y = torch.empty_like(x)                 # x's channels-last strides
    n = y.numel()
    if n == 0:
        return y
    err = (_ENTRIES or _entries())[0](
        xp, None if z is None else z.data_ptr(), y.data_ptr(),
        scale.data_ptr(), bias.data_ptr(),
        None if scale_z is None else scale_z.data_ptr(),
        None if scale_z is None else bias_z.data_ptr(), n, c,
        _CODES[form_of(z, scale_z), x.dtype],
        torch._C._cuda_getCurrentRawStream(dev))
    if err:
        raise RuntimeError(f"dtt_conv_epilogue: kernel launch failed: "
                           f"cudaError {err}")
    conv_epilogue_cuda.launches += 1
    return y


conv_epilogue_cuda.launches = 0


def conv_epilogue_bwd_cuda(g: torch.Tensor, y: torch.Tensor,
                           scale: torch.Tensor, form: str,
                           scale_z: torch.Tensor | None = None,
                           want_gz: bool = True) -> tuple:
    """``conv_epilogue_bwd_plain``'s (gx, gz) by ``dtt_conv_epilogue_bwd``:
    g and y like ``conv_epilogue_cuda``'s x; gz is None for form A or
    where `want_gz` is false.

    Launches on the current stream; counts its launches in
    ``conv_epilogue_bwd_cuda.launches``."""
    name = "conv_epilogue_bwd_cuda"
    if form not in FORMS:
        raise ValueError(f"{name}: form must be one of {FORMS}, got {form!r}")
    yp = _check_inputs(name, y, g)
    c = y.shape[1]
    _check_buffers(name, c, y.device, scale,
                   *((scale_z,) if form == "C" else ()))
    dev = _device(name, y)
    gx = torch.empty_like(y)
    gz = torch.empty_like(y) if form != "A" and want_gz else None
    n = y.numel()
    if n == 0:
        return gx, gz
    err = (_ENTRIES or _entries())[1](
        g.data_ptr(), yp, gx.data_ptr(), None if gz is None else gz.data_ptr(),
        scale.data_ptr(), scale_z.data_ptr() if form == "C" else None, n, c,
        _CODES[form, y.dtype], torch._C._cuda_getCurrentRawStream(dev))
    if err:
        raise RuntimeError(f"dtt_conv_epilogue_bwd: kernel launch failed: "
                           f"cudaError {err}")
    conv_epilogue_bwd_cuda.launches += 1
    return gx, gz


conv_epilogue_bwd_cuda.launches = 0


class _ConvEpilogue(torch.autograd.Function):
    """The epilogue with its backward, both by the kernels. The gradient
    reaches x and z, never the buffers; a gradient that is not
    channels-last is made so first."""

    @staticmethod
    def forward(ctx, x, scale, bias, z, scale_z, bias_z):
        y = conv_epilogue_cuda(x, scale, bias, z, scale_z, bias_z)
        ctx.form = form_of(z, scale_z)
        ctx.save_for_backward(y, scale, scale_z)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        y, scale, scale_z = ctx.saved_tensors
        gx, gz = conv_epilogue_bwd_cuda(
            g.contiguous(memory_format=torch.channels_last), y, scale,
            ctx.form, scale_z, want_gz=ctx.needs_input_grad[3])
        return gx, None, None, gz, None, None


def conv_epilogue(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  z: torch.Tensor | None = None,
                  scale_z: torch.Tensor | None = None,
                  bias_z: torch.Tensor | None = None) -> torch.Tensor:
    """The epilogue of form A, B or C (module docstring): the plain
    version on CPU tensors, ``dtt_conv_epilogue`` on CUDA tensors (which
    raises where it cannot launch), and, where x or z records a gradient,
    ``dtt_conv_epilogue_bwd`` in the backward."""
    if x.device.type == "cpu":
        return conv_epilogue_plain(x, scale, bias, z, scale_z, bias_z)
    if torch.is_grad_enabled() and (
            x.requires_grad or (z is not None and z.requires_grad)):
        return _ConvEpilogue.apply(x, scale, bias, z, scale_z, bias_z)
    return conv_epilogue_cuda(x, scale, bias, z, scale_z, bias_z)
