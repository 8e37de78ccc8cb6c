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
buffers take no gradient.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from dtt_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
FORMS = ("A", "B", "C")


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


def _check(name: str, t: torch.Tensor, like: torch.Tensor | None = None):
    """`t` channels-last and 16-byte aligned, of `like`'s shape, dtype and
    device where `like` is given."""
    if like is not None and (t.shape != like.shape or t.dtype != like.dtype
                             or t.device != like.device):
        raise ValueError(f"{name}: every tensor must be {tuple(like.shape)} "
                         f"{like.dtype} on {like.device}, got "
                         f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name}: tensors must be channels-last contiguous, "
                         f"got strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: tensors must be 16-byte aligned")


def _check_params(name: str, c: int, device, *params) -> None:
    """The (C,) float32 buffers on `device`, which must be a CUDA one."""
    for p in params:
        if p.dtype != torch.float32 or p.shape != (c,) or \
                p.device != device or not p.is_contiguous():
            raise ValueError(f"{name}: the buffers must be ({c},) float32 "
                             f"contiguous on {device}, got "
                             f"{tuple(p.shape)} {p.dtype} on {p.device}")
    if device.type != "cuda":
        raise ValueError(f"{name}: the tensors must be on a CUDA device, "
                         f"got {device}")


def _check_input(name: str, x: torch.Tensor) -> None:
    if x.dim() != 4 or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: tensors must be (N, C, H, W) float32 or "
                        f"bfloat16, got {tuple(x.shape)} {x.dtype}")


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    fn = getattr(_build.load("epilogue"), name)
    if name == "dtt_conv_epilogue":
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64] + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def conv_epilogue_cuda(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, z: torch.Tensor | None = None,
                       scale_z: torch.Tensor | None = None,
                       bias_z: torch.Tensor | None = None) -> torch.Tensor:
    """The epilogue by ``dtt_conv_epilogue``: (N, C, H, W) channels-last,
    16-byte aligned x (and z) in float32 or bfloat16, (C,) float32
    buffers; the output is a new channels-last tensor like x.

    Launches on the current stream; counts its launches in
    ``conv_epilogue_cuda.launches``."""
    name = "conv_epilogue_cuda"
    _check_input(name, x)
    form = form_of(z, scale_z)
    _check(name, x)
    if z is not None:
        _check(name, z, x)
    c = x.shape[1]
    _check_params(name, c, x.device, scale, bias,
                  *((scale_z, bias_z) if form == "C" else ()))
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    device = x.get_device()
    err = _entry("dtt_conv_epilogue")(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), _ptr(z),
        _ptr(scale_z), _ptr(bias_z), y.data_ptr(), y.numel(), c,
        FORMS.index(form), _DTYPE_CODES[x.dtype], device,
        torch._C._cuda_getCurrentRawStream(device))
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
    _check_input(name, y)
    _check(name, y)
    _check(name, g, y)
    c = y.shape[1]
    _check_params(name, c, y.device, scale,
                  *((scale_z,) if form == "C" else ()))
    gx = torch.empty_like(y, memory_format=torch.channels_last)
    gz = (torch.empty_like(y, memory_format=torch.channels_last)
          if form != "A" and want_gz else None)
    if y.numel() == 0:
        return gx, gz
    device = y.get_device()
    err = _entry("dtt_conv_epilogue_bwd")(
        g.data_ptr(), y.data_ptr(), scale.data_ptr(),
        _ptr(scale_z) if form == "C" else None, gx.data_ptr(), _ptr(gz),
        y.numel(), c, FORMS.index(form), _DTYPE_CODES[y.dtype], device,
        torch._C._cuda_getCurrentRawStream(device))
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
