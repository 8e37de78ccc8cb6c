"""Step programs: a serial step captured once as a CUDA graph and replayed,
the port's counterpart of ``dtt``'s ``jax.jit``'d steps.

A ``StepProgram`` wraps a step function ``fn(*args)`` whose arguments are
tensors, Python numbers and other objects, nested in tuples, lists,
NamedTuples and dicts. Their signature is the nesting, each tensor's shape
and dtype, each number's kind and every other object itself (a generator,
an optimizer, a module, None), compared by identity. On its first CUDA call
for a signature the program

1. allocates a fixed device buffer for every tensor and number (a number is
   an input like a tensor, in a 0-d float32 or int64 buffer, as ``jax.jit``
   traces a Python scalar), and copies the arguments in;
2. runs `fn` once on a side stream of its own, the warm-up that PyTorch's
   CUDA graph notes ask for: cuDNN and cuBLAS pick their algorithms and
   workspaces there and each kernel takes its one-time set-up (binding,
   ``cudaFuncSetAttribute``); with ``eager_calls=n`` the first n calls are
   instead real calls, run eagerly on that stream (a train step's first
   update makes the momentum buffers the graph then reads), and the capture
   comes at call n + 1;
3. captures `fn` into a ``torch.cuda.CUDAGraph`` on that stream, with every
   CUDA generator among the arguments registered, so that a replay draws
   and advances it as an eager call does.

Every call copies its arguments into the buffers (host tensors through
pinned memory, without waiting), replays the graph on the current stream
and returns copies of the outputs made on the card, so that the next
replay cannot overwrite what an earlier call returned (a driver keeps two
calls in flight). ``copy_out=False`` returns the graph's own outputs, for a
stage whose outputs only the next program reads; that program names the
arguments it reads in place with `borrow`, and never copies them.

A capture that fails raises a RuntimeError naming the step and the line of
the step that failed, and so does every later call of that signature: the
program never carries on eagerly. The CUDA generators the failed capture
registered are taken out of capture mode first, so the process's later
draws work. Every kernel wrapper counts its launches
(``launches``); a capture launches nothing, so its counts are taken back
and each replay adds them again. On the CPU, which a caller must ask for,
a call copies the arguments into fixed buffers, calls `fn` and copies the
outputs out, with no graph. ``program.eager(*args)`` calls `fn` uncaptured
on the arguments moved to the device (numbers as 0-d tensors, as the
program holds them), so the card can hold the two forms against each
other.

While a recording of ``dtt_torch.utils.profiling`` is on, every call is a
span ``program.call`` labelled with the program's name, whose children
are ``program.copy_in`` (the arguments into the buffers: pinning and the
uploads' enqueue), ``program.replay`` (``program.run`` where `fn` is
called directly, on the CPU) and ``program.copy_out`` (the outputs'
copies); a first call's warm-up and capture, and an eager call, are the
call's own time. The counter ``program.pinned_bytes`` adds the bytes of
every host tensor that had to be pinned afresh to be uploaded. The spans'
clock is the recorder's (see there).

Nothing inside `fn` may read a CUDA value back to the host, change a
tensor's shape from its values or replace a tensor the graph reads (a
parameter, a momentum buffer) by another: weights are loaded and state is
restored in place. Kernel 1 encodes its TMA descriptors from tensor
addresses on the host, so they too are frozen at capture, which holds
while the buffers and the graph's memory keep their addresses.
"""

from __future__ import annotations

import os
import traceback

import numpy as np
import torch

from dtt_torch.utils.profiling import count, span

_TORCH_DIR = os.path.dirname(torch.__file__) + os.sep


def kernel_wrappers() -> list:
    """Every kernel wrapper of the port that counts its launches."""
    from dtt_torch.eval import linking
    from dtt_torch.ops import correlation, epilogue, nms, psroi
    return [correlation.correlation_cuda, correlation.correlation_split_cuda,
            correlation.correlation_bwd_cuda, psroi.psroi_sums_cuda,
            psroi.psroi_bwd_cuda, psroi.psroi_mm_sums_cuda,
            psroi.psroi_sat_means_cuda, nms.nms_cuda, linking.link_cuda,
            epilogue.conv_epilogue_cuda, epilogue.conv_epilogue_bwd_cuda]


def _flatten(x, leaves: list):
    """The signature of `x`; its tensors and numbers appended to
    `leaves` in order."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return ("tensor", tuple(x.shape), x.dtype)
    if isinstance(x, (bool, np.bool_)) or x is None:
        return ("const", x)
    if isinstance(x, (int, np.integer)):
        leaves.append(int(x))
        return ("number", torch.int64)
    if isinstance(x, (float, np.floating)):
        leaves.append(float(x))
        return ("number", torch.float32)
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in x.items()))
    return ("const", x)


def _leaves(x) -> list:
    leaves: list = []
    _flatten(x, leaves)
    return leaves


def _unflatten(sig, leaves):
    """The nest of signature `sig` with its tensors and numbers taken in
    order from the iterator `leaves`."""
    kind = sig[0]
    if kind in ("tensor", "number"):
        return next(leaves)
    if kind == "const":
        return sig[1]
    if kind is dict:
        return {k: _unflatten(s, leaves) for k, s in sig[1]}
    items = [_unflatten(s, leaves) for s in sig[1]]
    return kind(*items) if hasattr(kind, "_fields") else kind(items)


def _consts(sig):
    """The objects of a signature, in order."""
    if sig[0] == "const":
        yield sig[1]
    elif sig[0] is dict:
        for _, s in sig[1]:
            yield from _consts(s)
    elif sig[0] not in ("tensor", "number"):
        for s in sig[1]:
            yield from _consts(s)


def _map_tensors(fn, x):
    """`x` with `fn` applied to each tensor of its nest."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map_tensors(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_map_tensors(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: _map_tensors(fn, v) for k, v in x.items()}
    return x


def upload(x, device: torch.device):
    """A leaf on `device`: a host tensor through pinned memory without
    waiting, a number as a 0-d float32 or int64 tensor."""
    if not isinstance(x, torch.Tensor):
        return torch.full((), x, device=device, dtype=torch.int64
                          if isinstance(x, int) else torch.float32)
    if device.type == "cuda" and x.device.type == "cpu" and not x.is_pinned():
        x = _pinned(x)
    return x.to(device, non_blocking=True)


def _pinned(x: torch.Tensor) -> torch.Tensor:
    """A pinned copy of the host tensor `x`, its bytes counted as
    ``program.pinned_bytes``."""
    count("program.pinned_bytes", x.numel() * x.element_size())
    return x.pin_memory()


def _failed_line(err: BaseException) -> str:
    """file:line and source of the deepest frame outside torch in the
    traceback of the first exception behind `err`."""
    while err.__context__ is not None:
        err = err.__context__
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if not f.filename.startswith(_TORCH_DIR)]
    if not frames:
        return "an unknown line"
    f = frames[-1]
    return f"{os.path.relpath(f.filename)}:{f.lineno} ({f.line})"


class _Entry:
    """The buffers, graph and outputs of one signature."""

    def __init__(self, sig, leaves: list, device: torch.device,
                 borrowed: set):
        self.sig = sig
        self.buffers = []
        for i, x in enumerate(leaves):
            if i in borrowed:
                self.buffers.append(x)
            elif isinstance(x, torch.Tensor):
                self.buffers.append(torch.empty(x.shape, dtype=x.dtype,
                                                device=device))
            else:
                self.buffers.append(upload(x, device))
        self.args = _unflatten(sig, iter(self.buffers))
        self.generators = [g for g in _consts(sig)
                           if isinstance(g, torch.Generator)
                           and g.device.type == "cuda"]
        self.calls = 0
        self.graph = None
        self.out = None
        self.launched = None
        self.error = None

    def copy_in(self, leaves: list) -> None:
        for buf, x in zip(self.buffers, leaves):
            if x is buf:
                continue
            if not isinstance(x, torch.Tensor):
                buf.fill_(x)
                continue
            if (buf.device.type == "cuda" and x.device.type == "cpu"
                    and not x.is_pinned()):
                x = _pinned(x)
            # a borrowed buffer may be an inference tensor
            with torch.inference_mode(buf.is_inference()):
                buf.copy_(x, non_blocking=True)


class StepProgram:
    """`fn` as a program captured once per signature and replayed (see the
    module docstring). `name` names the step in errors; `borrow` holds the
    indices of the arguments that are another program's fixed outputs,
    read in place."""

    def __init__(self, fn, name: str, device, *, eager_calls: int = 0,
                 copy_out: bool = True, borrow: tuple = ()):
        self.fn = fn
        self.name = name
        self.device = torch.device(device)
        self.eager_calls = eager_calls
        self.copy_out = copy_out
        self.borrow = tuple(borrow)
        self.captures = 0
        self.replays = 0
        self._entries: dict = {}
        self._stream = None

    def eager(self, *args):
        """`fn` uncaptured, on the arguments moved to the device."""
        leaves: list = []
        sig = _flatten(args, leaves)
        return self.fn(*_unflatten(sig, iter(
            [upload(x, self.device) for x in leaves])))

    def __call__(self, *args):
        with span("program.call", self.name):
            return self._call(args)

    def _call(self, args):
        leaves: list = []
        sig = _flatten(args, leaves)
        entry = self._entries.get(sig)
        if entry is None:
            borrowed, start = set(), 0
            for i, a in enumerate(args):
                n = len(_leaves(a))
                if i in self.borrow:
                    borrowed.update(range(start, start + n))
                start += n
            entry = self._entries[sig] = _Entry(sig, leaves, self.device,
                                                borrowed)
        if entry.error is not None:
            raise entry.error
        with span("program.copy_in"):
            entry.copy_in(leaves)
        if self.device.type != "cuda":
            with span("program.run"):
                out = self.fn(*entry.args)
            return self._out(out)
        if entry.graph is None:
            if entry.calls < self.eager_calls:
                entry.calls += 1
                return self._out(self._on_side(entry.args))
            if self.eager_calls == 0:
                self._on_side(entry.args)     # the warm-up
            self._capture(entry)
        with span("program.replay"):
            entry.graph.replay()
        self.replays += 1
        for wrapper, n in entry.launched:
            wrapper.launches += n
        return self._out(entry.out)

    def _out(self, out):
        if not self.copy_out:
            return out
        with span("program.copy_out"):
            return _map_tensors(torch.clone, out)

    def _side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _on_side(self, args):
        """`fn(*args)` run eagerly on the side stream, ordered after the
        current stream's work and before its next."""
        current = torch.cuda.current_stream(self.device)
        side = self._side_stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.fn(*args)
        current.wait_stream(side)
        return out

    def _capture(self, entry: _Entry) -> None:
        graph = torch.cuda.CUDAGraph()
        for g in entry.generators:
            graph.register_generator_state(g)
        current = torch.cuda.current_stream(self.device)
        wrappers = kernel_wrappers()
        before = [w.launches for w in wrappers]
        try:
            # thread_local: the loader's threads keep uploading on their own
            # streams while this thread captures
            with torch.cuda.graph(graph, stream=self._side_stream(),
                                  capture_error_mode="thread_local"):
                out = self.fn(*entry.args)
        except RuntimeError as e:
            torch.cuda.set_stream(current)
            self._end_generator_capture(entry.generators)
            entry.error = RuntimeError(
                f"{self.name}: capturing the step as a CUDA graph failed at "
                f"{_failed_line(e)}: {e}")
            raise entry.error from e
        finally:       # the capture launched nothing
            after = [w.launches for w in wrappers]
            for w, n in zip(wrappers, before):
                w.launches = n
        entry.launched = [(w, a - b) for w, a, b in
                          zip(wrappers, after, before) if a != b]
        entry.graph, entry.out = graph, out
        self.captures += 1

    def _end_generator_capture(self, generators: list) -> None:
        """A failed capture never ran its end, which takes the CUDA
        generators it registered (the device's default one and
        `generators`) out of capture mode, so every later draw from them
        would raise; an empty capture that registers them ends it."""
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        with torch.cuda.graph(graph, stream=self._side_stream()):
            pass
