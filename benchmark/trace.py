"""What a run records besides its end-to-end metrics: host spans and
counts from the benchmark's side, and with ``--trace 1`` a device trace
of a steady stretch of the window, kept in memory.

Spans time the calls the benchmark makes into the program (a chunk's
call of the video step, a snippet's linking); a span's name is the
layer it enters. The device trace is ``torch.profiler`` over CUDA
activity: every kernel, copy and set with its start, end and correlation
id, and the host's CUDA runtime calls with theirs, so that a kernel that
a CUDA graph's replay ran is tied to its ``cudaGraphLaunch``.
"""

from __future__ import annotations

import time
from collections import defaultdict


class Spans:
    """Host spans by name, in perf_counter seconds."""

    def __init__(self):
        self.spans = defaultdict(list)

    def add(self, name: str, start: float, end: float) -> None:
        self.spans[name].append((start, end))

    def ms(self, name: str) -> list:
        return [(e - s) * 1e3 for s, e in self.spans.get(name, [])]


class DeviceTrace:
    """One stretch under ``torch.profiler``: ``start`` and ``stop`` each
    synchronize the device first, so the stretch holds whole work."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.kernels = []     # (name, start_us, end_us, correlation)
        self.copies = []      # (name, start_us, end_us)
        self.runtime = []     # (name, start_us, end_us, correlation)
        self.annotations = []  # (name, start_us, end_us)

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        for e in self.prof.profiler.kineto_results.events():
            s = e.start_ns() / 1e3
            end = s + e.duration_ns() / 1e3
            name = e.name()
            if name.startswith("bench."):
                if e.device_type() != DeviceType.CUDA:
                    self.annotations.append((name, s, end))
            elif e.device_type() == DeviceType.CUDA:
                low = name.lower()
                if low.startswith(("memcpy", "memset")):
                    self.copies.append((name, s, end))
                else:
                    self.kernels.append((name, s, end, e.correlation_id()))
            elif name.startswith("cuda") and e.correlation_id():
                self.runtime.append((name, s, end, e.correlation_id()))
        self.prof = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def device_intervals(self) -> list:
        return ([(s, e) for _, s, e, _ in self.kernels]
                + [(s, e) for _, s, e in self.copies])

    def graph_kernels(self) -> list:
        """Kernels grouped by the ``cudaGraphLaunch`` that ran them, in
        launch order: [(launch start_us, [(name, start, end), ...])]."""
        launches = sorted((s, c) for n, s, _, c in self.runtime
                          if n.startswith("cudaGraphLaunch"))
        by_corr = defaultdict(list)
        for name, s, e, c in self.kernels:
            by_corr[c].append((name, s, e))
        return [(s, by_corr.get(c, [])) for s, c in launches]
