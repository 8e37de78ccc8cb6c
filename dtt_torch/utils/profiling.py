"""Profiling helpers (counterpart of ``dtt.utils.profiling``): a device
trace by ``torch.profiler``, trace annotations and a step timer that waits
for the device before it reads the clock."""

from __future__ import annotations

import contextlib
import time

import torch


def _synchronize(result) -> None:
    """Wait for the device work behind `result` (a tensor or a nest of
    them): every CUDA device a tensor of it lies on."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(result)
    for d in devices:
        torch.cuda.synchronize(d)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Record everything inside the block with ``torch.profiler`` (the
    CUDA activity too where a card is present) and write a trace that
    TensorBoard's profile plugin reads under `log_dir`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    with prof:
        yield prof


annotate = torch.profiler.record_function  # with annotate("step"): ...


class StepTimer:
    """Wall-clock timer that waits for the device's results (honest step
    times); the first `warmup` steps are not kept."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._times: list[float] = []
        self._seen = 0

    @contextlib.contextmanager
    def step(self, result_to_block=None):
        t0 = time.perf_counter()
        yield
        if result_to_block is not None:
            _synchronize(result_to_block)
        self._seen += 1
        if self._seen > self.warmup:
            self._times.append(time.perf_counter() - t0)

    def time_fn(self, fn, *args, iters: int = 10):
        """Mean seconds of `fn(*args)` over `iters` calls after one."""
        _synchronize(fn(*args))
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        _synchronize(out)
        return (time.perf_counter() - t0) / iters

    @property
    def mean(self) -> float:
        return sum(self._times) / max(len(self._times), 1)

    def summary(self) -> dict:
        if not self._times:
            return {"steps": 0}
        ts = sorted(self._times)
        return {
            "steps": len(ts),
            "mean_s": self.mean,
            "p50_s": ts[len(ts) // 2],
            "p95_s": ts[int(len(ts) * 0.95)],
        }
