"""Device timing by chained iterations (counterpart of
``dtt.utils.timing``).

CUDA work is queued asynchronously, so a loop that reads the clock without
waiting for the device times the launches, not the work. `chained_time`
feeds each iteration's scalar into the next and reads only the last one,
so every iteration lies on the path of the value the host waits for; the
cost of one host round trip (`sync_latency`) is subtracted.
"""

from __future__ import annotations

import time

import torch

from dtt_torch.core.device import resolve_device


def sync_latency(samples: int = 5, device=None) -> float:
    """Seconds of a trivial scalar round trip to `device` (CUDA unless the
    caller passes "cpu"): the least of `samples`, since the noise only
    adds."""
    device = resolve_device(device)
    x = torch.zeros((), device=device)
    float(x + 1.0)
    ts = []
    for i in range(samples):
        t0 = time.perf_counter()
        float(x + i)
        ts.append(time.perf_counter() - t0)
    return min(ts)


def chained_time(make_scalar_step, iters: int = 10, repeats: int = 3,
                 args: tuple = (), device=None) -> float:
    """Mean seconds per iteration of `make_scalar_step`.

    make_scalar_step: fn(carry_scalar, *args) -> new_scalar, a 0-d tensor
    on `device` (CUDA unless the caller passes "cpu") to which the
    computation of interest contributes. The best of `repeats` runs of
    `iters` chained calls, less one round trip."""
    device = resolve_device(device)

    def run(c0):
        c = c0
        for _ in range(iters):
            c = make_scalar_step(c, *args)
        return float(c)

    run(torch.zeros((), device=device))          # warm-up
    lat = sync_latency(device=device)
    best = float("inf")
    for r in range(repeats):
        c0 = torch.full((), r * 1e-6, device=device)
        t0 = time.perf_counter()
        run(c0)
        best = min(best, time.perf_counter() - t0 - lat)
    return max(best, 0.0) / iters
