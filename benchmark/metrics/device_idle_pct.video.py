"""The share of the traced stretch in which no kernel, copy or set ran on
the device."""

from benchmark.roofline import busy_ms


def read(r):
    tr = r.trace
    if tr is None or not tr.kernels:
        return None
    return 100 * (1 - busy_ms(tr.device_intervals()) / 1e3 / tr.window_s)
