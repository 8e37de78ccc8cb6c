"""The network's weights, made on the device from the run's seed.

The scheme is the one the D&T model is initialised with before training
(flax's defaults, as the program's ``init_jax_params`` draws them): conv
kernels of the backbone truncated normal in [-2, 2] with variance
1 / fan_in (lecun_normal), the heads normal with a fixed std, the frozen
BatchNorm affines scale 1 and bias 0. The draws are made in two large
calls on the device from one ``torch.Generator``, not leaf by leaf, and
sliced into the leaves: the same seed gives the same weights on the same
kind of device. The values differ from ``init_jax_params``' numpy draws;
only the distribution is the same.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.dnt import param_spec

# the std of a standard normal truncated to [-2, 2] (flax's constant)
TRUNC_STD = .87962566103423978


def truncated_normal(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """`n` standard normals redrawn where outside [-2, 2]."""
    z = torch.randn(n, generator=gen, device=device)
    while True:
        bad = z.abs() > 2
        if not bool(bad.any()):
            return z
        z = torch.where(bad, torch.randn(n, generator=gen, device=device), z)


def make_weights(model: dict, seed: int, device) -> dict:
    """Every weight of `model` (the configuration's ``model`` group) as a
    float32 tensor on `device`, by the names ``param_spec`` gives."""
    spec = param_spec(model)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    numel = lambda shape: math.prod(shape)
    n_lecun = sum(numel(s) for _, s, i in spec if i[0] == "lecun")
    n_normal = sum(numel(s) for _, s, i in spec if i[0] == "normal")
    lecun = truncated_normal(n_lecun, gen, device)
    normal = torch.randn(n_normal, generator=gen, device=device)
    out, at = {}, {"lecun": 0, "normal": 0}
    for name, shape, init in spec:
        kind = init[0]
        if kind in ("ones", "zeros"):
            out[name] = (torch.ones if kind == "ones" else torch.zeros)(
                shape, device=device)
            continue
        src = lecun if kind == "lecun" else normal
        n = numel(shape)
        x = src[at[kind]:at[kind] + n].view(shape)
        at[kind] += n
        scale = (math.sqrt(1.0 / init[1]) / TRUNC_STD if kind == "lecun"
                 else init[1])
        out[name] = x * scale
    return out
