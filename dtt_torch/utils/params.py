"""The weight bridge: ``dtt``'s flax parameter tree into the port's modules.

The tree is the one ``DnT.init`` makes (``{"params": {...}}``), as nested
dicts of numpy arrays (``jax.tree.map(np.asarray, params)``). Every torch
parameter or buffer ``a.b.c.weight|kernel|bias|scale`` reads the flax leaf
``a/b/c/kernel|bias|scale``:

* conv kernels HWIO -> OIHW;
* FrozenAffine ``scale``/``bias`` -> buffers;
* the ``cls_maps``/``bbox_maps``/``track_maps`` kernels (1, 1, I, O) ->
  (I, O) float32 matrices, with their biases, in the form ``fused_psmaps``
  slices them;
* channel orders unchanged: ps channels stay bin-major, RPN cls logits stay
  anchor-major.

The model keeps the values in float32, as the reference keeps its params,
and casts them to the compute dtype at use. ``to_jax_tree`` is the reverse
bridge: the model's values, or their gradients, in the flax layout.
"""

from __future__ import annotations

import numpy as np
import torch

from dtt_torch.core.config import ModelConfig
from dtt_torch.models.dnt import DnT, make_model

_PS_HEADS = ("cls_maps", "bbox_maps", "track_maps")


def _flax_path(torch_key: str) -> tuple:
    parts = torch_key.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return tuple(parts)


def _to_torch_layout(torch_key: str, value: np.ndarray) -> np.ndarray:
    if torch_key.endswith(".weight"):            # nn.Conv2d: HWIO -> OIHW
        return value.transpose(3, 2, 0, 1)
    if torch_key.split(".")[0] in _PS_HEADS and torch_key.endswith(".kernel"):
        return value[0, 0]                       # (1, 1, I, O) -> (I, O)
    return value


def _to_flax_layout(torch_key: str, value: np.ndarray) -> np.ndarray:
    if torch_key.endswith(".weight"):            # nn.Conv2d: OIHW -> HWIO
        return value.transpose(2, 3, 1, 0)
    if torch_key.split(".")[0] in _PS_HEADS and torch_key.endswith(".kernel"):
        return value[None, None]                 # (I, O) -> (1, 1, I, O)
    return value


def _from_torch_shape(torch_key: str, shape: tuple) -> tuple:
    if torch_key.endswith(".weight"):
        o, i, kh, kw = shape
        return (kh, kw, i, o)
    if torch_key.split(".")[0] in _PS_HEADS and torch_key.endswith(".kernel"):
        return (1, 1, *shape)
    return tuple(shape)


def _leaf(tree: dict, path: tuple):
    node = tree
    for p in path:
        if not isinstance(node, dict) or p not in node:
            raise KeyError("flax params have no leaf " + "/".join(path))
        node = node[p]
    return np.asarray(node)


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def load_jax_params(model: DnT, tree: dict) -> DnT:
    """Fill `model` in place from the flax variables `tree`; raises on a
    missing, extra or misshapen leaf."""
    params = tree["params"]
    state = model.state_dict()
    loaded = {}
    for key, ref in state.items():
        value = _to_torch_layout(key, _leaf(params, _flax_path(key)))
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: flax leaf has shape {value.shape} "
                             f"(torch layout), model has {tuple(ref.shape)}")
        loaded[key] = torch.from_numpy(np.array(value, np.float32))
    extra = _count_leaves(params) - len(loaded)
    if extra:
        raise KeyError(f"flax params have {extra} leaves the model lacks")
    model.load_state_dict(loaded)
    return model


def to_jax_tree(model: DnT, grads: bool = False) -> dict:
    """The model's parameters and buffers as a flax variables tree
    (``{"params": {...}}`` of float32 numpy arrays, OIHW -> HWIO and
    (I, O) -> (1, 1, I, O)), the inverse of `load_jax_params`. With
    `grads`, each leaf is the parameter's ``.grad`` instead, and zeros
    where there is none (buffers, frozen parameters)."""
    named = dict(model.named_parameters())
    params: dict = {}
    for key, value in model.state_dict().items():
        if grads:
            g = named[key].grad if key in named else None
            value = torch.zeros_like(value) if g is None else g
        v = value.detach().float().cpu().contiguous().numpy()
        path = _flax_path(key)
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(_to_flax_layout(key, v))
    return {"params": params}


def from_jax_params(tree: dict, cfg: ModelConfig, device=None) -> DnT:
    """A model on `device` (CUDA unless the caller passes "cpu") holding
    the flax variables `tree`."""
    return load_jax_params(make_model(cfg, device), tree)


# flax initialisers of each layer (dtt.models: nn.Conv's default
# lecun_normal for the backbone; normal(std) for the heads)
_INIT_STD = {"rpn": 0.01, "reduce": 0.01, "cls_maps": 0.01,
             "bbox_maps": 0.001, "track_maps": 0.001}


def _lecun_normal(rng: np.random.Generator, shape: tuple) -> np.ndarray:
    """flax's lecun_normal: truncated normal in [-2, 2] std, variance
    1/fan_in for an HWIO kernel."""
    fan_in = int(np.prod(shape[:-1]))
    z = rng.standard_normal(shape, dtype=np.float32)
    bad = np.abs(z) > 2
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
        bad = np.abs(z) > 2
    return z * np.float32(np.sqrt(1.0 / fan_in) / .87962566103423978)


def init_jax_params(cfg: ModelConfig, seed: int = 0) -> dict:
    """Random flax-layout variables for `cfg` from a numpy seed, drawn with
    the initialisers ``DnT.init`` uses (frozen-BN scales 1, biases 0)."""
    rng = np.random.default_rng(seed)
    params: dict = {}
    for key, ref in DnT(cfg, device="meta").state_dict().items():
        path = _flax_path(key)
        shape = _from_torch_shape(key, tuple(ref.shape))
        if path[-1] == "scale":
            value = np.ones(shape, np.float32)
        elif path[-1] == "bias":
            value = np.zeros(shape, np.float32)
        elif path[0] == "backbone":
            value = _lecun_normal(rng, shape)
        else:
            value = (rng.standard_normal(shape, dtype=np.float32)
                     * np.float32(_INIT_STD[path[0]]))
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    return {"params": params}
