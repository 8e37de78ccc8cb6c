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
  anchor-major;
* either stage layout: ``model.scan_blocks`` trees hold blocks 1..N-1 of a
  stage stacked on a leading axis under ``layerK/blocks/block``, and their
  slice i is ``layerK/block{i+1}``.

The model keeps the values in float32, as the reference keeps its params,
and casts them to the compute dtype at use. ``to_jax_tree`` is the reverse
bridge: the model's values, or their gradients, in the flax layout of the
model's config (stacked stages under ``scan_blocks``).
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


def _to_torch_layout(torch_key: str, value):
    """A view of the flax-layout numpy array or tensor `value` in torch
    layout."""
    if torch_key.endswith(".weight"):            # nn.Conv2d: HWIO -> OIHW
        if isinstance(value, torch.Tensor):
            return value.permute(3, 2, 0, 1)
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


def _scan_path(path: tuple):
    """(path in the scan_blocks layout, index on its scan axis) of the
    leaf `path` of a backbone block other than block0, else None."""
    if (len(path) > 3 and path[0] == "backbone"
            and path[1].startswith("layer") and path[2].startswith("block")
            and path[2] != "block0"):
        return path[:2] + ("blocks", "block") + path[3:], int(path[2][5:]) - 1
    return None


def _get(tree: dict, path: tuple):
    node = tree
    for p in path:
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return node


def _find_leaf(tree: dict, path: tuple) -> tuple[np.ndarray, tuple]:
    """The flax leaf of `path`, in either stage layout, and the path of the
    leaf it was read from."""
    node = _get(tree, path)
    if node is not None:
        return np.asarray(node), path
    scanned = _scan_path(path)
    if scanned is not None:
        node = _get(tree, scanned[0])
        if node is not None:
            return np.asarray(node)[scanned[1]], scanned[0]
    raise KeyError("flax params have no leaf " + "/".join(path))


def _leaf(tree: dict, path: tuple) -> np.ndarray:
    """The flax leaf of `path`, in either stage layout."""
    return _find_leaf(tree, path)[0]


def _leaf_paths(tree, prefix=()) -> set:
    if isinstance(tree, dict):
        return set().union(*(_leaf_paths(v, prefix + (k,))
                             for k, v in tree.items()))
    return {prefix}


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _stack_scanned(params: dict) -> dict:
    """Move blocks 1..N-1 of every backbone stage of more than one block
    into the scan_blocks layout: ``layerK/blocks/block``, each leaf stacked
    on a leading axis in block order."""
    for name, layer in params.get("backbone", {}).items():
        rest = sorted((k for k in layer if k.startswith("block")
                       and k != "block0"), key=lambda k: int(k[5:]))
        if not rest:
            continue
        blocks = [layer.pop(k) for k in rest]
        stacked: dict = {}
        for path in sorted(_leaf_paths(blocks[0])):
            _put(stacked, path, np.stack([_get(b, path) for b in blocks]))
        layer["blocks"] = {"block": stacked}
    return params


def torch_values(model: DnT, params: dict) -> dict:
    """The flax params tree `params` (either stage layout) as float32
    tensors by the model's state-dict keys, on the model's devices, in
    torch layout (views: each leaf goes to the device in its flax layout
    and is transposed there, not on the host); raises on a missing, extra
    or misshapen leaf."""
    values, used = {}, {}
    for key, ref in model.state_dict().items():
        leaf, source = _find_leaf(params, _flax_path(key))
        used[source] = used.get(source, 0) + 1
        shape = _to_torch_layout(key, leaf).shape
        if tuple(shape) != tuple(ref.shape):
            raise ValueError(f"{key}: flax leaf has shape {shape} "
                             f"(torch layout), model has {tuple(ref.shape)}")
        values[key] = _to_torch_layout(key, torch.from_numpy(
            np.array(leaf, np.float32)).to(ref.device))
    for source, n in used.items():
        rows = len(_get(params, source)) if "blocks" in source else 1
        if n != rows:
            raise ValueError(f"{'/'.join(source)}: {rows} stacked blocks, "
                             f"the model's stage has {n}")
    extra = _leaf_paths(params) - set(used)
    if extra:
        raise KeyError(f"flax params have {len(extra)} leaves the model "
                       f"lacks, e.g. {'/'.join(sorted(extra)[0])}")
    return values


def load_jax_params(model: DnT, tree: dict) -> DnT:
    """Fill `model` in place from the flax variables `tree` (either stage
    layout); raises on a missing, extra or misshapen leaf."""
    model.load_state_dict(torch_values(model, tree["params"]))
    return model


def flax_tree(model: DnT, values: dict) -> dict:
    """`values` (torch tensors by the model's state-dict keys) as a flax
    params tree of float32 numpy arrays in the layout of the model's config
    (OIHW -> HWIO, (I, O) -> (1, 1, I, O), stages stacked under
    ``scan_blocks``)."""
    params: dict = {}
    for key, value in values.items():
        v = value.detach().float().cpu().contiguous().numpy()
        _put(params, _flax_path(key),
             np.ascontiguousarray(_to_flax_layout(key, v)))
    return _stack_scanned(params) if model.cfg.scan_blocks else params


def to_jax_tree(model: DnT, grads: bool = False) -> dict:
    """The model's parameters and buffers as a flax variables tree
    (``{"params": {...}}``, see `flax_tree`), the inverse of
    `load_jax_params`. With `grads`, each leaf is the parameter's ``.grad``
    instead, and zeros where there is none (buffers, frozen parameters)."""
    values = model.state_dict()
    if grads:
        named = dict(model.named_parameters())
        values = {k: (named[k].grad if k in named
                      and named[k].grad is not None else torch.zeros_like(v))
                  for k, v in values.items()}
    return {"params": flax_tree(model, values)}


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
        _put(params, path, value)
    return {"params": params}
