"""Checkpoint / resume in ``dtt``'s run-dir format, so one run dir serves
both packages (counterpart of ``dtt.train.checkpoint``).

One directory per step, ``<ckpt_dir>/step_XXXXXXXX``, holding
  state.msgpack — flax ``to_bytes`` of {params, opt_state, step}, written
                  and read by the port's own codec (``dtt_torch.utils.msgpack``)
  config.yml    — the full config
  meta.json     — step, version and wall time
and ``<ckpt_dir>/LATEST`` naming the newest.

``params`` is the flax variables tree (``to_jax_tree``: HWIO kernels,
stacked stages under ``model.scan_blocks``). ``opt_state`` is the state
of ``dtt``'s optax chain for the config, as flax lays it out: a dict per
chain element keyed "0", "1", ...; {} for the clip and the final
set-to-zero, {"inner_state": {}} for each masked transform, and for the
SGD element {"0": {"trace": <params-shaped momentum>}, "1": {"count":
int32}}. The trace is the port's momentum buffer times its group's
``lr_mult``: optax doubles a bias update before the momentum, the port
doubles the bias group's rate after it. Frozen leaves and parameters
without a buffer hold a zero trace, which equals no buffer (the first
step sets ``buf = u``). ``count`` is the step.
"""

from __future__ import annotations

import json
import mmap
import os
import time

import numpy as np
import torch

from dtt_torch import __version__
from dtt_torch.core.config import Config, save_config
from dtt_torch.models.dnt import DnT
from dtt_torch.train.trainer import TrainState
from dtt_torch.utils import msgpack
from dtt_torch.utils.params import (flax_tree, load_jax_params, to_jax_tree,
                                    torch_values)


def _sorted(tree):
    """`tree` with every dict's keys in sorted order, as flax serializes
    (its ``msgpack_serialize`` rebuilds dicts through ``jax.tree_util``)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def _chain(cfg: Config, trace, count) -> dict:
    """The optax chain state of ``dtt``'s ``make_optimizer`` for `cfg`
    with the SGD trace `trace` and schedule count `count`, as flax's state
    dict."""
    t = cfg.train
    chain = [{}]                                   # clip_by_global_norm
    if t.weight_decay:
        chain.append({"inner_state": {}})          # masked decay
    if t.double_bias_lr:
        chain.append({"inner_state": {}})          # masked scale(2)
    chain.append({"0": {"trace": trace}, "1": {"count": count}})
    chain.append({"inner_state": {}})              # masked set_to_zero
    return {str(i): s for i, s in enumerate(chain)}


def _lr_mults(state: TrainState) -> dict:
    """Each optimized parameter's group ``lr_mult``, by parameter."""
    return {p: g["lr_mult"] for g in state.optimizer.param_groups
            for p in g["params"]}


def _state_dict(state: TrainState, cfg: Config) -> dict:
    model, opt = state.model, state.optimizer
    mults = _lr_mults(state)
    named = dict(model.named_parameters())
    trace = {}
    for key, value in model.state_dict().items():
        p = named.get(key)
        buf = opt.state.get(p, {}).get("momentum_buffer") if p in mults \
            else None
        trace[key] = (torch.zeros_like(value) if buf is None
                      else buf * mults[p])
    return _sorted({
        "params": to_jax_tree(model),
        "opt_state": _chain(cfg, flax_tree(model, trace),
                            np.asarray(state.step, np.int32)),
        "step": np.asarray(state.step, np.int32)})


def save_checkpoint(ckpt_dir: str, state: TrainState, cfg: Config) -> str:
    """Write a checkpoint for the current step; returns its path."""
    path = os.path.join(ckpt_dir, f"step_{state.step:08d}")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "state.msgpack"), "wb") as f:
        msgpack.dump(_state_dict(state, cfg), f)
    save_config(cfg, os.path.join(path, "config.yml"))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": state.step, "version": __version__,
                   "time": time.time()}, f)
    with open(os.path.join(ckpt_dir, "LATEST"), "w") as f:
        f.write(os.path.basename(path))
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    marker = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        name = f.read().strip()
    path = os.path.join(ckpt_dir, name)
    return path if os.path.exists(path) else None


def _unpack_file(path: str):
    """The msgpack value in the file `path`, its arrays viewing a read-only
    map of the file: only the pages of the arrays a caller copies are
    read (evaluation leaves the momentum, half the file, on the disk)."""
    with open(path, "rb") as f:
        return msgpack.unpackb(mmap.mmap(f.fileno(), 0,
                                         access=mmap.ACCESS_READ))


def _read(path: str) -> dict:
    return _unpack_file(os.path.join(path, "state.msgpack"))


def _sgd_state(opt_state: dict, path: str) -> dict:
    """The SGD element of a flax-serialized optax chain state."""
    found = [v for v in opt_state.values()
             if isinstance(v, dict) and set(v) == {"0", "1"}
             and "trace" in v["0"] and "count" in v["1"]]
    if len(found) != 1:
        raise ValueError(f"{path}: opt_state holds {len(found)} SGD "
                         "momentum states, not one")
    return found[0]


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load the checkpoint at `path` (written by either package) into
    `state`'s model and optimizer, in place on their device (parameters
    and existing momentum buffers keep their memory); returns the state
    at the saved step."""
    raw = _read(path)
    model, opt = state.model, state.optimizer
    sgd = _sgd_state(raw["opt_state"], path)
    step = int(raw["step"])
    if int(sgd["1"]["count"]) != step:
        raise ValueError(f"{path}: schedule count {int(sgd['1']['count'])} "
                         f"!= step {step}")
    load_jax_params(model, raw["params"])
    trace = torch_values(model, sgd["0"]["trace"])
    key_of = {p: k for k, p in model.named_parameters()}
    for group in opt.param_groups:       # the order SGD keeps its state in
        for p in group["params"]:
            # in the parameter's memory format, as SGD makes its buffers;
            # an existing buffer is filled in place, where a captured train
            # step reads it
            buf = opt.state[p].get("momentum_buffer")
            if buf is None:
                buf = torch.empty_like(p)
            opt.state[p]["momentum_buffer"] = buf.copy_(
                trace[key_of[p]] / group["lr_mult"])
    return state._replace(step=step)


def checkpoint_config(path: str) -> dict:
    """The config saved in the checkpoint at `path` (``config.yml``) as a
    plain dict; ``dtt_torch.core.config.config_from_dict`` rebuilds it."""
    import yaml
    with open(os.path.join(path, "config.yml")) as f:
        return yaml.safe_load(f)


def restore_params_only(path: str, model: DnT) -> int:
    """Load only the parameters of the checkpoint at `path` into `model`
    (in place, on its device), as evaluation needs; returns the saved
    step. The optimizer state's pages are not read."""
    raw = _read(path)
    load_jax_params(model, raw["params"])
    return int(raw["step"])


def save_params(path: str, model: DnT) -> None:
    """Params-only export: the flax variables tree, as flax ``to_bytes``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        msgpack.dump(_sorted(to_jax_tree(model)), f)


def load_params(path: str, model: DnT) -> DnT:
    """Fill `model` from a params-only export (`save_params`, or ``dtt``'s
    ``save_params`` of its variables tree)."""
    return load_jax_params(model, _unpack_file(path))
