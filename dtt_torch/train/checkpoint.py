"""Checkpoint / resume in a format native to the port (counterpart of
``dtt.train.checkpoint``; reading ``dtt``'s ``state.msgpack`` is not
supported).

One directory per step, ``<ckpt_dir>/step_XXXXXXXX``, holding
  state.pt  — ``torch.save`` of {params (the model's state dict),
              optimizer (its state dict), step, config (a plain dict)}
  meta.json — step and wall time
and ``<ckpt_dir>/LATEST`` naming the newest. Restore pours the saved
tensors into a train state built from the same config; evaluation reads
the saved config first (``checkpoint_config``) and restores only the
parameters (``restore_params_only``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import torch

from dtt_torch.core.config import Config
from dtt_torch.train.trainer import TrainState


def save_checkpoint(ckpt_dir: str, state: TrainState, cfg: Config) -> str:
    """Write a checkpoint for the current step; returns its path."""
    path = os.path.join(ckpt_dir, f"step_{state.step:08d}")
    os.makedirs(path, exist_ok=True)
    torch.save({"params": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step, "config": dataclasses.asdict(cfg)},
               os.path.join(path, "state.pt"))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": state.step, "time": time.time()}, f)
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


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load the checkpoint at `path` into `state`'s model and optimizer
    (in place, on their device); returns the state at the saved step."""
    device = next(state.model.parameters()).device
    saved = torch.load(os.path.join(path, "state.pt"), map_location=device,
                       weights_only=True)
    state.model.load_state_dict(saved["params"])
    state.optimizer.load_state_dict(saved["optimizer"])
    return state._replace(step=int(saved["step"]))


def checkpoint_config(path: str) -> dict:
    """The config dict saved in the checkpoint at `path` (tuples come back
    as lists; ``dtt_torch.core.config.config_from_dict`` rebuilds the Config)."""
    saved = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                       weights_only=True, mmap=True)
    return saved["config"]


def restore_params_only(path: str, model: torch.nn.Module) -> tuple[dict, int]:
    """Load only the model parameters of the checkpoint at `path` into
    `model` (in place, on its device), as evaluation needs; returns the
    saved config dict and step. The optimizer state stays on the disk."""
    saved = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                       weights_only=True, mmap=True)
    model.load_state_dict(saved["params"])
    return saved["config"], int(saved["step"])
