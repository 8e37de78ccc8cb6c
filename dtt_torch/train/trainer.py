"""Trainer: SGD with momentum under the reference's per-parameter rules,
and the single-GPU train step (counterpart of ``dtt.train.trainer``).

The optimizer is ``dtt``'s optax chain, step for step:

1. clip the gradients by their global norm (optax's form, no epsilon);
2. add weight decay (not on biases unless ``bias_decay``);
3. scale bias updates by 2 (``double_bias_lr``), before the momentum,
   which equals a bias group at twice the learning rate;
4. momentum ``buf = momentum * buf + u`` (``buf = u`` on the first step, as
   ``optax.trace`` from zeros) and ``p -= lr(step) * buf``, with the step
   decay and the multiplicative warm-up of ``make_optimizer``;
5. frozen parameters (frozen-BN affines, frozen stages) are in no group
   and never change.

Steps 2-4 are ``torch.optim.SGD`` with one group for weights and one for
biases; the clip and the schedule are done here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dtt_torch.core.anchors import grid_anchors_for
from dtt_torch.core.config import Config
from dtt_torch.core.device import resolve_device
from dtt_torch.models.dnt import DnT, is_frozen
from dtt_torch.models.targets import Draws
from dtt_torch.train.losses import batch_loss
from dtt_torch.utils.params import from_jax_params, init_jax_params


class TrainState(NamedTuple):
    """The model and its optimizer, updated in place by a step (as JAX
    donates its state), and the number of steps taken."""

    model: DnT
    optimizer: torch.optim.Optimizer
    step: int


def _is_bias(name: str) -> bool:
    return name.rsplit(".", 1)[-1] == "bias"


def learning_rate(cfg: Config, step: int) -> float:
    """optax's ``piecewise_constant_schedule`` (scaled by gamma from each
    boundary on: at step b the rate is already decayed) times the
    multiplicative warm-up min(1, (step + 1) / warmup_steps), in float32
    as optax computes it."""
    t = cfg.train
    lr = np.float32(t.learning_rate)
    for boundary in t.lr_decay_steps:
        if step >= int(boundary):
            lr = np.float32(np.float32(t.gamma) * lr)
    if t.warmup_steps > 0:
        warm = min(np.float32(1.0),
                   np.float32(step + 1) / np.float32(t.warmup_steps))
        lr = np.float32(lr * warm)
    return float(lr)


def make_optimizer(cfg: Config, model: DnT) -> torch.optim.SGD:
    """SGD + momentum over the trainable parameters: a weight group with
    weight decay and a bias group at ``lr_mult`` 2 (``double_bias_lr``)
    without it (unless ``bias_decay``). Frozen parameters are left out."""
    t = cfg.train
    weights, biases = [], []
    for name, p in model.named_parameters():
        if is_frozen(name, cfg.model.frozen_stages):
            continue
        (biases if _is_bias(name) else weights).append(p)
    groups = [
        {"params": weights, "lr_mult": 1.0, "weight_decay": t.weight_decay},
        {"params": biases, "lr_mult": 2.0 if t.double_bias_lr else 1.0,
         "weight_decay": t.weight_decay if t.bias_decay else 0.0},
    ]
    return torch.optim.SGD(groups, lr=t.learning_rate, momentum=t.momentum)


def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """Scale `grads` in place by max_norm / norm when their global norm is
    at least `max_norm` (optax's ``clip_by_global_norm``: no epsilon).
    Returns the norm, a device scalar; nothing waits for the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def apply_gradients(cfg: Config, state: TrainState) -> TrainState:
    """One optimizer update from the parameters' ``.grad``: clip, then the
    SGD step at ``learning_rate(cfg, state.step)``. A trainable parameter
    without a gradient counts as a zero gradient (weight decay and momentum
    still move it, as in optax)."""
    opt = state.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    clip_by_global_norm_([p.grad for p in params], cfg.train.clip_gradients)
    lr = learning_rate(cfg, state.step)
    for group in opt.param_groups:
        group["lr"] = lr * group["lr_mult"]
    opt.step()
    return state._replace(step=state.step + 1)


def create_train_state(cfg: Config, device=None, tree: dict | None = None
                       ) -> tuple[DnT, TrainState]:
    """The model on `device` (CUDA unless the caller passes "cpu") with
    the flax-layout weights `tree` (default: drawn from ``cfg.train.seed``
    by ``init_jax_params``), its optimizer, and step 0."""
    if tree is None:
        tree = init_jax_params(cfg.model, seed=cfg.train.seed)
    model = from_jax_params(tree, cfg.model, device).train()
    return model, TrainState(model, make_optimizer(cfg, model), 0)


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """A numpy (``synthetic_batch``) or tensor batch dict as tensors on
    `device`; labels become int64 indices."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.asarray(v))
        if k == "gt_labels":
            t = t.long()
        if device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def make_train_step(cfg: Config, model: DnT, feat_hw: tuple[int, int],
                    device=None, render_fn=None):
    """``train_step(state, batch, draws, generator=None) -> (state,
    metrics)`` on `device` (CUDA unless the caller passes "cpu"), which
    must hold `model`.

    `batch` is a numpy or tensor batch dict (see ``batch_loss``), `draws`
    the sampling uniforms (``sample_draws``). The step computes the loss,
    backpropagates it and applies the optimizer; `metrics` holds the
    ``LossBreakdown`` fields as device scalars, so nothing waits for the
    device.

    With `render_fn(batch, generator) -> images` (device-side synthetic
    rendering, ``dtt_torch.data.device_synth.make_pair_render_fn``) the
    batch carries scene parameters only and the step draws its canvases
    on the device first, from `generator`, which it then needs.
    """
    device = resolve_device(device)
    model_device = next(model.parameters()).device
    if model_device.type != device.type:
        raise ValueError(f"model is on {model_device}, step asked for {device}")
    anchors = torch.from_numpy(
        grid_anchors_for(cfg.model.anchors, *feat_hw)).to(device)

    def train_step(state: TrainState, batch: dict, draws: Draws,
                   generator: torch.Generator | None = None):
        if render_fn is not None:
            if generator is None:
                raise ValueError("a step with render_fn draws its canvases "
                                 "from a generator; pass one")
            batch = dict(batch, images=render_fn(batch, generator))
        state.optimizer.zero_grad(set_to_none=True)
        _, lb = batch_loss(cfg, state.model, anchors,
                           batch_to_device(batch, device), draws)
        lb.total.backward()
        state = apply_gradients(cfg, state)
        return state, {k: v.detach() for k, v in lb._asdict().items()}

    return train_step
