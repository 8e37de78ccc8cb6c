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

``torch.optim.SGD`` holds the two groups (weights; biases) and the momentum
buffers; the update itself is written here as ``torch._foreach_*`` ops in
SGD's order (decay, momentum, rate), with the rate a device tensor that
``learning_rate_tensor`` computes from the step on the card, so that one
captured update serves every step.

``make_train_step`` returns the step as a program
(``dtt_torch.utils.programs``), as ``dtt`` jits its step: forward,
backward and update captured once as a CUDA graph, at the second step
(the first runs eagerly and makes the momentum buffers), and replayed;
the batch, the draws and the step number are its inputs, the render
generator a registered one. ``step.eager`` is the same step uncaptured.

Data parallelism (``make_parallel_train_step``) is one process per device,
as ``torchrun`` starts them: each rank takes its rows of the global batch
(``shard_batch``, ``shard_draws``) and the ranks' gradients are averaged
by one all-reduce over a flat buffer before the clip, so the update is the
one a single process makes on the whole batch. That step is a program
too, as ``dtt`` jits it: under NCCL the all-reduces are captured in its
CUDA graph.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from dtt_torch.core.anchors import grid_anchors_for
from dtt_torch.core.config import Config
from dtt_torch.core.device import resolve_device
from dtt_torch.models.dnt import DnT, is_frozen
from dtt_torch.models.targets import Draws
from dtt_torch.parallel.mesh import (DataMesh, all_reduce_mean_, broadcast_,
                                     data_mesh, mesh_program)
from dtt_torch.train.losses import batch_loss
from dtt_torch.utils.params import from_jax_params, init_jax_params
from dtt_torch.utils.programs import StepProgram, upload


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


def learning_rate_tensor(cfg: Config, step: torch.Tensor) -> torch.Tensor:
    """`learning_rate` at the 0-d integer tensor `step`, as a float32 0-d
    tensor on its device: the same float32 operations in the same order
    (the division by a tensor, as a true division on every device), so
    equal to optax's schedule bit for bit."""
    t = cfg.train
    f32 = dict(dtype=torch.float32, device=step.device)
    lr = torch.full((), np.float32(t.learning_rate), **f32)
    for boundary in t.lr_decay_steps:
        lr = torch.where(step >= int(boundary), lr * np.float32(t.gamma), lr)
    if t.warmup_steps > 0:
        warm = (step + 1).to(torch.float32) / torch.full(
            (), np.float32(t.warmup_steps), **f32)
        lr = lr * warm.clamp(max=1.0)
    return lr


def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """Scale `grads` in place by max_norm / norm when their global norm is
    at least `max_norm` (optax's ``clip_by_global_norm``: no epsilon).
    Returns the norm, a device scalar; nothing waits for the device."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def _trainable(optimizer: torch.optim.Optimizer) -> list:
    return [p for g in optimizer.param_groups for p in g["params"]]


def sgd_step_(optimizer: torch.optim.SGD, lr: torch.Tensor) -> None:
    """``torch.optim.SGD``'s update of each group from the ``.grad``s at
    the rate ``lr * lr_mult``, `lr` a 0-d tensor: weight decay, then
    ``buf = momentum * buf + u`` (``buf = u`` on the first step), then
    ``p += (-lr * lr_mult) * buf``, the product rounded before the sum,
    as optax scales the update before applying it."""
    for group in optimizer.param_groups:
        params = group["params"]
        if not params:
            continue
        grads = [p.grad for p in params]
        if group["weight_decay"]:
            grads = torch._foreach_add(grads, params,
                                       alpha=group["weight_decay"])
        momentum = group["momentum"]
        if momentum:
            bufs = [optimizer.state[p].get("momentum_buffer")
                    for p in params]
            if any(b is None for b in bufs):      # the first step
                bufs = [torch.clone(g).detach() for g in grads]
                for p, b in zip(params, bufs):
                    optimizer.state[p]["momentum_buffer"] = b
            else:
                torch._foreach_mul_(bufs, momentum)
                torch._foreach_add_(bufs, grads)
            grads = bufs
        torch._foreach_add_(params, torch._foreach_mul(
            grads, -group["lr_mult"] * lr))


@torch.no_grad()
def _update(cfg: Config, optimizer: torch.optim.SGD,
            step: torch.Tensor) -> None:
    """Clip, then the SGD step at ``learning_rate_tensor(cfg, step)``. A
    trainable parameter without a gradient counts as a zero gradient
    (weight decay and momentum still move it, as in optax)."""
    params = _trainable(optimizer)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    clip_by_global_norm_([p.grad for p in params], cfg.train.clip_gradients)
    sgd_step_(optimizer, learning_rate_tensor(cfg, step))


def apply_gradients(cfg: Config, state: TrainState) -> TrainState:
    """One optimizer update from the parameters' ``.grad``, eagerly: clip,
    then the SGD step at ``learning_rate_tensor`` of ``state.step`` made a
    0-d tensor on the parameters' device (the steps take the step number
    as an input instead)."""
    device = _trainable(state.optimizer)[0].device
    _update(cfg, state.optimizer,
            torch.full((), state.step, dtype=torch.int64, device=device))
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


def batch_tensors(batch: dict) -> dict:
    """A numpy (``synthetic_batch``) or tensor batch dict as tensors where
    they lie; labels become int64 indices."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.asarray(v))
        out[k] = t.long() if k == "gt_labels" else t
    return out


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """`batch_tensors` of `batch` on `device`."""
    return {k: upload(t, device) for k, t in batch_tensors(batch).items()}


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

    The step is a program (``dtt_torch.utils.programs``): on CUDA the
    first step runs eagerly, the second is captured as a CUDA graph and
    every step from it replays the graph, with the batch, the draws and
    the step number copied into its buffers and `generator` registered
    with it. The metrics are copies. The graph reads the state's
    parameters and momentum buffers where they lie, so a state is updated
    in place (``restore_checkpoint`` and weight loads copy into it); a
    step given another state's optimizer captures anew.
    ``train_step.eager`` is the same step uncaptured.
    """
    device = resolve_device(device)
    model_device = next(model.parameters()).device
    if model_device.type != device.type:
        raise ValueError(f"model is on {model_device}, step asked for {device}")
    anchors = torch.from_numpy(
        grid_anchors_for(cfg.model.anchors, *feat_hw)).to(device)

    def body(model, optimizer, step, batch, draws, generator):
        if render_fn is not None:
            batch = dict(batch, images=render_fn(batch, generator))
        optimizer.zero_grad(set_to_none=True)
        _, lb = batch_loss(cfg, model, anchors, batch, draws)
        lb.total.backward()
        _update(cfg, optimizer, step)
        return {k: v.detach() for k, v in lb._asdict().items()}

    program = StepProgram(body, "train step", device, eager_calls=1)
    return _train_step(program, program, render_fn)


def _train_step(program: StepProgram, form, render_fn):
    """``train_step(state, batch, draws, generator=None) -> (state,
    metrics)`` calling `form` (the program, or what stands for it) on the
    state's model, optimizer and step number; ``train_step.eager`` calls
    the program's uncaptured twin, ``train_step.programs`` holds it."""
    def checked(form):
        def train_step(state: TrainState, batch: dict, draws: Draws,
                       generator: torch.Generator | None = None):
            if render_fn is not None and generator is None:
                raise ValueError("a step with render_fn draws its canvases "
                                 "from a generator; pass one")
            metrics = form(state.model, state.optimizer, state.step,
                           batch_tensors(batch), draws, generator)
            return state._replace(step=state.step + 1), metrics
        return train_step

    train_step = checked(form)
    train_step.eager = checked(program.eager)
    train_step.programs = (program,)
    return train_step


def make_data_mesh(device=None) -> DataMesh:
    """The 1-D data mesh of this rank (``dtt_torch.parallel.data_mesh``):
    one process per device, the counterpart of ``dtt``'s mesh over all
    chips."""
    return data_mesh(device)


def shard_batch(batch: dict, mesh: DataMesh) -> dict:
    """This rank's rows [r*b, (r+1)*b) of every array of a global host
    batch of B = world * b pairs; raises unless B divides by the world
    size, as ``dtt``'s sharding does."""
    rows = mesh.rows(len(next(iter(batch.values()))))
    return {k: v[rows] for k, v in batch.items()}


def shard_draws(draws: Draws, mesh: DataMesh) -> Draws:
    """This rank's rows of the `Draws` of the global batch. Every rank
    draws the global batch's uniforms from a generator seeded alike
    (``sample_draws(cfg, B, generator)``) and keeps its own pairs, as
    ``dtt`` splits its key over the global batch."""
    rows = mesh.rows(draws.anchor_pos.shape[0])
    return Draws(*(x[rows] for x in draws))


def replicate_tree(state, mesh: DataMesh):
    """Make every rank's replica rank 0's: the parameters and buffers
    (frozen-BN affines) of a `TrainState`'s model or of a module, the
    optimizer's momentum buffers and the step. Ranks that built their
    state alike are left as they were; one that read other weights by
    itself takes rank 0's. The tensors are overwritten in place, so a
    step program's graph reads the broadcast values. Returns the state."""
    model = state.model if isinstance(state, TrainState) else state
    tensors = list(model.state_dict().values())
    if isinstance(state, TrainState):
        tensors += [s["momentum_buffer"]
                    for s in state.optimizer.state.values()
                    if s.get("momentum_buffer") is not None]
    with torch.no_grad():
        broadcast_(tensors, mesh)
    if isinstance(state, TrainState) and mesh.distributed:
        step = torch.tensor([state.step], dtype=torch.int64,
                            device=mesh.device)
        broadcast_([step], mesh)
        state = state._replace(step=int(step.item()))
    return state


class _FlatGrads:
    """One preallocated float32 buffer holding the trainable parameters'
    gradients: each ``.grad`` is a view of it with its parameter's strides
    (channels-last convs included, autograd's layout contract), so
    backward accumulates into the buffer in place and one all-reduce
    averages all of them."""

    def __init__(self, params: list):
        self.params = params
        self.numel = sum(p.numel() for p in params)
        self.buffer = torch.zeros(self.numel, dtype=torch.float32,
                                  device=params[0].device)
        self.views, off = [], 0
        for p in params:
            if not (p.is_contiguous() or (p.dim() == 4 and p.is_contiguous(
                    memory_format=torch.channels_last))):
                raise ValueError(f"a parameter of shape {tuple(p.shape)} "
                                 f"and strides {p.stride()} is not dense")
            self.views.append(self.buffer.as_strided(p.shape, p.stride(),
                                                     off))
            off += p.numel()

    def bind(self) -> None:
        """Fill the buffer with -0.0 and make it every parameter's
        ``.grad``. -0.0 is IEEE addition's identity (+0.0 turns a -0.0
        gradient into +0.0), so backward's accumulation into the buffer
        leaves each gradient's bits as a step without the buffer has
        them."""
        self.buffer.fill_(-0.0)
        for p, v in zip(self.params, self.views):
            p.grad = v


def make_parallel_train_step(cfg: Config, model: DnT,
                             feat_hw: tuple[int, int], mesh: DataMesh,
                             render_fn=None):
    """Data-parallel ``train_step(state, batch, draws, generator=None) ->
    (state, metrics)`` on ``mesh.device``, which must hold `model`: this
    rank's replica takes this rank's rows of the global batch and of its
    draws (``shard_batch``, ``shard_draws``) and every rank makes the
    update one process makes on the whole global batch.

    The loss is the mean over the pairs (``batch_loss``), so the global
    gradient is the mean of the ranks' gradients: they are averaged by one
    all-reduce over a flat float32 buffer of the trainable gradients,
    after the backward and before the global-norm clip. A trainable
    parameter the loss does not reach holds a zero gradient (-0.0) in the
    buffer on every rank alike. The metrics are averaged too, so every rank returns the
    global ``LossBreakdown`` (device scalars).

    The step is a program as ``make_train_step``'s is (its first call
    eager, making the momentum buffers and NCCL's communicator, which no
    capture can make; captured at the second), with both all-reduces
    inside it, as ``dtt``'s jitted step holds its ``psum``. The form is the
    backend's (``mesh_program``): a CUDA graph under NCCL, copies around
    a direct call on the CPU, and under gloo on CUDA a call raises (gloo's
    collectives wait on the host); ``train_step.eager`` is the step
    uncaptured, on any backend. Each optimizer keeps its flat buffer as
    long as it lives, and every step makes the buffer's views the
    parameters' ``.grad`` again, so a graph and an eager step on one state
    write and read the same memory.

    DDP is not used: it syncs only inside its module's ``forward``, and
    the loss runs the model's other methods. `render_fn` as in
    ``make_train_step``: each rank draws its canvases on its own device.
    """
    device = mesh.device
    model_device = next(model.parameters()).device
    if model_device != device:
        raise ValueError(f"model is on {model_device}, mesh holds {device}")
    anchors = torch.from_numpy(
        grid_anchors_for(cfg.model.anchors, *feat_hw)).to(device)
    flat = weakref.WeakKeyDictionary()      # optimizer -> its _FlatGrads

    def body(model, optimizer, step, batch, draws, generator):
        if render_fn is not None:
            batch = dict(batch, images=render_fn(batch, generator))
        grads = flat.get(optimizer)
        if grads is None:
            grads = flat[optimizer] = _FlatGrads(_trainable(optimizer))
        grads.bind()
        _, lb = batch_loss(cfg, model, anchors, batch, draws)
        lb.total.backward()
        all_reduce_mean_(grads.buffer, mesh)
        _update(cfg, optimizer, step)
        metrics = all_reduce_mean_(torch.stack(lb).detach(), mesh)
        return dict(zip(lb._fields, metrics.unbind()))

    program = StepProgram(body, "parallel train step", device, eager_calls=1)
    train_step = _train_step(program, mesh_program(program, mesh), render_fn)
    train_step.allreduce_bytes = lambda state: 4 * sum(
        p.numel() for p in _trainable(state.optimizer))
    return train_step
