"""Training: targets-to-loss, optimizer, the single-device and the
data-parallel train step, and checkpoints."""

from dtt_torch.train.checkpoint import (latest_checkpoint, load_params,
                                        restore_checkpoint, save_checkpoint,
                                        save_params)
from dtt_torch.train.losses import LossBreakdown, batch_loss, pair_loss
from dtt_torch.train.trainer import (TrainState, create_train_state,
                                     make_data_mesh, make_optimizer,
                                     make_parallel_train_step,
                                     make_train_step, replicate_tree,
                                     shard_batch, shard_draws)

__all__ = ["latest_checkpoint", "load_params", "restore_checkpoint",
           "save_checkpoint", "save_params", "LossBreakdown", "batch_loss",
           "pair_loss", "TrainState", "create_train_state", "make_data_mesh",
           "make_optimizer", "make_parallel_train_step", "make_train_step",
           "shard_batch", "replicate_tree", "shard_draws"]
