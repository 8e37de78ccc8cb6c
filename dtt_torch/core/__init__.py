"""Config, anchors, box geometry and device selection (no JAX)."""

from dtt_torch.core.config import (AnchorConfig, Config, EvalConfig,
                                   InputConfig, ModelConfig, RoIConfig,
                                   RPNConfig, TrackConfig, TrainConfig,
                                   load_config, save_config)
from dtt_torch.core import anchors, boxes

__all__ = [
    "AnchorConfig", "Config", "EvalConfig", "InputConfig", "ModelConfig",
    "RoIConfig", "RPNConfig", "TrackConfig", "TrainConfig",
    "load_config", "save_config", "boxes", "anchors",
]
