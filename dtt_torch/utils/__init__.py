"""Weight bridge from the flax parameter tree, checkpoints' codec, the
metrics log, profiling, device timing and step programs (CUDA graphs)."""

from dtt_torch.utils.logging import MetricLogger, read_metrics
from dtt_torch.utils.profiling import StepTimer, annotate, device_trace
from dtt_torch.utils.programs import StepProgram
from dtt_torch.utils.timing import chained_time, sync_latency

__all__ = ["MetricLogger", "read_metrics", "StepTimer", "annotate",
           "device_trace", "chained_time", "sync_latency", "StepProgram"]
