"""dtt_torch: the PyTorch/CUDA port of ``dtt`` (Detect to Track) for an
NVIDIA H100.

It covers what ``dtt`` does on one device: video-mode, tau-strided and
single-frame inference (``dtt_torch.eval``), training (``dtt_torch.train``),
the data pipeline (``dtt_torch.data``), every pooling mode, and weights in
and out in ``dtt``'s run-dir format (``dtt_torch.utils``). Every TPU
kernel of ``dtt`` is a hand-written CUDA kernel (``dtt_torch.ops``). The
package imports torch and numpy only, never JAX, flax, msgpack or
``dtt``. Entry points run on CUDA unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper uses its plain
PyTorch version.
"""

__version__ = "0.1.0"
