"""The 1-D data mesh of one process per device (counterpart of
``dtt.parallel.mesh``).

``dtt`` shards a batch over the chips of one program (a 1-D ``data``
mesh) and lets XLA insert the collectives. PyTorch's idiom is one process
per GPU: ``torchrun`` starts the ranks, each holds a replica of the model
on ``cuda:LOCAL_RANK``, and ``torch.distributed`` carries the collectives,
NCCL on the card and gloo on the CPU. `DataMesh` is one rank's view of
that mesh: its rank, the world size and its device.

The collectives here are the ones the parallel steps need: a mean
all-reduce, a broadcast, an all-gather in rank order and the one-frame
halo of the video step (``lax.ppermute`` in ``dtt``). Under gloo (the
CPU, or several ranks on one card, which NCCL refuses) the halo's CUDA
tensors go through the host: gloo's send and receive take no device
memory, while its all-reduce, broadcast and all-gather do
(``tools/probe_collectives_torch.py`` on an H100). ``dtt``'s
``global_mesh``, ``replicated`` and
``data_sharded`` are JAX sharding objects over the devices of one
program and have no counterpart when each process holds one device.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist

from dtt_torch.core.device import resolve_device


class DataMesh(NamedTuple):
    """One rank's view of the 1-D data mesh over the default process
    group. Without a process group it is the mesh of one rank, and every
    collective is the identity."""

    rank: int
    size: int              # world size: the number of data shards
    device: torch.device

    @property
    def distributed(self) -> bool:
        return dist.is_available() and dist.is_initialized()

    @property
    def backend(self) -> str | None:
        return dist.get_backend() if self.distributed else None

    def rows(self, n: int) -> slice:
        """This rank's rows [r*b, (r+1)*b) of `n` global rows; raises
        unless `n` divides by the world size."""
        if n % self.size:
            raise ValueError(f"a global batch of {n} does not divide over "
                             f"{self.size} ranks")
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)


def local_device(device=None) -> torch.device:
    """The rank's device: ``cuda:LOCAL_RANK`` unless the caller names one
    (``"cuda"`` without an index also means LOCAL_RANK's card) or asks
    for the CPU; raises without a card, as every entry point does."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None, device=None,
                           backend: str | None = None,
                           store=None) -> None:
    """Join the process group: NCCL for a CUDA device, gloo for the CPU
    (`backend` overrides, e.g. gloo for two ranks on one card, which NCCL
    refuses). Reads ``torchrun``'s environment (``WORLD_SIZE``, ``RANK``,
    ``MASTER_ADDR``/``MASTER_PORT`` behind ``env://``) for what is not
    given. A no-op without ``WORLD_SIZE`` and without arguments (one
    process), and when the group already exists.

    Binds CUDA ranks to their device first (``torch.cuda.set_device``).
    Any failure raises: there is no fallback to one process.

    What the step programs need to capture NCCL's collectives in a CUDA
    graph (``tools/probe_nccl_capture_torch.py`` on an H100, torch 2.11,
    NCCL 2.28.9, one rank): the group's communicator, which NCCL makes at the
    first collective and which a capture cannot make (the capture fails),
    so an NCCL group makes it here with one all-reduce; the send and
    receive communicators of the halo (N > 1) come at a step's eager
    warm-up, before its capture. No environment setting: captures succeed
    under ``TORCH_NCCL_ASYNC_ERROR_HANDLING=0`` and
    ``TORCH_NCCL_BLOCKING_WAIT=1`` alike, and a work's ``wait()`` inside a
    capture only orders the streams; ``is_completed()`` inside one breaks
    the capture, and nothing here calls it."""
    if (init_method is None and world_size is None and store is None
            and "WORLD_SIZE" not in os.environ):
        return
    if dist.is_initialized():
        return
    dev = local_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if store is not None:
        dist.init_process_group(backend, store=store, world_size=world_size,
                                rank=rank)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank)
    if backend == "nccl":
        dist.all_reduce(torch.zeros(1, device=dev))


def data_mesh(device=None) -> DataMesh:
    """The 1-D data mesh of this rank over the whole world, on its device
    (``local_device``); one rank without a process group."""
    dev = local_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        return DataMesh(0, 1, dev)
    return DataMesh(dist.get_rank(), dist.get_world_size(), dev)


def _on_mesh(tensors: Sequence[torch.Tensor], mesh: DataMesh) -> None:
    """Refuse a tensor off the rank's device before it reaches a
    collective: NCCL takes no host tensor."""
    for t in tensors:
        if t.device != mesh.device:
            raise ValueError(f"a collective over {mesh.device} was given a "
                             f"tensor on {t.device}")


def all_reduce_mean_(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Replace `t` in place by its mean over the ranks; returns it."""
    _on_mesh([t], mesh)
    if mesh.distributed:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    if mesh.size > 1:
        t.div_(mesh.size)
    return t


def broadcast_(tensors: Sequence[torch.Tensor], mesh: DataMesh,
               src: int = 0) -> None:
    """Overwrite each tensor in place by rank `src`'s."""
    _on_mesh(tensors, mesh)
    if not mesh.distributed:
        return
    for t in tensors:
        dist.broadcast(t, src=src)


def barrier(mesh: DataMesh) -> None:
    if mesh.distributed:
        dist.barrier()


def all_gather_cat(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's `t` (all of one shape) concatenated along dim 0 in
    rank order, on the rank's device (`t` is copied there first)."""
    t = t.to(mesh.device).contiguous()
    if not mesh.distributed:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t)
    return torch.cat(parts)


def mesh_program(program, mesh: DataMesh):
    """The form a parallel step's program (a ``StepProgram`` over `mesh`,
    its collectives inside) runs in, decided by the backend: the program
    itself on the CPU (no graph: copies around a direct call), without a
    group and under NCCL, whose collectives are captured in the CUDA
    graph; under any other backend on CUDA (gloo: its CUDA collectives
    wait on the host, and its send and receive take no device memory) a
    callable that raises a RuntimeError naming the backend, since such a
    collective cannot be captured. The step's ``.eager`` runs anywhere."""
    backend = mesh.backend
    if mesh.device.type != "cuda" or backend in (None, "nccl"):
        return program

    def refused(*args):
        raise RuntimeError(
            f"{program.name}: the {backend} backend's collectives cannot be "
            f"captured in a CUDA graph; call the step's .eager under "
            f"{backend}, or join an NCCL group")
    return refused


def exchange_halo(tensors: Sequence[torch.Tensor], mesh: DataMesh
                  ) -> list[torch.Tensor]:
    """Send each of `tensors` to rank r-1 and receive rank r+1's (both
    modulo the world size; ``ppermute`` over ``i -> i-1``). One rank gets
    its own tensors back."""
    _on_mesh(tensors, mesh)
    if mesh.size == 1:
        return list(tensors)
    # gloo's send and receive take no device memory
    staged = tensors[0].is_cuda and mesh.backend == "gloo"
    sends = [(t.cpu() if staged else t).contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    to = (mesh.rank - 1) % mesh.size
    frm = (mesh.rank + 1) % mesh.size
    ops = [dist.P2POp(dist.isend, t, to, tag=i) for i, t in enumerate(sends)]
    ops += [dist.P2POp(dist.irecv, t, frm, tag=i)
            for i, t in enumerate(recvs)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device) for r, t in zip(recvs, tensors)]
