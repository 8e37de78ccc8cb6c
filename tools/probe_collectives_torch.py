"""Which torch.distributed collectives run on CUDA tensors on one card:
two gloo ranks (NCCL refuses two ranks on one device) and one NCCL rank.

    python3 tools/probe_collectives_torch.py

Each collective (all_reduce, broadcast, all_gather, barrier, a send/recv
pair by batch_isend_irecv) runs on CUDA tensors, and under gloo on CPU
tensors too, in a fresh group of fresh processes: a collective that
crashes its process (gloo reading a device pointer as a host one aborts
it) is recorded as such, and the group's timeout ends one that waits for
ever. Prints one JSON line per backend: {op [device]: "ok" | what went
wrong}. Under gloo, dtt_torch.parallel sends the CUDA tensors of the
one collective gloo refuses them for (send/recv) through the host.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPS = ("all_reduce", "broadcast", "all_gather", "barrier", "send_recv")


def _try(op: str, dev: str, rank: int, world: int) -> str:
    t = torch.full((4,), float(rank + 1), device=dev)
    try:
        if op == "all_reduce":
            dist.all_reduce(t)
            ok = t[0].item() == world * (world + 1) / 2
        elif op == "broadcast":
            dist.broadcast(t, src=0)
            ok = t[0].item() == 1.0
        elif op == "all_gather":
            parts = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(parts, t)
            ok = [p[0].item() for p in parts] == [r + 1.0
                                                  for r in range(world)]
        elif op == "barrier":
            dist.barrier()
            ok = True
        else:
            if world == 1:
                return "n/a at one rank"
            got = torch.empty_like(t)
            peer = (rank + 1) % world
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, t, peer),
                    dist.P2POp(dist.irecv, got, peer)]):
                req.wait()
            ok = got[0].item() == peer + 1.0
        if dev == "cuda":
            torch.cuda.synchronize()
        return "ok" if ok else "wrong values"
    except Exception as e:   # recorded: the point is which ops fail
        return f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def _rank(rank: int, world: int, store: str, backend: str, op: str,
          dev: str, out: str) -> None:
    if torch.cuda.is_available():
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=30))
    res = _try(op, dev, rank, world)
    dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            f.write(res)


def probe(d: str, backend: str, world: int, op: str, dev: str) -> str:
    """One collective in a fresh group of `world` spawned ranks."""
    tag = f"{backend}-{op}-{dev}"
    out = os.path.join(d, f"{tag}.txt")
    try:
        mp.start_processes(_rank, args=(world, os.path.join(
            d, f"{tag}.store"), backend, op, dev, out), nprocs=world,
            start_method="spawn")
    except Exception as e:   # recorded: a crash is the probe's answer
        return f"rank process failed: {str(e).strip().splitlines()[-1]}"
    with open(out) as f:
        return f.read()


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_collectives_torch: no CUDA device", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, NCCL "
          f"{torch.cuda.nccl.version()}", flush=True)
    with tempfile.TemporaryDirectory() as d:
        for backend, world, devs in (("gloo", 2, ("cuda", "cpu")),
                                     ("nccl", 1, ("cuda",))):
            res = {f"{op} [{dev}]": probe(d, backend, world, op, dev)
                   for dev in devs for op in OPS}
            print(json.dumps({"backend": backend, "ranks": world,
                              "ops": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
