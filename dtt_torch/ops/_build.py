"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` (seconds to
build; no PyTorch headers). Libraries go to ``dtt_torch/_build/``, named by
a hash of the source, every ``csrc/*.cuh`` header and the flags, so a
changed source or header rebuilds and an unchanged one is reused. Nothing
is built at import: the first call of a kernel wrapper builds what it
needs; ``build()`` builds several at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
KERNELS = ("correlation", "epilogue", "linking", "nms", "psroi")
# a block's shared memory on sm_90 (227 KB): kMaxSmem and kSmemLimit in csrc/
SMEM_LIMIT = 232_448
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "dtt_torch's kernels")


def library_path(name: str) -> Path:
    """The library of `name`, named by a hash of its source, every header
    in ``csrc/`` and the flags."""
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=KERNELS, verbose: bool = False) -> dict:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together. Returns the compiler output per kernel
    built (with ``-Xptxas -v`` when `verbose`); raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
