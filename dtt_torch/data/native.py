"""ctypes binding of the port's fused JPEG pipeline (``_native/pixelops.cpp``,
the port's copy of ``dtt``'s).

``decode_resize_normalize(jpeg_bytes, cfg, flip)`` decodes a JPEG at a DCT
scale, resizes it onto the canvas, mirrors it when asked and subtracts the
BGR mean in one pass. The library is built at first use with
``g++ -O3 -march=native -shared -fPIC ... -ljpeg`` into ``dtt_torch/_build/``,
named by a hash of the source, the flags and what ``-march=native`` means
on this host, so a library built for another CPU is never loaded. Where it
does not build (no ``g++``, no libjpeg header or library), ``available()``
is false and ``unavailable_reason()`` says why; nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "_native" / "pixelops.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_loaded: list = []     # [(library or None, reason it is missing or None)]


def _native_target() -> bytes:
    """The target options ``-march=native`` resolves to on this host."""
    return subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                          capture_output=True, check=True, timeout=60).stdout


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()
                            + _native_target()).hexdigest()[:16]
    return BUILD_DIR / f"libpixelops-{digest}.so"


def _build_and_load() -> tuple:
    try:
        out = library_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-ljpeg", "-o",
                                   str(tmp)], capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                lines = proc.stderr.strip().splitlines() or ["(no output)"]
                return None, f"g++ failed: {lines[0]}"
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
    except (OSError, subprocess.SubprocessError) as e:
        return None, f"{type(e).__name__}: {e}"
    lib.decode_resize_normalize.restype = ctypes.c_int
    lib.decode_resize_normalize.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    return lib, None


def _library() -> tuple:
    with _lock:
        if not _loaded:
            _loaded.append(_build_and_load())
        return _loaded[0]


def available() -> bool:
    """Whether the library built (or was built before) and loaded."""
    return _library()[0] is not None


def unavailable_reason() -> str | None:
    """Why the library is missing, or None when it loaded."""
    return _library()[1]


def decode_resize_normalize(jpeg_bytes: bytes, cfg, flip: bool = False
                            ) -> tuple[np.ndarray, float]:
    """JPEG bytes -> (float32 canvas (H, W, 3), BGR, mean-subtracted, zero
    beyond the image; the scale applied). `cfg` is an InputConfig.

    Raises RuntimeError when the library is missing and ValueError when the
    bytes do not decode."""
    lib, reason = _library()
    if lib is None:
        raise RuntimeError(f"the native JPEG pipeline is unavailable: {reason}")
    canvas = np.zeros((cfg.canvas_height, cfg.canvas_width, 3), np.float32)
    mean = np.asarray(cfg.pixel_means, np.float32)
    scale = ctypes.c_float(0.0)
    rc = lib.decode_resize_normalize(
        jpeg_bytes, len(jpeg_bytes),
        canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cfg.canvas_height, cfg.canvas_width,
        ctypes.c_float(float(cfg.target_short_side)),
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        int(bool(flip)), ctypes.byref(scale))
    if rc != 0:
        raise ValueError(f"jpeg decode failed (rc={rc})")
    return canvas, float(scale.value)
