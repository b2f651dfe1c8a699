"""The train pipeline's host resize (counterpart of
saspa_tpu/native/host_ops.py::resize_bilinear_u8).

`csrc/saspa_host.cpp` is a copy of the JAX package's native resize: an area
average on downscale, half-pixel bilinear on upscale, f32 accumulation, a
+0.5 round.  It builds with g++ and the JAX package's flags into
`saspa_tpu_torch/_host_build/` at first use (the file name carries a hash
of the source and flags, so an edit rebuilds), and loads through ctypes; a
call releases the GIL, so a thread pool resizes in parallel.  A failed
build raises: no other resize gives the same pixels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "csrc" / "saspa_host.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_host_build"
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_libs = {}


def load_host_library(src: Path, stem: str, declare) -> ctypes.CDLL:
    """Builds `src` with g++ into BUILD_DIR/lib<stem>-<hash>.so at first use
    (the hash covers the source and flags; a temporary file is renamed into
    place, so processes that build at once do not clash) and loads it under a
    lock; `declare(lib)` sets the functions' argtypes.  A failed build
    raises."""
    with _lock:
        if stem not in _libs:
            digest = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
            out = BUILD_DIR / f"lib{stem}-{digest}.so"
            if not out.exists():
                gxx = shutil.which("g++")
                if gxx is None:
                    raise RuntimeError(f"g++ not found: {src.name} builds with g++")
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                done = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(src), "-lpthread"],
                                      capture_output=True, text=True)
                if done.returncode != 0:
                    raise RuntimeError(f"building {src.name} failed:\n{done.stderr}")
                tmp.replace(out)
            lib = ctypes.CDLL(str(out))
            declare(lib)
            _libs[stem] = lib
    return _libs[stem]


def _declare(lib) -> None:
    u8p, i = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int
    lib.resize_bilinear_u8.argtypes = [u8p, i, i, i, u8p, i, i]
    lib.resize_bilinear_u8.restype = None


def _load() -> ctypes.CDLL:
    return load_host_library(SRC, "saspa_host", _declare)


def resize_bilinear_u8(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """uint8 (H, W, C) -> (dh, dw, C)."""
    src = np.ascontiguousarray(src, np.uint8)
    sh, sw, c = src.shape
    dst = np.empty((dh, dw, c), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    _load().resize_bilinear_u8(src.ctypes.data_as(u8p), sh, sw, c, dst.ctypes.data_as(u8p), dh, dw)
    return dst
