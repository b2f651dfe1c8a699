"""JPEG decode without PIL: the pixels of PIL's `Image.open(p).convert("RGB")`.

The JAX package reads every JPEG through PIL, which links libjpeg-turbo and
decodes with its defaults: the islow integer IDCT, fancy chroma upsampling
and fixed-point YCbCr -> RGB.  `csrc/jpeg_decode.cpp` does each of those
stages with libjpeg's arithmetic, for baseline, extended and progressive
8-bit Huffman files, so its pixels are PIL's bit for bit
(`tests/test_torch_jpeg.py` holds it so).  It builds with g++ at first use
into `saspa_tpu_torch/_host_build/` (`ops/host_resize.load_host_library`)
and is called through ctypes, which releases the GIL: the train pipeline's
decode threads run in parallel.  A failed build raises; nothing falls back
to PIL.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from saspa_tpu_torch.ops.host_resize import load_host_library

SRC = Path(__file__).resolve().parent.parent / "csrc" / "jpeg_decode.cpp"


class JPEGError(OSError):
    """A corrupt or truncated JPEG (PIL raises OSError for these too)."""


class UnsupportedJPEG(JPEGError):
    """A JPEG of a kind this decoder refuses; the message names the feature."""


def _declare(lib) -> None:
    u8p, ip, i, cp = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_char_p
    lib.jpeg_header.argtypes = [u8p, ctypes.c_size_t, ip, ip, ip, cp, i]
    lib.jpeg_header.restype = i
    lib.jpeg_decode.argtypes = [u8p, ctypes.c_size_t, u8p, i, i, i, cp, i]
    lib.jpeg_decode.restype = i


def _check(rc: int, err, name: str) -> None:
    if rc:
        msg = f"{name}: {err.value.decode(errors='replace')}"
        raise UnsupportedJPEG(msg) if rc == 2 else JPEGError(msg)


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """(H, W, 1) uint8 for a grey JPEG, (H, W, 3) RGB otherwise; `name` goes
    into the error messages."""
    lib = load_host_library(SRC, "jpeg_decode", _declare)
    buf = np.frombuffer(data, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    src = buf.ctypes.data_as(u8p)
    err = ctypes.create_string_buffer(256)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib.jpeg_header(src, buf.size, ctypes.byref(w), ctypes.byref(h), ctypes.byref(c), err, 256), err, name)
    out = np.empty((h.value, w.value, c.value), np.uint8)
    _check(lib.jpeg_decode(src, buf.size, out.ctypes.data_as(u8p), w.value, h.value, c.value, err, 256), err, name)
    return out


def read_jpeg(path) -> np.ndarray:
    return decode_jpeg(Path(path).read_bytes(), str(path))
