"""Image files for the generation driver, without PIL or cv2.

The JAX driver reads sources and writes PNGs with PIL; the machine with the
card has neither PIL nor cv2, so the port carries its own:
  * `read_png` / `write_png`: 8-bit PNG (gray, RGB, RGBA), non-interlaced,
    scanline filters 0-4; zlib from the standard library.  `write_png`
    writes RGB or gray with the Sub filter.
  * `image_size`: (width, height) from the header alone (PNG's IHDR, JPEG's
    SOF marker), as PIL's `Image.open(p).size` reads it for the driver's
    shape buckets.
  * `read_rgb`: an (H, W, 3) uint8 array as `np.asarray(Image.open(p).
    convert("RGB"))` gives it.  The format is told by the file's first bytes,
    not its name (FGVC-Aircraft paths end in .jpg whatever they hold).  PNG
    decodes here, JPEG through `gen/jpeg.py` (a host decoder bit-exact to
    PIL's libjpeg-turbo, never PIL itself); every other format decodes
    through PIL where PIL is installed, and raises otherwise.
  * `verify_image`: the check of `Image.open(p).verify()`, which the filter
    stage runs on every generated file: PNG chunks walked to IEND with each
    CRC checked, JPEG markers parsed to the start of scan; other formats
    through PIL where it is installed.  A file that fails raises
    `CorruptImage`; one that cannot be checked here raises `RuntimeError`.
"""

from __future__ import annotations

import re
import struct
import zlib
from pathlib import Path
from typing import Tuple

import numpy as np

from saspa_tpu_torch.gen.jpeg import read_jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel
# JPEG start-of-frame markers: C0-CF except DHT (C4), JPG (C8) and DAC (CC)
_SOF_MARKERS = set(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def sniff(path) -> str:
    """'png', 'jpeg' or 'other', from the file's first bytes."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == PNG_SIGNATURE:
        return "png"
    if head[:2] == JPEG_SIGNATURE:
        return "jpeg"
    return "other"


def image_size(path) -> Tuple[int, int]:
    """(width, height) from the header, without decoding pixels."""
    kind = sniff(path)
    with open(path, "rb") as f:
        if kind == "png":
            f.seek(8)
            length, tag = struct.unpack(">I4s", f.read(8))
            if tag != b"IHDR":
                raise ValueError(f"{path}: PNG without a leading IHDR chunk")
            return struct.unpack(">II", f.read(8))
        if kind == "jpeg":
            return _jpeg_size(f, path)
    with _pil_open(path) as im:
        return im.size


def _jpeg_size(f, path) -> Tuple[int, int]:
    f.seek(2)
    while True:
        byte = f.read(1)
        if not byte:
            break
        if byte != b"\xff":
            continue
        marker = f.read(1)
        while marker == b"\xff":  # fill bytes
            marker = f.read(1)
        if not marker:
            break
        m = marker[0]
        if m == 0xD8 or 0xD0 <= m <= 0xD7 or m == 0x01:  # markers without a length
            continue
        (length,) = struct.unpack(">H", f.read(2))
        if m in _SOF_MARKERS:
            _, height, width = struct.unpack(">BHH", f.read(5))
            return width, height
        f.seek(length - 2, 1)
    raise ValueError(f"{path}: JPEG without a start-of-frame marker")


def _pil_image(path):
    """PIL's Image module; RuntimeError where PIL is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"{path}: only PNG and JPEG decode without PIL, "
                           f"and PIL is not installed here") from e
    return Image


def _pil_open(path):
    return _pil_image(path).open(path)


class CorruptImage(ValueError):
    """A file that failed its image check."""


_CHUNK_TYPE = re.compile(rb"[A-Za-z0-9_]{4}")  # PIL's is_cid


def verify_image(path) -> None:
    """Raises CorruptImage where `Image.open(path).verify()` raises, as far
    as the format is checked here: a PNG must hold its signature, an IHDR
    chunk first, and whole chunks with matching CRCs up to IEND (whose CRC
    PIL does not read); a JPEG must hold every marker segment up to the start
    of scan, with a start-of-frame before it.  An empty file, or one that
    ends inside the PNG or JPEG signature, is no image of any format.  Other
    formats go through PIL, and raise RuntimeError (not CorruptImage) where
    PIL is not installed."""
    with open(path, "rb") as f:
        head = f.read(len(PNG_SIGNATURE))
    if len(head) < len(PNG_SIGNATURE) and (PNG_SIGNATURE.startswith(head) or JPEG_SIGNATURE.startswith(head)):
        raise CorruptImage(f"{path}: {len(head)} bytes, too short for an image")
    kind = sniff(path)
    if kind == "other":
        image = _pil_image(path)
        try:
            with image.open(path) as im:
                im.verify()
        except Exception as e:  # PIL raises many types for a broken file
            raise CorruptImage(f"{path}: {e}") from e
        return
    data = Path(path).read_bytes()
    (_verify_png if kind == "png" else _verify_jpeg)(data, path)


def _verify_png(data: bytes, path) -> None:
    pos, first = len(PNG_SIGNATURE), True
    while True:
        if pos + 8 > len(data):
            raise CorruptImage(f"{path}: truncated PNG file")
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if not _CHUNK_TYPE.fullmatch(tag):
            raise CorruptImage(f"{path}: broken PNG file (chunk {tag!r})")
        if first and (tag != b"IHDR" or length < 13):
            raise CorruptImage(f"{path}: PNG without a leading IHDR chunk")
        first = False
        if tag == b"IEND":
            return
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) < length or len(crc) < 4:
            raise CorruptImage(f"{path}: truncated PNG file (chunk {tag!r})")
        if zlib.crc32(tag + body) & 0xFFFFFFFF != struct.unpack(">I", crc)[0]:
            raise CorruptImage(f"{path}: broken PNG file (bad checksum in {tag!r})")
        pos += 12 + length


def _verify_jpeg(data: bytes, path) -> None:
    if data[:3] != b"\xff\xd8\xff":
        raise CorruptImage(f"{path}: not a JPEG file")
    pos, frame = 2, False
    while True:
        while pos < len(data) and data[pos] != 0xFF:  # junk between segments
            pos += 1
        while pos < len(data) and data[pos] == 0xFF:  # fill bytes
            pos += 1
        if pos >= len(data):
            raise CorruptImage(f"{path}: JPEG ends before its start of scan")
        m = data[pos]
        pos += 1
        if m == 0xD8 or 0xD0 <= m <= 0xD7 or m == 0x00:  # markers without a length
            continue
        if m < 0xC0:
            raise CorruptImage(f"{path}: no JPEG marker at byte {pos - 1}")
        if pos + 2 > len(data):
            raise CorruptImage(f"{path}: truncated JPEG marker segment")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        if length < 2 or pos + length > len(data):
            raise CorruptImage(f"{path}: truncated JPEG marker segment {m:#04x}")
        if m in _SOF_MARKERS:
            if length < 8 or data[pos + 7] not in (1, 3, 4):
                raise CorruptImage(f"{path}: JPEG frame header of an unsupported layout")
            frame = True
        if m == 0xDA:  # start of scan
            if not frame:
                raise CorruptImage(f"{path}: JPEG scan without a frame header")
            return
        pos += length


def read_rgb(path) -> np.ndarray:
    """(H, W, 3) uint8 RGB, as PIL's convert("RGB") gives it (alpha dropped,
    gray replicated)."""
    kind = sniff(path)
    if kind in ("png", "jpeg"):
        img = read_png(path) if kind == "png" else read_jpeg(path)
        if img.shape[2] == 1:
            return np.repeat(img, 3, axis=2)
        return np.ascontiguousarray(img[:, :, :3])
    with _pil_open(path) as im:
        return np.asarray(im.convert("RGB"))


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos < len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        yield tag, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IEND":
            return


def read_png(path) -> np.ndarray:
    """(H, W, C) uint8 pixels of an 8-bit PNG: C = 1 (gray), 3 (RGB) or 4 (RGBA)."""
    data = Path(path).read_bytes()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    ihdr, idat = None, []
    for tag, body in _chunks(data):
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if depth != 8 or ctype not in _PNG_CHANNELS or comp or filt or interlace:
        raise ValueError(f"{path}: PNG with bit depth {depth}, colour type {ctype}, interlace {interlace}: "
                         "only 8-bit, non-interlaced gray/RGB/RGBA PNGs are read here")
    bpp = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * bpp)
    return _unfilter(raw[:, 0], raw[:, 1:], bpp).reshape(h, w, bpp)


def _unfilter(kinds: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undoes the per-scanline filters (PNG spec, section 9): None and Sub
    (a running sum per channel, mod 256) read only their own row, so all
    such rows are undone at once; Up is elementwise on the row above;
    Average and Paeth depend on the reconstructed left neighbour, so they
    walk the row."""
    n = rows.shape[1]
    if np.any(kinds > 4):
        raise ValueError(f"PNG scanline filter {int(kinds.max())} is not defined")
    out = rows.copy()
    sub = kinds == 1
    if sub.any():
        out[sub] = np.cumsum(rows[sub].reshape(int(sub.sum()), -1, bpp), axis=1, dtype=np.uint8).reshape(-1, n)
    for y in np.flatnonzero(kinds >= 2):  # in order: each reads the finished row above
        prior = out[y - 1] if y else np.zeros(n, np.uint8)
        out[y] = rows[y] + prior if kinds[y] == 2 else _walk(rows[y], prior, bpp, int(kinds[y]))
    return out


def _walk(line: np.ndarray, prior: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    cur = line.astype(np.int64).tolist()
    up = prior.astype(np.int64).tolist()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            cur[i] = (cur[i] + pred) & 0xFF
    return np.asarray(cur, np.uint8)


def write_png(path, img: np.ndarray) -> None:
    """Writes an (H, W), (H, W, 1) or (H, W, 3) uint8 array as an 8-bit gray
    or RGB PNG, every scanline with the Sub filter."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    if img.ndim == 2:
        ctype, bpp = 0, 1
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype, bpp = 2, 3
    else:
        raise ValueError(f"write_png takes gray or RGB, got shape {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, w * bpp)
    sub = rows.copy()
    sub[:, bpp:] = rows[:, bpp:] - rows[:, :-bpp]  # uint8 arithmetic wraps mod 256
    raw = np.concatenate([np.ones((h, 1), np.uint8), sub], axis=1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    data = PNG_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) \
        + chunk(b"IEND", b"")
    tmp = Path(f"{path}.tmp")
    tmp.write_bytes(data)
    tmp.replace(path)
