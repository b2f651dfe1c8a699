"""Image geometry and resizing on the host (counterpart of saspa_tpu/ops/image.py).

`resize_shape_multiple_of_64` reproduces the reference's aspect-preserving
resize-to-multiple-of-64 geometry (all_utils/utils.py:58-79), an artifact
contract: the `_source.png` files and the ControlNet conditioning images are
made at these sizes.  The JAX package resamples with cv2 (INTER_LANCZOS4 to
upscale, INTER_AREA to downscale); the machine with the card has no cv2, so
this module implements cv2's uint8 arithmetic of both in numpy:
  * INTER_LANCZOS4: 8-tap separable filter, float32 coefficients
    (interpolateLanczos4) rounded to fixed point at scale 2048, integer
    horizontal then vertical passes, (v + 2^21) >> 22, edge replication;
  * INTER_AREA, both scales >= 1 and integral: block means (2x2:
    (sum + 2) >> 2; otherwise round(sum * float32(1 / area)));
  * INTER_AREA, both scales >= 1: cv2's float32 area-weight tables
    (computeResizeAreaTab) accumulated in cv2's order, then rounded;
  * INTER_AREA otherwise (an upscale after the 1.2 MP cap): cv2's emulation
    by a fixed-point bilinear filter with area-mode offsets.
tests/test_torch_image.py holds each against cv2.  `pil_resize` is
Pillow's 8-bit resample, and `jax_resize_weights` the weight matrices of
jax.image.resize (triangle and Keys cubic kernels).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np

MAX_RES_SIZE = 1_200_000  # 1200*1000 pixel cap (all_utils/utils.py:65)
COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS  # cv2's INTER_RESIZE_COEF_SCALE


def HWC3(x: np.ndarray) -> np.ndarray:
    """Grayscale/RGBA -> RGB uint8 (all_utils/utils.py:39-55 semantics)."""
    assert x.dtype == np.uint8
    if x.ndim == 2:
        x = x[:, :, None]
    assert x.ndim == 3
    _, _, c = x.shape
    assert c in (1, 3, 4)
    if c == 3:
        return x
    if c == 1:
        return np.concatenate([x, x, x], axis=2)
    color = x[:, :, 0:3].astype(np.float32)
    alpha = x[:, :, 3:4].astype(np.float32) / 255.0
    y = color * alpha + 255.0 * (1.0 - alpha)
    return y.clip(0, 255).astype(np.uint8)


def resize_shape_multiple_of_64(h: int, w: int, smaller_side_res: int) -> Tuple[int, int, float]:
    """Target (H, W) after the reference's geometry; also returns the scale k.

    Steps: scale so min side == smaller_side_res; if area > 1.2MP rescale down;
    round each side to the nearest multiple of 64.
    """
    H, W = float(h), float(w)
    k = float(smaller_side_res) / min(H, W)
    H *= k
    W *= k
    if H * W > MAX_RES_SIZE:
        k2 = np.sqrt(MAX_RES_SIZE / (H * W))
        H *= k2
        W *= k2
        k *= k2
    H = int(np.round(H / 64.0)) * 64
    W = int(np.round(W / 64.0)) * 64
    return H, W, k


def k0_scale(h: int, w: int, smaller_side_res: int) -> float:
    """The PRE-cap scale factor (reference's first k, all_utils/utils.py:68)."""
    return float(smaller_side_res) / min(float(h), float(w))


def resize_image(img: np.ndarray, smaller_side_res: int) -> np.ndarray:
    """Single-image resize with the reference geometry; uint8 in/out.  Same
    interpolation choice as the JAX package, including the reference's k
    rebinding quirk (all_utils/utils.py:71-77): when the 1.2 MP cap fires, k
    is overwritten by the (always < 1) cap factor, so capped UPSCALES use
    INTER_AREA too.  Identity geometry returns the image as is."""
    h, w = img.shape[:2]
    out_h, out_w, k = resize_shape_multiple_of_64(h, w, smaller_side_res)
    x = HWC3(np.asarray(img, np.uint8))
    if (out_h, out_w) == (h, w):
        return x
    k0 = k0_scale(h, w, smaller_side_res)
    capped = (float(h) * k0) * (float(w) * k0) > MAX_RES_SIZE
    if not capped and k > 1:
        return resize_lanczos4(x, out_h, out_w)
    return resize_area(x, out_h, out_w)


# ---- INTER_LANCZOS4 ------------------------------------------------------------

_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0), (_S45, _S45), (0, -1), (-_S45, _S45))


def _lanczos4_coeffs(fx: float) -> np.ndarray:
    """cv2's interpolateLanczos4(fx) (float32 weights summing to 1), as
    fixed-point int16 taps."""
    f = np.float32
    x = f(fx)
    y0 = -float(x + f(3)) * math.pi * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    coeffs = np.empty(8, np.float32)
    total = f(0)
    for i in range(8):
        t = x + f(3) - f(i)  # float arithmetic, as in cv2
        if abs(t) >= f(1e-6):
            y = -float(t) * math.pi * 0.25
            coeffs[i] = f((_LANCZOS_CS[i][0] * s0 + _LANCZOS_CS[i][1] * c0) / (y * y))
        else:
            coeffs[i] = f(1e30)
        total = f(total + coeffs[i])
    total = f(1) / total
    coeffs = (coeffs * total).astype(np.float32)
    return _fixed(coeffs * f(COEF_SCALE))


def _fixed(v) -> np.ndarray:
    """saturate_cast<short>(float): round half to even, then clip."""
    return np.clip(np.rint(np.asarray(v, np.float32)), -32768, 32767).astype(np.int64)


def _taps(n_in: int, n_out: int, ksize: int, coeffs):
    """Source indices (n_out, ksize), clamped to the image (cv2 replicates
    the border), and fixed-point weights, for one axis."""
    scale = 1.0 / (n_out / n_in)
    idx = np.empty((n_out, ksize), np.int64)
    w = np.empty((n_out, ksize), np.int64)
    for d in range(n_out):
        f = np.float32((d + 0.5) * scale - 0.5)
        s = math.floor(f)
        w[d] = coeffs(float(f - np.float32(s)))
        idx[d] = np.arange(s - ksize // 2 + 1, s + ksize // 2 + 1)
    return np.clip(idx, 0, n_in - 1), w


def resize_lanczos4(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.resize(x, (out_w, out_h), interpolation=cv2.INTER_LANCZOS4) on
    uint8 (H, W, C)."""
    h, w = x.shape[:2]
    xi, xw = _taps(w, out_w, 8, _lanczos4_coeffs)
    yi, yw = _taps(h, out_h, 8, _lanczos4_coeffs)
    src = x.astype(np.int64)
    rows = np.zeros((h, out_w, x.shape[2]), np.int64)
    for j in range(8):
        rows += src[:, xi[:, j]] * xw[:, j, None]
    out = np.zeros((out_h, out_w, x.shape[2]), np.int64)
    for j in range(8):
        out += rows[yi[:, j]] * yw[:, j, None, None]
    return np.clip((out + (1 << (2 * COEF_BITS - 1))) >> (2 * COEF_BITS), 0, 255).astype(np.uint8)


# ---- INTER_AREA ----------------------------------------------------------------

def resize_area(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.resize(x, (out_w, out_h), interpolation=cv2.INTER_AREA) on uint8
    (H, W, C)."""
    h, w = x.shape[:2]
    sx, sy = 1.0 / (out_w / w), 1.0 / (out_h / h)
    if sx >= 1 and sy >= 1:
        ix, iy = int(round(sx)), int(round(sy))
        if abs(sx - ix) < np.finfo(np.float64).eps and abs(sy - iy) < np.finfo(np.float64).eps:
            return _area_fast(x, ix, iy, out_h, out_w)
        return _area_tables(x, sx, sy, out_h, out_w)
    return _area_linear(x, out_h, out_w)


def _area_fast(x, ix: int, iy: int, out_h: int, out_w: int) -> np.ndarray:
    """Integral scales: the mean of each ix-by-iy block."""
    blocks = x[:out_h * iy, :out_w * ix].astype(np.int64).reshape(out_h, iy, out_w, ix, x.shape[2])
    s = blocks.sum(axis=(1, 3))
    if ix == 2 and iy == 2:
        return ((s + 2) >> 2).astype(np.uint8)
    v = s.astype(np.float32) * (np.float32(1) / np.float32(ix * iy))
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def _area_tab(n_in: int, n_out: int, scale: float):
    """cv2's computeResizeAreaTab as (n_out, slots) source indices and
    float32 weights (weight 0 pads the unused slots), in cv2's order."""
    entries = []
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, n_in - 1)
        s1 = min(s1, s2)
        e = []
        if s1 - f1 > 1e-3:
            e.append((s1 - 1, np.float32((s1 - f1) / cell)))
        for s in range(s1, s2):
            e.append((s, np.float32(1.0 / cell)))
        if f2 - s2 > 1e-3:
            e.append((s2, np.float32(min(min(f2 - s2, 1.0), cell) / cell)))
        entries.append(e)
    slots = max(len(e) for e in entries)
    idx = np.zeros((n_out, slots), np.int64)
    wt = np.zeros((n_out, slots), np.float32)
    for d, e in enumerate(entries):
        for j, (s, a) in enumerate(e):
            idx[d, j], wt[d, j] = s, a
    return idx, wt


def _area_tables(x, sx: float, sy: float, out_h: int, out_w: int) -> np.ndarray:
    """Both scales >= 1, not integral: float32 sums of area-weighted pixels,
    each output element's terms added in cv2's order (an added zero leaves a
    sum unchanged, so the padded slots do nothing)."""
    h, w = x.shape[:2]
    xi, xw = _area_tab(w, out_w, sx)
    yi, yw = _area_tab(h, out_h, sy)
    src = x.astype(np.float32)
    buf = np.zeros((h, out_w, x.shape[2]), np.float32)
    for j in range(xi.shape[1]):
        buf = buf + src[:, xi[:, j]] * xw[:, j, None]
    acc = np.zeros((out_h, out_w, x.shape[2]), np.float32)
    for j in range(yi.shape[1]):
        acc = acc + yw[:, j, None, None] * buf[yi[:, j]]
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


def _area_linear_taps(n_in: int, n_out: int, horizontal: bool):
    """Area-mode bilinear taps of one axis: (n_out, 2) clamped source
    indices and fixed-point weights.  cv2 pins the last source column (not
    row) with weight 1 where its right neighbour falls off the image."""
    scale, inv = 1.0 / (n_out / n_in), n_out / n_in
    idx = np.empty((n_out, 2), np.int64)
    w = np.empty((n_out, 2), np.int64)
    for d in range(n_out):
        s = math.floor(d * scale)
        fx = float(np.float32((d + 1) - (s + 1) * inv))
        fx = 0.0 if fx <= 0 else fx - math.floor(fx)
        if horizontal and s >= n_in - 1:
            fx, s = 0.0, n_in - 1
        f = np.float32(fx)
        w[d] = _fixed(np.array([np.float32(1) - f, f], np.float32) * np.float32(COEF_SCALE))
        idx[d] = (s, min(s + 1, n_in - 1))
    return idx, w


def _area_linear(x, out_h: int, out_w: int) -> np.ndarray:
    """An upscale in an axis: cv2 emulates INTER_AREA with its fixed-point
    bilinear filter; the vertical pass rounds as cv2's 8-bit kernel does:
    ((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16), + 2, >> 2."""
    h, w = x.shape[:2]
    xi, xw = _area_linear_taps(w, out_w, True)
    yi, yw = _area_linear_taps(h, out_h, False)
    src = x.astype(np.int64)
    rows = src[:, xi[:, 0]] * xw[:, 0, None] + src[:, xi[:, 1]] * xw[:, 1, None]
    r0, r1 = rows[yi[:, 0]] >> 4, rows[yi[:, 1]] >> 4
    out = ((yw[:, 0, None, None] * r0) >> 16) + ((yw[:, 1, None, None] * r1) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


# ---- Pillow's resample (the filter stage) ----------------------------------------

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
PIL_PRECISION_BITS = 32 - 8 - 2  # libImaging/Resample.c


def _pil_bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _pil_bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


_PIL_FILTERS = {"bicubic": (_pil_bicubic, 2.0), "bilinear": (_pil_bilinear, 1.0)}


@functools.lru_cache(maxsize=64)
def _pil_coeffs(in_size: int, out_size: int, method: str):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for one axis over
    the whole image: (xmin (out,), tap indices (out, ksize), int32 weights
    (out, ksize), rows of the input the taps reach (first, last))."""
    filt, filter_support = _PIL_FILTERS[method]
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    ss = 1.0 / filterscale
    taps = np.arange(ksize)
    w = np.where(taps[None] < xmax[:, None], filt(((taps[None] + xmin[:, None]) - center[:, None] + 0.5) * ss), 0.0)
    ww = np.zeros(out_size)
    for t in range(ksize):  # Pillow's summation order
        ww += w[:, t]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = w * (1 << PIL_PRECISION_BITS)
    fixed = np.trunc(np.where(w < 0, fixed - 0.5, fixed + 0.5)).astype(np.int32)
    idx = xmin[:, None] + np.minimum(taps[None], xmax[:, None] - 1)  # zero-weight taps stay in range
    for a in (xmin, idx, fixed):
        a.setflags(write=False)
    return xmin, idx, fixed, (int(xmin[0]), int(xmin[-1] + xmax[-1]))


def _pil_pass(x: np.ndarray, idx: np.ndarray, w: np.ndarray) -> np.ndarray:
    """One 8-bit pass along axis 0 (whole rows gathered at a time): sum of
    taps in int32 from the 1 << 21 rounding term, then clip8 (>> 22 into
    [0, 255])."""
    shape = (idx.shape[0],) + x.shape[1:]
    acc = np.full(shape, 1 << (PIL_PRECISION_BITS - 1), np.int32)
    tap = np.empty(shape, np.int32)
    wshape = (idx.shape[0],) + (1,) * (x.ndim - 1)
    for t in range(idx.shape[1]):
        np.take(x, idx[:, t], axis=0, out=tap)
        tap *= w[:, t].reshape(wshape)
        acc += tap
    acc >>= PIL_PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8)


def pil_resize(img: np.ndarray, size: Tuple[int, int], method: str = "bicubic") -> np.ndarray:
    """`np.asarray(Image.fromarray(img).resize(size, BICUBIC | BILINEAR))`
    on uint8 (H, W, C) or (H, W): Pillow's 8-bit two-pass resample
    (libImaging/Resample.c, reducing_gap=None).  The filter's support widens
    by the scale when downscaling; coefficients are normalised, then put in
    fixed point with 22 fraction bits, rounded away from zero; the
    horizontal pass runs first over the rows the vertical pass reads, each
    pass rounds and clips to uint8.  `size` is (width, height), as PIL's."""
    out_w, out_h = size
    h, w = img.shape[:2]
    x = img
    if (out_w, out_h) == (w, h):
        return img.copy()
    if out_h != h:
        ymin, yidx, yw, (y0, y1) = _pil_coeffs(h, out_h, method)
    else:
        y0, y1 = 0, h
    if out_w != w:  # on the transposed rows, so that the taps gather whole rows
        _, xidx, xw, _ = _pil_coeffs(w, out_w, method)
        x = _pil_pass(np.ascontiguousarray(np.swapaxes(x[y0:y1], 0, 1), dtype=np.int32), xidx, xw)
        x = np.ascontiguousarray(np.swapaxes(x, 0, 1))
    else:
        x = x[y0:y1]
    if out_h != h:
        x = _pil_pass(x.astype(np.int32), yidx - y0, yw)
    return x


def _fma(a, b, c, f):
    """a * b + c rounded once to f (computed in long double: exact products
    of float32 operands)."""
    w = np.longdouble
    return (np.asarray(a, f).astype(w) * np.asarray(b, f).astype(w) + np.asarray(c, f).astype(w)).astype(f)


def _keys_cubic(x: np.ndarray, f) -> np.ndarray:
    """jax.image's Keys cubic kernel (a = -0.5), in x's dtype, with the
    multiply-adds fused as XLA compiles them on the CPU."""
    near = _fma(_fma(f(1.5), x, f(-2.5), f) * x, x, f(1.0), f)
    far = _fma(_fma(_fma(f(-0.5), x, f(2.5), f), x, f(-4.0), f), x, f(2.0), f)
    return np.where(x >= 2.0, f(0.0), np.where(x >= 1.0, far, near))


_JAX_KERNELS = {"linear": lambda x, f: np.maximum(f(0), f(1) - x), "cubic": _keys_cubic}


@functools.lru_cache(maxsize=32)
def jax_resize_weights(n_in: int, n_out: int, method: str = "linear", f=np.float32) -> np.ndarray:
    """jax.image.resize's (n_in, n_out) weight matrix for one spatial
    dimension (`compute_weight_mat`): scale n_out / n_in, no translation,
    antialiased (the kernel widens by the scale when downscaling), columns
    normalised, samples outside the input zeroed; in float32 (float64 where
    jax runs with x64).  The sample positions (i + 0.5) * inv_scale - 0.5
    are one fused multiply-add, rounded once, as XLA compiles them on the
    CPU (near a position of 150 the separately rounded product moves a
    weight by 1e-5).  Read-only: the cache hands it to every caller."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = f(max(inv_scale, 1.0))
    sample_f = _fma(np.arange(n_out, dtype=f) + f(0.5), f(inv_scale), f(-0.5), f)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f)[:, None]) / kernel_scale
    w = _JAX_KERNELS[method](x, f)
    total = w.sum(axis=0, keepdims=True, dtype=f)
    w = np.where(np.abs(total) > f(1000.0 * np.finfo(np.float32).eps), w / np.where(total != 0, total, f(1)), f(0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = np.where(inside[None, :], w, f(0)).astype(f)
    w.setflags(write=False)
    return w
