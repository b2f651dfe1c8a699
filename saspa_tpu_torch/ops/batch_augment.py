"""WS-DAN attention crop and attention drop (counterpart of
saspa_tpu/ops/batch_augment.py), on NCHW batches on any device.

Numerical contract, as the JAX package's (itself the executed reference's,
fgvc/util.py:209-249):
  * thresholds scale the RAW attention map's max, not the upsampled one;
  * the CROP MASK comes from a half-pixel (align_corners=False) bilinear
    upsample, `>=` theta * max; the upsample is jax.image.resize's: one
    weight matrix a spatial dimension, rows then columns;
  * the CROP RESIZE and the DROP MASK use the align-corners grid
    lo + i * (length - 1) / (out - 1) and an edge-clamped bilinear gather;
    the drop mask is `<` theta * max;
  * bbox bounds are trunc(min nonzero index - pad * H) and
    trunc(max nonzero index + pad * H), clamped to [0, H], the max used as
    an exclusive end (the align-corners span is max - min).
The grid and the gather's lerps run as XLA's CPU code runs them (a
division by a constant as a product with its reciprocal; `a * (1 - w) +
b * w` with the first product fused into the add, done in f64 and rounded
once), so on the CPU the views equal the JAX package's.  Everything runs under
no_grad: the step uses the views as data.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple, Union

import numpy as np
import torch

from saspa_tpu_torch import to_device
from saspa_tpu_torch.models.layers import acc_dtype
from saspa_tpu_torch.ops.augment import fma
from saspa_tpu_torch.ops.image import jax_resize_weights
from saspa_tpu_torch.utils import rng as rngs


@lru_cache(maxsize=32)
def _halfpixel_weights_on(n_in: int, n_out: int, f, device: torch.device) -> torch.Tensor:
    """jax.image.resize's linear weight matrix on `device`, uploaded once a shape."""
    return to_device(jax_resize_weights(n_in, n_out, "linear", f).copy(), device)


def upsample_halfpixel(attn: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, ah, aw) -> (B, h, w): F.interpolate(bilinear, align_corners=False)
    as jax.image.resize(method="linear") computes it."""
    f = np.float64 if attn.dtype == torch.float64 else np.float32
    wy = _halfpixel_weights_on(attn.shape[1], h, f, attn.device)
    wx = _halfpixel_weights_on(attn.shape[2], w, f, attn.device)
    return torch.einsum("bjk,jh->bhk", attn, wy) @ wx


def _lerp(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a * (1 - w) + b * w with the first product fused into the add."""
    return fma(a, 1 - w, b * w)


def gather_bilinear(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """img (..., H, W) sampled at the (ys x xs) grid, edge-clamped:
    (..., len(ys), len(xs))."""
    h, w = img.shape[-2], img.shape[-1]
    y0 = torch.floor(ys).clamp(0, h - 1)
    x0 = torch.floor(xs).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wy = (ys - y0).clamp(0.0, 1.0)
    wx = (xs - x0).clamp(0.0, 1.0)
    y0i, y1i, x0i, x1i = (t.long() for t in (y0, y1, x0, x1))
    rows0, rows1 = img.index_select(-2, y0i), img.index_select(-2, y1i)
    top = _lerp(rows0.index_select(-1, x0i), rows0.index_select(-1, x1i), wx)
    bot = _lerp(rows1.index_select(-1, x0i), rows1.index_select(-1, x1i), wx)
    return _lerp(top, bot, wy[:, None])


def align_corners_grid(lo: torch.Tensor, length: torch.Tensor, out: int) -> torch.Tensor:
    """Sample positions of F.upsample_bilinear (align_corners=True) mapping
    the span [lo, lo + length) onto `out` points: lo + i * (length - 1) /
    (out - 1), as XLA computes it (the division a product with the f32
    reciprocal, fused with the add of lo)."""
    dt = lo.dtype
    i = torch.arange(out, dtype=dt, device=lo.device)
    recip = float(np.float32(1) / np.float32(max(out - 1, 1))) if dt == torch.float32 else 1.0 / max(out - 1, 1)
    return ((i * (length - 1.0)).double() * recip + lo.double()).to(dt)


def bbox_from_mask(mask: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """mask (B, H, W) bool -> (ymin, ymax, xmin, xmax), each (B,) int64:
    the min and max nonzero indices (a mask is never empty: the max pixel
    passes theta <= 1)."""
    b, h, w = mask.shape
    rows, cols = mask.any(dim=2), mask.any(dim=1)
    ridx = torch.arange(h, device=mask.device).expand(b, h)
    cidx = torch.arange(w, device=mask.device).expand(b, w)
    ymin = torch.where(rows, ridx, h).amin(dim=1)
    ymax = torch.where(rows, ridx, -1).amax(dim=1)
    xmin = torch.where(cols, cidx, w).amin(dim=1)
    xmax = torch.where(cols, cidx, -1).amax(dim=1)
    return ymin, ymax, xmin, xmax


def crop_boxes(attention_map: torch.Tensor, thetas: torch.Tensor, h: int, w: int,
               padding_ratio: float) -> torch.Tensor:
    """(B, 4) [ymin, ymax, xmin, xmax] of the attention crop, in the map's
    dtype; thetas already scaled by each map's max."""
    up = upsample_halfpixel(attention_map, h, w)
    ymin, ymax, xmin, xmax = (t.to(attention_map.dtype) for t in bbox_from_mask(up >= thetas[:, None, None]))
    ymin = torch.trunc(ymin - padding_ratio * h).clamp_min(0.0)
    ymax = torch.trunc(ymax + padding_ratio * h).clamp_max(float(h))
    xmin = torch.trunc(xmin - padding_ratio * w).clamp_min(0.0)
    xmax = torch.trunc(xmax + padding_ratio * w).clamp_max(float(w))
    return torch.stack([ymin, ymax, xmin, xmax], dim=1)


def draw_thetas(key, theta: Union[float, Tuple[float, float]], batch: int) -> np.ndarray:
    """The per-sample theta draw: jax.random.uniform(key, (B,), lo, hi), or
    the constant."""
    if isinstance(theta, tuple):
        return rngs.uniform_f32(key, (batch,), *theta)
    return np.full((batch,), theta, np.float32)


@torch.no_grad()
def batch_augment(images: torch.Tensor, attention_map: torch.Tensor, key=None, mode: str = "crop",
                  theta: Union[float, Tuple[float, float]] = 0.5, padding_ratio: float = 0.1,
                  thetas: Optional[torch.Tensor] = None, rows: Optional[rngs.Rows] = None) -> torch.Tensor:
    """Attention-guided crop or drop of NCHW `images` by one (ah, aw) map a
    sample.  Train draws theta per sample from `key` (a numpy threefry key,
    as jax's), for the whole batch of which `rows` are part when given;
    `thetas` (B,) overrides the draw.  Computes in f32 (f64
    for an f64 map, as jax with x64)."""
    b, _, h, w = images.shape
    attn = acc_dtype(attention_map)
    amax = attn.amax(dim=(1, 2))
    if thetas is None:
        thetas = to_device(rngs.take_rows(draw_thetas(key, theta, rngs.draw_size(rows, b)), rows), attn.device)
    thetas = thetas.to(device=attn.device, dtype=attn.dtype) * amax

    if mode == "crop":
        boxes = crop_boxes(attn, thetas, h, w, padding_ratio)
        img = images.to(attn.dtype)
        out = torch.empty_like(img)
        for i in range(b):  # a box a sample; each crop resizes back to (h, w)
            ymin, ymax, xmin, xmax = boxes[i]
            ys = align_corners_grid(ymin, ymax - ymin, h)
            xs = align_corners_grid(xmin, xmax - xmin, w)
            out[i] = gather_bilinear(img[i], ys, xs)
        return out.to(images.dtype)

    if mode == "drop":
        ah, aw = attn.shape[1], attn.shape[2]
        zero = torch.zeros((), dtype=attn.dtype, device=attn.device)
        ys = align_corners_grid(zero, torch.full((), float(ah), dtype=attn.dtype, device=attn.device), h)
        xs = align_corners_grid(zero, torch.full((), float(aw), dtype=attn.dtype, device=attn.device), w)
        up = gather_bilinear(attn, ys, xs)
        masks = (up < thetas[:, None, None]).to(images.dtype)
        return images * masks[:, None]

    raise ValueError(f"mode must be 'crop' or 'drop', got {mode!r}")
