"""Train and val image transforms on the device (counterpart of the
preset pipelines of saspa_tpu/ops/augment.py).

The host loader only decodes and resizes to the pre-crop size (size /
0.875); the batch goes up as uint8 and everything stochastic runs here over
the whole batch, its draws made on the host from the batch's threefry key
exactly as jax.random makes them (utils/rng.py):
  classic          random crop + hflip + ColorJitter(brightness=0.126, saturation=0.5)
  classic_no_color random crop + hflip
  None             center crop only
All end with /255 and the ImageNet normalize, and return NCHW float32.
The elementwise arithmetic follows XLA's CPU code (its fused multiply-adds
done in f64 and rounded once; a division by a constant as a product with
its reciprocal), so on the CPU the batches equal the JAX package's.
RandAugment, AutoAugment and CutMix are not ported (ROADMAP Queue 1 item
11) and raise.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from saspa_tpu_torch import to_device
from saspa_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD
from saspa_tpu_torch.utils import rng as rngs

PRESETS = (None, "classic", "classic_no_color")
NOT_PORTED = ("randaug", "autoaug")


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1 item 11: RandAugment, AutoAugment "
                               "and CutMix, whose mixing draws from jax.random.beta)")


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c in a's dtype with one rounding (exact for f32: the product
    and sum are done in f64), as XLA's CPU code fuses a multiply into an add."""
    return (a.double() * torch.as_tensor(b).double() + torch.as_tensor(c).double()).to(a.dtype)


def random_crop_batch(imgs: torch.Tensor, key, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, H, W, C) -> (B, th, tw, C), one random offset a sample."""
    b, h, w, _ = imgs.shape
    th, tw = out_hw
    ky, kx = rngs.split(key, 2)
    oy = rngs.randint(ky, (b,), 0, h - th + 1)
    ox = rngs.randint(kx, (b,), 0, w - tw + 1)
    return torch.stack([imgs[i, oy[i]:oy[i] + th, ox[i]:ox[i] + tw] for i in range(b)])


def center_crop_batch(imgs: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    _, h, w, _ = imgs.shape
    th, tw = out_hw
    y0, x0 = (h - th) // 2, (w - tw) // 2
    return imgs[:, y0:y0 + th, x0:x0 + tw]


def hflip_batch(imgs: torch.Tensor, key, p: float = 0.5) -> torch.Tensor:
    flip = to_device(rngs.bernoulli(key, p, (imgs.shape[0],)), imgs.device)
    return torch.where(flip[:, None, None, None], imgs.flip(2), imgs)


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return fma(b, 0.114, fma(r, 0.299, g * np.float32(0.587)))[..., None]


def adjust_brightness(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return (img * factor).clamp(0.0, 1.0)


def adjust_saturation(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    g = _grayscale(img)
    return fma(factor, img - g, g).clamp(0.0, 1.0)


def color_jitter_batch(imgs: torch.Tensor, key, brightness: float = 0.126, saturation: float = 0.5) -> torch.Tensor:
    """torchvision ColorJitter(brightness=0.126, saturation=0.5)
    (fgvc/util.py:296), with the op order drawn per sample."""
    b = imgs.shape[0]
    kb, ks, ko = rngs.split(key, 3)
    dev = imgs.device
    bf = to_device(rngs.uniform_f32(kb, (b, 1, 1, 1), 1 - brightness, 1 + brightness), dev)
    sf = to_device(rngs.uniform_f32(ks, (b, 1, 1, 1), 1 - saturation, 1 + saturation), dev)
    bright_first = to_device(rngs.bernoulli(ko, 0.5, (b, 1, 1, 1)), dev)
    return torch.where(bright_first, adjust_saturation(adjust_brightness(imgs, bf), sf),
                       adjust_brightness(adjust_saturation(imgs, sf), bf))


_INV_255 = float(np.float32(1) / np.float32(255))


@lru_cache(maxsize=8)
def _normalize_consts(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ImageNet mean, 1 / std) on `device`, uploaded once."""
    return to_device(IMAGENET_MEAN, device), to_device(np.float32(1) / IMAGENET_STD, device)


def _finalize(imgs: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std over NHWC float -> NCHW float32, contiguous."""
    mean, inv_std = _normalize_consts(imgs.device)
    return ((imgs - mean) * inv_std).permute(0, 3, 1, 2).contiguous()


def _finalize_u8(imgs_u8: torch.Tensor) -> torch.Tensor:
    """uint8 / 255 straight into the normalize: XLA fuses the scale and the
    mean's subtraction into one multiply-add."""
    mean, inv_std = _normalize_consts(imgs_u8.device)
    return (fma(imgs_u8.float(), _INV_255, -mean) * inv_std).permute(0, 3, 1, 2).contiguous()


def train_transform_batch(imgs_u8: torch.Tensor, key, preset: Optional[str], out_h: int, out_w: int) -> torch.Tensor:
    """uint8 (B, H, W, C), already resized to size / 0.875 by the host ->
    normalized float32 (B, C, out_h, out_w)."""
    if preset in NOT_PORTED:
        raise _not_ported(f"--special_aug {preset}")
    if preset not in PRESETS:
        raise ValueError(f"unknown train transform preset {preset!r}")
    kc, kf, kj = rngs.split(key, 3)
    if preset is None:
        return val_transform_batch(imgs_u8, out_h, out_w)
    x = hflip_batch(random_crop_batch(imgs_u8, kc, (out_h, out_w)), kf)  # the flip commutes with the scale
    if preset == "classic_no_color":
        return _finalize_u8(x)
    return _finalize(color_jitter_batch(x.float() * _INV_255, kj))


def val_transform_batch(imgs_u8: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    return _finalize_u8(center_crop_batch(imgs_u8, (out_h, out_w)))
