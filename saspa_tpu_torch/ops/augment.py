"""Train and val image transforms on the device (counterpart of the
preset pipelines and CutMix of saspa_tpu/ops/augment.py).

The host loader only decodes and resizes to the pre-crop size (size /
0.875); the batch goes up as uint8 and everything stochastic runs here over
the whole batch, its draws made on the host from the batch's threefry key
exactly as jax.random makes them (utils/rng.py):
  classic          random crop + hflip + ColorJitter(brightness=0.126, saturation=0.5)
  classic_no_color random crop + hflip
  randaug          random crop + RandAugment(N=2, M=9)
  autoaug          random crop + AutoAugment (the 25 ImageNet sub-policies)
  None             center crop only
All end with /255 and the ImageNet normalize, and return NCHW float32.
`cutmix_batch` mixes the normalized batch and gives its soft labels.
The elementwise arithmetic follows XLA's CPU code (its fused multiply-adds
done in f64 and rounded once; a division by a constant as a product with
its reciprocal), so on the CPU the batches equal the JAX package's or lie
within the bounds tests/test_torch_train_recipes.py states.

JAX draws RandAugment's and AutoAugment's op per sample under vmap and
lax.switch, which computes every op for every sample.  Here the op indices,
signs and coins are drawn on the host, so each op runs once over the
samples that drew it, gathered and put back by host-known indices: the
card never waits for a draw, and nothing synchronizes the stream.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from saspa_tpu_torch import to_device
from saspa_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD
from saspa_tpu_torch.utils import rng as rngs

PRESETS = (None, "classic", "classic_no_color", "randaug", "autoaug")


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c in a's dtype with one rounding (exact for f32: the product
    and sum are done in f64), as XLA's CPU code fuses a multiply into an add."""
    return (a.double() * torch.as_tensor(b).double() + torch.as_tensor(c).double()).to(a.dtype)


def random_crop_batch(imgs: torch.Tensor, key, out_hw: Tuple[int, int], rows: Optional[rngs.Rows] = None) -> torch.Tensor:
    """(B, H, W, C) -> (B, th, tw, C), one random offset a sample.  `rows`:
    imgs are those rows of a larger batch, whose draws they take (here and
    in every transform below)."""
    b, h, w, _ = imgs.shape
    th, tw = out_hw
    n = rngs.draw_size(rows, b)
    ky, kx = rngs.split(key, 2)
    oy = rngs.take_rows(rngs.randint(ky, (n,), 0, h - th + 1), rows)
    ox = rngs.take_rows(rngs.randint(kx, (n,), 0, w - tw + 1), rows)
    return torch.stack([imgs[i, oy[i]:oy[i] + th, ox[i]:ox[i] + tw] for i in range(b)])


def center_crop_batch(imgs: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    _, h, w, _ = imgs.shape
    th, tw = out_hw
    y0, x0 = (h - th) // 2, (w - tw) // 2
    return imgs[:, y0:y0 + th, x0:x0 + tw]


def hflip_batch(imgs: torch.Tensor, key, p: float = 0.5, rows: Optional[rngs.Rows] = None) -> torch.Tensor:
    flip = to_device(rngs.take_rows(rngs.bernoulli(key, p, (rngs.draw_size(rows, imgs.shape[0]),)), rows),
                     imgs.device)
    return torch.where(flip[:, None, None, None], imgs.flip(2), imgs)


def _grayscale(img: torch.Tensor) -> torch.Tensor:
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return fma(b, 0.114, fma(r, 0.299, g * np.float32(0.587)))[..., None]


def adjust_brightness(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    return (img * factor).clamp(0.0, 1.0)


def adjust_saturation(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    g = _grayscale(img)
    return fma(factor, img - g, g).clamp(0.0, 1.0)


def color_jitter_batch(imgs: torch.Tensor, key, brightness: float = 0.126, saturation: float = 0.5,
                       rows: Optional[rngs.Rows] = None) -> torch.Tensor:
    """torchvision ColorJitter(brightness=0.126, saturation=0.5)
    (fgvc/util.py:296), with the op order drawn per sample."""
    b = rngs.draw_size(rows, imgs.shape[0])
    kb, ks, ko = rngs.split(key, 3)
    dev = imgs.device

    def up(a):
        return to_device(rngs.take_rows(a, rows), dev)

    bf = up(rngs.uniform_f32(kb, (b, 1, 1, 1), 1 - brightness, 1 + brightness))
    sf = up(rngs.uniform_f32(ks, (b, 1, 1, 1), 1 - saturation, 1 + saturation))
    bright_first = up(rngs.bernoulli(ko, 0.5, (b, 1, 1, 1)))
    return torch.where(bright_first, adjust_saturation(adjust_brightness(imgs, bf), sf),
                       adjust_brightness(adjust_saturation(imgs, sf), bf))


_INV_255 = float(np.float32(1) / np.float32(255))
_F = np.float32


def _per_sample(values: np.ndarray, device) -> torch.Tensor:
    """Host f32 values (n,) as an (n, 1, 1, 1) tensor on `device`."""
    return to_device(np.asarray(values, _F).reshape(-1, 1, 1, 1), device)


# --------------------------------------------------------------------------
# the op table of RandAugment and AutoAugment: float NHWC in [0, 1], each op
# at a signed fraction s of its full torchvision strength (s: host f32 (n,))
# --------------------------------------------------------------------------
SHEAR, ROTATE, ENHANCE = 0.3, 30.0, 0.9


def affine_matrices(op: str, s: np.ndarray, size: int) -> np.ndarray:
    """(n, 2, 3) f32 inverse maps (output (y, x, 1) -> input) of a geometric
    op, as _randaug_ops builds them; XLA folds deg2rad's constants into one,
    s * (30 * pi / 180), and its f32 sin and cos are correctly rounded."""
    s = np.asarray(s, _F)
    m = np.zeros((len(s), 2, 3), _F)
    m[:, 0, 0] = m[:, 1, 1] = 1
    if op == "shear_x":
        m[:, 1, 0] = s * _F(SHEAR)
    elif op == "shear_y":
        m[:, 0, 1] = s * _F(SHEAR)
    elif op in ("translate_x", "translate_y"):
        m[:, 1 if op == "translate_x" else 0, 2] = -s * _F(150.0 / 331.0 * size)
    elif op == "rotate":
        a = (s * (_F(ROTATE) * _F(np.pi / 180))).astype(np.float64)
        m[:, 0, 0] = m[:, 1, 1] = np.cos(a)
        m[:, 1, 0] = np.sin(a)
        m[:, 0, 1] = -m[:, 1, 0]
    else:
        raise ValueError(f"not a geometric op: {op!r}")
    return m


def affine_sample(img: torch.Tensor, mat: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Inverse-warps img (n, H, W, C) by mat (n, 2, 3): bilinear, `fill`
    outside, on the grid centred at ((H - 1) / 2, (W - 1) / 2)."""
    n, h, w, c = img.shape
    dev = img.device
    gy = (torch.arange(h, dtype=torch.float32, device=dev) - (h - 1) / 2.0)[None, :, None]
    gx = (torch.arange(w, dtype=torch.float32, device=dev) - (w - 1) / 2.0)[None, None, :]
    m = mat[:, :, :, None, None]
    iy = (fma(m[:, 0, 0], gy, m[:, 0, 1] * gx) + m[:, 0, 2]) + (h - 1) / 2.0  # XLA's contraction in the transform
    ix = (fma(m[:, 1, 0], gy, m[:, 1, 1] * gx) + m[:, 1, 2]) + (w - 1) / 2.0
    y0, x0 = iy.floor(), ix.floor()
    wy, wx = (iy - y0)[..., None], (ix - x0)[..., None]
    flat = img.reshape(n * h * w, c)
    base = (torch.arange(n, device=dev) * (h * w))[:, None, None]

    def gather(yi, xi):
        valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
        idx = base + yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        return torch.where(valid, flat[idx], fill)

    def lerp(a, b, t):
        return fma(a, 1 - t, b * t)

    return lerp(lerp(gather(y0, x0), gather(y0, x0 + 1), wx), lerp(gather(y0 + 1, x0), gather(y0 + 1, x0 + 1), wx), wy)


def adjust_contrast(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """A blend with the mean grey.  The mean is summed in f64 and rounded
    once, so the card and the CPU agree; XLA's f32 sum takes another order
    (its mean lies within an ulp of this one)."""
    mean = _grayscale(img).double().mean(dim=(1, 2, 3), keepdim=True).float()
    return fma(factor, img - mean, mean).clamp(0.0, 1.0)


_SMOOTH = ((1, 1, 1), (1, 5, 1), (1, 1, 1))  # PIL's ImageFilter.SMOOTH, / 13


def adjust_sharpness(img: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """PIL's sharpness: a blend with the 3x3 smooth of the edge-padded image,
    the 1-px border pasted back from the original."""
    n, h, w, c = img.shape
    xp = torch.nn.functional.pad(img.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate").permute(0, 2, 3, 1)
    smooth = 0.0
    for i, row in enumerate(_SMOOTH):  # the taps in row order: XLA's convolution sums them in another
        for j, k in enumerate(row):
            smooth = smooth + xp[:, i:i + h, j:j + w] * float(_F(k) / _F(13))
    out = fma(factor, img - smooth, smooth).clamp(0.0, 1.0)
    return torch.cat([img[:, :1], torch.cat([img[:, 1:-1, :1], out[:, 1:-1, 1:-1], img[:, 1:-1, -1:]], 2),
                      img[:, -1:]], 1)


def posterize(img: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Keeps the top bits: q = 2 ** (8 - bits)."""
    return torch.floor(img * 255.0 / q) * q * _INV_255


def solarize(img: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    return torch.where(img >= threshold, 1.0 - img, img)


def autocontrast(img: torch.Tensor) -> torch.Tensor:
    """Each channel stretched to [0, 1]; a flat channel stays as it is."""
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    flat = hi <= lo
    lo = torch.where(flat, 0.0, lo)
    scale = torch.where(flat, 1.0, 1.0 / (hi - lo).clamp_min(1e-12))
    return ((img - lo) * scale).clamp(0.0, 1.0)


def equalize(img: torch.Tensor) -> torch.Tensor:
    """PIL's per-channel equalize: step = (pixels - count of the last
    nonzero bin) // 255, lut[i] = (step // 2 + cumsum(hist[:i])) // step,
    identity where step is 0.  The histograms go into one (n, C, 256)
    buffer by scatter_add_, with no sync."""
    n, h, w, c = img.shape
    u8 = torch.round(img * 255.0).clamp(0, 255).long().permute(0, 3, 1, 2).reshape(n, c, h * w)
    hist = torch.zeros(n, c, 256, dtype=torch.long, device=img.device).scatter_add_(2, u8, torch.ones_like(u8))
    bins = torch.arange(256, device=img.device)
    last_nz = torch.where(hist > 0, bins, -1).amax(dim=2, keepdim=True)
    step = (h * w - hist.gather(2, last_nz)) // 255
    lut = (hist.cumsum(2) + step // 2) // step.clamp_min(1)
    lut = torch.cat([torch.zeros_like(lut[..., :1]), lut[..., :-1]], 2).clamp(0, 255)
    out = lut.gather(2, u8).float() * _INV_255
    out = torch.where(step == 0, img.permute(0, 3, 1, 2).reshape(n, c, h * w), out)
    return out.reshape(n, c, h, w).permute(0, 2, 3, 1)


def _enhance(s: np.ndarray) -> np.ndarray:
    return rngs._fma(s, _F(ENHANCE), _F(1))  # 1 + s * 0.9, one rounding


def _geometric(op):
    return lambda img, s: affine_sample(img, to_device(affine_matrices(op, s, max(img.shape[1:3])), img.device))


OPS = {
    "identity": lambda img, s: img,
    "shear_x": _geometric("shear_x"),
    "shear_y": _geometric("shear_y"),
    "translate_x": _geometric("translate_x"),
    "translate_y": _geometric("translate_y"),
    "rotate": _geometric("rotate"),
    "brightness": lambda img, s: adjust_brightness(img, _per_sample(_enhance(s), img.device)),
    "color": lambda img, s: adjust_saturation(img, _per_sample(_enhance(s), img.device)),
    "contrast": lambda img, s: adjust_contrast(img, _per_sample(_enhance(s), img.device)),
    "sharpness": lambda img, s: adjust_sharpness(img, _per_sample(_enhance(s), img.device)),
    # torchvision's 8 - round(4 * |s|) bits; its threshold 1 - |s| (both unsigned)
    "posterize": lambda img, s: posterize(img, _per_sample(2.0 ** np.round(_F(4) * np.abs(s)), img.device)),
    "solarize": lambda img, s: solarize(img, _per_sample(_F(1) - np.abs(s), img.device)),
    "autocontrast": lambda img, s: autocontrast(img),
    "equalize": lambda img, s: equalize(img),
    "invert": lambda img, s: 1.0 - img,
}
RANDAUG_OPS = tuple(OPS)[:14]  # the order of saspa_tpu/ops/augment.py::_randaug_ops
AUTOAUG_OPS = RANDAUG_OPS + ("invert",)


def apply_ops(imgs: torch.Tensor, op_idx: np.ndarray, strength: np.ndarray, names, apply=None) -> torch.Tensor:
    """Rounds of per-sample ops: round r applies names[op_idx[r, i]] at
    strength[r, i] to sample i (where apply[r, i]).  Each op runs once a
    round over the samples that drew it, gathered and put back by indices
    known on the host."""
    for r in range(op_idx.shape[0]):
        for k in np.unique(op_idx[r]):
            picked = (op_idx[r] == k) if apply is None else (op_idx[r] == k) & apply[r]
            if names[k] == "identity" or not picked.any():
                continue
            idx = np.nonzero(picked)[0]
            rows = to_device(idx, imgs.device)
            imgs = imgs.index_copy(0, rows, OPS[names[k]](imgs.index_select(0, rows), strength[r, idx]))
    return imgs


RANDAUG_NUM_OPS, RANDAUG_MAGNITUDE = 2, 9  # torchvision's RandAugment defaults: 2 ops at 9 of 30


def randaugment_draws(key, b: int, rows: Optional[rngs.Rows] = None):
    """(op index, signed strength), each (2, b): sample i's key is
    split(key, b)[i]; op r splits fold_in(key, r) into (op, sign, next key)."""
    keys = rngs.take_rows(rngs.split(key, rngs.draw_size(rows, b)), rows)
    op_idx = np.zeros((RANDAUG_NUM_OPS, b), np.int64)
    sign = np.zeros((RANDAUG_NUM_OPS, b), _F)
    for r in range(RANDAUG_NUM_OPS):
        ki, ks, keys = rngs.split_each(rngs.fold_in_each(keys, r), 3)
        op_idx[r] = rngs.randint_each(ki, 0, len(RANDAUG_OPS))
        sign[r] = np.where(rngs.uniform_each(ks) < _F(0.5), _F(1), _F(-1))
    return op_idx, sign * _F(RANDAUG_MAGNITUDE / 30.0)


def randaugment_batch(imgs: torch.Tensor, key, rows: Optional[rngs.Rows] = None) -> torch.Tensor:
    """RandAugment (torchvision's 14 ops, 31 bins, 2 ops at strength 9 / 30)."""
    op_idx, strength = randaugment_draws(key, imgs.shape[0], rows)
    return apply_ops(imgs, op_idx, strength, RANDAUG_OPS)


# (op, probability, magnitude bin of 9): torchvision's ImageNet policy
AA_POLICY = [
    (("posterize", 0.4, 8), ("rotate", 0.6, 9)),
    (("solarize", 0.6, 5), ("autocontrast", 0.6, 5)),
    (("equalize", 0.8, 8), ("equalize", 0.6, 3)),
    (("posterize", 0.6, 7), ("posterize", 0.6, 6)),
    (("equalize", 0.4, 7), ("solarize", 0.2, 4)),
    (("equalize", 0.4, 4), ("rotate", 0.8, 8)),
    (("solarize", 0.6, 3), ("equalize", 0.6, 7)),
    (("posterize", 0.8, 5), ("equalize", 1.0, 2)),
    (("rotate", 0.2, 3), ("solarize", 0.6, 8)),
    (("equalize", 0.6, 8), ("posterize", 0.4, 6)),
    (("rotate", 0.8, 8), ("color", 0.4, 0)),
    (("rotate", 0.4, 9), ("equalize", 0.6, 2)),
    (("equalize", 0.0, 7), ("equalize", 0.8, 8)),
    (("invert", 0.6, 4), ("equalize", 1.0, 8)),
    (("color", 0.6, 4), ("contrast", 1.0, 8)),
    (("rotate", 0.8, 8), ("color", 1.0, 2)),
    (("color", 0.8, 8), ("solarize", 0.8, 7)),
    (("sharpness", 0.4, 7), ("invert", 0.6, 8)),
    (("shear_x", 0.6, 5), ("equalize", 1.0, 9)),
    (("color", 0.4, 0), ("equalize", 0.6, 3)),
    (("equalize", 0.4, 7), ("solarize", 0.2, 4)),
    (("solarize", 0.6, 5), ("autocontrast", 0.6, 5)),
    (("invert", 0.6, 4), ("equalize", 1.0, 8)),
    (("color", 0.6, 4), ("contrast", 1.0, 8)),
    (("equalize", 0.8, 8), ("equalize", 0.6, 3)),
]


_AA_IDX = np.array([[AUTOAUG_OPS.index(op[0]) for op in pol] for pol in AA_POLICY])
_AA_P = np.array([[op[1] for op in pol] for pol in AA_POLICY], _F)
_AA_M = np.array([[op[2] / 9.0 for op in pol] for pol in AA_POLICY], _F)


def autoaugment_draws(key, b: int, rows: Optional[rngs.Rows] = None):
    """(op index, signed strength, applied), each (2, b): sample i's key
    split(key, b)[i] splits into (policy, coin 1, coin 2, sign 1, sign 2);
    op j applies where uniform < its f32 probability."""
    kp, k1, k2, ks1, ks2 = rngs.split_each(rngs.take_rows(rngs.split(key, rngs.draw_size(rows, b)), rows), 5)
    pol = rngs.randint_each(kp, 0, len(AA_POLICY))
    apply = np.stack([rngs.uniform_each(kk) < _AA_P[pol, j] for j, kk in enumerate((k1, k2))])
    sign = np.stack([np.where(rngs.uniform_each(kk) < _F(0.5), _F(1), _F(-1)) for kk in (ks1, ks2)])
    return _AA_IDX[pol].T, sign * _AA_M[pol].T, apply


def autoaugment_batch(imgs: torch.Tensor, key, rows: Optional[rngs.Rows] = None) -> torch.Tensor:
    """AutoAugment: one of the 25 ImageNet sub-policies a sample, each of its
    two ops applied with its probability."""
    op_idx, strength, apply = autoaugment_draws(key, imgs.shape[0], rows)
    return apply_ops(imgs, op_idx, strength, AUTOAUG_OPS, apply)


# --------------------------------------------------------------------------
# CutMix (beta 1, prob 0.5, two mixes, as DA-Fusion / ALIA)
# --------------------------------------------------------------------------
CUTMIX_BETA, CUTMIX_PROB, CUTMIX_MIXES = 1.0, 0.5, 2


def cutmix_draws(key, b: int, h: int, w: int):
    """Each mix's boxes and mixing weights, drawn as saspa_tpu's cutmix_batch
    draws them: int64 (2, 6, b) rows (do, perm, y1, y2, x1, x2) and f32
    (2, 2, b) rows (lam_adj, 1 - lam_adj)."""
    ints = np.zeros((CUTMIX_MIXES, 6, b), np.int64)
    lams = np.zeros((CUTMIX_MIXES, 2, b), _F)
    for i in range(CUTMIX_MIXES):
        kp, kl, kperm, ky, kx = rngs.split(rngs.fold_in(key, i), 5)
        do = rngs.bernoulli(kp, CUTMIX_PROB, (b,))
        lam = rngs.beta_f32(kl, CUTMIX_BETA, CUTMIX_BETA, (b,))
        cut_rat = np.sqrt(_F(1) - lam)
        cut_h, cut_w = (_F(h) * cut_rat).astype(np.int32), (_F(w) * cut_rat).astype(np.int32)
        cy, cx = rngs.randint(ky, (b,), 0, h), rngs.randint(kx, (b,), 0, w)
        y1, y2 = np.clip(cy - cut_h // 2, 0, h), np.clip(cy + cut_h // 2, 0, h)
        x1, x2 = np.clip(cx - cut_w // 2, 0, w), np.clip(cx + cut_w // 2, 0, w)
        area = ((y2 - y1) * (x2 - x1)).astype(_F) / _F(h * w)
        lam_adj = np.where(do, _F(1) - area, _F(1)).astype(_F)
        ints[i] = (do, rngs.permutation(kperm, b), y1, y2, x1, x2)
        lams[i] = (lam_adj, _F(1) - lam_adj)
    return ints, lams


def _cutmix_plan(ints: np.ndarray, out: np.ndarray):
    """(sources, mix 1's rows): the sorted rows whose images mix into rows
    `out`.  Mix 2 reads mix 1's result at its permutation of `out`, and
    mix 1 reads the images at its permutation of those."""
    mid = np.union1d(out, ints[1, 1][out])
    return np.union1d(mid, ints[0, 1][mid]), mid


def cutmix_sources(key, rows: rngs.Rows, h: int, w: int) -> np.ndarray:
    """The sorted rows of the batch that rows.index's CutMix reads, at (h, w)."""
    return _cutmix_plan(cutmix_draws(key, rows.total, h, w)[0], np.asarray(rows.index))[0]


def cutmix_batch(imgs: torch.Tensor, labels: torch.Tensor, key, num_classes: int,
                 rows: Optional[rngs.Rows] = None):
    """In-batch CutMix of NCHW images: returns (images, labels, soft labels
    f32 (B, num_classes)).  Mix 2 permutes mix 1's images and labels.  The
    draws go up in two uploads; boxes and mixes run on imgs' device.

    With `rows`, imgs and labels are the rows `cutmix_sources(key, rows, h,
    w)` of a batch of rows.total, and the result is rows.index's: a shard
    loads only the images its own rows mix from.  Without `rows` the batch
    is all of its own rows."""
    _, _, h, w = imgs.shape
    dev = imgs.device
    if rows is None:
        rows = rngs.Rows(np.arange(imgs.shape[0]), imgs.shape[0])
    n = rows.total
    ints_np, lams_np = cutmix_draws(key, n, h, w)
    ints, lams = to_device(ints_np, dev), to_device(lams_np, dev)
    y_soft = torch.zeros(imgs.shape[0], num_classes, dtype=torch.float32, device=dev).scatter_(
        1, labels.long()[:, None], 1.0)
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    # each mix's output rows and the rows its input holds, as rows of the batch
    have, mid = _cutmix_plan(ints_np, np.asarray(rows.index))
    labels = labels[to_device(np.searchsorted(have, rows.index), dev)]
    for i, (dst, src) in enumerate([(mid, have), (np.asarray(rows.index), mid)]):
        pos = np.zeros(n, np.int64)
        pos[src] = np.arange(len(src))
        sel = to_device(dst, dev)
        mix, lam = ints[i][:, sel], lams[i][:, sel]
        here, there = to_device(pos[dst], dev), to_device(pos[ints_np[i, 1][dst]], dev)
        base, base_soft, other, other_soft = imgs[here], y_soft[here], imgs[there], y_soft[there]
        do, _, y1, y2, x1, x2 = mix[:, :, None, None]
        box = (ys >= y1) & (ys < y2) & (xs >= x1) & (xs < x2) & (do > 0)
        imgs = torch.where(box[:, None], other, base)
        y_soft = lam[0][:, None] * base_soft + lam[1][:, None] * other_soft
    return imgs, labels, y_soft


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


def train_transform_batch(imgs_u8: torch.Tensor, key, preset: Optional[str], out_h: int, out_w: int,
                          rows: Optional[rngs.Rows] = None) -> torch.Tensor:
    """uint8 (B, H, W, C), already resized to size / 0.875 by the host ->
    normalized float32 (B, C, out_h, out_w); with `rows`, imgs_u8 are those
    rows of a larger batch and take its draws."""
    if preset not in PRESETS:
        raise ValueError(f"unknown train transform preset {preset!r}")
    kc, kf, kj = rngs.split(key, 3)
    if preset is None:
        return val_transform_batch(imgs_u8, out_h, out_w)
    x = random_crop_batch(imgs_u8, kc, (out_h, out_w), rows)
    if preset == "randaug":
        return _finalize(randaugment_batch(x.float() * _INV_255, kj, rows))
    if preset == "autoaug":
        return _finalize(autoaugment_batch(x.float() * _INV_255, kj, rows))
    x = hflip_batch(x, kf, rows=rows)  # the flip commutes with the scale
    if preset == "classic_no_color":
        return _finalize_u8(x)
    return _finalize(color_jitter_batch(x.float() * _INV_255, kj, rows=rows))


def val_transform_batch(imgs_u8: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    return _finalize_u8(center_crop_batch(imgs_u8, (out_h, out_w)))
