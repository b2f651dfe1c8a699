"""Batched LPIPS distance between original and augmented images
(counterpart of saspa_tpu/filters/lpips_filter.py).

Reference behaviour (all_utils/utils.py:576-590): both images to
grayscale and back to RGB, resized to 256^2 (PIL's default filter for RGB,
bicubic), scaled to [-1, 1], AlexNet-LPIPS distance; the aug-JSON builder
keeps lpips_min <= d <= lpips_max.  The pairs are scored in padded batches
of one shape on the card (bf16 there, f32 on the CPU), each pair's two
images stacked on the channel axis through `filters/batches.py`.  The
weights are the lpips package's alex .pth under the weights dir; without
it the trunk takes a seeded init and the heads 1/C, with a warning, or
SASPA_STRICT_WEIGHTS=1 raises.
"""

from __future__ import annotations

import json
import logging
import random as pyrandom
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from saspa_tpu_torch import default_dtype, resolve_device
from saspa_tpu_torch.filters.batches import score_in_batches
from saspa_tpu_torch.gen.image_io import read_rgb
from saspa_tpu_torch.models.lpips import LPIPS
from saspa_tpu_torch.ops.image import pil_convert_l, pil_resize
from saspa_tpu_torch.weights.load import load_one


def _load_gray_rgb(path: str, resize: Tuple[int, int]) -> np.ndarray:
    """`Image.open(path).convert("L").convert("RGB").resize(resize)` scaled
    to [-1, 1]: (h, w, 3) float32.  The three channels are equal, so the
    gray plane is resized once."""
    gray = pil_resize(pil_convert_l(read_rgb(path)), resize, "bicubic")
    x = np.repeat(gray[..., None], 3, axis=-1).astype(np.float32) / 255.0
    return x * 2.0 - 1.0


def load_lpips(weights_dir: Optional[str] = None, device=None) -> LPIPS:
    device = resolve_device(device)
    model = LPIPS(default_dtype(device), device).eval()
    model.load_report = load_one(weights_dir, "lpips", model, "LPIPS alex file")
    if model.load_report is None:
        model.init_seeded(0)
    return model


def batched_lpips(orig_paths: Sequence[str], aug_paths: Sequence[str], resize: Tuple[int, int] = (256, 256),
                  weights_dir: Optional[str] = None, batch_size: int = 32, device=None, model: Optional[LPIPS] = None,
                  timings: Optional[dict] = None) -> np.ndarray:
    """(N,) float32 distances of the pairs (orig_paths[i], aug_paths[i])."""
    if len(orig_paths) != len(aug_paths):
        raise ValueError(f"{len(orig_paths)} originals for {len(aug_paths)} augs")
    model = model or load_lpips(weights_dir, device)
    dev = model.shift.device

    def pair(i: int) -> np.ndarray:
        return np.concatenate([_load_gray_rgb(orig_paths[i], resize), _load_gray_rgb(aug_paths[i], resize)], axis=-1)

    d = score_in_batches(list(range(len(aug_paths))), pair, lambda x: model(x[:, :3], x[:, 3:])[:, None], batch_size,
                         1, dev, timings)
    return d[:, 0]


def calc_lpips_given_aug_json(dataset, aug_json, net="alex", compute_on=3000, resize_to=None, seed=0,
                              weights_dir=None, device=None):
    """Offline metric: mean/std LPIPS over an aug-JSON (all_utils/utils.py:789-817)."""
    from saspa_tpu_torch.data.registry import DS_UTILS_DICT

    with open(aug_json) as f:
        aug_data = json.load(f)
    if len(aug_data) > compute_on:
        rng = pyrandom.Random(seed)
        aug_data = dict(rng.sample(sorted(aug_data.items()), compute_on))
    ds_utils = DS_UTILS_DICT[dataset]()
    by_name = {Path(p).name: p for p in ds_utils.original_images_paths}
    origs, augs = [], []
    for name, aug_list in aug_data.items():
        src = by_name.get(name)
        if src is None:
            continue
        for a in aug_list:
            origs.append(src)
            augs.append(a)
    values = batched_lpips(origs, augs, resize=resize_to or (256, 256), weights_dir=weights_dir, device=device)
    mean, std = float(np.mean(values)), float(np.std(values))
    logging.info("LPIPS mean %.4f std %.4f over %d pairs", mean, std, len(values))
    return mean, std, values.tolist()
