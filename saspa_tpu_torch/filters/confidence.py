"""Baseline-classifier confidence scoring, batched (counterpart of
saspa_tpu/filters/confidence.py).

The reference scores generated images one at a time with the dataset's
released WSDAN_CAL (all_utils/utils.py:357-375); here every aug image of the
sweep goes through padded batches of one shape on the card, and the
predicates (top-k membership, too-high confidence, ALIA per-class
thresholds) read the precomputed logits on the host.  Without a converted
checkpoint the baseline takes a seeded init, with a warning, or raises under
SASPA_STRICT_WEIGHTS=1.  Reading a converted checkpoint
(checkpoints/<dataset>/meta.json, orbax) is ROADMAP Queue 1 item 13.
"""

from __future__ import annotations

import logging
import os
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from saspa_tpu_torch import default_dtype, resolve_device
from saspa_tpu_torch.data.registry import checkpoints_dir
from saspa_tpu_torch.filters.batches import score_in_batches
from saspa_tpu_torch.gen.image_io import read_rgb
from saspa_tpu_torch.models.cal import WSDAN_CAL
from saspa_tpu_torch.models.layers import init_weights
from saspa_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD, pil_resize

BASELINE_NET = "resnet101"  # the net of the released baselines


def val_preprocess(path: str, resize: Tuple[int, int] = (224, 224)) -> np.ndarray:
    """Reference val transform: resize/0.875 (PIL BILINEAR) -> center crop
    -> normalize (all_utils/dataset_utils.py:78-85); (H, W, 3) float32."""
    th, tw = resize
    rh, rw = int(th / 0.875), int(tw / 0.875)
    x = pil_resize(read_rgb(path), (rw, rh), "bilinear").astype(np.float32) / 255.0
    y0, x0 = (rh - th) // 2, (rw - tw) // 2
    x = x[y0:y0 + th, x0:x0 + tw]
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def load_cal_baseline(name: str, num_classes: int, resize: Tuple[int, int] = (224, 224), device=None):
    """(model, preprocess_fn) of the dataset's baseline on `device` (None:
    the card), bf16 there and f32 on the CPU."""
    cp_dir = checkpoints_dir() / name
    if (cp_dir / "meta.json").exists():
        raise NotImplementedError(f"{cp_dir} holds a converted baseline checkpoint (orbax), which the port "
                                  "cannot read yet (ROADMAP Queue 1 item 13)")
    if os.environ.get("SASPA_STRICT_WEIGHTS", "") == "1":
        raise FileNotFoundError(f"no converted baseline CAL checkpoint under {cp_dir} and "
                                "SASPA_STRICT_WEIGHTS=1 — confidence filtering would be noise")
    logging.warning("no baseline checkpoint for %s — seeded random init", name)
    device = resolve_device(device)
    model = WSDAN_CAL(num_classes=num_classes, M=32, net=BASELINE_NET, dtype=default_dtype(device), device=device)
    init_weights(model, 0)
    return model.eval(), partial(val_preprocess, resize=resize)


def batched_logits(model: WSDAN_CAL, paths: Sequence[str], preprocess: Callable[[str], np.ndarray],
                   batch_size: int = 64, timings: Optional[dict] = None) -> np.ndarray:
    """Image paths -> (N, num_classes) float32 logits, in padded batches of
    one shape on the model's device."""
    device = model.fc.kernel.device
    return score_in_batches(paths, preprocess, lambda x: model(x)[0], batch_size, model.num_classes, device,
                            timings)


def compute_alia_thresholds(ds_utils, device=None) -> Dict[str, float]:
    """Per-class mean confidence of the baseline on the original train
    images (all_utils/dataset_utils.py:117-146)."""
    model, preprocess = ds_utils.load_baseline_model(device=device)
    path_to_class = ds_utils.get_image_path_to_class_id_dict()
    paths = list(ds_utils.original_images_paths)
    logits = batched_logits(model, paths, preprocess)
    per_class: Dict[int, List[float]] = {i: [] for i in range(ds_utils.num_classes)}
    for p, lg in zip(paths, logits):
        cid = path_to_class[p]
        per_class[cid].append(float(lg[cid]))
    empty = [cid for cid, v in per_class.items() if not v]
    if empty:
        # the reference fails here too (ZeroDivisionError on an empty class)
        raise ValueError(
            f"ALIA thresholds: classes {empty[:5]}{'...' if len(empty) > 5 else ''} have no original train "
            f"images (utils {ds_utils.name!r} with {ds_utils.num_classes} classes) — class ids and the utils "
            "class disagree")
    return {str(cid): sum(v) / len(v) for cid, v in per_class.items()}
