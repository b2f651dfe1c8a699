"""Baseline-classifier confidence scoring, batched (counterpart of
saspa_tpu/filters/confidence.py).

The reference scores generated images one at a time with the dataset's
released WSDAN_CAL (all_utils/utils.py:357-375); here every aug image of the
sweep goes through padded batches of one shape on the card, and the
predicates (top-k membership, too-high confidence, ALIA per-class
thresholds) read the precomputed logits on the host.  The baseline is the
dataset's released WSDAN-CAL .pth: the weights dir's (weights/sources.py)
or the one file under checkpoints/<dataset>/ (the reference's rule,
all_utils/dataset_utils.py:89-93), with the net its keys say (ResNet-101
or -50, with or without CBAM, or Inception-v3 at mixed_6e or mixed_7c;
weights/convert.py `cal_net`).  Without one the baseline takes a seeded
init, with a warning, or raises under SASPA_STRICT_WEIGHTS=1.
"""

from __future__ import annotations

from functools import partial
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from saspa_tpu_torch import default_dtype, resolve_device
from saspa_tpu_torch.data.registry import checkpoints_dir
from saspa_tpu_torch.filters.batches import score_in_batches
from saspa_tpu_torch.gen.image_io import read_rgb
from saspa_tpu_torch.models.cal import WSDAN_CAL
from saspa_tpu_torch.models.layers import init_weights
from saspa_tpu_torch.ops.image import IMAGENET_MEAN, IMAGENET_STD, pil_resize
from saspa_tpu_torch.weights.convert import cal_net
from saspa_tpu_torch.weights.files import read_state_dict
from saspa_tpu_torch.weights.load import load_file, missing_weights, refuse_orbax
from saspa_tpu_torch.weights.sources import find_source

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


def baseline_file(name: str, weights_dir: Optional[str] = None) -> Optional[Path]:
    """The released baseline .pth of dataset `name`: the weights dir's, else
    the one .pth under checkpoints/<name>/ (more than one raises, as the
    reference asserts exactly one)."""
    path = find_source(weights_dir, f"cal_{name}") if weights_dir else None
    if path is None:
        cp_dir = checkpoints_dir() / name
        pths = sorted(cp_dir.glob("*.pth"))
        if len(pths) > 1:
            raise ValueError(f"{cp_dir} holds {len(pths)} .pth files; the baseline is exactly one")
        path = pths[0] if pths else None
    return path


def load_cal_baseline(name: str, num_classes: int, resize: Tuple[int, int] = (224, 224), device=None,
                      weights_dir: Optional[str] = None):
    """(model, preprocess_fn) of the dataset's baseline on `device` (None:
    the card), bf16 there and f32 on the CPU."""
    device = resolve_device(device)
    path = baseline_file(name, weights_dir)
    if path is None:
        cp_dir = checkpoints_dir() / name
        if (cp_dir / "meta.json").exists():
            refuse_orbax(cp_dir)
        missing_weights(f"baseline CAL checkpoint for {name}", cp_dir)
        model = WSDAN_CAL(num_classes=num_classes, M=32, net=BASELINE_NET, dtype=default_dtype(device),
                          device=device)
        init_weights(model, 0)
    else:
        sd = read_state_dict(path)
        model = WSDAN_CAL(num_classes=num_classes, M=32, net=cal_net(sd), dtype=default_dtype(device), device=device)
        model.load_report = load_file(path, "cal", model, sd=sd)
    return model.eval(), partial(val_preprocess, resize=resize)


def batched_logits(model: WSDAN_CAL, paths: Sequence[str], preprocess: Callable[[str], np.ndarray],
                   batch_size: int = 64, timings: Optional[dict] = None) -> np.ndarray:
    """Image paths -> (N, num_classes) float32 logits, in padded batches of
    one shape on the model's device."""
    device = model.fc.kernel.device
    return score_in_batches(paths, preprocess, lambda x: model(x)[0], batch_size, model.num_classes, device,
                            timings)


def compute_alia_thresholds(ds_utils, device=None, weights_dir: Optional[str] = None) -> Dict[str, float]:
    """Per-class mean confidence of the baseline on the original train
    images (all_utils/dataset_utils.py:117-146)."""
    model, preprocess = ds_utils.load_baseline_model(device=device, weights_dir=weights_dir)
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
