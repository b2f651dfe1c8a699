"""CLIP zero-shot filter scoring, batched (counterpart of
saspa_tpu/filters/clip_filters.py).

Reference semantics (all_utils/utils.py:139-191,272-312):
  * semantic filter: prompts = [dataset basic prompt] + 6 fixed negatives;
    keep iff argmax(logits) == 0
  * per-class filter: prompts = one per class; keep iff
    softmax(logits)[true class] >= 1 / num_classes / discount

Text features are encoded once per battery, image features once per aug
image in padded batches on the card; the logits are one matmul on the host,
the softmax float32, as in the JAX package.  The weights are OpenAI's
RN50.pt under the weights dir (weights/sources.py), parameters and
BatchNorm statistics; without it the model takes a seeded init, with a
warning, or raises under SASPA_STRICT_WEIGHTS=1.  `CLIPScorer("vit-b-16")`
scores with CLIP ViT-B/16 (the JAX package's other pairing); no public
file rule exists for it in either package, so it always takes the seeded
init, under the same rule.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from saspa_tpu_torch import default_dtype, resolve_device
from saspa_tpu_torch.filters.batches import score_in_batches
from saspa_tpu_torch.gen.image_io import read_rgb
from saspa_tpu_torch.gen.tokenizer import default_tokenizer
from saspa_tpu_torch.models.clip import CLIP_MEAN, CLIP_STD, CLIPModel, CLIPVisionRNConfig
from saspa_tpu_torch.models.layers import init_weights
from saspa_tpu_torch.models.text_encoder import CLIP_RN50_TEXT
from saspa_tpu_torch.ops.image import pil_resize
from saspa_tpu_torch.weights.load import load_one, missing_weights, refuse_orbax

NEGATIVE_SEMANTIC_PROMPTS = [
    "a photo of an object",
    "a photo of a scene",
    "a photo of geometric shapes",
    "a photo",
    "an image",
    "a black photo",
]

# the scorer's towers: CLIP RN50 at its published widths
VISION_CFG = CLIPVisionRNConfig()
TEXT_CFG = CLIP_RN50_TEXT


def clip_preprocess_path(path: str, size: int = 224) -> np.ndarray:
    """Host-side CLIP preprocess: resize (PIL bicubic, short side to `size`)
    -> center crop -> normalize; (size, size, 3) float32."""
    img = read_rgb(path)
    h, w = img.shape[:2]
    scale = size / min(w, h)
    img = pil_resize(img, (max(size, int(round(w * scale))), max(size, int(round(h * scale)))), "bicubic")
    h, w = img.shape[:2]
    x0, y0 = (w - size) // 2, (h - size) // 2
    x = img[y0:y0 + size, x0:x0 + size].astype(np.float32) / 255.0
    return (x - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)


class CLIPScorer:
    """Owns a CLIP model on `device` (None: the card; bf16 there, f32 on the
    CPU) and scores image paths against prompt batteries."""

    def __init__(self, vision_kind: str = "rn50", weights_dir: Optional[str] = None, seed: int = 0, device=None):
        self.vision_kind = vision_kind
        weights_dir = weights_dir or os.environ.get("SASPA_WEIGHTS_DIR")
        self.tokenizer = default_tokenizer(weights_dir)
        self.device = resolve_device(device)
        towers = (VISION_CFG, TEXT_CFG) if vision_kind == "rn50" else (None, CLIP_RN50_TEXT)
        self.model = CLIPModel(vision_kind, *towers, dtype=default_dtype(self.device), device=self.device).eval()
        if vision_kind == "rn50":
            self.load_report = load_one(weights_dir, "clip_rn50", self.model, "CLIP rn50 file", orbax="clip_rn50")
        else:  # no public file rule: the JAX package's converted directory is refused, else the seeded init
            if weights_dir and (Path(weights_dir) / f"clip_{vision_kind}").exists():
                refuse_orbax(Path(weights_dir) / f"clip_{vision_kind}")
            missing_weights(f"CLIP {vision_kind} weights (no public file rule)", weights_dir or "(no --weights_dir)")
            self.load_report = None
        if self.load_report is None:
            init_weights(self.model, seed)

    @property
    def logit_scale(self) -> float:
        return float(np.exp(np.float32(self.model.logit_scale.item())))

    @torch.no_grad()
    def text_features(self, prompts: Sequence[str]) -> np.ndarray:
        ids = torch.from_numpy(self.tokenizer(list(prompts))).long().to(self.device)
        return self.model.encode_text(ids).float().cpu().numpy()

    def image_features(self, paths: Sequence[str], batch_size: int = 64, timings: Optional[dict] = None,
                       mesh=None) -> np.ndarray:
        """(N, output_dim) image features; with a mesh each batch is split
        over its ranks (filters/batches.py)."""
        return score_in_batches(paths, clip_preprocess_path, self.model.encode_image, batch_size,
                                self.model.output_dim, self.device, timings, mesh)

    def logits(self, image_features: np.ndarray, text_features: np.ndarray) -> np.ndarray:
        return self.logit_scale * image_features @ text_features.T


def semantic_keep(logits: np.ndarray) -> np.ndarray:
    """(N, 1+6) semantic-battery logits -> keep mask (argmax == 0)."""
    return logits.argmax(axis=-1) == 0


def per_class_keep(logits: np.ndarray, class_idx: np.ndarray, threshold: float) -> np.ndarray:
    """(N, C) class-battery logits + per-image true class -> keep mask
    (float32 softmax)."""
    x = np.asarray(logits, np.float32)
    ex = np.exp(x - x.max(axis=-1, keepdims=True))
    probs = ex / ex.sum(axis=-1, keepdims=True)
    return probs[np.arange(len(class_idx)), class_idx] >= threshold
